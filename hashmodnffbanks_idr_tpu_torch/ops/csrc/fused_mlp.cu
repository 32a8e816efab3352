// Fused SDF-MLP forward for the gradient-free sphere tracer, for Hopper (sm_90a).
//
// Replaces hashmodnffbanks_idr_tpu/ops/fused_mlp.py:_kernel (the Pallas
// kernel behind fused_sdf_raw).  For N embedded points x (N, d_in) it
// computes the raw SDF channel of the IDR MLP (hidden 512, skip after l3):
//
//   h = softplus100(x W_in + b_in)
//   h = softplus100(h W_l + b_l)            l = 1..7
//   after l3: columns >= 512-d_in hold x/sqrt(2), the rest h/sqrt(2)
//   sdf = h . w_out + b_out                 (only the SDF column)
//
// Two variants.  float weights (the 'exact' tracer) run on the tensor cores
// in split-TF32; bf16 weights (guidance queries) on WMMA with float
// accumulation.  Each layer rounds its input to the weight type, as the
// Pallas kernel does; biases, softplus and the skip scaling stay float.
//
// float variant: bound.  Per point the chain is 2*(59*512 + 6*512^2 +
// 512*453 + 512) ~ 3.67 MFLOP.  To keep float32 accuracy on the TF32 tensor
// cores every product a*b becomes three TF32 products, a_lo*b_hi + a_hi*b_lo
// + a_hi*b_hi (x = hi + lo, hi = tf32_rna(x), lo = tf32_rna(x - hi)), so the
// bound is 3 x 3.67 MFLOP per point at the H100's 495 TFLOP/s dense TF32:
// 1.094 ms at N=49152 and 0.091 ms at N=4096.  (On the CUDA cores' 67
// TFLOP/s FP32 the same chain is bound at 2.693 ms at N=49152.)
//
// float variant: design.  The Pallas kernel keeps all 7.4 MB of weights
// resident in VMEM; an SM has 227 KB.  So a block keeps a tile of 64 points
// on chip across all nine layers (a 64x512 float activation tile in shared
// memory, never in device memory) and streams the weights through a ring of
// three 16-row stages filled by 16-byte cp.async (commit/wait groups): while
// chunk k is multiplied, chunks k+1 and k+2 are in flight, also across layer
// boundaries, so the next layer's first weights arrive during the epilogue.
// 64 rows per block halve the L2 weight traffic of a 32-row tile (at
// N=49152, 768 blocks x 7.4 MB).  Eight warps each own 64 output columns for
// all 64 rows.  Per 8-deep k-step a warp reads 4 A and 8 B fragments of
// mma.sync.m16n8k8 from shared memory with plain loads (row strides padded so
// that both are free of bank conflicts), splits each value into hi and lo in
// registers (the weights are stored once, as float) and runs 3 x 32
// mma.sync.m16n8k8.tf32, the two small products before hi*hi.  The tensor
// cores truncate when they add into their accumulator, which over a layer
// would miss float32 accuracy; so each k-step's three products go into a
// fresh partial sum that a round-to-nearest add folds into the 128 float
// accumulators a thread holds.  The epilogue stores the accumulators to the
// tile, then a pass over the tile adds the bias, applies softplus (fast exp
// and log) and after l3 writes x/sqrt(2) (read from device memory) into the
// tail columns.  The last layer is a 512-long float dot per point with a warp
// reduction.  x is read at its real width and only (N,) is written.  What
// keeps this design from the bound: mma.sync does not reach the tensor
// cores' full rate (only wgmma does), and the splits, partial-sum adds and
// softplus compete with it for instruction slots.
//
// bf16 variant: bound 0.26 ms at N=69632 (989 TFLOP/s).  A block keeps 64
// points on chip and streams 64-row weight chunks synchronously into WMMA;
// no TMA, no wgmma, no double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int HIDDEN = 512;
constexpr int N_MID = 7;           // l1..l7
constexpr int SKIP_AFTER_MID = 2;  // the skip concat follows l3
constexpr int K0 = 64;             // first-layer depth: d_in <= 64, zero padded
constexpr float INV_SQRT2 = 0.70710678118654752f;
constexpr int MAX_SMEM = 232448;   // an sm_90 block's dynamic shared memory

// torch Softplus(beta=100, threshold=20)
__device__ __forceinline__ float softplus100(float x) {
  const float bx = 100.f * x;
  return bx > 20.f ? x : log1pf(expf(fminf(bx, 20.f))) / 100.f;
}

// ---------------------------------------------------------------------------
// float weights: split-TF32 mma.sync fed by a cp.async weight ring
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int TM = 64;                  // points per block
constexpr int NT = 256;                 // 8 warps
constexpr int WARP_COLS = HIDDEN / (NT / 32);  // 64 output columns a warp
constexpr int MI = TM / 16, NI = WARP_COLS / 8;  // m16n8 tiles a warp: 4 x 8
constexpr int KC = 16;                  // weight rows per ring stage
constexpr int STAGES = 3;
// row strides: A fragments read rows g at column t (stride = 4 mod 32 banks),
// B fragments rows t at column g (stride = 8 mod 32): no bank conflicts
constexpr int LDA = HIDDEN + 4;
constexpr int LDW = HIDDEN + 8;
constexpr int CHUNKS_IN = K0 / KC;          // l0's chunks
constexpr int CHUNKS_MID = HIDDEN / KC;     // each of l1..l7's
constexpr int CHUNKS = CHUNKS_IN + N_MID * CHUNKS_MID;
constexpr size_t SMEM = sizeof(float) * (TM * LDA + STAGES * KC * LDW);
static_assert(SMEM <= MAX_SMEM, "f32 tile and weight ring exceed shared memory");
static_assert(KC % 8 == 0 && K0 % KC == 0 && HIDDEN % KC == 0, "chunking");

// x = hi + lo, both TF32 rounded to nearest, ties away from zero (x - hi is
// exact in float).  The integer form gives the bits of cvt.rna.tf32.f32 and
// runs faster: adding half an ulp of TF32 to the bit pattern and clearing
// the 13 low bits rounds the magnitude; for lo the clearing is left to the
// tensor cores, which ignore those bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c = a b (16x8x8, TF32 operands, float result)
__device__ __forceinline__ void mma_set(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// c += a b
__device__ __forceinline__ void mma_add(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared without a register round trip; zero-filled when
// !valid (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// chunk c of the whole weight stream (l0's K0 rows, then l1..l7's 512 rows
// each, KC rows a chunk) into its ring stage, as one commit group; rows at or
// past d_in in l0 are zero.  Past the end it commits an empty group, so that
// the group count stays uniform for wait_group.
__device__ __forceinline__ void prefetch_chunk(float* ring, int c, int d_in,
                                            const float* __restrict__ w_in,
                                            const float* __restrict__ w_mid) {
  if (c < CHUNKS) {
    const bool first = c < CHUNKS_IN;
    const int m = (c - CHUNKS_IN) / CHUNKS_MID;
    const float* W = first ? w_in : w_mid + (size_t)m * HIDDEN * HIDDEN;
    const int k0 = first ? c * KC : (c - CHUNKS_IN - m * CHUNKS_MID) * KC;
    const int k_real = first ? d_in : HIDDEN;
    // thread -> column col of rows r0, r0 + ROW_STEP, ...
    constexpr int PER_ROW = HIDDEN / 4;  // 16-byte copies a row
    constexpr int ROW_STEP = NT / PER_ROW;
    static_assert(NT % PER_ROW == 0 && KC % ROW_STEP == 0, "copies per thread");
    const int r0 = threadIdx.x / PER_ROW, col = (threadIdx.x % PER_ROW) * 4;
    float* dst = ring + (c % STAGES) * KC * LDW + r0 * LDW + col;
    const float* src = W + (size_t)(k0 + r0) * HIDDEN + col;
#pragma unroll
    for (int r = 0; r < KC; r += ROW_STEP) {
      const bool valid = k0 + r0 + r < k_real;
      cp_async16(dst + r * LDW, valid ? src + r * HIDDEN : W, valid);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// acc += a[:, 0:KC] @ w[0:KC, :] for the warp's 64 x 64 block, in split-TF32
// (a: act at the chunk's first column; w: the stage at the warp's first
// column).  The tensor cores truncate when they add into their accumulator;
// over a 512-deep layer (192 mma per output) that bias reaches ~2e-5 in the
// SDF.  So each 8-deep step's three products go into a fresh partial sum,
// which a round-to-nearest add folds into acc.
__device__ __forceinline__ void mma_chunk(float (&acc)[MI][NI][4], const float* a,
                                          const float* w, int g, int t) {
#pragma unroll 1
  for (int kk = 0; kk < KC; kk += 8) {
    uint32_t bh[NI][2], bl[NI][2];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const float* p = w + (kk + t) * LDW + ni * 8 + g;
      split(p[0], bh[ni][0], bl[ni][0]);             // (k=t,   n=g)
      split(p[4 * LDW], bh[ni][1], bl[ni][1]);       // (k=t+4, n=g)
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      uint32_t ah[4], al[4];
      const float* p = a + (mi * 16 + g) * LDA + kk + t;
      split(p[0], ah[0], al[0]);                     // (g,   t)
      split(p[8 * LDA], ah[1], al[1]);               // (g+8, t)
      split(p[4], ah[2], al[2]);                     // (g,   t+4)
      split(p[8 * LDA + 4], ah[3], al[3]);           // (g+8, t+4)
      // the two small products first, then hi*hi
      float part[NI][4];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_set(part[ni], al, bh[ni]);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_add(part[ni], ah, bl[ni]);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_add(part[ni], ah, bh[ni]);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[ni][e];
    }
  }
}

// torch Softplus(beta=100, threshold=20) on the fast exp and log: within
// ~5e-8 of softplus100 (MUFU ex2/lg2 errors, scaled down by beta)
__device__ __forceinline__ float softplus100_fast(float x) {
  const float bx = 100.f * x;
  return bx > 20.f ? x : __logf(1.f + __expf(fminf(bx, 20.f))) * 0.01f;
}

// act <- acc for the warp's 64 x 64 block; zeroes acc for the next layer
__device__ __forceinline__ void store_acc(float (&acc)[MI][NI][4], float* act, int col0, int g,
                                          int t) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows g and g+8, columns 2t and 2t+1
        float* p = act + (mi * 16 + g + 8 * half) * LDA + col0 + ni * 8 + 2 * t;
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
        acc[mi][ni][2 * half] = acc[mi][ni][2 * half + 1] = 0.f;
      }
}

// act <- softplus(act + bias) in place, after l3 (skip) with x/sqrt(2) in
// the tail columns.  A pass of its own over the tile, four columns a thread,
// so that the accumulators are not live while softplus runs.
__device__ __forceinline__ void activate(float* act, const float* __restrict__ bias, bool skip,
                                         const float* __restrict__ x, int row0, int n,
                                         int d_in) {
  const int skip_cols = HIDDEN - d_in;
  static_assert(NT * 4 % HIDDEN == 0, "a thread keeps its four columns");
  const int col = threadIdx.x * 4 % HIDDEN;
  const float4 b = *reinterpret_cast<const float4*>(bias + col);
#pragma unroll 4
  for (int r = threadIdx.x * 4 / HIDDEN; r < TM; r += NT * 4 / HIDDEN) {
    float4* p = reinterpret_cast<float4*>(act + r * LDA + col);
    float v[4] = {p->x + b.x, p->y + b.y, p->z + b.z, p->w + b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = softplus100_fast(v[e]);
      if (skip) {
        if (col + e >= skip_cols)
          v[e] = row0 + r < n ? x[(size_t)(row0 + r) * d_in + col + e - skip_cols] : 0.f;
        v[e] *= INV_SQRT2;
      }
    }
    *p = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void __launch_bounds__(NT, 1)
    fused_sdf_kernel(const float* __restrict__ x, int n, int d_in,
                     const float* __restrict__ w_in, const float* __restrict__ b_in,
                     const float* __restrict__ w_mid, const float* __restrict__ b_mid,
                     const float* __restrict__ w_out, const float* __restrict__ b_out,
                     float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* act = reinterpret_cast<float*>(smem);  // (TM, LDA)
  float* ring = act + TM * LDA;                 // STAGES x (KC, LDW)
  const int row0 = blockIdx.x * TM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int col0 = warp * WARP_COLS;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) prefetch_chunk(ring, c, d_in, w_in, w_mid);

  // the point tile at its real width, zero padded to K0 columns and TM rows
  for (int i = threadIdx.x; i < TM * K0; i += NT) {
    const int r = i / K0, col = i % K0, row = row0 + r;
    act[r * LDA + col] = (row < n && col < d_in) ? x[(size_t)row * d_in + col] : 0.f;
  }

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int c = 0; c < CHUNKS; ++c) {
    // chunk c has landed for every thread, and every warp is done with chunk
    // c-1, whose stage the next copy overwrites
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    prefetch_chunk(ring, c + STAGES - 1, d_in, w_in, w_mid);

    const bool first = c < CHUNKS_IN;
    const int layer = first ? 0 : 1 + (c - CHUNKS_IN) / CHUNKS_MID;
    const int kc = first ? c : (c - CHUNKS_IN) % CHUNKS_MID;  // chunk within the layer
    mma_chunk(acc, act + kc * KC, ring + (c % STAGES) * KC * LDW + col0, g, t);

    if (kc == (first ? CHUNKS_IN : CHUNKS_MID) - 1) {
      __syncthreads();  // every warp has read act: overwrite it
      store_acc(acc, act, col0, g, t);
      __syncthreads();
      activate(act, layer == 0 ? b_in : b_mid + (layer - 1) * HIDDEN,
               layer == 1 + SKIP_AFTER_MID, x, row0, n, d_in);
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  // last layer: the SDF column only, one 512-long float dot per point
  constexpr int ROWS_PER_WARP = TM / (NT / 32);
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    float s = 0.f;
    for (int k = lane; k < HIDDEN; k += 32) s = fmaf(act[r * LDA + k], w_out[k], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const int row = row0 + r;
    if (lane == 0 && row < n) out[row] = s + b_out[0];
  }
}

int launch(const float* x, int n, int d_in, const float* w_in, const float* b_in,
           const float* w_mid, const float* b_mid, const float* w_out, const float* b_out,
           float* out, cudaStream_t stream) {
  if (n <= 0 || d_in <= 0 || d_in > K0) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_sdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  fused_sdf_kernel<<<(n + TM - 1) / TM, NT, SMEM, stream>>>(x, n, d_in, w_in, b_in, w_mid,
                                                           b_mid, w_out, b_out, out);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 weights: WMMA, synchronous weight chunks
// ---------------------------------------------------------------------------

template <typename T>
struct Cfg;
// bf16: 64 points per block of 16 warps, each warp a 64x32 block of 16x16
// WMMA tiles (64 accumulator registers a thread); rows padded by 8 elements
// against shared-memory bank conflicts.
template <>
struct Cfg<bf16> {
  static constexpr int NT = 512, TM = 64, KC = 64, LDA = HIDDEN + 8, LDW = HIDDEN + 8,
                       WARP_COLS = HIDDEN / (NT / 32), SCRATCH = (NT / 32) * 256;
};

template <typename T>
constexpr size_t smem_bytes() {
  using C = Cfg<T>;
  return sizeof(T) * (C::TM * C::LDA + C::KC * C::LDW) +
         sizeof(float) * (C::TM * K0 + C::SCRATCH);
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// bias + softplus, and after l3 the scaled skip input in the tail columns
template <typename T>
__device__ __forceinline__ T epilogue(float acc, float bias, bool skip, int col,
                                      int skip_cols, const float* xrow) {
  float v = softplus100(acc + bias);
  if (skip) v = (col < skip_cols ? v : to_f(from_f<T>(xrow[col - skip_cols]))) * INV_SQRT2;
  return from_f<T>(v);
}

// rows [k0, k0+KC) of a (k_real, HIDDEN) weight into shared memory; rows at or
// past k_real are zero
template <typename T>
__device__ __forceinline__ void load_chunk(T* wbuf, const T* __restrict__ W, int k0,
                                           int k_real) {
  using C = Cfg<T>;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HIDDEN / VEC;
  for (int i = threadIdx.x; i < C::KC * PER_ROW; i += C::NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < k_real) v = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * HIDDEN + c);
    *reinterpret_cast<uint4*>(wbuf + r * C::LDW + c) = v;
  }
}

// one layer, bf16: warp w owns output columns [32w, 32w+32) for all 64 rows
__device__ void layer_bf16(bf16* act, bf16* wbuf, float* scratch, const bf16* __restrict__ W,
                           int k_real, int k_loop, const float* __restrict__ bias, bool skip,
                           int skip_cols, const float* xs) {
  using C = Cfg<bf16>;
  constexpr int NI = C::WARP_COLS / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[4][NI];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) wmma::fill_fragment(c[mi][ni], 0.f);

  for (int k0 = 0; k0 < k_loop; k0 += C::KC) {
    load_chunk<bf16>(wbuf, W, k0, k_real);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < C::KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        wmma::load_matrix_sync(a[mi], act + mi * 16 * C::LDA + k0 + kk, C::LDA);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, wbuf + kk * C::LDW + warp * C::WARP_COLS + ni * 16, C::LDW);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) wmma::mma_sync(c[mi][ni], a[mi], b, c[mi][ni]);
      }
    }
    __syncthreads();
  }
  // every warp has finished reading act: write this layer's output over it
  float* sc = scratch + warp * 256;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      wmma::store_matrix_sync(sc, c[mi][ni], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = mi * 16 + e / 16, col = warp * C::WARP_COLS + ni * 16 + e % 16;
        act[r * C::LDA + col] =
            epilogue<bf16>(sc[e], bias[col], skip, col, skip_cols, xs + r * K0);
      }
      __syncwarp();
    }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::NT)
    fused_sdf_kernel(const float* __restrict__ x, int n, int d_in, const T* __restrict__ w_in,
                     const float* __restrict__ b_in, const T* __restrict__ w_mid,
                     const float* __restrict__ b_mid, const T* __restrict__ w_out,
                     const float* __restrict__ b_out, float* __restrict__ out) {
  using C = Cfg<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* act = reinterpret_cast<T*>(smem);                           // (TM, LDA)
  T* wbuf = act + C::TM * C::LDA;                                // (KC, LDW)
  float* xs = reinterpret_cast<float*>(wbuf + C::KC * C::LDW);   // (TM, K0)
  float* scratch = xs + C::TM * K0;
  const int row0 = blockIdx.x * C::TM;
  const int skip_cols = HIDDEN - d_in;

  // the point tile at its real width, zero padded to K0 columns and TM rows
  for (int i = threadIdx.x; i < C::TM * K0; i += C::NT) {
    const int r = i / K0, col = i % K0, row = row0 + r;
    const float v = (row < n && col < d_in) ? x[(size_t)row * d_in + col] : 0.f;
    xs[i] = v;
    act[r * C::LDA + col] = from_f<T>(v);
  }
  __syncthreads();

  for (int layer = 0; layer <= N_MID; ++layer) {
    const T* W = layer == 0 ? w_in : w_mid + (size_t)(layer - 1) * HIDDEN * HIDDEN;
    const float* bias = layer == 0 ? b_in : b_mid + (layer - 1) * HIDDEN;
    const int k_real = layer == 0 ? d_in : HIDDEN;
    const int k_loop = layer == 0 ? K0 : HIDDEN;
    const bool skip = layer == 1 + SKIP_AFTER_MID;
    layer_bf16(act, wbuf, scratch, W, k_real, k_loop, bias, skip, skip_cols, xs);
  }

  // last layer: the SDF column only, one 512-long dot per point
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int ROWS_PER_WARP = C::TM / (C::NT / 32);
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    float s = 0.f;
    for (int k = lane; k < HIDDEN; k += 32) s = fmaf(to_f(act[r * C::LDA + k]), to_f(w_out[k]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const int row = row0 + r;
    if (lane == 0 && row < n) out[row] = s + b_out[0];
  }
}

template <typename T>
int launch(const void* x, int n, int d_in, const void* w_in, const void* b_in,
           const void* w_mid, const void* b_mid, const void* w_out, const void* b_out,
           void* out, void* stream) {
  if (n <= 0 || d_in <= 0 || d_in > K0) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<T>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_sdf_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int blocks = (n + Cfg<T>::TM - 1) / Cfg<T>::TM;
  fused_sdf_kernel<T><<<blocks, Cfg<T>::NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, d_in, static_cast<const T*>(w_in),
      static_cast<const float*>(b_in), static_cast<const T*>(w_mid),
      static_cast<const float*>(b_mid), static_cast<const T*>(w_out),
      static_cast<const float*>(b_out), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; the stream is
// the caller's cudaStream_t.  Returns the cudaError_t of the launch (0 = ok).
extern "C" int fused_sdf_raw_f32(const void* x, int n, int d_in, const void* w_in,
                                 const void* b_in, const void* w_mid, const void* b_mid,
                                 const void* w_out, const void* b_out, void* out,
                                 void* stream) {
  return f32::launch(static_cast<const float*>(x), n, d_in, static_cast<const float*>(w_in),
                     static_cast<const float*>(b_in), static_cast<const float*>(w_mid),
                     static_cast<const float*>(b_mid), static_cast<const float*>(w_out),
                     static_cast<const float*>(b_out), static_cast<float*>(out),
                     static_cast<cudaStream_t>(stream));
}

extern "C" int fused_sdf_raw_bf16(const void* x, int n, int d_in, const void* w_in,
                                  const void* b_in, const void* w_mid, const void* b_mid,
                                  const void* w_out, const void* b_out, void* out,
                                  void* stream) {
  return launch<bf16>(x, n, d_in, w_in, b_in, w_mid, b_mid, w_out, b_out, out, stream);
}
