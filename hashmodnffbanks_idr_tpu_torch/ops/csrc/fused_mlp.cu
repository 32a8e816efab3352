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
// One template serves both weight types: float (the 'exact' tracer: FMA on
// the CUDA cores, no TF32) and __nv_bfloat16 (guidance queries: WMMA on the
// tensor cores, float accumulation).  Each layer rounds its input to the
// weight type, as the Pallas kernel does; biases, softplus and the skip
// scaling stay float.
//
// Bound.  Per point the chain is 2*(59*512 + 6*512^2 + 512*453 + 512) ~ 3.67
// MFLOP.  The float variant is bound by CUDA-core FP32 (~67 TFLOP/s on an
// H100 SXM: ~55 us per 1000 points); the bf16 variant by the tensor cores
// (989 TFLOP/s: ~3.7 us per 1000 points).  The weights (7.4 MB float, 3.7
// MB bf16) are read once per block from L2; from device memory they matter
// only for small N.
//
// Design.  The Pallas kernel keeps every weight resident in VMEM, which
// cannot fit in an SM's 227 KB of shared memory.  Instead a block keeps one
// tile of points on chip across all nine layers (its activations live in
// shared memory, never in device memory) and streams each layer's weights
// through shared memory in k-chunks.  The skip input is written straight
// into the tail columns after l3 (no permutation matmul), the last layer is a
// 512-long dot per point with a warp reduction, x is read at its real width
// and the output is (N,).  This is the simple first version: no TMA, no
// wgmma, no double buffering of the weight chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int HIDDEN = 512;
constexpr int N_MID = 7;           // l1..l7
constexpr int SKIP_AFTER_MID = 2;  // the skip concat follows l3
constexpr int K0 = 64;             // first-layer depth: d_in <= 64, zero padded
constexpr float INV_SQRT2 = 0.70710678118654752f;

template <typename T>
struct Cfg;
// float: 32 points per block of 256 threads, each thread an 8x8 register tile.
template <>
struct Cfg<float> {
  static constexpr int NT = 256, TM = 32, KC = 16, LDA = HIDDEN, LDW = HIDDEN, SCRATCH = 0;
};
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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// torch Softplus(beta=100, threshold=20)
__device__ __forceinline__ float softplus100(float x) {
  const float bx = 100.f * x;
  return bx > 20.f ? x : log1pf(expf(fminf(bx, 20.f))) / 100.f;
}

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

// one layer, float: act (TM, HIDDEN) <- epilogue(act[:, :k_loop] @ W)
__device__ void layer_f32(float* act, float* wbuf, const float* __restrict__ W, int k_real,
                          int k_loop, const float* __restrict__ bias, bool skip,
                          int skip_cols, const float* xs) {
  using C = Cfg<float>;
  // thread -> rows rg*8..rg*8+7 and columns cg + 64*j: the row reads are
  // warp-wide broadcasts, the weight reads hit consecutive banks
  const int rg = threadIdx.x / 64, cg = threadIdx.x % 64;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_loop; k0 += C::KC) {
    load_chunk<float>(wbuf, W, k0, k_real);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < C::KC; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = act[(rg * 8 + i) * C::LDA + k0 + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = wbuf[kk * C::LDW + cg + 64 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cg + 64 * j;
      act[r * C::LDA + col] =
          epilogue<float>(acc[i][j], bias[col], skip, col, skip_cols, xs + r * K0);
    }
  }
  __syncthreads();
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
  float* scratch = xs + C::TM * K0;                              // bf16 only
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
    if constexpr (std::is_same_v<T, float>)
      layer_f32(act, wbuf, W, k_real, k_loop, bias, skip, skip_cols, xs);
    else
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
  return launch<float>(x, n, d_in, w_in, b_in, w_mid, b_mid, w_out, b_out, out, stream);
}

extern "C" int fused_sdf_raw_bf16(const void* x, int n, int d_in, const void* w_in,
                                  const void* b_in, const void* w_mid, const void* b_mid,
                                  const void* w_out, const void* b_out, void* out,
                                  void* stream) {
  return launch<bf16>(x, n, d_in, w_in, b_in, w_mid, b_mid, w_out, b_out, out, stream);
}
