// NFFB's gradient-free encode in one kernel, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package leaves NFFBEmbedder.forward
// (hashmodnffbanks_idr_tpu/models/embedders.py) to XLA, whose fusion on the
// TPU beat a hand-written kernel there.  Eager torch inside the train step's
// CUDA graph has no such fusion: the module's plain forward is about 110
// small kernels a call, and the tracer calls it some 45 times a step under
// no_grad (the march, the line search, the sweep, the secant), so each NFFB
// step spent 12-17 ms in the encoder, nearly all of it in launches and the
// gaps between them.  This kernel computes the same function in one launch
// a call, for the gradient-free queries only (models/embedders.py routes
// them here; everything with autograd stays on the plain forward, which is
// the kernel's plain twin).
//
// Two grids, one kernel body.  nffb_encode_kernel<TorchGrid, ...> takes the
// pure-torch grid with its floor corner ('FFB', 'StyleModNFFB');
// nffb_encode_kernel<NgpGrid, ...> the instant-ngp grid with trilinear
// interpolation ('FFBTcnn'); a trace names each by its grid.  What it
// computes, per point u (IN = 3 inputs; L levels of F = 2 features; level
// width LW = 2F on the torch grid, F on the ngp grid; S = 2 + 2L slots; out
// width W = S * LW; the trunk's NL = L - 1 layers; USED = L - 2 levels read
// by the out layer):
//
//   in01 = (u + bound) / (2 bound),   x = u / bound
//   torch grid:
//   aug  = [sin(2 pi in01 B), cos(2 pi in01 B), grid(in01)]   (2L + L F = L LW
//          columns; grid: the floor corner, hashed with ops/hashgrid.py's
//          TORCH_PRIMES, modulo the level's rows)
//   ngp grid:
//   aug  = grid(in01)                                          (L F columns;
//          pos = in01 scale_l + 0.5, the 8 corners of its cell, each the
//          dense stride index where the level's grid fits, else the XOR of
//          NGP_PRIMES, in 32-bit wrap, modulo the level's rows; their
//          values weighted by the trilinear weights and summed)
//   g_l  = aug[l LW : (l + 1) LW]                               (level l)
//   e_l  = [g_l, g_l, sin(g_l f_1), sin(g_l f_1 + pi/2), ...]   (S slots of LW)
//   e_l  = instance_norm(e_l W_st^T + b_st)                      (with style)
//   h_0  = sin(w0 (x W_0^T + b_0)),  h_i = sin(w0 (h_{i-1} W_i^T + b_i))
//   s    = sum_{l < USED} e_l + sum_{i >= 1} h_i
//   out  = [in01, ((s W_o^T + b_o) + (USED - 1) b_o) / L]
//
// It reads the module's parameters and buffers in place by pointer (table,
// B, every ff_lin, the style's linear_transform, out_layer, the slots'
// scales and phases, the grid's constants): nothing is packed, so nothing
// goes stale while training moves the weights.  It skips what does not
// change the result: every level >= USED (no output column reads its
// encoding, its style transform or its norm, and so its grid features
// either), and the style block's `attention` softmax, which is over a
// singleton axis and so identically 1 for finite inputs.
//
// Two precisions.  float (the exact tracer, the mixed tracer's decisions,
// eval): FP32 FMA on the CUDA cores, precise sinf/cosf (this file is built
// without --use_fast_math), statistics in float.  bf16 (guidance queries,
// fast=True): it rounds to bf16 exactly where the plain path does: the
// ngp grid's corner values where hash_encode(inference=True) rounds them (a
// grid whose largest level has more than 1024 rows), the grid's output
// (grid_x.to(bfloat16)), each slot (bf16 products, sums and sines), the
// operands of every Linear(bf16=True) (weights as they are loaded, inputs as
// they are stored; float accumulation), the style's output
// (mod.to(bfloat16)) and the norm's output.  Sums may run in another order
// than torch's (the 8 corners' in a tree); no rounding point is added or
// left out.
//
// Bound, per point.  Torch grid, L = 6, W = 56: 28,392 multiply-adds (the
// style transform on 4 levels 12,544; the trunk 3x56 + 4 x 56x56, 12,712;
// the out layer 3,136), 484 sines (12 of the Fourier features, 192 slots,
// 280 in the trunk), 12 bytes read and 236 written.  At the H100's 67
// TFLOP/s of FP32 FMA that is 3.5 us at N = 4,096 and 59 us at N = 69,632;
// the bytes are 0.3 and 5 us at 3.35 TB/s.  The weights, 19k floats (77
// KB), come from L2 once a CTA.  Ngp grid, L = 6, W = 28: 7,268
// multiply-adds (the style transform 3,136, the trunk 3,220, the out layer
// 784, 4 levels' 8 corners' weights and weighted sums 128), 236 sines (96
// slots, 140 in the trunk), 12 bytes read and 124 written, and 32 random
// 8-byte reads of the 1.35 MB table (4 levels x 8 corners), from L2; the
// trunk's and the style's products are a quarter of the torch grid's, so
// the gathers' latency, not the products, sets the time of a tile.
//
// Design.  The tracer's calls are mostly 4,096 points, which one thread a
// point would spread over 32 warps of the card's 132 SMs.  So a tile is 32
// points on a CTA of 256 threads, and N = 4,096 fills 128 SMs.  Each CTA
// holds every weight in shared memory, transposed to [k][column] as it is
// loaded (float4 reads along k from L2, all of a thread's in flight at
// once; consecutive threads on consecutive columns, so that the stores fall
// in distinct banks), and walks over tiles (persistent: at most the CTAs
// that fit at once, two an SM), so large calls read the weights once a CTA
// and not once a tile.  Every product is a 32 x W by W x W GEMM on shared
// memory: a thread owns 4 points x 2 columns, reading one float4 of
// activations and one float2 of weights a k (8 point groups across the
// lanes, so each load is one wavefront).  Activations live in [k][point]
// buffers (row stride 36 floats) that the next layer reads as its A
// operand; a row-wise step (the instance norm) is 8 threads a point with
// shuffles.  The levels' sum stays in registers across levels, the trunk's
// sum across layers.  The tile's output rows are contiguous in `out`, so
// they are staged in shared memory and written with coalesced stores.  On
// the ngp grid a thread takes one corner of one (point, level): 8 lanes
// compute their corners' indices and weights, all of a thread's table reads
// are in flight at once, and the 8 weighted values meet in shuffles.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; calls replayed from a CUDA graph,
// chip_smoke.py [encode]): float32, L = 6, StyleModNFFB, 0.029 / 0.099 /
// 0.248 ms at N = 4,096 / 24,576 / 69,632 against the plain module's 0.243 /
// 0.693 / 1.673 ms.  With the sines made free the large call takes 13% less
// time, with the products made free 56% less: the products on the CUDA
// cores, two shared loads for 8 FMAs, are what bounds it; the first
// version, 128 threads a CTA, 4 x 4 tiles and a weight load one float4 at a
// time, took 0.043 / 0.139 / 0.401 ms, half of it waiting on its sines.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int IN = 3;    // the encoders' input width (points, view directions)
constexpr int F = 2;     // features a level (the torch grid's (N, L, 2F) reshape needs 2)
constexpr int P = 32;    // points a tile
constexpr int PS = 36;   // row stride of the [k][point] buffers (16-byte rows, no conflicts)
constexpr int NT = 256;  // threads a CTA
constexpr int NORM_LANES = NT / P;  // threads a point in the row-wise steps
constexpr int MAX_NL = 8;
constexpr unsigned PRIMES[IN] = {1u, 3u, 2654435761u};  // ops/hashgrid.py TORCH_PRIMES
constexpr int CORNERS = 1 << IN;                        // a cell's corners on the ngp grid
constexpr float TWO_PI = 6.283185307179586f;            // float(2 pi), as torch rounds it
constexpr float NORM_EPS = 1e-5f;                       // _instance_norm_rows

constexpr int round4(int v) { return (v + 3) / 4 * 4; }
constexpr int imax(int a, int b) { return a > b ? a : b; }
constexpr int ipow(int b, int e) { return e == 0 ? 1 : b * ipow(b, e - 1); }

enum Grid { TORCH_GRID, NGP_GRID };

// The module's tensors, in the order the wrapper passes them
// (ops/nffb_encode.py tensors).
struct Params {
  const float* x;
  float* out;
  int n;
  double bound;
  const float* table;          // (rows, F)
  const float* ff;             // grid.ff.B (IN, L)
  const float* grid_scales;    // (L,)
  const long long* grid_sizes;    // (L,)
  const long long* grid_offsets;  // (L,)
  const float* scales;         // _scales (S,)
  const float* phase;          // _phase (S,)
  const float* wst;            // style.linear_transform.w (W, W), or null
  const float* bst;
  const float* w[MAX_NL];      // ff_lin[i].w (W, IN) then (W, W)
  const float* b[MAX_NL];
  const float* wo;             // out_layer.w (W, W)
  const float* bo;
};

// The ngp grid's own tensors, after the others in the wrapper's order
struct NgpTables {
  const long long* strides;    // (L, IN) dense strides, mod 2^32
  const unsigned char* dense;  // (L,) stride-indexed levels
  int round_corners;           // bf16: round the corner values
};

struct NgpParams {
  Params p;
  NgpTables t;
};

// The kernel's first template argument, the grid: it names the kernel in a
// trace (nffb_encode_kernel<(anonymous namespace)::NgpGrid, ...>) and sets
// what the kernel takes; the torch grid's kernel takes Params alone
struct TorchGrid {
  static constexpr int KIND = TORCH_GRID;
  using Args = Params;
};
struct NgpGrid {
  static constexpr int KIND = NGP_GRID;
  using Args = NgpParams;
};

__device__ __forceinline__ const Params& params_of(const Params& q) { return q; }
__device__ __forceinline__ const Params& params_of(const NgpParams& q) { return q.p; }

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <int GRID, int L, int W, bool STYLE>
struct Cfg {
  static constexpr int LW = GRID == TORCH_GRID ? 2 * F : F;
  static constexpr int S = 2 + 2 * L, USED = L - 2, NAUG = USED * LW, NL = L - 1;
  static constexpr int CG = W / 2, ITEMS = (P / 4) * CG;  // GEMM tiles of 4 points x 2 columns
  static constexpr float W0 = float(ipow(L, F) - L);      // SIREN w0 (nffb3d.py:83)
  static constexpr float INV_L = 1.0f / float(L);
  static constexpr float INV_W = 1.0f / float(W);
  static constexpr int NV = (W + NORM_LANES - 1) / NORM_LANES;  // a norm thread's columns
  static constexpr int NFF = GRID == TORCH_GRID ? round4(IN * L) : 0;  // grid.ff.B
  // an activation buffer; it also stages the tile's output rows
  static constexpr int ABUF = imax(W * PS, round4(P * (IN + W)));
  // shared memory, in floats; every offset a multiple of 4
  static constexpr int O_WST = 0;
  static constexpr int O_W0 = O_WST + (STYLE ? W * W : 0);
  static constexpr int O_WT = O_W0 + IN * W;
  static constexpr int O_WO = O_WT + (NL - 1) * W * W;
  static constexpr int O_BST = O_WO + W * W;
  static constexpr int O_B0 = O_BST + W;
  static constexpr int O_BT = O_B0 + W;
  static constexpr int O_BO = O_BT + (NL - 1) * W;
  static constexpr int O_FF = O_BO + W;
  static constexpr int O_SC = O_FF + NFF;
  static constexpr int O_PH = O_SC + round4(S);
  static constexpr int O_IN01 = O_PH + round4(S);
  static constexpr int O_XN = O_IN01 + IN * PS;
  static constexpr int O_AUG = O_XN + IN * PS;
  static constexpr int O_A = O_AUG + NAUG * PS;
  static constexpr int O_B = O_A + ABUF;
  static constexpr int O_ES = O_B + ABUF;
  static constexpr int FLOATS = O_ES + W * PS;
  static constexpr size_t SMEM = FLOATS * sizeof(float);
  static_assert(S * LW == W && W % 4 == 0 && NL <= MAX_NL && USED >= 1, "NFFB shape");
  static_assert(ITEMS <= NT, "one GEMM tile a thread");
  static_assert(GRID == TORCH_GRID || (P * USED * CORNERS) % NT == 0,
                "the ngp grid's corners fill whole warps");
};

// dst[k][r] (row length R) = src[r][k] of a row-major (R, K) weight, K % 4 == 0,
// rounded to bf16 in the bf16 variant.  Unrolled, so that a thread's float4
// reads from L2 are all in flight at once.
template <int R, int K, bool BF16>
__device__ __forceinline__ void load_transposed(float* dst, const float* __restrict__ src) {
  constexpr int QUADS = R * (K / 4);
#pragma unroll
  for (int it = 0; it < (QUADS + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (QUADS % NT == 0 || i < QUADS) {
      const int r = i % R, q = i / R;
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + r * K) + q);
      dst[(4 * q + 0) * R + r] = rnd<BF16>(v.x);
      dst[(4 * q + 1) * R + r] = rnd<BF16>(v.y);
      dst[(4 * q + 2) * R + r] = rnd<BF16>(v.z);
      dst[(4 * q + 3) * R + r] = rnd<BF16>(v.w);
    }
  }
}

// acc[r][j] = sum_k xs[k][4 rg + r] * wt[k][2 cg + j]
template <int K, int W>
__device__ __forceinline__ void mac(const float* xs, const float* wt, int rg, int cg,
                                    float (&acc)[4][2]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(xs + k * PS + 4 * rg);
    const float2 b = *reinterpret_cast<const float2*>(wt + k * W + 2 * cg);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[r][0] = fmaf(av[r], b.x, acc[r][0]);
      acc[r][1] = fmaf(av[r], b.y, acc[r][1]);
    }
  }
}

// ys[2 cg + j][4 rg + r] = v[r][j]
__device__ __forceinline__ void store_cols(float* ys, int rg, int cg, const float (&v)[4][2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
    *reinterpret_cast<float4*>(ys + (2 * cg + j) * PS + 4 * rg) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

// ops/hashgrid.py NGP_PRIMES, as values: a namespace-scope array is host
// memory, which device code cannot index
__device__ __forceinline__ unsigned ngp_prime(int d) {
  return d == 0 ? 1u : d == 1 ? 2654435761u : 805459861u;
}

// the ngp grid's aug columns of the used levels: thread e takes corner
// e % 8 of (point, level) e / 8, so a point-level's 8 corners are 8
// neighbouring lanes; each computes its corner's row and trilinear weight
// as ops/hashgrid.py does (pos = in01 scale + 0.5, the weight's factors
// multiplied in axis order), and the weighted values meet in shuffles
template <int USED, bool BF16>
__device__ __forceinline__ void ngp_grid_columns(const Params& p, const NgpTables& grid,
                                                 const float* in01, float* aug) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int it = 0; it < P * USED * CORNERS / NT; ++it) {
    const int e = it * NT + tid;
    const int corner = e % CORNERS, q = (e / CORNERS) % P, g = e / (CORNERS * P);
    const float s = __ldg(p.grid_scales + g);
    unsigned hashed = 0u, dense = 0u;
    float w = 1.0f;
#pragma unroll
    for (int d = 0; d < IN; ++d) {
      const float pos = __fadd_rn(__fmul_rn(in01[d * PS + q], s), 0.5f);
      const float fl = floorf(pos);
      const float fr = __fsub_rn(pos, fl);
      const unsigned bit = (corner >> d) & 1u;
      const unsigned c = unsigned(int(fl)) + bit;  // the int64 corner's low 32 bits
      const float wd = bit ? fr : __fsub_rn(1.0f, fr);
      w = d == 0 ? wd : __fmul_rn(w, wd);
      hashed ^= c * ngp_prime(d);
      dense += c * unsigned(__ldg(grid.strides + g * IN + d));
    }
    const unsigned idx = __ldg(grid.dense + g) ? dense : hashed;
    // a level's rows fit 32 bits (ops/nffb_encode.py checks)
    const long long row = (long long)(idx % unsigned(__ldg(p.grid_sizes + g))) +
                          __ldg(p.grid_offsets + g);
    float2 v = __ldg(reinterpret_cast<const float2*>(p.table) + row);
    if (BF16 && grid.round_corners) {
      v.x = rnd<true>(v.x);
      v.y = rnd<true>(v.y);
    }
    v.x = __fmul_rn(v.x, w);
    v.y = __fmul_rn(v.y, w);
#pragma unroll
    for (int m = 1; m < CORNERS; m *= 2) {
      v.x = __fadd_rn(v.x, __shfl_xor_sync(0xffffffffu, v.x, m));
      v.y = __fadd_rn(v.y, __shfl_xor_sync(0xffffffffu, v.y, m));
    }
    if (corner == 0) {
      aug[(g * F) * PS + q] = rnd<BF16>(v.x);
      aug[(g * F + 1) * PS + q] = rnd<BF16>(v.y);
    }
  }
}

// One kernel for both grids, the grid its first template argument, and the
// body its own: held in an inlined device function under two kernels, the
// body compiled the torch grid's L = 6 kernels to other instructions (its
// weight loads' address arithmetic in another order); this way they are the
// instructions the torch grid's kernel had alone
template <class Grid, int L, int W, bool STYLE, bool BF16>
__global__ void __launch_bounds__(NT, 2) nffb_encode_kernel(const typename Grid::Args q) {
  constexpr int GRID = Grid::KIND;
  const Params& p = params_of(q);
  using C = Cfg<GRID, L, W, STYLE>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;

  // the weights, once a CTA
  if constexpr (STYLE) load_transposed<W, W, BF16>(sm + C::O_WST, p.wst);
  for (int i = tid; i < W * IN; i += NT)
    sm[C::O_W0 + (i % IN) * W + i / IN] = rnd<BF16>(__ldg(p.w[0] + i));
#pragma unroll
  for (int l = 1; l < C::NL; ++l)
    load_transposed<W, W, BF16>(sm + C::O_WT + (l - 1) * W * W, p.w[l]);
  load_transposed<W, W, BF16>(sm + C::O_WO, p.wo);
  for (int i = tid; i < W; i += NT) {
    if constexpr (STYLE) sm[C::O_BST + i] = __ldg(p.bst + i);
    sm[C::O_B0 + i] = __ldg(p.b[0] + i);
#pragma unroll
    for (int l = 1; l < C::NL; ++l) sm[C::O_BT + (l - 1) * W + i] = __ldg(p.b[l] + i);
    sm[C::O_BO + i] = __ldg(p.bo + i);
  }
  if constexpr (GRID == TORCH_GRID)
    for (int i = tid; i < IN * L; i += NT) sm[C::O_FF + i] = __ldg(p.ff + i);
  for (int i = tid; i < C::S; i += NT) {
    sm[C::O_SC + i] = __ldg(p.scales + i);
    sm[C::O_PH + i] = __ldg(p.phase + i);
  }
  __syncthreads();

  const float* ff = sm + C::O_FF;
  const float* sc = sm + C::O_SC;
  const float* ph = sm + C::O_PH;
  float* in01 = sm + C::O_IN01;
  float* xn = sm + C::O_XN;
  float* aug = sm + C::O_AUG;
  float* es_buf = sm + C::O_ES;
  // inputs as torch computes them on the card: a float scalar divisor is a
  // product with its float reciprocal
  const float bound = float(p.bound);
  const float inv_b = 1.0f / bound, inv_2b = 1.0f / float(2.0 * p.bound);
  const int rg = tid % 8, cg = tid / 8;  // this thread's GEMM tile, if tid < ITEMS
  const bool mm = tid < C::ITEMS;
  const int np = tid / NORM_LANES, nq = tid % NORM_LANES;  // this thread's norm row, phase
  const int tiles = (p.n + P - 1) / P;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int base = tile * P;
    // 0: the tile's inputs ([k][point])
    if (tid < P) {
      const int gi = base + tid;
#pragma unroll
      for (int d = 0; d < IN; ++d) {
        const float u = gi < p.n ? __ldg(p.x + (size_t)gi * IN + d) : 0.0f;
        in01[d * PS + tid] = (u + bound) * inv_2b;
        xn[d * PS + tid] = rnd<BF16>(u * inv_b);
      }
    }
    __syncthreads();

    // 1: the grid's columns that the used levels read
    if constexpr (GRID == NGP_GRID) {
      ngp_grid_columns<C::USED, BF16>(p, q.t, in01, aug);
    } else {
#pragma unroll
      for (int it = 0; it < (C::NAUG * P + NT - 1) / NT; ++it) {
        const int e = it * NT + tid;
        if (e >= C::NAUG * P) break;
        const int q = e % P, k = e / P;
        const float u0 = in01[q], u1 = in01[PS + q], u2 = in01[2 * PS + q];
        float v;
        if (k < 2 * L) {
          const int j = k % L;
          const float t = TWO_PI * fmaf(u2, ff[2 * L + j], fmaf(u1, ff[L + j], u0 * ff[j]));
          v = k < L ? sinf(t) : cosf(t);
        } else {
          const int g = (k - 2 * L) / F, f = (k - 2 * L) % F;
          const float s = __ldg(p.grid_scales + g);
          const unsigned h = unsigned(int(floorf(u0 * s))) * PRIMES[0] ^
                             unsigned(int(floorf(u1 * s))) * PRIMES[1] ^
                             unsigned(int(floorf(u2 * s))) * PRIMES[2];
          const long long row = (long long)((unsigned long long)h %
                                            (unsigned long long)__ldg(p.grid_sizes + g)) +
                                __ldg(p.grid_offsets + g);
          v = __ldg(p.table + row * F + f);
        }
        aug[k * PS + q] = rnd<BF16>(v);
      }
    }
    __syncthreads();

    // 2: each used level's slots, style transform and norm; their sum
    float es[C::NV];
    for (int l = 0; l < C::USED; ++l) {
      float* emb = sm + C::O_A;
#pragma unroll
      for (int it = 0; it < (W * P + NT - 1) / NT; ++it) {
        const int e = it * NT + tid;
        if ((W * P) % NT != 0 && e >= W * P) break;
        const int q = e % P, c = e / P, s = c / C::LW, j = c % C::LW;
        const float g = aug[(l * C::LW + j) * PS + q];
        float v;
        if constexpr (BF16) {
          const float pre = rnd<true>(__fmul_rn(g, rnd<true>(sc[s])));
          v = s < 2 ? pre : rnd<true>(sinf(rnd<true>(__fadd_rn(pre, rnd<true>(ph[s])))));
        } else {
          const float pre = __fmul_rn(g, sc[s]);
          v = s < 2 ? pre : sinf(__fadd_rn(pre, ph[s]));
        }
        emb[c * PS + q] = v;
      }
      __syncthreads();
      if constexpr (STYLE) {
        float* mod = sm + C::O_B;
        if (mm) {
          float acc[4][2];
          mac<W, W>(emb, sm + C::O_WST, rg, cg, acc);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              acc[r][j] = rnd<BF16>(__fadd_rn(acc[r][j], sm[C::O_BST + 2 * cg + j]));
          store_cols(mod, rg, cg, acc);
        }
        __syncthreads();
        float v[C::NV], sum = 0.0f;
#pragma unroll
        for (int i = 0; i < C::NV; ++i) {
          const int c = nq + NORM_LANES * i;
          v[i] = W % NORM_LANES == 0 || c < W ? mod[c * PS + np] : 0.0f;
          sum += v[i];
        }
#pragma unroll
        for (int m = 1; m < NORM_LANES; m *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, m);
        const float mean = __fmul_rn(sum, C::INV_W);
        float sq = 0.0f;
#pragma unroll
        for (int i = 0; i < C::NV; ++i) {
          const float d = v[i] - mean;
          if (W % NORM_LANES == 0 || nq + NORM_LANES * i < W) sq = fmaf(d, d, sq);
        }
#pragma unroll
        for (int m = 1; m < NORM_LANES; m *= 2) sq += __shfl_xor_sync(0xffffffffu, sq, m);
        const float sd = sqrtf(__fadd_rn(__fmul_rn(sq, C::INV_W), NORM_EPS));
#pragma unroll
        for (int i = 0; i < C::NV; ++i) {
          const float nv = rnd<BF16>((v[i] - mean) / sd);
          es[i] = l == 0 ? nv : es[i] + nv;
        }
      } else {
#pragma unroll
        for (int i = 0; i < C::NV; ++i) {
          const int c = nq + NORM_LANES * i;
          const float nv = W % NORM_LANES == 0 || c < W ? emb[c * PS + np] : 0.0f;
          es[i] = l == 0 ? nv : es[i] + nv;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < C::NV; ++i)
      if (W % NORM_LANES == 0 || nq + NORM_LANES * i < W)
        es_buf[(nq + NORM_LANES * i) * PS + np] = es[i];

    // 3: the SIREN trunk; the sum of its layers after the first in registers
    float* cur = sm + C::O_A;
    float* nxt = sm + C::O_B;
    float xs[4][2];
    if (mm) {
      float acc[4][2];
      mac<IN, W>(xn, sm + C::O_W0, rg, cg, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          acc[r][j] = rnd<BF16>(
              sinf(__fmul_rn(C::W0, __fadd_rn(acc[r][j], sm[C::O_B0 + 2 * cg + j]))));
      store_cols(cur, rg, cg, acc);
    }
    __syncthreads();
    // not unrolled: each layer inlines 8 sinf, slow path and all; unrolled,
    // the build took 15.0 s against 10.7 and a call 0-3% less time
#pragma unroll 1
    for (int l = 1; l < C::NL; ++l) {
      if (mm) {
        float acc[4][2];
        mac<W, W>(cur, sm + C::O_WT + (l - 1) * W * W, rg, cg, acc);
        const float* bias = sm + C::O_BT + (l - 1) * W + 2 * cg;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float h = sinf(__fmul_rn(C::W0, __fadd_rn(acc[r][j], bias[j])));
            xs[r][j] = l == 1 ? h : xs[r][j] + h;
            acc[r][j] = rnd<BF16>(h);
          }
        if (l + 1 < C::NL) store_cols(nxt, rg, cg, acc);
      }
      if (l + 1 < C::NL) __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    // cur: free (the last layer stored nothing); nxt: the last layer's input

    // 4: the out layer's input, the levels' sum plus the trunk's
    if (mm) {
      float s[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 e4 = *reinterpret_cast<const float4*>(es_buf + (2 * cg + j) * PS + 4 * rg);
        s[0][j] = rnd<BF16>(e4.x + xs[0][j]);
        s[1][j] = rnd<BF16>(e4.y + xs[1][j]);
        s[2][j] = rnd<BF16>(e4.z + xs[2][j]);
        s[3][j] = rnd<BF16>(e4.w + xs[3][j]);
      }
      store_cols(cur, rg, cg, s);
    }
    __syncthreads();

    // 5: the out layer, staged row-major in `nxt`, then the tile's rows of out
    float* stage = nxt;
    if (mm) {
      float acc[4][2];
      mac<W, W>(cur, sm + C::O_WO, rg, cg, acc);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float bo = sm[C::O_BO + 2 * cg + j];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float y = __fadd_rn(acc[r][j], bo);
          if (C::USED > 1) y = __fadd_rn(y, __fmul_rn(float(C::USED - 1), bo));
          stage[(4 * rg + r) * (IN + W) + IN + 2 * cg + j] = __fmul_rn(y, C::INV_L);
        }
      }
    }
    if (tid < P) {
#pragma unroll
      for (int d = 0; d < IN; ++d) stage[tid * (IN + W) + d] = in01[d * PS + tid];
    }
    __syncthreads();
    const int rows = min(P, p.n - base);
    float* dst = p.out + (size_t)base * (IN + W);
    for (int i = tid; i < rows * (IN + W); i += NT) dst[i] = stage[i];
  }
}

// the CTAs of `kernel` that fit on the current device at once (queried once
// a device), its shared memory limit set on first use
template <class Grid, int L, int W, bool STYLE, bool BF16>
int launch(const typename Grid::Args& q, int n, cudaStream_t stream) {
  using C = Cfg<Grid::KIND, L, W, STYLE>;
  auto kernel = nffb_encode_kernel<Grid, L, W, STYLE, BF16>;
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  const int tiles = (n + P - 1) / P;
  const int grid = tiles < resident[dev] ? tiles : resident[dev];
  kernel<<<grid, NT, C::SMEM, stream>>>(q);
  return (int)cudaGetLastError();
}

template <class Grid, int L, int W>
int dispatch(bool style, bool bf16, const typename Grid::Args& q, int n, cudaStream_t stream) {
  if (style)
    return bf16 ? launch<Grid, L, W, true, true>(q, n, stream)
                : launch<Grid, L, W, true, false>(q, n, stream);
  return bf16 ? launch<Grid, L, W, false, true>(q, n, stream)
              : launch<Grid, L, W, false, false>(q, n, stream);
}

// the module's pointers in the wrapper's order into `p`; the index of the
// first pointer after them
int read_tensors(int levels, const void* const* tensors, Params& p) {
  int i = 0;
  p.table = static_cast<const float*>(tensors[i++]);
  p.ff = static_cast<const float*>(tensors[i++]);
  p.grid_scales = static_cast<const float*>(tensors[i++]);
  p.grid_sizes = static_cast<const long long*>(tensors[i++]);
  p.grid_offsets = static_cast<const long long*>(tensors[i++]);
  p.scales = static_cast<const float*>(tensors[i++]);
  p.phase = static_cast<const float*>(tensors[i++]);
  p.wst = static_cast<const float*>(tensors[i++]);
  p.bst = static_cast<const float*>(tensors[i++]);
  for (int l = 0; l < levels - 1; ++l) {
    p.w[l] = static_cast<const float*>(tensors[i++]);
    p.b[l] = static_cast<const float*>(tensors[i++]);
  }
  p.wo = static_cast<const float*>(tensors[i++]);
  p.bo = static_cast<const float*>(tensors[i++]);
  return i;
}

}  // namespace

// Plain C interface for ctypes.  `grid`: TORCH_GRID (0) or NGP_GRID (1);
// `levels`, `width`: the module's L and out width, one of the grid's
// compiled shapes (the torch grid: L 6 width 56, L 4 width 40; the ngp
// grid: L 6 width 28, L 4 width 20; in 3, F 2); `style`: with the style
// block (StyleModNFFB, FFBTcnn's preset), else FFB; `bf16`: the guidance
// path; `round_corners`: the ngp grid's corner values rounded to bf16 on
// that path (ignored on the torch grid).  x (n, 3) float; out (n, 3 +
// width) float; `tensors`: the module's device pointers in the wrapper's
// order (table, ff.B (null on the ngp grid), grid scales, sizes, offsets,
// _scales, _phase, style w, style b (null without style), ff_lin[i] w and b
// for each of the L - 1 layers, out_layer w and b; then on the ngp grid its
// strides and dense flags).  Returns the cudaError_t of the launch (0 =
// ok); a grid or shape it is not built for is cudaErrorInvalidValue.
extern "C" int nffb_encode(int grid, int levels, int width, int style, int bf16,
                           int round_corners, const void* x, int n, double bound,
                           const void* const* tensors, void* out, void* stream) {
  if (n <= 0 || levels < 3 || levels - 1 > MAX_NL) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = static_cast<const float*>(x);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.bound = bound;
  int i = read_tensors(levels, tensors, p);
  if (style && (p.wst == nullptr || p.bst == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid == TORCH_GRID) {
    if (levels == 6 && width == 56) return dispatch<TorchGrid, 6, 56>(style != 0, bf16 != 0, p, n, s);
    if (levels == 4 && width == 40) return dispatch<TorchGrid, 4, 40>(style != 0, bf16 != 0, p, n, s);
    return (int)cudaErrorInvalidValue;
  }
  if (grid != NGP_GRID) return (int)cudaErrorInvalidValue;
  NgpTables t{};
  t.strides = static_cast<const long long*>(tensors[i++]);
  t.dense = static_cast<const unsigned char*>(tensors[i++]);
  t.round_corners = round_corners;
  if (t.strides == nullptr || t.dense == nullptr) return (int)cudaErrorInvalidValue;
  const NgpParams q{p, t};
  if (levels == 6 && width == 28) return dispatch<NgpGrid, 6, 28>(style != 0, bf16 != 0, q, n, s);
  if (levels == 4 && width == 20) return dispatch<NgpGrid, 4, 20>(style != 0, bf16 != 0, q, n, s);
  return (int)cudaErrorInvalidValue;
}
