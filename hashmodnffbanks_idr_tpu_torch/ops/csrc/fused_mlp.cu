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
// The first layer's depth K0 (d_in rounded up to a compiled depth, rows past
// d_in zero) is a template parameter of both variants: 64, 128, 256 or 512,
// so every d_in < 512 that the JAX kernel takes is served (the encoders give
// 9 to 102).  It sets only l0's chunk count; the ring, the tile and the
// epilogues are the same at every depth.
//
// Two variants.  float weights (the 'exact' tracer) run on the tensor cores
// in split-TF32 on wgmma; bf16 weights (guidance queries) on bf16 wgmma
// with float accumulation.  Each layer rounds its input to the weight type,
// as the Pallas kernel does; biases, softplus and the skip scaling stay
// float.
//
// float variant: bound.  Per point the chain is 2*(59*512 + 6*512^2 +
// 512*453 + 512) ~ 3.67 MFLOP.  To keep float32 accuracy on the TF32 tensor
// cores every product a*b becomes three TF32 products, a_lo*b_hi + a_hi*b_lo
// + a_hi*b_hi (x = hi + lo, hi = tf32_rna(x), lo = tf32_rna(x - hi), both
// with their 13 low bits cleared, so that it does not matter whether the
// tensor cores truncate or round an operand), so the bound is 3 x 3.67
// MFLOP per point at the H100's 495 TFLOP/s dense TF32: 1.094 ms at
// N=49152, 0.091 ms at N=4096 and 0.045 ms at N=2048.  (On the CUDA cores'
// 67 TFLOP/s FP32 the same chain is bound at 2.693 ms at N=49152.)
//
// float variant: design.  The Pallas kernel keeps all 7.4 MB of weights
// resident in VMEM; an SM has 227 KB.  So a tile of 64 points stays on chip
// across all nine layers (a 64x512 float activation tile in shared memory,
// 132,096 B, never in device memory) and the weights stream through it.  A
// tile is a cluster of C = 2 or 4 CTAs: each holds the whole tile, the A
// operand of every layer, and computes 512 / C output columns of each
// layer, streaming only those columns' weights, so the cluster reads each
// weight from L2 once a tile.  A CTA is three warpgroups.  Two consumers
// each own half of the CTA's columns for all 64 rows and run their products
// as wgmma.mma_async.m64nNk8.f32.tf32 (N = 128 at C = 2, 64 at C = 4): A
// from registers, each consumer loading its 64x8 fragment of the float tile
// a k-step and splitting it once a warpgroup (the mma.sync kernel split it
// once a warp); B from shared memory through matrix descriptors.  The
// third, the producer, feeds both: each thread copies one 4x4 block (4 k x
// 4 columns) of each consumer's chunk of 16 (C = 2) or 32 (C = 4) weight
// rows with 16-byte cp.async into a raw buffer two chunks ahead; when the
// chunk lands and the consumer has freed the slot, it splits the block
// once (hi, and lo into a second buffer) into the consumer's (hi, lo) slot
// in the layout the descriptors read, transposed on the way, fences the
// stores for the tensor cores (fence.proxy.async) and arrives at the slot's
// `full` mbarrier.  That layout is wgmma's K-major canonical layout without
// swizzle: core matrices of 8 columns x 4 k (128 contiguous bytes), one
// after another along the columns (stride byte offset 128) in panels of 4 k,
// the panels (leading byte offset) padded by 16 bytes so that the
// producer's 16-byte stores fall on 8 bank quads.  (The descriptor fields as
// CUTLASS's cute/arch/mma_sm90_desc.hpp lays them out: with the two offsets
// exchanged the kernel faulted; a 64-byte swizzled layout read the same
// bits and ran no faster.)  Weights are read from L2 once, as float; the
// split lives in shared memory only.
//
// The tensor cores truncate when they add into their accumulator, which
// over a 512-deep layer misses float32 accuracy.  So each fold group of 4
// k-steps (32 k) sums into a fresh partial accumulator (scale-d 0 on its
// first product), which a round-to-nearest add then folds into the float
// accumulators.  Max abs error against the plain twin (NVIDIA H100 80GB
// HBM3, 700 W; scripts/bench_fused_mlp_f32.py --errors-d-in 59 102 198 510,
// N = 4113 and 49152, K0 = 64 / 128 / 256 / 512; the depths other than 32
// k read on earlier revisions of this kernel, which waited once a chunk
// and so took any depth, with the script's FOLD variants), by depth: 8 k
// 1.07-1.19e-6 / 1.43-1.67e-6 / 1.91e-6 / 0.95-1.19e-6; 16 k 1.55e-6 /
// 1.91e-6 / 2.38e-6 / 1.31e-6; 32 k 2.50-2.74e-6 / 3.10-3.34e-6 / 3.81e-6 /
// 2.03-2.15e-6; 64 k 4.77-5.25e-6 / 5.25e-6 / 7.15e-6 / 3.22-3.46e-6.  The
// kernel folds every 32 k: within 1e-5 by 2.6x at its worst depth, and a
// wave 6-10% faster than at 16 k.  A consumer issues a chunk's products as
// soon as the chunk is split, behind the previous chunk's on the same
// partial sum, frees the previous chunk's slot once those are done
// (wgmma.wait_group 1), and waits for all (and folds) once a fold group.
// Every C keeps each column's k order and fold grouping, so every C gives
// the bits of C = 2.
//
// Budget.  Registers: a consumer thread holds N / 2 float accumulators and
// as many partial sums (64 + 64 at C = 2) and the A fragments of a fold
// group (32), under the 200 that setmaxnreg gives it (the producer drops to
// 104: 128 x 104 + 256 x 200 = 384 x 168, the launch bounds' share); ptxas
// reports 168 a thread at launch and no spill at any K0 and C.  One CTA a
// tile would need 256 columns a warpgroup, 128 + 128 accumulators a
// thread, over the 255 cap: the variant compiles C = 2 and 4 only.  Shared
// memory: the tile, and per consumer two (hi, lo) slots and two raw
// buffers of 4 (C = 2) or 8 (C = 4) padded panels (8,256 or 8,320 B each),
// and 8 mbarriers: 231,232 B at C = 2 and 232,000 B at C = 4; one CTA an
// SM.
//
// At a layer's end each consumer runs the epilogue on its accumulators in
// registers (bias, branch-free softplus on the fast exp and log, after l3
// x/sqrt(2), read from device memory, in the tail columns), a cluster
// barrier (which the producer joins once it has split the next layer's
// first chunk) waits until every CTA is done reading its tile, the
// consumers write their activated columns into their own tile with 8-byte
// stores and into the other CTAs' with 16-byte st.shared::cluster (lanes t
// and t^1 trade halves of their n8 tile so that each holds four adjacent
// columns of one row), and a second cluster barrier makes them visible.
// The last layer is a 512-long float dot per point with a warp reduction,
// the cluster's CTAs taking 64 / C rows each.  x is read at its real width
// and only (N,) is written.
//
// C is chosen from N by the caller, for both variants by one rule
// (ops/fused_mlp.py:cluster_size): of the variant's sizes, the one of least
// ceil(tiles C / slots_C) x wave_ms_C, where slots_C is C x the clusters of
// C that can run at once (cudaOccupancyMaxActiveClusters,
// fused_sdf_raw_*_slots) and wave_ms_C the variant's measured time of one
// full wave of clusters of C (fused_mlp.WAVE_MS); a tie goes to the smaller
// C.  The H100 seats 132 CTAs of this variant at C = 2 and 120 at C = 4, so
// f32 takes C = 4 at N=256 and C = 2 from N=2048 up.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; scripts/
// bench_fused_mlp_f32.py and its variants, N=49152 at C = 2 beside the
// kernel as it is, 3.34-3.40 ms): the products alone (no copies, splits or
// A loads: wgmma_only) take 1.90 ms, 57% of the TF32 peak's 1.09; without
// the copies 2.64-2.80; without the producer's split 3.04.  So the weight
// stream from L2 (every CTA of a wave reads the same 7.4 MB, 16 KB a chunk)
// is the largest part after the products, then the split.  Two more chunks
// in flight (one (hi, lo) slot and four raw buffers) ran slower, and so did
// copies issued before the split; tiles reading their rows in a rotated
// order moved nothing, though all threads copying the same 16 bytes made a
// wave 12x slower (copy_same).
//
// bf16 variant: bound.  The same 3.67 MFLOP per point, one bf16 product per
// product, at the H100's 989 TFLOP/s dense bf16: 0.258 ms at N=69632 and
// 0.0152 ms at N=4096.
//
// bf16 variant: design.  The float variant's skeleton on bf16 wgmma: a CTA
// is two consumer warpgroups and a producer warpgroup, a tile of points
// stays on chip across all nine layers as a bf16 tile in shared memory (the
// A operand of every layer), and the weights stream through a ring.  Every
// product is a wgmma.mma_async.m64nNk16.f32.bf16.bf16 with both operands in
// shared memory, read through matrix descriptors: A, the tile, in the
// K-major layout without swizzle (core matrices of 8 rows x 8 k, 128
// contiguous bytes, the rows' one after another, panels of 8 k padded by 32
// bytes); B, the weights, in the MN-major (transposed-B, imm-trans-b 1)
// layout (core matrices of 8 k x 8 columns, the columns' one after another,
// panels of 8 k), which is how the weights lie, (k, n) with n fastest, so
// nothing is transposed.  A comes from shared memory, not registers: the
// same 2 KB a warpgroup and k-step are read either way, and from the
// descriptor a consumer's loop is mbarrier waits and wgmma issues, with no
// A fragments kept live beside up to 128 accumulators.  (The descriptor
// fields as CUTLASS's cute/arch/mma_sm90_desc.hpp lays out the no-swizzle
// layouts: the leading byte offset steps k, the stride byte offset the rows
// of A and the columns of B; with B's two exchanged the kernel faulted on
// the card.)
//
// The configurations (tile, C), C the CTAs of a cluster that share the tile
// through distributed shared memory, each computing 512 / C columns of each
// layer and streaming only their weights:
//   (128, 4): each consumer owns 64 rows of a 128-point tile and all of the
//     CTA's 128 columns (m64n128k16), so both read the same weight chunk:
//     each weight byte read from L2 serves 128 points.
//   (64, 1): a 128-point tile on one CTA would take 64 x 512 float
//     accumulators a consumer, 256 registers a thread, over the cap, so the
//     tile is 64 points and the consumers split the columns (m64n256k16).
// Not compiled, as the rule never takes them on the H100: (128, 2), the same
// layout at m64n256k16, whose waves end at the same N as (64, 1)'s and took
// 0.0999-0.1001 ms against 0.0775 (NVIDIA H100 80GB HBM3, 700 W;
// scripts/bench_fused_mlp_f32.py --dtype bf16 while it was compiled; below:
// its ring keeps too few bytes in flight); (64, 2) and (64, 4), which serve
// 64 points a weight byte; (192, 4), whose 192 KB tile leaves no room for a
// ring.
//
// Budget.  Registers: 128 (C = 1) or 64 (C = 4) float accumulators a
// consumer thread and, in the epilogue, their 64 or 32 bf16 pairs, under the
// 224 that setmaxnreg gives a consumer (the producer drops to 56: 128 x 56 +
// 256 x 224 = 384 x 168, the launch bounds' share); ptxas reports 168 a
// thread at launch and no spill at any <K0, C>.  Shared memory: the tile, 64
// panels of TM x 16 + 32 bytes (133,120 B at TM = 128, 67,584 at 64), then
// stages of KC weight rows of the CTA's columns (KC = 32 at C = 1, 64 at C =
// 4: 32 KB a stage at C = 1, 16 KB at 4), as many as fit with their two
// mbarriers each (5 at C = 1, 6 at 4): 231,504 B at C = 1, 231,520 at 4; one
// CTA an SM.
//
// The stream.  The producer's thread 0 copies each chunk with the Tensor
// Memory Accelerator, one bulk copy (cp.async.bulk) of COLS x 16 bytes for
// each 8-row group, from a pre-tiled image of the weights in device memory
// (ops/fused_mlp.py:stream_image, built by pack_params: l0 zero-padded to
// K0, then l1..l7, in the stages' core-matrix order), into a slot whose
// `full` mbarrier expects the chunk's bytes; the consumers issue a chunk's
// products as soon as it lands, behind the previous chunk's, and free the
// previous chunk's slot (its `empty` mbarrier) once those are done
// (wgmma.wait_group 1).  The copies write through the async proxy, which
// the tensor cores read, so no proxy fence stands between them.  (16-byte
// cp.async copies by the producer's 128 threads, handed over with
// cp.async.mbarrier.arrive.noinc, kept too few bytes in flight: on the card
// that stream alone was slower than the bulk copies' whole kernel.)
//
// A layer's end.  The consumers await the layer's last products (wait_group
// 0) and activate their accumulators in registers: bias, branch-free softplus
// on MUFU ex2/lg2, after l3 bf16(x)/sqrt(2) (x read at its real width from
// device memory) in the tail columns, rounding to bf16. Once every CTA of the
// cluster is done reading its tile (the first cluster barrier, arrived at
// right after the wait and waited for after the activation; at C = 1 a named
// barrier of the consumers), each stores its block into its own tile and the
// others' with 16-byte stores, st.shared and st.shared::cluster: a quad's 4x4
// transpose by shuffles gives each lane the 8 columns of one row of one n8
// tile, one row of a core matrix, and the 32-byte panel padding puts a
// quarter warp's stores (2 rows x 4 panels) on 8 bank quads.  A second
// barrier makes the tile complete, and each consumer thread fences what it
// has acquired for the tensor cores (fence.proxy.async).  At C > 1 the
// producer takes part in both cluster barriers without stalling the ring: it
// arrives at the first as soon as it has issued the layer's last chunk, and
// waits for it, then arrives at and waits for the second, only before it
// waits for a slot that the consumers free after them; so the ring is full
// when the next layer starts.  The last layer is a 512-long float dot per
// point with a warp reduction, the cluster's CTAs taking TM / C rows each;
// only (N,) is written.
//
// Accumulation.  The tensor cores add each k-step's 16 products into the
// float accumulators with truncation, in k order, the layer's first k-step
// setting them (scale-d 0), with no fold: the truncating adds stay far below
// bf16 rounding (tests/test_torch_fused_mlp.py holds that arithmetic,
// emulated, to the Pallas kernel's bf16 tolerance).  Max abs error against
// the plain twin (NVIDIA H100 80GB HBM3, 700 W;
// scripts/bench_fused_mlp_f32.py --dtype bf16 --errors-d-in 59 102 198 510
// --errors-n 4113 49152, input weights spread), at K0 = 64 / 128 / 256 / 512:
// 1.85e-3 / 3.58e-3 / 3.71e-3 / 1.73e-3 at N=4113, 2.45e-3 / 3.78e-3 /
// 4.46e-3 / 3.54e-3 at N=49152; tol 3e-2, signs agreeing.  Every
// configuration keeps each column's k order and k16 grouping, so every (tile,
// C) gives the bits of (64, 1).
//
// The configuration is chosen from N by the float variant's rule
// (ops/fused_mlp.py:cluster_size) over each configuration's tiles
// (fused_mlp.TILES): on the H100 (132 / 120 slots, waves of 0.077 / 0.074
// ms at (64, 1) / (128, 4)) it takes (128, 4) up to 3,840 points and (64, 1)
// above.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W;
// scripts/bench_fused_mlp_f32.py --dtype bf16 and its variants): at N=69632
// on (64, 1) the kernel takes 0.66-0.67 ms, 2.6x its bound; without
// softplus 0.52-0.53, without the weight copies 0.63-0.64, the products,
// barriers and stores alone (wgmma_only) 0.48-0.49.  So the epilogue's
// softplus on MUFU, which no product overlaps, is the largest part after
// the products, and the stream, 4.1 GB from L2 at about 6.1 TB/s, is nearly
// hidden.  (128, 2) read half the bytes but ran 0.83-0.86 ms there: its
// ring holds 96 KB beside the 130 KB tile, against 160 KB at (64, 1), and
// a CTA's stream is bound by the bytes it keeps in flight (the copies'
// latency under load), not by L2's bandwidth.  At the small calls (one CTA
// a few tiles) the chain of eight layers is latency: (128, 4) takes 0.069
// ms at N=256 and 2048, 0.050 without the stores into other tiles.
//
// Left for later: softplus off MUFU (log1p as a polynomial on the FMA pipe)
// or under the next tile's products (two tiles a CTA, one a consumer); TMA
// multicast of one chunk to the CTAs of several tiles; the K0=128 question.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int HIDDEN = 512;
constexpr int N_MID = 7;           // l1..l7
constexpr int SKIP_AFTER_MID = 2;  // the skip concat follows l3
constexpr float INV_SQRT2 = 0.70710678118654752f;
constexpr int MAX_SMEM = 232448;   // an sm_90 block's dynamic shared memory

// 16 bytes global -> shared without a register round trip; zero-filled when
// !valid (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// ---------------------------------------------------------------------------
// thread-block clusters: both variants run a tile on a cluster of C CTAs
// that share it through distributed shared memory (f32: 64 points on 2 or
// 4; bf16: 64 points on 1, 128 on 4)
// ---------------------------------------------------------------------------

// the CTA's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the shared::cluster address of the shared::cta address `addr` in CTA
// `rank` of the cluster (distributed shared memory)
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Every thread of the cluster (C > 1) or of the CTA (C = 1) has arrived.
// The release and acquire make each thread's stores into any CTA's shared
// memory before the barrier visible to every thread after it.
template <int C>
__device__ __forceinline__ void tile_barrier() {
  if constexpr (C == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
}

// The two halves of tile_barrier at C > 1, so that work that touches no
// other CTA's tile can run between them: arrive releases this thread's
// accesses of shared memory before it; wait returns once every thread of the
// cluster has arrived, and acquires theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma's fences and mbarriers, which both variants' producer and consumer
// warpgroups use
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// returns once at most N of the warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// registers that an asynchronous wgmma reads or writes: the compiler may
// neither move their uses across this point nor give them away before it
template <int R, int E>
__device__ __forceinline__ void fence_regs(float (&v)[R][E]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) asm volatile("" : "+f"(v[i][e])::"memory");
}
template <int R, int E>
__device__ __forceinline__ void fence_regs(uint32_t (&v)[R][E]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) asm volatile("" : "+r"(v[i][e])::"memory");
}

// mbarriers in shared memory (shared::cta addresses)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}" ::"r"(bar)
               : "memory");
}
// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a launch of `tiles` tiles in clusters of C CTAs of `threads` along x
template <int C>
cudaLaunchConfig_t launch_config(int tiles, int threads, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute& attr) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

// `kernel`'s dynamic shared memory limit, set on its first use (`ready`)
template <typename... P>
int allow_smem(void (*kernel)(P...), size_t smem, bool& ready) {
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  return 0;
}

// one launch of `kernel` over `tiles` tiles in clusters of C (C = 1: a plain
// launch)
template <int C, typename... P, typename... A>
int launch_tiles(void (*kernel)(P...), int threads, size_t smem, bool& ready, int tiles,
                 cudaStream_t stream, A... args) {
  if (const int err = allow_smem(kernel, smem, ready)) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config<C>(tiles, threads, smem, stream, attr);
  if (C == 1) cfg.numAttrs = 0;  // a plain launch
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// *out <- C x the number of clusters of C CTAs of `kernel` that can run at
// once on the current device
template <int C, typename... P>
int count_slots(void (*kernel)(P...), int threads, size_t smem, bool& ready, int* out) {
  if (const int err = allow_smem(kernel, smem, ready)) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<C>(1, threads, smem, nullptr, attr);
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return (int)err;
  *out = clusters * C;
  return 0;
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<K0>(), Int<C>()) for the compiled first-layer depth k0 (64, 128, 256
// or 512) and the cluster size (1, 2 or 4); cudaErrorInvalidValue for any
// other
template <class F>
int dispatch(int k0, int cluster, F&& f) {
  const auto at_depth = [&](auto k) -> int {
    switch (cluster) {
      case 1: return f(k, Int<1>());
      case 2: return f(k, Int<2>());
      case 4: return f(k, Int<4>());
      default: return (int)cudaErrorInvalidValue;
    }
  };
  switch (k0) {
    case 64: return at_depth(Int<64>());
    case 128: return at_depth(Int<128>());
    case 256: return at_depth(Int<256>());
    case 512: return at_depth(Int<512>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// float weights: split-TF32 wgmma, A (the activations) from registers and B
// (the weights, split into TF32 hi and lo once a chunk by a producer
// warpgroup) from shared memory, fed by a cp.async ring; one tile of 64
// points shared by a cluster of C CTAs
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int TM = 64;                  // points per tile (per cluster)
// the tile's row stride: A fragments read rows g at column t (stride = 4
// mod 32 banks), free of bank conflicts
constexpr int LDA = HIDDEN + 4;
constexpr size_t TILE_BYTES = sizeof(float) * TM * LDA;
// 8-deep k-steps whose products a partial accumulator sums before a
// round-to-nearest add folds it into the float accumulators
constexpr int FOLD = 4;

// How a cluster of C CTAs splits one tile's work.  Every CTA holds the whole
// 64 x 512 tile (the A operand of every layer) and computes HIDDEN / C output
// columns of each layer.  Two consumer warpgroups each own WG_COLS = COLS /
// 2 of them for all 64 rows (one m64nWG_COLSk8 wgmma a product), each with
// buffers of its own; a third, the producer, copies and splits the weights
// of both.  A chunk is KC weight rows of a consumer's columns; each
// producer thread copies and splits one 4 x 4 block of each consumer's.
template <int C>
struct Split {
  static_assert(C == 2 || C == 4, "cluster sizes 2 and 4");
  static constexpr int NT = 384;                  // two consumer warpgroups, a producer
  static constexpr int CONSUMER_WARPS = 8;
  // registers a thread after setmaxnreg: 128 x 104 + 256 x 200 = 384 x 168,
  // what the launch bounds give each thread at the start
  static constexpr int PRODUCER_REGS = 104, CONSUMER_REGS = 200;
  static constexpr int COLS = HIDDEN / C;         // a CTA's output columns
  static constexpr int WG_COLS = COLS / 2;        // wgmma's N: 128 or 64
  static constexpr int NI = WG_COLS / 8;          // n8 tiles of an accumulator
  static constexpr int KC = C == 2 ? 16 : 32;     // weight rows a chunk
  static constexpr int KS = KC / 8;               // 8-deep k-steps a chunk
  static constexpr int KQ = KC / 4;               // 4-deep panels a chunk
  static constexpr int CPF = FOLD / KS;           // chunks a fold group
  // A panel holds 4 rows k of the chunk for the warpgroup's WG_COLS columns
  // as WG_COLS / 8 core matrices of 8 columns x 4 k (128 B, k fastest: B
  // K-major), one after another, and 16 bytes of padding, which shifts each
  // panel by 4 banks; a buffer is KQ panels, hi or lo of one chunk
  static constexpr int PANEL = WG_COLS / 8 * 128 + 16;
  static constexpr int BUF = KQ * PANEL;
  // Each consumer's HLS slots of (hi, lo), which its products read while
  // the producer splits the next chunk into the other, and RAW buffers
  // where the copies land, as each thread's blocks at the same offsets:
  // chunk c + RAW is copied into the buffer the split of c has just read
  static constexpr int HLS = 2, RAW = 2;
  static constexpr int WG_BYTES = (2 * HLS + RAW) * BUF;  // a warpgroup's buffers
  static constexpr int CHUNKS_MID = HIDDEN / KC;  // each of l1..l7's chunks
  // the tile, both consumers' buffers, and the mbarriers: full and empty
  // of each consumer's (hi, lo) slots
  static constexpr int BARS = 2 * 2 * HLS;
  static constexpr size_t SMEM = TILE_BYTES + 2 * (size_t)WG_BYTES + 8 * BARS;
  static_assert(SMEM <= MAX_SMEM, "f32 tile and weight ring exceed shared memory");
  static_assert(KQ * (WG_COLS / 4) == 128, "one 4 x 4 block of each chunk a thread");
  static_assert(FOLD % KS == 0, "fold groups of whole chunks");
  static_assert(HLS >= CPF, "a consumer holds a fold group's slots until its next chunk is split");
  static_assert(TM % (C * CONSUMER_WARPS) == 0, "the last layer's rows: whole rows a warp");
};

// the chunk stream of first-layer depth K0: l0's chunks, then l1..l7's
template <int K0, int C>
struct Stream {
  static constexpr int KC = Split<C>::KC;
  static_assert(K0 % KC == 0 && K0 <= HIDDEN, "l0 depth: whole chunks, inside the tile");
  static_assert(K0 % (8 * FOLD) == 0, "l0 depth: whole fold groups");
  static constexpr int CHUNKS_IN = K0 / KC;
  static constexpr int CHUNKS = CHUNKS_IN + N_MID * Split<C>::CHUNKS_MID;
};

// Chunk c of the stream: its layer (0 = l0), whether it is the layer's
// last, and the first row k of the layer it covers
template <int K0, int C>
__device__ __forceinline__ int chunk_k(int c, int& layer, bool& last) {
  using S = Split<C>;
  constexpr int CHUNKS_IN = Stream<K0, C>::CHUNKS_IN;
  const bool first = c < CHUNKS_IN;
  const int kc = first ? c : (c - CHUNKS_IN) % S::CHUNKS_MID;  // the chunk in the layer
  layer = first ? 0 : 1 + (c - CHUNKS_IN) / S::CHUNKS_MID;
  last = kc == (first ? CHUNKS_IN : S::CHUNKS_MID) - 1;
  return kc * S::KC;
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, with
// the 13 low bits cleared: the bits of cvt.rna.tf32.f32, so that the tensor
// cores read the same value whether they truncate or round an operand
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32 (x - hi is exact in float)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The matrix descriptor of a B operand at shared address `addr` (16-byte
// aligned) in the layout of Split<C>: no swizzle, K-major core matrices; the
// leading byte offset steps k by 4 (to the next panel), the stride byte
// offset n by 8 (to the next core matrix of the panel)
template <int C>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t LBO = Split<C>::PANEL >> 4, SBO = 128 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (LBO << 16) | (SBO << 32);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d (+)= a b: d the m64n64 float accumulator, a the warpgroup's 64x8 TF32
  // fragment, b the 64x8 TF32 stage through its descriptor; scale_d = 0 sets d
  static __device__ __forceinline__ void mma(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // the same at m64n128
  static __device__ __forceinline__ void mma(float (&d)[16][4], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// Where the thread's 4 x 4 block of a chunk lies in its warpgroup's buffer
// (bytes; tid: the thread in the warpgroup): panel kq (rows 4 kq.. of the
// chunk), columns 4 nb.. of the warpgroup's, i.e. rows 4 (nb % 2).. of core
// matrix nb / 2.  The 8 lanes of a quarter warp take 4 panels x 2 halves
// (C = 2) or 8 panels (C = 4), so that their 16-byte accesses fall on 8
// different bank quads.
template <int C>
__device__ __forceinline__ int block_offset(int tid, int& kq, int& nb) {
  using S = Split<C>;
  kq = tid % S::KQ;
  nb = tid / S::KQ;
  return kq * S::PANEL + (nb / 2) * 128 + (nb % 2) * 64;
}

// The warpgroup's columns [col0, col0 + WG_COLS) of chunk c of the whole
// weight stream (l0's K0 rows, then l1..l7's 512 rows each, KC rows a chunk)
// into its raw buffer c % RAW: the thread's block as 4 rows k of 4 columns
// (16 bytes each); rows at or past d_in in l0 are zero.  Nothing past the
// end.  The caller commits the group.
template <int K0, int C>
__device__ __forceinline__ void prefetch_chunk(unsigned char* bufs, int c, int d_in, int col0,
                                               int block, int kq, int nb,
                                               const float* __restrict__ w_in,
                                               const float* __restrict__ w_mid) {
  using S = Split<C>;
  if (c < Stream<K0, C>::CHUNKS) {
    int layer;
    bool last;
    const int k0 = chunk_k<K0, C>(c, layer, last) + 4 * kq;
    const float* W = layer == 0 ? w_in : w_mid + (size_t)(layer - 1) * HIDDEN * HIDDEN;
    const int k_real = layer == 0 ? d_in : HIDDEN;
    unsigned char* dst = bufs + (size_t)(2 * S::HLS + c % S::RAW) * S::BUF + block;
    const float* src = W + (size_t)k0 * HIDDEN + col0 + 4 * nb;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool valid = k0 + r < k_real;
      cp_async16(dst + 16 * r, valid ? src + r * HIDDEN : W, valid);
    }
  }
}

// The thread's blocks of chunk c, one of each consumer's columns (`bufs`:
// the first consumer's buffers), landed in raw buffer c % RAW as rows k,
// become the B operand's K-major layout, split, in (hi, lo) slot c % HLS:
// column 4 nb + s (row 4 (nb % 2) + s of its core matrix) holds its 4 k as
// hi in the hi buffer and as lo in the lo buffer.  Only the thread itself
// touches its blocks.
template <int C>
__device__ __forceinline__ void split_block(unsigned char* bufs, int c, int block) {
  using S = Split<C>;
  float w[2][4][4];  // [consumer][k][column]
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const unsigned char* raw =
        bufs + q * S::WG_BYTES + (size_t)(2 * S::HLS + c % S::RAW) * S::BUF + block;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(raw + 16 * r);
      w[q][r][0] = v.x;
      w[q][r][1] = v.y;
      w[q][r][2] = v.z;
      w[q][r][3] = v.w;
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    unsigned char* hi = bufs + q * S::WG_BYTES + (size_t)(c % S::HLS) * 2 * S::BUF + block;
    unsigned char* lo = hi + S::BUF;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint4 h, l;
      split(w[q][0][s], h.x, l.x);
      split(w[q][1][s], h.y, l.y);
      split(w[q][2][s], h.z, l.z);
      split(w[q][3][s], h.w, l.w);
      *reinterpret_cast<uint4*>(hi + 16 * s) = h;
      *reinterpret_cast<uint4*>(lo + 16 * s) = l;
    }
  }
}

// the warpgroup's A fragment of the 8-deep k-step at tile column k, split:
// rows 16 wq + g (+ 8) of the warp, columns k + t (+ 4)
__device__ __forceinline__ void load_a(const float* act, int wq, int g, int t, int k,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* p = act + (16 * wq + g) * LDA + k + t;
  split(p[0], hi[0], lo[0]);            // (g,   t)
  split(p[8 * LDA], hi[1], lo[1]);      // (g+8, t)
  split(p[4], hi[2], lo[2]);            // (g,   t+4)
  split(p[8 * LDA + 4], hi[3], lo[3]);  // (g+8, t+4)
}

// torch Softplus(beta=100, threshold=20) on the fast exp and log: within
// ~5e-8 of softplus100 (MUFU ex2/lg2 errors, scaled down by beta).  Branch
// free: both sides are computed and one is selected (a C++ ternary that
// evaluates only its taken side compiles to a branch per element).
__device__ __forceinline__ float softplus100_fast(float x) {
  const float bx = 100.f * x;
  const float soft = __logf(1.f + __expf(fminf(bx, 20.f))) * 0.01f;
  return bx > 20.f ? x : soft;
}

// acc <- softplus(acc + bias) in registers for the warp's rows 16 wq + g (+
// 8) of the tile and the warpgroup's columns col0..; after l3 (SKIP) the
// tail columns take x/sqrt(2) (x read at its real width from device memory)
// and the rest softplus/sqrt(2).  SKIP is a template parameter, so that the
// common epilogue is one basic block.
template <int NI, bool SKIP>
__device__ __forceinline__ void activate(float (&acc)[NI][4], const float* __restrict__ bias,
                                         const float* __restrict__ x, int row0, int n, int d_in,
                                         int wq, int col0, int g, int t) {
  const int skip_cols = HIDDEN - d_in;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int col = col0 + ni * 8 + 2 * t;  // accumulator columns col, col+1
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // rows g and g+8
      float& v0 = acc[ni][2 * half];
      float& v1 = acc[ni][2 * half + 1];
      v0 = softplus100_fast(v0 + b.x);
      v1 = softplus100_fast(v1 + b.y);
      if (SKIP) {
        const int row = row0 + 16 * wq + g + 8 * half;
        if (col >= skip_cols) v0 = row < n ? x[(size_t)row * d_in + col - skip_cols] : 0.f;
        if (col + 1 >= skip_cols) v1 = row < n ? x[(size_t)row * d_in + col + 1 - skip_cols] : 0.f;
        v0 *= INV_SQRT2;
        v1 *= INV_SQRT2;
      }
    }
  }
}

// The warpgroup's activated block into the tile of every CTA of the cluster:
// its own through 8-byte stores (rows g and g+8, columns 2t, 2t+1 of each n8
// tile, free of bank conflicts), the others' through 16-byte
// st.shared::cluster at the addresses `remote` (ranks rank+1, ...,
// rank+C-1), after lanes t and t^1 trade halves so that each holds four
// adjacent columns of one row.  Zeroes acc for the next layer.
template <int NI, int C>
__device__ __forceinline__ void store_tile(float (&acc)[NI][4], float* act,
                                           const uint32_t (&remote)[C], int wq, int col0, int g,
                                           int t) {
  const bool odd = t & 1;
  const int row = 16 * wq + g;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int col = col0 + ni * 8 + 2 * t;
    float (&v)[4] = acc[ni];
    *reinterpret_cast<float2*>(act + row * LDA + col) = make_float2(v[0], v[1]);
    *reinterpret_cast<float2*>(act + (row + 8) * LDA + col) = make_float2(v[2], v[3]);
    const float s0 = odd ? v[0] : v[2], s1 = odd ? v[1] : v[3];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const float4 q = odd ? make_float4(r0, r1, v[2], v[3]) : make_float4(v[0], v[1], r0, r1);
    const int off = (row + (odd ? 8 : 0)) * LDA + col0 + ni * 8 + 4 * (t >> 1);
#pragma unroll
    for (int other = 1; other < C; ++other)
      asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(
                       remote[other] + (uint32_t)(sizeof(float) * off)),
                   "f"(q.x), "f"(q.y), "f"(q.z), "f"(q.w)
                   : "memory");
    v[0] = v[1] = v[2] = v[3] = 0.f;
  }
}

// The producer warpgroup: for each chunk (landed, copied RAW chunks ahead),
// once both consumer warpgroups are done with the (hi, lo) slot it takes,
// each thread splits its block of each consumer's chunk into it, fences the
// writes for the tensor cores and arrives at the slot's `full` barriers;
// then it copies its blocks of chunk c + RAW.  It meets the consumers at the
// cluster barriers of each layer's end once it has split the next layer's
// first chunk.
template <int K0, int C>
__device__ __forceinline__ void produce(unsigned char* bufs, int col0, int d_in, int ptid,
                                        uint32_t bars, const float* __restrict__ w_in,
                                        const float* __restrict__ w_mid) {
  using S = Split<C>;
  constexpr int CHUNKS = Stream<K0, C>::CHUNKS;
  int kq, nb;
  const int block = block_offset<C>(ptid, kq, nb);
  const auto copy = [&](int c) {  // both warpgroups' blocks of chunk c, one commit group
#pragma unroll
    for (int w = 0; w < 2; ++w)
      prefetch_chunk<K0, C>(bufs + w * S::WG_BYTES, c, d_in, col0 + w * S::WG_COLS, block, kq,
                            nb, w_in, w_mid);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
#pragma unroll
  for (int c = 0; c < S::RAW; ++c) copy(c);
  for (int c = 0; c < CHUNKS; ++c) {
    const int slot = c % S::HLS;
    asm volatile("cp.async.wait_group %0;" ::"n"(S::RAW - 1) : "memory");
    if (c >= S::HLS) {  // both consumers are done with chunk c - HLS in this slot
      mbar_wait(bars + 8 * (2 * S::HLS + slot), (c / S::HLS - 1) & 1);
      mbar_wait(bars + 8 * (3 * S::HLS + slot), (c / S::HLS - 1) & 1);
    }
    split_block<C>(bufs, c, block);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(bars + 8 * slot);
    mbar_arrive(bars + 8 * (S::HLS + slot));
    copy(c + S::RAW);
    if (c > 0) {
      int layer;
      bool last;
      chunk_k<K0, C>(c - 1, layer, last);
      if (last) {  // chunk c - 1 ended a layer
        tile_barrier<C>();
        tile_barrier<C>();
      }
    }
  }
  tile_barrier<C>();  // the last layer's end
  tile_barrier<C>();
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <int K0, int C>
__global__ void __launch_bounds__(Split<C>::NT, 1)
    fused_sdf_kernel(const float* __restrict__ x, int n, int d_in,
                     const float* __restrict__ w_in, const float* __restrict__ b_in,
                     const float* __restrict__ w_mid, const float* __restrict__ b_mid,
                     const float* __restrict__ w_out, const float* __restrict__ b_out,
                     float* __restrict__ out) {
  using S = Split<C>;
  constexpr int CHUNKS = Stream<K0, C>::CHUNKS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* act = reinterpret_cast<float*>(smem);  // (TM, LDA)
  unsigned char* bufs = smem + TILE_BYTES;      // each consumer warpgroup's buffers
  // mbarriers: full[w][slot] at HLS w + slot, empty[w][slot] at 2 HLS + HLS w
  // + slot
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(bufs + 2 * S::WG_BYTES));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;                      // 0, 1: consumers; 2: the producer
  // a 1-D cluster is C consecutive blocks, one tile
  const int rank = (int)cluster_rank();
  const int row0 = blockIdx.x / C * TM;
  const int cta_col0 = rank * S::COLS;          // the CTA's first output column

  // the point tile at its real width, zero padded to K0 columns and TM rows
  for (int i = threadIdx.x; i < TM * K0; i += S::NT) {
    const int r = i / K0, col = i % K0, row = row0 + r;
    act[r * LDA + col] = (row < n && col < d_in) ? x[(size_t)row * d_in + col] : 0.f;
  }
  if (threadIdx.x < S::BARS) mbar_init(bars + 8 * threadIdx.x, 128);
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(S::PRODUCER_REGS));
    produce<K0, C>(bufs, cta_col0, d_in, threadIdx.x - 256, bars, w_in, w_mid);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(S::CONSUMER_REGS));
  const int wq = warp % 4;                      // the warp in its warpgroup
  const int g = lane / 4, t = lane % 4;         // fragment coordinates
  const int col0 = cta_col0 + wg * S::WG_COLS;  // the warpgroup's first output column
  const uint32_t bufs_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(bufs + wg * S::WG_BYTES));
  uint32_t remote[C] = {};  // remote[q]: the tile of rank + q (q >= 1)
#pragma unroll
  for (int q = 1; q < C; ++q)
    remote[q] = map_rank(static_cast<uint32_t>(__cvta_generic_to_shared(act)), (rank + q) % C);

  float acc[S::NI][4], part[S::NI][4];
#pragma unroll
  for (int ni = 0; ni < S::NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = part[ni][e] = 0.f;

  // One fold group (CPF chunks) at a time: each chunk's products are issued
  // as soon as it is split, behind the previous chunk's, and the slot of
  // the previous chunk is freed once its products are done; the group's
  // partial sum is read only after the last.
  for (int c0 = 0; c0 < CHUNKS; c0 += S::CPF) {
    uint32_t ah[S::CPF][S::KS][4], al[S::CPF][S::KS][4];
    int layer;
    bool last;
#pragma unroll
    for (int j = 0; j < S::CPF; ++j) {
      const int c = c0 + j, slot = c % S::HLS;
      const int k0 = chunk_k<K0, C>(c, layer, last);  // the chunk's first row of the layer
      mbar_wait(bars + 8 * (S::HLS * wg + slot), (c / S::HLS) & 1);  // chunk c is split
#pragma unroll
      for (int s = 0; s < S::KS; ++s) load_a(act, wq, g, t, k0 + 8 * s, ah[j][s], al[j][s]);
      wgmma_fence();
      const uint32_t hi_addr = bufs_addr + slot * 2 * S::BUF;
#pragma unroll
      for (int s = 0; s < S::KS; ++s) {
        // k-step s reads panels 2 s and 2 s + 1; the two small products
        // first, then hi*hi; the group's first product sets the partial sum
        const uint32_t b_hi = hi_addr + 2 * s * S::PANEL;
        Wgmma<S::WG_COLS>::mma(part, al[j][s], b_desc<C>(b_hi), j > 0 || s > 0);
        Wgmma<S::WG_COLS>::mma(part, ah[j][s], b_desc<C>(b_hi + S::BUF), 1);
        Wgmma<S::WG_COLS>::mma(part, ah[j][s], b_desc<C>(b_hi), 1);
      }
      wgmma_commit();
      if (j > 0) {  // the previous chunk's products are done: its slot is free
        wgmma_wait<1>();
        fence_regs(ah[j - 1]);
        fence_regs(al[j - 1]);
        mbar_arrive(bars + 8 * (2 * S::HLS + S::HLS * wg + (c - 1) % S::HLS));
      }
    }
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(ah[S::CPF - 1]);
    fence_regs(al[S::CPF - 1]);
    mbar_arrive(bars + 8 * (2 * S::HLS + S::HLS * wg + (c0 + S::CPF - 1) % S::HLS));
    // the fold: the group's partial sum into the float accumulators,
    // rounded to nearest
#pragma unroll
    for (int ni = 0; ni < S::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] += part[ni][e];

    if (last) {
      // the layer's end: activate in registers, then replace the tile of
      // every CTA of the cluster once all of them are done reading it
      const float* bias = layer == 0 ? b_in : b_mid + (layer - 1) * HIDDEN;
      if (layer == 1 + SKIP_AFTER_MID)
        activate<S::NI, true>(acc, bias, x, row0, n, d_in, wq, col0, g, t);
      else
        activate<S::NI, false>(acc, bias, x, row0, n, d_in, wq, col0, g, t);
      tile_barrier<C>();  // every CTA of the cluster has read its tile
      store_tile<S::NI, C>(acc, act, remote, wq, col0, g, t);
      // the new tile, complete in every CTA; after the last layer's, no CTA
      // touches another's shared memory, so that each may exit
      tile_barrier<C>();
    }
  }

  // last layer: the SDF column only, one 512-long float dot per point; the
  // cluster's CTAs split the tile's rows, the consumer warps of each CTA
  // its share
  constexpr int ROWS_PER_WARP = TM / C / S::CONSUMER_WARPS;
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = rank * (TM / C) + warp * ROWS_PER_WARP + rr;
    float s = 0.f;
    for (int k = lane; k < HIDDEN; k += 32) s = fmaf(act[r * LDA + k], w_out[k], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const int row = row0 + r;
    if (lane == 0 && row < n) out[row] = s + b_out[0];
  }
}

// the kernel's dynamic shared memory limit is set (on its first use)
template <int K0, int C>
bool ready = false;

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 weights: bf16 wgmma, A (the activation tile) and B (the weights, fed
// by a producer warpgroup's bulk copies) from shared memory through matrix
// descriptors; a tile of 64 or 128 points shared by a cluster of C CTAs
// ---------------------------------------------------------------------------

namespace bf16k {

// How a cluster of C CTAs splits one tile's work.  Every CTA holds the whole
// tile (the A operand of every layer) and computes COLS = HIDDEN / C output
// columns of each layer, streaming only those columns' weights.  A CTA is
// three warpgroups: two consumers, which run the products, and a producer,
// which copies the weights.  At C = 4 the tile is 128 points and each
// consumer owns 64 rows and all 128 columns (one m64n128k16 wgmma a k-step),
// so both consumers read every weight chunk: each weight byte read from L2
// serves 128 points.  At C = 1 a 128-point tile would need 64 x 512
// accumulators a consumer, 256 registers a thread, over the cap: the tile is
// 64 points and the consumers split the columns, 256 each.  (C = 2 is not
// compiled: see the note at the top.)
template <int C>
struct Split {
  static_assert(C == 1 || C == 4, "cluster sizes 1 and 4");
  static constexpr int TM = C == 1 ? 64 : 128;    // points a tile
  static constexpr bool ROW_SPLIT = TM == 128;    // consumers split rows, else columns
  static constexpr int NT = 384;                  // two consumer warpgroups, a producer
  static constexpr int CONSUMER_WARPS = 8;
  // registers a thread after setmaxnreg: 128 x 56 + 256 x 224 = 384 x 168,
  // what the launch bounds give each thread at the start
  static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
  static constexpr int COLS = HIDDEN / C;         // a CTA's output columns
  static constexpr int WG_COLS = ROW_SPLIT ? COLS : COLS / 2;  // wgmma's N: 256, 128
  static constexpr int NI = WG_COLS / 8;          // n8 tiles of an accumulator
  static constexpr int KC = C == 1 ? 32 : 64;     // weight rows a chunk
  static constexpr int KS = KC / 16;              // 16-deep k-steps a chunk
  // The tile in wgmma's K-major canonical layout without swizzle: core
  // matrices of 8 rows x 8 k (128 contiguous bytes), the rows' core matrices
  // one after another (stride byte offset 128) in panels of 8 k, the panels
  // (leading byte offset) padded by 32 bytes, so that the 16-byte stores of
  // a quarter warp (2 rows x 4 panels) fall on 8 bank quads
  static constexpr int PANEL_A = TM * 16 + 32;
  static constexpr int TILE_BYTES = HIDDEN / 8 * PANEL_A;
  // A stage holds a chunk in the MN-major (transposed-B) canonical layout
  // without swizzle: core matrices of 8 k x 8 columns (a 16-byte row of 8
  // columns a k, 128 contiguous bytes), one after another along the columns
  // (stride byte offset 128), in panels of 8 k (leading byte offset)
  static constexpr int PANEL_B = COLS * 16;
  static constexpr int STAGE = KC / 8 * PANEL_B;
  // as many stages as fit beside the tile and their two mbarriers each (5
  // at C = 1, 6 at C = 4), fewer than a layer's chunks (the producer meets
  // at most one layer end at a time)
  static constexpr int FIT = (MAX_SMEM - TILE_BYTES) / (STAGE + 16);
  static constexpr int STAGES = FIT < HIDDEN / KC - 1 ? FIT : HIDDEN / KC - 1;
  static constexpr size_t SMEM = TILE_BYTES + (size_t)STAGES * (STAGE + 16);
  static_assert(SMEM <= MAX_SMEM && STAGES >= 3, "bf16 tile and weight ring exceed shared memory");
  static_assert(NI % 4 == 0, "the tile stores: four n8 tiles a quad transpose");
  static_assert(TM % (C * CONSUMER_WARPS) == 0, "the last layer's rows: whole rows a warp");
};

// the chunk stream of first-layer depth K0: l0's chunks, then l1..l7's
template <int K0, int C>
struct Stream {
  static constexpr int KC = Split<C>::KC;
  static_assert(K0 % KC == 0 && K0 <= HIDDEN, "l0 depth: whole chunks, inside the tile");
  static constexpr int CHUNKS_IN = K0 / KC, CHUNKS_MID = HIDDEN / KC;
  static constexpr int CHUNKS = CHUNKS_IN + N_MID * CHUNKS_MID;
};

// Chunk c of the stream: its layer (0 = l0), whether it is the layer's
// last, and the first row k of the layer it covers
template <int K0, int C>
__device__ __forceinline__ int chunk_k(int c, int& layer, bool& last) {
  using T = Stream<K0, C>;
  const bool first = c < T::CHUNKS_IN;
  const int kc = first ? c : (c - T::CHUNKS_IN) % T::CHUNKS_MID;  // the chunk in the layer
  layer = first ? 0 : 1 + (c - T::CHUNKS_IN) / T::CHUNKS_MID;
  last = kc == (first ? T::CHUNKS_IN : T::CHUNKS_MID) - 1;
  return kc * T::KC;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a shared memory matrix descriptor without swizzle: start address, leading
// byte offset (between core matrices along k), stride byte offset (along
// the rows of A, the columns of B), all in 16-byte units (CUTLASS's
// cute/arch/mma_sm90_desc.hpp: GmmaDescriptor)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

template <int N>
struct Wgmma;

// d (+)= a b: d the m64nN float accumulator of the warpgroup, a the 64x16
// bf16 tile block (K-major) and b the 16xN bf16 weight block (MN-major:
// imm-trans-b 1) through their descriptors; scale_d = 0 sets d
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[16][4], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[32][4], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
          "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
          "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
          "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
          "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
          "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
          "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
          "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
          "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// mbarriers after the ring: full[s] at 16 s, empty[s] at 16 s + 8
__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) { return bars + 16 * s; }
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) { return bars + 16 * s + 8; }

// the consumers' barrier at C = 1 (named barrier 1: the producer does not
// take part); at C > 1 the cluster's, which every thread joins
__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// Chunk c of the weight stream, the CTA's columns [col0, col0 + COLS), into
// its stage: one bulk copy (the Tensor Memory Accelerator) of COLS x 16
// bytes for each 8-row group, whose core matrices lie one after another in
// the weight image (ops/fused_mlp.py:stream_image) as in the stage; the
// stage's `full` mbarrier expects their bytes.  One thread issues them.
template <int C>
__device__ __forceinline__ void copy_chunk(unsigned char* ring, uint32_t bars, int c, int col0,
                                           const bf16* __restrict__ w_img) {
  using S = Split<C>;
  const int slot = c % S::STAGES;
  const uint32_t full = full_bar(bars, slot);
  const uint32_t dst = smem_addr(ring + (size_t)slot * S::STAGE);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(full),
               "r"(S::STAGE)
               : "memory");
#pragma unroll
  for (int g = 0; g < S::KC / 8; ++g) {
    // 8-row group c KC / 8 + g of the stream: HIDDEN / 8 core matrices of 64
    // elements, the CTA's from col0 / 8
    const bf16* src = w_img + ((size_t)(c * (S::KC / 8) + g) * (HIDDEN / 8) + col0 / 8) * 64;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(dst + g * S::PANEL_B),
        "l"(src), "r"(S::PANEL_B), "r"(full)
        : "memory");
  }
}

// The producer warpgroup: thread 0 copies chunk c into its slot once both
// consumers are done with the chunk the slot held; the copies arrive at the
// slot's `full` mbarrier as they land.  At C > 1 every thread of the
// cluster takes part in the consumers' two cluster barriers of each layer's
// end: the producer arrives at the first as soon as it has issued the
// layer's last chunk, and waits for it, arrives at the second and waits
// for that only before it waits for a slot that the consumers free after
// them.  So the ring is full when the next layer starts.
template <int K0, int C>
__device__ __forceinline__ void produce(unsigned char* ring, uint32_t bars, int col0, int ptid,
                                        const bf16* __restrict__ w_img) {
  using S = Split<C>;
  using T = Stream<K0, C>;
  static_assert(C == 1 || T::CHUNKS_MID > S::STAGES, "one layer end in the producer's way");
  int pending = -1;  // the last chunk of the layer whose first barrier it has arrived at
  const auto finish = [&]() {  // the rest of that layer end's barriers
    if constexpr (C > 1) {
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    pending = -1;
  };
#pragma unroll 1
  for (int c = 0; c < T::CHUNKS; ++c) {
    if (c >= S::STAGES) {  // both consumers are done with chunk c - STAGES
      if (pending >= 0 && c - S::STAGES > pending) finish();
      mbar_wait(empty_bar(bars, c % S::STAGES), (c / S::STAGES - 1) & 1);
    }
    if (ptid == 0) copy_chunk<C>(ring, bars, c, col0, w_img);
    if constexpr (C > 1) {
      int layer;
      bool last;
      chunk_k<K0, C>(c, layer, last);
      if (last) {
        cluster_arrive();
        pending = c;
      }
    }
  }
  if (pending >= 0) finish();
}

// torch Softplus(beta=100, threshold=20) on MUFU ex2 and lg2: within ~5e-8
// of log1pf(expf()) (their errors, scaled down by beta), far below bf16
// rounding.  Branch free: both sides are computed and one is selected.  A
// C++ ternary evaluates only its taken side and compiles to a branch per
// element, which keeps ptxas from interleaving a thread's exp-log chains
// (the epilogue is then latency bound).
__device__ __forceinline__ float softplus100(float x) {
  constexpr float LOG2E_100 = 144.269504088896341f;  // 100 log2(e)
  constexpr float LN2_100 = 0.00693147180559945309f;  // ln(2) / 100
  float e, l;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fminf(x * LOG2E_100, 20.f * 1.44269504f)));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(1.f + e));
  return 100.f * x > 20.f ? x : l * LN2_100;
}

// the skip input of row `row`, column j, as the tile holds it: bf16(x)
__device__ __forceinline__ float skip_input(const float* __restrict__ x, int row, int n,
                                            int d_in, int j) {
  return row < n ? __bfloat162float(__float2bfloat16_rn(x[(size_t)row * d_in + j])) : 0.f;
}

// bf16(softplus(acc + bias)) of the warpgroup's block in registers, as
// pairs[i][half]: row `row` (+ 8 half) of the tile, layer columns col0 + 8 i
// + 2t and + 1; after l3 (SKIP) the tail columns take bf16(bf16(x)/sqrt(2))
// and the rest bf16(softplus/sqrt(2)).  SKIP is a template parameter, so
// that the common epilogue is one basic block.
template <int NI, bool SKIP>
__device__ __forceinline__ void activate(const float (&acc)[NI][4], uint32_t (&pairs)[NI][2],
                                         const float* __restrict__ bias,
                                         const float* __restrict__ x, int row, int n, int d_in,
                                         int col0, int t) {
  const int skip_cols = HIDDEN - d_in;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int col = col0 + i * 8 + 2 * t;  // accumulator columns col, col+1
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // rows row and row+8
      float v0 = softplus100(acc[i][2 * half] + b.x);
      float v1 = softplus100(acc[i][2 * half + 1] + b.y);
      if (SKIP) {
        const int r = row + 8 * half;
        if (col >= skip_cols) v0 = skip_input(x, r, n, d_in, col - skip_cols);
        if (col + 1 >= skip_cols) v1 = skip_input(x, r, n, d_in, col + 1 - skip_cols);
        v0 *= INV_SQRT2;
        v1 *= INV_SQRT2;
      }
      const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
      pairs[i][half] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
}

// v[j] of lane j of each quad (lanes 4g .. 4g+3) -> v[j] of lane t: lane
// j's v[t].  A 4x4 transpose in two rounds of shuffles: lanes t and t^1 swap
// the entries whose index differs from t in bit 0, then t and t^2 in bit 1.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool odd = t & 1, high = t & 2;
  uint32_t s0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  uint32_t s1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  if (odd) {
    v[0] = s0;
    v[2] = s1;
  } else {
    v[1] = s0;
    v[3] = s1;
  }
  s0 = __shfl_xor_sync(0xffffffffu, high ? v[0] : v[2], 2);
  s1 = __shfl_xor_sync(0xffffffffu, high ? v[1] : v[3], 2);
  if (high) {
    v[0] = s0;
    v[1] = s1;
  } else {
    v[2] = s0;
    v[3] = s1;
  }
}

// The warpgroup's activated block into the tile of every CTA of the
// cluster, 16 bytes a store: the four lanes of a quad hold the 8 columns of
// one n8 tile's row, so a quad transposes the pairs of four adjacent n8
// tiles of one row, after which lane t holds all 8 columns of tile 4 j + t,
// one row of one core matrix.  Its own tile through st.shared, the others'
// (`remote`: ranks rank+1, ..., rank+C-1) through st.shared::cluster; a
// quarter warp's stores (2 rows x 4 panels) fall on 8 bank quads.
template <int C>
__device__ __forceinline__ void store_tile(const uint32_t (&pairs)[Split<C>::NI][2],
                                           unsigned char* tile, const uint32_t (&remote)[C],
                                           int row, int col0, int t) {
  using S = Split<C>;
#pragma unroll
  for (int j = 0; j < S::NI / 4; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = pairs[4 * j + k][half];
      quad_transpose(v, t);
      const uint32_t off = (col0 / 8 + 4 * j + t) * S::PANEL_A + (row + 8 * half) * 16;
      *reinterpret_cast<uint4*>(tile + off) = make_uint4(v[0], v[1], v[2], v[3]);
#pragma unroll
      for (int other = 1; other < C; ++other)
        asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(remote[other] + off),
                     "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                     : "memory");
    }
}

template <int K0, int C>
__global__ void __launch_bounds__(Split<C>::NT, 1)
    fused_sdf_kernel(const float* __restrict__ x, int n, int d_in,
                     const bf16* __restrict__ w_img, const float* __restrict__ b_in,
                     const float* __restrict__ b_mid, const bf16* __restrict__ w_out,
                     const float* __restrict__ b_out, float* __restrict__ out) {
  using S = Split<C>;
  constexpr int CHUNKS = Stream<K0, C>::CHUNKS;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* tile = smem;                  // the activations, K-major (PANEL_A)
  unsigned char* ring = smem + S::TILE_BYTES;  // STAGES stages
  const uint32_t bars = smem_addr(ring + (size_t)S::STAGES * S::STAGE);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;  // 0, 1: consumers; 2: the producer
  // a 1-D cluster is C consecutive blocks, one tile
  const int rank = C == 1 ? 0 : (int)cluster_rank();
  const int row0 = blockIdx.x / C * S::TM;
  const int cta_col0 = rank * S::COLS;  // the CTA's first output column

  // the point tile at its real width in bf16, zero padded to K0 columns and
  // TM rows: 8 columns of a row (one row of a core matrix) a thread
  for (int i = threadIdx.x; i < S::TM * K0 / 8; i += S::NT) {
    const int r = i / (K0 / 8), kg = i % (K0 / 8), row = row0 + r;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * kg + 2 * e;
      const float a = row < n && col < d_in ? x[(size_t)row * d_in + col] : 0.f;
      const float b = row < n && col + 1 < d_in ? x[(size_t)row * d_in + col + 1] : 0.f;
      const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
      v[e] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(tile + kg * S::PANEL_A + r * 16) = make_uint4(v[0], v[1], v[2], v[3]);
  }
  if (threadIdx.x < S::STAGES) {
    mbar_init(full_bar(bars, threadIdx.x), 1);                   // the producer's expect_tx
    mbar_init(empty_bar(bars, threadIdx.x), S::CONSUMER_WARPS);  // a lane of each consumer warp
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");  // ... for the copies
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the tile, for the tensor cores
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(S::PRODUCER_REGS));
    produce<K0, C>(ring, bars, cta_col0, threadIdx.x - 256, w_img);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(S::CONSUMER_REGS));
  const int wq = warp % 4;                  // the warp in its warpgroup
  const int g = lane / 4, t = lane % 4;     // accumulator coordinates
  // the warpgroup's block: 64 rows from wg_row0, WG_COLS columns from col0
  const int wg_row0 = S::ROW_SPLIT ? 64 * wg : 0;
  const int wg_col = S::ROW_SPLIT ? 0 : S::WG_COLS * wg;  // ... of the CTA's
  const int col0 = cta_col0 + wg_col;
  const int row = wg_row0 + 16 * wq + g;    // the thread's rows row and row + 8
  const uint32_t a_base = smem_addr(tile) + 16 * wg_row0;
  const uint32_t b_base = smem_addr(ring) + wg_col * 16;
  uint32_t remote[C] = {};  // remote[q]: the tile of rank + q (q >= 1)
#pragma unroll
  for (int q = 1; q < C; ++q) remote[q] = map_rank(smem_addr(tile), (rank + q) % C);

  float acc[S::NI][4];
#pragma unroll
  for (int i = 0; i < S::NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // Each chunk's products are issued as soon as it has landed, behind the
  // previous chunk's, and the previous chunk's slot is freed once those are
  // done; at a layer's end all are awaited.  The layer's first product sets
  // the accumulators (scale-d 0).
  for (int c = 0; c < CHUNKS; ++c) {
    const int slot = c % S::STAGES;
    int layer;
    bool last;
    const int k0 = chunk_k<K0, C>(c, layer, last);  // the chunk's first row of the layer
    mbar_wait(full_bar(bars, slot), (c / S::STAGES) & 1);  // the chunk has landed
    wgmma_fence();
    const uint32_t b_stage = b_base + slot * S::STAGE;
#pragma unroll
    for (int s = 0; s < S::KS; ++s) {
      const int k = k0 + 16 * s;
      Wgmma<S::WG_COLS>::mma(acc, desc(a_base + k / 8 * S::PANEL_A, S::PANEL_A, 128),
                             desc(b_stage + 2 * s * S::PANEL_B, S::PANEL_B, 128), k > 0);
    }
    wgmma_commit();
    if (k0 > 0) {  // the previous chunk's products are done: its slot is free
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty_bar(bars, (c - 1) % S::STAGES));
    }
    if (last) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty_bar(bars, slot));
      // the layer's end: the tile is read; activate in registers, then
      // replace the tile of every CTA of the cluster once all of them are
      // done reading it
      if constexpr (C > 1) cluster_arrive();
      const float* bias = layer == 0 ? b_in : b_mid + (layer - 1) * HIDDEN;
      uint32_t pairs[S::NI][2];
      if (layer == 1 + SKIP_AFTER_MID)
        activate<S::NI, true>(acc, pairs, bias, x, row0 + row, n, d_in, col0, t);
      else
        activate<S::NI, false>(acc, pairs, bias, x, row0 + row, n, d_in, col0, t);
      if constexpr (C > 1)
        cluster_wait();
      else
        consumer_barrier();
      store_tile<C>(pairs, tile, remote, row, col0, t);
      // the new tile, complete in every CTA; after the last layer's, no CTA
      // touches another's shared memory, so that each may exit
      if constexpr (C > 1)
        tile_barrier<C>();
      else
        consumer_barrier();
      // ... and the stores into it that this thread has acquired, visible
      // to the tensor cores
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
  }

  // last layer: the SDF column only, one 512-long float dot per point; the
  // cluster's CTAs split the tile's rows, the consumer warps of each CTA its
  // share; lane l reads panels l and l + 32 (16 bytes each) of its row
  constexpr int ROWS_PER_WARP = S::TM / C / S::CONSUMER_WARPS;
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = rank * (S::TM / C) + warp * ROWS_PER_WARP + rr;
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kg = lane + 32 * h;
      const uint4 a = *reinterpret_cast<const uint4*>(tile + kg * S::PANEL_A + r * 16);
      const uint4 w = *reinterpret_cast<const uint4*>(w_out + 8 * kg);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 af = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[e]));
        const float2 wf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv[e]));
        s = fmaf(af.x, wf.x, s);
        s = fmaf(af.y, wf.y, s);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const int grow = row0 + r;
    if (lane == 0 && grow < n) out[grow] = s + b_out[0];
  }
}

// the kernel's dynamic shared memory limit is set (on its first use)
template <int K0, int C>
bool ready = false;

}  // namespace bf16k

// a launch's shape: k0 the compiled first-layer depth, at least d_in; the
// skip fills columns >= 512 - d_in, so d_in < 512
bool valid_shape(int n, int d_in, int k0) {
  return n > 0 && d_in > 0 && d_in <= k0 && d_in < HIDDEN;
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; the stream is
// the caller's cudaStream_t; k0 is the compiled first-layer depth to launch
// (64, 128, 256 or 512: the smallest that covers d_in, chosen by the
// caller); cluster the CTAs that share a tile, which also fixes the points
// a tile (f32: 64 at C = 2 or 4; bf16: 64 at C = 1, 128 at C = 4; any other
// C is refused).  Returns the cudaError_t of the launch (0 = ok).

extern "C" int fused_sdf_raw_f32(const void* x, int n, int d_in, int k0, int cluster,
                                 const void* w_in, const void* b_in, const void* w_mid,
                                 const void* b_mid, const void* w_out, const void* b_out,
                                 void* out, void* stream) {
  if (!valid_shape(n, d_in, k0)) return (int)cudaErrorInvalidValue;
  return dispatch(k0, cluster, [&](auto k, auto c) {
    constexpr int K0 = decltype(k)::value, C = decltype(c)::value;
    if constexpr (C == 1) {
      return (int)cudaErrorInvalidValue;  // the f32 kernel's clusters are of 2 and 4
    } else {
      using S = f32::Split<C>;
      return launch_tiles<C>(f32::fused_sdf_kernel<K0, C>, S::NT, S::SMEM, f32::ready<K0, C>,
                             (n + f32::TM - 1) / f32::TM, static_cast<cudaStream_t>(stream),
                             static_cast<const float*>(x), n, d_in,
                             static_cast<const float*>(w_in), static_cast<const float*>(b_in),
                             static_cast<const float*>(w_mid), static_cast<const float*>(b_mid),
                             static_cast<const float*>(w_out), static_cast<const float*>(b_out),
                             static_cast<float*>(out));
    }
  });
}

extern "C" int fused_sdf_raw_bf16(const void* x, int n, int d_in, int k0, int cluster,
                                  const void* w_img, const void* b_in, const void* b_mid,
                                  const void* w_out, const void* b_out, void* out, void* stream) {
  if (!valid_shape(n, d_in, k0)) return (int)cudaErrorInvalidValue;
  return dispatch(k0, cluster, [&](auto k, auto c) {
    constexpr int K0 = decltype(k)::value, C = decltype(c)::value;
    if constexpr (C == 2) {
      return (int)cudaErrorInvalidValue;  // (64, 1) and (128, 4) only
    } else {
      using S = bf16k::Split<C>;
      return launch_tiles<C>(bf16k::fused_sdf_kernel<K0, C>, S::NT, S::SMEM, bf16k::ready<K0, C>,
                             (n + S::TM - 1) / S::TM, static_cast<cudaStream_t>(stream),
                             static_cast<const float*>(x), n, d_in,
                             static_cast<const bf16*>(w_img), static_cast<const float*>(b_in),
                             static_cast<const float*>(b_mid), static_cast<const bf16*>(w_out),
                             static_cast<const float*>(b_out), static_cast<float*>(out));
    }
  });
}

// *slots <- cluster x the clusters of each variant's kernel at depth k0 that
// can run at once on the current device (cudaOccupancyMaxActiveClusters).
// Returns the cudaError_t (0 = ok).
extern "C" int fused_sdf_raw_f32_slots(int k0, int cluster, int* slots) {
  return dispatch(k0, cluster, [&](auto k, auto c) {
    constexpr int K0 = decltype(k)::value, C = decltype(c)::value;
    if constexpr (C == 1) {
      return (int)cudaErrorInvalidValue;
    } else {
      using S = f32::Split<C>;
      return count_slots<C>(f32::fused_sdf_kernel<K0, C>, S::NT, S::SMEM, f32::ready<K0, C>,
                            slots);
    }
  });
}

extern "C" int fused_sdf_raw_bf16_slots(int k0, int cluster, int* slots) {
  return dispatch(k0, cluster, [&](auto k, auto c) {
    constexpr int K0 = decltype(k)::value, C = decltype(c)::value;
    if constexpr (C == 2) {
      return (int)cudaErrorInvalidValue;
    } else {
      using S = bf16k::Split<C>;
      return count_slots<C>(bf16k::fused_sdf_kernel<K0, C>, S::NT, S::SMEM, bf16k::ready<K0, C>,
                            slots);
    }
  });
}
