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
// in split-TF32 on wgmma; bf16 weights (guidance queries) on bf16 mma.sync
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
// bf16 variant: design.  The skeleton of the float variant: a tile of 64
// points stays on chip across all nine layers, as a 64x520 bf16 activation
// tile (66,560 B), and the weights stream through a cp.async ring of two
// 64-row bf16 stages: one uniform chunk stream over l0 (K0 rows, rows >=
// d_in zero-filled) and l1..l7, the next chunk in flight while the current
// one is multiplied, across layer boundaries too.  One tile is a cluster of
// C CTAs (C = 1, 2 or 4), as in the float variant: each CTA holds the whole
// tile and computes 512 / C columns of each layer, streaming only their
// weights (stages of 64 x (512/C + 8): 199,680 B in all at C = 1, 134,144 B
// at 2, 101,376 B at 4; one CTA an SM).  Its eight warps each own 64 / C
// output columns for all 64 rows (128, 64 or 32 float accumulators a
// thread); at C = 1, of the two layouts that fit, this one reads the least
// from shared memory (per 16-deep k-step 32 KB through ldmatrix, against 48
// KB for sixteen warps of 64x32, which also spill at their 128-register
// cap).  Per k-step a warp loads 4 A fragments with ldmatrix.x4 and 16 / C
// B fragments with ldmatrix.x4.trans straight from the input-major (k, n)
// weight stage, and issues 32 / C mma.sync.m16n8k16.bf16 accumulating in
// float in the tensor cores (their truncating adds stay far below bf16
// rounding).  Row strides of 16 mod 128 bytes make both ldmatrix reads free
// of bank conflicts.  Every output column keeps its k order and its m16n8k16
// grouping, so every C gives the bits of C = 1, and C = 1 those of the
// kernel before clusters.  Three choices, each measured on the card
// against a version without it when the design was set:
// the fragments of k-step s+1 are loaded before k-step s's products; each
// warp copies exactly the weights it reads, so that it waits for its own
// copies (wait_group + __syncwarp) and the block meets only around the
// epilogues, where the shared tile is rewritten (two barriers a layer
// instead of one a chunk); and softplus is branch free.  The epilogue runs
// on the accumulators in registers: bias, softplus on MUFU ex2/lg2, after l3
// bf16(x)/sqrt(2) (x read at its real width from device memory) in the tail
// columns, rounded to bf16 and stored as pairs into the tile.  At C > 1 the
// pairs go into the CTA's own tile by 4-byte stores (free of bank
// conflicts) and into the other CTAs' tiles by 16-byte st.shared::cluster:
// the four lanes of a quad hold the 8 columns of one n8 tile's row, and a
// 4x4 transpose by shuffles gives each lane all 8 of one row.  Around the
// stores the cluster meets as the float variant's does, but the first
// barrier is split: a warp arrives once it has loaded its last fragments of
// the tile and waits only after its last products and its activation.
// The last layer is a 512-long float dot per point with a warp reduction,
// the cluster's CTAs taking 64 / C rows each; only (N,) is written.  What
// bounds it at the large calls (C = 1): mma.sync, which alone runs at about
// 37% of the H100's dense bf16 peak (the mma_only variant at N=69632),
// then the weight copies, softplus and the layer barriers, which no other
// work overlaps while every warp runs its epilogue.  At the small calls
// (NVIDIA H100 80GB HBM3, 700 W; scripts/bench_fused_mlp_f32.py --dtype bf16
// beside the kernel before clusters): N=256 takes 0.072 ms on clusters of 4
// against 0.099, N=2048 0.085-0.089 on clusters of 2 against 0.099-0.102,
// but N=4096 0.094-0.098 against 0.099-0.105, and a full wave of clusters
// takes 0.146 / 0.098 / 0.089 ms at C = 1 / 2 / 4.  A cluster divides a
// tile's products and its weight stream, not the weights the call reads
// from L2: every tile still reads all 3.73 MB, 239 MB at N=4096, which
// arrive at about 2.4 TB/s when every CTA starts at once, at C = 1 and 2
// alike (4.5 TB/s in the steady waves of N=69632).  With the weight
// copies taken out N=4096 at C = 2 runs 28% faster; with the products
// taken out 8%; without the stores into other tiles 8% (40% at C = 4,
// N=256); what remains is the per-layer latency of eight epilogues, their
// softplus on MUFU and their barrier pairs.
//
// Left for later: wgmma (the only path to the full tensor-core rate, with B
// read from shared memory without per-warp ldmatrix traffic) and TMA; and
// the L2 traffic of 64-point tiles: every block re-reads all 3.73 MB of bf16
// weights, about 4.1 GB from L2 at N=69632 (1088 blocks).

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
// thread-block clusters: both variants run a 64-point tile on a cluster of C
// CTAs (f32: 2 or 4; bf16: 1, 2 or 4) that share it through distributed
// shared memory
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
// bf16 weights: bf16 mma.sync fed by a cp.async weight ring, one tile of 64
// points shared by a cluster of C CTAs
// ---------------------------------------------------------------------------

namespace bf16k {

constexpr int TM = 64;                  // points per tile (per cluster)
constexpr int KC = 64;                  // weight rows per ring stage
// the tile's row stride, 1040 B (16 mod 128): the eight 16-byte rows an
// ldmatrix phase reads fall in distinct banks
constexpr int LDA = HIDDEN + 8;
constexpr size_t TILE_BYTES = sizeof(bf16) * TM * LDA;
constexpr int CHUNKS_MID = HIDDEN / KC;     // each of l1..l7's chunks
// an even number of 16-deep k-steps a chunk: the main loop's two fragment
// buffers then alternate from chunk to chunk
static_assert(KC % 32 == 0 && HIDDEN % KC == 0, "chunking");

// How a cluster of C CTAs splits one tile's work.  Every CTA holds the whole
// 64 x 512 tile (the A operand of every layer) and computes HIDDEN / C output
// columns of each layer, streaming only those columns' weights through its
// ring.  Each of its 8 warps owns WARP_COLS of those columns for all 64
// rows and copies exactly their weights, so that it waits for its own
// copies only: 64 x 64 at C = 1, 64 x 32 at C = 2, 64 x 16 at C = 4.
template <int C>
struct Split {
  static_assert(C == 1 || C == 2 || C == 4, "cluster sizes 1, 2 and 4");
  static constexpr int NT = 256;                  // 8 warps a CTA
  static constexpr int WARPS = NT / 32;
  static constexpr int COLS = HIDDEN / C;         // a CTA's output columns
  static constexpr int WARP_COLS = COLS / WARPS;  // a warp's
  static constexpr int MI = TM / 16, NI = WARP_COLS / 8;  // m16n8 tiles a warp
  // ring stages: two fill shared memory beside the tile at C = 1; at C = 2
  // and 4 four fit, but ran 1-8% slower on the card than two
  static constexpr int STAGES = 2;
  // the stage's row stride, COLS + 8 elements: 16 mod 128 bytes at every C
  static constexpr int LDW = COLS + 8;
  static constexpr size_t SMEM = TILE_BYTES + sizeof(bf16) * STAGES * KC * LDW;
  static_assert(SMEM <= MAX_SMEM, "bf16 tile and weight ring exceed shared memory");
  static_assert(NI % 2 == 0, "ldmatrix.x4.trans loads two n8 tiles");
  static_assert(MI * NI * 2 % 4 == 0, "the stores into other tiles: four fragments a store");
  static_assert(TM % (C * WARPS) == 0, "the last layer's rows: whole rows a warp");
};

// the chunk stream of first-layer depth K0: l0's chunks, then l1..l7's
template <int K0>
struct Stream {
  static_assert(K0 % KC == 0 && K0 <= HIDDEN, "l0 depth: whole chunks, inside the tile");
  static constexpr int CHUNKS_IN = K0 / KC;
  static constexpr int CHUNKS = CHUNKS_IN + N_MID * CHUNKS_MID;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a b (16x8x16, bf16 operands, float accumulator)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the warp's columns of chunk c of the whole weight stream (l0's K0 rows,
// then l1..l7's 512 rows each, KC rows a chunk) into its ring stage, as one
// commit group: weight columns [col0, col0 + WARP_COLS) into stage columns
// [scol0, scol0 + WARP_COLS); rows at or past d_in in l0 are zero.  A warp
// copies exactly the part of each stage that it reads, so it waits for its
// own copies only.  Past the end it commits an empty group, so that the
// group count stays uniform for wait_group.
template <int K0, int C>
__device__ __forceinline__ void prefetch_chunk(bf16* ring, int c, int d_in, int scol0, int col0,
                                               int lane, const bf16* __restrict__ w_in,
                                               const bf16* __restrict__ w_mid) {
  using S = Split<C>;
  constexpr int CHUNKS_IN = Stream<K0>::CHUNKS_IN, CHUNKS = Stream<K0>::CHUNKS;
  // lane -> 16-byte piece of rows r0, r0 + ROW_STEP, ...
  constexpr int PER_ROW = S::WARP_COLS / 8;  // 16-byte copies a row
  constexpr int ROW_STEP = 32 / PER_ROW;
  static_assert(32 % PER_ROW == 0 && KC % ROW_STEP == 0, "copies per lane");
  const int r0 = lane / PER_ROW, piece = (lane % PER_ROW) * 8, col = col0 + piece;
  bf16* dst = ring + (c % S::STAGES) * KC * S::LDW + r0 * S::LDW + scol0 + piece;
  if (c < CHUNKS_IN) {
    const int k0 = c * KC;
#pragma unroll
    for (int r = 0; r < KC; r += ROW_STEP) {
      const bool valid = k0 + r0 + r < d_in;
      cp_async16(dst + r * S::LDW, valid ? w_in + (size_t)(k0 + r0 + r) * HIDDEN + col : w_in,
                 valid);
    }
  } else if (c < CHUNKS) {
    // l1..l7 are one contiguous stream of full rows
    const bf16* src = w_mid + ((size_t)(c - CHUNKS_IN) * KC + r0) * HIDDEN + col;
#pragma unroll
    for (int r = 0; r < KC; r += ROW_STEP) cp_async16(dst + r * S::LDW, src + r * HIDDEN, true);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// one 16-deep k-step's fragments of the warp's block
template <int C>
struct Frags {
  uint32_t a[Split<C>::MI][4];
  uint32_t b[Split<C>::NI][2];
};

// a_addr: the thread's ldmatrix address in the tile at the k-step's first
// column; w_addr: its address in the stage at the k-step's first row and the
// warp's first column
template <int C>
__device__ __forceinline__ void load_frags(Frags<C>& f, uint32_t a_addr, uint32_t w_addr) {
  // A: matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  // give a0..a3 of m16n8k16
#pragma unroll
  for (int mi = 0; mi < Split<C>::MI; ++mi)
    ldsm_x4(f.a[mi], a_addr + sizeof(bf16) * mi * 16 * LDA);
  // B from (k, n) rows, transposed: (k 0-7, n 0-7), (8-15, 0-7),
  // (0-7, 8-15), (8-15, 8-15) give b0, b1 of two n8 tiles
#pragma unroll
  for (int nj = 0; nj < Split<C>::NI / 2; ++nj)
    ldsm_x4_trans(f.b[2 * nj][0], f.b[2 * nj][1], f.b[2 * nj + 1][0], f.b[2 * nj + 1][1],
                  w_addr + sizeof(bf16) * nj * 16);
}

// acc += the k-step's 64 x 16 by 16 x WARP_COLS product
template <int C>
__device__ __forceinline__ void mma_step(float (&acc)[Split<C>::MI][Split<C>::NI][4],
                                         const Frags<C>& f) {
#pragma unroll
  for (int mi = 0; mi < Split<C>::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < Split<C>::NI; ++ni) mma(acc[mi][ni], f.a[mi], f.b[ni]);
}

// chunk c's first column in its layer's input
template <int K0>
__device__ __forceinline__ int chunk_col(int c) {
  constexpr int CHUNKS_IN = Stream<K0>::CHUNKS_IN;
  return c < CHUNKS_IN ? c * KC : (c - CHUNKS_IN) % CHUNKS_MID * KC;
}

// torch Softplus(beta=100, threshold=20) on MUFU ex2 and lg2: within ~5e-8
// of log1pf(expf()) (their errors, scaled down by beta), far below bf16
// rounding.  Branch free: both sides are computed and one is selected.  A
// C++ ternary evaluates only its taken side and compiles to a branch per
// element, which keeps ptxas from interleaving a thread's 128 exp-log chains
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

// bf16(softplus(acc + bias)) for the warp's block (columns col0.. of the
// layer), from the accumulators in registers; after l3 (SKIP) the tail
// columns take bf16(bf16(x)/sqrt(2)) and the rest bf16(softplus/sqrt(2)).
// At C = 1 the pairs of columns go straight into the tile, at C > 1 into
// `pairs` (pairs[mi][ni][half]: row mi*16 + g + 8*half, columns ni*8 + 2t
// and + 1) for store_tile.  Zeroes acc for the next layer.  SKIP is a
// template parameter, so that the common epilogue is one basic block.
template <int C, bool SKIP>
__device__ __forceinline__ void epilogue(float (&acc)[Split<C>::MI][Split<C>::NI][4],
                                         uint32_t (&pairs)[Split<C>::MI][Split<C>::NI][2],
                                         bf16* act, const float* __restrict__ bias,
                                         const float* __restrict__ x, int row0, int n,
                                         int d_in, int col0, int g, int t) {
  const int skip_cols = HIDDEN - d_in;
#pragma unroll
  for (int ni = 0; ni < Split<C>::NI; ++ni) {
    const int col = col0 + ni * 8 + 2 * t;  // accumulator columns col, col+1
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int mi = 0; mi < Split<C>::MI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows g and g+8
        const int r = mi * 16 + g + 8 * half;
        float v0 = softplus100(acc[mi][ni][2 * half] + b.x);
        float v1 = softplus100(acc[mi][ni][2 * half + 1] + b.y);
        if (SKIP) {
          if (col >= skip_cols) v0 = skip_input(x, row0 + r, n, d_in, col - skip_cols);
          if (col + 1 >= skip_cols) v1 = skip_input(x, row0 + r, n, d_in, col + 1 - skip_cols);
          v0 *= INV_SQRT2;
          v1 *= INV_SQRT2;
        }
        const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
        if constexpr (C == 1)
          *reinterpret_cast<__nv_bfloat162*>(act + r * LDA + col) = v;
        else
          pairs[mi][ni][half] = *reinterpret_cast<const uint32_t*>(&v);
        acc[mi][ni][2 * half] = acc[mi][ni][2 * half + 1] = 0.f;
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

// The warp's activated block (C > 1) into the tile of every CTA of the
// cluster: its own through 4-byte stores, free of bank conflicts; the
// others' (`remote`: ranks rank+1, ..., rank+C-1) through 16-byte
// st.shared::cluster.  The four lanes of a quad hold the 8 columns of one
// n8 tile's row, so a quad transposes each four of its fragments
// (fragment i: mi = i / (2 NI), half = i / NI % 2, ni = i % NI), after which
// lane t holds all 8 columns of fragment t of the four.
template <int C>
__device__ __forceinline__ void store_tile(const uint32_t (&pairs)[Split<C>::MI][Split<C>::NI][2],
                                           bf16* act, const uint32_t (&remote)[C], int col0,
                                           int g, int t) {
  constexpr int MI = Split<C>::MI, NI = Split<C>::NI;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(act + (mi * 16 + g + 8 * half) * LDA + col0 + ni * 8 +
                                     2 * t) = pairs[mi][ni][half];
#pragma unroll
  for (int q = 0; q < MI * NI * 2 / 4; ++q) {
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * q + j;
      v[j] = pairs[i / (2 * NI)][i % NI][i / NI % 2];
    }
    quad_transpose(v, t);
    const int i = 4 * q + t;
    const uint32_t off = sizeof(bf16) * ((i / (2 * NI) * 16 + g + 8 * (i / NI % 2)) * LDA +
                                         col0 + i % NI * 8);
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
                     const bf16* __restrict__ w_in, const float* __restrict__ b_in,
                     const bf16* __restrict__ w_mid, const float* __restrict__ b_mid,
                     const bf16* __restrict__ w_out, const float* __restrict__ b_out,
                     float* __restrict__ out) {
  using S = Split<C>;
  constexpr int CHUNKS_IN = Stream<K0>::CHUNKS_IN, CHUNKS = Stream<K0>::CHUNKS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);  // (TM, LDA)
  bf16* ring = act + TM * LDA;                // STAGES x (KC, LDW)
  // a 1-D cluster is C consecutive blocks, one tile
  const int rank = C == 1 ? 0 : (int)cluster_rank();
  const int row0 = blockIdx.x / C * TM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int scol0 = warp * S::WARP_COLS;      // the warp's first column in the stage
  const int col0 = rank * S::COLS + scol0;    // ... in the layer
  // ldmatrix row addresses: lanes 0-15 rows 0-15 at column 0, lanes 16-31
  // the same rows at column 8
  const int lrow = lane % 16, lcol = lane / 16 * 8;
  const uint32_t a_base = smem_addr(act + lrow * LDA + lcol);
  const uint32_t w_base = smem_addr(ring + lrow * S::LDW + scol0 + lcol);
  uint32_t remote[C] = {};  // remote[q]: the tile of rank + q (q >= 1)
#pragma unroll
  for (int q = 1; q < C; ++q) remote[q] = map_rank(smem_addr(act), (rank + q) % C);

#pragma unroll
  for (int c = 0; c < S::STAGES - 1; ++c)
    prefetch_chunk<K0, C>(ring, c, d_in, scol0, col0, lane, w_in, w_mid);

  // the point tile at its real width in bf16, zero padded to K0 columns and
  // TM rows
  for (int i = threadIdx.x; i < TM * K0; i += S::NT) {
    const int r = i / K0, col = i % K0, row = row0 + r;
    act[r * LDA + col] =
        __float2bfloat16_rn((row < n && col < d_in) ? x[(size_t)row * d_in + col] : 0.f);
  }

  float acc[S::MI][S::NI][4];
#pragma unroll
  for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // The main loop is software pipelined: a warp loads k-step s+1's fragments
  // before it issues k-step s's products, and the wait for the next chunk
  // sits between the loads of a chunk's last k-step and its products.  A
  // warp reads only the weights it copied, so the wait is its own: its
  // copies of chunk j have landed, and __syncwarp makes them visible to all
  // its lanes.  The copy of chunk j+STAGES-1 goes into chunk j-1's stage,
  // which the warp finished reading before, after k-step 0's products of
  // chunk j.  Only the tile, which every warp of the cluster reads and each
  // writes in part, needs the others: a barrier before an epilogue
  // overwrites it and one after.
  constexpr int KSTEPS = KC / 16, LAST = (KSTEPS - 1) % 2;
  const auto wait_chunk = [&]() {
    asm volatile("cp.async.wait_group %0;" ::"n"(S::STAGES - 2) : "memory");
    __syncwarp();
  };
  const auto frag_addr = [&](int j, int s, uint32_t& a, uint32_t& w) {
    a = a_base + sizeof(bf16) * (chunk_col<K0>(j) + s * 16);
    w = w_base + sizeof(bf16) * ((j % S::STAGES) * KC + s * 16) * S::LDW;
  };
  Frags<C> f[2];
  uint32_t a_addr, w_addr;
  __syncthreads();  // the point tile
  wait_chunk();
  frag_addr(0, 0, a_addr, w_addr);
  load_frags<C>(f[0], a_addr, w_addr);

  for (int c = 0; c < CHUNKS; ++c) {
#pragma unroll
    for (int s = 0; s + 1 < KSTEPS; ++s) {
      frag_addr(c, s + 1, a_addr, w_addr);
      load_frags<C>(f[(s + 1) % 2], a_addr, w_addr);
      mma_step<C>(acc, f[s % 2]);
      if (s == 0)
        prefetch_chunk<K0, C>(ring, c + S::STAGES - 1, d_in, scol0, col0, lane, w_in, w_mid);
    }
    const bool first = c < CHUNKS_IN;
    const bool layer_end = chunk_col<K0>(c) == (first ? K0 : HIDDEN) - KC;
    if (layer_end) {
      // every warp of the cluster has loaded its last fragments of the tile
      // (at C > 1 the wait comes after the products and the activation)
      if constexpr (C == 1)
        __syncthreads();
      else
        cluster_arrive();
      mma_step<C>(acc, f[LAST]);
      const int layer = first ? 0 : 1 + (c - CHUNKS_IN) / CHUNKS_MID;
      const float* bias = layer == 0 ? b_in : b_mid + (layer - 1) * HIDDEN;
      uint32_t pairs[S::MI][S::NI][2];
      if (layer == 1 + SKIP_AFTER_MID)
        epilogue<C, true>(acc, pairs, act, bias, x, row0, n, d_in, col0, g, t);
      else
        epilogue<C, false>(acc, pairs, act, bias, x, row0, n, d_in, col0, g, t);
      if constexpr (C > 1) {
        cluster_wait();
        store_tile<C>(pairs, act, remote, col0, g, t);
      }
      // the new tile, complete in every CTA; after the last layer's, no CTA
      // touches another's shared memory, so that each may exit
      tile_barrier<C>();
    }
    if (c + 1 < CHUNKS) {
      wait_chunk();
      frag_addr(c + 1, 0, a_addr, w_addr);
      load_frags<C>(f[(LAST + 1) % 2], a_addr, w_addr);
    }
    if (!layer_end) mma_step<C>(acc, f[LAST]);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  // last layer: the SDF column only, one 512-long float dot per point; the
  // cluster's CTAs split the tile's rows
  constexpr int ROWS_PER_WARP = TM / C / S::WARPS;
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = rank * (TM / C) + warp * ROWS_PER_WARP + rr;
    float s = 0.f;
#pragma unroll
    for (int k = 2 * lane; k < HIDDEN; k += 64) {
      const float2 a =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(act + r * LDA + k));
      const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w_out + k));
      s = fmaf(a.x, w.x, s);
      s = fmaf(a.y, w.y, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const int row = row0 + r;
    if (lane == 0 && row < n) out[row] = s + b_out[0];
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
// caller); cluster the CTAs that share a tile (f32: 2 or 4; bf16: 1, 2 or
// 4).  Returns the cudaError_t of the launch (0 = ok).

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
                                  const void* w_in, const void* b_in, const void* w_mid,
                                  const void* b_mid, const void* w_out, const void* b_out,
                                  void* out, void* stream) {
  if (!valid_shape(n, d_in, k0)) return (int)cudaErrorInvalidValue;
  return dispatch(k0, cluster, [&](auto k, auto c) {
    constexpr int K0 = decltype(k)::value, C = decltype(c)::value;
    using S = bf16k::Split<C>;
    return launch_tiles<C>(bf16k::fused_sdf_kernel<K0, C>, S::NT, S::SMEM, bf16k::ready<K0, C>,
                           (n + bf16k::TM - 1) / bf16k::TM, static_cast<cudaStream_t>(stream),
                           static_cast<const float*>(x), n, d_in,
                           static_cast<const bf16*>(w_in), static_cast<const float*>(b_in),
                           static_cast<const bf16*>(w_mid), static_cast<const float*>(b_mid),
                           static_cast<const bf16*>(w_out), static_cast<const float*>(b_out),
                           static_cast<float*>(out));
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
    using S = bf16k::Split<C>;
    return count_slots<C>(bf16k::fused_sdf_kernel<K0, C>, S::NT, S::SMEM, bf16k::ready<K0, C>,
                          slots);
  });
}
