// Span stamps: the train step's layer boundaries timed on the card's own
// clock, from inside the captured CUDA graph, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package has no counterpart: a span is
// the port's tracing (utils/profiling.py:span).  With tracing on, a span's
// entry and its exit each launch one span_stamp on the current stream, so
// inside a capture each becomes a one-thread kernel node of the graph, in
// stream order with the work it brackets; inside a while-node's body it
// runs once an iteration.  It reads %globaltimer (ns) and keeps, in one
// int64 buffer that utils/profiling.py lays out:
//
//   open[n]      the entry time of each span, by id
//   total[n]     the summed durations (exit - entry) of each span
//   count[n]     its exits
//   misc[4]      between-steps total, between-steps count, the last exit
//                of span 0 (`step`), the ring's cursor
//   ring[cap][2] (time, 2 id + end) of every stamp in device order, kept
//                while the cursor is below cap (the cursor counts on)
//
// At the entry of span 0 (`step`) a stamp also adds the time since the last
// exit of `step` to the between-steps total (none after a reset, which
// zeroes that time): how long the card waits between one launch's work and
// the next.  The host reads total, count and the between-steps pair in the
// same read as the loops' totals (utils/graphs.py:fold_device_counts).
//
// Bound: one thread reads and writes a few 8-byte words; the cost is the
// kernel node's launch inside the graph, a few microseconds.

#include <cuda_runtime.h>

enum { kBetweenNs = 0, kBetweenCount = 1, kLastStepEnd = 2, kCursor = 3, kMisc = 4 };

__global__ void span_stamp(long long* buf, int n_spans, long long cap, int id, int end) {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  long long* open = buf;
  long long* total = buf + n_spans;
  long long* count = buf + 2 * n_spans;
  long long* misc = buf + 3 * n_spans;
  long long* ring = misc + kMisc;
  if (!end) {
    open[id] = t;
    if (id == 0 && misc[kLastStepEnd] > 0) {
      misc[kBetweenNs] += t - misc[kLastStepEnd];
      misc[kBetweenCount] += 1;
    }
  } else {
    total[id] += t - open[id];
    count[id] += 1;
    if (id == 0) misc[kLastStepEnd] = t;
  }
  long long k = misc[kCursor]++;
  if (k < cap) {
    ring[2 * k] = t;
    ring[2 * k + 1] = 2 * id + end;
  }
}

extern "C" {

// One stamp of span `id` (end = 0 at its entry, 1 at its exit) on `stream`.
// Returns the cudaError_t of the launch (0 = ok).
int sp_stamp(void* buf, int n_spans, long long cap, int id, int end, void* stream) {
  span_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(buf),
                                                              n_spans, cap, id, end);
  return cudaGetLastError();
}

// Load the kernel's module now, so that no capture is the first to launch it.
int sp_load() {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, span_stamp);
}

}  // extern "C"
