// The tracer's loops as conditional while-nodes of one CUDA graph, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It is the counterpart of XLA's on-device
// `while`: the JAX package's tracer runs its line search and its march as
// jax.lax.while_loop (hashmodnffbanks_idr_tpu/models/ray_tracing.py:316 and
// :333) inside the one jitted training step, and the host never reads a
// predicate.  The port captures the step with torch's CUDA graphs, cut at
// each loop into straight-line segments and a body per loop
// (utils/graphs.py); the functions here assemble them into one executable
// graph:
//
//   each segment            a child-graph node (torch's captured graph,
//                           cloned), in order;
//   each loop               a set_while kernel node, then a conditional
//                           while-node whose body holds the loop body's
//                           segments and nested loops, and a set_while
//                           node last;
//
// so one launch runs the whole step, the loops included.
//
// set_while(handle, pred, counter, max_iters, total, add) sets the node's
// condition to `pred && counter < max_iters` with cudaGraphSetConditional:
// JAX's loop condition with its iteration cap (the counter is the loop's k
// or it, which the body advances).  Before the node (add = 0) it decides
// whether the first body runs; at the end of a body (add = 1) it also adds
// the iteration to `total`, a device count the host folds into the launch
// counts when it reads them (it cannot know how many iterations ran).
//
// Bound: one thread reads 1 + 8 bytes, and reads and writes 8; the bytes
// bound is a few picoseconds.  What an iteration costs is the launch of a
// one-thread kernel node and the conditional node's re-evaluation on the
// device, a few microseconds, against a host round trip (a device-to-host
// read of the predicate, then the next launch) that it removes.
//
// Conditional nodes need CUDA 12.4 (toolkit and CUDA driver); the body graphs
// may hold kernel, memset, memcpy, empty, child-graph and conditional
// nodes, which is what torch's stream capture records for the tracer.  A
// node the runtime refuses returns its error: the caller raises.

#include <cuda_runtime.h>

#include <vector>

__global__ void set_while(cudaGraphConditionalHandle handle, const bool* pred,
                          const long long* counter, long long max_iters,
                          unsigned long long* total, int add) {
  if (add) *total += 1;
  cudaGraphSetConditional(handle, (*pred && *counter < max_iters) ? 1u : 0u);
}

namespace {

// Append a node to `graph` after *last (first in the graph when *last is
// null); *last <- the new node.
template <typename Add>
cudaError_t append(void** last, Add add) {
  cudaGraphNode_t node, dep = static_cast<cudaGraphNode_t>(*last);
  cudaError_t err = add(&node, dep ? &dep : nullptr, dep ? 1 : 0);
  if (err == cudaSuccess) *last = node;
  return err;
}

cudaError_t add_set_while(cudaGraph_t graph, void** last, cudaGraphConditionalHandle handle,
                          const void* pred, const void* counter, long long max_iters,
                          void* total, int add) {
  void* args[] = {&handle, &pred, &counter, &max_iters, &total, &add};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(set_while);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  return append(last, [&](cudaGraphNode_t* node, const cudaGraphNode_t* deps, size_t n) {
    return cudaGraphAddKernelNode(node, graph, deps, n, &p);
  });
}

}  // namespace

extern "C" {

// Each function returns the cudaError_t (0 = ok).  Graphs, nodes and
// executables are opaque pointers; `last` is the caller's record of the
// last node appended to a graph (null before the first).

int gl_graph_create(void** graph) {
  return cudaGraphCreate(reinterpret_cast<cudaGraph_t*>(graph), 0);
}

// Append `child` (a captured graph, cloned) as a child-graph node; an
// empty capture appends nothing.
int gl_add_child(void* graph, void** last, void* child) {
  size_t nodes = 0;
  cudaError_t err = cudaGraphGetNodes(static_cast<cudaGraph_t>(child), nullptr, &nodes);
  if (err != cudaSuccess || nodes == 0) return err;
  return append(last, [&](cudaGraphNode_t* node, const cudaGraphNode_t* deps, size_t n) {
    return cudaGraphAddChildGraphNode(node, static_cast<cudaGraph_t>(graph), deps, n,
                                      static_cast<cudaGraph_t>(child));
  });
}

// Append a set_while node (add 0) and a while-node after it, whose body
// runs while `pred && counter < max_iters`.  *body <- the body graph to
// fill, *handle <- its condition's handle (for gl_end_body).
int gl_add_while(void* graph, void** last, const void* pred, const void* counter,
                 long long max_iters, void* total, void** body, unsigned long long* handle) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphConditionalHandle h;
  cudaError_t err = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (err == cudaSuccess) err = add_set_while(g, last, h, pred, counter, max_iters, total, 0);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = h;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  err = append(last, [&](cudaGraphNode_t* node, const cudaGraphNode_t* deps, size_t n) {
#if CUDART_VERSION >= 13000
    return cudaGraphAddNode(node, g, deps, nullptr, n, &params);
#else
    return cudaGraphAddNode(node, g, deps, n, &params);
#endif
  });
  if (err != cudaSuccess) return err;
  *body = params.conditional.phGraph_out[0];
  *handle = h;
  return cudaSuccess;
}

// Close a while-node's body: a set_while node (add 1) after its last node.
int gl_end_body(void* body, void** last, unsigned long long handle, const void* pred,
                const void* counter, long long max_iters, void* total) {
  return add_set_while(static_cast<cudaGraph_t>(body), last, handle, pred, counter, max_iters,
                       total, 1);
}

// counts[0..3] <- the nodes of `graph`, a captured segment (flat: stream
// capture records no child graphs), by type: kernel, memset, memcpy, and
// any other (empty, event).
int gl_count_nodes(void* graph, unsigned long long* counts) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(g, nodes.data(), &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err == cudaSuccess) {
      counts[type == cudaGraphNodeTypeKernel   ? 0
             : type == cudaGraphNodeTypeMemset ? 1
             : type == cudaGraphNodeTypeMemcpy ? 2
                                               : 3] += 1;
    }
  }
  return err;
}

int gl_instantiate(void** exec, void* graph) {
  return cudaGraphInstantiate(reinterpret_cast<cudaGraphExec_t*>(exec),
                              static_cast<cudaGraph_t>(graph), 0);
}

int gl_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

int gl_destroy(void* exec, void* graph) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    cudaError_t e = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e;
  }
  return err;
}

}  // extern "C"
