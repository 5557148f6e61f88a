// The batched step as one CUDA graph with its encoder rungs as conditional
// nodes: the counterpart of jax.jit(step) with jnp.searchsorted +
// lax.switch (fire_tpu/pipeline/batch_engine.py:455-468).
//
// PyTorch captures the step in parts (its capture API has no conditional
// node in every release): the front (detect, top-k pick, the rung index
// on the card), one body per encoder rung, and the back (tracker scan,
// packing).  fire_graph_compose chains them into one graph: each part a
// child graph node, and for a step with several rungs, a one-block
// kernel that sets one conditional handle per rung from the rung index,
// then one IF node per rung whose body holds that rung's part.  Exactly
// one body runs a launch; nothing is read on the host.  Conditional
// nodes need CUDA 12.4.
//
// The parts keep their own memory (PyTorch's graph pool): this file only
// arranges and launches them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_RUNGS = 8;
constexpr int ERR_TOO_MANY_RUNGS = 20001;  // above every cudaError_t

struct Handles {
  cudaGraphConditionalHandle h[MAX_RUNGS];
};

// Thread j opens rung j's body iff the step's rung index equals j.
__global__ void set_rungs(const long long* __restrict__ rung, Handles hs, int n) {
  const int j = threadIdx.x;
  if (j < n) cudaGraphSetConditional(hs.h[j], *rung == j ? 1u : 0u);
}

// cudaGraphAddNode took no edge data before CUDA 13 and takes it from
// CUDA 13 on: whichever form this toolkit declares.
template <typename F>
auto add_node(F f, cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* deps, size_t n,
              cudaGraphNodeParams* p, int) -> decltype(f(node, g, deps, n, p)) {
  return f(node, g, deps, n, p);
}
template <typename F>
auto add_node(F f, cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* deps, size_t n,
              cudaGraphNodeParams* p, long)
    -> decltype(f(node, g, deps, static_cast<const cudaGraphEdgeData*>(nullptr), n, p)) {
  return f(node, g, deps, nullptr, n, p);
}

}  // namespace

// Chains `n_items` items into one graph and instantiates it on the current
// device.  Item i is `graphs[g]` as a child graph where rungs[i] == 0, or,
// where rungs[i] = n > 0, the n graphs graphs[g .. g + n) as rung bodies
// of which the one numbered *rung_index[i] (a device int64) runs.
// Returns 0 and the executable graph in *exec_out, or a cudaError_t.
extern "C" int fire_graph_compose(int n_items, const int* rungs, void* const* graphs,
                                  void* const* rung_index, void** exec_out) {
  *exec_out = nullptr;
  cudaGraph_t root = nullptr;
  cudaError_t err = cudaGraphCreate(&root, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t prev = nullptr;
  int g = 0;
  for (int i = 0; i < n_items && err == cudaSuccess; ++i) {
    cudaGraphNode_t node = nullptr;
    const size_t n_deps = prev ? 1 : 0;
    if (rungs[i] == 0) {
      err = cudaGraphAddChildGraphNode(&node, root, &prev, n_deps,
                                       static_cast<cudaGraph_t>(graphs[g++]));
      prev = node;
      continue;
    }
    int n = rungs[i];
    if (n > MAX_RUNGS) {
      cudaGraphDestroy(root);
      return ERR_TOO_MANY_RUNGS;
    }
    Handles hs{};
    for (int j = 0; j < n && err == cudaSuccess; ++j)
      err = cudaGraphConditionalHandleCreate(&hs.h[j], root, 0, cudaGraphCondAssignDefault);
    if (err != cudaSuccess) break;
    const long long* index = static_cast<const long long*>(rung_index[i]);
    void* args[] = {&index, &hs, &n};
    cudaKernelNodeParams kp{};
    kp.func = reinterpret_cast<void*>(set_rungs);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(32);
    kp.kernelParams = args;
    err = cudaGraphAddKernelNode(&node, root, &prev, n_deps, &kp);
    prev = node;
    for (int j = 0; j < n && err == cudaSuccess; ++j) {
      cudaGraphNodeParams p{};
      p.type = cudaGraphNodeTypeConditional;
      p.conditional.handle = hs.h[j];
      p.conditional.type = cudaGraphCondTypeIf;
      p.conditional.size = 1;
      err = add_node(cudaGraphAddNode, &node, root, &prev, 1, &p, 0);
      if (err != cudaSuccess) break;
      cudaGraphNode_t child = nullptr;
      err = cudaGraphAddChildGraphNode(&child, p.conditional.phGraph_out[0], nullptr, 0,
                                       static_cast<cudaGraph_t>(graphs[g++]));
      prev = node;
    }
  }
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, root, 0);
  cudaGraphDestroy(root);
  if (err != cudaSuccess) return static_cast<int>(err);
  *exec_out = exec;
  return 0;
}

// One launch of a composed graph on `stream`.
extern "C" int fire_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int fire_graph_destroy(void* exec) {
  return static_cast<int>(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}
