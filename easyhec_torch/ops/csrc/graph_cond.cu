// CUDA graph conditional node for the graphed calibration step
// (easyhec_torch/utils/cuda_graph.py::CondGraph, models/calib.py::_Scan).
//
// Replaces no TPU kernel. The JAX package's scan decides the rebin on the
// device with a lax.cond (easyhec_tpu/models/calib.py::opt_scan, astep);
// this is the counterpart for a CUDA graph: one executable graph per step,
//
//   set_if_kernel (one thread: the IF node's condition from a device bool)
//     -> IF node { child graph: the rebin, captured by PyTorch }
//     -> child graph: the step, captured by PyTorch,
//
// so a chunk of steps is queued as launches of this graph with no host read
// in between. PyTorch captures the body and the step as ordinary CUDA graphs
// sharing one memory pool (kept as raw graphs, keep_graph=True), so every
// allocation the body makes lands in that pool; this file only assembles
// them around the node and instantiates the result. The kernel reads one
// byte and does one store; its cost is the launch itself.
//
// Needs CUDA 12.4 or later (conditional nodes with child graphs in their
// body). Every function returns the cudaError_t of the first call that
// failed, 0 on success.
#include <cuda_runtime.h>

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
    cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

extern "C" {

// exec_out / graph_out: set_if_kernel(flag) -> IF { body } -> tail. The child
// graphs are cloned into the new graph.
int cond_graph_build(const void* flag, void* body, void* tail, void** exec_out,
                     void** graph_out) {
    cudaGraph_t g = nullptr;
    cudaGraphExec_t x = nullptr;
    cudaGraphConditionalHandle handle;
    cudaGraphNode_t set_node, if_node, body_node, tail_node;
    cudaKernelNodeParams kp = {};
    cudaGraphNodeParams cp = {};
    void* args[2] = {&handle, &flag};
    cudaError_t e = cudaGraphCreate(&g, 0);
    if (e != cudaSuccess) return e;
    e = cudaGraphConditionalHandleCreate(&handle, g, 0, 0);
    if (e != cudaSuccess) goto fail;
    kp.func = reinterpret_cast<void*>(set_if_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.sharedMemBytes = 0;
    kp.kernelParams = args;
    e = cudaGraphAddKernelNode(&set_node, g, nullptr, 0, &kp);
    if (e != cudaSuccess) goto fail;
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
#if CUDART_VERSION >= 13000
    e = cudaGraphAddNode(&if_node, g, &set_node, nullptr, 1, &cp);
#else
    e = cudaGraphAddNode(&if_node, g, &set_node, 1, &cp);
#endif
    if (e != cudaSuccess) goto fail;
    e = cudaGraphAddChildGraphNode(&body_node, cp.conditional.phGraph_out[0], nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
    if (e != cudaSuccess) goto fail;
    e = cudaGraphAddChildGraphNode(&tail_node, g, &if_node, 1, static_cast<cudaGraph_t>(tail));
    if (e != cudaSuccess) goto fail;
    e = cudaGraphInstantiate(&x, g, 0);
    if (e != cudaSuccess) goto fail;
    *exec_out = x;
    *graph_out = g;
    return cudaSuccess;
fail:
    cudaGraphDestroy(g);
    return e;
}

int cond_graph_launch(void* exec, void* stream) {
    return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                           static_cast<cudaStream_t>(stream));
}

int cond_graph_destroy(void* exec, void* graph) {
    cudaError_t e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
    cudaError_t f = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    return e != cudaSuccess ? e : f;
}

const char* cond_error_string(int e) {
    return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
