// Device clock stamps for the port's device spans
// (easyhec_torch/utils/profiling.py::DeviceSpans).
//
// Replaces no TPU kernel. A region of a CUDA graph is timed by two
// one-thread kernels captured around it: the first writes the device's
// global nanosecond timer into its row, the second adds the time since to
// the row's total and counts the close. Every replay adds up, so the host
// reads one total and one count per region name after a read it makes
// anyway. CUDA events would do the same outside a conditional node, but a
// conditional node's body may hold no event record node (CUDA refuses
// the graph), and the calibration's rebin is such a body.
//
// row: [open ns, total ns, closes], unsigned 64-bit. Every function
// returns the cudaError_t of the launch, 0 on success.
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__global__ void clock_open_kernel(unsigned long long* row) { row[0] = global_ns(); }

__global__ void clock_close_kernel(unsigned long long* row) {
    row[1] += global_ns() - row[0];
    row[2] += 1;
}

extern "C" {

int device_clock_stamp(void* row, int close, void* stream) {
    auto* r = static_cast<unsigned long long*>(row);
    auto s = static_cast<cudaStream_t>(stream);
    if (close)
        clock_close_kernel<<<1, 1, 0, s>>>(r);
    else
        clock_open_kernel<<<1, 1, 0, s>>>(r);
    return cudaGetLastError();
}

const char* device_clock_error_string(int e) {
    return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
