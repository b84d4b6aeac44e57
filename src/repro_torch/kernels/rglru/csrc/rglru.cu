// RG-LRU diagonal linear recurrence, CUDA C++ for sm_90a.
//
//     h_t = a_t * h_{t-1} + b_t        a, b (B, S, D); h0 (B, D); h f32
//
// Replaces the TPU Pallas kernel rglru_scan_fwd (_kernel) of the JAX
// package's kernels/rglru/kernel.py.  There, the channel axis is tiled
// across the grid and time is chunked on the sequential grid axis, with a
// log-step doubling scan inside each chunk.
//
// Here: one thread per (batch, channel), looping over time with the
// carry in a register.  Neighbouring threads take neighbouring channels,
// so every load of a_t, b_t and store of h_t is coalesced across the
// warp.  The loop is unrolled so that loads of later steps are in flight
// while the carry's dependent chain runs.
//
// What bounds it on an H100: bytes in principle (each element of a and b
// read once, each h written once: 252 MB at B2 S4096 D2560 in f32, 0.075
// ms at 3.35 TB/s), but at B*D = 5120 threads only a few warps per SM
// exist, each step waits on a dependent multiply-add and the loads of its
// own thread, so the kernel is latency-bound.  Splitting time into chunks
// with a second pass (or the doubling scan) is the later fix.
//
// Bit-exactness: the multiply and the add are written with __fmul_rn and
// __fadd_rn, which nvcc never contracts into an FMA, so each is rounded
// to float32 exactly as the plain PyTorch version's two operations are.
//
// C interface (ctypes): pointers and the stream are void*, sizes int64;
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  int64_t S, int64_t D, int64_t BD) {
    const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= BD) return;
    const int64_t bi = idx / D, d = idx - bi * D;
    int64_t off = bi * S * D + d;
    float hv = h0[idx];
#pragma unroll 8
    for (int64_t t = 0; t < S; ++t, off += D) {
        hv = __fadd_rn(__fmul_rn(to_f32(a[off]), hv), to_f32(b[off]));
        h[off] = hv;
    }
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, float* h,
           int64_t B, int64_t S, int64_t D, cudaStream_t stream) {
    const int64_t BD = B * D;
    const unsigned blocks = (unsigned)((BD + THREADS - 1) / THREADS);
    rglru_scan_kernel<T><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), h0, h, S, D, BD);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0: a and b are float32; 1: bfloat16.
int rglru_scan(const void* a, const void* b, const void* h0, void* h,
               int64_t B, int64_t S, int64_t D, int dtype, void* stream) {
    if (B <= 0 || S <= 0 || D <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* h0f = static_cast<const float*>(h0);
    float* hf = static_cast<float*>(h);
    if (dtype == 0) return launch<float>(a, b, h0f, hf, B, S, D, st);
    if (dtype == 1) return launch<__nv_bfloat16>(a, b, h0f, hf, B, S, D, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
