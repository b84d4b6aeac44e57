// RG-LRU diagonal linear recurrence, CUDA C++ for sm_90a.
//
//     h_t = a_t * h_{t-1} + b_t        a, b (B, S, D); h0 (B, D); h f32
//
// Replaces the TPU Pallas kernel rglru_scan_fwd (_kernel) of the JAX
// package's kernels/rglru/kernel.py.  There, the channel axis is tiled
// across the grid and time is chunked on the sequential grid axis, with a
// log-step doubling scan inside each chunk.  The doubling scan does not
// carry over: the port is held BIT-equal to its sequential plain version,
// which needs each channel's chain to run in order, one rounded multiply
// and one rounded add a step.
//
// What bounds it on an H100: bytes.  Each element of a and b is read
// once and each h written once: 503 MB in f32 at recurrentgemma-2b's
// widths (B2 S8192 D2560), 0.150 ms at 3.35 TB/s, and 336 MB (0.100 ms)
// with bf16 inputs.  The serial chain is no limit: about 8 cycles a step,
// 8192 steps in ~40 us.  What the card needs is bytes in flight: by
// Little's law ~20 KB per SM at 3.35 TB/s.  The kernel this one replaced
// ran one thread per channel straight from device memory, about 2.5 KB in
// flight per SM.
//
// Design: the B*D chains are cut into blocks of C channels of one batch
// row, C chosen so that about one block lands on each SM (B2 D2560 on 132
// SMs: 128 blocks of 40 channels, with no second wave).  Each block
// streams (TT steps x C channels) panels of a and b through a ring of
// STAGES shared-memory stages with cp.async 16-byte copies: every thread
// of the block issues copies, STAGES - 1 panels ahead, about 90 KB in
// flight per SM.  The first C threads then run the chains from shared
// memory, one channel each (neighbouring threads on neighbouring
// channels, so the reads are conflict-free and each warp's stores of h_t
// are coalesced).  TT is set so a stage holds ~32 KB whatever the dtype:
// bf16 moves its panels as f32 does, at twice the steps a stage.  The
// ring takes more than half of an SM's shared memory at these widths, so
// no SM holds two blocks.  Ragged edges: the last time panel is short
// (S not a multiple of TT), the last channel block is narrow (D not a
// multiple of C).  Where a row of a or b is not made of whole 16-byte
// chunks (D * element size not a multiple of 16, e.g. D 37 in f32 or D
// 2561 in bf16) or a pointer is not 16-byte aligned, the same ring is
// filled by element loads instead of cp.async.
//
// Bit-exactness: the multiply and the add are written with __fmul_rn and
// __fadd_rn, which nvcc never contracts into an FMA, so each is rounded
// to float32 exactly as the plain PyTorch version's two operations are.
//
// Times on an NVIDIA H100 80GB HBM3 at 700.00 W (benchmarks/
// torch_bench_kernels.py's card table, rglru-rg B2 S8192 D2560, one call
// alone between two CUDA events, host launch included; two runs of this
// source and, in brackets, two of the kernel it replaced, all in one call
// of the card; PERF.md, section 6): f32 0.243-0.263 ms [1.219-1.236],
// 1.91-2.07 TB/s, 57-62 % of the HBM bound; bf16 0.191-0.195 ms [1.993-
// 2.044], 52 % of its bound, but 0.227-0.238 ms in the two full runs
// that followed: over its 0.200 ms target, which is smaller than the
// run-to-run spread of a sub-millisecond call (PERF.md, section 7).
// What still holds it below the bound: with every chain serial, each
// block reads a and b as 160-byte (bf16: 80-byte) row pieces 10 KB (5 KB)
// apart.  Exploratory builds showed that the loads alone, not the chain
// or the stores, set the time, and that a deeper or shallower ring, wider
// blocks on fewer SMs, more loading threads and L2 prefetch hints did
// not speed them by more than a few percent.
//
// C interface (ctypes): pointers and the stream are void*, sizes int64;
// returns the first error of the device query, the shared-memory
// attribute and the launch (cudaGetLastError()).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int STAGES = 4;              // ring depth: 3 panels in flight
constexpr int MAX_C = THREADS;         // channels per block
constexpr int STAGE_BYTES = 32768;     // a and b panels of one stage

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One block: channels d0 .. d0 + C - 1 of batch row bi, all S steps.
// ASYNC: rows of whole, aligned 16-byte chunks (cp.async); else element
// loads into the same ring.
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  int64_t S, int64_t D, int C, int TT, int64_t nbd) {
    extern __shared__ __align__(16) uint8_t smem[];
    T* sa = reinterpret_cast<T*>(smem);            // [STAGES][TT][C]
    T* sb = sa + (size_t)STAGES * TT * C;
    const int tid = threadIdx.x;
    const int64_t bi = blockIdx.x / nbd;
    const int64_t d0 = (blockIdx.x - bi * nbd) * (int64_t)C;
    const int cw = (int)(D - d0 < C ? D - d0 : C);  // channels of this block
    const T* ab = a + bi * S * D + d0;              // step t at + t * D
    const T* bb = b + bi * S * D + d0;
    const int64_t ntiles = (S + TT - 1) / TT;

    auto load = [&](int64_t tile) {
        const int st = (int)(tile % STAGES);
        const int64_t t0 = tile * TT;
        const int rows = (int)(S - t0 < TT ? S - t0 : TT);
        T* da = sa + (size_t)st * TT * C;
        T* db = sb + (size_t)st * TT * C;
        if (ASYNC) {
            constexpr int VE = 16 / sizeof(T);      // elements a chunk
            const int cpr = cw / VE;                // cw is a multiple of VE
            for (int i = tid; i < rows * cpr; i += THREADS) {
                const int r = i / cpr, c = (i - r * cpr) * VE;
                const int64_t g = (t0 + r) * D + c;
                cp_async16(da + r * C + c, ab + g);
                cp_async16(db + r * C + c, bb + g);
            }
        } else {
            for (int i = tid; i < rows * cw; i += THREADS) {
                const int r = i / cw, c = i - r * cw;
                const int64_t g = (t0 + r) * D + c;
                da[r * C + c] = ab[g];
                db[r * C + c] = bb[g];
            }
        }
    };

#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) {
        if (p < ntiles) load(p);
        cp_async_commit();                          // one group a panel
    }
    float hv = tid < cw ? h0[bi * D + d0 + tid] : 0.f;
    float* out = h + bi * S * D + d0 + tid;
    for (int64_t i = 0; i < ntiles; ++i) {
        cp_async_wait<STAGES - 2>();   // this thread's copies of panel i
        __syncthreads();               // everyone's; panel i - 1 consumed
        if (i + STAGES - 1 < ntiles) load(i + STAGES - 1);
        cp_async_commit();
        if (tid < cw) {
            const int st = (int)(i % STAGES);
            const int64_t t0 = i * TT;
            const int rows = (int)(S - t0 < TT ? S - t0 : TT);
            const T* pa = sa + (size_t)st * TT * C + tid;
            const T* pb = sb + (size_t)st * TT * C + tid;
            float* o = out + t0 * D;
#pragma unroll 8
            for (int r = 0; r < rows; ++r) {
                hv = __fadd_rn(__fmul_rn(to_f32(pa[r * C]), hv),
                               to_f32(pb[r * C]));
                o[(int64_t)r * D] = hv;
            }
        }
    }
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, float* h,
           int64_t B, int64_t S, int64_t D, cudaStream_t stream) {
    constexpr int VE = 16 / sizeof(T);
    const bool async = D % VE == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    // about one block an SM: channels per block from the blocks a batch
    // row gets, rounded up to whole chunks
    const int unit = async ? VE : 1;
    const int64_t per_row = B >= sms ? 1 : sms / B;
    int64_t C = (D + per_row - 1) / per_row;
    C = (C + unit - 1) / unit * unit;
    if (C > MAX_C) C = MAX_C;
    const int64_t nbd = (D + C - 1) / C;
    int TT = (int)(STAGE_BYTES / (2 * C * (int64_t)sizeof(T)));
    TT = TT > 512 ? 512 : TT / 8 * 8;
    if (TT < 8) TT = 8;
    const size_t smem = (size_t)STAGES * 2 * TT * C * sizeof(T);
    const int64_t blocks = nbd * B;
    if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    auto kernel = async ? rglru_scan_kernel<T, true>
                        : rglru_scan_kernel<T, false>;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), h0, h, S, D,
        (int)C, TT, nbd);
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
