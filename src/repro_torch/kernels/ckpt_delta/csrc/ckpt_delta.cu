// Delta-codec kernels of the checkpoint plane, CUDA C++ for sm_90a.
//
// Six kernels, one per TPU Pallas kernel of the JAX package's
// kernels/ckpt_delta/kernel.py:
//
//   flat_lossless_encode  <- flat_lossless_encode_fwd (_flat_lossless_encode_kernel)
//   flat_int8_encode      <- flat_delta_encode_fwd    (_flat_encode_kernel)
//   lossless_decode       <- lossless_decode_fwd      (_lossless_decode_kernel)
//   delta_decode          <- delta_decode_fwd         (_decode_kernel)
//   lossless_encode       <- lossless_encode_fwd      (_lossless_encode_kernel)
//   delta_encode          <- delta_encode_fwd         (_encode_kernel)
//
// The first four run on the device-placed delta path of the trainer (one
// fused launch over the packed state); the last two are the per-leaf
// encodes (one launch per leaf, zero-padded to whole groups by the
// wrapper) that the checkpoint calibration times as the pre-flat
// baseline.  Each per-leaf encode is its flat twin without the per-group
// change statistics: one template on ``kStats`` serves both.
//
// What bounds them on an H100: bytes.  Each element is touched once and
// costs one or two float operations, so every kernel is a streaming pass
// that can at best run at the HBM rate (16 B/element for the lossless
// encodes and decode, ~9 B for the int8 encodes, ~5 B for the int8
// decode).  For the per-leaf encodes the launch itself adds a few
// microseconds per leaf, which is the overhead they stand for; they are
// deliberately not fused.
// The design serves that: one block of 256 threads per 1024-element group,
// each thread moving its 4 elements as ONE 16-byte vector (coalesced,
// neighbouring threads on neighbouring addresses), per-group reductions in
// registers and shuffles (warp shuffle, then one combine of the 8 warps in
// shared memory) so nothing but the outputs goes back to memory.  Making
// them faster (persistent blocks, TMA) is later work.
//
// Bit-exactness: plain IEEE float32 arithmetic, no fast-math.  The
// subtraction, addition and multiplication are written with the _rn
// intrinsics so nvcc cannot contract anything into an FMA; the int8 scale
// and quotient use true IEEE division (-prec-div=true is nvcc's default)
// and rintf (round half to even, like jnp.round / np.round).
//
// Offsets: the packed state can exceed 2^31 elements, so every element
// offset is computed in 64 bits from blockIdx.x.
//
// C interface (bound with ctypes): every pointer and the stream are
// void*, sizes are int64; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 1024;
constexpr int THREADS = 256;            // 4 elements per thread
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Block-wide sum of one int per thread; the result is valid in every
// thread.  ``scratch`` holds WARPS ints.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_sum(v);
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += scratch[w];
    return total;
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_max(v);
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    float m = scratch[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, scratch[w]);
    return m;
}

__device__ __forceinline__ int changed(float a, float b) {
    return __float_as_uint(a) != __float_as_uint(b);
}

// ---------------------------------------------------------------------------
// #1 / #5 lossless encode: d = new - base, r = bits(new) ^ bits(base + d);
// with kStats (#1), per group: elements whose bits changed, nonzero
// residual words
// ---------------------------------------------------------------------------
template <bool kStats>
__global__ void __launch_bounds__(THREADS)
lossless_encode_kernel(const float4* __restrict__ nw,
                       const float4* __restrict__ bs,
                       float4* __restrict__ d, uint4* __restrict__ r,
                       int* __restrict__ group_changed,
                       int* __restrict__ group_rnnz) {
    __shared__ int s_changed[WARPS];
    __shared__ int s_rnnz[WARPS];
    const size_t g = blockIdx.x;
    const size_t i = g * (GROUP / 4) + threadIdx.x;
    const float4 n = nw[i];
    const float4 b = bs[i];
    float4 dd;
    dd.x = __fsub_rn(n.x, b.x);
    dd.y = __fsub_rn(n.y, b.y);
    dd.z = __fsub_rn(n.z, b.z);
    dd.w = __fsub_rn(n.w, b.w);
    uint4 rr;
    rr.x = __float_as_uint(n.x) ^ __float_as_uint(__fadd_rn(b.x, dd.x));
    rr.y = __float_as_uint(n.y) ^ __float_as_uint(__fadd_rn(b.y, dd.y));
    rr.z = __float_as_uint(n.z) ^ __float_as_uint(__fadd_rn(b.z, dd.z));
    rr.w = __float_as_uint(n.w) ^ __float_as_uint(__fadd_rn(b.w, dd.w));
    d[i] = dd;
    r[i] = rr;
    if constexpr (kStats) {
        const int c = changed(n.x, b.x) + changed(n.y, b.y)
                    + changed(n.z, b.z) + changed(n.w, b.w);
        const int z = (rr.x != 0u) + (rr.y != 0u) + (rr.z != 0u)
                    + (rr.w != 0u);
        const int ct = block_sum(c, s_changed);
        const int zt = block_sum(z, s_rnnz);
        if (threadIdx.x == 0) {
            group_changed[g] = ct;
            group_rnnz[g] = zt;
        }
    }
}

// ---------------------------------------------------------------------------
// #2 / #6 int8 encode: d = new - base, scale = max(max|d|, 1e-12) / 127,
// q = clip(rint(d / scale), -127, 127); with kStats (#2), the per-group
// changed count
// ---------------------------------------------------------------------------
__device__ __forceinline__ signed char quantize(float d, float scale) {
    float q = rintf(__fdiv_rn(d, scale));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    return static_cast<signed char>(static_cast<int>(q));
}

template <bool kStats>
__global__ void __launch_bounds__(THREADS)
int8_encode_kernel(const float4* __restrict__ nw,
                   const float4* __restrict__ bs,
                   char4* __restrict__ q, float* __restrict__ scales,
                   int* __restrict__ group_changed) {
    __shared__ float s_amax[WARPS];
    __shared__ int s_changed[WARPS];
    const size_t g = blockIdx.x;
    const size_t i = g * (GROUP / 4) + threadIdx.x;
    const float4 n = nw[i];
    const float4 b = bs[i];
    const float dx = __fsub_rn(n.x, b.x), dy = __fsub_rn(n.y, b.y);
    const float dz = __fsub_rn(n.z, b.z), dw = __fsub_rn(n.w, b.w);
    const float m = fmaxf(fmaxf(fabsf(dx), fabsf(dy)),
                          fmaxf(fabsf(dz), fabsf(dw)));
    const float amax = block_max(m, s_amax);
    const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
    char4 qq;
    qq.x = quantize(dx, scale);
    qq.y = quantize(dy, scale);
    qq.z = quantize(dz, scale);
    qq.w = quantize(dw, scale);
    q[i] = qq;
    if constexpr (kStats) {
        const int c = changed(n.x, b.x) + changed(n.y, b.y)
                    + changed(n.z, b.z) + changed(n.w, b.w);
        const int ct = block_sum(c, s_changed);
        if (threadIdx.x == 0) group_changed[g] = ct;
    }
    if (threadIdx.x == 0) scales[g] = scale;
}

// ---------------------------------------------------------------------------
// #3 lossless decode: out = f32(bits(base + d) ^ r)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
lossless_decode_kernel(const float4* __restrict__ bs,
                       const float4* __restrict__ d,
                       const uint4* __restrict__ r,
                       float4* __restrict__ out) {
    const size_t i = static_cast<size_t>(blockIdx.x) * (GROUP / 4)
                   + threadIdx.x;
    const float4 b = bs[i];
    const float4 dd = d[i];
    const uint4 rr = r[i];
    float4 o;
    o.x = __uint_as_float(__float_as_uint(__fadd_rn(b.x, dd.x)) ^ rr.x);
    o.y = __uint_as_float(__float_as_uint(__fadd_rn(b.y, dd.y)) ^ rr.y);
    o.z = __uint_as_float(__float_as_uint(__fadd_rn(b.z, dd.z)) ^ rr.z);
    o.w = __uint_as_float(__float_as_uint(__fadd_rn(b.w, dd.w)) ^ rr.w);
    out[i] = o;
}

// ---------------------------------------------------------------------------
// #4 int8 decode: d = q * scale[group]; the caller adds the base (kept
// apart so no multiply-add can be contracted into an FMA)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
delta_decode_kernel(const char4* __restrict__ q,
                    const float* __restrict__ scales,
                    float4* __restrict__ d) {
    const size_t g = blockIdx.x;
    const size_t i = g * (GROUP / 4) + threadIdx.x;
    const float s = scales[g];
    const char4 qq = q[i];
    float4 o;
    o.x = __fmul_rn(static_cast<float>(qq.x), s);
    o.y = __fmul_rn(static_cast<float>(qq.y), s);
    o.z = __fmul_rn(static_cast<float>(qq.z), s);
    o.w = __fmul_rn(static_cast<float>(qq.w), s);
    d[i] = o;
}

}  // namespace

extern "C" {

int ckpt_flat_lossless_encode(const void* nw, const void* bs, void* d,
                              void* r, void* group_changed,
                              void* group_rnnz, int64_t num_groups,
                              void* stream) {
    if (num_groups > 0) {
        lossless_encode_kernel<true><<<static_cast<unsigned>(num_groups),
                                       THREADS, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(nw), static_cast<const float4*>(bs),
            static_cast<float4*>(d), static_cast<uint4*>(r),
            static_cast<int*>(group_changed), static_cast<int*>(group_rnnz));
    }
    return static_cast<int>(cudaGetLastError());
}

int ckpt_flat_int8_encode(const void* nw, const void* bs, void* q,
                          void* scales, void* group_changed,
                          int64_t num_groups, void* stream) {
    if (num_groups > 0) {
        int8_encode_kernel<true><<<static_cast<unsigned>(num_groups),
                                   THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(nw), static_cast<const float4*>(bs),
            static_cast<char4*>(q), static_cast<float*>(scales),
            static_cast<int*>(group_changed));
    }
    return static_cast<int>(cudaGetLastError());
}

int ckpt_lossless_decode(const void* bs, const void* d, const void* r,
                         void* out, int64_t num_groups, void* stream) {
    if (num_groups > 0) {
        lossless_decode_kernel<<<static_cast<unsigned>(num_groups), THREADS,
                                 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(bs), static_cast<const float4*>(d),
            static_cast<const uint4*>(r), static_cast<float4*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}

int ckpt_delta_decode(const void* q, const void* scales, void* d,
                      int64_t num_groups, void* stream) {
    if (num_groups > 0) {
        delta_decode_kernel<<<static_cast<unsigned>(num_groups), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
            static_cast<const char4*>(q), static_cast<const float*>(scales),
            static_cast<float4*>(d));
    }
    return static_cast<int>(cudaGetLastError());
}

int ckpt_lossless_encode(const void* nw, const void* bs, void* d, void* r,
                         int64_t num_groups, void* stream) {
    if (num_groups > 0) {
        lossless_encode_kernel<false><<<static_cast<unsigned>(num_groups),
                                        THREADS, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(nw), static_cast<const float4*>(bs),
            static_cast<float4*>(d), static_cast<uint4*>(r), nullptr,
            nullptr);
    }
    return static_cast<int>(cudaGetLastError());
}

int ckpt_int8_encode(const void* nw, const void* bs, void* q, void* scales,
                     int64_t num_groups, void* stream) {
    if (num_groups > 0) {
        int8_encode_kernel<false><<<static_cast<unsigned>(num_groups),
                                    THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(nw), static_cast<const float4*>(bs),
            static_cast<char4*>(q), static_cast<float*>(scales), nullptr);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
