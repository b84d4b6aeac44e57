// Flash attention forward, CUDA C++ for sm_90a.
//
//     o = softmax(mask(softcap(q k^T / sqrt(hd)))) v
//
//     q (B, S, H, hd); k, v (B, Skv, K, hd), GQA: kv head = h / (H / K)
//     float32 or bfloat16 in, q's dtype out, float32 accumulation
//
// Replaces the TPU Pallas kernel flash_attention_fwd (_kernel) of the JAX
// package's kernels/flash_attention/kernel.py: a streaming softmax over
// key/value tiles on the sequential grid axis, with the output block and
// the running max and sum resident in VMEM, and fully masked tiles
// skipped.
//
// Here: one block of 256 threads per (q tile of BQ = 64 rows, head,
// batch).  The block loads its q tile once into shared memory, then
// streams the key/value tiles (BKV = 32 keys) that hold at least one
// allowed position through shared memory: the causal bound and the
// window bound decide the first and last tile, so fully masked tiles are
// never loaded.  Per tile it forms the 64 x 32 scores, applies the scale,
// the softcap and the mask, updates the running max and sum of each row
// (online softmax, float32), writes the probabilities to shared memory
// and adds P v to the output accumulator, which lives in registers.
// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4 ty .. 4 ty + 3
// in both products: scores at key columns tx + 16 c, output at head
// columns tx + 16 j, so a row's statistics stay with the 16 lanes of one
// half warp and reduce with four shuffles.  Shared tiles are float32
// whatever the input dtype; q and k rows are padded by 4 floats so the
// 16-byte reads of 16 different k rows fall in distinct banks.
//
// What bounds it on an H100: operations.  4 hd float operations per
// allowed (q, k) pair (137 GFLOP at yi-6b widths, S 4096, causal) against
// ~75 MB of inputs and output.  This kernel runs them on the CUDA cores
// in float32 (67 TFLOP/s at best), not on the tensor cores (989 TFLOP/s
// in bf16): it is the simple, right version.  wgmma with TMA-fed tiles
// is the later redesign.
//
// Numerics: masked scores are -inf and the running max starts at -inf;
// while a row has seen no allowed key its max is taken as 0 for the
// exponentials, so no exp(-inf - -inf) is ever formed and masked entries
// contribute exactly 0.  The output is acc / max(l, 1e-30) (IEEE
// division), written with __float2bfloat16_rn for bfloat16.  The softcap
// is cap * tanhf(s / cap) with IEEE division; no fast-math anywhere.
// Element offsets are 64-bit.
//
// Shared memory at hd 256: 141,824 bytes, past the 48 KB default, so the
// launcher raises the kernel's dynamic shared-memory limit first.
//
// C interface (ctypes): pointers and the stream are void*, sizes int64;
// returns cudaGetLastError() (cudaErrorInvalidValue for an hd that is
// not instantiated: 64, 128, 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BKV = 32;          // keys per tile
constexpr int THREADS = 256;
constexpr int RPT = BQ / 16;     // query rows per thread
constexpr int CPT = BKV / 16;    // score columns per thread
constexpr int PAD = 4;           // floats of padding per q / k row
constexpr int PS = BKV + PAD;    // row stride of the probability tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
    return sizeof(float) *
           ((size_t)BQ * (HD + PAD) + (size_t)BKV * (HD + PAD) +
            (size_t)BKV * HD + (size_t)BQ * PS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int64_t S, int64_t Skv, int64_t H, int64_t G, int causal,
                 int64_t window, float softcap, float scale) {
    constexpr int QS = HD + PAD;      // row stride of the q and k tiles
    constexpr int DPT = HD / 16;      // output columns per thread
    extern __shared__ float4 smem4[];
    float* sq = reinterpret_cast<float*>(smem4);
    float* sk = sq + BQ * QS;
    float* sv = sk + BKV * QS;
    float* sp = sv + BKV * HD;

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int64_t q0 = (int64_t)blockIdx.x * BQ;
    const int64_t h = blockIdx.y, b = blockIdx.z;
    const int64_t K = H / G, kh = h / G;
    const int64_t q_step = H * HD, kv_step = K * HD;  // between positions
    const T* qb = q + (b * S * H + h) * HD;
    const T* kb = k + (b * Skv * K + kh) * HD;
    const T* vb = v + (b * Skv * K + kh) * HD;

    for (int i = tid; i < BQ * HD; i += THREADS) {
        const int r = i / HD, d = i % HD;
        const int64_t qp = q0 + r;
        sq[r * QS + d] = qp < S ? to_f32(qb[qp * q_step + d]) : 0.f;
    }

    float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[r][j] = 0.f;
    }

    // keys that some row of this tile may see: [k_lo, k_hi]
    const int64_t q_last = (q0 + BQ < S ? q0 + BQ : S) - 1;
    int64_t k_hi = Skv - 1;
    if (causal && q_last < k_hi) k_hi = q_last;
    int64_t k_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;

    for (int64_t t0 = (k_lo / BKV) * BKV; t0 <= k_hi; t0 += BKV) {
        __syncthreads();     // the previous tile's P v is done with sk/sv/sp
        for (int i = tid; i < BKV * HD; i += THREADS) {
            const int r = i / HD, d = i % HD;
            const int64_t kp = t0 + r;
            const bool in = kp < Skv;
            sk[r * QS + d] = in ? to_f32(kb[kp * kv_step + d]) : 0.f;
            sv[r * HD + d] = in ? to_f32(vb[kp * kv_step + d]) : 0.f;
        }
        __syncthreads();

        // scores of rows 4 ty + r, key columns tx + 16 c
        float s[RPT][CPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; d += 4) {
            float4 qv[RPT], kv[CPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r)
                qv[r] = *reinterpret_cast<const float4*>(
                    &sq[(ty * RPT + r) * QS + d]);
#pragma unroll
            for (int c = 0; c < CPT; ++c)
                kv[c] = *reinterpret_cast<const float4*>(
                    &sk[(tx + 16 * c) * QS + d]);
#pragma unroll
            for (int r = 0; r < RPT; ++r)
#pragma unroll
                for (int c = 0; c < CPT; ++c) {
                    float a = s[r][c];
                    a = fmaf(qv[r].x, kv[c].x, a);
                    a = fmaf(qv[r].y, kv[c].y, a);
                    a = fmaf(qv[r].z, kv[c].z, a);
                    a = fmaf(qv[r].w, kv[c].w, a);
                    s[r][c] = a;
                }
        }

        // scale, softcap, mask; online softmax per row
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int64_t qp = q0 + ty * RPT + r;
            float mx = -INFINITY;
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                const int64_t kp = t0 + tx + 16 * c;
                float x = s[r][c] * scale;
                if (softcap > 0.f) x = softcap * tanhf(__fdiv_rn(x, softcap));
                const bool ok = kp < Skv && (!causal || kp <= qp) &&
                                (window <= 0 || qp - kp < window);
                s[r][c] = ok ? x : -INFINITY;
                mx = fmaxf(mx, s[r][c]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[r], mx);
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            const float corr = expf(m[r] - m_use);
            float ps = 0.f;
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                const float p = expf(s[r][c] - m_use);
                ps += p;
                sp[(ty * RPT + r) * PS + tx + 16 * c] = p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                ps += __shfl_xor_sync(0xffffffffu, ps, off);
            l[r] = l[r] * corr + ps;
            m[r] = m_new;
#pragma unroll
            for (int j = 0; j < DPT; ++j) acc[r][j] *= corr;
        }
        __syncthreads();

        // acc += P v over this tile's keys
#pragma unroll 2
        for (int kk = 0; kk < BKV; kk += 4) {
            float4 pv[RPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r)
                pv[r] = *reinterpret_cast<const float4*>(
                    &sp[(ty * RPT + r) * PS + kk]);
#pragma unroll
            for (int j = 0; j < DPT; ++j) {
                const int d = tx + 16 * j;
                const float v0 = sv[(kk + 0) * HD + d];
                const float v1 = sv[(kk + 1) * HD + d];
                const float v2 = sv[(kk + 2) * HD + d];
                const float v3 = sv[(kk + 3) * HD + d];
#pragma unroll
                for (int r = 0; r < RPT; ++r) {
                    float a = acc[r][j];
                    a = fmaf(pv[r].x, v0, a);
                    a = fmaf(pv[r].y, v1, a);
                    a = fmaf(pv[r].z, v2, a);
                    a = fmaf(pv[r].w, v3, a);
                    acc[r][j] = a;
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int64_t qp = q0 + ty * RPT + r;
        if (qp >= S) continue;
        const float denom = fmaxf(l[r], 1e-30f);
        T* orow = o + (b * S * H + h) * HD + qp * q_step;
#pragma unroll
        for (int j = 0; j < DPT; ++j)
            store(&orow[tx + 16 * j], __fdiv_rn(acc[r][j], denom));
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t S, int64_t Skv, int64_t H, int64_t K, int causal,
           int64_t window, float softcap, float scale, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
    flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, Skv, H, H / K,
        causal, window, softcap, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o,
                int64_t B, int64_t S, int64_t Skv, int64_t H, int64_t K,
                int64_t hd, int causal, int64_t window, float softcap,
                float scale, cudaStream_t st) {
    switch (hd) {
        case 64:
            return launch<T, 64>(q, k, v, o, B, S, Skv, H, K, causal, window,
                                 softcap, scale, st);
        case 128:
            return launch<T, 128>(q, k, v, o, B, S, Skv, H, K, causal,
                                  window, softcap, scale, st);
        case 256:
            return launch<T, 256>(q, k, v, o, B, S, Skv, H, K, causal,
                                  window, softcap, scale, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dtype 0: float32; 1: bfloat16 (q, k, v and o share it).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int64_t B, int64_t S, int64_t Skv, int64_t H,
                        int64_t K, int64_t hd, int causal, int64_t window,
                        float softcap, float scale, int dtype, void* stream) {
    if (B <= 0 || S <= 0 || Skv <= 0 || H <= 0 || K <= 0 || H % K)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return dispatch_hd<float>(q, k, v, o, B, S, Skv, H, K, hd, causal,
                                  window, softcap, scale, st);
    if (dtype == 1)
        return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, Skv, H, K, hd,
                                          causal, window, softcap, scale, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
