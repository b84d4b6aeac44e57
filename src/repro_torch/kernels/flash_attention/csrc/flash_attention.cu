// Flash attention forward, CUDA C++ for sm_90a.
//
//     o = softmax(mask(softcap(q k^T / sqrt(hd)))) v
//
//     q (B, S, H, hd); k, v (B, Skv, K, hd), GQA: kv head = h / (H / K)
//     float32 or bfloat16 in, q's dtype out, float32 accumulation
//
// Replaces the TPU Pallas kernel flash_attention_fwd
// (src/repro/kernels/flash_attention/kernel.py:88, _kernel :31-85): a
// streaming softmax over key/value tiles on the sequential grid axis,
// with the output block and the running max and sum resident in VMEM,
// and fully masked tiles skipped.
//
// What bounds it on an H100: operations, 4 hd per allowed (q, k) pair
// (137 GFLOP at yi-6b widths, S 4096, causal) against ~75 MB of bf16
// inputs and output.  Two kernels, by dtype:
//
// bfloat16: the tensor cores (989 TFLOP/s dense bf16).  One block per
// (q tile of BQ = 128 rows, head, batch): two consumer warpgroups of 64
// query rows each and one producer warpgroup, which gives all but 24 of
// its registers to the consumers (setmaxnreg: 240 each).  One producer
// thread issues TMA loads (4-D tensor maps over (B, S, heads, hd),
// 128-byte swizzle, one box of 64 head columns per panel, so hd 128 and
// 256 take 2 and 4 boxes per row) of the q tile once and of the key/value
// tiles into a ring of 2 stages; mbarriers signal arrival (full) and
// release (empty).  Each consumer warpgroup runs S = q k^T as wgmma
// m64nBKVk16 with both operands in shared memory (K-major), the online
// softmax on S's accumulator in registers (a row's max and sum are
// reduced over the four threads of a quad; the sum stays per thread until
// the end), rounds P to bf16 in place into the register-A fragment (the
// accumulator layout of m64nNk16 is the A layout of the next product) and
// runs O += P v as wgmma m64nHDk16 with v's tile as the MN-major
// (transposed) B operand.  The warpgroup pipelines its tiles: it issues
// S_{i+1} and then P_i v_i, and softmaxes S_{i+1} while the tensor cores
// run P_i v_i (P is double-buffered in registers).  Tiles: BKV = 128 keys
// at hd 64 and 128 (S 64 + O 64 + two P of 32 registers per thread at hd
// 128), BKV = 64 at hd 256 (O alone takes 128 f32 registers); shared
// memory 80, 160 and 192 KB.  The softcap and the mask run as separate
// loops without branches, instantiated per tile for (softcap, edge), so
// masks cost only at the edge: a tile wholly inside every row's allowed
// range for a warpgroup skips the per-element test.  Blocks run heaviest q
// tile first (the block index runs the q tiles in reverse), so the causal
// tail does not idle the card.  TMA fills rows past S with zeros; keys
// past Skv are masked all the same.
//
// float32: the CUDA cores, so the 2e-4 gate holds (TF32 would not).  One
// block of 256 threads per (q tile of 64 rows, head, batch) streams
// 32-key tiles through shared memory as float32; thread (ty, tx) = (tid /
// 16, tid % 16) owns query rows 4 ty .. 4 ty + 3, scores at key columns
// tx + 16 c and output at head columns tx + 16 j, so a row's statistics
// stay with the 16 lanes of one half warp.  q and k rows are padded by 4
// floats so the 16-byte reads of 16 different k rows fall in distinct
// banks.  141,824 bytes of shared memory at hd 256.
//
// Both: the causal bound and the window bound decide the first and last
// key tile of a q tile, so fully masked tiles are never loaded.  Masked
// scores are -inf and the running max starts at -inf; while a row has
// seen no allowed key its max is taken as 0 for the exponentials, so no
// exp(-inf - -inf) is ever formed and masked entries contribute exactly
// 0.  The output is acc / max(l, 1e-30) (IEEE division), rounded with
// __float2bfloat16_rn for bfloat16.  The bf16 kernel takes exponentials
// as 2^x (ex2.approx.ftz, the instruction exp2f is built on; a result
// below 2^-126 flushes to 0, which a row sum of at least 1 cannot see)
// with log2(e) folded into the scale, and rounds P to bf16 before P v.
// The softcap is cap * tanhf(s / cap) with the correctly rounded
// quotient (the f32 kernel: __fdiv_rn; the bf16 kernel: div_cap below,
// for cap in [2^-20, 2^20]); no fast-math anywhere.  Element offsets are
// 64-bit.
//
// Rows that see no key.  Row q may see keys [max(0, q - window + 1),
// min(Skv - 1, causal ? q : Skv - 1)] (window <= 0: no lower bound); the
// range is empty exactly when window > 0 and q >= Skv + window - 1, which
// happens only for Skv < S.  The reference fills masked scores with
// -1e30, so such a row softmaxes to a uniform row and returns the mean of
// v over all Skv keys of its kv head.  The skipped tiles are never loaded,
// so the kernels take that mean from mean_v (one block per (kv head,
// batch), launched by the wrapper only when some row is fully masked) and
// write it, rounded to the output type, in the epilogue.
//
// Times on an H100 80GB HBM3 at 700 W (chip_smoke.py's card table, B1;
// the CUDA-core bf16 kernel this one replaced in brackets): bf16 at
// yi-6b widths (S4096 H32 K4 hd128, causal) 0.385 ms [6.491], 357
// TFLOP/s, against scaled_dot_product_attention's 0.307; grok-1 (S8192
// H48 K8 hd128, softcap 30) 3.766 ms [36.345]; recurrentgemma-2b (S8192
// H10 K1 hd256, window 2048) 0.462 ms [8.389]; float32 6.297, 35.672 and
// 7.405 ms (PERF.md, section 6).
//
// C interface (ctypes): pointers and the stream are void*, sizes int64;
// returns cudaGetLastError(), cudaErrorInvalidValue for what it does not
// take (hd not 64, 128 or 256; a fully masked row without vmean; a
// pointer the TMA cannot address; a bf16 softcap outside [2^-20, 2^20]),
// or 10000 + the CUresult of a failed cuTensorMapEncodeTiled (20000 if
// cuTensorMapEncodeTiled cannot be found).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// the kernels' common test for a row that no key may be seen by
__host__ __device__ __forceinline__ bool no_key(int64_t qp, int64_t Skv,
                                                int64_t window) {
    return window > 0 && qp >= Skv + window - 1;
}

// mean of v over all Skv positions of each (batch, kv head): (B, K, hd)
// float32, one block of hd threads per (kv head, batch)
template <typename T>
__global__ void mean_v_kernel(const T* __restrict__ v,
                              float* __restrict__ vmean, int64_t Skv,
                              int64_t K, int64_t hd) {
    const int64_t kh = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
    const T* p = v + (b * Skv * K + kh) * hd + d;
    float s = 0.f;
    for (int64_t t = 0; t < Skv; ++t) s += to_f32(p[t * K * hd]);
    vmean[(b * K + kh) * hd + d] = __fdiv_rn(s, (float)Skv);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;           // query rows per block
constexpr int BKV = 32;          // keys per tile
constexpr int THREADS = 256;
constexpr int RPT = BQ / 16;     // query rows per thread
constexpr int CPT = BKV / 16;    // score columns per thread
constexpr int PAD = 4;           // floats of padding per q / k row
constexpr int PS = BKV + PAD;    // row stride of the probability tile

template <int HD>
constexpr size_t smem_bytes() {
    return sizeof(float) *
           ((size_t)BQ * (HD + PAD) + (size_t)BKV * (HD + PAD) +
            (size_t)BKV * HD + (size_t)BQ * PS);
}

// instantiated for float only: bfloat16 runs on the tensor cores (tc)
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const float* __restrict__ vmean, int64_t S, int64_t Skv,
                 int64_t H, int64_t G, int causal, int64_t window,
                 float softcap, float scale) {
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
        T* orow = o + (b * S * H + h) * HD + qp * q_step;
        if (no_key(qp, Skv, window)) {
            const float* mv = vmean + (b * K + kh) * HD;
#pragma unroll
            for (int j = 0; j < DPT; ++j)
                store(&orow[tx + 16 * j], mv[tx + 16 * j]);
            continue;
        }
        const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < DPT; ++j)
            store(&orow[tx + 16 * j], __fdiv_rn(acc[r][j], denom));
    }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), TMA-fed key/value ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;                  // two consumer warpgroups x 64 rows
constexpr int CONSUMERS = 2;             // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + a producer warpgroup
// setmaxnreg: 384 threads start at 168 registers each; the producer gives
// 144 of its 168 to the consumers, which take 240 (2 x 128 x 72 = 128 x 144)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int STAGES = 2;                // key/value ring depth
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Tiles {
    static constexpr int BKV = HD == 256 ? 64 : 128;   // keys per tile
    static constexpr int PANELS = HD / 64;  // 128-byte swizzle boxes per row
    static constexpr uint32_t Q_BYTES = BQ * HD * 2;
    static constexpr uint32_t KV_BYTES = BKV * HD * 2;   // one of k or v
    static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;
    // 1024-byte alignment slack, the q tile, the ring, 1 + 2 STAGES
    // mbarriers
    static constexpr size_t SMEM =
        1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * (1 + 2 * STAGES);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}

// wait until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// one TMA box (64 head columns x 1 head x rows positions x 1 batch) into
// shared memory, completing on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int pos, int batch) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
        "r"(pos), "r"(batch)
        : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1
// (SWIZZLE_128B).  K-major: SBO = 1024 (8 rows of 128 B), LBO unused.
// MN-major: LBO = the stride between 64-column panels, SBO = 1024 (8
// rows of the K dimension).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// keep the compiler from moving accesses of accumulator registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = low half
    return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, f32 += bf16 x bf16.  Accumulator layout (per thread t of
// the warpgroup, warp w = t / 32, lane l): d[4 j + e] is row 16 w + l / 4,
// column 8 j + 2 (l % 4) + e; d[4 j + 2 + e] the same column, row + 8.
template <int N>
struct Mma;

template <>
struct Mma<64> {
    // D (+)= A B; A and B from shared memory, both K-major (trans 0, 0)
    __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
            "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31}"
            ", %32, %33, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
              "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
              "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "l"(a), "l"(b), "r"(accumulate));
    }
    // D = A B (D's old values unread), as ss with accumulate 0
    __device__ __forceinline__ static void ss0(float (&d)[32], uint64_t a,
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
            "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31}"
            ", %32, %33, p, 1, 1, 0, 0;\n}\n"
            : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
              "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
              "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
              "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
              "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
              "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
              "=f"(d[30]), "=f"(d[31])
            : "l"(a), "l"(b), "r"(0));
    }
    // D += A B; A from registers (bf16 pairs), B from shared memory,
    // MN-major (trans-b 1)
    __device__ __forceinline__ static void rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
            "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31}"
            ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
              "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
              "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <>
struct Mma<128> {
    // D (+)= A B; A and B from shared memory, both K-major (trans 0, 0)
    __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
            "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
            "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
            "%60, %61, %62, %63}"
            ", %64, %65, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
              "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
              "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
              "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
              "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
              "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
              "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(a), "l"(b), "r"(accumulate));
    }
    // D = A B (D's old values unread), as ss with accumulate 0
    __device__ __forceinline__ static void ss0(float (&d)[64], uint64_t a,
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
            "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
            "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
            "%60, %61, %62, %63}"
            ", %64, %65, p, 1, 1, 0, 0;\n}\n"
            : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
              "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
              "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
              "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
              "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
              "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
              "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
              "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
              "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
              "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
              "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
              "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
              "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
            : "l"(a), "l"(b), "r"(0));
    }
    // D += A B; A from registers (bf16 pairs), B from shared memory,
    // MN-major (trans-b 1)
    __device__ __forceinline__ static void rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
            "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
            "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
            "%60, %61, %62, %63}"
            ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
              "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
              "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
              "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
              "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
              "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
              "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <>
struct Mma<256> {
    // D += A B; A from registers (bf16 pairs), B from shared memory,
    // MN-major (trans-b 1)
    __device__ __forceinline__ static void rs(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
            "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
            "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
            "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
            "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
            "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
            "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
            "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
            "%120, %121, %122, %123, %124, %125, %126, %127}"
            ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
              "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
              "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
              "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
              "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
              "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
              "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
              "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
              "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
              "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
              "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
              "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
              "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
              "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
              "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
              "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
              "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
              "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
              "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
              "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
              "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

__device__ __forceinline__ float ex2(float x) {       // 2^x, flush to zero
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// issue S = q k^T for one warpgroup's 64 rows over hd in steps of 16 (4 per
// 64-column panel); K-major operands, 32 bytes further per step
template <int HD, int BKV>
__device__ __forceinline__ void issue_qk(float (&sc)[BKV / 2], uint32_t sq_wg,
                                         uint32_t sk) {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;
        const uint64_t da =
            sw128_desc(sq_wg + (ks / 4) * BQ * 128 + off, 16, 1024);
        const uint64_t db = sw128_desc(sk + (ks / 4) * BKV * 128 + off, 16, 1024);
        if (ks == 0)
            Mma<BKV>::ss0(sc, da, db);      // S's old values are not read
        else
            Mma<BKV>::ss(sc, da, db, 1);
    }
}

// issue O += P v over a tile's keys in steps of 16: v's tile is the
// MN-major B operand, 16 rows of 128 B further per step, panels LBO apart
template <int HD, int BKV>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         const uint32_t (&pa)[BKV / 16][4],
                                         uint32_t sv) {
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc)
        Mma<HD>::rs(acc, pa[kc],
                    sw128_desc(sv + kc * 16 * 128, BKV * 128, 1024));
}

// x / cap rounded to nearest, as IEEE division rounds it, with no call
// and no branch (__fdiv_rn's slow-path call serializes the pipeline):
// Markstein's correction q + (x - q cap) / cap with rcap, the correctly
// rounded 1 / cap, gives the correctly rounded quotient while no step
// overflows or underflows, which holds for |x| in [2^-100, 2^100] and cap
// in [2^-20, 2^20] (chip_smoke.py holds it against __fdiv_rn over every
// such float x, for the configs' caps and divisors across that range:
// flash_attention_check_div_cap; the launcher refuses a cap outside it).
// x is clamped into that range first:
// past 2^100, tanh(x / cap) is +-1 all the same, and below 2^-100 the
// logit is 0 to the softmax either way.
__device__ __forceinline__ float div_cap(float x, float cap, float rcap) {
    const float c = fminf(fmaxf(x, -0x1p100f), 0x1p100f);
    const float q = c * rcap;
    return fmaf(fmaf(-q, cap, c), rcap, q);
}

// what a consumer thread needs to turn a tile's scores into probabilities
struct Mask {
    int Skv, causal, window;
    float softcap, scale, sl2;   // sl2: (softcap or scale) * log2(e)
    float rcap;                  // 1 / softcap, correctly rounded
    int qa, r0, cq;              // warpgroup's first row, thread's rows r0
                                 // and r0 + 8, column offset 2 (lane % 4)
};

// running max (log2 domain) and per-thread partial sums of rows r0, r0 + 8
struct Rows {
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
};

// the softcap and the mask applied to a tile's scores in place; CAP and
// EDGE are template arguments so that each tile runs a loop without
// branches (masked scores become -inf)
template <int BKV, bool CAP, bool EDGE>
__device__ __forceinline__ void transform(float (&sc)[BKV / 2], const Mask& mk,
                                          int t0) {
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            float x0 = sc[4 * j + e], x1 = sc[4 * j + 2 + e];
            if (CAP) {
                x0 = tanhf(div_cap(x0 * mk.scale, mk.softcap, mk.rcap));
                x1 = tanhf(div_cap(x1 * mk.scale, mk.softcap, mk.rcap));
            }
            if (EDGE) {
                const int kp = t0 + 8 * j + mk.cq + e, r1 = mk.r0 + 8;
                const bool in = kp < mk.Skv;
                const bool ok0 = in && (!mk.causal || kp <= mk.r0) &&
                                 (mk.window <= 0 || mk.r0 - kp < mk.window);
                const bool ok1 = in && (!mk.causal || kp <= r1) &&
                                 (mk.window <= 0 || r1 - kp < mk.window);
                x0 = ok0 ? x0 : -INFINITY;
                x1 = ok1 ? x1 : -INFINITY;
            }
            sc[4 * j + e] = x0;
            sc[4 * j + 2 + e] = x1;
        }
    }
}

// scores of the tile at key t0 -> P as bf16 register-A fragments; updates
// the running max and sum, and gives the factors c0, c1 that rescale the
// output rows to the new max
template <int BKV>
__device__ __forceinline__ void softmax_tile(float (&sc)[BKV / 2],
                                             uint32_t (&pa)[BKV / 16][4],
                                             Rows& rw, float& c0, float& c1,
                                             const Mask& mk, int t0) {
    // the per-element mask only where some row of the warpgroup may lose
    // a key of this tile
    const bool edge = t0 + BKV > mk.Skv ||
                      (mk.causal && t0 + BKV - 1 > mk.qa) ||
                      (mk.window > 0 && mk.qa + 63 - t0 >= mk.window);
    if (mk.softcap > 0.f) {
        if (edge)
            transform<BKV, true, true>(sc, mk, t0);
        else
            transform<BKV, true, false>(sc, mk, t0);
    } else if (edge) {
        transform<BKV, false, true>(sc, mk, t0);
    }
    // two chains per row
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i] = fmaxf(mx[i], sc[4 * j + i]);
    float mx0 = fmaxf(mx[0], mx[1]), mx1 = fmaxf(mx[2], mx[3]);
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // the max of x sl2 is sl2 times the max of x (sl2 > 0, rounding is
    // monotonic); while a row has seen no key its max is used as 0
    const float mn0 = fmaxf(rw.m0, mx0 * mk.sl2);
    const float mn1 = fmaxf(rw.m1, mx1 * mk.sl2);
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    c0 = ex2(rw.m0 - mu0);
    c1 = ex2(rw.m1 - mu1);
    rw.m0 = mn0;
    rw.m1 = mn1;
    float ps[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
        float p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
            p[i] = ex2(fmaf(sc[8 * kc + i], mk.sl2, (i & 2) ? -mu1 : -mu0));
        ps[0] += p[0] + p[1];
        ps[1] += p[4] + p[5];
        ps[2] += p[2] + p[3];
        ps[3] += p[6] + p[7];
        pa[kc][0] = pack_bf16(p[0], p[1]);    // row r0, keys 16 kc + cq
        pa[kc][1] = pack_bf16(p[2], p[3]);    // row r0 + 8
        pa[kc][2] = pack_bf16(p[4], p[5]);    // row r0, keys + 8
        pa[kc][3] = pack_bf16(p[6], p[7]);    // row r0 + 8, keys + 8
    }
    rw.l0 = rw.l0 * c0 + (ps[0] + ps[1]);
    rw.l1 = rw.l1 * c1 + (ps[2] + ps[3]);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ o, const float* __restrict__ vmean,
             int S, int Skv, int H, int G, int B, int causal, int window,
             float softcap, float rcap, float scale) {
    using TL = Tiles<HD>;
    constexpr int BKV = TL::BKV, PANELS = TL::PANELS;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t ring = sq + TL::Q_BYTES;
    const uint32_t bars = ring + STAGES * TL::STAGE_BYTES;
    const uint32_t q_full = bars;
    // full[s] at bars + 8 (1 + s), empty[s] at bars + 8 (1 + STAGES + s)

    // heaviest q tile first: the block index runs the q tiles in reverse
    const int nq = (S + BQ - 1) / BQ;
    const int64_t hb = (int64_t)H * B;
    const int qt = nq - 1 - (int)(blockIdx.x / hb);
    const int rem = (int)(blockIdx.x % hb);
    const int h = rem % H, b = rem / H, kh = h / G;
    const int q0 = qt * BQ;

    // keys that some row of this q tile may see: [k_lo, k_hi]
    const int q_last = min(q0 + BQ, S) - 1;
    int k_hi = Skv - 1;
    if (causal && q_last < k_hi) k_hi = q_last;
    int k_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
    const int t_first = (k_lo / BKV) * BKV;
    const int n_tiles = k_lo > k_hi ? 0 : (k_hi - t_first) / BKV + 1;

    const int tid = threadIdx.x;
    if (tid == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bars + 8 * (1 + s), 1);
            mbar_init(bars + 8 * (1 + STAGES + s), CONSUMERS * 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= CONSUMERS * 128) {
        // producer warpgroup: gives its registers to the consumers; one
        // thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
            PRODUCER_REGS));
        if (tid == CONSUMERS * 128 && n_tiles > 0) {
            mbar_expect_tx(q_full, TL::Q_BYTES);
            for (int p = 0; p < PANELS; ++p)
                tma_load(sq + p * BQ * 128, &tq, q_full, p * 64, h, q0, b);
            for (int it = 0; it < n_tiles; ++it) {
                const int s = it % STAGES;
                const uint32_t full = bars + 8 * (1 + s);
                mbar_wait(bars + 8 * (1 + STAGES + s),
                          ((it / STAGES) & 1) ^ 1);
                mbar_expect_tx(full, TL::STAGE_BYTES);
                const int t0 = t_first + it * BKV;
                const uint32_t sk = ring + s * TL::STAGE_BYTES;
                const uint32_t sv = sk + TL::KV_BYTES;
                for (int p = 0; p < PANELS; ++p) {
                    tma_load(sk + p * BKV * 128, &tk, full, p * 64, kh, t0, b);
                    tma_load(sv + p * BKV * 128, &tv, full, p * 64, kh, t0, b);
                }
            }
        }
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));

    // consumer warpgroup wg: rows qa .. qa + 63; this thread rows r0, r0 + 8
    const int wg = tid / 128, lane = tid % 32;
    const int qa = q0 + 64 * wg;
    const int r0 = qa + 16 * ((tid % 128) / 32) + lane / 4;
    const uint32_t sq_wg = sq + wg * 64 * 128;
    const Mask mask{Skv, causal, window, softcap, scale,
                    (softcap > 0.f ? softcap : scale) * LOG2E, rcap, qa, r0,
                    2 * (lane % 4)};

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    Rows rows;

    // Software pipeline inside the warpgroup: while the tensor cores run
    // P_i v_i, the CUDA cores softmax S_{i+1}, which was issued first.
    if (n_tiles > 0) {
        uint32_t pa[BKV / 16][4], pb[BKV / 16][4];
        float c0, c1;
        mbar_wait(q_full, 0);
        mbar_wait(bars + 8, 0);
        {
            float sc[BKV / 2];
            wgmma_fence();
            issue_qk<HD, BKV>(sc, sq_wg, ring);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);
            softmax_tile<BKV>(sc, pa, rows, c0, c1, mask, t_first);
        }
        // tile it: P_it v_it runs while S_{it+1} is softmaxed into pn
        auto step = [&](int it, const uint32_t (&pc)[BKV / 16][4],
                        uint32_t (&pn)[BKV / 16][4]) {
            const int s = it % STAGES, s1 = (it + 1) % STAGES;
            float sc[BKV / 2];
            mbar_wait(bars + 8 * (1 + s1), ((it + 1) / STAGES) & 1);
            fence_regs(acc);
            wgmma_fence();
            issue_qk<HD, BKV>(sc, sq_wg, ring + s1 * TL::STAGE_BYTES);
            wgmma_commit();
            issue_pv<HD, BKV>(acc, pc,
                              ring + s * TL::STAGE_BYTES + TL::KV_BYTES);
            wgmma_commit();
            wgmma_wait<1>();                // S_{it+1} is in
            fence_regs(sc);
            softmax_tile<BKV>(sc, pn, rows, c0, c1, mask,
                              t_first + (it + 1) * BKV);
            wgmma_wait<0>();
            fence_regs(acc);
            if (lane == 0) mbar_arrive(bars + 8 * (1 + STAGES + s));
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
                acc[4 * j] *= c0;
                acc[4 * j + 1] *= c0;
                acc[4 * j + 2] *= c1;
                acc[4 * j + 3] *= c1;
            }
        };
        auto last = [&](const uint32_t (&pc)[BKV / 16][4]) {
            const int s = (n_tiles - 1) % STAGES;
            fence_regs(acc);
            wgmma_fence();
            issue_pv<HD, BKV>(acc, pc,
                              ring + s * TL::STAGE_BYTES + TL::KV_BYTES);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
            if (lane == 0) mbar_arrive(bars + 8 * (1 + STAGES + s));
        };
        int it = 0;
        for (; it + 2 < n_tiles; it += 2) {
            step(it, pa, pb);
            step(it + 1, pb, pa);
        }
        if (it + 1 < n_tiles) {
            step(it, pa, pb);
            last(pb);
        } else {
            last(pa);
        }
    }

    float l0 = rows.l0, l1 = rows.l1;
    const int cq = mask.cq;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int64_t K = H / G;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int64_t qp = r0 + 8 * rr;
        if (qp >= S) continue;
        __nv_bfloat16* orow = o + (((int64_t)b * S + qp) * H + h) * HD;
        if (no_key(qp, Skv, window)) {
            const float* mv = vmean + ((int64_t)b * K + kh) * HD;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
                    __floats2bfloat162_rn(mv[8 * j + cq], mv[8 * j + cq + 1]);
            continue;
        }
        const float den = fmaxf(rr ? l1 : l0, 1e-30f);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
                __floats2bfloat162_rn(__fdiv_rn(acc[4 * j + 2 * rr], den),
                                      __fdiv_rn(acc[4 * j + 2 * rr + 1], den));
    }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (cudaGetDriverEntryPointByVersion), so the library links no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q);
#endif
        if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
    }
    return fn;
}

// (B, seq, heads, hd) bf16 as a 4-D map, innermost first; a box is 64 head
// columns (128 bytes, the swizzle span) x 1 head x rows positions x 1
// batch.  Positions past seq read as zeros.
int tensor_map(EncodeTiled enc, CUtensorMap* map, const void* base,
               int64_t B, int64_t seq, int64_t heads, int64_t hd,
               uint32_t rows) {
    if (reinterpret_cast<uintptr_t>(base) % 16)
        return (int)cudaErrorInvalidValue;
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                                (cuuint64_t)seq, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)(hd * 2),
                                   (cuuint64_t)(heads * hd * 2),
                                   (cuuint64_t)(seq * heads * hd * 2)};
    const cuuint32_t box[4] = {64, 1, rows, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                           const_cast<void*>(base), dims, strides, box, unit,
                           CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const float* vmean, int64_t B, int64_t S, int64_t Skv, int64_t H,
           int64_t K, int causal, int64_t window, float softcap, float scale,
           cudaStream_t stream) {
    using TL = Tiles<HD>;
    if (S >= (1ll << 31) || Skv >= (1ll << 31) || window >= (1ll << 31))
        return (int)cudaErrorInvalidValue;
    if (softcap > 0.f && (softcap < 0x1p-20f || softcap > 0x1p20f))
        return (int)cudaErrorInvalidValue;    // div_cap's checked range
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return 20000;
    CUtensorMap mq, mk, mv;
    int err = tensor_map(enc, &mq, q, B, S, H, HD, BQ);
    if (!err) err = tensor_map(enc, &mk, k, B, Skv, K, HD, TL::BKV);
    if (!err) err = tensor_map(enc, &mv, v, B, Skv, K, HD, TL::BKV);
    if (err) return err;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TL::SMEM);
    if (e != cudaSuccess) return (int)e;
    const int64_t blocks = (S + BQ - 1) / BQ * H * B;
    if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    flash_fwd_tc<HD><<<(unsigned)blocks, THREADS, TL::SMEM, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(o), vmean, (int)S, (int)Skv,
        (int)H, (int)(H / K), (int)B, causal, (int)(window > 0 ? window : 0),
        softcap, softcap > 0.f ? (float)(1.0 / (double)softcap) : 0.f, scale);
    return (int)cudaGetLastError();
}

// div_cap against __fdiv_rn for every float x with |x| in [2^-100,
// 2^100], for each divisor: mismatches[i] counts the x whose quotients by
// divisors[i] differ in any bit
__global__ void div_cap_check_kernel(const float* __restrict__ divisors,
                                     int n, unsigned long long* mismatches) {
    for (int i = 0; i < n; ++i) {
        const float cap = divisors[i], rcap = (float)(1.0 / (double)cap);
        unsigned long long bad = 0;
        for (uint64_t u = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
             u < (1ull << 32); u += (uint64_t)gridDim.x * blockDim.x) {
            const float x = __uint_as_float((uint32_t)u);
            const float ax = fabsf(x);
            if (!(ax >= 0x1p-100f && ax <= 0x1p100f)) continue;
            bad += __float_as_uint(div_cap(x, cap, rcap)) !=
                   __float_as_uint(__fdiv_rn(x, cap));
        }
        atomicAdd(&mismatches[i], bad);
    }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launchers and the C interface
// ---------------------------------------------------------------------------

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const float* vmean, int64_t B, int64_t S, int64_t Skv,
               int64_t H, int64_t K, int causal, int64_t window,
               float softcap, float scale, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<float, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
    flash_fwd_kernel<float, HD><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), vmean, S, Skv,
        H, H / K, causal, window, softcap, scale);
    return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              void* o, const float* vmean, int64_t B, int64_t S, int64_t Skv,
              int64_t H, int64_t K, int causal, int64_t window, float softcap,
              float scale, cudaStream_t st) {
    if (dtype == 0)
        return launch_f32<HD>(q, k, v, o, vmean, B, S, Skv, H, K, causal,
                              window, softcap, scale, st);
    if (dtype == 1)
        return tc::launch<HD>(q, k, v, o, vmean, B, S, Skv, H, K, causal,
                              window, softcap, scale, st);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype 0: float32 (CUDA cores); 1: bfloat16 (tensor cores).  q, k, v
// and o share it.  vmean: (B, K, hd) float32 from flash_attention_mean_v,
// required when some row sees no key (no_key), else may be NULL.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        const void* vmean, int64_t B, int64_t S, int64_t Skv,
                        int64_t H, int64_t K, int64_t hd, int causal,
                        int64_t window, float softcap, float scale, int dtype,
                        void* stream) {
    if (B <= 0 || S <= 0 || Skv <= 0 || H <= 0 || K <= 0 || H % K)
        return (int)cudaErrorInvalidValue;
    if (vmean == nullptr && no_key(S - 1, Skv, window))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* vm = static_cast<const float*>(vmean);
    switch (hd) {
        case 64:
            return launch_hd<64>(dtype, q, k, v, o, vm, B, S, Skv, H, K,
                                 causal, window, softcap, scale, st);
        case 128:
            return launch_hd<128>(dtype, q, k, v, o, vm, B, S, Skv, H, K,
                                  causal, window, softcap, scale, st);
        case 256:
            return launch_hd<256>(dtype, q, k, v, o, vm, B, S, Skv, H, K,
                                  causal, window, softcap, scale, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// The bf16 kernel's softcap quotient (div_cap) against IEEE division over
// every float |x| in [2^-100, 2^100], for n divisors (float32, device):
// mismatches (n uint64, device, zeroed by the caller) counts the
// differing quotients per divisor.  A check run by chip_smoke.py.
int flash_attention_check_div_cap(const void* divisors, int n,
                                  void* mismatches, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    tc::div_cap_check_kernel<<<132 * 8, 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(divisors), n,
        static_cast<unsigned long long*>(mismatches));
    return (int)cudaGetLastError();
}

// vmean (B, K, hd) float32 = the mean of v (B, Skv, K, hd) over its Skv
// positions: what a row that sees no key returns.
int flash_attention_mean_v(const void* v, void* vmean, int64_t B,
                           int64_t Skv, int64_t K, int64_t hd, int dtype,
                           void* stream) {
    if (B <= 0 || Skv <= 0 || K <= 0 || hd <= 0 || hd > 1024)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid((unsigned)K, (unsigned)B);
    float* out = static_cast<float*>(vmean);
    if (dtype == 0)
        mean_v_kernel<float><<<grid, (unsigned)hd, 0, st>>>(
            static_cast<const float*>(v), out, Skv, K, hd);
    else if (dtype == 1)
        mean_v_kernel<__nv_bfloat16><<<grid, (unsigned)hd, 0, st>>>(
            static_cast<const __nv_bfloat16*>(v), out, Skv, K, hd);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

}  // extern "C"
