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
// float32 (namespace cc): the CUDA cores (67 TFLOP/s of f32 FMA), so the
// 2e-4 gate holds; TF32 or split-TF32 products on the tensor cores would
// not be exact f32 FMAs.  What held the kernel this one replaced at 20-23
// TFLOP/s: 4 x 2 score tiles per thread, so shared memory, not the FMA
// units, set the pace; scalar loads through registers with no overlap of
// loads and math; a mask and softcap test on every score; q tiles in
// forward order.  The design: one block of 256 threads, 16 x 16 (rg, cg),
// per (q tile, head, batch), BQ = 128 query rows (64 at hd 256) against
// BKV = 64-key tiles.  q is stored transposed (q^T [hd][BQ]), k row-major
// with rows padded by 4 floats, v row-major, P transposed (P^T [BKV][BQ +
// 4]).  S = q k^T runs as an outer product per thread: rows RT rg .. + RT
// - 1 (RT = BQ / 16) by keys cg + 16 j (4 keys): per 4 head columns, 4
// float4 reads of k and RT / 4 float4 reads of q^T per column feed 16 RT
// FMAs.  O += P v runs as an outer product of the same rows by head
// columns 4 cg + 64 i .. + 3 (hd / 16 columns): per key, RT / 4 float4
// reads of P^T and hd / 64 of v feed RT hd / 16 FMAs.  A warp holds 4
// rg by 8 cg, so each of those reads touches at most 8 distinct 16-byte
// chunks in distinct banks (the padding staggers k's rows): one wavefront.
// A row's 16 score columns lie in two warps: the row max is 3 shuffles
// and one exchange through shared memory ahead of the barrier that frees
// the k tile; the rescale stays in registers and the row sum per thread
// until the end.  k and v tiles come by cp.async (16-byte copies, zeros
// past Skv) into single buffers that alternate: v of tile i loads during
// S_i (issued after the barrier that opens tile i, which also ends P v of
// tile i - 1), k of tile i + 1 during the softmax and P_i v_i (issued
// after the barrier that frees k_i); three barriers a tile.  The softcap
// (a kernel template argument) and the mask (per tile: a tile wholly
// inside every row's allowed range takes no per-score test) are
// compile-time cases.  Shared memory 101,376 bytes at hd 64 (two blocks
// an SM, 128 registers), 166,912 at hd 128 (214 registers) and 215,552
// at hd 256 (BQ 64 keeps the 64 accumulators of hd 128; 168 registers);
// no spills (nvcc -Xptxas -v with the build's flags).
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
// quotient (div_cap below, for cap in [2^-20, 2^20], in both kernels);
// no fast-math anywhere.  The f32 kernel takes exponentials with expf
// and sums exact f32 FMAs.  Element offsets are
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
// Times on an NVIDIA H100 80GB HBM3 at 700.00 W (benchmarks/
// torch_bench_kernels.py's card table, B1, one call alone between two
// CUDA events, host launch included; two runs of this source and, in
// brackets, two of the f32 kernel it replaced, all in one call of the
// card; PERF.md, section 6): bf16 at yi-6b widths (S4096 H32 K4 hd128,
// causal) 0.369-0.375 ms, 367-372 TFLOP/s, against
// scaled_dot_product_attention's 0.292-0.295; grok-1 (S8192 H48 K8
// hd128, softcap 30) 3.76-3.79 ms; recurrentgemma-2b (S8192 H10 K1
// hd256, window 2048) 0.472-0.507 ms.  float32: yi-6b 3.603-3.637 ms
// [6.364-6.386], 37.8-38.2 TFLOP/s, 56-57 % of the CUDA cores' 67,
// against SDPA's 13.37-13.40; grok-1 21.99-22.05 ms [35.68-35.85], 37.4-
// 37.5 TFLOP/s; recurrentgemma-2b 4.514-4.612 ms [7.409-7.452] (4.635-
// 4.639 in the two full runs that followed), 32.6-33.3 TFLOP/s, 48-50 %
// of its bound, against SDPA's 24.59-24.62.  At hd 256 the f32 kernel
// misses its 4.49 ms target: BQ 64 gives each
// thread 4 rows, so S = q k^T reads shared memory every 8 FMAs (about 11
// at hd 128), with 8 warps an SM to hide it.
//
// C interface (ctypes): pointers and the stream are void*, sizes int64;
// returns cudaGetLastError(), cudaErrorInvalidValue for what it does not
// take (hd not 64, 128 or 256; a fully masked row without vmean; a
// pointer not on 16 bytes; a softcap outside [2^-20, 2^20]),
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
// float32: CUDA cores, register-blocked tiles, cp.async-fed key/value tiles
// ---------------------------------------------------------------------------

namespace cc {

// 16 x 16 threads (rg, cg); warp w holds rg 4 (w / 2) .. + 3 by cg 8 (w %
// 2) .. + 7, so a warp's reads of k and v touch 8 distinct 16-byte
// chunks (one wavefront) and a row's 16 score columns lie in two warps
constexpr int THREADS = 256;
constexpr int BKV = 64;           // keys per tile
constexpr int KT = BKV / 16;      // score columns per thread: keys cg + 16 j

template <int HD>
struct Tiles {
    static constexpr int BQ = HD == 256 ? 64 : 128;  // query rows per block
    static constexpr int RT = BQ / 16;    // rows per thread: RT rg .. + RT - 1
    static constexpr int CT4 = HD / 64;   // output float4s per row and thread:
                                          // columns 4 cg + 64 i .. + 3
    static constexpr int KS = HD + 4;     // row stride of the k tile (floats)
    static constexpr int PS = BQ + 4;     // row stride of the P^T tile
    // q^T [HD][BQ], k [BKV][KS], v [BKV][HD], P^T [BKV][PS], and each
    // row's max (then sum) over the keys of either warp [2][BQ]
    static constexpr size_t SMEM =
        sizeof(float) * ((size_t)HD * BQ + (size_t)BKV * KS +
                         (size_t)BKV * HD + (size_t)BKV * PS + 2 * BQ);
    static constexpr int MIN_BLOCKS = HD == 64 ? 2 : 1;
    // head columns of S = q k^T unrolled, in steps of 4 (hd 64 keeps 2 so
    // that two blocks' 128 registers a thread do not spill)
    static constexpr int D_UNROLL = HD == 64 ? 2 : 4;
};

// 16 bytes global -> shared, asynchronously; zeros where !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     tc::smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float comp(const float4& x, int e) {
    return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// what a thread needs to turn a tile's scores into probabilities
struct Mask {
    int Skv, causal, window;
    float softcap, rcap, scale;
    int r0, c0;    // the thread's first query row and first key column
};

// scale, softcap and mask the thread's RT x KT scores of the tile at key
// t0 in place, and give each row's max over the warp's 8 threads of it
// (half: the row maxima of this warp's 8 score columns, written by the
// row's first thread).  CAP and EDGE are compile-time, so an interior tile
// runs without a per-score branch.
template <int RT, bool CAP, bool EDGE>
__device__ __forceinline__ void score_tile(float (&s)[RT][KT], const Mask& mk,
                                           int t0, float* half, bool writer) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        const int qp = mk.r0 + r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
            float x = s[r][j] * mk.scale;
            if (CAP)
                x = mk.softcap *
                    tanhf(tc::div_cap(x, mk.softcap, mk.rcap));
            if (EDGE) {
                const int kp = t0 + mk.c0 + 16 * j;
                const bool ok = kp < mk.Skv && (!mk.causal || kp <= qp) &&
                                (mk.window <= 0 || qp - kp < mk.window);
                x = ok ? x : -INFINITY;
            }
            s[r][j] = x;
            mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (writer) half[r] = mx;
    }
}

// the tile's scores -> probabilities against the running max (both warps'
// row maxima in rmax[0], rmax[BQ]); updates m and the thread's partial
// sums l, and rescales the output rows
template <int RT, int NACC, int BQ>
__device__ __forceinline__ void softmax_tile(float (&s)[RT][KT],
                                             float (&m)[RT], float (&l)[RT],
                                             float (&acc)[RT][NACC],
                                             const float* rmax) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        const float mx = fmaxf(rmax[r], rmax[BQ + r]);
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float corr = expf(m[r] - m_use);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
            const float p = expf(s[r][j] - m_use);
            ps += p;
            s[r][j] = p;
        }
        l[r] = l[r] * corr + ps;
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < NACC; ++c) acc[r][c] *= corr;
    }
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(THREADS, Tiles<HD>::MIN_BLOCKS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              const float* __restrict__ vmean, int S, int Skv, int H, int G,
              int B, int causal, int window, float softcap, float rcap,
              float scale) {
    using TL = Tiles<HD>;
    constexpr int BQ = TL::BQ, RT = TL::RT, CT4 = TL::CT4, KS = TL::KS,
                  PS = TL::PS, NACC = 4 * CT4;
    extern __shared__ float4 smem4[];
    float* sqT = reinterpret_cast<float*>(smem4);   // [HD][BQ]
    float* sk = sqT + HD * BQ;                      // [BKV][KS]
    float* sv = sk + BKV * KS;                      // [BKV][HD]
    float* spT = sv + BKV * HD;                     // [BKV][PS]
    float* srow = spT + BKV * PS;                    // [2][BQ]

    // heaviest q tile first: the block index runs the q tiles in reverse
    const int nq = (S + BQ - 1) / BQ;
    const int64_t hb = (int64_t)H * B;
    const int qt = nq - 1 - (int)(blockIdx.x / hb);
    const int rem = (int)(blockIdx.x % hb);
    const int h = rem % H, b = rem / H, kh = h / G, K = H / G;
    const int q0 = qt * BQ;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int rg = 4 * (w >> 1) + (lane >> 3), half = w & 1;
    const int cg = 8 * half + (lane & 7);
    const bool writer = (lane & 7) == 0;   // a row's first thread in a warp
    const int64_t q_step = (int64_t)H * HD, kv_step = (int64_t)K * HD;
    const float* qb = q + ((int64_t)b * S * H + h) * HD;
    const float* kb = k + ((int64_t)b * Skv * K + kh) * HD;
    const float* vb = v + ((int64_t)b * Skv * K + kh) * HD;

    // keys that some row of this q tile may see: [k_lo, k_hi]
    const int q_last = min(q0 + BQ, S) - 1;
    int k_hi = Skv - 1;
    if (causal && q_last < k_hi) k_hi = q_last;
    int k_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
    const int t_first = (k_lo / BKV) * BKV;
    const int n_tiles = k_lo > k_hi ? 0 : (k_hi - t_first) / BKV + 1;

    // one k or v tile (rows t0 .. t0 + BKV - 1, zeros past Skv) into dst
    auto load_tile = [&](float* dst, int stride, const float* src, int t0) {
        constexpr int C4 = HD / 4;
#pragma unroll 4
        for (int i = tid; i < BKV * C4; i += THREADS) {
            const int r = i / C4, c = (i - r * C4) * 4;
            const int kp = t0 + r;
            const bool in = kp < Skv;
            cp_async16(dst + r * stride + c,
                       in ? src + (int64_t)kp * kv_step + c : src, in);
        }
    };
    if (n_tiles > 0) {
        load_tile(sk, KS, kb, t_first);
        cp_async_commit();
        load_tile(sv, HD, vb, t_first);
        cp_async_commit();
    }
    // the q tile, transposed (neighbouring threads on neighbouring rows:
    // conflict-free stores), while k and v arrive
    for (int i = tid; i < BQ * (HD / 4); i += THREADS) {
        const int r = i % BQ, d = (i / BQ) * 4;
        const int qp = q0 + r;
        const float4 x = qp < S ? *reinterpret_cast<const float4*>(
                                      qb + (int64_t)qp * q_step + d)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        sqT[(d + 0) * BQ + r] = x.x;
        sqT[(d + 1) * BQ + r] = x.y;
        sqT[(d + 2) * BQ + r] = x.z;
        sqT[(d + 3) * BQ + r] = x.w;
    }

    float m[RT], l[RT], acc[RT][NACC];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
#pragma unroll
        for (int c = 0; c < NACC; ++c) acc[r][c] = 0.f;
    }
    const Mask mk{Skv, causal, window, softcap, rcap, scale, q0 + rg * RT, cg};

    for (int it = 0; it < n_tiles; ++it) {
        const int t0 = t_first + it * BKV;
        if (it == 0)
            cp_async_wait1();   // k of the first tile (its v may be in flight)
        else
            cp_async_wait0();   // k of this tile
        __syncthreads();        // k in; P v of the last tile done everywhere
        if (it > 0) {
            load_tile(sv, HD, vb, t0);
            cp_async_commit();
        }

        // S = q k^T: rows RT rg + r, keys cg + 16 j
        float s[RT][KT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int j = 0; j < KT; ++j) s[r][j] = 0.f;
#pragma unroll (TL::D_UNROLL)
        for (int d = 0; d < HD; d += 4) {
            float4 kv[KT];
#pragma unroll
            for (int j = 0; j < KT; ++j)
                kv[j] = *reinterpret_cast<const float4*>(
                    &sk[(cg + 16 * j) * KS + d]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float qv[RT];
#pragma unroll
                for (int r4 = 0; r4 < RT / 4; ++r4) {
                    const float4 x = *reinterpret_cast<const float4*>(
                        &sqT[(d + e) * BQ + rg * RT + 4 * r4]);
                    qv[4 * r4] = x.x;
                    qv[4 * r4 + 1] = x.y;
                    qv[4 * r4 + 2] = x.z;
                    qv[4 * r4 + 3] = x.w;
                }
#pragma unroll
                for (int r = 0; r < RT; ++r)
#pragma unroll
                    for (int j = 0; j < KT; ++j)
                        s[r][j] = fmaf(qv[r], comp(kv[j], e), s[r][j]);
            }
        }
        // the per-score mask only where some row may lose a key of the tile
        const bool edge = t0 + BKV > Skv || (causal && t0 + BKV - 1 > q0) ||
                          (window > 0 && q0 + BQ - 1 - t0 >= window);
        float* rhalf = srow + half * BQ + rg * RT;
        if (edge)
            score_tile<RT, CAP, true>(s, mk, t0, rhalf, writer);
        else
            score_tile<RT, CAP, false>(s, mk, t0, rhalf, writer);
        __syncthreads();        // k tile done with; both warps' row maxima in
        if (it + 1 < n_tiles) load_tile(sk, KS, kb, t0 + BKV);
        cp_async_commit();
        softmax_tile<RT, NACC, BQ>(s, m, l, acc, srow + rg * RT);
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int r4 = 0; r4 < RT / 4; ++r4)
                *reinterpret_cast<float4*>(
                    &spT[(cg + 16 * j) * PS + rg * RT + 4 * r4]) =
                    make_float4(s[4 * r4][j], s[4 * r4 + 1][j],
                                s[4 * r4 + 2][j], s[4 * r4 + 3][j]);
        cp_async_wait1();       // v of this tile (the next k may be in flight)
        __syncthreads();

        // acc += P v: rows RT rg + r, columns 4 cg + 64 i + e
#pragma unroll 8
        for (int j = 0; j < BKV; ++j) {
            float p[RT];
#pragma unroll
            for (int r4 = 0; r4 < RT / 4; ++r4) {
                const float4 x = *reinterpret_cast<const float4*>(
                    &spT[j * PS + rg * RT + 4 * r4]);
                p[4 * r4] = x.x;
                p[4 * r4 + 1] = x.y;
                p[4 * r4 + 2] = x.z;
                p[4 * r4 + 3] = x.w;
            }
            float4 vv[CT4];
#pragma unroll
            for (int i = 0; i < CT4; ++i)
                vv[i] = *reinterpret_cast<const float4*>(
                    &sv[j * HD + 4 * cg + 64 * i]);
#pragma unroll
            for (int r = 0; r < RT; ++r)
#pragma unroll
                for (int i = 0; i < CT4; ++i) {
                    acc[r][4 * i] = fmaf(p[r], vv[i].x, acc[r][4 * i]);
                    acc[r][4 * i + 1] = fmaf(p[r], vv[i].y, acc[r][4 * i + 1]);
                    acc[r][4 * i + 2] = fmaf(p[r], vv[i].z, acc[r][4 * i + 2]);
                    acc[r][4 * i + 3] = fmaf(p[r], vv[i].w, acc[r][4 * i + 3]);
                }
        }
    }

    // a row's sum: over the 8 threads of each warp, then the two warps
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
        if (writer) srow[half * BQ + rg * RT + r] = l[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RT; ++r)
        l[r] = srow[rg * RT + r] + srow[BQ + rg * RT + r];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        const int qp = mk.r0 + r;
        if (qp >= S) continue;
        float* orow = o + ((int64_t)b * S + qp) * q_step + (int64_t)h * HD;
        if (no_key(qp, Skv, window)) {
            const float* mv = vmean + ((int64_t)b * K + kh) * HD;
#pragma unroll
            for (int i = 0; i < CT4; ++i)
                *reinterpret_cast<float4*>(orow + 4 * cg + 64 * i) =
                    *reinterpret_cast<const float4*>(mv + 4 * cg + 64 * i);
            continue;
        }
        const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int i = 0; i < CT4; ++i)
            *reinterpret_cast<float4*>(orow + 4 * cg + 64 * i) =
                make_float4(__fdiv_rn(acc[r][4 * i], den),
                            __fdiv_rn(acc[r][4 * i + 1], den),
                            __fdiv_rn(acc[r][4 * i + 2], den),
                            __fdiv_rn(acc[r][4 * i + 3], den));
    }
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
    const void* ptrs[] = {q, k, v, o, vmean};
    for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) % 16)   // cp.async, float4
            return (int)cudaErrorInvalidValue;
    auto kernel = softcap > 0.f ? flash_fwd_f32<HD, true>
                                : flash_fwd_f32<HD, false>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TL::SMEM);
    if (e != cudaSuccess) return (int)e;
    const int64_t blocks = (S + TL::BQ - 1) / TL::BQ * H * B;
    if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, THREADS, TL::SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), vmean, (int)S,
        (int)Skv, (int)H, (int)(H / K), (int)B, causal,
        (int)(window > 0 ? window : 0), softcap,
        softcap > 0.f ? (float)(1.0 / (double)softcap) : 0.f, scale);
    return (int)cudaGetLastError();
}

}  // namespace cc

// ---------------------------------------------------------------------------
// launchers and the C interface
// ---------------------------------------------------------------------------

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              void* o, const float* vmean, int64_t B, int64_t S, int64_t Skv,
              int64_t H, int64_t K, int causal, int64_t window, float softcap,
              float scale, cudaStream_t st) {
    if (dtype == 0)
        return cc::launch<HD>(q, k, v, o, vmean, B, S, Skv, H, K, causal,
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

// The kernels' softcap quotient (div_cap) against IEEE division over
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
