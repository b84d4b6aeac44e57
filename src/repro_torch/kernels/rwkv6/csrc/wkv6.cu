// RWKV-6 (Finch) WKV recurrence, CUDA C++ for sm_90a.
//
//     y_t[j]  = sum_i r_t[i] * (S_t[i, j] + u[i] * k_t[i] * v_t[j])
//     S_{t+1} = diag(w_t) S_t + k_t^T v_t
//
//     r, k, v, w (B, S, H, hs) f32; u (H, hs); s0 (B, H, hs, hs)
//     -> y (B, S, H, hs) f32 and the final state (B, H, hs, hs) f32
//
// Replaces the TPU Pallas kernel wkv6_fwd (_kernel) of the JAX package's
// kernels/rwkv6/kernel.py (src/repro/kernels/rwkv6/kernel.py:57, _kernel
// :28-86), which keeps the hs x hs state resident in a VMEM output block
// across time chunks on the sequential grid axis.
//
// What bounds it on an H100: bytes.  5 float operations per state element
// and step (6.8 GFLOP at B2 S4096 H40 hs64, 0.10 ms at 67 TFLOP/s) against
// 422 MB of inputs and outputs (0.126 ms at 3.35 TB/s).  The recurrence is
// sequential in time, so what stands in the way of either bound is
// latency: the first port ran one block of hs threads per (batch, head),
// 80 blocks of 2 warps on 132 SMs, a 64-long chain per step and one
// barrier per step (2.603 ms, PERF.md).
//
// Here: the columns of the state are independent (y_t[j] and S[:, j] read
// column j, v_t[j] and the r, k, w, u vectors every column shares), so
// the work splits three ways.
//   * Columns across blocks: a block owns CJ = min(16, hs) columns of one
//     (batch, head); the grid is (B H) x (hs / CJ) blocks (320 at rwkv6-3b
//     widths, against 80 before).
//   * Rows across threads: each thread owns RPT = 8 rows (float4 groups
//     rr and rr + R, so the 16-byte shared-memory reads of one column's R
//     = hs / 8 threads are contiguous) of CPT = 2 columns, which share the
//     thread's r, k, w reads; a column's R threads sit in one warp.
//   * Time in chunks of T = 16 steps: r, k, w of a chunk (all hs rows) and
//     v of the block's columns land in shared memory by cp.async, NBUF = 4
//     chunks in flight, so a block crosses one barrier per chunk, not per
//     step.  A chunk's steps keep their partial y in registers, with no
//     store or branch between steps, and the next step's operands are read
//     before this step's arithmetic.  After the chunk, the R partial sums
//     of all 16 steps reduce together (log2 R xor-shuffles) and y leaves
//     through shared memory as 16-byte stores.
// The state stays in registers (16 floats a thread) for the whole
// sequence.  The per-step sum runs over each thread's rows, in two
// partial sums, then over the R threads: another order than the plain
// version's, hence a tolerance (2e-4) and not bit equality.
//
// What still holds it back (PERF.md): each thread's steps are serial and
// each SM holds only 2-3 blocks of 2 warps (320 blocks on 132 SMs).
//
// Time on an H100 80GB HBM3 at 700 W (chip_smoke.py's card table) at
// B2 S4096 H40 hs64: 0.727 ms, against 2.603 ms for one block per (batch,
// head) and a bound of 0.126 ms (PERF.md, section 6).
//
// C interface (ctypes): pointers and the stream are void*, sizes int64;
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int T = 16;          // time steps per staged chunk
constexpr int NBUF = 4;        // chunks in flight: NBUF - 1 ahead
constexpr int RPT = 8;         // state rows per thread
constexpr int GPT = RPT / 4;   // float4 row groups per thread
constexpr int CPT = 2;         // state columns per thread

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int HS>
struct Shape {
    static constexpr int CJ = HS < 16 ? HS : 16;   // columns per block
    static constexpr int R = HS / RPT;             // threads per column
    static constexpr int THREADS = CJ / CPT * R;
    // shared floats: NBUF chunks of r, k, w (T x HS) and v (T x CJ), and
    // two chunks of y (T x CJ)
    static constexpr size_t SMEM =
        sizeof(float) * (NBUF * T * (3 * HS + CJ) + 2 * T * CJ);
};

template <int HS>
__global__ void __launch_bounds__(Shape<HS>::THREADS)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out,
            int64_t S, int64_t H) {
    constexpr int CJ = Shape<HS>::CJ, R = Shape<HS>::R;
    constexpr int NT = Shape<HS>::THREADS;
    constexpr unsigned LANES = NT >= 32 ? 0xffffffffu : (1u << NT) - 1;
    extern __shared__ float4 smem4[];
    float* const sm = reinterpret_cast<float*>(smem4);
    // chunk buffer p: T rows of r, of k, of w (HS floats), of v (CJ floats)
    auto srow = [&](int p, int which, int tt) {
        return sm + ((p * 3 + which) * T + tt) * HS;
    };
    float* const svb = sm + NBUF * 3 * T * HS;
    auto sv = [&](int p, int tt) { return svb + (p * T + tt) * CJ; };
    float* const syb = svb + NBUF * T * CJ;     // y of chunk n in n & 1
    auto sy = [&](int64_t n, int tt) { return syb + ((n & 1) * T + tt) * CJ; };

    const int tid = threadIdx.x;
    const int cg = tid / R, rr = tid % R;     // column group, row slice
    const int64_t bh = blockIdx.x;
    const int64_t b = bh / H, h = bh - b * H;
    const int j0 = blockIdx.y * CJ, jc = CPT * cg;   // jc: within block
    const int64_t step = H * HS;              // floats between time steps
    const int64_t base = (b * S * H + h) * HS;
    const int64_t nchunks = (S + T - 1) / T;

    // rows of this thread: 4 (rr + R m) + e, m < GPT and e < 4; columns
    // j0 + jc + cc, cc < CPT
    float st[CPT][RPT], uu[RPT];
    const float* s0p = s0 + bh * HS * HS;
#pragma unroll
    for (int m = 0; m < GPT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = 4 * (rr + R * m) + e;
            uu[4 * m + e] = u[h * HS + i];
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc)
                st[cc][4 * m + e] = s0p[i * HS + j0 + jc + cc];
        }

    // stage chunk n into buffer n % NBUF, 16 bytes per copy: a thread's
    // copies sit at the same (step, offset) of every chunk.  Every call
    // commits one group (empty past the end), so cp_async_wait's count
    // stays exact.
    constexpr int ROW = HS / 4, VROW = CJ / 4;          // copies per row
    constexpr int RKW = (T * ROW + NT - 1) / NT;         // r/k/w slots
    auto load = [&](int64_t n) {
        if (n < nchunks) {
            const int p = (int)(n % NBUF);
            const int64_t t0 = n * T;
            const float* const rt = r + base + t0 * step;
            const float* const kt = k + base + t0 * step;
            const float* const wt = w + base + t0 * step;
#pragma unroll
            for (int x = 0; x < RKW; ++x) {
                const int i = tid + x * NT;
                const int tt = i / ROW, q = 4 * (i % ROW);
                if (i < T * ROW && t0 + tt < S) {
                    const int64_t off = tt * step + q;
                    cp_async16(srow(p, 0, tt) + q, rt + off);
                    cp_async16(srow(p, 1, tt) + q, kt + off);
                    cp_async16(srow(p, 2, tt) + q, wt + off);
                }
            }
            for (int i = tid; i < T * VROW; i += NT) {
                const int tt = i / VROW, q = 4 * (i % VROW);
                if (t0 + tt < S)
                    cp_async16(sv(p, tt) + q,
                               v + base + (t0 + tt) * step + j0 + q);
            }
        }
        cp_async_commit();
    };
    // y of chunk n, gathered in shared memory, out as 16-byte stores
    auto store_y = [&](int64_t n) {
        const int64_t t0 = n * T;
        for (int i = tid; i < T * VROW; i += NT) {
            const int tt = i / VROW, q = 4 * (i % VROW);
            if (t0 + tt < S)
                *reinterpret_cast<float4*>(y + base + (t0 + tt) * step + j0 +
                                           q) =
                    *reinterpret_cast<const float4*>(sy(n, tt) + q);
        }
    };

    // one step's operands for this thread: r, k, w of its rows, v of its
    // columns
    struct Step {
        float4 r4[GPT], k4[GPT], w4[GPT];
        float v[CPT];
    };
    auto fetch = [&](int p, int tt, Step& o) {
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) o.v[cc] = sv(p, tt)[jc + cc];
#pragma unroll
        for (int m = 0; m < GPT; ++m) {
            const int g = 4 * (rr + R * m);
            o.r4[m] = *reinterpret_cast<const float4*>(srow(p, 0, tt) + g);
            o.k4[m] = *reinterpret_cast<const float4*>(srow(p, 1, tt) + g);
            o.w4[m] = *reinterpret_cast<const float4*>(srow(p, 2, tt) + g);
        }
    };
    // the steps of chunk n, y of each in registers, the next step's
    // operands fetched before this step's arithmetic: no store and, for a
    // whole chunk (FULL), no branch between steps, so shared-memory latency
    // hides behind the arithmetic
    auto chunk = [&](auto full, int64_t n, int steps) {
        const int p = (int)(n % NBUF);
        constexpr bool FULL = decltype(full)::value;
        float acc[T][CPT];
        Step op[2];           // this step's and the next step's operands
        fetch(p, 0, op[0]);
#pragma unroll
        for (int tt = 0; tt < T; ++tt) {
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc) acc[tt][cc] = 0.f;
            if (!FULL && tt >= steps) continue;
            if (tt + 1 < T && (FULL || tt + 1 < steps))
                fetch(p, tt + 1, op[(tt + 1) & 1]);
            const Step& cur = op[tt & 1];
            // one partial sum per float4 group: GPT independent chains
            float part[CPT][GPT];
#pragma unroll
            for (int m = 0; m < GPT; ++m) {
                const float rs[4] = {cur.r4[m].x, cur.r4[m].y, cur.r4[m].z,
                                     cur.r4[m].w};
                const float ks[4] = {cur.k4[m].x, cur.k4[m].y, cur.k4[m].z,
                                     cur.k4[m].w};
                const float ws[4] = {cur.w4[m].x, cur.w4[m].y, cur.w4[m].z,
                                     cur.w4[m].w};
#pragma unroll
                for (int cc = 0; cc < CPT; ++cc) part[cc][m] = 0.f;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int x = 4 * m + e;
#pragma unroll
                    for (int cc = 0; cc < CPT; ++cc) {
                        const float kv = ks[e] * cur.v[cc];
                        part[cc][m] += rs[e] * (st[cc][x] + uu[x] * kv);
                        st[cc][x] = ws[e] * st[cc][x] + kv;
                    }
                }
            }
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc) {
#pragma unroll
                for (int m = 0; m < GPT; ++m) acc[tt][cc] += part[cc][m];
            }
        }
        // sum the R row slices of every step at once; thread rr of a
        // column keeps the steps tt = rr (mod R)
#pragma unroll
        for (int off = R / 2; off > 0; off >>= 1)
#pragma unroll
            for (int tt = 0; tt < T; ++tt)
#pragma unroll
                for (int cc = 0; cc < CPT; ++cc)
                    acc[tt][cc] += __shfl_xor_sync(LANES, acc[tt][cc], off);
#pragma unroll
        for (int tt = 0; tt < T; ++tt)
            if (tt % R == rr && (FULL || tt < steps))
#pragma unroll
                for (int cc = 0; cc < CPT; ++cc)
                    sy(n, tt)[jc + cc] = acc[tt][cc];
    };

    for (int n = 0; n < NBUF - 1; ++n) load(n);
    for (int64_t n = 0; n < nchunks; ++n) {
        cp_async_wait<NBUF - 2>();
        __syncthreads();      // chunk n landed; chunk n - 1 fully read
        load(n + NBUF - 1);   // into the buffer chunk n - 1 used
        if (n > 0) store_y(n - 1);
        if (S - n * T >= T)
            chunk(std::true_type(), n, T);
        else
            chunk(std::false_type(), n, (int)(S - n * T));
    }
    __syncthreads();
    store_y(nchunks - 1);

    float* sp = s_out + bh * HS * HS;
#pragma unroll
    for (int m = 0; m < GPT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc)
                sp[(4 * (rr + R * m) + e) * HS + j0 + jc + cc] = st[cc][4 * m + e];
}

template <int HS>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out,
           int64_t B, int64_t S, int64_t H, cudaStream_t stream) {
    using SH = Shape<HS>;
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<HS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SH::SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)(B * H), (unsigned)(HS / SH::CJ));
    wkv6_kernel<HS><<<grid, SH::THREADS, SH::SMEM, stream>>>(
        r, k, v, w, u, s0, y, s_out, S, H);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* s_out,
             int64_t B, int64_t S, int64_t H, int64_t hs, void* stream) {
    if (B <= 0 || H <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float *rf = static_cast<const float*>(r),
                *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v),
                *wf = static_cast<const float*>(w),
                *uf = static_cast<const float*>(u),
                *sf = static_cast<const float*>(s0);
    float* yf = static_cast<float*>(y);
    float* of = static_cast<float*>(s_out);
    switch (hs) {
        case 16: return launch<16>(rf, kf, vf, wf, uf, sf, yf, of, B, S, H, st);
        case 32: return launch<32>(rf, kf, vf, wf, uf, sf, yf, of, B, S, H, st);
        case 64: return launch<64>(rf, kf, vf, wf, uf, sf, yf, of, B, S, H, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
