// RWKV-6 (Finch) WKV recurrence, CUDA C++ for sm_90a.
//
//     y_t[j]  = sum_i r_t[i] * (S_t[i, j] + u[i] * k_t[i] * v_t[j])
//     S_{t+1} = diag(w_t) S_t + k_t^T v_t
//
//     r, k, v, w (B, S, H, hs) f32; u (H, hs); s0 (B, H, hs, hs)
//     -> y (B, S, H, hs) f32 and the final state (B, H, hs, hs) f32
//
// Replaces the TPU Pallas kernel wkv6_fwd (_kernel) of the JAX package's
// kernels/rwkv6/kernel.py, which keeps the hs x hs state resident in a
// VMEM output block across time chunks on the sequential grid axis.
//
// Here: one block per (batch, head) with hs threads; the whole time loop
// runs inside the block.  Thread j keeps column S[:, j] of the state in
// registers for the whole sequence (hs floats), so the state never goes
// to memory until the end.  Each step stages r_t, k_t and w_t (and u,
// once) in shared memory, double-buffered so that one barrier per step
// suffices, and thread j computes y_t[j] and updates its column.  The
// next step's inputs are loaded into registers while the current step
// computes.  Loads of one step are hs contiguous floats per tensor.
//
// What bounds it on an H100: operations in principle (7 float operations
// per state element and step: 9.4 GFLOP at B2 S4096 H40 hs64, 0.14 ms at
// 67 TFLOP/s float32, against 0.126 ms for its 422 MB), but with one
// block per (batch, head) only B*H blocks of hs threads exist (80 at
// rwkv6-3b widths), and each step is a chain of hs dependent FMAs, so it
// is latency-bound.  Splitting the state's rows over more threads, or
// chunking time with a parallel intra-chunk form, is the later fix.
//
// C interface (ctypes): pointers and the stream are void*, sizes int64;
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int HS>
__global__ void __launch_bounds__(HS)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out,
            int64_t S, int64_t H) {
    __shared__ float sr[2][HS], sk[2][HS], sw[2][HS], su[HS];
    const int j = threadIdx.x;
    const int64_t bh = blockIdx.x;
    const int64_t b = bh / H, h = bh - b * H;

    float st[HS];                               // column j of the state
    const float* s0p = s0 + bh * HS * HS;
#pragma unroll
    for (int i = 0; i < HS; ++i) st[i] = s0p[i * HS + j];
    su[j] = u[h * HS + j];

    const int64_t step = H * HS;                // between two time steps
    int64_t off = (b * S * H + h) * HS + j;
    float rn = r[off], kn = k[off], wn = w[off], vn = v[off];
    for (int64_t t = 0; t < S; ++t) {
        const int p = (int)(t & 1);
        sr[p][j] = rn;
        sk[p][j] = kn;
        sw[p][j] = wn;
        const float vj = vn;
        const int64_t cur = off;
        off += step;
        if (t + 1 < S) {
            rn = r[off];
            kn = k[off];
            wn = w[off];
            vn = v[off];
        }
        __syncthreads();
        float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
        for (int i = 0; i < HS; i += 4) {
            float kv;
            kv = sk[p][i] * vj;
            y0 += sr[p][i] * (st[i] + su[i] * kv);
            st[i] = sw[p][i] * st[i] + kv;
            kv = sk[p][i + 1] * vj;
            y1 += sr[p][i + 1] * (st[i + 1] + su[i + 1] * kv);
            st[i + 1] = sw[p][i + 1] * st[i + 1] + kv;
            kv = sk[p][i + 2] * vj;
            y2 += sr[p][i + 2] * (st[i + 2] + su[i + 2] * kv);
            st[i + 2] = sw[p][i + 2] * st[i + 2] + kv;
            kv = sk[p][i + 3] * vj;
            y3 += sr[p][i + 3] * (st[i + 3] + su[i + 3] * kv);
            st[i + 3] = sw[p][i + 3] * st[i + 3] + kv;
        }
        y[cur] = (y0 + y1) + (y2 + y3);
    }
    float* sp = s_out + bh * HS * HS;
#pragma unroll
    for (int i = 0; i < HS; ++i) sp[i * HS + j] = st[i];
}

template <int HS>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out,
           int64_t B, int64_t S, int64_t H, cudaStream_t stream) {
    wkv6_kernel<HS><<<(unsigned)(B * H), HS, 0, stream>>>(
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
