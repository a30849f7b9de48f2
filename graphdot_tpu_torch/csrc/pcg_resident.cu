// Resident Jacobi-PCG over batches of marginalized-graph-kernel product
// systems, one CTA per graph pair, for NVIDIA Hopper (sm_90a).
//
// Replaces graphdot_tpu/ops/pallas_pcg.py::_pcg_kernel, i.e. `pallas_pcg`
// with the loop of `_cg_solve_values` at unroll=1. Per pair it solves
//
//     [diag o Y - S1^T (T o (D1 Y D2^T)) S2] = b      (Y is N1 x N2)
//
// by Jacobi-PCG from x = 0, with the same breakdown guards (pAp == 0,
// rz == 0) and the same stop rule (sqrt(r.r) < tol, or maxiter steps).
// The TPU kernel multiplies by one-hot incidence matrices to put the four
// gathers on the MXU; here the off-diagonal matvec is written in gather
// form over the edge lists:
//
//     out[i1,i2] = sum_{e1: src1(e1)=i1} sum_{e2: src2(e2)=i2}
//                  T[e1,e2] * y[dst1(e1), dst2(e2)]
//
// in two passes, W[e1,i2] = sum over side-2 edges leaving i2, then
// out[i1,i2] = sum of W over side-1 edges leaving i1. Each CTA sorts its
// pair's edges by source into a CSR layout in shared memory (stable, by
// counting), so both passes are plain loops with no atomics. Padded edges
// carry T = 0 and add nothing.
//
// Precision: the TPU kernel's modes (split2, default, highest, refine)
// choose bf16 MXU passes. This kernel computes in f32 with FMA, which is at
// least as accurate as split2, so it takes no mode argument. Block-wide
// dot products are deterministic: warp butterflies, then the warp sums in
// a fixed order, with no float atomics.
//
// What bounds it: all CG state (x, r, p, Ap, diag, precond), T, the W
// scratch and the CSR arrays stay in shared memory for the whole solve, so
// device memory is read once per pair and x written once. Each CG step is
// about M1*M2 + M1*N2 FMAs, each of which reads shared memory, plus four
// block barriers; at molecule shapes (N1 = N2 = 24, M ~ 64, ~36 KB per
// CTA, six CTAs per SM) the step is bound by shared-memory loads and
// barrier latency, not by device memory or FLOPs. Each pair stops at its
// own convergence, so no pair runs on with a slower one.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Shared-memory layout, in 4-byte words (floats and ints alike).
struct Layout {
    size_t T, W, x, r, p, Ap, dg, pc, red;
    size_t src1, dst1, rowptr1, perm1;
    size_t src2, rowptr2, dst2p;
    size_t perm2;
    size_t words;
};

__host__ __device__ inline Layout make_layout(int M1, int M2, int N1,
                                              int N2) {
    Layout L;
    const size_t N = static_cast<size_t>(N1) * N2;
    size_t o = 0;
    L.T = o;       o += static_cast<size_t>(M1) * M2;
    L.W = o;       o += static_cast<size_t>(M1) * N2;
    L.x = o;       o += N;
    L.r = o;       o += N;
    L.p = o;       o += N;
    L.Ap = o;      o += N;
    L.dg = o;      o += N;
    L.pc = o;      o += N;
    L.red = o;     o += 2 * kWarps;
    L.src1 = o;    o += M1;
    L.dst1 = o;    o += M1;
    L.rowptr1 = o; o += N1 + 1;
    L.perm1 = o;   o += M1;
    L.src2 = o;    o += M2;
    L.rowptr2 = o; o += N2 + 1;
    L.dst2p = o;   o += M2;
    L.perm2 = o;   o += M2;
    L.words = o;
    return L;
}

__device__ __forceinline__ float warp_sum(float v) {
    // butterfly: every lane ends with the same, order-fixed total
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Sums a and b over the block; every thread receives both totals.
// Contains two barriers, so it also orders the shared-memory writes made
// before it against the reads made after it.
__device__ __forceinline__ void block_sum2(float &a, float &b, float *red) {
    a = warp_sum(a);
    b = warp_sum(b);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
        red[warp] = a;
        red[kWarps + warp] = b;
    }
    __syncthreads();
    a = 0.f;
    b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        a += red[w];
        b += red[kWarps + w];
    }
    __syncthreads();
}

// Stable counting sort of one side's edges by source node:
// rowptr[i] = #{e : src[e] < i}; position of e = rowptr[src[e]] + #{f < e :
// src[f] == src[e]}; perm[pos] = e. O(M^2) compares per CTA, done once.
__device__ __forceinline__ void build_csr(const int *src, int M, int N,
                                          int *rowptr, int *perm) {
    for (int i = threadIdx.x; i <= N; i += kThreads) {
        int c = 0;
        for (int e = 0; e < M; ++e) c += src[e] < i;
        rowptr[i] = c;
    }
    for (int e = threadIdx.x; e < M; e += kThreads) {
        const int s = src[e];
        int pos = 0;
        for (int f = 0; f < M; ++f) {
            const int sf = src[f];
            pos += (sf < s) | ((sf == s) & (f < e));
        }
        perm[pos] = e;
    }
}

__global__ void __launch_bounds__(kThreads)
pcg_resident_kernel(const float *__restrict__ T,
                    const int *__restrict__ esrc1,
                    const int *__restrict__ edst1,
                    const int *__restrict__ esrc2,
                    const int *__restrict__ edst2,
                    const float *__restrict__ diag,
                    const float *__restrict__ precond,
                    const float *__restrict__ b,
                    const float *__restrict__ tol,
                    float *__restrict__ x_out,
                    int *__restrict__ iters_out,
                    int M1, int M2, int N1, int N2, int maxiter) {
    extern __shared__ float smem[];
    const Layout L = make_layout(M1, M2, N1, N2);
    float *Ts = smem + L.T;
    float *W = smem + L.W;
    float *x = smem + L.x;
    float *r = smem + L.r;
    float *p = smem + L.p;
    float *Ap = smem + L.Ap;
    float *dg = smem + L.dg;
    float *pc = smem + L.pc;
    float *red = smem + L.red;
    int *src1 = reinterpret_cast<int *>(smem + L.src1);
    int *dst1 = reinterpret_cast<int *>(smem + L.dst1);
    int *rowptr1 = reinterpret_cast<int *>(smem + L.rowptr1);
    int *perm1 = reinterpret_cast<int *>(smem + L.perm1);
    int *src2 = reinterpret_cast<int *>(smem + L.src2);
    int *rowptr2 = reinterpret_cast<int *>(smem + L.rowptr2);
    int *dst2p = reinterpret_cast<int *>(smem + L.dst2p);
    int *perm2 = reinterpret_cast<int *>(smem + L.perm2);

    const int tid = threadIdx.x;
    const size_t pair = blockIdx.x;
    const int N = N1 * N2;

    // ---- edge lists -> CSR by source --------------------------------
    for (int e = tid; e < M1; e += kThreads) {
        src1[e] = esrc1[pair * M1 + e];
        dst1[e] = edst1[pair * M1 + e];
    }
    for (int e = tid; e < M2; e += kThreads) src2[e] = esrc2[pair * M2 + e];
    __syncthreads();
    build_csr(src1, M1, N1, rowptr1, perm1);
    build_csr(src2, M2, N2, rowptr2, perm2);
    __syncthreads();
    for (int k = tid; k < M2; k += kThreads)
        dst2p[k] = edst2[pair * M2 + perm2[k]];

    // ---- operands; T's columns in side-2 CSR order --------------------
    const float *Tg = T + pair * M1 * M2;
    for (int idx = tid; idx < M1 * M2; idx += kThreads) {
        const int e1 = idx / M2;
        const int k = idx - e1 * M2;
        Ts[idx] = Tg[e1 * M2 + perm2[k]];
    }
    const float *bg = b + pair * N;
    float rz = 0.f, rr = 0.f;
    for (int i = tid; i < N; i += kThreads) {
        const float bi = bg[i];
        const float ci = precond[pair * N + i];
        const float zi = ci * bi;
        dg[i] = diag[pair * N + i];
        pc[i] = ci;
        x[i] = 0.f;
        r[i] = bi;
        p[i] = zi;
        rz += bi * zi;
        rr += bi * bi;
    }
    block_sum2(rz, rr, red);

    const float tolp = tol[pair];
    bool done = sqrtf(rr) < tolp;
    int it = 0;
    int n_iter = done ? 0 : maxiter;

    // ---- PCG ----------------------------------------------------------
    while (!done && it < maxiter) {
        // pass 1: W[e1, i2] = sum_{k in row i2} T[e1, k] p[dst1(e1), dst2(k)]
        for (int idx = tid; idx < M1 * N2; idx += kThreads) {
            const int e1 = idx / N2;
            const int i2 = idx - e1 * N2;
            const float *Trow = Ts + e1 * M2;
            const float *prow = p + dst1[e1] * N2;
            float acc = 0.f;
            for (int k = rowptr2[i2]; k < rowptr2[i2 + 1]; ++k)
                acc = fmaf(Trow[k], prow[dst2p[k]], acc);
            W[idx] = acc;
        }
        __syncthreads();
        // pass 2: Ap = diag o p - sum_{e1 in row i1} W[e1, i2]
        float pAp = 0.f, unused = 0.f;
        for (int i = tid; i < N; i += kThreads) {
            const int i1 = i / N2;
            const int i2 = i - i1 * N2;
            float acc = 0.f;
            for (int k = rowptr1[i1]; k < rowptr1[i1 + 1]; ++k)
                acc += W[perm1[k] * N2 + i2];
            const float api = dg[i] * p[i] - acc;
            Ap[i] = api;
            pAp += p[i] * api;
        }
        block_sum2(pAp, unused, red);
        ++it;
        if (pAp == 0.f || rz == 0.f) {   // breakdown: x stays as it is
            n_iter = it;
            break;
        }
        const float alpha = rz / pAp;
        float rz_new = 0.f;
        rr = 0.f;
        for (int i = tid; i < N; i += kThreads) {
            x[i] += alpha * p[i];
            const float ri = r[i] - alpha * Ap[i];
            r[i] = ri;
            rz_new += ri * (pc[i] * ri);
            rr += ri * ri;
        }
        block_sum2(rz_new, rr, red);
        if (sqrtf(rr) < tolp) {
            n_iter = it;
            break;
        }
        const float beta = rz_new / rz;
        for (int i = tid; i < N; i += kThreads)
            p[i] = pc[i] * r[i] + beta * p[i];
        rz = rz_new;
        __syncthreads();
    }

    for (int i = tid; i < N; i += kThreads) x_out[pair * N + i] = x[i];
    if (tid == 0) iters_out[pair] = n_iter;
}

}  // namespace

extern "C" {

// Dynamic shared memory one pair needs, in bytes.
size_t graphdot_pcg_resident_smem_bytes(int M1, int M2, int N1, int N2) {
    return make_layout(M1, M2, N1, N2).words * sizeof(float);
}

// The most dynamic shared memory one block may opt into on `device`.
int graphdot_pcg_resident_smem_limit(int device, int *bytes) {
    return static_cast<int>(cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

const char *graphdot_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one CTA per pair on `stream`; returns the launch's cudaError_t.
int graphdot_pcg_resident(const float *T, const int *esrc1, const int *edst1,
                          const int *esrc2, const int *edst2,
                          const float *diag, const float *precond,
                          const float *b, const float *tol, float *x,
                          int *iters, int P, int M1, int M2, int N1, int N2,
                          int maxiter, void *stream) {
    const size_t smem = graphdot_pcg_resident_smem_bytes(M1, M2, N1, N2);
    cudaError_t err = cudaFuncSetAttribute(
        pcg_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    pcg_resident_kernel<<<P, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol, x, iters, M1,
        M2, N1, N2, maxiter);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
