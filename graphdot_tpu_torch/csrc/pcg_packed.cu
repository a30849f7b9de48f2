// Packed Jacobi-PCG over groups of marginalized-graph-kernel product
// systems, one CTA per group of k members, for NVIDIA Hopper (sm_90a).
//
// Replaces graphdot_tpu/ops/pallas_pcg.py::_pcg_pack_kernel, i.e.
// `pallas_pcg_packed` as `pallas_pcg_solver` reaches it when it packs
// k >= 2 systems a group. Each member m of group s has the system of
// csrc/pcg_resident.cu,
//
//     [diag_m o Y - S1^T (T_m o (D1 Y D2^T)) S2] = b_m      (Y is N1 x N2)
//
// and the group runs ONE Jacobi-PCG on the block-diagonal union of its
// members, as the TPU kernel does on its packed scratch: the dot products
// rz, pAp and r.r are summed over all members before the step sizes, so
// alpha and beta are shared; the breakdown guards (pAp == 0, rz == 0) and
// the stop rule (sqrt(sum_m r_m.r_m) < tol[s], or maxiter steps) apply to
// the group. A member whose b is zero stays exactly zero (its z and p are
// zero from the start), and a group whose b is all zero stops after 0
// steps. The caller gives tol[s] as the min over the members' own
// tolerances and scales maxiter, as `pallas_pcg_solver` does.
//
// The TPU kernel writes its members into diagonal blocks of zeroed VMEM
// scratch to fill 128x128 MXU tiles, and zeroes that scratch only in grid
// program 0, relying on a sequential grid. Here CTAs run concurrently and
// each owns its shared memory: there is no packed matrix and no
// off-diagonal block at all. The matvec runs per member, because the union
// is block-diagonal and the members never couple; only the reductions run
// over the union. The matvec is the gather form of pcg_resident.cu over
// each member's edge lists, sorted by source into a CSR layout in shared
// memory by a stable counting sort, so neither pass needs atomics.
//
// Contract (compact inputs, as `pallas_pcg_packed` takes them):
//   T [S, ka, M1, M2] f32; esrc1/edst1 [S, ka, M1], esrc2/edst2 [S, ka, M2]
//   int32; diag/precond [S, ka, N1, N2] f32; b [S, k, N1, N2] f32; tol [S]
//   f32; maxiter. Result x [S, k, N1, N2] f32 and iters [S] int32.
// ka is k (every member has its own operator: groups of different pairs,
// the TPU's layout) or 1 (the members share one operator, a member stride
// of 0: the n_theta tangent systems of one pair, which differ only in b).
// With ka = 1, T, the CSR arrays, diag and precond are loaded once per CTA,
// so a group of k tangents costs k CG vectors and k W scratches beside one
// pair's operator.
//
// Precision: the TPU kernel's modes (split2, default, highest, refine)
// choose bf16 MXU passes; this kernel computes in f32 with FMA, as the
// other two kernels, and takes no mode argument. Block-wide dot products
// are deterministic: each thread sums its elements over all members in a
// fixed order, then warp butterflies, then the warp sums in a fixed order,
// with no float atomics.
//
// What bounds it: as pcg_resident.cu, everything stays in shared memory
// for the whole solve, so device memory is read once per group and x
// written once; a CG step is k * (M1*M2 + M1*N2) FMAs out of shared memory
// plus four block barriers, bound by shared-memory loads and barrier
// latency. Packing k members into a CTA amortizes the barriers and the
// operator's load over k systems, and costs the extra CG steps that the
// shared step sizes take beyond each member's own (few when the members
// share a spectrum, as tangents do), and the shared memory that limits how
// many CTAs an SM holds.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// One operator's edge arrays, in 4-byte words from the operator's base.
struct EdgeLayout {
    size_t src1, dst1, rowptr1, perm1;
    size_t src2, rowptr2, dst2p, perm2;
    size_t words;
};

__host__ __device__ inline EdgeLayout make_edge_layout(int M1, int M2,
                                                       int N1, int N2) {
    EdgeLayout E;
    size_t o = 0;
    E.src1 = o;    o += M1;
    E.dst1 = o;    o += M1;
    E.rowptr1 = o; o += N1 + 1;
    E.perm1 = o;   o += M1;
    E.src2 = o;    o += M2;
    E.rowptr2 = o; o += N2 + 1;
    E.dst2p = o;   o += M2;
    E.perm2 = o;   o += M2;
    E.words = o;
    return E;
}

// Shared-memory layout of a group, in 4-byte words (floats and ints).
struct Layout {
    size_t T, W, x, r, p, Ap, dg, pc, red, edges;
    size_t words;
};

__host__ __device__ inline Layout make_layout(int k, int ka, int M1, int M2,
                                              int N1, int N2) {
    Layout L;
    const size_t N = static_cast<size_t>(N1) * N2;
    size_t o = 0;
    L.T = o;     o += static_cast<size_t>(ka) * M1 * M2;
    L.W = o;     o += static_cast<size_t>(k) * M1 * N2;
    L.x = o;     o += k * N;
    L.r = o;     o += k * N;
    L.p = o;     o += k * N;
    L.Ap = o;    o += k * N;
    L.dg = o;    o += ka * N;
    L.pc = o;    o += ka * N;
    L.red = o;   o += 2 * kWarps;
    L.edges = o; o += ka * make_edge_layout(M1, M2, N1, N2).words;
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
// src[f] == src[e]}; perm[pos] = e. O(M^2) compares per operator, once.
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
pcg_packed_kernel(const float *__restrict__ T,
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
                  int k, int ka, int M1, int M2, int N1, int N2,
                  int maxiter) {
    extern __shared__ float smem[];
    const Layout L = make_layout(k, ka, M1, M2, N1, N2);
    const EdgeLayout E = make_edge_layout(M1, M2, N1, N2);
    float *Ts = smem + L.T;
    float *W = smem + L.W;
    float *x = smem + L.x;
    float *r = smem + L.r;
    float *p = smem + L.p;
    float *Ap = smem + L.Ap;
    float *dg = smem + L.dg;
    float *pc = smem + L.pc;
    float *red = smem + L.red;
    int *edges = reinterpret_cast<int *>(smem + L.edges);

    const int tid = threadIdx.x;
    const size_t group = blockIdx.x;
    const int N = N1 * N2;
    const int kN = k * N;
    const int MW = M1 * N2;            // W words of one member
    const int MT = M1 * M2;            // T words of one operator
    // operator of member m: m when ka == k, 0 when the members share one
    const int op_step = ka == 1 ? 0 : 1;

    // ---- edge lists -> CSR by source, one operator after another ------
    for (int a = 0; a < ka; ++a) {
        int *e = edges + a * E.words;
        const size_t o1 = (group * ka + a) * M1;
        const size_t o2 = (group * ka + a) * M2;
        for (int i = tid; i < M1; i += kThreads) {
            e[E.src1 + i] = esrc1[o1 + i];
            e[E.dst1 + i] = edst1[o1 + i];
        }
        for (int i = tid; i < M2; i += kThreads) e[E.src2 + i] = esrc2[o2 + i];
    }
    __syncthreads();
    for (int a = 0; a < ka; ++a) {
        int *e = edges + a * E.words;
        build_csr(e + E.src1, M1, N1, e + E.rowptr1, e + E.perm1);
        build_csr(e + E.src2, M2, N2, e + E.rowptr2, e + E.perm2);
    }
    __syncthreads();

    // ---- operands; each T's columns in its side-2 CSR order -----------
    for (int a = 0; a < ka; ++a) {
        int *e = edges + a * E.words;
        const size_t o2 = (group * ka + a) * M2;
        for (int i = tid; i < M2; i += kThreads)
            e[E.dst2p + i] = edst2[o2 + e[E.perm2 + i]];
        const float *Tg = T + (group * ka + a) * MT;
        float *Ta = Ts + a * MT;
        const int *perm2 = e + E.perm2;
        for (int idx = tid; idx < MT; idx += kThreads) {
            const int e1 = idx / M2;
            const int j = idx - e1 * M2;
            Ta[idx] = Tg[e1 * M2 + perm2[j]];
        }
    }
    const size_t op_base = group * ka * N;
    for (int i = tid; i < ka * N; i += kThreads) {
        dg[i] = diag[op_base + i];
        pc[i] = precond[op_base + i];
    }
    const float *bg = b + group * kN;
    float rz = 0.f, rr = 0.f;
    for (int i = tid; i < kN; i += kThreads) {
        const int m = i / N;
        const float bi = bg[i];
        const float ci = precond[op_base + (m * op_step) * N + (i - m * N)];
        const float zi = ci * bi;
        x[i] = 0.f;
        r[i] = bi;
        p[i] = zi;
        rz += bi * zi;
        rr += bi * bi;
    }
    block_sum2(rz, rr, red);

    const float tolg = tol[group];
    bool done = sqrtf(rr) < tolg;
    int it = 0;
    int n_iter = done ? 0 : maxiter;

    // ---- one PCG on the union of the members --------------------------
    while (!done && it < maxiter) {
        // pass 1, per member m: W_m[e1, i2] =
        //     sum_{j in row i2} T[e1, j] p_m[dst1(e1), dst2(j)]
        for (int idx = tid; idx < k * MW; idx += kThreads) {
            const int m = idx / MW;
            const int rem = idx - m * MW;
            const int e1 = rem / N2;
            const int i2 = rem - e1 * N2;
            const int a = m * op_step;
            const int *e = edges + a * E.words;
            const int *rowptr2 = e + E.rowptr2;
            const int *dst2p = e + E.dst2p;
            const float *Trow = Ts + a * MT + e1 * M2;
            const float *prow = p + m * N + e[E.dst1 + e1] * N2;
            float acc = 0.f;
            for (int j = rowptr2[i2]; j < rowptr2[i2 + 1]; ++j)
                acc = fmaf(Trow[j], prow[dst2p[j]], acc);
            W[idx] = acc;
        }
        __syncthreads();
        // pass 2: Ap_m = diag o p_m - sum_{e1 in row i1} W_m[e1, i2]; the
        // pAp partial sums run over every member
        float pAp = 0.f, unused = 0.f;
        for (int i = tid; i < kN; i += kThreads) {
            const int m = i / N;
            const int j = i - m * N;
            const int i1 = j / N2;
            const int i2 = j - i1 * N2;
            const int a = m * op_step;
            const int *e = edges + a * E.words;
            const int *rowptr1 = e + E.rowptr1;
            const int *perm1 = e + E.perm1;
            const float *Wm = W + m * MW;
            float acc = 0.f;
            for (int q = rowptr1[i1]; q < rowptr1[i1 + 1]; ++q)
                acc += Wm[perm1[q] * N2 + i2];
            const float api = dg[a * N + j] * p[i] - acc;
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
        for (int i = tid; i < kN; i += kThreads) {
            const int m = i / N;
            const float ci = pc[(m * op_step) * N + (i - m * N)];
            x[i] += alpha * p[i];
            const float ri = r[i] - alpha * Ap[i];
            r[i] = ri;
            rz_new += ri * (ci * ri);
            rr += ri * ri;
        }
        block_sum2(rz_new, rr, red);
        if (sqrtf(rr) < tolg) {
            n_iter = it;
            break;
        }
        const float beta = rz_new / rz;
        for (int i = tid; i < kN; i += kThreads) {
            const int m = i / N;
            const float ci = pc[(m * op_step) * N + (i - m * N)];
            p[i] = ci * r[i] + beta * p[i];
        }
        rz = rz_new;
        __syncthreads();
    }

    float *xg = x_out + group * kN;
    for (int i = tid; i < kN; i += kThreads) xg[i] = x[i];
    if (tid == 0) iters_out[group] = n_iter;
}

}  // namespace

extern "C" {

// Dynamic shared memory one group needs, in bytes: k members with ka
// operators (ka = k, or 1 when the members share one).
size_t graphdot_pcg_packed_smem_bytes(int k, int ka, int M1, int M2, int N1,
                                      int N2) {
    return make_layout(k, ka, M1, M2, N1, N2).words * sizeof(float);
}

const char *graphdot_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one CTA per group on `stream`; returns the launch's
// cudaError_t. ka is k or 1 (see the contract above).
int graphdot_pcg_packed(const float *T, const int *esrc1, const int *edst1,
                        const int *esrc2, const int *edst2,
                        const float *diag, const float *precond,
                        const float *b, const float *tol, float *x,
                        int *iters, int S, int k, int ka, int M1, int M2,
                        int N1, int N2, int maxiter, void *stream) {
    if (k < 1 || (ka != 1 && ka != k)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = graphdot_pcg_packed_smem_bytes(k, ka, M1, M2, N1, N2);
    cudaError_t err = cudaFuncSetAttribute(
        pcg_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    pcg_packed_kernel<<<S, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol, x, iters, k,
        ka, M1, M2, N1, N2, maxiter);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
