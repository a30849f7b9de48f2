// Jacobi-PCG over marginalized-graph-kernel product systems whose pair does
// not fit one block, each system solved on chip by a thread-block cluster of
// K CTAs (K in {2, 4, 8, 16}), for NVIDIA Hopper (sm_90a).
//
// Replaces graphdot_tpu/ops/pallas_pcg.py::_pcg_stream_kernel (reached
// through `pallas_pcg_stream` and `_stream_solver`) for the pairs beyond a
// block whose live rows of T, CG vectors and edge lists fit the shared
// memory of a cluster of at most 16 CTAs; larger pairs stay in
// csrc/pcg_stream.cu. It solves the system of csrc/pcg_stream.cu,
//
//     [diag o Y - S1^T (T o (D1 Y D2^T)) S2] = b      (Y is N1 x N2)
//
// by Jacobi-PCG from x = 0, with the same breakdown guards (pAp == 0,
// rz == 0), the same stop rule (sqrt(r.r) < tol, or maxiter steps) and a
// step count per system, over the gather-form matvec
//
//     out[i1,i2] = sum_{e1: src1(e1)=i1} sum_{e2: src2(e2)=i2}
//                  T[e1,e2] * y[dst1(e1), dst2(e2)].
//
// Contract: T [P, M1, M2] f32 (operators); esrc1/edst1 [P, M1],
// esrc2/edst2 [P, M2] int32; diag/precond [P, N1, N2] f32 (an operator's);
// b [S, N1, N2] f32, tol [S] f32 and op [S] int32 (systems: system s solves
// with operator op[s], so the k tangent systems of a pair read one copy of
// T); maxiter. Result x [S, N1, N2] f32, iters [S] int32.
//
// Design, one system a cluster of K CTAs (cudaLaunchKernelEx with a cluster
// dimension; clusters run in waves, so a chunk of any size fills the card):
//
// - Live edges. An edge is live when its row (side 1) or column (side 2)
//   of T holds a nonzero, the rule of csrc/pcg_stream.cu: a dead edge adds
//   exactly 0. CTA c scans T's rows [c R, (c + 1) R), R = ceil(M1 / K), once
//   from device memory, a warp a row; the CTAs then read each other's row
//   flags and OR their column flags through distributed shared memory
//   (DSMEM).
// - Sort. Every CTA sorts both sides' live edges by source with the stable
//   counting sort of csrc/edge_sort.cuh in O(M + M N / 32) work a side:
//   each warp ranks 32 edges among equal sources (__match_any_sync), a scan
//   over the chunks and the nodes gives each edge its place. The order
//   within a node is edge order, as in the plain twin.
// - T on chip. CTA c holds the live sorted rows [c Rl, (c + 1) Rl), Rl =
//   ceil(L1 / K), of T: one coalesced read of each row by a warp, scattered
//   by 4-byte cp.async into the column order sorted by side-2 source.
//   Nothing of T is read from device memory after that.
// - The matvec in two passes. Pass 1, over the CTA's own rows q1:
//       W[q1, i2] = sum_{q2 in side 2's row i2} T[q1, q2] p[dst1(q1), dst2(q2)]
//   with a full copy of p in each CTA's shared memory. The lanes of a warp
//   take consecutive rows q1 of one column i2: one trip count, dst2(q2)
//   loaded once for the warp, and T's rows, p's rows and W (stored
//   transposed) at odd strides, so that the lanes' loads of T and p and
//   stores of W meet distinct banks. Pass 2, for the
//   CTA's own product nodes (a contiguous 1/K of them):
//       U[i1, i2] = sum_{q1 in side 1's row i1} W[q1, i2],
//   reading W from whichever CTA holds row q1, in q1's order. (Summing
//   each CTA's rows of a source first, so that pass 2 loads one part a
//   CTA, made the 56-63-atom molecules slower on an H100: a step does not
//   wait for these DSMEM loads.)
// - CG state. x, r, diag and precond of a CTA's product nodes live in
//   registers (NPT nodes a thread, one template instance each). After its
//   r update a CTA writes its nodes' z = precond r into every CTA's copy of
//   z through DSMEM; after the barrier each CTA forms its whole copy
//   p = z + beta p itself, with the same beta, so the K copies of p stay
//   bit-identical.
// - Two cluster barriers a step. pAp is summed in pass 1 as
//   sum diag p^2 - sum_{q1, i2} p[src1(q1), i2] W[q1, i2] (the same sum as
//   p . Ap, grouped by rows), so it is published with W at the first
//   barrier; rz and r.r with z at the second. A CTA puts its block sums in
//   its own shared memory; after the barrier every CTA reads all K of them
//   and adds them in rank order, so all take bit-identical alpha, beta and
//   stop decisions with no float atomics: the result is deterministic for
//   a given K. Each slot, W and z is written again only after a barrier
//   that every reader of the old value has passed. A last cluster.sync()
//   keeps every CTA's shared memory alive while a peer may read it.
//
// Precision: f32 with FMA, as csrc/pcg_stream.cu (the TPU kernel's split2
// is two bf16 passes).
//
// What bounds it: device memory is read once a solve (T once for the flags
// and once more, mostly from L2, for the live rows, with the edge lists,
// diag, precond and b) and x is written once: 4 M1 M2 bytes a system
// against the 4 L1 L2 bytes a CG step that csrc/pcg_stream.cu streams. A CG
// step is shared-memory work: each live T entry and the p it multiplies
// are loaded once (8 bytes a lane a multiply-add; the side-2 destination
// is one broadcast a warp) against 128 bytes a clock of each SM's shared
// memory, then pass 2's
// L1 N2 DSMEM loads of W, the K-fold DSMEM stores of z and two cluster
// barriers. Shared memory holds a CTA's ceil(M1 / K) x M2 floats of T,
// W, two copies of the N1 N2 vector (p and z) and the edge lists; a pair
// whose plan exceeds a block's shared memory at K = 16, or whose product
// nodes exceed 16 x 512 x 8, is not this kernel's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "edge_sort.cuh"
#include "pcg_block.cuh"

namespace cg = cooperative_groups;

namespace {

using graphdot_pcg::warp_sum;

//: threads a CTA
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
//: the cluster sizes (CTAs a system)
constexpr int kSizes[] = {2, 4, 8, 16};
constexpr int kMaxCluster = 16;
//: the product nodes a thread may own, one template instance each
constexpr int kLadder[] = {1, 2, 4, 8};

struct Problem {
    const float *T;
    const int *esrc1, *edst1, *esrc2, *edst2;
    const float *diag, *precond, *b, *tol;
    const int *op;
    float *x;
    int *iters;
    int M1, M2, N1, N2, maxiter;
};

// Shared-memory layout of a CTA of a cluster of K, in 4-byte words, each
// region on a 16-byte boundary. `hist`, the sort's counts, lives in the
// region of T, which is loaded after the sort.
struct Layout {
    long long rows;   // T rows a CTA holds at most: ceil(M1 / K)
    // odd strides, so that the lanes of a warp, on consecutive rows of T
    // (or nodes of side 1), meet distinct banks: T's rows, W's columns
    // (W is stored [N2][rows]), p's and z's rows
    long long ldT, ldW, ldp;
    long long T, W, p, z, rowptr1, src1s, dst1s, perm1, live1, rowptr2,
        dst2s, pos2, live2, live2p, slots, warps, gather, words;
};

__host__ __device__ inline long long take(long long &at, long long words) {
    const long long start = at;
    at += (words + 3) / 4 * 4;
    return start;
}

__host__ __device__ inline Layout make_layout(int K, int M1, int M2, int N1,
                                              int N2) {
    Layout L;
    long long o = 0;
    L.rows = (M1 + K - 1) / K;
    L.ldT = M2 | 1;
    L.ldW = L.rows | 1;
    L.ldp = N2 | 1;
    const long long hist1 = static_cast<long long>((M1 + 31) / 32) * N1;
    const long long hist2 = static_cast<long long>((M2 + 31) / 32) * N2;
    const long long hist = hist1 > hist2 ? hist1 : hist2;
    const long long tile = L.rows * L.ldT;
    L.T = take(o, tile > hist ? tile : hist);
    L.W = take(o, N2 * L.ldW);
    L.p = take(o, N1 * L.ldp);
    L.z = take(o, N1 * L.ldp);
    L.rowptr1 = take(o, N1 + 1);
    L.src1s = take(o, M1);
    L.dst1s = take(o, M1);
    L.perm1 = take(o, M1);
    L.live1 = take(o, M1);
    L.rowptr2 = take(o, N2 + 1);
    L.dst2s = take(o, M2);
    L.pos2 = take(o, M2);
    L.live2 = take(o, M2);
    L.live2p = take(o, M2);
    L.slots = take(o, 4);                    // pAp | rz | r.r, read by peers
    L.warps = take(o, 2 * kWarps);           // a block sum's warp sums
    L.gather = take(o, 2 * kMaxCluster);     // the peers' slots, in order
    L.words = o;
    return L;
}

inline size_t smem_bytes(int K, int M1, int M2, int N1, int N2) {
    return static_cast<size_t>(make_layout(K, M1, M2, N1, N2).words) *
           sizeof(float);
}

// The product nodes a thread owns for a cluster of K on N1 x N2 nodes: the
// smallest ladder entry that holds the CTA's ceil(N / K); 0 where none does.
inline int nodes_per_thread(int K, int N1, int N2) {
    const long long N = static_cast<long long>(N1) * N2;
    const long long own = (N + K - 1) / K;
    const long long need = (own + kThreads - 1) / kThreads;
    for (int npt : kLadder)
        if (npt >= need) return npt;
    return 0;
}

inline bool is_size(int K) {
    for (int k : kSizes)
        if (k == K) return true;
    return false;
}

// a and b summed over the block into every thread, with one barrier: the
// warp sums go to `warps`. Between two calls the caller passes a cluster
// barrier, so no thread rewrites a warp sum that a slower one still reads.
__device__ __forceinline__ void block_sum(float &a, float &b, float *warps) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
        warps[warp] = a;
        warps[kWarps + warp] = b;
    }
    __syncthreads();
    a = 0.f;
    b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        a += warps[w];
        b += warps[kWarps + w];
    }
}

// Slots k .. k + NV - 1 of every CTA of the cluster, summed in rank order
// into every thread: thread r < K reads rank r's slots through DSMEM, then
// every thread adds them in order. Called after a cluster barrier that
// follows the slots' writes, and before the next one.
template <int NV>
__device__ __forceinline__ void cluster_sum(cg::cluster_group &cluster,
                                            float *slots, float *gather,
                                            int K, int k, float (&v)[NV]) {
    if (threadIdx.x < K) {
        const float *peer = cluster.map_shared_rank(slots, threadIdx.x);
#pragma unroll
        for (int j = 0; j < NV; ++j)
            gather[j * kMaxCluster + threadIdx.x] = peer[k + j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        float t = 0.f;
        for (int r = 0; r < K; ++r) t += gather[j * kMaxCluster + r];
        v[j] = t;
    }
}

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

// One system a cluster: cluster blockIdx.x / K solves system
// blockIdx.x / K, its CTA of rank c doing part c of the work.
template <int NPT>
__global__ void __launch_bounds__(kThreads, 1)
pcg_cluster_kernel(Problem P) {
    cg::cluster_group cluster = cg::this_cluster();
    const int K = static_cast<int>(cluster.num_blocks());
    const int c = static_cast<int>(cluster.block_rank());
    const size_t sys = blockIdx.x / K;
    const int tid = threadIdx.x;
    const int M1 = P.M1, M2 = P.M2, N1 = P.N1, N2 = P.N2;
    const int N = N1 * N2;
    const Layout L = make_layout(K, M1, M2, N1, N2);
    const int ldT = static_cast<int>(L.ldT), ldW = static_cast<int>(L.ldW),
              ldp = static_cast<int>(L.ldp);
    extern __shared__ __align__(16) float smem[];
    float *Ts = smem + L.T;
    float *W = smem + L.W;
    float *p = smem + L.p;
    float *zc = smem + L.z;
    int *rowptr1 = reinterpret_cast<int *>(smem + L.rowptr1);
    int *src1s = reinterpret_cast<int *>(smem + L.src1s);
    int *dst1s = reinterpret_cast<int *>(smem + L.dst1s);
    int *perm1 = reinterpret_cast<int *>(smem + L.perm1);
    int *live1 = reinterpret_cast<int *>(smem + L.live1);
    int *rowptr2 = reinterpret_cast<int *>(smem + L.rowptr2);
    int *dst2s = reinterpret_cast<int *>(smem + L.dst2s);
    int *pos2 = reinterpret_cast<int *>(smem + L.pos2);
    int *live2 = reinterpret_cast<int *>(smem + L.live2);
    int *live2p = reinterpret_cast<int *>(smem + L.live2p);
    float *slots = smem + L.slots;
    float *warps = smem + L.warps;
    float *gather = smem + L.gather;

    const size_t o = static_cast<size_t>(P.op[sys]);
    const float *Tg = P.T + o * M1 * M2;
    const int *es1 = P.esrc1 + o * M1, *ed1 = P.edst1 + o * M1;
    const int *es2 = P.esrc2 + o * M2, *ed2 = P.edst2 + o * M2;
    const float *dg_g = P.diag + o * N, *pc_g = P.precond + o * N;
    const float *b_g = P.b + sys * N;

    // ---- live flags of this CTA's rows of T; columns OR'd over them ------
    const int chunk = static_cast<int>(L.rows);
    const int e_lo = c * chunk;
    const int e_hi = min(M1, e_lo + chunk);
    for (int i = tid; i < M2; i += kThreads) live2p[i] = 0;
    for (int i = e_lo + tid; i < e_hi; i += kThreads) live1[i] = 0;
    __syncthreads();
    // a warp a row, its lanes along the row; T read 16 bytes a load where
    // the rows are 16-byte aligned. Racing stores of the same 1
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const bool by4 = (M2 & 3) == 0 &&
                     (reinterpret_cast<size_t>(Tg) & 15) == 0;
    for (int e1 = e_lo + warp; e1 < e_hi; e1 += kWarps) {
        const float *row = Tg + static_cast<size_t>(e1) * M2;
        int any = 0;
        if (by4) {
            const float4 *row4 = reinterpret_cast<const float4 *>(row);
#pragma unroll 4
            for (int v = lane; v < M2 / 4; v += 32) {
                const float4 t = row4[v];
                const float ts[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    if (ts[u] != 0.f) {
                        live2p[4 * v + u] = 1;
                        any = 1;
                    }
                }
            }
        } else {
#pragma unroll 4
            for (int e2 = lane; e2 < M2; e2 += 32) {
                if (row[e2] != 0.f) {
                    live2p[e2] = 1;
                    any = 1;
                }
            }
        }
        if (__any_sync(0xffffffffu, any) && lane == 0) live1[e1] = 1;
    }
    cluster.sync();   // every CTA has started and written its flags
    for (int e = tid; e < M1; e += kThreads) {
        const int owner = e / chunk;
        if (owner != c) live1[e] = *cluster.map_shared_rank(live1 + e, owner);
    }
    for (int e = tid; e < M2; e += kThreads) {
        int v = 0;
        for (int r = 0; r < K; ++r)
            v |= *cluster.map_shared_rank(live2p + e, r);
        live2[e] = v;
    }
    __syncthreads();

    // ---- both sides' live edges sorted by source --------------------------
    int *hist = reinterpret_cast<int *>(Ts);
    graphdot_sort::sort_side<kThreads>(es1, ed1, live1, M1, N1, rowptr1,
                                       src1s, dst1s, perm1, nullptr, hist);
    graphdot_sort::sort_side<kThreads>(es2, ed2, live2, M2, N2, rowptr2,
                                       nullptr, dst2s, nullptr, pos2, hist);
    const int L1 = rowptr1[N1];
    const int Rl = (L1 + K - 1) / K;      // live rows a CTA holds
    const int q0 = c * Rl;
    const int R = max(0, min(L1, q0 + Rl) - q0);

    // ---- the CTA's live rows of T, columns in side 2's sorted order: a
    // warp a row, its lanes along the row ------------------------------
    for (int rl = warp; rl < R; rl += kWarps) {
        const float *src = Tg + static_cast<size_t>(perm1[q0 + rl]) * M2;
        float *dst = Ts + rl * ldT;
        for (int e2 = lane; e2 < M2; e2 += 32) {
            const int k = pos2[e2];
            if (k >= 0) cp_async4(dst + k, src + e2);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    // ---- p = precond b everywhere (0 on the rows' padding, and z 0); the
    // CTA's nodes' state in registers, with each node's place in p ------
    for (int t = tid; t < N1 * ldp; t += kThreads) {
        const int i1 = t / ldp;
        const int i2 = t - i1 * ldp;
        p[t] = i2 < N2 ? pc_g[i1 * N2 + i2] * b_g[i1 * N2 + i2] : 0.f;
        zc[t] = 0.f;
    }
    const int own = (N + K - 1) / K;
    const int lo = c * own;
    const int hi = min(N, lo + own);
    float x[NPT], r[NPT], dg[NPT], pc[NPT];
    int at[NPT];
    float rz = 0.f, rr = 0.f;
#pragma unroll
    for (int s = 0; s < NPT; ++s) {
        const int j = lo + tid + s * kThreads;
        x[s] = r[s] = dg[s] = pc[s] = 0.f;
        at[s] = 0;
        if (j < hi) {
            const int i1 = j / N2;
            at[s] = i1 * ldp + (j - i1 * N2);
            const float bi = b_g[j];
            pc[s] = pc_g[j];
            dg[s] = dg_g[j];
            r[s] = bi;
            const float zi = pc[s] * bi;
            rz += bi * zi;
            rr += bi * bi;
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    block_sum(rz, rr, warps);   // its barrier also publishes T and p
    if (tid == 0) {
        slots[1] = rz;
        slots[2] = rr;
    }
    cluster.sync();
    {
        float v[2];
        cluster_sum<2>(cluster, slots, gather, K, 1, v);
        rz = v[0];
        rr = v[1];
    }
    const float tolv = P.tol[sys];
    int n_iter = sqrtf(rr) < tolv ? 0 : P.maxiter;
    int it = 0;

    // ---- the PCG; every CTA takes the same decisions ----------------------
    while (n_iter != 0 && it < P.maxiter) {
        // pass 1 over the CTA's rows, and its part of pAp
        float pAp = 0.f, unused = 0.f;
#pragma unroll
        for (int s = 0; s < NPT; ++s) {
            const int j = lo + tid + s * kThreads;
            if (j < hi) pAp += p[at[s]] * (dg[s] * p[at[s]]);
        }
        // the lanes of a warp on consecutive rows, one column i2: one
        // trip count, side 2's destination read once for the warp
        for (int idx = tid; idx < R * N2; idx += kThreads) {
            const int i2 = idx / R;
            const int rl = idx - i2 * R;
            const int k0 = rowptr2[i2], k1 = rowptr2[i2 + 1];
            const float *trow = Ts + rl * ldT;
            const float *prow = p + dst1s[q0 + rl] * ldp;
            float acc = 0.f;
            for (int k = k0; k < k1; ++k)
                acc = fmaf(trow[k], prow[dst2s[k]], acc);
            W[i2 * ldW + rl] = acc;
            pAp -= p[src1s[q0 + rl] * ldp + i2] * acc;
        }
        block_sum(pAp, unused, warps);
        if (tid == 0) slots[0] = pAp;
        cluster.sync();   // W and the pAp parts of every CTA
        {
            float v[1];
            cluster_sum<1>(cluster, slots, gather, K, 0, v);
            pAp = v[0];
        }
        ++it;
        if (pAp == 0.f || rz == 0.f) {   // breakdown: x stays as it is
            n_iter = it;
            break;
        }
        const float alpha = rz / pAp;
        // pass 2 for the CTA's nodes, then x, r and z; z to every CTA
        float rz_new = 0.f;
        rr = 0.f;
#pragma unroll
        for (int s = 0; s < NPT; ++s) {
            const int j = lo + tid + s * kThreads;
            if (j < hi) {
                const int i1 = j / N2;
                const int i2 = j - i1 * N2;
                float u = 0.f;
                const int q_lo = rowptr1[i1], q_hi = rowptr1[i1 + 1];
                if (q_hi > q_lo) {
                    int rank = q_lo / Rl;
                    int local = q_lo - rank * Rl;
                    const float *w =
                        cluster.map_shared_rank(W, rank) + i2 * ldW;
#pragma unroll 4
                    for (int q = q_lo; q < q_hi; ++q, ++local) {
                        if (local == Rl) {   // the next CTA's rows
                            w = cluster.map_shared_rank(W, ++rank) +
                                i2 * ldW;
                            local = 0;
                        }
                        u += w[local];
                    }
                }
                const float pj = p[at[s]];
                const float ap = dg[s] * pj - u;
                x[s] += alpha * pj;
                const float ri = r[s] - alpha * ap;
                r[s] = ri;
                const float zi = pc[s] * ri;
                rz_new += ri * zi;
                rr += ri * ri;
                for (int d = 0; d < K; ++d)
                    cluster.map_shared_rank(zc, d)[at[s]] = zi;
            }
        }
        block_sum(rz_new, rr, warps);
        if (tid == 0) {
            slots[1] = rz_new;
            slots[2] = rr;
        }
        cluster.sync();   // z and the rz, r.r parts of every CTA
        {
            float v[2];
            cluster_sum<2>(cluster, slots, gather, K, 1, v);
            rz_new = v[0];
            rr = v[1];
        }
        if (sqrtf(rr) < tolv) {
            n_iter = it;
            break;
        }
        const float beta = rz_new / rz;
        for (int t = tid; t < N1 * ldp; t += kThreads)
            p[t] = zc[t] + beta * p[t];
        rz = rz_new;
        __syncthreads();   // the next pass 1 gathers p anywhere
    }

    float *xg = P.x + sys * N;
#pragma unroll
    for (int s = 0; s < NPT; ++s) {
        const int j = lo + tid + s * kThreads;
        if (j < hi) xg[j] = x[s];
    }
    if (c == 0 && tid == 0) P.iters[sys] = n_iter;
    cluster.sync();   // no CTA leaves while a peer may read its memory
}

using KernelFn = void (*)(Problem);

KernelFn instance(int npt) {
    switch (npt) {
        case 1: return pcg_cluster_kernel<1>;
        case 2: return pcg_cluster_kernel<2>;
        case 4: return pcg_cluster_kernel<4>;
        case 8: return pcg_cluster_kernel<8>;
        default: return nullptr;
    }
}

// The instance for a cluster of K on these shapes, its dynamic shared
// memory set and (K = 16) a non-portable cluster size allowed; nullptr
// with *err = cudaErrorInvalidValue when K is not a cluster size or no
// instance holds the CTA's product nodes.
KernelFn prepare(int K, int M1, int M2, int N1, int N2, size_t *smem,
                 cudaError_t *err) {
    KernelFn fn = is_size(K) ? instance(nodes_per_thread(K, N1, N2))
                             : nullptr;
    *smem = smem_bytes(K, M1, M2, N1, N2);
    if (fn == nullptr) {
        *err = cudaErrorInvalidValue;
        return nullptr;
    }
    *err = cudaFuncSetAttribute(fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
    if (*err == cudaSuccess && K > 8)
        *err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return *err == cudaSuccess ? fn : nullptr;
}

// A launch of `clusters` clusters of K CTAs; `attr` holds the cluster
// dimension.
cudaLaunchConfig_t launch_config(int K, int clusters, size_t smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute *attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(clusters) * K);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = K;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

}  // namespace

extern "C" {

// Dynamic shared memory a CTA of a cluster of K needs for systems of these
// shapes, in bytes.
size_t graphdot_pcg_cluster_smem_bytes(int K, int M1, int M2, int N1,
                                       int N2) {
    return smem_bytes(K, M1, M2, N1, N2);
}

// The product nodes a thread owns in a cluster of K on N1 x N2 nodes; 0
// when K is not a cluster size or no instance holds the CTA's nodes.
int graphdot_pcg_cluster_nodes_per_thread(int K, int N1, int N2) {
    return is_size(K) ? nodes_per_thread(K, N1, N2) : 0;
}

// The smallest cluster size whose CTAs hold systems of these shapes within
// `limit` bytes of shared memory a block; 0 when none does.
int graphdot_pcg_cluster_size(int M1, int M2, int N1, int N2, int limit) {
    for (int K : kSizes)
        if (nodes_per_thread(K, N1, N2) > 0 &&
            smem_bytes(K, M1, M2, N1, N2) <= static_cast<size_t>(limit))
            return K;
    return 0;
}

const char *graphdot_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// What a cluster of K gets on the current device for these shapes: out[0]
// the clusters it holds at once (cudaOccupancyMaxActiveClusters), out[1]
// registers a thread, out[2] local (spill) bytes a thread, out[3] dynamic
// shared bytes a CTA. Returns a cudaError_t (cudaErrorInvalidValue when K
// is not a cluster size or no instance holds the CTA's nodes).
int graphdot_pcg_cluster_occupancy(int K, int M1, int M2, int N1, int N2,
                                   int *out) {
    size_t smem = 0;
    cudaError_t err = cudaSuccess;
    KernelFn fn = prepare(K, M1, M2, N1, N2, &smem, &err);
    if (fn == nullptr) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute cluster_dim;
    const cudaLaunchConfig_t cfg =
        launch_config(K, 1, smem, nullptr, &cluster_dim);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(
        &clusters, reinterpret_cast<const void *>(fn), &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = clusters;
    out[1] = attr.numRegs;
    out[2] = static_cast<int>(attr.localSizeBytes);
    out[3] = static_cast<int>(smem);
    return 0;
}

// Solves S systems on `stream`, one cluster of K CTAs each. Returns the
// launch's cudaError_t (cudaErrorInvalidValue when K is not a cluster size
// or no instance holds the CTA's nodes); a refused launch is not retried.
int graphdot_pcg_cluster(const float *T, const int *esrc1, const int *edst1,
                         const int *esrc2, const int *edst2,
                         const float *diag, const float *precond,
                         const float *b, const float *tol, const int *op,
                         float *x, int *iters, int S, int K, int M1, int M2,
                         int N1, int N2, int maxiter, void *stream) {
    size_t smem = 0;
    cudaError_t err = cudaSuccess;
    KernelFn fn = prepare(K, M1, M2, N1, N2, &smem, &err);
    if (fn == nullptr) return static_cast<int>(err);
    Problem prob = {T,       esrc1, edst1, esrc2, edst2, diag, precond,
                    b,       tol,   op,    x,     iters, M1,   M2,
                    N1,      N2,    maxiter};
    cudaLaunchAttribute cluster_dim;
    const cudaLaunchConfig_t cfg = launch_config(
        K, S, smem, static_cast<cudaStream_t>(stream), &cluster_dim);
    err = cudaLaunchKernelEx(&cfg, fn, prob);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
