// The device core of csrc/pcg_resident.cu and csrc/pcg_packed.cu: one CTA
// solves one group of K product-graph systems by ONE Jacobi-PCG on their
// block-diagonal union, for NVIDIA Hopper (sm_90a).
//
// Each member m of group g has the system
//
//     [diag_m o Y - S1^T (T_m o (D1 Y D2^T)) S2] = b_m      (Y is N1 x N2)
//
// with the off-diagonal matvec in gather form over the edge lists,
//
//     out[i1,i2] = sum_{e1: src1(e1)=i1} sum_{e2: src2(e2)=i2}
//                  T[e1,e2] * y[dst1(e1), dst2(e2)].
//
// The dot products rz, pAp and r.r are summed over all members, so the
// step sizes alpha and beta, the breakdown guards (pAp == 0 or rz == 0)
// and the stop rule (sqrt(sum_m r_m.r_m) < tol[g], or maxiter steps) are
// the group's. This is the recurrence of the JAX package's
// `_cg_solve_values`, unpipelined, from x = 0. pcg_resident.cu runs it
// with K = 1 (one pair a CTA); pcg_packed.cu with K from 2 to kMaxMembers.
// Each source names its own __global__ function over the core
// (pcg_resident_kernel, pcg_packed_kernel), so that a profile tells them
// apart.
//
// Contract (compact inputs, one group after another in memory):
//   T [S, ka, M1, M2] f32; esrc1/edst1 [S, ka, M1], esrc2/edst2 [S, ka, M2]
//   int32; diag/precond [S, ka, N1, N2] f32; b [S, K, N1, N2] f32; tol [S]
//   f32; maxiter. Result x [S, K, N1, N2] f32 and iters [S] int32. ka is 1
//   (the members share one operator: a pair's tangent systems, or
//   pcg_resident's one member) or K (each member its own operator).
//
// Design:
//
// - Live edges only. An edge is live when its row of T (side 1) or its
//   column of T (side 2) holds a nonzero, the rule of pcg_stream.cu's
//   stream_live_kernel. Only live edges enter the CSR layout by
//   source, so the batch's padding edges (T = 0, all with source 0) no
//   longer pile into node 0's rows. Exact: a dead edge adds 0 everywhere.
// - Live node extent. Side 1's extent n1 is 1 + the largest node index
//   that is an end of a live edge, or the row of a nonzero b of any member
//   (side 2 likewise, by columns); one extent serves the whole group. A
//   product node outside n1 x n2 has no live edge and b = 0, so r = p = 0
//   there from the start and Ap = diag * 0 = 0 at every step: it stays
//   exactly 0, adds nothing to any sum, and is never visited. The solve
//   runs over the n1 x n2 nodes of the extent, laid out compactly.
// - One fused matvec, no scratch. The thread that owns product node
//   (i1, i2) computes its whole off-diagonal sum in one pass over the
//   pairs of its two CSR rows, T[q1, q2] * p[dst1(q1), dst2(q2)]. No W,
//   no barrier between passes, and a node costs deg1 * deg2 multiply-adds.
//   The prologue lays every node's pairs out contiguously (q1-major, the
//   order of the sum), each as T and the 16-bit offset of the p it
//   multiplies, so the node's sum is one loop of three shared loads and
//   one multiply-add a member, with no index arithmetic.
// - Members in lockstep. With one shared operator (ka = 1) p is laid out
//   [node][K], so one T entry and one destination index serve all K
//   members, and one 16-byte shared load brings the K = 4 members' p.
//   With ka = K each member walks its own operator's rows.
// - CG state in registers. Thread t owns product nodes t + s * kThreads
//   (s < NPT) of the extent for the whole solve; their x, r, Ap, diag and
//   precond (and, with ka = 1, their CSR row ranges) live in registers.
//   Only p, which neighbours gather, the pair list and the index arrays
//   stay in shared memory. (With ka = K the members' diag and
//   precond differ and sit in shared memory beside p.)
// - Three block barriers a CG step: after the pAp partial sums, after
//   the rz and r.r partial sums (two sets of reduction slots, so each
//   block sum needs one barrier), and after p is written. Block sums are
//   deterministic: each thread sums its nodes in order, warps reduce by
//   butterfly, and every thread adds the warp sums in warp order, with no
//   float atomics, so all threads take bit-identical decisions.
// - Blocks of kThreads = 256 threads: on the H100 both kernels ran the
//   molecule chunks faster than at 128 threads, and a block holds twice
//   the product nodes.
//   Registers, not shared memory, bound how many CTAs an SM holds: the
//   state is (3 K + 2) floats a node times NPT nodes a thread. Instances
//   exist for NPT on the ladder kLadder, within kStateBudget; a shape
//   takes the smallest that holds its nodes. One member (K = 1) reaches
//   13 nodes a thread, 3328 product nodes: 56 x 56, the pairs that the
//   all-shared-memory kernel this core replaced held. Shapes beyond the
//   instances run in pcg_stream (values) or smaller groups (tangents).
//
// What bounds it: device memory is read about twice per group (T once,
// 16 bytes a load, for the live flags; its live part again, mostly from
// L2, into the pair list) and x is written once; a CG step is ~deg1 *
// deg2 multiply-adds a product node out of shared memory and three
// barriers, bound by instruction issue and latency, far from the card's
// byte and FLOP rates.
//
// Not here: tensor cores (a product node has ~6 multiply-adds a step, no
// MMA-shaped work); fusing the hyperparameter-dependent setup (T = w1 w2
// k_edge, Vx, diag) into the prologue; TMA for the T load.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace graphdot_pcg {

//: threads a block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
//: largest group a CTA solves (pcg_packed's cap on k)
constexpr int kMaxMembers = 4;
//: the product nodes a thread may own, one template instance each
constexpr int kLadder[] = {3, 6, 8, 13};
constexpr int kLadderSize = sizeof(kLadder) / sizeof(kLadder[0]);
//: floats of CG state a thread may hold, (3 K + 2) * NPT
constexpr int kStateBudget = 84;
//: product nodes a thread owns when each member has its own operator
//: (groups of pairs, the TPU's layout: tests and comparisons)
constexpr int kOwnOperatorsNodes = 3;

// Whether a template instance exists for groups of K members with NPT
// product nodes a thread, sharing one operator or each with its own.
__host__ __device__ constexpr bool has_instance(int K, int npt, bool shared) {
    return K >= 1 && K <= kMaxMembers &&
           (shared ? (3 * K + 2) * npt <= kStateBudget
                   : K > 1 && npt == kOwnOperatorsNodes);
}

// Registers an instance should need, rounded up to the allocation unit:
// ~32 of addressing and loop state, and for each of its product nodes the
// 3 K CG floats, diag, precond and the two packed CSR row ranges.
__host__ __device__ constexpr int estimated_registers(int K, int npt) {
    return (32 + (3 * K + 4) * npt + 7) / 8 * 8;
}

// CTAs an SM the instance asks ptxas to fit (__launch_bounds__' second
// argument), which caps its registers near the estimate.
__host__ __device__ constexpr int min_blocks(int K, int npt) {
    return 65536 / (kThreads * estimated_registers(K, npt)) < 1
               ? 1
               : 65536 / (kThreads * estimated_registers(K, npt));
}

// The product nodes a thread owns in the instance for groups of K members
// (sharing one operator or not) of N1 x N2 product nodes: the smallest
// ladder entry that holds them; 0 where no instance does.
inline int instance_nodes(int K, bool shared, int N1, int N2) {
    const long long need =
        (static_cast<long long>(N1) * N2 + kThreads - 1) / kThreads;
    for (int npt : kLadder)
        if (npt >= need && has_instance(K, npt, shared)) return npt;
    return 0;
}

// One operator's arrays, in 4-byte words from the operator's base
// (I: int on the card, long long for the host's byte count).
template <class I>
struct OpLayout {
    I Tp, offs;                   // the live pairs' T and p offsets
    I src1, dst1, live1, perm1, rowptr1;
    I src2, dst2, live2, perm2, rowptr2;
    I words;
};

template <class I>
__host__ __device__ inline OpLayout<I> make_op_layout(int M1, int M2, int N1,
                                                      int N2) {
    OpLayout<I> O;
    const I MT = static_cast<I>(M1) * M2;
    I o = 0;
    O.Tp = o;      o += MT;
    O.offs = o;    o += (MT + 1) / 2;     // 16 bits each
    O.src1 = o;    o += M1;
    O.dst1 = o;    o += M1;
    O.live1 = o;   o += M1;
    O.perm1 = o;   o += M1;
    O.rowptr1 = o; o += N1 + 1;
    O.src2 = o;    o += M2;
    O.dst2 = o;    o += M2;
    O.live2 = o;   o += M2;
    O.perm2 = o;   o += M2;
    O.rowptr2 = o; o += N2 + 1;
    O.words = (o + 3) / 4 * 4;
    return O;
}

// Shared-memory layout of a group, in 4-byte words, every region on a
// 16-byte boundary for vector loads: p, the operators' arrays, the
// members' diag and precond (ka = K only), the reduction slots, the
// extent.
template <class I>
struct Layout {
    OpLayout<I> op;
    I p, ops, dg, pc, red, ext, words;
};

template <class I>
__host__ __device__ inline Layout<I> make_layout(int K, int ka, int M1,
                                                 int M2, int N1, int N2) {
    Layout<I> L;
    L.op = make_op_layout<I>(M1, M2, N1, N2);
    const I NK = (static_cast<I>(N1) * N2 * K + 3) / 4 * 4;
    I o = 0;
    L.p = o;    o += NK;
    L.ops = o;  o += ka * L.op.words;
    L.dg = o;   o += ka > 1 ? NK : 0;
    L.pc = o;   o += ka > 1 ? NK : 0;
    L.red = o;  o += 3 * kWarps;          // slots: pAp | rz | r.r
    L.ext = o;  o += 2;
    L.words = o;
    return L;
}

inline size_t smem_bytes(int K, int ka, int M1, int M2, int N1, int N2) {
    return static_cast<size_t>(
               make_layout<long long>(K, ka, M1, M2, N1, N2).words) *
           sizeof(float);
}

__device__ __forceinline__ float warp_sum(float v) {
    // butterfly: every lane ends with the same, order-fixed total
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// The kWarps floats at `at` (16-byte aligned) summed in warp order.
__device__ __forceinline__ float sum_slots(const float *at) {
    const float4 u = reinterpret_cast<const float4 *>(at)[0];
    const float4 v = reinterpret_cast<const float4 *>(at)[1];
    return ((((((u.x + u.y) + u.z) + u.w) + v.x) + v.y) + v.z) + v.w;
}

// Sums a (and b) over the block into every thread, with one barrier: the
// warp sums go to `slot` (kWarps floats each), which the caller
// alternates with another so that no thread rewrites a slot that a slower
// one still reads.
template <int NV>
__device__ __forceinline__ void block_sum(float &a, float &b, float *slot) {
    static_assert(kWarps == 8, "sum_slots reads 8 slots");
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    a = warp_sum(a);
    if (NV == 2) b = warp_sum(b);
    if (lane == 0) {
        slot[warp] = a;
        if (NV == 2) slot[kWarps + warp] = b;
    }
    __syncthreads();
    a = sum_slots(slot);
    if (NV == 2) b = sum_slots(slot + kWarps);
}

// Stable counting sort of one side's live edges by source over the rows
// [0, n): rowptr[i] = #{live e : src[e] < i}; live edge e goes to
// rowptr[src[e]] + #{live f < e : src[f] == src[e]}; perm[pos] = e.
// O(M^2) compares per operator, once.
__device__ __forceinline__ void build_csr(const int *src, const int *live,
                                          int M, int n, int *rowptr,
                                          int *perm) {
    for (int i = threadIdx.x; i <= n; i += kThreads) {
        int c = 0;
        for (int e = 0; e < M; ++e) c += live[e] & (src[e] < i);
        rowptr[i] = c;
    }
    for (int e = threadIdx.x; e < M; e += kThreads) {
        if (!live[e]) continue;
        const int s = src[e];
        int pos = 0;
        for (int f = 0; f < M; ++f) {
            const int sf = src[f];
            pos += live[f] & ((sf < s) | ((sf == s) & (f < e)));
        }
        perm[pos] = e;
    }
}

// The K members' p at one product node.
template <int K>
__device__ __forceinline__ void load_members(const float *at, float (&v)[K]) {
    if constexpr (K == 4) {
        const float4 w = *reinterpret_cast<const float4 *>(at);
        v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
    } else if constexpr (K == 2) {
        const float2 w = *reinterpret_cast<const float2 *>(at);
        v[0] = w.x; v[1] = w.y;
    } else {
#pragma unroll
        for (int m = 0; m < K; ++m) v[m] = at[m];
    }
}

struct Problem {
    const float *T;
    const int *esrc1, *edst1, *esrc2, *edst2;
    const float *diag, *precond, *b, *tol;
    float *x;
    int *iters;
    int ka, M1, M2, N1, N2, maxiter;
};

// Where product node (i1, i2)'s live pairs (q1, q2), q1 in side 1's CSR
// row i1 and q2 in side 2's row i2, start in the pair list, q1-major:
// after all rows i1' < i1 (rowptr1[i1] * L2 pairs) and, within row i1,
// after the rows i2' < i2 (deg1 * rowptr2[i2]); and how many there are
// (deg1 * deg2). Packed into one register: start | count << 16 (the list
// has fewer than 2^16 entries: a block's shared memory holds fewer words).
__device__ __forceinline__ unsigned pair_range(const int *rowptr1,
                                               const int *rowptr2, int L2,
                                               int i1, int i2) {
    const int b1 = rowptr1[i1], d1 = rowptr1[i1 + 1] - b1;
    const int b2 = rowptr2[i2], d2 = rowptr2[i2 + 1] - b2;
    return static_cast<unsigned>(b1 * L2 + d1 * b2) |
           (static_cast<unsigned>(d1 * d2) << 16);
}

// The group's solve. SHARED: the K members share operator 0 (ka = 1) and
// run in lockstep; else member m has operator m (ka = K).
template <int K, int NPT, bool SHARED>
__device__ __forceinline__ void pcg_group(const Problem &P, float *smem) {
    const int tid = threadIdx.x;
    constexpr int nt = kThreads;
    const int ka = SHARED ? 1 : K;
    const int M1 = P.M1, M2 = P.M2, N1 = P.N1, N2 = P.N2;
    const int N = N1 * N2;
    const Layout<int> L = make_layout<int>(K, ka, M1, M2, N1, N2);
    const OpLayout<int> O = L.op;
    const size_t g = blockIdx.x;
    float *p = smem + L.p;
    float *dgs = smem + L.dg;
    float *pcs = smem + L.pc;
    float *red = smem + L.red;
    int *ext = reinterpret_cast<int *>(smem + L.ext);
    auto op_base = [&](int a) {
        return reinterpret_cast<int *>(smem + L.ops + a * O.words);
    };

    // ---- edge lists; live flags cleared ---------------------------------
    for (int a = 0; a < ka; ++a) {
        int *o = op_base(a);
        const size_t e1 = (g * ka + a) * M1;
        const size_t e2 = (g * ka + a) * M2;
        for (int i = tid; i < M1; i += nt) {
            o[O.src1 + i] = P.esrc1[e1 + i];
            o[O.dst1 + i] = P.edst1[e1 + i];
            o[O.live1 + i] = 0;
        }
        for (int i = tid; i < M2; i += nt) {
            o[O.src2 + i] = P.esrc2[e2 + i];
            o[O.dst2 + i] = P.edst2[e2 + i];
            o[O.live2 + i] = 0;
        }
    }
    for (int i = tid; i < 3 * kWarps; i += nt) red[i] = 0.f;
    if (tid == 0) {
        ext[0] = -1;
        ext[1] = -1;
    }
    __syncthreads();

    // ---- a nonzero of T marks its edge live on both sides (T read 16
    // bytes a load where its size allows). The extent starts from the rows
    // and columns of the members' nonzero b ------------------------------
    const int MT = M1 * M2;
    for (int a = 0; a < ka; ++a) {
        int *o = op_base(a);
        const float *Tg = P.T + (g * ka + a) * MT;
        auto mark = [&](int idx, float t) {
            if (t != 0.f) {           // racing stores of the same 1
                const int e1 = idx / M2;
                o[O.live1 + e1] = 1;
                o[O.live2 + idx - e1 * M2] = 1;
            }
        };
        if (MT % 4 == 0) {
            const float4 *T4 = reinterpret_cast<const float4 *>(Tg);
#pragma unroll 4
            for (int v = tid; v < MT / 4; v += nt) {
                const float4 t = T4[v];
                mark(4 * v, t.x);
                mark(4 * v + 1, t.y);
                mark(4 * v + 2, t.z);
                mark(4 * v + 3, t.w);
            }
        } else {
#pragma unroll 4
            for (int idx = tid; idx < MT; idx += nt) mark(idx, Tg[idx]);
        }
    }
    int hi1 = -1, hi2 = -1;
    const float *bg = P.b + g * K * N;
#pragma unroll 4
    for (int idx = tid; idx < K * N; idx += nt) {
        if (bg[idx] != 0.f) {
            const int j = idx % N;
            const int i1 = j / N2;
            hi1 = max(hi1, i1);
            hi2 = max(hi2, j - i1 * N2);
        }
    }
    __syncthreads();
    for (int a = 0; a < ka; ++a) {
        const int *o = op_base(a);
        for (int e = tid; e < M1; e += nt)
            if (o[O.live1 + e])
                hi1 = max(hi1, max(o[O.src1 + e], o[O.dst1 + e]));
        for (int e = tid; e < M2; e += nt)
            if (o[O.live2 + e])
                hi2 = max(hi2, max(o[O.src2 + e], o[O.dst2 + e]));
    }
    if (hi1 >= 0) atomicMax(ext, hi1);        // integer: order-free
    if (hi2 >= 0) atomicMax(ext + 1, hi2);
    __syncthreads();
    const int n1 = ext[0] + 1;
    const int n2 = ext[1] + 1;
    const int n = n1 * n2;

    // ---- CSR by source over the live edges of the extent's rows ---------
    for (int a = 0; a < ka; ++a) {
        int *o = op_base(a);
        build_csr(o + O.src1, o + O.live1, M1, n1, o + O.rowptr1,
                  o + O.perm1);
        build_csr(o + O.src2, o + O.live2, M2, n2, o + O.rowptr2,
                  o + O.perm2);
    }
    __syncthreads();

    // ---- the pair list: for every live (q1, q2), T of its edges (from L2,
    // just scanned) and the word of p it multiplies, at the place
    // pair_range gives, so each product node's pairs are contiguous -------
    for (int a = 0; a < ka; ++a) {
        int *o = op_base(a);
        float *Tp = reinterpret_cast<float *>(o + O.Tp);
        unsigned short *offs = reinterpret_cast<unsigned short *>(o + O.offs);
        const float *Tg = P.T + (g * ka + a) * MT;
        const int *rowptr1 = o + O.rowptr1, *rowptr2 = o + O.rowptr2;
        const int L2 = rowptr2[n2];
        for (int idx = tid; idx < rowptr1[n1] * L2; idx += nt) {
            const int q1 = idx / L2;
            const int q2 = idx - q1 * L2;
            const int e1 = o[O.perm1 + q1], e2 = o[O.perm2 + q2];
            const int i1 = o[O.src1 + e1], i2 = o[O.src2 + e2];
            const int b1 = rowptr1[i1], b2 = rowptr2[i2];
            const int pos = b1 * L2 + (rowptr1[i1 + 1] - b1) * b2 +
                            (q1 - b1) * (rowptr2[i2 + 1] - b2) + (q2 - b2);
            Tp[pos] = Tg[e1 * M2 + e2];
            offs[pos] = static_cast<unsigned short>(
                (o[O.dst1 + e1] * n2 + o[O.dst2 + e2]) * K);
        }
    }

    // ---- each thread's product nodes: registers and p = precond * b -----
    const int *o0 = op_base(0);
    const float *Tp0 = reinterpret_cast<const float *>(o0 + O.Tp);
    const unsigned short *offs0 =
        reinterpret_cast<const unsigned short *>(o0 + O.offs);
    const int L2_0 = o0[O.rowptr2 + n2];
    const size_t opg = g * ka * N;
    float x[NPT][K], r[NPT][K], Ap[NPT][K], dg[NPT], pc[NPT];
    unsigned pairs[NPT];
    float rz = 0.f, rr = 0.f;
#pragma unroll
    for (int s = 0; s < NPT; ++s) {
        const int j = tid + s * nt;
        dg[s] = pc[s] = 0.f;
        pairs[s] = 0;
#pragma unroll
        for (int m = 0; m < K; ++m) x[s][m] = r[s][m] = Ap[s][m] = 0.f;
        if (j < n) {
            const int i1 = j / n2;
            const int i2 = j - i1 * n2;
            const int gi = i1 * N2 + i2;
            if (SHARED) {
                dg[s] = P.diag[opg + gi];
                pc[s] = P.precond[opg + gi];
                pairs[s] = pair_range(o0 + O.rowptr1, o0 + O.rowptr2, L2_0,
                                      i1, i2);
            }
#pragma unroll
            for (int m = 0; m < K; ++m) {
                float c = pc[s];
                if (!SHARED) {
                    c = P.precond[opg + m * N + gi];
                    dgs[j * K + m] = P.diag[opg + m * N + gi];
                    pcs[j * K + m] = c;
                }
                const float bi = bg[m * N + gi];
                const float zi = c * bi;
                r[s][m] = bi;
                p[j * K + m] = zi;
                rz += bi * zi;
                rr += bi * bi;
            }
        }
    }
    block_sum<2>(rz, rr, red + kWarps);   // also publishes p and pairs

    const float tolg = P.tol[g];
    const bool done = sqrtf(rr) < tolg;
    int it = 0;
    int n_iter = done ? 0 : P.maxiter;

    // ---- one PCG on the union of the members ----------------------------
    while (!done && it < P.maxiter) {
        float pAp = 0.f, unused = 0.f;
#pragma unroll
        for (int s = 0; s < NPT; ++s) {
            const int j = tid + s * nt;
            if (j >= n) continue;
            float acc[K];
#pragma unroll
            for (int m = 0; m < K; ++m) acc[m] = 0.f;
            if (SHARED) {
                // the members in lockstep over the shared operator's pairs
                const int k0 = pairs[s] & 0xffffu;
                const int k1 = k0 + (pairs[s] >> 16);
                for (int k = k0; k < k1; ++k) {
                    const float t = Tp0[k];
                    float v[K];
                    load_members<K>(p + offs0[k], v);
#pragma unroll
                    for (int m = 0; m < K; ++m)
                        acc[m] = fmaf(t, v[m], acc[m]);
                }
            } else {
                // each member over its own operator's pairs
                const int i1 = j / n2;
                const int i2 = j - i1 * n2;
#pragma unroll
                for (int m = 0; m < K; ++m) {
                    const int *o = op_base(m);
                    const float *Tp =
                        reinterpret_cast<const float *>(o + O.Tp);
                    const unsigned short *offs =
                        reinterpret_cast<const unsigned short *>(o + O.offs);
                    const unsigned range = pair_range(
                        o + O.rowptr1, o + O.rowptr2, o[O.rowptr2 + n2], i1,
                        i2);
                    const int k0 = range & 0xffffu;
                    const int k1 = k0 + (range >> 16);
                    for (int k = k0; k < k1; ++k)
                        acc[m] = fmaf(Tp[k], p[offs[k] + m], acc[m]);
                }
            }
#pragma unroll
            for (int m = 0; m < K; ++m) {
                const float pv = p[j * K + m];
                const float d = SHARED ? dg[s] : dgs[j * K + m];
                Ap[s][m] = d * pv - acc[m];
                pAp += pv * Ap[s][m];
            }
        }
        block_sum<1>(pAp, unused, red);
        ++it;
        if (pAp == 0.f || rz == 0.f) {   // breakdown: x stays as it is
            n_iter = it;
            break;
        }
        const float alpha = rz / pAp;
        float rz_new = 0.f;
        rr = 0.f;
#pragma unroll
        for (int s = 0; s < NPT; ++s) {
            const int j = tid + s * nt;
            if (j >= n) continue;
#pragma unroll
            for (int m = 0; m < K; ++m) {
                const float c = SHARED ? pc[s] : pcs[j * K + m];
                x[s][m] += alpha * p[j * K + m];
                const float ri = r[s][m] - alpha * Ap[s][m];
                r[s][m] = ri;
                rz_new += ri * (c * ri);
                rr += ri * ri;
            }
        }
        block_sum<2>(rz_new, rr, red + kWarps);
        if (sqrtf(rr) < tolg) {
            n_iter = it;
            break;
        }
        const float beta = rz_new / rz;
#pragma unroll
        for (int s = 0; s < NPT; ++s) {
            const int j = tid + s * nt;
            if (j >= n) continue;
#pragma unroll
            for (int m = 0; m < K; ++m) {
                const float c = SHARED ? pc[s] : pcs[j * K + m];
                p[j * K + m] = c * r[s][m] + beta * p[j * K + m];
            }
        }
        rz = rz_new;
        __syncthreads();
    }

    // ---- x: the extent's nodes from registers, zeros beyond it ----------
    float *xg = P.x + g * K * N;
#pragma unroll
    for (int s = 0; s < NPT; ++s) {
        const int j = tid + s * nt;
        if (j >= n) continue;
        const int i1 = j / n2;
        const int gi = i1 * N2 + (j - i1 * n2);
#pragma unroll
        for (int m = 0; m < K; ++m) xg[m * N + gi] = x[s][m];
    }
    for (int idx = tid; idx < K * N; idx += nt) {
        const int j = idx % N;
        const int i1 = j / N2;
        if (i1 >= n1 || j - i1 * N2 >= n2) xg[idx] = 0.f;
    }
    if (tid == 0) P.iters[g] = n_iter;
}

using KernelFn = void (*)(Problem);

// The instance of NPT nodes a thread among the ladder's (nullptr where it
// has none): KERNELS::get<K, NPT, SHARED>() names each source's own
// __global__ function, so that a profile tells the kernels apart.
template <class KERNELS, int K, bool SHARED, int I = 0>
KernelFn instance(int npt) {
    if constexpr (I < kLadderSize) {
        constexpr int NPT = kLadder[I];
        if constexpr (has_instance(K, NPT, SHARED)) {
            if (npt == NPT) return KERNELS::template get<K, NPT, SHARED>();
        }
        return instance<KERNELS, K, SHARED, I + 1>(npt);
    } else {
        return nullptr;
    }
}

// Launches `fn` (nullptr: no instance) with one CTA a group on `stream`;
// returns the launch's cudaError_t (cudaErrorInvalidValue for nullptr).
inline int launch(KernelFn fn, const Problem &P, int S, int K,
                  void *stream) {
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(K, P.ka, P.M1, P.M2, P.N1, P.N2);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    Problem arg = P;
    void *args[] = {&arg};
    err = cudaLaunchKernel(reinterpret_cast<const void *>(fn), dim3(S),
                           dim3(kThreads), args, smem,
                           static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// What `fn` gets on the current device for groups of these shapes:
// out[0] CTAs an SM, out[1] registers a thread, out[2] local (spill)
// bytes a thread, out[3] dynamic shared bytes a CTA.
inline int occupancy(KernelFn fn, int K, int ka, int M1, int M2, int N1,
                     int N2, int *out) {
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(K, ka, M1, M2, N1, N2);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                        kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = blocks;
    out[1] = attr.numRegs;
    out[2] = static_cast<int>(attr.localSizeBytes);
    out[3] = static_cast<int>(smem);
    return 0;
}

}  // namespace graphdot_pcg
