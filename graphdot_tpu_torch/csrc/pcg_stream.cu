// Streaming Jacobi-PCG over marginalized-graph-kernel product systems whose
// pair does not fit a block's shared memory, each pair spread over C CTAs
// of one cooperative grid, for NVIDIA Hopper (sm_90a).
//
// Replaces graphdot_tpu/ops/pallas_pcg.py::_pcg_stream_kernel (reached
// through `pallas_pcg_stream` and `_stream_solver`). It solves the same
// system as csrc/pcg_resident.cu,
//
//     [diag o Y - S1^T (T o (D1 Y D2^T)) S2] = b      (Y is N1 x N2)
//
// by Jacobi-PCG from x = 0, with the same breakdown guards (pAp == 0,
// rz == 0), the same stop rule (sqrt(r.r) < tol, or maxiter steps) and a
// step count per pair. The off-diagonal matvec is in gather form:
//
//     out[i1,i2] = sum_{e1: src1(e1)=i1} sum_{e2: src2(e2)=i2}
//                  T[e1,e2] * y[dst1(e1), dst2(e2)]
//
// Four kernels run on the stream, one after the other:
//
// 1. `stream_live_cols_kernel` and `stream_live_rows_kernel` mark the
//    edges whose column or row of T holds a nonzero. The others (the
//    batch's padding edges, T = 0) add nothing, and are left out of the
//    solve: this keeps a graph's padding out of node 0's edge list, where
//    one thread would otherwise walk all of it, and out of the stream.
// 2. `stream_sort_kernel`, one CTA per pair: a stable counting sort of
//    each side's live edges by source (one thread per node scans the edge
//    list in order), giving the sorted sources and destinations, the
//    permutations, both sides' row pointers and the live counts L1, L2.
// 3. `stream_permute_kernel`: one pass over T that writes
//    Tp[k1,k2] = T[perm1[k1], perm2[k2]] for the live edges, rows padded
//    to a multiple of four floats, so that rows sharing a side-1 source
//    and columns sharing a side-2 source are contiguous and every tile is
//    16-byte aligned.
// 4. `pcg_stream_kernel`, launched cooperatively (cudaLaunchCooperative-
//    Kernel) with C CTAs per pair, runs the whole PCG. CTA c of a pair
//    owns a contiguous range [a_c, a_{c+1}) of side-1 source nodes, cut
//    at the node where rowptr1[i] + i (live edges plus nodes before i)
//    reaches c / C of L1 + N1, so the ranges balance the live edges and
//    spread edge-less nodes too. The CTA owns rows a_c..a_{c+1} of the CG
//    vectors (x, r, p and out/Ap, N1 x N2 floats each, in the caller's
//    workspace) and streams only the sorted rows of Tp whose source lies
//    in its range, in tiles of TR rows by TC columns, double-buffered
//    with cp.async, once per CG step, together with the rows of p the
//    tile's rows gather from. Per tile, pass 1 computes
//        W[r, i2] = sum_{k in row i2 of side 2, k in the tile}
//                   Tp[r, k] * p[dst1s(r), dst2s(k)]
//    and pass 2 adds W over each run of rows with one side-1 source into
//    out[src1s(r), i2]; one thread owns each column i2 of a tile, and
//    every source of the CTA's rows is one it owns, so the sums need no
//    atomics. A row longer than a tile is cut into column tiles, so no
//    edge count is too large; the bound is N2 (see below).
//
// A CG step has three grid barriers (cooperative_groups grid.sync()):
// after each CTA has written its block sum of pAp into its slot of the
// workspace; after its sums of rz and r.r; and after its rows of p are
// updated, because the next matvec gathers rows of p that other CTAs
// wrote. After a barrier every CTA of a pair adds the pair's C partials in
// CTA order (one warp, lanes in a fixed order, then a butterfly), so all
// of them get bit-identical alpha, beta and stop decisions, and the
// result is deterministic for a given C. Every CTA of the grid meets every
// barrier: a pair that has converged or broken down stops computing but
// goes on meeting them, and the loop ends for the whole grid when the
// count of finished pairs (in the workspace, raised between two barriers
// and read only between the next two) reaches the grid's pair count, or
// at maxiter. The CG vectors written by other CTAs are read only through
// L2 (cp.async.cg, ld.global.cg), never through L1 or the read-only path.
// More pairs than fit one grid run in several launches of C = 1.
//
// Precision: the TPU kernel computes in split2 (two bf16 MXU passes); this
// kernel computes in f32 with FMA, which is at least as accurate, so it
// takes no mode argument. Block-wide dot products are deterministic: warp
// butterflies, then the warp sums in a fixed order, with no float atomics;
// the matvec sums in a fixed order too.
//
// What bounds it: T is read from device memory once per CG step, L1*L2*4
// bytes a pair (up to 55.8 MB at the protein contact-map shapes,
// M = 3736, 24x the 50 MB L2 for a 21-pair chunk). With one CTA per pair a
// chunk of P pairs kept only P SMs busy and a step cost one SM's pass over
// all its tiles; the split puts C = floor(G / P) CTAs on a pair (G = the
// CTAs that fit the card at once, one an SM at these shapes), so every SM
// streams. Inside a CTA the time per tile is still the latency of pass
// 1's shared-memory loads and the block barriers of each tile, and each
// step adds three grid barriers of a few microseconds. Shared memory holds
// two tiles with their rows of p (TR x N2 floats each), side 2's
// destinations for one column tile, its row pointers and W (TR x N2):
// with TR = 1 the plan fits the 227 KB a block can get for N2 up to about
// 9,800 nodes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSortThreads = 256;
constexpr int kStages = 2;                  // T tiles in flight
constexpr int kMaxCols = 6144;              // columns of a tile
constexpr int kMaxRows = 16;                // rows of a tile
constexpr size_t kTileBytes = 96 * 1024;    // bytes of one T tile
constexpr int kSlots = 3;                   // pAp, rz, r.r of a CTA

struct Plan {
    int TR, TC, ldT;
    size_t smem;   // bytes of dynamic shared memory
};

__host__ __device__ inline size_t round_up(size_t a, size_t b) {
    return (a + b - 1) / b * b;
}

// Tile shape and shared memory for a pair; TR = 0 when no tile fits.
__host__ __device__ inline Plan make_plan(int M1, int M2, int N2,
                                          size_t smem_limit) {
    Plan P;
    P.ldT = static_cast<int>(round_up(M2 > 0 ? M2 : 1, 4));
    const int n_col = (P.ldT + kMaxCols - 1) / kMaxCols;
    P.TC = static_cast<int>(round_up((P.ldT + n_col - 1) / n_col, 4));
    P.TR = 0;
    P.smem = 0;
    const int rows = M1 < kMaxRows ? (M1 > 0 ? M1 : 1) : kMaxRows;
    for (int tr = rows; tr >= 1; --tr) {
        const size_t tile = static_cast<size_t>(tr) * P.TC * sizeof(float);
        const size_t rows_of_p =
            static_cast<size_t>(tr) * N2 * sizeof(float);
        const size_t smem = kStages * (tile + rows_of_p) +
                            P.TC * sizeof(int) + (N2 + 1) * sizeof(int) +
                            rows_of_p + 2 * kWarps * sizeof(float);
        if ((tile <= kTileBytes || tr == 1) && smem <= smem_limit) {
            P.TR = tr;
            P.smem = smem;
            break;
        }
    }
    return P;
}

// Workspace layout: byte offsets into the caller's buffer, 256-aligned.
struct Workspace {
    size_t Tp, vec, live1, live2, nlive, src1s, dst1s, perm1, rowptr1,
        src2s, dst2s, perm2, rowptr2, part, finished;
    size_t bytes;
};

// For P pairs solved by grids of at most `grid` CTAs.
inline Workspace make_workspace(int P, int M1, int M2, int N1, int N2,
                                int grid) {
    Workspace W;
    const Plan plan = make_plan(M1, M2, N2, 0);
    const size_t p = static_cast<size_t>(P);
    size_t o = 0;
    auto take = [&o](size_t bytes) {
        const size_t at = o;
        o = round_up(o + bytes, 256);
        return at;
    };
    W.Tp = take(p * M1 * plan.ldT * sizeof(float));
    W.vec = take(p * 4 * N1 * N2 * sizeof(float));   // x, r, p, out/Ap
    W.live1 = take(p * M1 * sizeof(int));
    W.live2 = take(p * M2 * sizeof(int));
    W.nlive = take(p * 2 * sizeof(int));
    W.src1s = take(p * M1 * sizeof(int));
    W.dst1s = take(p * M1 * sizeof(int));
    W.perm1 = take(p * M1 * sizeof(int));
    W.rowptr1 = take(p * (N1 + 1) * sizeof(int));
    W.src2s = take(p * M2 * sizeof(int));
    W.dst2s = take(p * M2 * sizeof(int));
    W.perm2 = take(p * M2 * sizeof(int));
    W.rowptr2 = take(p * (N2 + 1) * sizeof(int));
    W.part = take(static_cast<size_t>(grid) * kSlots * sizeof(float));
    W.finished = take(sizeof(int));
    W.bytes = o;
    return W;
}

__device__ __forceinline__ float warp_sum(float v) {
    // butterfly: every lane ends with the same, order-fixed total
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Sums a and b over the block; every thread receives both totals.
// Contains two barriers, so it also orders the memory writes made before
// it against the reads made after it.
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

// Sums slots k..k+K-1 of the C CTAs from `first` on (the CTAs of one
// pair), in a fixed order: lane l adds CTAs l, l + 32, ... in turn, then a
// butterfly. Every thread receives the K totals, and every CTA of the pair
// the same bits. Reads the slots through L2: other CTAs wrote them.
template <int K>
__device__ __forceinline__ void pair_sum(const float *part, int first,
                                         int C, int k, float (&v)[K],
                                         float *red) {
    if (threadIdx.x < 32) {
        float s[K];
#pragma unroll
        for (int j = 0; j < K; ++j) s[j] = 0.f;
        for (int c = threadIdx.x; c < C; c += 32) {
            const float *slot = part + (first + c) * kSlots + k;
#pragma unroll
            for (int j = 0; j < K; ++j) s[j] += __ldcg(slot + j);
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
            s[j] = warp_sum(s[j]);
            if (threadIdx.x == 0) red[j] = s[j];
        }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = red[j];
    __syncthreads();
}

// live2[pair, e2] = 1 when column e2 of T holds a nonzero.
// Grid: (ceil(M2 / 256), P); one thread a column, down all rows.
__global__ void __launch_bounds__(256)
stream_live_cols_kernel(const float *__restrict__ T, int *__restrict__ live2,
                        int M1, int M2) {
    const size_t pair = blockIdx.y;
    const int e2 = blockIdx.x * blockDim.x + threadIdx.x;
    if (e2 >= M2) return;
    const float *col = T + pair * M1 * M2 + e2;
    int live = 0;
#pragma unroll 8
    for (int e1 = 0; e1 < M1; ++e1)
        live |= col[static_cast<size_t>(e1) * M2] != 0.f;
    live2[pair * M2 + e2] = live;
}

// live1[pair, e1] = 1 when row e1 of T holds a nonzero. Grid: (M1, P).
__global__ void __launch_bounds__(256)
stream_live_rows_kernel(const float *__restrict__ T, int *__restrict__ live1,
                        int M1, int M2) {
    const size_t pair = blockIdx.y;
    const int e1 = blockIdx.x;
    const float *row = T + (pair * M1 + e1) * M2;
    int live = 0;
    for (int e2 = threadIdx.x; e2 < M2; e2 += blockDim.x)
        live |= row[e2] != 0.f;
    live = __syncthreads_or(live);
    if (threadIdx.x == 0) live1[pair * M1 + e1] = live != 0;
}

// Stable counting sort of one pair's live edges (of M) by source over N
// nodes. Thread i counts, then places, the live edges leaving node i in
// edge order; a serial prefix sum over the nodes sits between the two
// scans. Writes the row pointers (N + 1) and returns the number of live
// edges to every thread.
__device__ int sort_side(const int *src, const int *dst, const int *live,
                         int M, int N, int *src_s, int *dst_s, int *perm,
                         int *rowptr, int *count) {
    for (int i = threadIdx.x; i < N; i += kSortThreads) {
        int c = 0;
        for (int e = 0; e < M; ++e) c += (src[e] == i) & live[e];
        count[i] = c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int acc = 0;
        for (int i = 0; i < N; ++i) {
            const int c = count[i];
            count[i] = acc;
            acc += c;
        }
        count[N] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i <= N; i += kSortThreads) {
        int at = count[i];
        rowptr[i] = at;
        if (i == N) continue;
        for (int e = 0; e < M; ++e) {
            if ((src[e] == i) & live[e]) {
                src_s[at] = i;
                dst_s[at] = dst[e];
                perm[at] = e;
                ++at;
            }
        }
    }
    const int n_live = count[N];
    __syncthreads();
    return n_live;
}

__global__ void __launch_bounds__(kSortThreads)
stream_sort_kernel(const int *__restrict__ esrc1,
                   const int *__restrict__ edst1,
                   const int *__restrict__ esrc2,
                   const int *__restrict__ edst2,
                   const int *__restrict__ live1,
                   const int *__restrict__ live2, int *nlive, int *src1s,
                   int *dst1s, int *perm1, int *rowptr1, int *src2s,
                   int *dst2s, int *perm2, int *rowptr2, int M1, int M2,
                   int N1, int N2) {
    extern __shared__ int count[];   // max(N1, N2) + 1 ints
    const size_t pair = blockIdx.x;
    const int L1 = sort_side(esrc1 + pair * M1, edst1 + pair * M1,
                             live1 + pair * M1, M1, N1, src1s + pair * M1,
                             dst1s + pair * M1, perm1 + pair * M1,
                             rowptr1 + pair * (N1 + 1), count);
    const int L2 = sort_side(esrc2 + pair * M2, edst2 + pair * M2,
                             live2 + pair * M2, M2, N2, src2s + pair * M2,
                             dst2s + pair * M2, perm2 + pair * M2,
                             rowptr2 + pair * (N2 + 1), count);
    if (threadIdx.x == 0) {
        nlive[2 * pair] = L1;
        nlive[2 * pair + 1] = L2;
    }
}

// Tp[pair, k1, k2] = T[pair, perm1[k1], perm2[k2]] over the live edges,
// zero for L2 <= k2 < ldT; rows past L1 are left alone (never read).
// Grid: (M1 rows, P pairs).
__global__ void __launch_bounds__(256)
stream_permute_kernel(const float *__restrict__ T,
                      const int *__restrict__ nlive,
                      const int *__restrict__ perm1,
                      const int *__restrict__ perm2, float *__restrict__ Tp,
                      int M1, int M2, int ldT) {
    const size_t pair = blockIdx.y;
    const int k1 = blockIdx.x;
    if (k1 >= nlive[2 * pair]) return;
    const int L2 = nlive[2 * pair + 1];
    const int e1 = perm1[pair * M1 + k1];
    const float *row = T + (pair * M1 + e1) * M2;
    const int *p2 = perm2 + pair * M2;
    float *out = Tp + (pair * M1 + k1) * ldT;
    for (int k2 = threadIdx.x; k2 < ldT; k2 += blockDim.x)
        out[k2] = k2 < L2 ? row[p2[k2]] : 0.f;
}

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issues the copies of tile t (column tile t / n_row, row tile t % n_row
// of the rows [R0, R1) the CTA streams) into `buf`, columns up to L2
// rounded up to four, and of the rows of p that its rows gather from into
// `prows` (row r of the tile takes p[dst1s(r), :]). Then commits a group
// (empty when t is past the last tile). p is written by other CTAs during
// the kernel, so its rows come through L2: 16-byte cp.async.cg where rows
// of p are 16-byte aligned (N2 a multiple of 4, as in every padded batch),
// else ld.global.cg.
__device__ __forceinline__ void issue_tile(const float *Tg, const float *p,
                                           const int *dst1s, float *buf,
                                           float *prows, int t, int n_tiles,
                                           int n_row, int R0, int R1,
                                           int L2, int N2, const Plan &pl) {
    if (t < n_tiles) {
        const int r0 = R0 + (t % n_row) * pl.TR;
        const int c0 = (t / n_row) * pl.TC;
        const int rows = min(pl.TR, R1 - r0);
        const int cols =
            min(pl.TC, static_cast<int>(round_up(L2, 4)) - c0);
        const int q = cols >> 2;          // 16-byte chunks a row
        for (int idx = threadIdx.x; idx < rows * q; idx += kThreads) {
            const int r = idx / q;
            const int c = (idx - r * q) << 2;
            cp_async16(buf + r * pl.TC + c,
                       Tg + static_cast<size_t>(r0 + r) * pl.ldT + c0 + c);
        }
        if ((N2 & 3) == 0) {
            const int q2 = N2 >> 2;
            for (int idx = threadIdx.x; idx < rows * q2; idx += kThreads) {
                const int r = idx / q2;
                const int c = (idx - r * q2) << 2;
                cp_async16(prows + r * N2 + c,
                           p + static_cast<size_t>(dst1s[r0 + r]) * N2 + c);
            }
        } else {
            for (int idx = threadIdx.x; idx < rows * N2; idx += kThreads) {
                const int r = idx / N2;
                prows[idx] = __ldcg(
                    p + static_cast<size_t>(dst1s[r0 + r]) * N2 +
                    (idx - r * N2));
            }
        }
    }
    cp_async_commit();
}

// The first side-1 node i of the range of CTA c of C: the least i in
// [0, N1] with rowptr1[i] + i >= ceil(c * (L1 + N1) / C).
__device__ int range_start(const int *rowptr1, int L1, int N1, int c,
                           int C) {
    const long long target =
        (static_cast<long long>(L1 + N1) * c + C - 1) / C;
    int lo = 0, hi = N1;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (rowptr1[mid] + mid >= target)
            hi = mid;
        else
            lo = mid + 1;
    }
    return lo;
}

// One cooperative grid of n_pairs * C CTAs: CTA blockIdx.x works on pair
// pair0 + blockIdx.x / C, as its part blockIdx.x % C.
__global__ void __launch_bounds__(kThreads)
pcg_stream_kernel(const float *__restrict__ Tp_all,
                  const int *__restrict__ nlive,
                  const int *__restrict__ src1s_all,
                  const int *__restrict__ dst1s_all,
                  const int *__restrict__ rowptr1_all,
                  const int *__restrict__ src2s_all,
                  const int *__restrict__ dst2s_all,
                  const int *__restrict__ rowptr2_all,
                  const float *__restrict__ diag,
                  const float *__restrict__ precond,
                  const float *__restrict__ b, const float *__restrict__ tol,
                  float *vec_all, float *part, int *finished,
                  float *__restrict__ x_out, int *__restrict__ iters_out,
                  int pair0, int n_pairs, int C, int M1, int M2, int N1,
                  int N2, int maxiter, Plan pl) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ __align__(16) float smem[];
    float *tiles = smem;                                  // kStages tiles
    float *prows = tiles + kStages * pl.TR * pl.TC;       // kStages x TR x N2
    int *dst2t = reinterpret_cast<int *>(prows + kStages * pl.TR * N2);
    int *rp2 = dst2t + pl.TC;                             // N2 + 1
    float *W = reinterpret_cast<float *>(rp2 + N2 + 1);   // TR x N2
    float *red = W + pl.TR * N2;

    const int tid = threadIdx.x;
    const int local = blockIdx.x / C;
    const int c = blockIdx.x - local * C;
    const int first = local * C;   // the pair's first CTA
    const size_t pair = pair0 + local;
    const int N = N1 * N2;
    const int L1 = nlive[2 * pair];
    const int L2 = nlive[2 * pair + 1];
    const float *Tg = Tp_all + pair * M1 * pl.ldT;
    const int *src1s = src1s_all + pair * M1;
    const int *dst1s = dst1s_all + pair * M1;
    const int *rowptr1 = rowptr1_all + pair * (N1 + 1);
    const int *src2s = src2s_all + pair * M2;
    const int *dst2s = dst2s_all + pair * M2;
    const int *rowptr2 = rowptr2_all + pair * (N2 + 1);
    // CG vectors in device memory. The CTA writes rows [a, a_next) of
    // each; the matvec gathers rows of p that other CTAs wrote, so p is
    // never read through the read-only path or L1
    float *x = vec_all + pair * 4 * N;
    float *r = x + N;
    float *p = r + N;
    float *U = p + N;   // out of the matvec, then Ap

    if (tid == 0) {
        red[0] = __int_as_float(range_start(rowptr1, L1, N1, c, C));
        red[1] = __int_as_float(range_start(rowptr1, L1, N1, c + 1, C));
    }
    __syncthreads();
    const int a = __float_as_int(red[0]);
    const int a_next = __float_as_int(red[1]);
    __syncthreads();
    const int R0 = rowptr1[a];        // the CTA's sorted rows of Tp
    const int R1 = rowptr1[a_next];
    const int lo = a * N2;            // the CTA's elements of the vectors
    const int hi = a_next * N2;
    float *slot = part + blockIdx.x * kSlots;

    for (int i = tid; i <= N2; i += kThreads) rp2[i] = rowptr2[i];
    const float *dg = diag + pair * N;
    const float *pc = precond + pair * N;
    const float *bg = b + pair * N;
    float rz = 0.f, rr = 0.f;
    for (int i = lo + tid; i < hi; i += kThreads) {
        const float bi = bg[i];
        const float zi = pc[i] * bi;
        x[i] = 0.f;
        r[i] = bi;
        p[i] = zi;
        U[i] = 0.f;
        rz += bi * zi;
        rr += bi * bi;
    }
    block_sum2(rz, rr, red);
    if (tid == 0) {
        slot[1] = rz;
        slot[2] = rr;
    }
    grid.sync();
    {
        float v[2];
        pair_sum<2>(part, first, C, 1, v, red);
        rz = v[0];
        rr = v[1];
    }
    const float tolp = tol[pair];
    bool active = !(sqrtf(rr) < tolp);
    int n_iter = active ? maxiter : 0;
    if (!active && c == 0 && tid == 0) atomicAdd(finished, 1);
    grid.sync();

    const int n_row = (R1 - R0 + pl.TR - 1) / pl.TR;
    const int n_tiles = n_row * ((L2 + pl.TC - 1) / pl.TC);

    for (int step = 0; step < maxiter; ++step) {
        // no CTA raises the count between the last barrier and the next
        if (*reinterpret_cast<volatile int *>(finished) == n_pairs) break;
        if (active) {
            // ---- U = sum over the CTA's T tiles (U is zero here) -------
            for (int s = 0; s < kStages - 1; ++s)
                issue_tile(Tg, p, dst1s, tiles + s * pl.TR * pl.TC,
                           prows + s * pl.TR * N2, s, n_tiles, n_row, R0,
                           R1, L2, N2, pl);
            for (int t = 0; t < n_tiles; ++t) {
                const int next = (t + kStages - 1) % kStages;
                issue_tile(Tg, p, dst1s, tiles + next * pl.TR * pl.TC,
                           prows + next * pl.TR * N2, t + kStages - 1,
                           n_tiles, n_row, R0, R1, L2, N2, pl);
                const int r0 = R0 + (t % n_row) * pl.TR;
                const int c0 = (t / n_row) * pl.TC;
                const int c1 = min(c0 + pl.TC, L2);
                const int rows = min(pl.TR, R1 - r0);
                if (t % n_row == 0) {   // side 2's destinations of this
                                        // column tile
                    for (int k = tid; k < c1 - c0; k += kThreads)
                        dst2t[k] = dst2s[c0 + k];
                }
                cp_async_wait<kStages - 1>();
                __syncthreads();
                const float *Ts = tiles + (t % kStages) * pl.TR * pl.TC;
                const float *Ps = prows + (t % kStages) * pl.TR * N2;
                const int i2lo = src2s[c0];
                const int NI = src2s[c1 - 1] - i2lo + 1;
                // pass 1: W[row, j] over the tile's part of row i2lo + j
                for (int idx = tid; idx < rows * NI; idx += kThreads) {
                    const int rl = idx / NI;
                    const int j = idx - rl * NI;
                    const int klo = max(rp2[i2lo + j], c0) - c0;
                    const int khi = min(rp2[i2lo + j + 1], c1) - c0;
                    const float *Trow = Ts + rl * pl.TC;
                    const float *prow = Ps + rl * N2;
                    float acc = 0.f;
#pragma unroll 4
                    for (int k = klo; k < khi; ++k)
                        acc = fmaf(Trow[k], prow[dst2t[k]], acc);
                    W[idx] = acc;
                }
                __syncthreads();
                // pass 2: U[i1, i2] += W over each run of rows with
                // source i1; thread j owns column i2lo + j of the tile
                for (int j = tid; j < NI; j += kThreads) {
                    const int i2 = i2lo + j;
                    int cur = src1s[r0];
                    float acc = 0.f;
                    for (int rl = 0; rl < rows; ++rl) {
                        const int s = src1s[r0 + rl];
                        if (s != cur) {
                            U[cur * N2 + i2] += acc;
                            acc = 0.f;
                            cur = s;
                        }
                        acc += W[rl * NI + j];
                    }
                    U[cur * N2 + i2] += acc;
                }
                __syncthreads();   // the tile's buffers and W are free
            }
            cp_async_wait<0>();

            // ---- Ap = diag o p - U; pAp ------------------------------
            float pAp = 0.f, unused = 0.f;
            for (int i = lo + tid; i < hi; i += kThreads) {
                const float pi = p[i];
                const float api = dg[i] * pi - U[i];
                U[i] = api;
                pAp += pi * api;
            }
            block_sum2(pAp, unused, red);
            if (tid == 0) slot[0] = pAp;
        }
        grid.sync();
        if (active) {
            float v[1];
            pair_sum<1>(part, first, C, 0, v, red);
            const float pAp = v[0];
            if (pAp == 0.f || rz == 0.f) {   // breakdown: x stays as it is
                n_iter = step + 1;
                active = false;
                if (c == 0 && tid == 0) atomicAdd(finished, 1);
            } else {
                const float alpha = rz / pAp;
                float rz_new = 0.f;
                rr = 0.f;
                for (int i = lo + tid; i < hi; i += kThreads) {
                    x[i] += alpha * p[i];
                    const float ri = r[i] - alpha * U[i];
                    r[i] = ri;
                    rz_new += ri * (pc[i] * ri);
                    rr += ri * ri;
                }
                block_sum2(rz_new, rr, red);
                if (tid == 0) {
                    slot[1] = rz_new;
                    slot[2] = rr;
                }
            }
        }
        grid.sync();
        if (active) {
            float v[2];
            pair_sum<2>(part, first, C, 1, v, red);
            const float rz_new = v[0];
            rr = v[1];
            if (sqrtf(rr) < tolp) {
                n_iter = step + 1;
                active = false;
                if (c == 0 && tid == 0) atomicAdd(finished, 1);
            } else {
                const float beta = rz_new / rz;
                for (int i = lo + tid; i < hi; i += kThreads) {
                    p[i] = pc[i] * r[i] + beta * p[i];
                    U[i] = 0.f;
                }
                rz = rz_new;
            }
        }
        grid.sync();   // the next matvec gathers rows of p of other CTAs
    }

    for (int i = lo + tid; i < hi; i += kThreads)
        x_out[pair * N + i] = x[i];
    if (c == 0 && tid == 0) iters_out[pair] = n_iter;
}

}  // namespace

extern "C" {

// Dynamic shared memory the solve needs a block, in bytes, for a pair of
// these shapes under `limit` bytes; 0 when no tile shape fits.
size_t graphdot_pcg_stream_smem_bytes(int M1, int M2, int N1, int N2,
                                      int limit) {
    (void)N1;
    return make_plan(M1, M2, N2, static_cast<size_t>(limit)).smem;
}

const char *graphdot_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most CTAs of the solve that the current device holds at once (its
// cooperative grid), for pairs of these shapes, into *grid; returns a
// cudaError_t, cudaErrorInvalidValue when no tile shape fits `smem_limit`
// and cudaErrorNotSupported when the device has no cooperative launch.
int graphdot_pcg_stream_grid(int M1, int M2, int N1, int N2, int smem_limit,
                             int *grid) {
    (void)N1;
    *grid = 0;
    const Plan plan = make_plan(M1, M2, N2, static_cast<size_t>(smem_limit));
    if (plan.TR == 0) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                     dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            pcg_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(plan.smem));
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, pcg_stream_kernel, kThreads, plan.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    *grid = per_sm * sms;
    return static_cast<int>(cudaSuccess);
}

// Bytes of the workspace `graphdot_pcg_stream` takes for P pairs solved by
// cooperative grids of at most `grid` CTAs.
size_t graphdot_pcg_stream_workspace_bytes(int P, int M1, int M2, int N1,
                                           int N2, int grid) {
    return make_workspace(P, M1, M2, N1, N2, grid).bytes;
}

// Marks, sorts, permutes and solves P pairs on `stream`, C =
// `ctas_per_pair` CTAs a pair, in cooperative launches of at most
// floor(grid / C) pairs each (`grid` from graphdot_pcg_stream_grid).
// Returns the first cudaError_t that is not cudaSuccess: a launch that is
// refused is not retried. cudaErrorInvalidValue when no tile shape fits
// `smem_limit` or C < 1, cudaErrorCooperativeLaunchTooLarge when C >
// grid. `work` holds `graphdot_pcg_stream_workspace_bytes` bytes for the
// same P and grid, 256-byte aligned.
int graphdot_pcg_stream(const float *T, const int *esrc1, const int *edst1,
                        const int *esrc2, const int *edst2,
                        const float *diag, const float *precond,
                        const float *b, const float *tol, float *x,
                        int *iters, void *work, int P, int M1, int M2,
                        int N1, int N2, int maxiter, int ctas_per_pair,
                        int grid, int smem_limit, void *stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Plan plan = make_plan(M1, M2, N2, static_cast<size_t>(smem_limit));
    if (plan.TR == 0 || ctas_per_pair < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (ctas_per_pair > grid)
        return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const Workspace ws = make_workspace(P, M1, M2, N1, N2, grid);
    char *base = static_cast<char *>(work);
    auto at = [base](size_t offset) { return base + offset; };
    float *Tp = reinterpret_cast<float *>(at(ws.Tp));
    float *vec = reinterpret_cast<float *>(at(ws.vec));
    int *live1 = reinterpret_cast<int *>(at(ws.live1));
    int *live2 = reinterpret_cast<int *>(at(ws.live2));
    int *nlive = reinterpret_cast<int *>(at(ws.nlive));
    int *src1s = reinterpret_cast<int *>(at(ws.src1s));
    int *dst1s = reinterpret_cast<int *>(at(ws.dst1s));
    int *perm1 = reinterpret_cast<int *>(at(ws.perm1));
    int *rowptr1 = reinterpret_cast<int *>(at(ws.rowptr1));
    int *src2s = reinterpret_cast<int *>(at(ws.src2s));
    int *dst2s = reinterpret_cast<int *>(at(ws.dst2s));
    int *perm2 = reinterpret_cast<int *>(at(ws.perm2));
    int *rowptr2 = reinterpret_cast<int *>(at(ws.rowptr2));
    float *part = reinterpret_cast<float *>(at(ws.part));
    int *finished = reinterpret_cast<int *>(at(ws.finished));

    cudaError_t err = cudaSuccess;
    if (M2 > 0) {
        stream_live_cols_kernel<<<dim3((M2 + 255) / 256, P), 256, 0, s>>>(
            T, live2, M1, M2);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (M1 > 0) {
        stream_live_rows_kernel<<<dim3(M1, P), 256, 0, s>>>(T, live1, M1,
                                                            M2);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const size_t count_bytes = ((N1 > N2 ? N1 : N2) + 1) * sizeof(int);
    if (count_bytes > 48 * 1024) {
        err = cudaFuncSetAttribute(stream_sort_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(count_bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    stream_sort_kernel<<<P, kSortThreads, count_bytes, s>>>(
        esrc1, edst1, esrc2, edst2, live1, live2, nlive, src1s, dst1s, perm1,
        rowptr1, src2s, dst2s, perm2, rowptr2, M1, M2, N1, N2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (M1 > 0) {
        stream_permute_kernel<<<dim3(M1, P), 256, 0, s>>>(
            T, nlive, perm1, perm2, Tp, M1, M2, plan.ldT);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    err = cudaFuncSetAttribute(pcg_stream_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(plan.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int C = ctas_per_pair;
    const int per_launch = grid / C;
    for (int pair0 = 0; pair0 < P; pair0 += per_launch) {
        int n_pairs = P - pair0 < per_launch ? P - pair0 : per_launch;
        err = cudaMemsetAsync(finished, 0, sizeof(int), s);
        if (err != cudaSuccess) return static_cast<int>(err);
        Plan pl = plan;
        int M1v = M1, M2v = M2, N1v = N1, N2v = N2, maxiterv = maxiter;
        void *args[] = {
            &Tp, &nlive, &src1s, &dst1s, &rowptr1, &src2s, &dst2s,
            &rowptr2, &diag, &precond, &b, &tol, &vec, &part, &finished,
            &x, &iters, &pair0, &n_pairs, &C, &M1v, &M2v, &N1v, &N2v,
            &maxiterv, &pl};
        err = cudaLaunchCooperativeKernel(
            reinterpret_cast<const void *>(pcg_stream_kernel),
            dim3(n_pairs * C), dim3(kThreads), args, plan.smem, s);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
