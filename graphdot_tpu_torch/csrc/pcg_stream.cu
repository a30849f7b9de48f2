// Streaming Jacobi-PCG over marginalized-graph-kernel product systems whose
// pair fits neither a block nor a thread-block cluster (the protein contact
// maps), each pair spread over C CTAs of one cooperative grid, for NVIDIA
// Hopper (sm_90a).
//
// Replaces graphdot_tpu/ops/pallas_pcg.py::_pcg_stream_kernel (reached
// through `pallas_pcg_stream` and `_stream_solver`) for the pairs beyond a
// cluster; csrc/pcg_cluster.cu takes the mid-size ones. It solves
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
// Three kernels run on the stream, one after the other:
//
// 1. `stream_live_kernel` reads T once, 32 rows by 1024 columns a block,
//    and ORs both live flags: an edge is live when its row (side 1) or
//    column (side 2) of T holds a nonzero. The others (the batch's padding
//    edges, T = 0) add nothing and are left out of the solve. Flags are
//    set by stores of 1 over zeroed arrays, an integer OR whatever the
//    order. This is the only read of T before the first CG step.
// 2. `stream_sort_kernel`, a CTA a side of each pair: the stable counting
//    sort of csrc/edge_sort.cuh (shared with csrc/pcg_cluster.cu; warps
//    rank 32 edges at once with __match_any_sync, edge order kept within a
//    node) of each side's live edges by source, into sorted sources,
//    destinations, permutations and row pointers, its counts in shared
//    memory where they fit and in the workspace otherwise. Side 2's sorted
//    list is packed as (column of T, destination) in one 32-bit entry, the
//    column in the low cbits (16 where M2 and N2 fit 16 bits, else the bit
//    width of M2 - 1), and its live columns' span [lo, hi] is kept. No copy
//    of T is made.
// 3. `pcg_stream_kernel`, launched cooperatively with C CTAs per pair (C
//    chosen per launch by the caller), runs the whole PCG. CTA c of a pair
//    owns a contiguous range [a_c, a_{c+1}) of side-1 source nodes, cut at
//    the node where rowptr1[i] + i reaches c / C of L1 + N1, and the sorted
//    live rows of T whose source lies in it. The CG vectors (x, r, z, U,
//    and p twice) live in the workspace with rows padded to ldv (a multiple
//    of 4) floats.
//
// The matvec streams T in place. The CTA's rows go through a ring of NS
// >= 3 stages of R rows in shared memory. Warp 0 is the producer: for each
// stage its lanes copy one row each of T itself, row perm1[q], by one
// Hopper bulk copy (cp.async.bulk, the 1-D TMA) of the 16-byte-aligned
// span that covers the pair's live columns [lo, hi] (for any M2: where M2
// % 4 != 0 or T's base is not 16-byte aligned the copy starts up to 12
// bytes early and the row's offset s_r into it is kept), completed on the
// stage's `full` mbarrier with an expected byte count; and the rows of z
// and of the previous p that each row gathers from, by 16-byte
// cp.async.cg (through L2: other CTAs wrote them), counted on the same
// mbarrier. The 31 consumer warps wait on `full`, compute, and arrive on
// the stage's `empty` mbarrier, which the producer waits on before it
// refills the slot. Columns stay in T's order in shared memory: pass 1
// reaches side-2 node i2's live columns through its sorted list (the
// column and its destination, packed).
//
// A pair whose row does not fit three stages beside its rows of z and p
// takes a chunked plan: R = 1, and a stage is a chunk of CW columns of the
// live span (CW a multiple of 32, as wide as shared memory allows), so a
// row is nch = ceil(span / CW) stages. The producer stages the row's z and
// p beside each chunk while a chunk is at least as wide as they are, side
// 2's list staying in shared memory where it fits too (a list read from
// device memory puts an L2 load at the head of every product's chain);
// beyond that (N2 above about 4,400) z and p stay in device memory and the
// consumers read them through L2 (__ldcg), as the producer would have. A
// node's entries are in column order, so each lane keeps a cursor into its
// node's list from chunk to chunk, and the row's sum so far rides in the
// carry as an open segment does between stages.
//
// Layout of a stage's work: lane l of a warp sits on row l % R of the
// stage and on node l / R of a group of NG = 32 / R side-2 nodes (R = 32
// where a stage holds 32 rows: every lane on one node, with the same trip
// count and the same column index; at the protein contact maps' M = 3736
// only R = 4 rows of T fit a stage, and the R lanes of each node share its
// trip count and column index). Warp w takes node groups w, w + 31, ...
// in every stage, the nodes in order of live degree (`order2`, from the
// sort kernel) so that the groups a warp walks have lists of about one
// length; its per-node state needs no block barrier:
//   pass 1: W[r, i2] = sum_{k in node i2} T[perm1(r), col(k)]
//           * p[dst1(r), dst(k)], each lane down its node's list;
//   pass 2: a segmented inclusive scan over the stage's rows by side-1
//           source (rows of one source are consecutive), in a fixed tree
//           over the R lanes of a node; a segment's tail adds it to
//           U[source, i2], carrying an open segment to the next stage in
//           shared memory. Each U element is stored once a step, by one
//           lane, in a fixed order.
// T's row stride ldT in shared memory is a multiple of 4 floats (TMA's
// 16-byte alignment) and 4 mod 32: lanes on 32 rows at one column then
// meet 8 distinct banks, 4 a bank, the fewest any 16-byte-aligned stride
// allows (1 mod 32 would break the alignment); rows whose s_r differ, or
// the nodes' columns, spread them further. The stage's rows of z and p
// (stride ldz) follow the same rule.
//
// Two grid barriers a CG step (cooperative_groups grid.sync()):
//   A, after each CTA has put its part of pAp in its slot: pAp is summed
//     over the CTA's nodes from the matvec's own output, p (diag p - U),
//     in the same phase, so it needs no barrier of its own;
//   B, after alpha's x and r updates and z = precond r, with the rz and
//     r.r parts.
// After B each CTA forms its own rows of p_{k+1} = z + beta p_k (fmaf) in
// the other p buffer, and the next matvec's producer copies rows of z and
// of p_k for the rows it gathers: the consumers form p_{k+1} there by the
// same fmaf, so they need no third barrier after p is written. After a
// barrier every CTA of a pair adds the pair's C partials in CTA order (one
// warp, lanes in a fixed order, then a butterfly), so all of them get
// bit-identical alpha, beta and stop decisions, and the result is
// deterministic for a given C. Every CTA of the grid meets every barrier;
// the loop ends for the whole grid when the count of finished pairs (in
// the workspace, raised only between barriers A and B and read only at the
// top of a step) reaches the grid's pair count, or at maxiter.
//
// Precision: the TPU kernel computes in split2 (two bf16 MXU passes); this
// kernel computes in f32 with FMA, which is at least as accurate. Block
// sums are deterministic: warp butterflies, then the warp sums in a fixed
// order, with no float atomics.
//
// What bounds it: the bytes are T once for the flags, then its live part
// once a CG step (4 L1 L2 bytes a pair, 37.7 MB at the contact maps' M =
// 3736; 21 pairs exceed the 50 MB L2): the streaming floor. On an H100 a
// step of the 21-pair chunk costs about 3x the floor's step, and the
// consumers bind, not the stages' bytes. A product
// costs four shared-memory loads (the list entry, then T, z and p) in a
// dependent chain, and at M = 3736 a stage holds only R = 4 rows, so every
// node's list is walked once per 4 rows. More consumer warps helped (1024
// threads beat 512 and 256); so did the degree order, a little; stages of
// 32 rows over column tiles of T were slower (a node's entries spread over
// every tile, so each tile visits nearly every node). Shared memory holds
// NS stages of R rows of T (ldT floats), z and p (ldz floats each), side
// 2's sorted list where it fits (else it is read from the workspace
// through L1), its row pointers, the node order and the carries: the
// largest R whose 3 stages fit, which holds pairs with ldT + 2 ldz up to
// about 19,000 floats (a categorical contact map of about 1,100 residues).
// Beyond that the chunked plans run any M2 (up to 2^(32 - bit width of N2
// - 1) for the list's entries) with N2 up to about 14,000 nodes: their
// shared memory is 3 chunks (with z and p up to N2 of about 4,400) plus
// four words a side-2 node (row pointers, order, carries, cursors). The
// plan that reads z and p from L2 pays two scattered L2 loads a product.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "edge_sort.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kConsumers = kWarps - 1;      // warp 0 produces
constexpr int kSortThreads = 512;
constexpr int kLiveThreads = 256;
constexpr int kLiveCols = 4 * kLiveThreads; // columns of a live-flag block
constexpr int kLiveRows = 32;               // rows of a live-flag block
constexpr int kSlots = 3;                   // pAp, rz, r.r of a CTA
constexpr int kVectors = 6;                 // x, r, z, U, p (two)
// arrivals that complete a stage: the producer's expect_tx, and one
// cp.async arrival of each producer lane
constexpr unsigned kFullArrivals = 33;

__host__ __device__ inline size_t round_up(size_t a, size_t b) {
    return (a + b - 1) / b * b;
}

// The solve's shared-memory plan, in 4-byte words from the block's base:
// the mbarriers (full[NS], empty[NS]) first, then the ring of NS stages
// (T: R x ldT, then with vec = 1 z: R x ldz and p: R x ldz), side 2's
// sorted list (lists = 1), its row pointers, its nodes by degree (N2), the
// carries (N2), the list cursors (N2, chunked plans only) and the
// block-sum scratch. CW = 0: a stage holds whole rows of the live span;
// else R = 1 and a stage holds CW columns of it (a chunk). vec: z and p
// are staged (else read from device memory). cbits: the bits
// of a list entry that hold the column, the rest hold the destination.
// R = 0 and smem = 0 when no plan fits.
struct Plan {
    int R, NS, ldT, ldv, ldz, lists, vec, CW, cbits;
    int stage, ring, list, rowptr2, order2, carry, cur, red;
    size_t smem;
};

__host__ __device__ inline int bit_width(int v) {   // bits of v >= 0
    int b = 0;
    while (v >> b) ++b;
    return b;
}

// The plan's offsets after the ring, for NS stages of `stage` words; the
// total in P.smem. Returns whether it fits `limit` bytes.
__host__ __device__ inline bool lay_out(Plan &P, int NS, size_t stage,
                                        int lists, int M2, int N2,
                                        size_t limit) {
    size_t o = 4 * static_cast<size_t>(NS);   // mbarriers
    P.ring = static_cast<int>(o);
    o += NS * stage;
    P.list = static_cast<int>(o);
    if (lists) o += round_up(M2, 4);
    P.rowptr2 = static_cast<int>(o);
    o += round_up(N2 + 1, 4);
    P.order2 = static_cast<int>(o);
    o += round_up(N2, 4);
    P.carry = static_cast<int>(o);
    o += round_up(N2, 4);
    P.cur = static_cast<int>(o);
    if (P.CW) o += round_up(N2, 4);
    P.red = static_cast<int>(o);
    o += round_up(2 * kWarps + 4, 4);
    P.NS = NS;
    P.lists = lists;
    P.stage = static_cast<int>(stage);
    P.smem = o * sizeof(float);
    return P.smem <= limit;
}

// The first plan that fits `limit` bytes, in this order: whole rows with z
// and p staged beside them, the largest R of 32, 16, ..., 1 with 4 or 3
// stages and side 2's list in shared memory, then without it; else chunks
// of a row (R = 1, 3 stages) with z and p staged beside them and the list
// in shared memory, then in device memory, then z and p read from device
// memory too.
__host__ __device__ inline Plan make_plan(int M2, int N2, size_t limit) {
    Plan P = {};
    // 16 wherever both fit (every whole-row plan: the consumers' hot loop
    // then shifts and masks by constants), else the bit width of M2 - 1
    P.cbits = M2 <= 65536 && N2 <= 65536 ? 16
                                         : bit_width(M2 > 1 ? M2 - 1 : 1);
    if (P.cbits + bit_width(N2 > 1 ? N2 - 1 : 1) > 32) return P;
    P.ldv = static_cast<int>(round_up(N2 > 0 ? N2 : 1, 4));
    P.ldz = P.ldv;
    while (P.ldz % 32 != 4) P.ldz += 4;
    P.ldT = static_cast<int>(round_up((M2 > 0 ? M2 : 1) + 3, 4));
    while (P.ldT % 32 != 4) P.ldT += 4;
    P.vec = 1;
    const int opts[4][2] = {{4, 1}, {3, 1}, {4, 0}, {3, 0}};   // NS, lists
    for (int R = 32; R >= 1; R >>= 1) {
        for (const auto &opt : opts) {
            const size_t stage =
                static_cast<size_t>(R) * (P.ldT + 2 * P.ldz);
            if (lay_out(P, opt[0], stage, opt[1], M2, N2, limit)) {
                P.R = R;
                return P;
            }
        }
    }
    // chunks of a row (R = 1, 3 stages) as wide as the words left for the
    // ring allow, the width 4 mod 32 (as ldT above): z and p staged beside
    // a chunk while it is at least as wide as their rows, first with side
    // 2's list in shared memory, then without; else z and p read from
    // device memory with a chunk of at least 36
    P.CW = 1;   // lay out the cursors
    const size_t words = limit / sizeof(float);
    const int copts[3][2] = {{1, 1}, {1, 0}, {0, 0}};   // vec, lists
    for (const auto &copt : copts) {
        const int vec = copt[0], lists = copt[1];
        const size_t zp = vec ? 2 * static_cast<size_t>(P.ldz) : 0;
        lay_out(P, 3, 0, lists, M2, N2, limit);
        const size_t fixed = P.smem / sizeof(float) + 3 * zp;
        size_t room = words > fixed ? (words - fixed) / 3 : 0;
        if (room > static_cast<size_t>(P.ldT)) room = P.ldT;
        int ldT = static_cast<int>(room);
        while (ldT > 0 && ldT % 32 != 4) --ldT;
        if (ldT < (vec && P.ldz > 36 ? P.ldz : 36)) continue;
        P.vec = vec;
        P.ldT = ldT;
        P.CW = ldT - 4;   // a multiple of 32: a chunk's copy starts <= 12
                          // bytes early and ends on a 16-byte boundary
        if (!lay_out(P, 3, ldT + zp, lists, M2, N2, limit)) return Plan{};
        P.R = 1;
        return P;
    }
    return Plan{};
}

// Workspace layout: byte offsets into the caller's buffer, 256-aligned.
// The sort's counts (hist_ints a side of a pair) take shared memory where
// they fit (hist_in_smem) and the workspace only otherwise.
struct Workspace {
    size_t vec, live1, live2, meta, src1s, dst1s, perm1, rowptr1, perm2,
        dst2s, list2, rowptr2, order2, hist, part, finished;
    size_t hist_ints;
    int hist_in_smem;
    size_t bytes;
};

// For P pairs solved by grids of at most `grid` CTAs, the sort under
// `smem_limit` bytes of shared memory.
inline Workspace make_workspace(int P, int M1, int M2, int N1, int N2,
                                int grid, int smem_limit) {
    Workspace W;
    const size_t p = static_cast<size_t>(P);
    const size_t ldv = round_up(N2 > 0 ? N2 : 1, 4);
    const size_t h1 = static_cast<size_t>((M1 + 31) / 32) * N1;
    const size_t h2 = static_cast<size_t>((M2 + 31) / 32) * N2;
    W.hist_ints = h1 > h2 ? h1 : h2;
    // the sort kernel's static shared memory takes the rest
    W.hist_in_smem = W.hist_ints * sizeof(int) + 64 <=
                     static_cast<size_t>(smem_limit);
    size_t o = 0;
    auto take = [&o](size_t bytes) {
        const size_t at = o;
        o = round_up(o + bytes, 256);
        return at;
    };
    W.vec = take(p * kVectors * N1 * ldv * sizeof(float));
    W.live1 = take(p * M1 * sizeof(int));
    W.live2 = take(p * M2 * sizeof(int));   // right after live1: one memset
    W.meta = take(p * 4 * sizeof(int));     // L1, L2, lo, hi
    W.src1s = take(p * M1 * sizeof(int));
    W.dst1s = take(p * M1 * sizeof(int));
    W.perm1 = take(p * M1 * sizeof(int));
    W.rowptr1 = take(p * (N1 + 1) * sizeof(int));
    W.perm2 = take(p * M2 * sizeof(int));
    W.dst2s = take(p * M2 * sizeof(int));
    W.list2 = take(p * M2 * sizeof(unsigned));
    W.rowptr2 = take(p * (N2 + 1) * sizeof(int));
    W.order2 = take(p * N2 * sizeof(int));
    W.hist = take(W.hist_in_smem ? 0 : p * 2 * W.hist_ints * sizeof(int));
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

// live1[pair, e1] = 1 when row e1 of T holds a nonzero, live2[pair, e2] =
// 1 when column e2 does; both arrays zeroed before. Grid: (ceil(M2 /
// kLiveCols), ceil(M1 / kLiveRows), P). Thread t reads columns t + 256 j
// (j < 4) of the block's rows, so each warp load is 128 contiguous bytes.
__global__ void __launch_bounds__(kLiveThreads)
stream_live_kernel(const float *__restrict__ T, int *__restrict__ live1,
                   int *__restrict__ live2, int M1, int M2) {
    __shared__ int rowflag[kLiveRows];
    const size_t pair = blockIdx.z;
    const int c0 = blockIdx.x * kLiveCols + threadIdx.x;
    const int r0 = blockIdx.y * kLiveRows;
    const int rows = min(kLiveRows, M1 - r0);
    if (threadIdx.x < kLiveRows) rowflag[threadIdx.x] = 0;
    __syncthreads();
    const float *base = T + (pair * M1 + r0) * M2;
    int col[4] = {0, 0, 0, 0};
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
        const float *row = base + static_cast<size_t>(i) * M2;
        int any = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = c0 + j * kLiveThreads;
            if (c < M2) {
                const int nz = row[c] != 0.f;
                col[j] |= nz;
                any |= nz;
            }
        }
        if (__any_sync(0xffffffffu, any) && (threadIdx.x & 31) == 0)
            rowflag[i] = 1;
    }
    __syncthreads();
    if (threadIdx.x < rows && rowflag[threadIdx.x])
        live1[pair * M1 + r0 + threadIdx.x] = 1;
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (col[j]) live2[pair * M2 + c0 + j * kLiveThreads] = 1;
}

// One CTA a side of a pair: blockIdx.x 0 sorts side 1, 1 sorts side 2.
// meta[pair] = (L1, L2, lo, hi): the live counts and side 2's live span
// (lo = 0, hi = -1 when no column is live); side 2's sorted list as
// entries (column of T) | (destination << cbits). order2 lists side 2's
// nodes by live degree, highest first, ties in node order: the order in
// which the solve's warps take them, so that the nodes a warp walks at once
// have lists of about one length.
__global__ void __launch_bounds__(kSortThreads)
stream_sort_kernel(const int *__restrict__ esrc1,
                   const int *__restrict__ edst1,
                   const int *__restrict__ esrc2,
                   const int *__restrict__ edst2,
                   const int *__restrict__ live1,
                   const int *__restrict__ live2, int *hist_all,
                   size_t hist_ints, int hist_in_smem, int *meta,
                   int *src1s, int *dst1s, int *perm1, int *rowptr1,
                   int *perm2, int *dst2s, unsigned *list2, int *rowptr2,
                   int *order2, int M1, int M2, int N1, int N2,
                   int cbits) {
    extern __shared__ int hist_smem[];
    __shared__ int span[2];
    const size_t pair = blockIdx.y;
    int *hist = hist_in_smem ? hist_smem
                             : hist_all + (pair * 2 + blockIdx.x) * hist_ints;
    if (blockIdx.x == 0) {
        int *rp = rowptr1 + pair * (N1 + 1);
        graphdot_sort::sort_side<kSortThreads>(
            esrc1 + pair * M1, edst1 + pair * M1, live1 + pair * M1, M1, N1,
            rp, src1s + pair * M1, dst1s + pair * M1, perm1 + pair * M1,
            nullptr, hist);
        if (threadIdx.x == 0) meta[4 * pair] = rp[N1];
        return;
    }
    int *rp = rowptr2 + pair * (N2 + 1);
    int *pm = perm2 + pair * M2;
    int *ds = dst2s + pair * M2;
    const int *lv = live2 + pair * M2;
    if (threadIdx.x == 0) {
        span[0] = INT_MAX;
        span[1] = -1;
    }
    graphdot_sort::sort_side<kSortThreads>(esrc2 + pair * M2,
                                           edst2 + pair * M2, lv, M2, N2,
                                           rp, nullptr, ds, pm, nullptr,
                                           hist);
    const int L2 = rp[N2];
    unsigned *lst = list2 + pair * M2;
    for (int q = threadIdx.x; q < L2; q += kSortThreads)
        lst[q] = static_cast<unsigned>(pm[q]) |
                 (static_cast<unsigned>(ds[q]) << cbits);
    int *order = order2 + pair * N2;
    for (int i = threadIdx.x; i < N2; i += kSortThreads) {
        const int d = rp[i + 1] - rp[i];
        int rank = 0;
        for (int j = 0; j < N2; ++j) {
            const int dj = rp[j + 1] - rp[j];
            rank += dj > d || (dj == d && j < i);
        }
        order[rank] = i;
    }
    int lo = INT_MAX, hi = -1;
    for (int e = threadIdx.x; e < M2; e += kSortThreads) {
        if (lv[e]) {
            lo = min(lo, e);
            hi = max(hi, e);
        }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if ((threadIdx.x & 31) == 0) {
        atomicMin(span, lo);
        atomicMax(span + 1, hi);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        meta[4 * pair + 1] = L2;
        meta[4 * pair + 2] = span[1] >= 0 ? span[0] : 0;
        meta[4 * pair + 3] = span[1];
    }
}

__device__ __forceinline__ unsigned smem_u32(const void *p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t *bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_u32(bar)),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t *bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra.uni DONE;\n"
        "bra.uni LAB_WAIT;\n"
        "DONE:\n"
        "}\n" ::"r"(smem_u32(bar)),
        "r"(parity)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t *bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t *bar, unsigned bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
}

// One 1-D TMA copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device memory to shared memory, completed on `bar`.
__device__ __forceinline__ void bulk_copy(void *dst, const void *src,
                                          unsigned bytes, uint64_t *bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void cp_async16(void *dst, const void *src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}

// An arrival on `bar` when this thread's earlier cp.async copies are done
// (counted against the mbarrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t *bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(smem_u32(bar))
                 : "memory");
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

struct Problem {
    const float *T;
    const int *meta, *src1s, *dst1s, *perm1, *rowptr1, *rowptr2, *order2;
    const unsigned *list2;
    const float *diag, *precond, *b, *tol;
    float *vec, *part;
    int *finished;
    float *x;
    int *iters;
    int pair0, n_pairs, C, M1, M2, N1, N2, maxiter;
};

// What the producer and the consumers of one CTA share for a matvec.
// A stage is chunk j of the rows [qs, qs + R) of the CTA's sorted rows:
// columns [lo + j CW, lo + (j + 1) CW) of the live span, nch chunks a row
// (CW = span and nch = 1 for plans of whole rows).
struct Stream {
    const float *T;      // the pair's T
    const int *perm1, *src1s, *dst1s;
    int M2, lo, span, CW, nch, R0, R1, n_st, gstage;
};

// Stage st of a matvec: its first sorted row, its rows, its chunk, and the
// chunk's first column and column count.
struct StageAt {
    int qs, nrows, j, c0, cnt;
};

__device__ __forceinline__ StageAt stage_at(const Stream &S, int R, int st) {
    StageAt a;
    const int blk = st / S.nch;
    a.j = st - blk * S.nch;
    a.qs = S.R0 + blk * R;
    a.nrows = min(R, S.R1 - a.qs);
    a.c0 = S.lo + a.j * S.CW;
    a.cnt = min(S.CW, S.span - a.j * S.CW);
    return a;
}

// Byte address in T of row perm1[q], column c.
__device__ __forceinline__ size_t row_at(const Stream &S, int q, int c) {
    return reinterpret_cast<size_t>(
        S.T + static_cast<size_t>(__ldg(S.perm1 + q)) * S.M2 + c);
}

// Warp 0: the stages of one matvec, in order. Lane l copies row l of the
// stage (the stage's columns of row perm1[q] of T, by one bulk copy), then,
// where the plan stages them (kStaged), all lanes copy the stage's rows of
// z and of the previous p (16 bytes a cp.async); every lane arrives when
// its copies are done.
template <bool kStaged>
__device__ void produce(const Plan &pl, const Stream &S, float *ring,
                        uint64_t *full, uint64_t *empty, const float *z,
                        const float *pprev) {
    const int lane = threadIdx.x & 31;
    const int R = pl.R, ldv = pl.ldv, ldz = pl.ldz, chunks = pl.ldv >> 2;
    for (int st = 0; st < S.n_st; ++st) {
        const int g = S.gstage + st, slot = g % pl.NS;
        const unsigned parity = (g / pl.NS) & 1;
        const StageAt sa = stage_at(S, R, st);
        unsigned bytes = 0;
        const char *from = nullptr;
        int jrow = 0;
        if (lane < sa.nrows) {
            const int q = sa.qs + lane;
            const size_t at = row_at(S, q, sa.c0);
            from = reinterpret_cast<const char *>(at & ~size_t(15));
            bytes = static_cast<unsigned>(
                round_up((at & 15) + static_cast<size_t>(sa.cnt) * 4, 16));
            if (kStaged) jrow = __ldg(S.dst1s + q);
        }
        unsigned total = bytes;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            total += __shfl_xor_sync(0xffffffffu, total, o);
        mbar_wait(empty + slot, parity ^ 1);
        float *Ts = ring + static_cast<size_t>(slot) * pl.stage;
        if (lane == 0) mbar_expect(full + slot, total);
        __syncwarp();
        if (lane < sa.nrows) bulk_copy(Ts + lane * pl.ldT, from, bytes,
                                       full + slot);
        if (kStaged) {
            float *Zs = Ts + R * pl.ldT;
            float *Ps = Zs + R * ldz;
            for (int rr = 0; rr < sa.nrows; ++rr) {
                const size_t j = static_cast<size_t>(
                                     __shfl_sync(0xffffffffu, jrow, rr)) *
                                 ldv;
                for (int k = lane; k < chunks; k += 32) {
                    cp_async16(Zs + rr * ldz + 4 * k, z + j + 4 * k);
                    cp_async16(Ps + rr * ldz + 4 * k, pprev + j + 4 * k);
                }
            }
        }
        cp_async_arrive(full + slot);
    }
}

// Consumer warp cw (of kConsumers): passes 1 and 2 of its side-2 nodes
// over every stage of one matvec, storing U of the CTA's source nodes. Lane
// l sits on row l % R of the stage and node l / R of a group of NG = 32 / R
// nodes, the groups taken in order2's order (nodes by degree); the warp
// takes the groups cw, cw + kConsumers, ..., the same nodes in every stage.
// A chunked plan (kChunked, R = 1) walks a node's list a chunk at a time: a
// node's entries are in column order (the sort keeps edge order within a
// node), so a chunk takes them from the node's cursor up to its last
// column, and the row's sum so far rides in the carry from chunk to chunk.
// !kStaged: z and p are read from device memory through L2.
template <bool kSmemList, bool kStaged, bool kChunked>
__device__ __forceinline__ void consume(const Plan &pl, const Stream &S,
                                        const float *ring, uint64_t *full,
                                        uint64_t *empty,
                                        const unsigned *list,
                                        const int *rowptr2,
                                        const int *order2, float *carry,
                                        int *cur, float *U, const float *z,
                                        const float *pprev, float beta,
                                        int N2, int cw) {
    const int lane = threadIdx.x & 31;
    const int R = pl.R, NG = 32 / R, ldT = pl.ldT, ldv = pl.ldv,
              ldz = pl.ldz, cb = kChunked ? pl.cbits : 16;
    const unsigned cmask = (1u << cb) - 1u;
    const int r = lane % R, u = lane / R;
    int prev_last = -2;
    for (int st = 0; st < S.n_st; ++st) {
        const int g = S.gstage + st, slot = g % pl.NS;
        const unsigned parity = (g / pl.NS) & 1;
        const StageAt sa = stage_at(S, R, st);
        const int nrows = sa.nrows;
        const bool valid = r < nrows;
        int src = -1, rbase = 0;
        size_t jrow = 0;
        if (valid) {
            const int q = sa.qs + r;
            const size_t at = row_at(S, q, sa.c0);
            rbase = r * ldT + static_cast<int>((at & 15) >> 2) - sa.c0;
            src = __ldg(S.src1s + q);
            if (!kStaged)
                jrow = static_cast<size_t>(__ldg(S.dst1s + q)) * ldv;
        }
        const int next_src = sa.qs + nrows < S.R1
                                 ? __ldg(S.src1s + sa.qs + nrows)
                                 : -3;
        // the stage's segments: rows of one source are consecutive; ss is
        // the first row of this row's segment
        const int up = __shfl_up_sync(0xffffffffu, src, 1, R);
        int ss = (r == 0 || src != up) ? r : 0;
        for (int d = 1; d < R; d <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, ss, d, R);
            if (r >= d) ss = max(ss, t);
        }
        const int down = __shfl_down_sync(0xffffffffu, src, 1, R);
        const int last = nrows - 1;
        const bool tail = valid && (r == last || src != down);
        const int first_src = __shfl_sync(0xffffffffu, src, 0);
        const int last_src = __shfl_sync(0xffffffffu, src, last);
        // carried in: a later chunk of the row, or the segment open at the
        // end of the stage before; carried onward likewise
        const bool cont_in = sa.j > 0 || first_src == prev_last;
        const bool cont_out = sa.j < S.nch - 1 || last_src == next_src;
        prev_last = last_src;
        mbar_wait(full + slot, parity);
        const float *Ts = ring + static_cast<size_t>(slot) * pl.stage;
        const float *Zs = kStaged ? Ts + R * ldT + r * ldz : z + jrow;
        const float *Ps = kStaged ? Zs + R * ldz : pprev + jrow;
        const int c1 = sa.c0 + sa.cnt;   // the chunk's end column
        for (int g0 = cw; g0 * NG < N2; g0 += kConsumers) {
            const int at = g0 * NG + u;
            const bool has = at < N2;
            const int i2 = has ? order2[at] : 0;
            const float cin = has ? carry[i2] : 0.f;
            int k = has ? (kChunked && sa.j > 0 ? cur[i2] : rowptr2[i2]) : 0;
            const int k1 = has && valid ? rowptr2[i2 + 1] : 0;
            // each lane down its node's list
            float acc = 0.f;
            if (!kChunked) {
#pragma unroll 2
                for (; k < k1; ++k) {
                    const unsigned e = list[k];
                    const int d2 = static_cast<int>(e >> cb);
                    const float pv = fmaf(beta, Ps[d2], Zs[d2]);
                    acc = fmaf(Ts[rbase + static_cast<int>(e & cmask)], pv,
                               acc);
                }
            } else {
                for (; k < k1; ++k) {
                    const unsigned e = list[k];
                    const int col = static_cast<int>(e & cmask);
                    if (col >= c1) break;
                    const int d2 = static_cast<int>(e >> cb);
                    const float pv =
                        kStaged ? fmaf(beta, Ps[d2], Zs[d2])
                                : fmaf(beta, __ldcg(Ps + d2), __ldcg(Zs + d2));
                    acc = fmaf(Ts[rbase + col], pv, acc);
                }
                if (has && S.nch > 1) cur[i2] = k;
            }
            for (int d = 1; d < R; d <<= 1) {
                const float t = __shfl_up_sync(0xffffffffu, acc, d, R);
                if (r - d >= ss) acc += t;
            }
            __syncwarp();   // every lane has read the carry
            if (tail && has) {
                const float total = (ss == 0 && cont_in) ? cin + acc : acc;
                if (r == last && cont_out)
                    carry[i2] = total;
                else
                    U[static_cast<size_t>(src) * ldv + i2] = total;
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + slot);
    }
}

// One cooperative grid of n_pairs * C CTAs: CTA blockIdx.x works on pair
// pair0 + blockIdx.x / C, as its part blockIdx.x % C. kSmemList: side 2's
// sorted list is in shared memory (Plan::lists); kStaged: rows of z and p
// are staged beside T's (Plan::vec); kChunked: rows of T come in chunks
// (Plan::CW).
template <bool kSmemList, bool kStaged, bool kChunked>
__global__ void __launch_bounds__(kThreads, 1)
pcg_stream_kernel(Problem P, Plan pl) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ __align__(16) float smem[];
    uint64_t *full = reinterpret_cast<uint64_t *>(smem);
    uint64_t *empty = full + pl.NS;
    float *ring = smem + pl.ring;
    int *rowptr2 = reinterpret_cast<int *>(smem + pl.rowptr2);
    float *carry = smem + pl.carry;
    int *cur = reinterpret_cast<int *>(smem + pl.cur);
    float *red = smem + pl.red;

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int C = P.C;
    const int local = blockIdx.x / C;
    const int c = blockIdx.x - local * C;
    const int first = local * C;   // the pair's first CTA
    const size_t pair = P.pair0 + local;
    const int M1 = P.M1, M2 = P.M2, N1 = P.N1, N2 = P.N2, ldv = pl.ldv;
    const int L1 = P.meta[4 * pair];
    const int L2 = P.meta[4 * pair + 1];
    const int lo = P.meta[4 * pair + 2];
    const int span = L2 > 0 ? P.meta[4 * pair + 3] - lo + 1 : 0;
    const int *rowptr1 = P.rowptr1 + pair * (N1 + 1);
    const unsigned *list =
        kSmemList ? reinterpret_cast<const unsigned *>(smem + pl.list)
                  : P.list2 + pair * M2;
    // CG vectors in device memory, rows of ldv floats. The CTA writes the
    // rows of its source nodes; the matvec's producer copies rows of z and
    // p that other CTAs wrote through L2 only
    const size_t NV = static_cast<size_t>(N1) * ldv;
    float *x = P.vec + pair * kVectors * NV;
    float *r = x + NV;
    float *z = r + NV;
    float *U = z + NV;   // the matvec's off-diagonal sums
    float *p0 = U + NV;  // p_k of even steps
    float *p1 = p0 + NV;

    if (tid == 0) {
        for (int s = 0; s < pl.NS; ++s) {
            mbar_init(full + s, kFullArrivals);
            mbar_init(empty + s, kConsumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        red[0] = __int_as_float(range_start(rowptr1, L1, N1, c, C));
        red[1] = __int_as_float(range_start(rowptr1, L1, N1, c + 1, C));
    }
    int *order2 = reinterpret_cast<int *>(smem + pl.order2);
    for (int i = tid; i <= N2; i += kThreads)
        rowptr2[i] = P.rowptr2[pair * (N2 + 1) + i];
    for (int i = tid; i < N2; i += kThreads)
        order2[i] = P.order2[pair * N2 + i];
    if (kSmemList) {
        unsigned *ls = reinterpret_cast<unsigned *>(smem + pl.list);
        for (int q = tid; q < L2; q += kThreads) ls[q] = P.list2[pair * M2 + q];
    }
    __syncthreads();
    const int a = __float_as_int(red[0]);
    const int a_next = __float_as_int(red[1]);
    __syncthreads();
    Stream S;
    S.T = P.T + pair * M1 * M2;
    S.perm1 = P.perm1 + pair * M1;
    S.src1s = P.src1s + pair * M1;
    S.dst1s = P.dst1s + pair * M1;
    S.M2 = M2;
    S.lo = lo;
    S.span = span;
    S.CW = pl.CW ? pl.CW : max(span, 1);
    S.nch = span > 0 ? (span + S.CW - 1) / S.CW : 1;
    S.R0 = rowptr1[a];   // the CTA's sorted rows of T
    S.R1 = rowptr1[a_next];
    S.n_st = (S.R1 - S.R0 + pl.R - 1) / pl.R * S.nch;
    S.gstage = 0;
    float *slot = P.part + blockIdx.x * kSlots;

    // the CTA's product nodes: rows [a, a_next) of N2
    const int n_own = (a_next - a) * N2;
    const float *dg = P.diag + pair * N1 * N2;
    const float *pc = P.precond + pair * N1 * N2;
    const float *bg = P.b + pair * N1 * N2;
    float rz = 0.f, rr = 0.f;
    for (int i = tid; i < n_own; i += kThreads) {
        const int i1 = a + i / N2;
        const int i2 = i - (i1 - a) * N2;
        const int gi = i1 * N2 + i2;
        const size_t v = static_cast<size_t>(i1) * ldv + i2;
        const float bi = bg[gi];
        const float zi = pc[gi] * bi;
        const float pi = fmaf(0.f, 0.f, zi);   // as the consumers form it
        x[v] = 0.f;
        r[v] = bi;
        z[v] = zi;
        p0[v] = pi;
        p1[v] = 0.f;
        U[v] = 0.f;
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
        pair_sum<2>(P.part, first, C, 1, v, red);
        rz = v[0];
        rr = v[1];
    }
    const float tolp = P.tol[pair];
    bool active = !(sqrtf(rr) < tolp);
    int n_iter = active ? P.maxiter : 0;
    // the pair's stop, counted by its first CTA between barriers A and B
    bool pending = !active && c == 0 && tid == 0;
    float beta = 0.f;   // beta of the step before (0: p_{-1} = 0)

    for (int step = 0; step < P.maxiter; ++step) {
        __syncthreads();   // p of this step is written
        // no CTA raises the count between barrier B and barrier A
        if (*reinterpret_cast<volatile int *>(P.finished) == P.n_pairs) break;
        float *pk = (step & 1) ? p1 : p0;      // p_k, formed
        float *pprev = (step & 1) ? p0 : p1;   // p_{k-1}, then p_{k+1}
        if (active) {
            // ---- U = the off-diagonal sums; pAp from them ----------------
            if (S.n_st > 0) {
                if (warp == 0)
                    produce<kStaged>(pl, S, ring, full, empty, z, pprev);
                else
                    consume<kSmemList, kStaged, kChunked>(
                        pl, S, ring, full, empty, list, rowptr2, order2,
                        carry, cur, U, z, pprev, beta, N2, warp - 1);
                S.gstage += S.n_st;
            }
            __syncthreads();   // U is stored
            float pAp = 0.f, unused = 0.f;
            for (int i = tid; i < n_own; i += kThreads) {
                const int i1 = a + i / N2;
                const int i2 = i - (i1 - a) * N2;
                const size_t v = static_cast<size_t>(i1) * ldv + i2;
                const float pi = pk[v];
                pAp += pi * (dg[i1 * N2 + i2] * pi - U[v]);
            }
            block_sum2(pAp, unused, red);
            if (tid == 0) slot[0] = pAp;
        }
        grid.sync();   // A
        if (pending) {
            atomicAdd(P.finished, 1);
            pending = false;
        }
        if (active) {
            float v[1];
            pair_sum<1>(P.part, first, C, 0, v, red);
            const float pAp = v[0];
            if (pAp == 0.f || rz == 0.f) {   // breakdown: x stays as it is
                n_iter = step + 1;
                active = false;
                if (c == 0 && tid == 0) atomicAdd(P.finished, 1);
            } else {
                const float alpha = rz / pAp;
                float rz_new = 0.f;
                rr = 0.f;
                for (int i = tid; i < n_own; i += kThreads) {
                    const int i1 = a + i / N2;
                    const int i2 = i - (i1 - a) * N2;
                    const int gi = i1 * N2 + i2;
                    const size_t v = static_cast<size_t>(i1) * ldv + i2;
                    const float pi = pk[v];
                    const float api = dg[gi] * pi - U[v];
                    x[v] += alpha * pi;
                    const float ri = r[v] - alpha * api;
                    r[v] = ri;
                    const float zi = pc[gi] * ri;
                    z[v] = zi;
                    rz_new += ri * zi;
                    rr += ri * ri;
                }
                block_sum2(rz_new, rr, red);
                if (tid == 0) {
                    slot[1] = rz_new;
                    slot[2] = rr;
                }
            }
        }
        grid.sync();   // B: z and the rz, r.r parts of every CTA
        if (active) {
            float v[2];
            pair_sum<2>(P.part, first, C, 1, v, red);
            const float rz_new = v[0];
            rr = v[1];
            if (sqrtf(rr) < tolp) {
                n_iter = step + 1;
                active = false;
                pending = c == 0 && tid == 0;
            } else {
                beta = rz_new / rz;
                for (int i = tid; i < n_own; i += kThreads) {
                    const int i1 = a + i / N2;
                    const size_t v = static_cast<size_t>(i1) * ldv +
                                     (i - (i1 - a) * N2);
                    pprev[v] = fmaf(beta, pk[v], z[v]);
                }
                rz = rz_new;
            }
        }
    }

    for (int i = tid; i < n_own; i += kThreads) {
        const int i1 = a + i / N2;
        const int i2 = i - (i1 - a) * N2;
        P.x[pair * N1 * N2 + i1 * N2 + i2] =
            x[static_cast<size_t>(i1) * ldv + i2];
    }
    if (c == 0 && tid == 0) P.iters[pair] = n_iter;
}

using SolveFn = void (*)(Problem, Plan);

// The solve's instance for a plan: whole rows or chunks, with side 2's
// list in shared or device memory, and chunks with z and p staged or not.
SolveFn solve_kernel(const Plan &plan) {
    if (plan.CW)
        return plan.lists  ? pcg_stream_kernel<true, true, true>
               : plan.vec ? pcg_stream_kernel<false, true, true>
                          : pcg_stream_kernel<false, false, true>;
    return plan.lists ? pcg_stream_kernel<true, true, false>
                      : pcg_stream_kernel<false, true, false>;
}

}  // namespace

extern "C" {

const char *graphdot_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most CTAs of the solve that the current device holds at once (its
// cooperative grid), for pairs of these shapes, into *grid; returns a
// cudaError_t, cudaErrorInvalidValue when no plan fits `smem_limit` and
// cudaErrorNotSupported when the device has no cooperative launch.
int graphdot_pcg_stream_grid(int M1, int M2, int N1, int N2, int smem_limit,
                             int *grid) {
    (void)M1;
    (void)N1;
    *grid = 0;
    const Plan plan = make_plan(M2, N2, static_cast<size_t>(smem_limit));
    if (plan.R == 0) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                     dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    const SolveFn fn = solve_kernel(plan);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(plan.smem));
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fn, kThreads, plan.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    *grid = per_sm * sms;
    return static_cast<int>(cudaSuccess);
}

// The plan for these shapes under `limit` bytes, into out[0..7]: the
// stages' rows R and count NS, the strides of T's rows and of z's and p's
// rows in a stage, whether side 2's list and whether z and p sit in shared
// memory, the columns of a chunk (0: whole rows) and the dynamic shared
// memory in bytes. Returns 0 when a plan fits, else cudaErrorInvalidValue.
int graphdot_pcg_stream_plan(int M1, int M2, int N1, int N2, int limit,
                             int *out) {
    (void)M1;
    (void)N1;
    const Plan p = make_plan(M2, N2, static_cast<size_t>(limit));
    out[0] = p.R;
    out[1] = p.NS;
    out[2] = p.ldT;
    out[3] = p.ldz;
    out[4] = p.lists;
    out[5] = p.vec;
    out[6] = p.CW;
    out[7] = static_cast<int>(p.smem);
    return p.R ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of the workspace `graphdot_pcg_stream` takes for P pairs solved by
// cooperative grids of at most `grid` CTAs under `smem_limit` bytes of
// shared memory: the CG vectors, the live flags, the sorted edge lists,
// permutations and row pointers, the sort's counts where they exceed
// shared memory, and the block sums; nothing of T's size.
size_t graphdot_pcg_stream_workspace_bytes(int P, int M1, int M2, int N1,
                                           int N2, int grid, int smem_limit) {
    return make_workspace(P, M1, M2, N1, N2, grid, smem_limit).bytes;
}

// Marks, sorts and solves P pairs on `stream`, in the cooperative launches
// `launches` names: n_launches (pairs, C) entries, in pair order, pairs * C
// <= grid each (`grid` from graphdot_pcg_stream_grid). Returns the first
// cudaError_t that is not cudaSuccess: a launch that is refused is not
// retried. cudaErrorInvalidValue when no plan fits `smem_limit` or the
// launches do not cover the P pairs with C >= 1,
// cudaErrorCooperativeLaunchTooLarge when a launch exceeds the grid.
// `work` holds `graphdot_pcg_stream_workspace_bytes` bytes for the same P,
// grid and smem_limit, 256-byte aligned.
int graphdot_pcg_stream(const float *T, const int *esrc1, const int *edst1,
                        const int *esrc2, const int *edst2,
                        const float *diag, const float *precond,
                        const float *b, const float *tol, float *x,
                        int *iters, void *work, int P, int M1, int M2,
                        int N1, int N2, int maxiter, const int *launches,
                        int n_launches, int grid, int smem_limit,
                        void *stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Plan plan = make_plan(M2, N2, static_cast<size_t>(smem_limit));
    if (plan.R == 0) return static_cast<int>(cudaErrorInvalidValue);
    long long covered = 0;
    for (int l = 0; l < n_launches; ++l) {
        const int pairs = launches[2 * l], C = launches[2 * l + 1];
        if (pairs < 1 || C < 1)
            return static_cast<int>(cudaErrorInvalidValue);
        if (static_cast<long long>(pairs) * C > grid)
            return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
        covered += pairs;
    }
    if (covered != P) return static_cast<int>(cudaErrorInvalidValue);
    const Workspace ws = make_workspace(P, M1, M2, N1, N2, grid, smem_limit);
    char *base = static_cast<char *>(work);
    auto at = [base](size_t offset) { return base + offset; };
    int *live1 = reinterpret_cast<int *>(at(ws.live1));
    int *live2 = reinterpret_cast<int *>(at(ws.live2));
    int *meta = reinterpret_cast<int *>(at(ws.meta));
    int *src1s = reinterpret_cast<int *>(at(ws.src1s));
    int *dst1s = reinterpret_cast<int *>(at(ws.dst1s));
    int *perm1 = reinterpret_cast<int *>(at(ws.perm1));
    int *rowptr1 = reinterpret_cast<int *>(at(ws.rowptr1));
    int *perm2 = reinterpret_cast<int *>(at(ws.perm2));
    int *dst2s = reinterpret_cast<int *>(at(ws.dst2s));
    unsigned *list2 = reinterpret_cast<unsigned *>(at(ws.list2));
    int *rowptr2 = reinterpret_cast<int *>(at(ws.rowptr2));
    int *order2 = reinterpret_cast<int *>(at(ws.order2));
    int *hist = reinterpret_cast<int *>(at(ws.hist));
    int *finished = reinterpret_cast<int *>(at(ws.finished));

    cudaError_t err = cudaMemsetAsync(live1, 0, ws.meta - ws.live1, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (M1 > 0 && M2 > 0) {
        stream_live_kernel<<<dim3((M2 + kLiveCols - 1) / kLiveCols,
                                  (M1 + kLiveRows - 1) / kLiveRows, P),
                             kLiveThreads, 0, s>>>(T, live1, live2, M1, M2);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const size_t sort_smem =
        ws.hist_in_smem ? ws.hist_ints * sizeof(int) : 0;
    err = cudaFuncSetAttribute(stream_sort_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sort_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    stream_sort_kernel<<<dim3(2, P), kSortThreads, sort_smem, s>>>(
        esrc1, edst1, esrc2, edst2, live1, live2, hist, ws.hist_ints,
        ws.hist_in_smem, meta, src1s, dst1s, perm1, rowptr1, perm2, dst2s,
        list2, rowptr2, order2, M1, M2, N1, N2, plan.cbits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const SolveFn fn = solve_kernel(plan);
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(plan.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    Problem prob = {T,       meta,    src1s,
                    dst1s,   perm1,   rowptr1,
                    rowptr2, order2,  list2,   diag,
                    precond, b,       tol,
                    reinterpret_cast<float *>(at(ws.vec)),
                    reinterpret_cast<float *>(at(ws.part)),
                    finished, x,      iters,
                    0,       0,       1,
                    M1,      M2,      N1,
                    N2,      maxiter};
    Plan pl = plan;
    for (int l = 0; l < n_launches; ++l) {
        prob.n_pairs = launches[2 * l];
        prob.C = launches[2 * l + 1];
        err = cudaMemsetAsync(finished, 0, sizeof(int), s);
        if (err != cudaSuccess) return static_cast<int>(err);
        void *args[] = {&prob, &pl};
        err = cudaLaunchCooperativeKernel(
            reinterpret_cast<const void *>(fn),
            dim3(prob.n_pairs * prob.C), dim3(kThreads), args, plan.smem, s);
        if (err != cudaSuccess) return static_cast<int>(err);
        prob.pair0 += prob.n_pairs;
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
