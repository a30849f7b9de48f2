// The stable sort of one side's live edges by source, shared by
// csrc/pcg_cluster.cu (each CTA of a cluster, hist in the region of T) and
// csrc/pcg_stream.cu (a CTA a side of a pair, hist in shared memory where
// it fits, else in the workspace), for NVIDIA Hopper (sm_90a).
#pragma once

#include <cuda_runtime.h>

namespace graphdot_sort {

// Stable counting sort of one side's live edges by source over n nodes, by
// a block of kThreads threads: rowptr (n + 1), and for each live edge e at
// its place `at`: src_s[at], dst_s[at], perm[at] = e, pos[e] = at (pos[e] =
// -1 for a dead edge); any of the four may be null. Each warp takes chunks
// of 32 edges; a lane's rank among the chunk's edges of its source is the
// count of lower lanes with that source (__match_any_sync), `hist`
// [chunks, n] holds each chunk's counts and then their exclusive scan over
// the chunks. The order within a node is edge order. src, dst and live are
// the operator's edge lists and flags; every pointer is generic (shared or
// device memory). Ends with a block barrier, so rowptr and the outputs are
// visible to the whole block.
template <int kThreads>
__device__ void sort_side(const int *src, const int *dst, const int *live,
                          int M, int n, int *rowptr, int *src_s, int *dst_s,
                          int *perm, int *pos, int *hist) {
    constexpr int kWarps = kThreads / 32;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int chunks = (M + 31) / 32;
    for (int i = threadIdx.x; i < chunks * n; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int ch = warp; ch < chunks; ch += kWarps) {
        const int e = ch * 32 + lane;
        const int key = (e < M && live[e]) ? src[e] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (key >= 0 && lane == __ffs(peers) - 1)
            hist[ch * n + key] = __popc(peers);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
        int run = 0;
        for (int ch = 0; ch < chunks; ++ch) {
            const int v = hist[ch * n + i];
            hist[ch * n + i] = run;
            run += v;
        }
        rowptr[i] = run;   // the node's count, scanned below
    }
    __syncthreads();
    if (warp == 0) {
        int carry = 0;
        for (int base = 0; base < n; base += 32) {
            const int i = base + lane;
            const int v = i < n ? rowptr[i] : 0;
            int incl = v;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int u = __shfl_up_sync(0xffffffffu, incl, d);
                if (lane >= d) incl += u;
            }
            if (i < n) rowptr[i] = carry + incl - v;
            carry += __shfl_sync(0xffffffffu, incl, 31);
        }
        if (lane == 0) rowptr[n] = carry;
    }
    __syncthreads();
    for (int ch = warp; ch < chunks; ch += kWarps) {
        const int e = ch * 32 + lane;
        const int key = (e < M && live[e]) ? src[e] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (key >= 0) {
            const int at = rowptr[key] + hist[ch * n + key] +
                           __popc(peers & ((1u << lane) - 1u));
            if (src_s) src_s[at] = key;
            if (dst_s) dst_s[at] = dst[e];
            if (perm) perm[at] = e;
            if (pos) pos[e] = at;
        } else if (e < M && pos) {
            pos[e] = -1;
        }
    }
    __syncthreads();
}

}  // namespace graphdot_sort
