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
// members, as the TPU kernel does on its packed scratch: rz, pAp and r.r
// are summed over all members before the step sizes, so alpha and beta
// are shared; the breakdown guards and the stop rule
// (sqrt(sum_m r_m.r_m) < tol[s], or maxiter steps) apply to the group. A
// member whose b is zero stays exactly zero, and a group whose b is all
// zero stops after 0 steps. The caller gives tol[s] as the min over the
// members' own tolerances and scales maxiter, as `pallas_pcg_solver` does.
//
// The TPU kernel writes its members into diagonal blocks of zeroed VMEM
// scratch to fill 128x128 MXU tiles, and zeroes that scratch only in grid
// program 0, relying on a sequential grid. Here CTAs run concurrently and
// each owns its shared memory: there is no packed matrix and no
// off-diagonal block. The solve is the core in csrc/pcg_block.cuh.
//
// Contract (compact inputs, as `pallas_pcg_packed` takes them):
//   T [S, ka, M1, M2] f32; esrc1/edst1 [S, ka, M1], esrc2/edst2 [S, ka, M2]
//   int32; diag/precond [S, ka, N1, N2] f32; b [S, k, N1, N2] f32; tol [S]
//   f32; maxiter. Result x [S, k, N1, N2] f32 and iters [S] int32.
// ka is k (every member has its own operator: groups of different pairs,
// the TPU's layout) or 1 (the members share one operator: the n_theta
// tangent systems of one pair, which differ only in b). With ka = 1 the
// members run in lockstep: one T entry and one destination index serve
// all k, and p is laid out [node][k] (one 16-byte load at k = 4).
// k is 2 to graphdot_pcg::kMaxMembers (4): a group of one member is
// pcg_resident.cu's problem, and its wrapper runs it there, as the TPU's
// k == 1 branch runs `pallas_pcg`. A template instance exists for each k
// and each count of product nodes a thread on the core's ladder within
// its register budget (graphdot_pcg_packed_nodes_per_thread).
//
// Precision: the TPU kernel's modes (split2, default, highest, refine)
// choose bf16 MXU passes; this kernel computes in f32 with FMA, as the
// other two kernels, and takes no mode argument.
//
// What bounds it: as pcg_resident.cu, shared-memory latency and three
// block barriers a CG step, k multiply-adds per T entry loaded; packing
// the k tangents of a pair into one CTA shares the operator's load, its
// index walks and the barriers among them, and costs the extra CG steps
// that the shared step sizes take beyond each member's own (few when the
// members share a spectrum, as tangents do).
#include "pcg_block.cuh"

using graphdot_pcg::KernelFn;
using graphdot_pcg::Problem;

namespace {

template <int K, int NPT, bool SHARED>
__global__ void __launch_bounds__(graphdot_pcg::kThreads,
                                  graphdot_pcg::min_blocks(K, NPT))
pcg_packed_kernel(const Problem P) {
    extern __shared__ __align__(16) float smem[];
    graphdot_pcg::pcg_group<K, NPT, SHARED>(P, smem);
}

struct Kernels {
    template <int K, int NPT, bool SHARED>
    static KernelFn get() {
        return pcg_packed_kernel<K, NPT, SHARED>;
    }
};

template <int K>
KernelFn pick_k(bool shared, int npt) {
    return shared ? graphdot_pcg::instance<Kernels, K, true>(npt)
                  : graphdot_pcg::instance<Kernels, K, false>(npt);
}

// The instance for groups of k members (2 <= k <= kMaxMembers) with one
// shared operator (ka = 1) or one each (ka = k), of N1 x N2 product
// nodes; nullptr where none exists.
KernelFn pick(int k, int ka, int N1, int N2) {
    if (ka != 1 && ka != k) return nullptr;
    const bool shared = ka == 1;
    const int npt = graphdot_pcg::instance_nodes(k, shared, N1, N2);
    static_assert(graphdot_pcg::kMaxMembers == 4, "one case a k");
    switch (k) {
        case 2: return pick_k<2>(shared, npt);
        case 3: return pick_k<3>(shared, npt);
        case 4: return pick_k<4>(shared, npt);
        default: return nullptr;
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory one group needs, in bytes: k members with ka
// operators (ka = k, or 1 when the members share one).
size_t graphdot_pcg_packed_smem_bytes(int k, int ka, int M1, int M2, int N1,
                                      int N2) {
    return graphdot_pcg::smem_bytes(k, ka, M1, M2, N1, N2);
}

// Product nodes a thread owns for groups of k members with ka operators
// of N1 x N2 nodes; 0 when the kernel has no instance for them (k outside
// 2..kMaxMembers, k's CG state beyond the register budget, or more than
// kOwnOperatorsNodes nodes a thread with ka = k).
int graphdot_pcg_packed_nodes_per_thread(int k, int ka, int N1, int N2) {
    return pick(k, ka, N1, N2) == nullptr
               ? 0
               : graphdot_pcg::instance_nodes(k, ka == 1, N1, N2);
}

const char *graphdot_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[0..3]: CTAs an SM, registers and local bytes a thread, shared bytes
// a CTA, of the instance for these shapes on the current device.
int graphdot_pcg_packed_occupancy(int k, int ka, int M1, int M2, int N1,
                                  int N2, int *out) {
    return graphdot_pcg::occupancy(pick(k, ka, N1, N2), k, ka, M1, M2, N1,
                                   N2, out);
}

// Launches one CTA of 256 threads per group on `stream`; returns the
// launch's cudaError_t. ka is k or 1 (see the contract above).
int graphdot_pcg_packed(const float *T, const int *esrc1, const int *edst1,
                        const int *esrc2, const int *edst2,
                        const float *diag, const float *precond,
                        const float *b, const float *tol, float *x,
                        int *iters, int S, int k, int ka, int M1, int M2,
                        int N1, int N2, int maxiter, void *stream) {
    const Problem prob{T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
                       x, iters, ka, M1, M2, N1, N2, maxiter};
    return graphdot_pcg::launch(pick(k, ka, N1, N2), prob, S, k, stream);
}

}  // extern "C"
