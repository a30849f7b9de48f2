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
// gathers on the MXU; here the off-diagonal matvec is in gather form over
// the pair's live edges, fused into one pass per product node, with the
// CG state of each thread's nodes in registers: the core in
// csrc/pcg_block.cuh, run with one member a group (K = 1) and the pair's
// own operator. Contract: T [P, M1, M2], esrc1/edst1 [P, M1], esrc2/edst2
// [P, M2] int32, diag/precond/b [P, N1, N2], tol [P]; x [P, N1, N2] and
// iters [P].
//
// Precision: the TPU kernel's modes (split2, default, highest, refine)
// choose bf16 MXU passes. This kernel computes in f32 with FMA, which is at
// least as accurate as split2, so it takes no mode argument.
//
// What bounds it: device memory is read about twice a pair and x written
// once; a CG step is ~6 multiply-adds a live product node at molecule
// shapes, out of shared memory, and three block barriers, so the step is
// bound by shared-memory latency and barriers; the registers of the CG
// state bound the CTAs an SM holds (graphdot_pcg_resident_occupancy).
// Each pair stops at its own convergence, so no pair runs on with a slower
// one.
#include "pcg_block.cuh"

using graphdot_pcg::KernelFn;
using graphdot_pcg::Problem;

namespace {

template <int NPT>
__global__ void __launch_bounds__(graphdot_pcg::kThreads,
                                  graphdot_pcg::min_blocks(1, NPT))
pcg_resident_kernel(const Problem P) {
    extern __shared__ __align__(16) float smem[];
    graphdot_pcg::pcg_group<1, NPT, true>(P, smem);
}

struct Kernels {
    template <int K, int NPT, bool SHARED>
    static KernelFn get() {
        return pcg_resident_kernel<NPT>;
    }
};

// The instance for pairs of N1 x N2 product nodes; nullptr where none.
KernelFn pick(int N1, int N2) {
    return graphdot_pcg::instance<Kernels, 1, true>(
        graphdot_pcg::instance_nodes(1, true, N1, N2));
}

}  // namespace

extern "C" {

// Dynamic shared memory one pair needs, in bytes.
size_t graphdot_pcg_resident_smem_bytes(int M1, int M2, int N1, int N2) {
    return graphdot_pcg::smem_bytes(1, 1, M1, M2, N1, N2);
}

// The most dynamic shared memory one block may opt into on `device`.
int graphdot_pcg_resident_smem_limit(int device, int *bytes) {
    return static_cast<int>(cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Product nodes a thread owns for pairs of N1 x N2 nodes; 0 when the
// kernel has no instance for them (more than 13 a thread).
int graphdot_pcg_resident_nodes_per_thread(int N1, int N2) {
    return graphdot_pcg::instance_nodes(1, true, N1, N2);
}

const char *graphdot_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[0..3]: CTAs an SM, registers and local bytes a thread, shared bytes
// a CTA, of the instance for these shapes on the current device.
int graphdot_pcg_resident_occupancy(int M1, int M2, int N1, int N2,
                                    int *out) {
    return graphdot_pcg::occupancy(pick(N1, N2), 1, 1, M1, M2, N1, N2, out);
}

// Launches one CTA of 256 threads per pair on `stream`; returns the
// launch's cudaError_t.
int graphdot_pcg_resident(const float *T, const int *esrc1, const int *edst1,
                          const int *esrc2, const int *edst2,
                          const float *diag, const float *precond,
                          const float *b, const float *tol, float *x,
                          int *iters, int P, int M1, int M2, int N1, int N2,
                          int maxiter, void *stream) {
    const Problem prob{T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
                       x, iters, 1, M1, M2, N1, N2, maxiter};
    return graphdot_pcg::launch(pick(N1, N2), prob, P, 1, stream);
}

}  // extern "C"
