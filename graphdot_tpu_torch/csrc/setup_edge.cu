// The edge coupling T of a batch of marginalized-graph-kernel product
// systems in one pass, for NVIDIA Hopper (sm_90a):
//
//     T[p, a, b] = (w1[p, a] != 0 && w2[p, b] != 0)
//                  ? (k_edge(f1[p, a], f2[p, b]; theta) * w1[p, a]) * w2[p, b]
//                  : 0
//
// Replaces no TPU kernel: the JAX package builds T in one jnp expression
// inside graphdot_tpu/kernel/marginalized/_solver.py::mlgk_setup, which XLA
// fuses into one loop. Its plain PyTorch form (the edge kernel's chain of
// elementwise operations, the products, the mask, the copy) runs as about
// eight passes over [P, M1, M2], each reading and writing T's size in device
// memory; this kernel writes T once and keeps nothing else there.
//
// This file is a template. Each microkernel gives its float32 C expression
// beside its definition (MicroKernel.c_expr in graphdot_tpu_torch/
// microkernel/); graphdot_tpu_torch/ops/setup_edge.py puts the edge
// kernel's in place of the marker line below, with the constants kFeatures
// (scalar feature columns a side), kSlots (kFeatures, at least 1) and
// kTheta (the edge kernel's hyperparameters), as the function
//
//     __device__ float edge_kernel(const float *x, const float *y,
//                                  const float *th);
//
// over one edge's feature values of each side and the hyperparameters. The
// hyperparameters are read from device memory at each launch, so a new
// theta builds nothing and reads nothing back to the host; the source
// depends on the kernel's expression alone.
//
// Contract: f1 [P, M1] and f2 [P, M2] f32, one pointer a feature column;
// w1 [P, M1], w2 [P, M2] f32; theta [kTheta] f32; T [P, M1, M2] f32,
// contiguous, written whole.
//
// What bounds it: the store of T, 4 bytes an entry, and nothing else of
// that size (a pair's features and weights are M1 + M2 values a column).
// Design: a CTA takes one pair and a tile of rows; each thread owns 4
// neighbouring columns, holds their side-2 features and weights in
// registers, and walks its rows, storing the 4 entries of each as one
// 16-byte store where a row is a multiple of 4 floats (one warp covers 512
// contiguous bytes of a row). Side 1's values of a row are one broadcast
// load for the warp. A dead edge (weight 0) skips the edge kernel.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

// @EDGE_KERNEL@

constexpr int kThreads = 256;
// rows a thread stores per CTA
constexpr int kRowsPerThread = 8;

struct Columns {
    const float *c[kSlots];
};

// Grid: x = P * row tiles, y = column tiles. Threads: 2^tx_log2 along the
// columns (4 columns each), kThreads >> tx_log2 along the rows.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
setup_edge_kernel(const Columns f1, const Columns f2,
                  const float *__restrict__ w1, const float *__restrict__ w2,
                  const float *__restrict__ theta, float *__restrict__ T,
                  int M1, int M2, int row_tiles, int tx_log2) {
    const int tx = threadIdx.x & ((1 << tx_log2) - 1);
    const int ty = threadIdx.x >> tx_log2;
    const int rows_parallel = kThreads >> tx_log2;
    const int64_t p = blockIdx.x / row_tiles;
    const int a0 = (blockIdx.x % row_tiles) * rows_parallel * kRowsPerThread;
    const int b = ((blockIdx.y << tx_log2) + tx) * 4;
    if (b >= M2) return;

    float th[kTheta > 0 ? kTheta : 1];
#pragma unroll
    for (int j = 0; j < kTheta; ++j) th[j] = __ldg(theta + j);

    // the thread's 4 columns of side 2
    float y[4][kSlots];
    float wy[4];
    const int64_t base2 = p * M2 + b;
    if (kVec) {
        const float4 w = __ldg(reinterpret_cast<const float4 *>(w2 + base2));
        wy[0] = w.x; wy[1] = w.y; wy[2] = w.z; wy[3] = w.w;
#pragma unroll
        for (int c = 0; c < kFeatures; ++c) {
            const float4 v =
                __ldg(reinterpret_cast<const float4 *>(f2.c[c] + base2));
            y[0][c] = v.x; y[1][c] = v.y; y[2][c] = v.z; y[3][c] = v.w;
        }
    } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const bool in = b + q < M2;
            wy[q] = in ? __ldg(w2 + base2 + q) : 0.f;
#pragma unroll
            for (int c = 0; c < kFeatures; ++c)
                y[q][c] = in ? __ldg(f2.c[c] + base2 + q) : 0.f;
        }
    }

#pragma unroll 1
    for (int r = 0; r < kRowsPerThread; ++r) {
        const int a = a0 + ty + r * rows_parallel;
        if (a >= M1) break;
        const int64_t i1 = p * M1 + a;
        const float wx = __ldg(w1 + i1);
        float x[kSlots];
#pragma unroll
        for (int c = 0; c < kFeatures; ++c) x[c] = __ldg(f1.c[c] + i1);
        float out[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            out[q] = 0.f;
            // zero at a padded edge by the mask, not by the weight alone
            if (wx != 0.f && wy[q] != 0.f)
                out[q] = (edge_kernel(x, y[q], th) * wx) * wy[q];
        }
        float *row = T + i1 * M2 + b;
        if (kVec) {
            *reinterpret_cast<float4 *>(row) =
                make_float4(out[0], out[1], out[2], out[3]);
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (b + q < M2) row[q] = out[q];
        }
    }
}

}  // namespace

extern "C" {

const char *graphdot_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the build of T [P, M1, M2] on `stream`; cols1 and cols2 are
// host arrays of kFeatures device pointers. `vec`: every row of side 2 and
// of T starts on 16 bytes (M2 % 4 == 0, aligned pointers). Returns the
// launch's cudaError_t.
int graphdot_setup_edge(const float *const *cols1, const float *const *cols2,
                        const float *w1, const float *w2, const float *theta,
                        float *T, int P, int M1, int M2, int vec,
                        void *stream) {
    if (P == 0 || M1 == 0 || M2 == 0) return 0;
    Columns f1, f2;
    for (int c = 0; c < kFeatures; ++c) {
        f1.c[c] = cols1[c];
        f2.c[c] = cols2[c];
    }
    // the fewest threads along a row (a power of 2, 32 to kThreads) that
    // cover it 4 columns a thread; the rest of the CTA along the rows
    const int quads = (M2 + 3) / 4;
    int tx_log2 = 5;
    while ((1 << tx_log2) < quads && (1 << tx_log2) < kThreads) ++tx_log2;
    const int rows_a_cta = (kThreads >> tx_log2) * kRowsPerThread;
    const int row_tiles = (M1 + rows_a_cta - 1) / rows_a_cta;
    const dim3 grid(static_cast<unsigned>(P) * row_tiles,
                    (quads + (1 << tx_log2) - 1) >> tx_log2);
    auto s = static_cast<cudaStream_t>(stream);
    if (vec)
        setup_edge_kernel<true><<<grid, kThreads, 0, s>>>(
            f1, f2, w1, w2, theta, T, M1, M2, row_tiles, tx_log2);
    else
        setup_edge_kernel<false><<<grid, kThreads, 0, s>>>(
            f1, f2, w1, w2, theta, T, M1, M2, row_tiles, tx_log2);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
