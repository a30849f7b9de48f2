"""Product-graph PCG: the CUDA kernels' wrappers and their plain PyTorch
twins.

Counterpart of ``graphdot_tpu/ops/pallas_pcg.py``: ``pallas_pcg`` (the
``k == 1`` branch of ``pallas_pcg_solver`` and ``_cg_solve_values``),
``pallas_pcg_packed`` (its ``k >= 2`` branch) and ``pallas_pcg_stream``
(``_stream_solver``). Every function here solves, for every pair p of a
batch,

    [diag o Y - S1^T (T o (D1 Y D2^T)) S2] x = b

by Jacobi-PCG from x = 0 and stop each pair at ``sqrt(r.r) < tol[p]`` or
after ``maxiter`` steps. The incidence matrices S and D are given as edge
lists (``esrc``/``edst`` indices), not as one-hot matrices.

- :func:`pcg_resident` launches ``csrc/pcg_resident.cu`` on CUDA tensors
  (one CTA per pair over the pair's live edges, each thread's product
  nodes' CG state in registers: the core in ``csrc/pcg_block.cuh``).
  Given CPU tensors it runs :func:`pcg_resident_reference` instead; it
  never falls back from the card to anything else.
- :func:`pcg_resident_reference` is the same function in plain torch:
  batched over pairs with done masks, the matvec by ``index_select`` and
  sums over the same edge lists (:func:`offdiag_operator`).
- :func:`pcg_stream` launches ``csrc/pcg_stream.cu`` on CUDA tensors (a
  cooperative grid with C CTAs per pair, each streaming its share of T
  from device memory in tiles, the CG vectors in a device workspace), for
  pairs beyond a block's shared memory. Given CPU tensors it runs
  :func:`pcg_stream_reference`.
- :func:`pcg_stream_reference` is its plain twin, the same function as
  :func:`pcg_resident_reference`.
- :func:`pcg_packed` launches ``csrc/pcg_packed.cu`` on CUDA tensors: one
  CTA per group of k systems that run ONE PCG on their union, with the dot
  products summed over the members and shared step sizes, stopping at the
  group's tolerance. The members share one operator (the tangent systems
  of a pair, in lockstep) or have one each (groups of pairs,
  :func:`group_pairs`); at most :data:`PACKED_MAX_K` a group. A group of
  one member runs in ``csrc/pcg_resident.cu``, as the TPU's ``k == 1``
  branch runs ``pallas_pcg``. Given CPU tensors it runs
  :func:`pcg_packed_reference`.

:func:`pcg_resident` and :func:`pcg_packed` run on blocks of 256 threads;
a thread owns up to 13 product nodes (one member) or fewer (larger
groups), as many as its CG state's registers allow (:func:`resident_fits`,
:func:`packed_fits`).
"""
import ctypes
import functools

import torch

from . import _build

#: the largest group :func:`pcg_packed` solves in one CTA
#: (``kMaxMembers`` of ``csrc/pcg_block.cuh``)
PACKED_MAX_K = 4


def pcg(matvec, b, precond, tol, maxiter, return_iters=False):
    """Batched Jacobi-PCG (``graphdot_tpu/kernel/marginalized/_solver.py``
    ``pcg``). All operands [P, N]; ``tol`` [P] is the absolute residual-norm
    threshold per pair. Pairs that converged (or broke down on
    ``pAp == 0`` or ``rz == 0``) keep their x while the others go on.

    With ``return_iters``, also returns the per-pair step count at which
    each system stopped (``maxiter`` for systems the cap preempted).
    """
    def dot(u, v):
        return torch.sum(u * v, dim=-1)

    z = precond * b
    x = torch.zeros_like(b)
    r = b
    p = z
    rz = dot(b, z)
    done = torch.sqrt(dot(b, b)) < tol
    iters = torch.where(done, 0, maxiter).to(torch.int32)
    it = 0
    while it < maxiter and not bool(done.all()):
        Ap = matvec(p)
        pAp = dot(p, Ap)
        bad = (pAp == 0.0) | (rz == 0.0)
        step = ~(done | bad)
        alpha = torch.where(
            step, rz / torch.where(pAp == 0, 1.0, pAp), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = precond * r
        rz_new = dot(r, z)
        done_new = done | bad | (torch.sqrt(dot(r, r)) < tol)
        beta = torch.where(
            done_new, 0.0, rz_new / torch.where(rz == 0, 1.0, rz))
        p = z + beta[:, None] * p
        rz = torch.where(done_new, rz, rz_new)
        iters = torch.where(done_new & ~done, it + 1, iters)
        done = done_new
        it += 1
    if return_iters:
        return x, iters
    return x


def edge_segments(src, live, n):
    """Each node's live edges, in edge order: [P, n, W] local edge indices
    of the edges whose source is the node (W the most any node has), the
    slots a node leaves free holding M, the index of a zero that
    :func:`offdiag_operator` appends. ``src`` [P, M] and ``live`` [P, M]
    bool."""
    P, M = src.shape
    device = src.device
    key = torch.where(live, src.long(), n)
    order = torch.argsort(key, dim=1, stable=True)
    skey = torch.gather(key, 1, order)
    counts = torch.zeros(P, n + 1, dtype=torch.long, device=device)
    counts.scatter_add_(1, key, torch.ones_like(key))      # integer: exact
    start = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(M, device=device) - torch.gather(start, 1, skey)
    W = int(counts[:, :n].max()) if P and n else 0
    # every live edge to its (node, rank) slot; the dead ones to a spare
    # slot at the end, which is cut off
    slot = torch.where(
        skey < n,
        (torch.arange(P, device=device)[:, None] * n + skey) * W + rank,
        P * n * W)
    table = torch.full((P * n * W + 1,), M, dtype=torch.long, device=device)
    table[slot.reshape(-1)] = order.reshape(-1)
    return table[:-1].view(P, n, W)


def offdiag_operator(T, esrc1, edst1, esrc2, edst2, segments=None):
    """``Y [P,N1,N2] -> out [P,N1,N2]``, the off-diagonal product-graph
    matvec in gather form over one operator:

    ``out[p,i1,i2] = sum_{e1: src1=i1} sum_{e2: src2=i2}
    T[p,e1,e2] Y[p, dst1(e1), dst2(e2)]``

    T [P,M1,M2]; esrc1/edst1 [P,M1] and esrc2/edst2 [P,M2] integer
    tensors. The two sums run over each node's edge lists
    (:func:`edge_segments`): each output adds its terms one after another
    from 0, in edge order, as ``index_add_`` does on the CPU, so that it is
    the same, bit for bit, at every call, on every device and whichever
    other pairs share the batch (on CUDA ``index_add_`` adds floats by
    atomics, in an order that changes from run to run).

    ``segments`` is the pair (seg1, seg2) of the two sides' lists over the
    N1 and N2 nodes of Y, which must hold every edge whose row (side 1) or
    column (side 2) of T holds a nonzero: the kernel's packed batches carry
    the lists of each graph's real edges. None lists the live edges of T
    itself, once a node count."""
    P, M1, M2 = T.shape
    device = T.device
    esrc1, edst1, esrc2, edst2 = (e.long() for e in (esrc1, edst1, esrc2,
                                                     edst2))

    def gathered(Y):
        """Z [P, M1, M2] = T o H, H[p,e1,e2] = Y[p, dst1(e1), dst2(e2)]"""
        N1, N2 = Y.shape[1:]
        dst1 = (torch.arange(P, device=device)[:, None] * N1
                + edst1).reshape(-1)
        dst2 = (torch.arange(P, device=device)[:, None] * N2
                + edst2).reshape(-1)
        # G[p,e1,:] = Y[p, dst1(e1), :]
        G = Y.reshape(P * N1, N2).index_select(0, dst1).view(P, M1, N2)
        # H[p,e1,e2] = G[p, e1, dst2(e2)]  (selected from G^T by rows)
        Ht = G.transpose(1, 2).reshape(P * N2, M1).index_select(0, dst2)
        return T * Ht.view(P, M2, M1).transpose(1, 2)

    tables = {}

    def table(N1, N2):
        if segments is not None:
            return segments
        if (N1, N2) not in tables:
            nz = T != 0
            tables[N1, N2] = (edge_segments(esrc1, nz.any(dim=2), N1),
                              edge_segments(esrc2, nz.any(dim=1), N2))
        return tables[N1, N2]

    def offdiag(Y):
        N1, N2 = Y.shape[1:]
        seg1, seg2 = table(N1, N2)
        Z = gathered(Y)
        Zp = torch.cat([Z, Z.new_zeros(P, M1, 1)], dim=2)
        # U[p,e1,i2] = sum_{e2: src2=i2} Z[p,e1,e2], in e2's order
        U = Z.new_zeros(P, M1, N2)
        for w in range(seg2.shape[2]):
            U = U + torch.gather(
                Zp, 2, seg2[:, None, :, w].expand(P, M1, N2))
        Up = torch.cat([U, U.new_zeros(P, 1, N2)], dim=1)
        # out[p,i1,i2] = sum_{e1: src1=i1} U[p,e1,i2], in e1's order
        out = Y.new_zeros(P, N1, N2)
        for w in range(seg1.shape[2]):
            out = out + torch.gather(
                Up, 1, seg1[:, :, w, None].expand(P, N1, N2))
        return out
    return offdiag


def gather_offdiag(T, esrc1, edst1, esrc2, edst2, Y, segments=None):
    """The off-diagonal product-graph matvec in gather form,
    :func:`offdiag_operator` of T and the edge lists (and ``segments``)
    applied to Y [P,N1,N2]. Returns [P,N1,N2]."""
    return offdiag_operator(T, esrc1, edst1, esrc2, edst2, segments)(Y)


def live_extent(T, esrc1, edst1, esrc2, edst2, b):
    """The part of each system that ``csrc/pcg_block.cuh`` solves, in plain
    torch: ``(L1, L2, n1, n2)``, each [P].

    T [P, M1, M2]; esrc1/edst1 [P, M1]; esrc2/edst2 [P, M2]; b [P, ...,
    N1, N2] (the members' right-hand sides between). An edge is live when
    its row (side 1) or column (side 2) of T holds a nonzero; L1 and L2
    count them. Side 1's extent n1 is 1 + the largest node that ends a
    live edge or holds a nonzero b in its row (0 when there is none), n2
    likewise by columns. Every product node (i1, i2) with i1 >= n1 or
    i2 >= n2 has no live edge and b = 0 there, so its x is exactly 0."""
    P, N1, N2 = b.shape[0], b.shape[-2], b.shape[-1]
    nz = T != 0
    live1, live2 = nz.any(dim=2), nz.any(dim=1)
    bnz = (b != 0).reshape(P, -1, N1, N2).any(dim=1)

    def highest(mask, index):
        return torch.where(mask, index, -1).amax(dim=1) if mask.shape[1] \
            else torch.full((P,), -1, device=mask.device)

    def side(live, src, dst, rows, n):
        ends = torch.maximum(src, dst).long()
        index = torch.arange(n, device=rows.device).expand(P, n)
        return torch.maximum(highest(live, ends), highest(rows, index)) + 1

    return (live1.sum(dim=1), live2.sum(dim=1),
            side(live1, esrc1, edst1, bnz.any(dim=2), N1),
            side(live2, esrc2, edst2, bnz.any(dim=1), N2))


def _validate(operands, device, maxiter, index_lists):
    """Check each operand's type, shape, dtype, device and contiguity,
    ``maxiter``, and that every index list lies in [0, n) of its side."""
    for name, (t, shape, dtype) in operands.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f'{name} must be a torch.Tensor')
        if tuple(t.shape) != shape:
            raise ValueError(
                f'{name} must have shape {shape}, got {tuple(t.shape)}')
        if t.dtype != dtype:
            raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
        if t.device != device:
            raise ValueError(
                f'{name} is on {t.device}, T is on {device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if not isinstance(maxiter, int) or maxiter < 0:
        raise ValueError(f'maxiter must be a non-negative int: {maxiter!r}')
    # one device-to-host sync for all index lists
    bad = torch.zeros((), dtype=torch.bool, device=device)
    for e, n in index_lists:
        bad = bad | ((e < 0) | (e >= n)).any()
    if bool(bad):
        raise ValueError('edge indices out of range of the node counts')


def _check(T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol, maxiter):
    """Validate the operands of both solvers; returns (P, M1, M2, N1, N2)."""
    if T.dim() != 3:
        raise ValueError(f'T must be [P, M1, M2], got {tuple(T.shape)}')
    P, M1, M2 = T.shape
    if diag.dim() != 3 or diag.shape[0] != P:
        raise ValueError(
            f'diag must be [P={P}, N1, N2], got {tuple(diag.shape)}')
    N1, N2 = diag.shape[1:]
    _validate({
        'esrc1': (esrc1, (P, M1), torch.int32),
        'edst1': (edst1, (P, M1), torch.int32),
        'esrc2': (esrc2, (P, M2), torch.int32),
        'edst2': (edst2, (P, M2), torch.int32),
        'T': (T, (P, M1, M2), torch.float32),
        'diag': (diag, (P, N1, N2), torch.float32),
        'precond': (precond, (P, N1, N2), torch.float32),
        'b': (b, (P, N1, N2), torch.float32),
        'tol': (tol, (P,), torch.float32),
    }, T.device, maxiter,
        ((esrc1, N1), (edst1, N1), (esrc2, N2), (edst2, N2)))
    return P, M1, M2, N1, N2


def _check_packed(T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
                  maxiter):
    """Validate the operands of the packed solver; returns
    (S, k, ka, M1, M2, N1, N2), ka being 1 or k operators a group."""
    if T.dim() != 4:
        raise ValueError(
            f'T must be [S, ka, M1, M2], got {tuple(T.shape)}')
    if b.dim() != 4 or b.shape[0] != T.shape[0]:
        raise ValueError(
            f'b must be [S={T.shape[0]}, k, N1, N2], got {tuple(b.shape)}')
    S, ka, M1, M2 = T.shape
    k, N1, N2 = b.shape[1:]
    if ka not in (1, k):
        raise ValueError(
            f'T has {ka} operators a group; give 1 (shared by the members) '
            f'or k = {k}')
    _validate({
        'esrc1': (esrc1, (S, ka, M1), torch.int32),
        'edst1': (edst1, (S, ka, M1), torch.int32),
        'esrc2': (esrc2, (S, ka, M2), torch.int32),
        'edst2': (edst2, (S, ka, M2), torch.int32),
        'T': (T, (S, ka, M1, M2), torch.float32),
        'diag': (diag, (S, ka, N1, N2), torch.float32),
        'precond': (precond, (S, ka, N1, N2), torch.float32),
        'b': (b, (S, k, N1, N2), torch.float32),
        'tol': (tol, (S,), torch.float32),
    }, T.device, maxiter,
        ((esrc1, N1), (edst1, N1), (esrc2, N2), (edst2, N2)))
    return S, k, ka, M1, M2, N1, N2


def _plain_pcg(T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
               maxiter):
    """The solve of both kernels in plain torch: :func:`pcg` over the
    matvec of :func:`offdiag_operator`."""
    P, M1, M2, N1, N2 = _check(T, esrc1, edst1, esrc2, edst2, diag,
                               precond, b, tol, maxiter)
    N = N1 * N2
    offdiag = offdiag_operator(T, esrc1, edst1, esrc2, edst2)
    diag_flat = diag.reshape(P, N)

    def matvec(y):
        off = offdiag(y.view(P, N1, N2))
        return diag_flat * y - off.reshape(P, N)

    x, iters = pcg(matvec, b.reshape(P, N), precond.reshape(P, N), tol,
                   maxiter, return_iters=True)
    return x.view(P, N1, N2), iters


def pcg_resident_reference(T, esrc1, edst1, esrc2, edst2, diag, precond, b,
                           tol, maxiter):
    """Plain-torch twin of :func:`pcg_resident`, with the same arguments
    and results: ``(x [P,N1,N2] f32, iters [P] int32)``."""
    return _plain_pcg(T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
                      maxiter)


def pcg_stream_reference(T, esrc1, edst1, esrc2, edst2, diag, precond, b,
                         tol, maxiter):
    """Plain-torch twin of :func:`pcg_stream`, with the same arguments and
    results: ``(x [P,N1,N2] f32, iters [P] int32)``.

    It computes the same function as :func:`pcg_resident_reference`, by
    the same code. Its memory grows with the chunk: each CG step of
    :func:`gather_offdiag` builds intermediates of T's size, [P, M2, M1]
    floats (55.8 MB a pair at protein contact-map shapes, M = 3736), so
    give it a chunk of a few pairs at that size."""
    return _plain_pcg(T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
                      maxiter)


def pcg_packed_reference(T, esrc1, edst1, esrc2, edst2, diag, precond, b,
                         tol, maxiter):
    """Plain-torch twin of :func:`pcg_packed`, with the same arguments and
    results: ``(x [S,k,N1,N2] f32, iters [S] int32)``.

    One PCG over the union of each group's k members, the loop of
    ``_cg_solve_values`` on ``_pcg_pack_kernel``'s block-diagonal union:
    :func:`pcg` over the group's k members laid end to end, so that
    ``rz``, ``pAp`` and ``r.r`` are summed over the members, alpha and beta
    are shared, the breakdown guards apply to the group and the group stops
    at ``sqrt(sum_m r_m.r_m) < tol[s]``. Each member's matvec is
    :func:`offdiag_operator` over its own operator."""
    S, k, ka, M1, M2, N1, N2 = _check_packed(
        T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol, maxiter)
    N = N1 * N2

    def members(a):
        """[S, ka, ...] -> [S * k, ...], one operator a member"""
        return a.expand(S, k, *a.shape[2:]).reshape(S * k, *a.shape[2:])

    Tm = members(T)
    offdiag = offdiag_operator(Tm, *(members(e) for e in (esrc1, edst1,
                                                          esrc2, edst2)))
    diag_flat = members(diag).reshape(S, k * N)

    def matvec(y):
        off = offdiag(y.view(S * k, N1, N2))
        return diag_flat * y - off.reshape(S, k * N)

    x, iters = pcg(matvec, b.reshape(S, k * N),
                   members(precond).reshape(S, k * N), tol, maxiter,
                   return_iters=True)
    return x.view(S, k, N1, N2), iters


def group_pairs(k, T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
                maxiter):
    """Group P pairs into S = ceil(P / k) groups of k members for
    :func:`pcg_packed`: the packed branch of
    ``graphdot_tpu/ops/pallas_pcg.py::pallas_pcg_solver``, the TPU's
    layout (every member its own pair).

    P is padded to a multiple of k with zero systems (T, diag, precond and
    b zero, edges 0 -> 0, tol 1.0), the operands are reshaped to
    [S, k, ...], each group's tol is the min over its members and maxiter
    is scaled to ``min(maxiter * k, 16384)``. Returns the arguments of
    :func:`pcg_packed`; its x, reshaped to [S * k, N1, N2], holds the pairs'
    solutions in its first P rows."""
    P = T.shape[0]
    pad = -P % k

    def grouped(a, value=0):
        if pad:
            a = torch.cat([a, a.new_full((pad, *a.shape[1:]), value)])
        return a.reshape(-1, k, *a.shape[1:]).contiguous()

    return (*(grouped(a) for a in (T, esrc1, edst1, esrc2, edst2, diag,
                                   precond, b)),
            grouped(tol, 1.0).min(dim=1).values,
            min(maxiter * k, 16384))


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library, with its C signatures declared."""
    lib = _build.load('pcg_resident')
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.graphdot_pcg_resident.argtypes = [ptr] * 11 + [cint] * 6 + [ptr]
    lib.graphdot_pcg_resident.restype = cint
    lib.graphdot_pcg_resident_smem_bytes.argtypes = [cint] * 4
    lib.graphdot_pcg_resident_smem_bytes.restype = ctypes.c_size_t
    lib.graphdot_pcg_resident_smem_limit.argtypes = [
        cint, ctypes.POINTER(cint)]
    lib.graphdot_pcg_resident_smem_limit.restype = cint
    lib.graphdot_pcg_resident_nodes_per_thread.argtypes = [cint] * 2
    lib.graphdot_pcg_resident_nodes_per_thread.restype = cint
    lib.graphdot_pcg_resident_occupancy.argtypes = [cint] * 4 + [
        ctypes.POINTER(cint)]
    lib.graphdot_pcg_resident_occupancy.restype = cint
    lib.graphdot_cuda_error_string.argtypes = [cint]
    lib.graphdot_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _stream_library():
    """The built streaming-kernel library, with its C signatures."""
    lib = _build.load('pcg_stream')
    ptr, cint, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.graphdot_pcg_stream.argtypes = [ptr] * 12 + [cint] * 9 + [ptr]
    lib.graphdot_pcg_stream.restype = cint
    lib.graphdot_pcg_stream_smem_bytes.argtypes = [cint] * 5
    lib.graphdot_pcg_stream_smem_bytes.restype = size
    lib.graphdot_pcg_stream_grid.argtypes = [cint] * 5 + [
        ctypes.POINTER(cint)]
    lib.graphdot_pcg_stream_grid.restype = cint
    lib.graphdot_pcg_stream_workspace_bytes.argtypes = [cint] * 6
    lib.graphdot_pcg_stream_workspace_bytes.restype = size
    lib.graphdot_cuda_error_string.argtypes = [cint]
    lib.graphdot_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _packed_library():
    """The built packed-kernel library, with its C signatures."""
    lib = _build.load('pcg_packed')
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.graphdot_pcg_packed.argtypes = [ptr] * 11 + [cint] * 8 + [ptr]
    lib.graphdot_pcg_packed.restype = cint
    lib.graphdot_pcg_packed_smem_bytes.argtypes = [cint] * 6
    lib.graphdot_pcg_packed_smem_bytes.restype = ctypes.c_size_t
    lib.graphdot_pcg_packed_nodes_per_thread.argtypes = [cint] * 4
    lib.graphdot_pcg_packed_nodes_per_thread.restype = cint
    lib.graphdot_pcg_packed_occupancy.argtypes = [cint] * 6 + [
        ctypes.POINTER(cint)]
    lib.graphdot_pcg_packed_occupancy.restype = cint
    lib.graphdot_cuda_error_string.argtypes = [cint]
    lib.graphdot_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, what):
    if err:
        msg = lib.graphdot_cuda_error_string(err).decode()
        raise RuntimeError(f'{what} failed: CUDA error {err} ({msg})')


def _device_index(device):
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _smem_limit(device):
    """Bytes of shared memory a block can opt into on the CUDA device."""
    lib = _library()
    limit = ctypes.c_int(0)
    _raise_on(lib, lib.graphdot_pcg_resident_smem_limit(
        _device_index(device), ctypes.byref(limit)),
        'cudaDeviceGetAttribute')
    return limit.value


def resident_smem(M1, M2, N1, N2, device):
    """(bytes of shared memory :func:`pcg_resident` needs for one pair of
    these shapes, bytes a block can opt into on the CUDA ``device``)."""
    return (_library().graphdot_pcg_resident_smem_bytes(M1, M2, N1, N2),
            _smem_limit(device))


def resident_fits(M1, M2, N1, N2, device):
    """Whether one pair of these shapes runs in :func:`pcg_resident` on the
    CUDA ``device``: its operator fits a block's shared memory, and its
    N1 * N2 product nodes the registers of a block (at most 13 nodes a
    thread, 3328 in all)."""
    smem, limit = resident_smem(M1, M2, N1, N2, device)
    return smem <= limit and \
        _library().graphdot_pcg_resident_nodes_per_thread(N1, N2) > 0


def packed_smem(k, M1, M2, N1, N2, device, shared=False):
    """(bytes of shared memory :func:`pcg_packed` needs for a group of k
    members of these shapes, bytes a block can opt into on the CUDA
    ``device``). ``shared``: the members share one operator (T, edges,
    diag and precond given once a group). One member is
    :func:`pcg_resident`'s problem (:func:`resident_smem`)."""
    if k == 1:
        return resident_smem(M1, M2, N1, N2, device)
    nbytes = _packed_library().graphdot_pcg_packed_smem_bytes(
        k, 1 if shared else k, M1, M2, N1, N2)
    return nbytes, _smem_limit(device)


def packed_fits(k, M1, M2, N1, N2, device, shared=False):
    """Whether a group of k members of these shapes runs in
    :func:`pcg_packed` on the CUDA ``device``: k <= :data:`PACKED_MAX_K`,
    the group fits a block's shared memory, and its members' CG state the
    registers of a block ((3 k + 2) floats a product node, and at most 3
    nodes a thread unless ``shared``). One member runs where
    :func:`resident_fits` says."""
    if k == 1:
        return resident_fits(M1, M2, N1, N2, device)
    nbytes, limit = packed_smem(k, M1, M2, N1, N2, device, shared)
    return nbytes <= limit and \
        _packed_library().graphdot_pcg_packed_nodes_per_thread(
            k, 1 if shared else k, N1, N2) > 0


def largest_packed_k(k, M1, M2, N1, N2, device, shared=False):
    """The largest group size up to ``k`` (and :data:`PACKED_MAX_K`) whose
    group runs in :func:`pcg_packed` on the CUDA ``device``
    (:func:`packed_fits`); 0 when not even one member fits."""
    for g in range(min(k, PACKED_MAX_K), 0, -1):
        if packed_fits(g, M1, M2, N1, N2, device, shared):
            return g
    return 0


def kernel_occupancy(name, M1, M2, N1, N2, k=1, ka=1):
    """What the CUDA instance of :func:`pcg_resident` or :func:`pcg_packed`
    (``name``; k >= 2) for these shapes gets on the current device:
    {'ctas_per_sm', 'registers', 'spill_bytes', 'smem_bytes'}
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` and
    ``cudaFuncGetAttributes``, at 256 threads a block)."""
    out = (ctypes.c_int * 4)()
    if name == 'pcg_resident':
        lib = _library()
        err = lib.graphdot_pcg_resident_occupancy(M1, M2, N1, N2, out)
    elif name == 'pcg_packed':
        lib = _packed_library()
        err = lib.graphdot_pcg_packed_occupancy(k, ka, M1, M2, N1, N2, out)
    else:
        raise ValueError(f'no occupancy query for {name!r}')
    _raise_on(lib, err, f'{name} occupancy')
    return dict(zip(('ctas_per_sm', 'registers', 'spill_bytes',
                     'smem_bytes'), out))


def pcg_resident(T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
                 maxiter):
    """Solve a batch of product-graph systems with the resident CUDA PCG.

    Parameters
    ----------
    T: [P, M1, M2] float32 edge-coupling matrices (zero for padded edges).
    esrc1, edst1: [P, M1] int32 directed edge sources/destinations, side 1.
    esrc2, edst2: [P, M2] int32, side 2.
    diag, precond, b: [P, N1, N2] float32 diagonal coefficient, Jacobi
        preconditioner and right-hand side.
    tol: [P] float32 absolute residual-norm thresholds.
    maxiter: int, CG step bound.

    Returns
    -------
    (x [P, N1, N2] float32, iters [P] int32)

    CUDA tensors launch the kernel on the current stream and add one to
    ``pcg_resident.launches``; CPU tensors run
    :func:`pcg_resident_reference`. Raises when a pair's operator exceeds
    the shared memory a block can get, when its product nodes exceed what
    a block holds in registers (:func:`resident_fits`), or when the launch
    fails.
    """
    P, M1, M2, N1, N2 = _check(T, esrc1, edst1, esrc2, edst2, diag,
                               precond, b, tol, maxiter)
    if T.device.type == 'cpu':
        return pcg_resident_reference(T, esrc1, edst1, esrc2, edst2, diag,
                                      precond, b, tol, maxiter)
    if T.device.type != 'cuda':
        raise ValueError(f'pcg_resident runs on CUDA or CPU, not {T.device}')
    return _launch_resident(T, esrc1, edst1, esrc2, edst2, diag, precond, b,
                            tol, maxiter)


def _launch_resident(T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
                     maxiter):
    """Launch ``csrc/pcg_resident.cu`` on checked CUDA operands
    ([P, M1, M2] T and so on) and count the launch."""
    P, M1, M2 = T.shape
    N1, N2 = diag.shape[1:]
    lib = _library()
    smem, limit = resident_smem(M1, M2, N1, N2, T.device)
    if smem > limit:
        raise ValueError(
            f'a pair with M1={M1}, M2={M2}, N1={N1}, N2={N2} needs {smem} '
            f'bytes of shared memory; a block can have {limit}. '
            'Such pairs run in pcg_stream.')
    if not lib.graphdot_pcg_resident_nodes_per_thread(N1, N2):
        raise ValueError(
            f'a pair of N1={N1} x N2={N2} product nodes exceeds the 3328 '
            '(13 a thread) that a block holds in registers. Such pairs run '
            'in pcg_stream.')
    x = torch.empty_like(b)
    iters = torch.empty(P, dtype=torch.int32, device=T.device)
    if P == 0:
        return x, iters
    with torch.cuda.device(_device_index(T.device)):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.graphdot_pcg_resident(
            T.data_ptr(), esrc1.data_ptr(), edst1.data_ptr(),
            esrc2.data_ptr(), edst2.data_ptr(), diag.data_ptr(),
            precond.data_ptr(), b.data_ptr(), tol.data_ptr(),
            x.data_ptr(), iters.data_ptr(),
            P, M1, M2, N1, N2, maxiter, stream)
    _raise_on(lib, err, 'pcg_resident launch')
    pcg_resident.launches += 1
    return x, iters


#: kernel launches of ``csrc/pcg_resident.cu`` in this process (by
#: :func:`pcg_resident`, and by :func:`pcg_packed` for one-member groups)
pcg_resident.launches = 0


def stream_ctas_per_pair(P, N1, grid):
    """The CTAs :func:`pcg_stream` gives each of P pairs by default: the
    cooperative grid of ``grid`` CTAs shared out, ``floor(grid / P)``, at
    least 1 (more pairs than the grid run in several launches) and at
    most N1 (a CTA owns at least one side-1 node)."""
    return max(1, min(grid // max(P, 1), N1))


def stream_grid(M1, M2, N1, N2, device):
    """The most CTAs of :func:`pcg_stream`'s solve that the CUDA ``device``
    holds at once, for pairs of these shapes: its cooperative grid."""
    lib = _stream_library()
    limit = _smem_limit(device)
    if not lib.graphdot_pcg_stream_smem_bytes(M1, M2, N1, N2, limit):
        raise ValueError(
            f'no tile of the streaming kernel fits {limit} bytes of shared '
            f'memory for a pair with M1={M1}, M2={M2}, N1={N1}, N2={N2}')
    grid = ctypes.c_int(0)
    with torch.cuda.device(_device_index(device)):
        err = lib.graphdot_pcg_stream_grid(M1, M2, N1, N2, limit,
                                           ctypes.byref(grid))
    _raise_on(lib, err, 'pcg_stream grid size')
    return grid.value


def pcg_stream(T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
               maxiter, ctas_per_pair=None):
    """Solve a batch of product-graph systems with the streaming CUDA PCG.

    Arguments and results as :func:`pcg_resident`. The kernel keeps T in
    device memory and streams it through shared memory in tiles once per
    CG step, so a pair of any edge count runs; the wrapper allocates the
    workspace (a copy of T sorted by edge source on both sides, the CG
    vectors and the sorted edge lists, about T's size again) with
    ``torch.empty``.

    The solve is one cooperative grid of G CTAs (:func:`stream_grid`, one
    an SM at protein shapes), C of them on each pair; ``ctas_per_pair``
    None takes C from :func:`stream_ctas_per_pair`, an int forces it
    (1 <= C <= G). More pairs than G // C run in several launches. The C
    used is kept in ``pcg_stream.last_ctas_per_pair``.

    CUDA tensors launch the kernel on the current stream and add one to
    ``pcg_stream.launches`` a call; CPU tensors run
    :func:`pcg_stream_reference`. Raises when no tile shape fits a block's
    shared memory (side 2 beyond about 9,800 nodes), for more than 65535
    pairs (the preprocessing grids' second dimension), for a C outside
    [1, G], or when a launch fails; a refused cooperative launch is not
    retried.
    """
    P, M1, M2, N1, N2 = _check(T, esrc1, edst1, esrc2, edst2, diag,
                               precond, b, tol, maxiter)
    if ctas_per_pair is not None and (
            not isinstance(ctas_per_pair, int) or ctas_per_pair < 1):
        raise ValueError(
            f'ctas_per_pair must be None or a positive int: '
            f'{ctas_per_pair!r}')
    if T.device.type == 'cpu':
        return pcg_stream_reference(T, esrc1, edst1, esrc2, edst2, diag,
                                    precond, b, tol, maxiter)
    if T.device.type != 'cuda':
        raise ValueError(f'pcg_stream runs on CUDA or CPU, not {T.device}')
    if P > 65535:
        raise ValueError(f'pcg_stream takes at most 65535 pairs a call, '
                         f'got {P}')
    lib = _stream_library()
    device = _device_index(T.device)
    limit = _smem_limit(T.device)
    grid = stream_grid(M1, M2, N1, N2, T.device)
    C = stream_ctas_per_pair(P, N1, grid) if ctas_per_pair is None \
        else ctas_per_pair
    if C > grid:
        raise ValueError(
            f'ctas_per_pair={C} exceeds the {grid} CTAs of a cooperative '
            'grid on this device')
    x = torch.empty_like(b)
    iters = torch.empty(P, dtype=torch.int32, device=T.device)
    if P == 0:
        return x, iters
    # freed when this returns: the caching allocator hands it out again
    # only to work queued after the launch on the same stream
    work = torch.empty(
        lib.graphdot_pcg_stream_workspace_bytes(P, M1, M2, N1, N2, grid),
        dtype=torch.uint8, device=T.device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.graphdot_pcg_stream(
            T.data_ptr(), esrc1.data_ptr(), edst1.data_ptr(),
            esrc2.data_ptr(), edst2.data_ptr(), diag.data_ptr(),
            precond.data_ptr(), b.data_ptr(), tol.data_ptr(),
            x.data_ptr(), iters.data_ptr(), work.data_ptr(),
            P, M1, M2, N1, N2, maxiter, C, grid, limit, stream)
    _raise_on(lib, err, 'pcg_stream launch')
    pcg_stream.launches += 1
    pcg_stream.last_ctas_per_pair = C
    return x, iters


#: kernel launches made by :func:`pcg_stream` in this process
pcg_stream.launches = 0
#: CTAs a pair of the last CUDA call of :func:`pcg_stream`
pcg_stream.last_ctas_per_pair = None


def pcg_packed(T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
               maxiter):
    """Solve groups of product-graph systems with the packed CUDA PCG: one
    PCG on the union of each group's k members, with shared step sizes
    (see :func:`pcg_packed_reference` for the semantics).

    Parameters
    ----------
    T: [S, ka, M1, M2] float32 edge-coupling matrices; ka is k (each member
        its own operator) or 1 (the k members share one).
    esrc1, edst1: [S, ka, M1] int32; esrc2, edst2: [S, ka, M2] int32.
    diag, precond: [S, ka, N1, N2] float32.
    b: [S, k, N1, N2] float32 right-hand sides, one a member.
    tol: [S] float32 absolute thresholds on the group's residual norm (the
        min over its members' own: :func:`group_pairs`).
    maxiter: int, CG step bound of a group.

    Returns
    -------
    (x [S, k, N1, N2] float32, iters [S] int32)

    CUDA tensors launch the kernel on the current stream and add one to
    ``pcg_packed.launches``; groups of one member (k = 1) launch
    ``csrc/pcg_resident.cu`` instead, the same problem, and add one to
    ``pcg_resident.launches``. CPU tensors run
    :func:`pcg_packed_reference`. Raises when a group does not run in one
    block (:func:`packed_fits`: k above :data:`PACKED_MAX_K`, the shared
    memory a block can get, or the registers of its members' CG state),
    naming the largest k that fits, or when the launch fails.
    """
    S, k, ka, M1, M2, N1, N2 = _check_packed(
        T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol, maxiter)
    if T.device.type == 'cpu':
        return pcg_packed_reference(T, esrc1, edst1, esrc2, edst2, diag,
                                    precond, b, tol, maxiter)
    if T.device.type != 'cuda':
        raise ValueError(f'pcg_packed runs on CUDA or CPU, not {T.device}')
    if k == 1:
        # [S, 1, ...] is [S, ...] in memory: pcg_resident's operands
        x, iters = _launch_resident(
            *(a[:, 0] for a in (T, esrc1, edst1, esrc2, edst2, diag,
                                precond, b)), tol, maxiter)
        return x[:, None], iters
    lib = _packed_library()
    shared = ka == 1
    if not packed_fits(k, M1, M2, N1, N2, T.device, shared):
        smem, limit = packed_smem(k, M1, M2, N1, N2, T.device, shared)
        fits = largest_packed_k(k, M1, M2, N1, N2, T.device, shared)
        raise ValueError(
            f'a group of k={k} members with M1={M1}, M2={M2}, N1={N1}, '
            f'N2={N2} ({"one shared" if shared else "one a member"} '
            f'operator) does not run in one block: it needs {smem} bytes '
            f'of shared memory (a block can have {limit}), at most '
            f'{PACKED_MAX_K} members, and (3 k + 2) floats of registers '
            f'for each of its N1 * N2 product nodes. The largest k that '
            f'fits is {fits}.')
    x = torch.empty_like(b)
    iters = torch.empty(S, dtype=torch.int32, device=T.device)
    if S == 0:
        return x, iters
    with torch.cuda.device(_device_index(T.device)):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.graphdot_pcg_packed(
            T.data_ptr(), esrc1.data_ptr(), edst1.data_ptr(),
            esrc2.data_ptr(), edst2.data_ptr(), diag.data_ptr(),
            precond.data_ptr(), b.data_ptr(), tol.data_ptr(),
            x.data_ptr(), iters.data_ptr(),
            S, k, ka, M1, M2, N1, N2, maxiter, stream)
    _raise_on(lib, err, 'pcg_packed launch')
    pcg_packed.launches += 1
    return x, iters


#: kernel launches made by :func:`pcg_packed` in this process
pcg_packed.launches = 0
