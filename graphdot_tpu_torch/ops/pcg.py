"""Product-graph PCG: the CUDA kernels' wrappers and their plain PyTorch
twins.

Counterpart of ``graphdot_tpu/ops/pallas_pcg.py``: ``pallas_pcg`` (the
``k == 1`` branch of ``pallas_pcg_solver`` and ``_cg_solve_values``) and
``pallas_pcg_stream`` (``_stream_solver``). Every function here solves,
for every pair p of a batch,

    [diag o Y - S1^T (T o (D1 Y D2^T)) S2] x = b

by Jacobi-PCG from x = 0 and stop each pair at ``sqrt(r.r) < tol[p]`` or
after ``maxiter`` steps. The incidence matrices S and D are given as edge
lists (``esrc``/``edst`` indices), not as one-hot matrices.

- :func:`pcg_resident` launches ``csrc/pcg_resident.cu`` on CUDA tensors
  (one CTA per pair, all CG state in shared memory). Given CPU tensors it
  runs :func:`pcg_resident_reference` instead; it never falls back from the
  card to anything else.
- :func:`pcg_resident_reference` is the same function in plain torch:
  batched over pairs with done masks, the matvec by ``index_select`` and
  ``index_add_`` over the same edge lists.
- :func:`pcg_stream` launches ``csrc/pcg_stream.cu`` on CUDA tensors (one
  CTA per pair, T streamed from device memory in tiles, the CG vectors in
  a device workspace), for pairs beyond a block's shared memory. Given CPU
  tensors it runs :func:`pcg_stream_reference`.
- :func:`pcg_stream_reference` is its plain twin, the same function as
  :func:`pcg_resident_reference`.
"""
import ctypes
import functools

import torch

from . import _build


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


def gather_offdiag(T, esrc1, edst1, esrc2, edst2, Y):
    """The off-diagonal product-graph matvec in gather form:

    ``out[p,i1,i2] = sum_{e1: src1=i1} sum_{e2: src2=i2}
    T[p,e1,e2] Y[p, dst1(e1), dst2(e2)]``

    T [P,M1,M2]; esrc1/edst1 [P,M1] and esrc2/edst2 [P,M2] integer tensors;
    Y [P,N1,N2]. Returns [P,N1,N2]."""
    P, N1, N2 = Y.shape
    M1, M2 = T.shape[1:]
    base1 = torch.arange(P, device=Y.device)[:, None] * N1
    base2 = torch.arange(P, device=Y.device)[:, None] * N2
    dst1 = (base1 + edst1).reshape(-1)
    dst2 = (base2 + edst2).reshape(-1)
    src1 = (base1 + esrc1).reshape(-1)
    src2 = (base2 + esrc2).reshape(-1)
    # G[p,e1,:] = Y[p, dst1(e1), :]
    G = Y.reshape(P * N1, N2).index_select(0, dst1).view(P, M1, N2)
    # H[p,e1,e2] = G[p, e1, dst2(e2)]  (selected from G^T by rows)
    Ht = G.transpose(1, 2).reshape(P * N2, M1).index_select(0, dst2)
    Z = T * Ht.view(P, M2, M1).transpose(1, 2)
    # U[p,e1,i2] = sum_{e2: src2=i2} Z[p,e1,e2]
    Ut = torch.zeros(P * N2, M1, dtype=Y.dtype, device=Y.device)
    Ut.index_add_(0, src2, Z.transpose(1, 2).reshape(P * M2, M1))
    U = Ut.view(P, N2, M1).transpose(1, 2).reshape(P * M1, N2)
    # out[p,i1,i2] = sum_{e1: src1=i1} U[p,e1,i2]
    out = torch.zeros(P * N1, N2, dtype=Y.dtype, device=Y.device)
    out.index_add_(0, src1, U)
    return out.view(P, N1, N2)


def _check(T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol, maxiter):
    """Validate the operands of both solvers; returns (P, M1, M2, N1, N2)."""
    if T.dim() != 3:
        raise ValueError(f'T must be [P, M1, M2], got {tuple(T.shape)}')
    P, M1, M2 = T.shape
    if diag.dim() != 3 or diag.shape[0] != P:
        raise ValueError(
            f'diag must be [P={P}, N1, N2], got {tuple(diag.shape)}')
    N1, N2 = diag.shape[1:]
    shapes = {
        'esrc1': (esrc1, (P, M1), torch.int32),
        'edst1': (edst1, (P, M1), torch.int32),
        'esrc2': (esrc2, (P, M2), torch.int32),
        'edst2': (edst2, (P, M2), torch.int32),
        'T': (T, (P, M1, M2), torch.float32),
        'diag': (diag, (P, N1, N2), torch.float32),
        'precond': (precond, (P, N1, N2), torch.float32),
        'b': (b, (P, N1, N2), torch.float32),
        'tol': (tol, (P,), torch.float32),
    }
    for name, (t, shape, dtype) in shapes.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f'{name} must be a torch.Tensor')
        if tuple(t.shape) != shape:
            raise ValueError(
                f'{name} must have shape {shape}, got {tuple(t.shape)}')
        if t.dtype != dtype:
            raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
        if t.device != T.device:
            raise ValueError(
                f'{name} is on {t.device}, T is on {T.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if not isinstance(maxiter, int) or maxiter < 0:
        raise ValueError(f'maxiter must be a non-negative int: {maxiter!r}')
    # one device-to-host sync for all four index lists
    bad = torch.zeros((), dtype=torch.bool, device=T.device)
    for e, n in ((esrc1, N1), (edst1, N1), (esrc2, N2), (edst2, N2)):
        bad = bad | ((e < 0) | (e >= n)).any()
    if bool(bad):
        raise ValueError('edge indices out of range of the node counts')
    return P, M1, M2, N1, N2


def _plain_pcg(T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
               maxiter):
    """The solve of both kernels in plain torch: :func:`pcg` over the
    matvec of :func:`gather_offdiag`."""
    P, M1, M2, N1, N2 = _check(T, esrc1, edst1, esrc2, edst2, diag,
                               precond, b, tol, maxiter)
    N = N1 * N2
    e1s, e1d, e2s, e2d = (e.long() for e in (esrc1, edst1, esrc2, edst2))
    diag_flat = diag.reshape(P, N)

    def matvec(y):
        off = gather_offdiag(T, e1s, e1d, e2s, e2d, y.view(P, N1, N2))
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
    lib.graphdot_cuda_error_string.argtypes = [cint]
    lib.graphdot_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _stream_library():
    """The built streaming-kernel library, with its C signatures."""
    lib = _build.load('pcg_stream')
    ptr, cint, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.graphdot_pcg_stream.argtypes = [ptr] * 12 + [cint] * 7 + [ptr]
    lib.graphdot_pcg_stream.restype = cint
    lib.graphdot_pcg_stream_smem_bytes.argtypes = [cint] * 5
    lib.graphdot_pcg_stream_smem_bytes.restype = size
    lib.graphdot_pcg_stream_workspace_bytes.argtypes = [cint] * 5
    lib.graphdot_pcg_stream_workspace_bytes.restype = size
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
    :func:`pcg_resident_reference`. Raises when a pair's working set
    exceeds the shared memory a block can get, or when the launch fails.
    """
    P, M1, M2, N1, N2 = _check(T, esrc1, edst1, esrc2, edst2, diag,
                               precond, b, tol, maxiter)
    if T.device.type == 'cpu':
        return pcg_resident_reference(T, esrc1, edst1, esrc2, edst2, diag,
                                      precond, b, tol, maxiter)
    if T.device.type != 'cuda':
        raise ValueError(f'pcg_resident runs on CUDA or CPU, not {T.device}')
    lib = _library()
    device = _device_index(T.device)
    smem, limit = resident_smem(M1, M2, N1, N2, T.device)
    if smem > limit:
        raise ValueError(
            f'a pair with M1={M1}, M2={M2}, N1={N1}, N2={N2} needs {smem} '
            f'bytes of shared memory; a block can have {limit}. '
            'Such pairs run in pcg_stream.')
    x = torch.empty_like(b)
    iters = torch.empty(P, dtype=torch.int32, device=T.device)
    if P == 0:
        return x, iters
    with torch.cuda.device(device):
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


#: kernel launches made by :func:`pcg_resident` in this process
pcg_resident.launches = 0


def pcg_stream(T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
               maxiter):
    """Solve a batch of product-graph systems with the streaming CUDA PCG.

    Arguments and results as :func:`pcg_resident`. The kernel keeps T in
    device memory and streams it through shared memory in tiles once per
    CG step, so a pair of any edge count runs; the wrapper allocates the
    workspace (a copy of T sorted by edge source on both sides, the CG
    vectors and the sorted edge lists, about T's size again) with
    ``torch.empty``.

    CUDA tensors launch the kernel on the current stream and add one to
    ``pcg_stream.launches``; CPU tensors run :func:`pcg_stream_reference`.
    Raises when no tile shape fits a block's shared memory (side 2 beyond
    about 9,800 nodes), for more than 65535 pairs (the grid's second
    dimension), or when a launch fails.
    """
    P, M1, M2, N1, N2 = _check(T, esrc1, edst1, esrc2, edst2, diag,
                               precond, b, tol, maxiter)
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
    if not lib.graphdot_pcg_stream_smem_bytes(M1, M2, N1, N2, limit):
        raise ValueError(
            f'no tile of the streaming kernel fits {limit} bytes of shared '
            f'memory for a pair with M1={M1}, M2={M2}, N1={N1}, N2={N2}')
    x = torch.empty_like(b)
    iters = torch.empty(P, dtype=torch.int32, device=T.device)
    if P == 0:
        return x, iters
    # freed when this returns: the caching allocator hands it out again
    # only to work queued after the launch on the same stream
    work = torch.empty(
        lib.graphdot_pcg_stream_workspace_bytes(P, M1, M2, N1, N2),
        dtype=torch.uint8, device=T.device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.graphdot_pcg_stream(
            T.data_ptr(), esrc1.data_ptr(), edst1.data_ptr(),
            esrc2.data_ptr(), edst2.data_ptr(), diag.data_ptr(),
            precond.data_ptr(), b.data_ptr(), tol.data_ptr(),
            x.data_ptr(), iters.data_ptr(), work.data_ptr(),
            P, M1, M2, N1, N2, maxiter, limit, stream)
    _raise_on(lib, err, 'pcg_stream launch')
    pcg_stream.launches += 1
    return x, iters


#: kernel launches made by :func:`pcg_stream` in this process
pcg_stream.launches = 0
