"""Row-sharded conjugate gradients for a GP's K^-1 y; counterpart of
``graphdot_tpu/parallel/solve.py``.

K lies over the ranks by blocks of rows, as the JAX module shards it over
its mesh; each step of the CG gathers the search direction once
(``all_gather``) and sums its dot products over the ranks
(``all_reduce``), with a Jacobi preconditioner from each rank's diagonal
block. The loop is driven from Python: each step's stopping test reads
the residual's norm on the host. The solve runs in the dtype of K and y:
float32 as the JAX module's, or float64, as the port's GP objectives run,
for a Gram whose condition number float32 cannot carry.
"""
import torch

from .mesh import sharded_along


def sharded_cg_solve_fn(mesh, axis='pairs', tol=1e-6, maxiter=1000):
    """``solve(K_rows, y_rows, alpha) -> x_rows`` with (K + alpha I) x = y.

    Parameters
    ----------
    mesh: :class:`~.mesh.Mesh`
    axis: the mesh axis (or axes) that K's rows and every vector split
        over; the ranks along it must divide n.
    tol: relative residual-norm stopping threshold.
    maxiter: step bound.

    Returns
    -------
    solve(K_rows [n / d, n], y_rows [n / d], alpha) -> x_rows [n / d], this
    rank's rows of each (``sharded_along(mesh, axis).local``).
    """
    def pdot(a, b):
        return mesh.all_reduce(torch.dot(a, b), axis)

    def solve(K_loc, y_loc, alpha):
        n_loc = y_loc.shape[0]
        row0 = mesh.axis_index(axis) * n_loc

        def matvec(p_loc):
            # one all-gather a step: the whole search direction
            return K_loc @ mesh.all_gather(p_loc, axis) + alpha * p_loc

        bnorm = torch.sqrt(pdot(y_loc, y_loc))
        atol = tol * torch.clamp(bnorm, min=1e-30)
        # Jacobi preconditioner from the local diagonal block
        diag = torch.diagonal(K_loc[:, row0:row0 + n_loc]) + alpha
        precond = 1.0 / torch.where(diag > 0, diag, 1.0)
        x = torch.zeros_like(y_loc)
        r = y_loc
        p = precond * y_loc
        rz = pdot(y_loc, p)
        it = 0
        while it < maxiter and bool(torch.sqrt(pdot(r, r)) > atol):
            Ap = matvec(p)
            pAp = pdot(p, Ap)
            alpha_k = rz / torch.where(pAp == 0, 1.0, pAp)
            x = x + alpha_k * p
            r = r - alpha_k * Ap
            z = precond * r
            rz_new = pdot(r, z)
            beta = rz_new / torch.where(rz == 0, 1.0, rz)
            p = z + beta * p
            rz = rz_new
            it += 1
        return x

    return solve


def sharded_gp_solve(mesh, K, y, alpha, axis='pairs', tol=1e-6,
                     maxiter=1000):
    """K^-1 y with K's rows split over ``axis``: K [n, n] and y [n] whole
    on every rank, the solution [n] whole on every rank. For repeated
    solves build the function once by :func:`sharded_cg_solve_fn`."""
    rows = sharded_along(mesh, axis)
    solve = sharded_cg_solve_fn(mesh, axis=axis, tol=tol, maxiter=maxiter)
    return rows.gather(solve(rows.local(K), rows.local(y), alpha))
