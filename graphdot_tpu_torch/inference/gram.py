"""Gram matrices over a fixed set of graphs as functions of the kernel's
hyperparameters; counterpart of ``graphdot_tpu/inference/gram.py``.

:class:`GramFactory` packs its graphs once, by padded-size class, into a
:class:`~graphdot_tpu_torch.kernel.marginalized._kernel.JobPlan` whose
tensors and job indices stay on the kernel's device. :meth:`GramFactory.gram`
then redoes only what depends on the hyperparameters: the product-graph
setup and the solves (``pcg_resident`` for the values and ``pcg_packed``
for the tangents on the card, ``pcg_stream`` or the sum-of-Kronecker route
for pairs beyond a block). It serves ``MarginalizedGraphKernel.__call__``
(non-nodal calls of 512 jobs or more) and the Gaussian-process fit.

Where the port differs from the JAX module:

- ``gram`` is a function of concrete hyperparameters, not a traced one.
  With ``eval_gradient`` it returns dK / d(log theta_active) itself, from
  the port's tangent systems (``mlgk_solve(tangents=True)``), where the
  JAX callers take ``jax.jacfwd(factory.gram)``. The tangents run at the
  kernel's ``gtol``, as every gradient of the port does; the JAX jacobian
  solves them at ``ftol``.
- A rectangular factory packs both lists together by size class: the
  symmetric and the rectangular job lists share one grouping, the plan of
  the per-call path.
- ``maxiter`` bounds each group's solves by ``min(n1 * n2, maxiter)``, the
  padded product of its two classes, as in the JAX module.
- ``kron_ranks='auto'`` calibrates on the Chebyshev domain of all the
  factory's real edges, the domain its solves use; under mode ``'cuda'``
  calibration happens only where a group would take the kron route
  (``JobPlan.kron_possible``: beyond a block, by ``resident_fits``, and
  beyond ``KRON_MIN_N``).

Not ported:

- union packing and ``union=``: groups of pairs packed into one CG were
  measured slower on the H100 than one pair a block (``PERF.md``);
- the one-hot gates ``_ONEHOT_BUDGET`` and ``_ONEHOT_JOB_ELEMS``: the card's
  kernels gather over the edge lists and build no incidence one-hots;
- ``reorder_by_iterations``: each pair stops at its own convergence in its
  own block;
- ``_group_ops_solve``: the sharded Gram of ``graphdot_tpu_torch.parallel``
  solves each rank's share through the plan's own chunk solve.
"""
import numpy as np
import torch

from ..kernel.marginalized._kernel import JobPlan
from ..kernel.marginalized._solver import (_detached, _plain_solve,
                                           mlgk_setup)
from ..util.iterable import flatten
from ..util.trace import spanned


class GramFactory:
    """Gram matrices of a ``MarginalizedGraphKernel`` over a fixed graph
    set, at any hyperparameters.

    Parameters
    ----------
    kernel: MarginalizedGraphKernel, or a ``Normalization`` of one (then
        ``normalize`` is set).
    graphs: list of Graph
    normalize: bool
        Return the cosine-normalized Gram K_ij / sqrt(K_ii K_jj).
    buckets: 'auto' | bool
        Solve the jobs by padded-size class, each class packed to its own
        size; 'auto' does so when the graphs span more than one class.
    node_align: int
        Padded node counts are multiples of this.
    maxiter: int or None
        Cap on the CG steps of each solve (default: 10000); each group's
        solves stop at ``min(n1 * n2, maxiter)`` steps.
    graphs2: list of Graph or None
        When given, the factory is rectangular: its jobs are the cross
        product of ``graphs`` and ``graphs2``, and ``gram`` returns
        [len(graphs), len(graphs2)]. Normalize such a Gram with each side's
        diagonal: ``normalize`` must be False.
    kron_ranks: 'auto' | None | int | tuple | 'off'
        Chebyshev ranks of the sum-of-Kronecker route
        (``kernel/marginalized/_kron.py``). 'auto' calibrates the
        per-feature rank against ``factorization_error`` at the kernel's
        hyperparameters whenever a group would take the route; under
        backend 'cuda' an error above 1e-4 sets 'off' (those pairs run in
        ``pcg_stream``), backend 'kron' keeps the best rung and warns. None
        is the module default, an int or a tuple forces the ranks, 'off'
        keeps backend 'cuda' off the route (and raises under backend
        'kron', which has no other route). Call :meth:`recalibrate_kron`
        after large hyperparameter moves; at the theta of the last
        calibration it keeps the ranks it has.
    """

    def __init__(self, kernel, graphs, normalize=True, buckets='auto',
                 node_align=8, maxiter=None, graphs2=None, kron_ranks='auto'):
        if maxiter is None:
            self._maxiter_cap = 10000
        elif int(maxiter) >= 1:
            self._maxiter_cap = int(maxiter)
        else:
            raise ValueError(f'maxiter must be >= 1, got {maxiter!r}.')
        # unwrap a Normalization fix
        if hasattr(kernel, 'kernel') and not hasattr(kernel, 'node_kernel'):
            kernel = kernel.kernel
            normalize = True
        self.kernel = kernel
        self.graphs = list(graphs)
        self._two = graphs2 is not None
        if self._two:
            if normalize:
                raise ValueError(
                    'normalize is not supported for rectangular (X, Y) '
                    'factories; normalize with per-side diagonals.')
            self.graphs2 = list(graphs2)
        else:
            self.graphs2 = self.graphs
        self.normalize = normalize
        self._n, self._n2 = len(self.graphs), len(self.graphs2)
        if self._two:
            ii, jj = np.indices((self._n, self._n2))
            iu, ju = ii.ravel(), jj.ravel()
            plan_graphs, j_jobs = self.graphs + self.graphs2, ju + self._n
        else:
            iu, ju = np.triu_indices(self._n)
            plan_graphs, j_jobs = self.graphs, ju

        self._n_p = len(list(flatten(kernel.p.theta)))
        self._active = np.asarray(kernel.active_theta_mask)
        self._full0 = np.asarray(kernel.flat_hyperparameters, dtype=float)
        self._plan = JobPlan(kernel, plan_graphs, iu, j_jobs, buckets,
                             node_align)
        for grp in self._plan.groups:
            # each job's place in K
            grp['rows'] = torch.as_tensor(iu[grp['pos']], device=kernel.device)
            grp['cols'] = torch.as_tensor(ju[grp['pos']], device=kernel.device)
        if self._kron_possible():
            self._calibrate_kron(None, kron_ranks)

    def _kron_possible(self):
        """Whether a group of this factory would take the sum-of-Kronecker
        route once calibrated (``JobPlan.kron_possible``: backend 'kron',
        or 'cuda' with a group whose pairs do not fit a block by
        ``resident_fits`` and exceed ``KRON_MIN_N``), with kron-eligible
        edge features."""
        return self._plan.kron_possible()

    def _calibrate_kron(self, theta_log_active=None, ranks='auto'):
        """Set the plan's kron ranks at ``theta_log_active`` (default: the
        kernel's hyperparameters at construction), on the host."""
        full = self._full0 if theta_log_active is None else \
            self.full_theta(theta_log_active).cpu().numpy()
        return self._plan.calibrate_kron(torch.as_tensor(full), ranks)

    @property
    def _kron_ranks(self):
        """The kron route's ranks (a tuple a feature, or 'off'), None when
        no group takes the route."""
        return None if self._plan.kron is None else self._plan.kron.ranks

    def recalibrate_kron(self, theta_log_active):
        """Calibrate the kron ranks again at ``theta_log_active`` (log-scale
        active hyperparameters) and keep them for later builds. Returns the
        ranks: None when no group takes the route, 'off' when the
        factorization misses the accuracy limit under backend 'cuda'."""
        if not self._kron_possible():
            return None
        return self._calibrate_kron(theta_log_active).ranks

    @property
    def n_active(self):
        return int(self._active.sum())

    @property
    def theta0(self):
        """Log-scale active hyperparameters of the kernel at construction."""
        return np.log(self._full0[self._active])

    def full_theta(self, theta_log_active):
        """The full linear-scale hyperparameter vector with the active
        entries at exp(``theta_log_active``) and the fixed ones kept, as a
        float32 tensor on the kernel's device; [C, n_full] for C rows of
        ``theta_log_active``."""
        t = torch.as_tensor(theta_log_active).detach().to('cpu',
                                                          torch.float64)
        full = torch.tensor(self._full0, dtype=torch.float64).expand(
            *t.shape[:-1], len(self._full0)).clone()
        full[..., torch.as_tensor(np.flatnonzero(self._active))] = \
            torch.exp(t)
        return full.to(self.kernel.device, torch.float32)

    def _group_maxiter(self, grp):
        return min(grp['n1'] * grp['n2'], self._maxiter_cap)

    @spanned('gram_factory')
    def gram(self, theta_log_active, lmin=0, with_residual=False,
             eval_gradient=False):
        """The (normalized, when ``normalize``) Gram at log-scale active
        hyperparameters: K [n, n2] as a float32 tensor on the kernel's
        device.

        With ``eval_gradient``, also dK / d(log theta_active) [n, n2,
        n_active]. With ``with_residual``, also, last, the worst relative
        residual ``||b - A x|| / ||b||`` of the value solves, a float:
        converged float32 solves give about 1e-7..1e-5, and far more means
        that ``maxiter`` cut solves short at this theta.

        ``theta_log_active`` may also be [C, n_active], C hyperparameter
        vectors (the chains of a sampler): K is then [C, n, n2], dK [C, n,
        n2, n_active], and the residual a [C] numpy array, each equal to C
        calls of one vector. On the resident route each chunk's value
        systems for all C vectors go to the card in one ``pcg_resident``
        launch and its tangent systems in one ``pcg_packed`` launch, with
        the setup and its jacobian vectorized over the C vectors; groups on
        the ``pcg_stream`` and kron routes solve the C vectors one after
        another (:meth:`JobPlan.solve`).
        """
        theta = self.full_theta(theta_log_active)
        batched = theta.dim() == 2
        thetas = theta if batched else theta[None]
        C = thetas.shape[0]
        active = torch.as_tensor(np.flatnonzero(self._active),
                                 device=theta.device)
        K = theta.new_zeros(C, self._n, self._n2)
        dK = theta.new_zeros(C, self._n, self._n2, len(active)) \
            if eval_gradient else None
        worst = torch.zeros(C, dtype=torch.float64)
        for grp in self._plan.groups:
            outs = list(self._plan.solve(
                theta, grp, False, lmin, eval_gradient,
                maxiter=self._group_maxiter(grp),
                with_residual=with_residual))
            if not batched:
                outs = [tuple(None if o is None else o[None] for o in out)
                        for out in outs]
            rows, cols = grp['rows'], grp['cols']
            r = torch.cat([o[0] for o in outs], dim=1)
            K[:, rows, cols] = r
            if not self._two:
                K[:, cols, rows] = r
            if eval_gradient:
                dr = torch.cat([o[1] for o in outs], dim=1)[..., active]
                dK[:, rows, cols] = dr
                if not self._two:
                    dK[:, cols, rows] = dr
            if with_residual:
                worst = torch.maximum(worst, torch.cat(
                    [o[2] for o in outs], dim=1).amax(dim=1).cpu().double())

        if self.normalize:
            diag = torch.diagonal(K, dim1=-2, dim2=-1)
            d = torch.sqrt(diag)
            outer = d[:, :, None] * d[:, None, :]
            K = K / d[:, :, None] / d[:, None, :]
            if eval_gradient:
                # d(R_ij / sqrt(R_ii R_jj)) = dR_ij / sqrt(R_ii R_jj)
                #     - K_ij / 2 * (dR_ii / R_ii + dR_jj / R_jj)
                ratio = torch.diagonal(dK, dim1=1, dim2=2).transpose(1, 2) \
                    / diag[:, :, None]
                dK = dK / outer[..., None] - 0.5 * K[..., None] * (
                    ratio[:, :, None, :] + ratio[:, None, :, :])
        if eval_gradient:
            dK = dK * thetas[:, None, None, active]   # d / d log theta
        if not batched:
            K = K[0]
            dK = None if dK is None else dK[0]
        out = (K,)
        if eval_gradient:
            out += (dK,)
        if with_residual:
            out += (worst.numpy() if batched else float(worst[0]),)
        return out if len(out) > 1 else K

    def iteration_stats(self, theta_log_active, lmin=0):
        """CG steps of every pair at ``theta_log_active``, group by group
        (``lmin`` changes no solve and is kept for the JAX signature):
        the value solves run in the plain :func:`~graphdot_tpu_torch.ops.
        pcg.pcg` with a count a pair, as the JAX module counts them in its
        XLA solver, over T, or over the kron factors for a group on the
        kron route.

        Returns a list of dicts, one a group, with ``n_jobs``, ``ca`` and
        ``cb`` (the padded node counts of its two classes), ``m1`` and
        ``m2`` (padded directed edges; 0 in mode ``'dense'``), ``k1 = k2 =
        1`` (no union packing), ``iters`` ([n_jobs] int array) and ``gi``,
        ``gj`` (each job's row and column in K).
        """
        kernel = self.kernel
        mode = kernel.backend.mode
        theta = self.full_theta(theta_log_active)
        stats = []
        for grp in self._plan.groups:
            iters = []
            grp_mode = 'kron' if self._plan.route(grp) == 'kron' else mode
            for _, idx1, idx2 in self._plan.chunks(grp):
                ops = kernel._operands(grp['bd1'], grp['bd2'], idx1, idx2)
                s = _detached(mlgk_setup(
                    theta, ops, knode=kernel.node_kernel,
                    kedge=kernel.edge_kernel, n_p_theta=self._n_p,
                    mode=grp_mode, kron=self._plan.kron))
                iters.append(_plain_solve(
                    s, grp_mode, s['b'].unsqueeze(1), s['tol'],
                    self._group_maxiter(grp), return_iters=True)[1])
            m1 = m2 = 0
            if mode != 'dense':
                m1 = grp['bd1']['esrc'].shape[1]
                m2 = grp['bd2']['esrc'].shape[1]
            stats.append({
                'n_jobs': len(grp['pos']), 'ca': grp['n1'], 'cb': grp['n2'],
                'k1': 1, 'k2': 1, 'm1': int(m1), 'm2': int(m2),
                'iters': torch.cat(iters).cpu().numpy(),
                'gi': grp['rows'].cpu().numpy(),
                'gj': grp['cols'].cpu().numpy(),
            })
        return stats
