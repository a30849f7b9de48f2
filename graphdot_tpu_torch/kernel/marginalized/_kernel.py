"""Marginalized graph kernel — host-side orchestration; counterpart of
``graphdot_tpu/kernel/marginalized/_kernel.py`` (``__call__``, ``diag``,
the sklearn-compatible ``theta``/``bounds``/``clone_with_theta``).

The job list (upper-triangular or rectangular index set) is grouped by
size class and cut into chunks of pair indices (:class:`JobPlan`), gathered
on the kernel's device; all pairs in a chunk are solved at once by
:func:`._solver.mlgk_solve`. Every tensor lives on the ``device`` given to
the kernel. With ``eval_gradient=True`` each chunk also solves the tangent
systems of every hyperparameter (forward mode, as the JAX package's
``jax.jacfwd``), and the results carry d K / d theta on the linear scale.
Non-nodal calls of 512 jobs or more run through a cached
``GramFactory``, which keeps its plan across calls. Where a chunk may take
the sum-of-Kronecker route (``backend='kron'``, or ``'cuda'`` beyond a block
with kron-eligible edge features), every call calibrates the Chebyshev
ranks at its own hyperparameters first (:meth:`JobPlan.calibrate_kron`).
The hotspot gradient of the MaxiMin metric (:meth:`MarginalizedGraphKernel.
_solve_hotspot_grads`, the JAX class's ``grad='hotspot'``) gathers one
nodal entry a pair and its gradient on the device, chunk by chunk.
"""
import copy
import numbers
import os
import warnings
from collections import namedtuple

import numpy as np
import torch

from ...util import Timer
from ...util.iterable import fold_like, flatten
from ...util.pretty_tuple import pretty_tuple
from ...graph import Graph, batch_graphs
from ...ops.pcg import edge_segments
from ._backend import backend_factory, resolve_device
from ._kron import (ACCURACY_LIMIT, DEFAULT_RANK, KronPlan, _normalize_ranks,
                    calibrate_ranks, kron_domain, kron_eligible_feats)
from ._solver import (_apply_on_features, _split_theta, chunk_route,
                      mlgk_solve, weight_by_p)
from .starting_probability import StartingProbability, Uniform, Adhoc


#: working-set budget, in floats, of a chunk of pairs that runs in
#: ``pcg_stream``
STREAM_CHUNK_FLOATS = 1 << 30
#: working-set budget, in floats, of a chunk of pairs on the kron route
KRON_CHUNK_FLOATS = 1 << 30
#: the most a batched solve's budget grows to, in floats, with its C copies
#: of each pair: C * 2^26 up to 2^29, so that C <= 8 hyperparameter vectors
#: share the chunks of one (each chunk costs a ``jacfwd`` on the host)
BATCHED_CHUNK_FLOATS = 1 << 29


def _tree_map(f, tree):
    """Apply ``f`` to the leaves of a feature pytree (dicts of arrays or of
    (values, mask) tuples)."""
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(f, v) for v in tree)
    return f(tree)


class JobPlan:
    """Pair jobs (i_jobs[k], j_jobs[k]) over one list of graphs, grouped by
    padded-size class, each class packed once, every tensor on the
    kernel's device.

    With ``buckets`` (True, or ``'auto'`` when the graphs span more than one
    class of ``node_align`` nodes) each class is packed on its own, else
    all graphs form one batch. A job joins the group of its two classes,
    the smaller first: a job whose first graph lies in the larger class is
    solved as (j, i) and marked in ``swap``. Each group (a dict) holds the
    two classes' device tensors (``bd1``, ``bd2``, ``pf1``, ``pf2``), the
    local indices of its jobs on the device (``l1``, ``l2``), their places
    in the job list (``pos``), ``swap``, and the padded sizes ``n1``,
    ``n2`` and ``m_pad``.

    The per-call path (:meth:`MarginalizedGraphKernel._solve_jobs`) builds
    one a call and throws it away; ``graphdot_tpu_torch.inference.
    GramFactory`` keeps one across hyperparameters. Both run its groups
    through :meth:`solve`, each group by its :meth:`route`, with ``kron``
    (a :class:`~._kron.KronPlan` from :meth:`calibrate_kron`, or None) for
    the kron route.
    """

    def __init__(self, kernel, graphs, i_jobs, j_jobs, buckets,
                 node_align=8):
        self.kernel = kernel
        self.i_jobs = np.asarray(i_jobs, dtype=np.int64)
        self.j_jobs = np.asarray(j_jobs, dtype=np.int64)
        classes = kernel._size_classes(graphs, node_align)
        if buckets == 'auto':
            buckets = len(classes) > 1
        if buckets:
            members = [classes[c] for c in sorted(classes)]
        else:
            members = [list(range(len(graphs)))]
        class_of = np.zeros(len(graphs), dtype=np.int64)
        local_of = np.zeros(len(graphs), dtype=np.int64)
        batches = []
        self.kron = None
        self._kron_theta = None     # the theta of the last 'auto' ranks
        for c, idx in enumerate(members):
            class_of[idx] = c
            local_of[idx] = np.arange(len(idx))
            batches.append(kernel._prepare_batch(
                [graphs[g] for g in idx], node_align))
        self.n_classes = len(batches)
        # the numpy edge lists of each class, for the kron domain and rank
        # calibration
        self._edges = [(b.edge_elist_feats, b.ew) for b, _, _ in batches] \
            if kernel.backend.mode in ('cuda', 'kron') else None
        self.kron_eligible = self._edges is not None and \
            kron_eligible_feats(self._edges[0][0], self._edges[0][0])

        ca, cb = class_of[self.i_jobs], class_of[self.j_jobs]
        swap = ca > cb
        first = np.where(swap, self.j_jobs, self.i_jobs)
        second = np.where(swap, self.i_jobs, self.j_jobs)
        key = np.minimum(ca, cb) * len(batches) + np.maximum(ca, cb)
        device = kernel.device
        self.groups = []
        for k in np.unique(key):
            pos = np.flatnonzero(key == k)
            (b1, bd1, pf1), (b2, bd2, pf2) = (
                batches[c] for c in divmod(int(k), len(batches)))
            self.groups.append({
                'bd1': bd1, 'bd2': bd2, 'pf1': pf1, 'pf2': pf2,
                'n1': b1.node_mask.shape[1], 'n2': b2.node_mask.shape[1],
                'm_pad': max(b1.esrc.shape[1], b2.esrc.shape[1]),
                'pos': pos, 'swap': swap[pos],
                'l1': torch.as_tensor(local_of[first[pos]], device=device),
                'l2': torch.as_tensor(local_of[second[pos]], device=device),
            })

    def route(self, grp, ranks=None):
        """The route of the group's chunks (:func:`._solver.chunk_route`):
        ``'kron'``, ``'resident'``, ``'stream'``, or the plain mode. It is
        named here only: :meth:`solve` hands it to every chunk's solve, and
        :meth:`chunks` sizes the chunks for it. ``ranks`` (default: those
        of :attr:`kron`) are the calibrated ranks the rule reads."""
        mode = self.kernel.backend.mode
        if mode not in ('cuda', 'kron'):
            return mode
        if ranks is None and self.kron is not None:
            ranks = self.kron.ranks
        return chunk_route(mode, grp['bd1']['esrc'].shape[1],
                           grp['bd2']['esrc'].shape[1], grp['n1'], grp['n2'],
                           self.kernel.device, self.kron_eligible, ranks)

    def kron_possible(self):
        """Whether a group would take the kron route once calibrated: its
        :meth:`route` under the default grid of the edge features (mode
        ``'kron'``, or ``'cuda'`` with a group beyond a block and beyond
        ``KRON_MIN_N``), with kron-eligible edge features."""
        if not self.kron_eligible:
            return False
        grid = _normalize_ranks(None, sorted(self._edges[0][0]))
        return any(self.route(grp, grid) == 'kron' for grp in self.groups)

    def calibrate_kron(self, theta, ranks='auto'):
        """Set :attr:`kron` for the hyperparameters ``theta`` (the full
        linear-scale vector): the Chebyshev domain of every edge feature
        over the real edges of all the plan's graphs, and the ranks:
        ``'auto'`` calibrates them on the host (:func:`._kron.
        calibrate_ranks`, on that domain), and in mode ``'cuda'`` an error
        above ``ACCURACY_LIMIT`` sets ``'off'`` (the pairs stay in
        ``pcg_stream``) where mode ``'kron'`` keeps the best rung and
        warns; None is the default grid, an int or a tuple forces them,
        ``'off'`` keeps mode ``'cuda'`` off the route, and raises in mode
        ``'kron'``, which has no other route. ``'auto'`` at the theta of
        the last calibration keeps its plan. Returns the plan."""
        mode = self.kernel.backend.mode
        if isinstance(ranks, str) and ranks == 'off' and mode == 'kron':
            raise ValueError(
                "kron_ranks='off' under backend 'kron': the kron route is "
                "the only route of that backend")
        theta = torch.as_tensor(theta).detach().to('cpu', torch.float32)
        auto = isinstance(ranks, str) and ranks == 'auto'
        if auto and self.kron is not None and self._kron_theta is not None \
                and torch.equal(theta, self._kron_theta):
            return self.kron
        names = sorted(self._edges[0][0])
        feats = {n: torch.from_numpy(np.concatenate(
            [f[n][ew != 0] for f, ew in self._edges]))[None]
            for n in names}
        ones = torch.ones_like(feats[names[0]])
        domain = kron_domain(feats, ones, feats, ones)
        err = None
        if ranks == 'auto':
            kernel = self.kernel
            te = _split_theta(theta, kernel.node_kernel, kernel.edge_kernel,
                              len(list(flatten(kernel.p.theta))))[2]
            ranks, err = calibrate_ranks(
                _apply_on_features, kernel.edge_kernel, te, feats, ones,
                feats, ones, domain=domain)
            if mode == 'cuda' and err > ACCURACY_LIMIT:
                ranks = 'off'
        elif not (isinstance(ranks, str) and ranks == 'off'):
            ranks = _normalize_ranks(ranks, names)
        self.kron = KronPlan(ranks, domain, err)
        self._kron_theta = theta if auto else None
        return self.kron

    def chunks(self, grp, eval_gradient=False, nodal=False, copies=1):
        """The group's jobs as (start, local indices 1, local indices 2) in
        chunks of :meth:`MarginalizedGraphKernel._chunk_size` pairs, sized
        for the group's :meth:`route`, with ``copies`` systems a pair (one
        a hyperparameter vector of a batched solve)."""
        route = self.route(grp)
        grid = None
        if route == 'kron':
            ranks = None if self.kron is None else self.kron.ranks
            grid = int(np.prod(_normalize_ranks(
                ranks, sorted(grp['bd1']['edge_elist_feats']))))
        chunk = self.kernel._chunk_size(max(grp['n1'], grp['n2']),
                                        grp['m_pad'], eval_gradient, nodal,
                                        route=route, grid=grid,
                                        copies=copies)
        for s in range(0, len(grp['pos']), chunk):
            yield s, grp['l1'][s:s + chunk], grp['l2'][s:s + chunk]

    def solve(self, theta, grp, nodal, lmin, eval_gradient=False,
              maxiter=None, with_residual=False, hotspot=None):
        """Solve a group's jobs chunk by chunk; yields
        :meth:`MarginalizedGraphKernel._solve_chunk`'s result for each, in
        the group's :meth:`route`.

        ``theta`` may be [C, n_theta]: each result then leads with C. On the
        resident route (and the plain modes) a chunk's C * P systems are
        solved together, in chunks that count the C copies of each pair; on
        the ``pcg_stream`` and kron routes the C thetas run one after
        another. ``hotspot`` (one theta only) is a pair of index tensors
        over the group's jobs, in the orientation they are solved in: each
        chunk then yields one nodal entry a pair (``_solve_chunk``)."""
        route = self.route(grp)
        batched = theta.dim() == 2
        if batched and hotspot is not None:
            raise ValueError('hotspot entries are solved at one theta')
        one_by_one = batched and route in ('stream', 'kron')
        copies = theta.shape[0] if batched and not one_by_one else 1
        for s, idx1, idx2 in self.chunks(grp, eval_gradient, nodal, copies):
            hot = None if hotspot is None else \
                tuple(h[s:s + len(idx1)] for h in hotspot)

            def solve(t):
                return self.kernel._solve_chunk(
                    t, grp['bd1'], grp['bd2'], idx1, idx2, grp['pf1'],
                    grp['pf2'], nodal, lmin, eval_gradient, maxiter=maxiter,
                    with_residual=with_residual, kron=self.kron,
                    route=route, hotspot=hot)
            if one_by_one:
                yield tuple(None if o[0] is None else torch.stack(o)
                            for o in zip(*(solve(t) for t in theta)))
            else:
                yield solve(theta)


class MarginalizedGraphKernel:
    """Implements the random-walk-based graph similarity kernel proposed
    in Kashima, Tsuda & Inokuchi (ICML 2003) and accelerated per Tang &
    de Jong (2019).

    Parameters
    ----------
    node_kernel: microkernel
        Computes the similarity between individual nodes.
    edge_kernel: microkernel
        Computes the similarity between individual edges.
    p: positive number (default=1.0) or StartingProbability
        The starting probability of the random walk on each node.
    q: float in (0, 1)
        The probability for the random walk to stop during each step.
    q_bounds: pair of floats
        Optimization bounds of q.
    eps, ftol, gtol: floats
        eps is kept for API parity with the JAX class (a finite-difference
        step there; unused, gradients are exact). ftol is the CG
        convergence tolerance of the kernel-value solve (stop at
        sqrt(rTr) < ftol * N); gtol that of the gradient's tangent solves.
    dtype: numpy dtype of returned matrices.
    backend: 'auto', 'cuda', 'edge', 'dense', 'kron', or a Backend
        instance. 'auto' is 'cuda' on a CUDA device and 'edge' on the CPU.
    buckets: solve jobs in per-size-class batches instead of padding every
        graph to the largest. Calls on the factory route (below) bucket by
        size class whenever the graphs span more than one class, whatever
        this option says, as the JAX package's route does.
    device: torch device (or its name) that every tensor follows; the
        card (``'cuda'``) unless the caller asks for ``'cpu'``. A CUDA
        device without a usable card raises: nothing falls back to the
        CPU.
    """

    trait_t = namedtuple(
        'Traits', 'diagonal, symmetric, nodal, lmin, eval_gradient'
    )

    @classmethod
    def traits(cls, diagonal=False, symmetric=False, nodal=False, lmin=0,
               eval_gradient=False):
        return cls.trait_t(diagonal, symmetric, nodal, lmin, eval_gradient)

    def __init__(self, node_kernel, edge_kernel, p=1.0, q=0.01,
                 q_bounds=(1e-4, 1 - 1e-4), eps=1e-2, ftol=1e-8, gtol=1e-6,
                 dtype=np.float64, backend='auto', buckets=False,
                 device='cuda'):
        self.buckets = buckets
        self.node_kernel = node_kernel
        self.edge_kernel = edge_kernel
        self.p = self._get_starting_probability(p)
        self.q = q
        self.q_bounds = q_bounds
        self.eps = eps
        self.ftol = ftol
        self.gtol = gtol
        self.element_dtype = dtype
        self.device = resolve_device(device)
        self.backend = backend_factory(backend, self.device)

        if self.node_kernel.minmax[0] <= 0 or self.node_kernel.minmax[1] > 1:
            warnings.warn(
                'Node kernel value range should be within (0, 1], '
                f'got {self.node_kernel.minmax} for {self.node_kernel}. '
                'Consider adding a small constant or using the '
                '`.normalized` attribute of the kernel.',
                DeprecationWarning
            )
        if self.edge_kernel.minmax[0] < 0 or self.edge_kernel.minmax[1] > 1:
            warnings.warn(
                'Edge kernel value range must be within [0, 1], '
                f'got {self.edge_kernel.minmax} for {self.edge_kernel}. '
                'Consider adding a small constant or using the '
                '`.normalized` attribute of the kernel.',
                DeprecationWarning
            )

    def _get_starting_probability(self, p):
        if isinstance(p, StartingProbability):
            return p
        elif isinstance(p, tuple) and len(p) == 2:
            f, expr = p
            if callable(f) and isinstance(expr, str):
                return Adhoc(f, expr)
            raise ValueError(
                'An ad hoc starting probability must be specified as a '
                '(callable, expression) pair.'
            )
        elif isinstance(p, numbers.Number):
            if p > 0:
                return Uniform(p)
            raise ValueError(f'Starting probability {p} < 0.')
        else:
            raise ValueError(f'Unknown starting probability: {p}')

    # ------------------------------------------------------------------
    # solver plumbing
    # ------------------------------------------------------------------

    def __getstate__(self):
        state = self.__dict__.copy()
        # cached factories hold device tensors
        state.pop('_factory_cache', None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    def _theta_vector(self):
        """Full linear-scale hyperparameter vector [p..., q, node...,
        edge...] as a float32 tensor on the kernel's device."""
        return torch.tensor(
            list(flatten(self.hyperparameters)), dtype=torch.float32,
            device=self.device)

    def _tensors(self, tree):
        """numpy feature pytree -> tensors on the kernel's device."""
        return _tree_map(
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device), tree)

    def _prepare_batch(self, graphs, node_align=8):
        """Pack ``graphs`` into one padded batch; returns (GraphBatch of
        numpy arrays, dict of tensors on the device, p_fixed or None). The
        dense arrays are stacked in mode ``'dense'`` only; the others carry
        ``edge_lists``, each node's real edges (weight != 0) in edge order
        (:func:`~graphdot_tpu_torch.ops.pcg.edge_segments`), over which the
        plain matvecs and the tangent right-hand sides sum."""
        dense = self.backend.mode == 'dense'
        batch = batch_graphs(graphs, node_align=node_align, dense=dense)
        fields = ['node_mask', 'degree', 'node_feats']
        if dense:
            fields += ['adj', 'edge_feats']
        else:
            fields += ['esrc', 'edst', 'ew', 'edge_elist_feats']
        batch_dict = {f: self._tensors(getattr(batch, f)) for f in fields}
        if not dense:
            batch_dict['edge_lists'] = edge_segments(
                batch_dict['esrc'], batch_dict['ew'] != 0,
                batch.node_mask.shape[1])

        p_fixed = None
        if isinstance(self.p, Adhoc):
            n_pad = batch.node_mask.shape[1]
            p_fixed = np.zeros((len(graphs), n_pad), dtype=np.float32)
            for b, g in enumerate(graphs):
                p_values, _ = self.p(g.nodes)
                p_values = np.asarray(p_values, dtype=np.float32)
                # frame rows -> node-index order (matches pack_graph)
                order = np.argsort(np.asarray(g.nodes['!i']))
                p_fixed[b, :len(g.nodes)] = p_values[order]
            p_fixed = self._tensors(p_fixed)
        return batch, batch_dict, p_fixed

    def _operands(self, bd1, bd2, idx1, idx2):
        """Per-pair operands of the jobs (idx1[k], idx2[k]), gathered from
        two prepared batches; idx1/idx2 are int64 tensors on the device."""
        def g1(tree):
            return _tree_map(lambda a: a[idx1], tree)

        def g2(tree):
            return _tree_map(lambda a: a[idx2], tree)

        ops = {
            'node_feats_1': g1(bd1['node_feats']),
            'node_feats_2': g2(bd2['node_feats']),
            'node_mask_1': bd1['node_mask'][idx1],
            'node_mask_2': bd2['node_mask'][idx2],
            'degree_1': bd1['degree'][idx1],
            'degree_2': bd2['degree'][idx2],
            'ftol': float(self.ftol),
            'gtol': float(self.gtol),
        }
        if self.backend.mode == 'dense':
            ops['adj_1'] = bd1['adj'][idx1]
            ops['adj_2'] = bd2['adj'][idx2]
            ops['edge_feats_1'] = g1(bd1['edge_feats'])
            ops['edge_feats_2'] = g2(bd2['edge_feats'])
        else:
            for f in ('esrc', 'edst', 'ew', 'edge_lists'):
                ops[f + '_1'] = bd1[f][idx1]
                ops[f + '_2'] = bd2[f][idx2]
            ops['edge_elist_feats_1'] = g1(bd1['edge_elist_feats'])
            ops['edge_elist_feats_2'] = g2(bd2['edge_elist_feats'])
        return ops

    def _solve_chunk(self, theta, bd1, bd2, idx1, idx2, pf1, pf2, nodal,
                     lmin, eval_gradient=False, maxiter=None,
                     with_residual=False, kron=None, route=None,
                     hotspot=None):
        """Solve one chunk of jobs; returns (R [P, n1, n2] (nodal) or the
        kernel values [P], and with ``eval_gradient`` d R / d theta
        [P(, n1, n2), n_dims], else None), as float32 tensors; with
        ``with_residual``, also the [P] relative residuals of the value
        solves. A theta of [C, n_dims] solves the chunk at each row (in one
        batch, :func:`._solver.mlgk_solve`), and every result leads with
        C. ``maxiter`` defaults to :meth:`maxiter` of the padded
        size; ``kron`` is the plan's :class:`~._kron.KronPlan` and ``route``
        the chunk's (:meth:`JobPlan.route`; None: mode ``'cuda'``'s from
        the shapes, as :func:`._solver.mlgk_solve` says).

        ``hotspot``, a pair of [P] index tensors (h1, h2) on the device,
        asks for one nodal entry a pair, as the JAX package's
        ``grad='hotspot'``: the result is then (R[p, h1_p, h2_p] [P], and
        with ``eval_gradient`` its gradient [P, n_dims]), gathered from the
        tangents and from the weights' jacobian on the device, so the
        [P, n1, n2, n_dims] nodal jacobian is never formed."""
        ops = self._operands(bd1, bd2, idx1, idx2)
        if maxiter is None:
            maxiter = self.maxiter(max(bd1['node_mask'].shape[1],
                                       bd2['node_mask'].shape[1]))
        n_p = len(list(flatten(self.p.theta)))
        out = mlgk_solve(
            theta, ops, knode=self.node_kernel, kedge=self.edge_kernel,
            n_p_theta=n_p, lmin=lmin, mode=self.backend.mode,
            maxiter=maxiter, tangents=eval_gradient,
            return_resnorm=with_residual, kron=kron, route=route
        )
        pf1 = None if pf1 is None else pf1[idx1]
        pf2 = None if pf2 is None else pf2[idx2]

        def weights(t):
            """p1 and p2 of the pairs under the hyperparameters t"""
            return (self.p.apply(t[:n_p], ops['node_mask_1'], pf1),
                    self.p.apply(t[:n_p], ops['node_mask_2'], pf2))

        if hotspot is not None:
            return self._hotspot_entries(theta, out, weights, hotspot,
                                         eval_gradient)
        batched = theta.dim() == 2
        if batched:
            # the C * P systems theta by theta -> [C, P, ...]
            out = tuple(o.unflatten(0, (theta.shape[0], -1)) for o in out)
        x = out[0]
        p1, p2 = (torch.func.vmap(weights) if batched else weights)(theta)
        R = weight_by_p(x, p1, p2)
        dR = None
        if eval_gradient:
            # product rule of weight_by_p: dR = x_dot o w + x o w_dot, with
            # w = p1 p2^T
            jacobian = torch.func.jacfwd(
                lambda t: weight_by_p(1.0, *weights(t)))
            w_dot = (torch.func.vmap(jacobian) if batched else jacobian)(
                theta.detach())
            dR = out[3] * weight_by_p(1.0, p1, p2)[..., None] \
                + x[..., None] * w_dot
        if not nodal:
            R = torch.sum(R, dim=(-2, -1))
            dR = None if dR is None else torch.sum(dR, dim=(-3, -2))
        if with_residual:
            return R, dR, out[-1]
        return R, dR

    @staticmethod
    def _hotspot_entries(theta, out, weights, hotspot, eval_gradient):
        """R[p, h1_p, h2_p] of a chunk's solves ``out`` (x, and x_dot with
        ``eval_gradient``) and, with ``eval_gradient``, its gradient by the
        product rule of :func:`._solver.weight_by_p` at that entry alone:
        x_dot[h] p1_h1 p2_h2 + x[h] d(p1_h1 p2_h2) / d theta."""
        h1, h2 = hotspot
        k = torch.arange(h1.shape[0], device=h1.device)

        def w_hot(t):
            p1, p2 = weights(t)
            return p1[k, h1] * p2[k, h2]

        x_h = out[0][k, h1, h2]
        w = w_hot(theta)
        if not eval_gradient:
            return x_h * w, None
        w_dot = torch.func.jacfwd(w_hot)(theta.detach())      # [P, n_dims]
        return x_h * w, out[3][k, h1, h2] * w[:, None] \
            + x_h[:, None] * w_dot

    @staticmethod
    def maxiter(n_pad):
        """CG step bound for pairs padded to ``n_pad`` nodes a side: the
        product-space dimension, capped at 10000."""
        return min(n_pad * n_pad, 10000)

    def _chunk_size(self, n_pad, m_pad, eval_gradient=False, nodal=False,
                    route=None, grid=None, copies=1):
        """Job-chunk size bounded by the solver's working-set memory
        (~256 MB of float32 per chunk; ~4 GB for pairs that run in
        ``pcg_stream``, whose launch overhead and three grid barriers per
        CG step are paid once a chunk, and on the kron route). Gradients
        carry one tangent system per hyperparameter, and nodal gradients
        [chunk, n, n, n_dims] outputs, which scale the per-pair working set
        as in the JAX package. ``route`` defaults to the one of mode
        ``'cuda'`` without kron (:func:`._solver.chunk_route`) for the
        padded sizes; on the kron route, ``grid`` is the tensor grid's
        size R. ``copies`` systems a pair (a batched solve's C
        hyperparameter vectors) multiply the working set of a pair, the
        budget (up to ``BATCHED_CHUNK_FLOATS``) and divide the cap of 4096
        pairs a chunk."""
        n_theta = max(int(self.n_dims), 1)
        nn = n_pad * n_pad
        mode = self.backend.mode
        if route is None:
            route = mode if mode in ('dense', 'edge') else chunk_route(
                mode, m_pad, m_pad, n_pad, n_pad, self.device)
        if route == 'kron':
            grid = grid or DEFAULT_RANK
            # the side factors A1s, B2s, side 2's grid values, the fused
            # intermediate, and the dense basis evaluation's temporaries;
            # the k tangents' intermediates side by side, their CG vectors
            per_pair = 8 * grid * nn + 8 * nn
            if eval_gradient:
                per_pair += 8 * n_theta * (grid * nn + nn)
                if nodal:
                    per_pair += nn * n_theta
            return int(np.clip(KRON_CHUNK_FLOATS // per_pair, 1, 4096))
        budget = 1 << 26  # floats
        if mode == 'dense':
            per_pair = max(n_pad ** 4, 1)
        else:
            per_pair = max(m_pad * m_pad + 4 * m_pad * n_pad + 8 * nn, 1)
            if route == 'stream':
                budget = STREAM_CHUNK_FLOATS
        if copies > 1:
            budget = max(budget, min(budget * copies, BATCHED_CHUNK_FLOATS))
        if eval_gradient:
            per_pair *= 1 + n_theta
            if nodal:
                per_pair += nn * n_theta
        return int(np.clip(budget // (per_pair * copies), 1,
                           max(4096 // copies, 1)))

    def _size_classes(self, graphs, align=8):
        """Partition graph indices into padded-size classes."""
        classes = {}
        for gi, g in enumerate(graphs):
            n_pad = max(align, -(-len(g.nodes) // align) * align)
            classes.setdefault(n_pad, []).append(gi)
        return classes

    def _solve_jobs(self, graphs, i_jobs, j_jobs, nodal, lmin,
                    eval_gradient=False):
        """Solve all (i, j) jobs; returns the [P(,n1,n2)] results, and with
        ``eval_gradient`` a pair (values, [P(,n1,n2), n_dims] gradients),
        as numpy: one array for values, lists of per-job arrays for nodal
        results. The jobs run through a throw-away :class:`JobPlan`, by
        size class with ``buckets`` on."""
        theta = self._theta_vector()
        plan = JobPlan(self, graphs, i_jobs, j_jobs, self.buckets)
        if plan.kron_possible():
            plan.calibrate_kron(theta)
        P = len(plan.i_jobs)
        raw = [None] * P if nodal else np.empty(P)
        raw_grad = None
        if eval_gradient:
            raw_grad = [None] * P if nodal else np.empty((P, self.n_dims))
        for grp in plan.groups:
            outs, grads = [], []
            for res, grad in plan.solve(theta, grp, nodal, lmin,
                                        eval_gradient):
                outs.append(res.cpu().numpy())
                if eval_gradient:
                    grads.append(grad.cpu().numpy())
            out = np.concatenate(outs, axis=0)
            grad = np.concatenate(grads, axis=0) if eval_gradient else None
            if not nodal:
                raw[grp['pos']] = out
                if eval_gradient:
                    raw_grad[grp['pos']] = grad
                continue
            for k, p in enumerate(grp['pos']):
                o = out[k]
                g = grad[k] if eval_gradient else None
                if grp['swap'][k]:   # the job was solved as R[gj, gi]
                    o = np.swapaxes(o, 0, 1)
                    g = None if g is None else np.swapaxes(g, 0, 1)
                raw[p] = o
                if eval_gradient:
                    raw_grad[p] = g
        return (raw, raw_grad) if eval_gradient else raw

    def _solve_hotspot_grads(self, plan, h1, h2, lmin):
        """The gradient in the hyperparameters (linear scale, all of them)
        of one nodal entry a job, R[p, h1_p, h2_p]: [P, n_dims] numpy.
        Counterpart of the JAX class's ``_solve_hotspot_grads``, used by
        the MaxiMin hotspot gradient. The jobs run through ``plan`` (a
        :class:`JobPlan` over the jobs, calibrated for kron where a group
        may take it, as the value solves left it) in chunks sized as
        the JAX class sizes them (``eval_gradient=True``, ``nodal=False``);
        the tangents take each group's route (``pcg_packed`` groups on the
        resident route). A job solved as (j, i) (``swap``) transposes its
        hotspot. Only the [P, n_dims] entries leave the device."""
        theta = self._theta_vector()
        h1 = np.asarray(h1, dtype=np.int64)
        h2 = np.asarray(h2, dtype=np.int64)
        grad = np.empty((len(plan.i_jobs), self.n_dims))
        for grp in plan.groups:
            pos, swap = grp['pos'], grp['swap']
            hot = tuple(torch.as_tensor(h, device=self.device) for h in (
                np.where(swap, h2[pos], h1[pos]),
                np.where(swap, h1[pos], h2[pos])))
            grads = [dr for _, dr in plan.solve(theta, grp, False, lmin,
                                                 True, hotspot=hot)]
            grad[pos] = torch.cat(grads).cpu().numpy()
        return grad

    @staticmethod
    def _check_types(graphs):
        pred_or_tuple = Graph.has_unified_types(graphs)
        if pred_or_tuple is not True:
            group, first, second = pred_or_tuple
            raise TypeError(
                f'The two graphs have mismatching {group} attributes or '
                'attribute types. If the attributes match in name but '
                'differ in type, try `Graph.unify_datatype` as an '
                'automatic fix.\n'
                f'First graph: {first}\n'
                f'Second graph: {second}\n'
            )

    # ------------------------------------------------------------------
    # the factory route: non-nodal calls of many jobs run through a
    # cached GramFactory, which packs the graphs once
    # ------------------------------------------------------------------

    #: minimum job count before a non-nodal ``__call__`` routes through a
    #: cached factory. ``GRAPHDOT_API_UNION=0`` turns the route off, ``=1``
    #: takes it at any size, an integer sets the threshold. The value is
    #: the JAX package's, where it pays back a factory's own compile. The
    #: port's factory compiles nothing, but it solves each size-class
    #: group in chunks of its own, and below a few hundred jobs those
    #: extra chunks cost more host time than packing once saves: on the
    #: card both routes' times at 136 and 496 jobs are in ``PERF.md``.
    _API_UNION_MIN_JOBS = 512

    def _get_call_factory(self, X, Y):
        """The cached :class:`~graphdot_tpu_torch.inference.GramFactory`
        over the graph lists. An entry is dropped when any of its graphs
        mutated (``Graph.permute`` and ``unify_datatype`` clear the cookie
        that holds the entry's token); four entries are kept, the oldest
        dropped first."""
        from ...inference.gram import GramFactory

        cache = self.__dict__.setdefault('_factory_cache', {})
        key = (tuple(map(id, X)),
               None if Y is None else tuple(map(id, Y)),
               self.backend.mode)
        all_graphs = list(X) + (list(Y) if Y is not None else [])
        entry = cache.get(key)
        if entry is not None:
            factory, token = entry
            if all(g.cookie.get(('apifac', key)) is token
                   for g in all_graphs):
                return factory
            del cache[key]
        self._check_types(all_graphs)
        factory = GramFactory(self, list(X), normalize=False,
                              graphs2=None if Y is None else list(Y))
        token = object()
        for g in all_graphs:
            g.cookie[('apifac', key)] = token
        cache[key] = (factory, token)
        while len(cache) > 4:
            del cache[next(iter(cache))]
        return factory

    def _factory_call(self, X, Y, eval_gradient, lmin):
        """A non-nodal call through the cached factory: (K, dK on the
        linear scale or None) as numpy, or None where the route declines
        (``GRAPHDOT_API_UNION``, fewer jobs than the threshold, or mode
        ``'dense'``). Where the factory's pairs may take the kron route, its
        ranks are calibrated at the call's hyperparameters first."""
        v = os.environ.get('GRAPHDOT_API_UNION', 'auto').strip().lower()
        if v in ('0', 'false', 'off', 'no'):
            return None
        if v in ('auto', ''):
            min_jobs = self._API_UNION_MIN_JOBS
        elif v in ('1', 'true', 'on', 'yes'):
            min_jobs = 0
        else:
            min_jobs = int(v)
        if self.backend.mode not in ('cuda', 'edge', 'kron'):
            return None
        nX = len(X)
        n_jobs = nX * (nX + 1) // 2 if Y is None else nX * len(Y)
        if n_jobs < min_jobs:
            return None

        factory = self._get_call_factory(X, Y)
        th_lin = self.flat_hyperparameters[self.active_theta_mask]
        factory.recalibrate_kron(np.log(th_lin))
        out = factory.gram(np.log(th_lin), lmin=int(lmin),
                           eval_gradient=eval_gradient)
        if eval_gradient:
            K, dK = out
            # the factory's dK is in log theta; the call's is linear
            return (K.cpu().numpy(),
                    dK.cpu().numpy() / th_lin[None, None, :])
        return out.cpu().numpy(), None

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def __call__(self, X, Y=None, eval_gradient=False, nodal=False, lmin=0,
                 timing=False):
        """Compute the pairwise similarity matrix between graphs.

        Parameters
        ----------
        X: list of N graphs (must have identical feature signatures)
        Y: None or list of M graphs
        eval_gradient: if True, also return d K / d theta (linear scale,
            active hyperparameters only).
        nodal: if True, return node-wise similarities.
        lmin: 0 or 1 — number of steps to skip in each random walk path.
        timing: if True, print the wall time of each phase (generating
            jobs, solving pair jobs, collecting result), in ms.

        Returns
        -------
        kernel_matrix: ndarray; plus the gradient ndarray if eval_gradient.

        A non-nodal call of at least ``_API_UNION_MIN_JOBS`` pair jobs runs
        through a cached :class:`~graphdot_tpu_torch.inference.GramFactory`
        over X (and Y), which packs the graphs once (``GRAPHDOT_API_UNION``
        sets the threshold). Its gradient's tangent systems, like every
        gradient of the port, run at ``gtol``. A failure there raises: no
        call falls back to the per-pair route.
        """
        timer = Timer()
        if not nodal:
            # before the type check: a cache hit proves the graphs were
            # checked when the factory was built and have not changed
            timer.tic('factory route')
            routed = self._factory_call(X, Y, eval_gradient, lmin)
            timer.toc('factory route')
            if routed is not None:
                if timing:
                    timer.report(unit='ms')
                K, dK = routed
                if eval_gradient:
                    return (K.astype(self.element_dtype),
                            dK.astype(self.element_dtype))
                return K.astype(self.element_dtype)
        all_graphs = list(X) + (list(Y) if Y is not None else [])
        self._check_types(all_graphs)

        timer.tic('generating jobs')
        symmetric = Y is None
        if symmetric:
            i, j = np.triu_indices(len(X))
        else:
            i, j = np.indices((len(X), len(Y)))
            j = j + len(X)
        i = i.ravel()
        j = j.ravel()
        timer.toc('generating jobs')

        timer.tic('solving pair jobs')
        result = self._solve_jobs(all_graphs, i, j, nodal=bool(nodal),
                                  lmin=lmin, eval_gradient=eval_gradient)
        timer.toc('solving pair jobs')

        timer.tic('collecting result')
        raw, raw_grad = result if eval_gradient else (result, None)
        sizes = np.array([len(g.nodes) for g in all_graphs])
        gramian, gradient = self._assemble(
            raw, raw_grad, i, j, sizes, len(X),
            len(Y) if Y is not None else None, nodal
        )
        timer.toc('collecting result')

        if timing:
            timer.report(unit='ms')
        timer.reset()
        if eval_gradient:
            return (gramian.astype(self.element_dtype),
                    gradient[:, :, self.active_theta_mask].astype(
                        self.element_dtype))
        return gramian.astype(self.element_dtype)

    def _assemble(self, raw, raw_grad, i_jobs, j_jobs, sizes, nX, nY,
                  nodal):
        """Scatter per-pair results (and gradients, when ``raw_grad`` is not
        None) into the output matrix layout; returns (R, dR or None)."""
        symmetric = nY is None
        n_dims = self.n_dims
        if nodal:
            starts = np.concatenate([[0], np.cumsum(sizes)])
            if symmetric:
                rows = cols = starts[nX]
                col_base = starts
            else:
                rows = starts[nX]
                cols = starts[len(sizes)] - starts[nX]
                col_base = starts - starts[nX]
            R = np.zeros((rows, cols))
            dR = None if raw_grad is None else np.zeros((rows, cols, n_dims))
            for p, (gi, gj) in enumerate(zip(i_jobs, j_jobs)):
                ni, nj = sizes[gi], sizes[gj]
                r0, c0 = starts[gi], col_base[gj]
                R[r0:r0 + ni, c0:c0 + nj] = raw[p][:ni, :nj]
                if dR is not None:
                    dR[r0:r0 + ni, c0:c0 + nj] = raw_grad[p][:ni, :nj]
                if symmetric and gi != gj:
                    R[c0:c0 + nj, r0:r0 + ni] = raw[p][:ni, :nj].T
                    if dR is not None:
                        dR[c0:c0 + nj, r0:r0 + ni] = np.swapaxes(
                            raw_grad[p][:ni, :nj], 0, 1)
            return R, dR
        raw = np.asarray(raw)
        grad = None if raw_grad is None else np.asarray(raw_grad)
        if symmetric:
            R = np.zeros((nX, nX))
            R[i_jobs, j_jobs] = raw
            R[j_jobs, i_jobs] = raw
            dR = None
            if grad is not None:
                dR = np.zeros((nX, nX, n_dims))
                dR[i_jobs, j_jobs] = grad
                dR[j_jobs, i_jobs] = grad
        else:
            R = np.zeros((nX, nY))
            R[i_jobs, j_jobs - nX] = raw
            dR = None
            if grad is not None:
                dR = np.zeros((nX, nY, n_dims))
                dR[i_jobs, j_jobs - nX] = grad
        return R, dR

    def diag(self, X, eval_gradient=False, nodal=False, lmin=0,
             active_theta_only=True, timing=False):
        """Compute the self-similarities of a list of graphs.

        nodal=False -> [N] graph self-similarities; nodal=True -> vector of
        nodal self-similarities; nodal='block' -> list of per-graph nodal
        similarity matrices. With ``eval_gradient``, also their gradients
        in the hyperparameters (linear scale; active ones only when
        ``active_theta_only``, except for ``'block'``, as in the JAX
        class). ``timing``: print the wall time of solving the pair jobs,
        in ms.
        """
        timer = Timer()
        self._check_types(X)
        if nodal not in (True, False, 'block'):
            raise ValueError("Invalid 'nodal' option '%s'" % nodal)

        i = np.arange(len(X))
        timer.tic('solving pair jobs')
        result = self._solve_jobs(list(X), i, i, nodal=bool(nodal),
                                  lmin=lmin, eval_gradient=eval_gradient)
        timer.toc('solving pair jobs')
        if timing:
            timer.report(unit='ms')
        timer.reset()
        raw, raw_grad = result if eval_gradient else (result, None)
        sizes = np.array([len(g.nodes) for g in X])
        grad = raw_grad
        if nodal is True:
            out = np.concatenate([
                np.diagonal(raw[p][:n, :n]) for p, n in enumerate(sizes)
            ])
            if eval_gradient:
                grad = np.concatenate([
                    np.diagonal(raw_grad[p][:n, :n], axis1=0, axis2=1).T
                    for p, n in enumerate(sizes)
                ])
        elif nodal == 'block':
            out = [raw[p][:n, :n] for p, n in enumerate(sizes)]
            if eval_gradient:
                return out, [raw_grad[p][:n, :n].astype(self.element_dtype)
                             for p, n in enumerate(sizes)]
            return out
        else:
            out = raw
        out = np.asarray(out).astype(self.element_dtype)
        if not eval_gradient:
            return out
        grad = np.asarray(grad)
        if active_theta_only:
            grad = grad[..., self.active_theta_mask]
        return out, grad.astype(self.element_dtype)

    # ------------------------------------------------------------------
    # scikit-learn interoperability
    # ------------------------------------------------------------------

    def is_stationary(self):
        return False

    @property
    def requires_vector_input(self):
        return False

    @property
    def hyperparameters(self):
        """A hierarchical representation of all kernel hyperparameters."""
        return pretty_tuple(
            'MarginalizedGraphKernel',
            ['starting_probability', 'stopping_probability', 'node_kernel',
             'edge_kernel']
        )(self.p.theta, self.q, self.node_kernel.theta,
          self.edge_kernel.theta)

    @property
    def flat_hyperparameters(self):
        return np.fromiter(flatten(self.hyperparameters), float)

    @property
    def hyperparameter_bounds(self):
        return pretty_tuple(
            'GraphKernelHyperparameterBounds',
            ['starting_probability', 'stopping_probability', 'node_kernel',
             'edge_kernel']
        )(self.p.bounds, self.q_bounds, self.node_kernel.bounds,
          self.edge_kernel.bounds)

    @property
    def n_dims(self):
        """Number of hyperparameters, optimizable and fixed alike."""
        return len(self.flat_hyperparameters)

    def _bounds_table(self):
        """[n_dims, 2] linear-scale bounds table, one row per
        hyperparameter in theta order; ``'fixed'`` entries become NaN
        rows.

        ``flatten`` splits each (lo, hi) pair into two consecutive
        scalars but yields the 'fixed' sentinel (a string) and any
        2-array bound whole, so the walk consumes one or two stream items
        per hyperparameter accordingly.
        """
        rows = []
        stream = flatten(self.hyperparameter_bounds)
        for item in stream:
            if isinstance(item, str):
                if item != 'fixed':
                    raise ValueError(f'Unknown bound spec {item!r}')
                rows.append((np.nan, np.nan))
            elif hasattr(item, '__len__'):
                lo, hi = item
                rows.append((float(lo), float(hi)))
            else:
                rows.append((float(item), float(next(stream))))
        return np.asarray(rows, dtype=float).reshape(-1, 2)

    @property
    def active_theta_mask(self):
        """Boolean mask over the full hyperparameter vector: True for
        entries that participate in optimization, False for 'fixed' ones
        and degenerate lo == hi bounds."""
        table = self._bounds_table()
        fixed = np.isnan(table).any(axis=1)
        degenerate = table[:, 0] == table[:, 1]
        return ~(fixed | degenerate)

    @property
    def theta(self):
        """Log-scale flattened vector of the active hyperparameters."""
        return np.log(self.flat_hyperparameters[self.active_theta_mask])

    @theta.setter
    def theta(self, value):
        full = self.flat_hyperparameters
        full[self.active_theta_mask] = np.exp(value)
        (self.p.theta,
         self.q,
         self.node_kernel.theta,
         self.edge_kernel.theta
         ) = fold_like(full, self.hyperparameters)

    @property
    def bounds(self):
        """Log-scale n-by-2 array of active hyperparameter bounds."""
        return np.log(self._bounds_table()[self.active_theta_mask])

    def clone_with_theta(self, theta=None):
        """A deep copy, at ``theta`` when given, that shares this kernel's
        factory cache: a factory takes the active hyperparameters as an
        argument and keeps only the fixed ones."""
        clone = copy.deepcopy(self)   # __getstate__ leaves the cache out
        clone._factory_cache = self.__dict__.setdefault('_factory_cache', {})
        if theta is not None:
            clone.theta = theta
        return clone
