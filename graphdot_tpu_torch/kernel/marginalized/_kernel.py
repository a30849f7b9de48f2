"""Marginalized graph kernel — host-side orchestration; counterpart of
``graphdot_tpu/kernel/marginalized/_kernel.py`` (``__call__``, ``diag``,
the sklearn-compatible ``theta``/``bounds``/``clone_with_theta``).

The job list (upper-triangular or rectangular index set) is cut into
chunks of pair indices, gathered on the kernel's device; all pairs in a
chunk are solved at once by :func:`._solver.mlgk_solve`. Every tensor lives
on the ``device`` given to the kernel. With ``eval_gradient=True`` each
chunk also solves the tangent systems of every hyperparameter (forward
mode, as the JAX package's ``jax.jacfwd``), and the results carry
d K / d theta on the linear scale.
"""
import copy
import numbers
import warnings
from collections import namedtuple

import numpy as np
import torch

from ...util import Timer
from ...util.iterable import fold_like, flatten
from ...util.pretty_tuple import pretty_tuple
from ...graph import Graph, batch_graphs
from ._backend import backend_factory, resolve_device
from ._solver import cuda_solver, mlgk_solve, weight_by_p
from ...ops.pcg import pcg_stream
from .starting_probability import StartingProbability, Uniform, Adhoc


#: working-set budget, in floats, of a chunk of pairs that runs in
#: ``pcg_stream``
STREAM_CHUNK_FLOATS = 1 << 30


def _tree_map(f, tree):
    """Apply ``f`` to the leaves of a feature pytree (dicts of arrays or of
    (values, mask) tuples)."""
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(f, v) for v in tree)
    return f(tree)


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
    backend: 'auto', 'cuda', 'edge', 'dense', or a Backend instance.
        'auto' is 'cuda' on a CUDA device and 'edge' on the CPU.
    buckets: solve jobs in per-size-class batches instead of padding every
        graph to the largest.
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

    def _prepare_batch(self, graphs):
        """Pack ``graphs`` into one padded batch; returns (GraphBatch of
        numpy arrays, dict of tensors on the device, p_fixed or None)."""
        batch = batch_graphs(graphs)
        fields = ['node_mask', 'degree', 'node_feats']
        if self.backend.mode == 'dense':
            fields += ['adj', 'edge_feats']
        else:
            fields += ['esrc', 'edst', 'ew', 'edge_elist_feats']
        batch_dict = {f: self._tensors(getattr(batch, f)) for f in fields}

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
            for f in ('esrc', 'edst', 'ew'):
                ops[f + '_1'] = bd1[f][idx1]
                ops[f + '_2'] = bd2[f][idx2]
            ops['edge_elist_feats_1'] = g1(bd1['edge_elist_feats'])
            ops['edge_elist_feats_2'] = g2(bd2['edge_elist_feats'])
        return ops

    def _solve_chunk(self, theta, bd1, bd2, idx1, idx2, pf1, pf2, nodal,
                     lmin, eval_gradient=False):
        """Solve one chunk of jobs; returns (R [P, n1, n2] (nodal) or the
        kernel values [P], and with ``eval_gradient`` d R / d theta
        [P(, n1, n2), n_dims], else None), as float32 tensors."""
        ops = self._operands(bd1, bd2, idx1, idx2)
        n_pad = max(bd1['node_mask'].shape[1], bd2['node_mask'].shape[1])
        n_p = len(list(flatten(self.p.theta)))
        out = mlgk_solve(
            theta, ops, knode=self.node_kernel, kedge=self.edge_kernel,
            n_p_theta=n_p, lmin=lmin, mode=self.backend.mode,
            maxiter=self.maxiter(n_pad), tangents=eval_gradient
        )
        pf1 = None if pf1 is None else pf1[idx1]
        pf2 = None if pf2 is None else pf2[idx2]

        def weights(t):
            """p1 and p2 of the pairs under the hyperparameters t"""
            return (self.p.apply(t[:n_p], ops['node_mask_1'], pf1),
                    self.p.apply(t[:n_p], ops['node_mask_2'], pf2))

        x = out[0]
        p1, p2 = weights(theta)
        R = weight_by_p(x, p1, p2)
        dR = None
        if eval_gradient:
            # product rule of weight_by_p: dR = x_dot o w + x o w_dot, with
            # w = p1 p2^T
            w_dot = torch.func.jacfwd(
                lambda t: weight_by_p(1.0, *weights(t)))(theta.detach())
            dR = out[3] * weight_by_p(1.0, p1, p2)[..., None] \
                + x[..., None] * w_dot
        if nodal:
            return R, dR
        return (torch.sum(R, dim=(1, 2)),
                None if dR is None else torch.sum(dR, dim=(1, 2)))

    @staticmethod
    def maxiter(n_pad):
        """CG step bound for pairs padded to ``n_pad`` nodes a side: the
        product-space dimension, capped at 10000."""
        return min(n_pad * n_pad, 10000)

    def _chunk_size(self, n_pad, m_pad, eval_gradient=False, nodal=False):
        """Job-chunk size bounded by the solver's working-set memory
        (~256 MB of float32 per chunk; ~4 GB for pairs that run in
        ``pcg_stream``, whose launch overhead and three grid barriers per
        CG step are paid once a chunk). Gradients carry one tangent system per
        hyperparameter, and nodal gradients [chunk, n, n, n_dims] outputs,
        which scale the per-pair working set as in the JAX package."""
        budget = 1 << 26  # floats
        if self.backend.mode == 'dense':
            per_pair = max(n_pad ** 4, 1)
        else:
            per_pair = max(
                m_pad * m_pad + 4 * m_pad * n_pad + 8 * n_pad * n_pad, 1
            )
            if self.backend.mode == 'cuda' and cuda_solver(
                    m_pad, m_pad, n_pad, n_pad, self.device) is pcg_stream:
                budget = STREAM_CHUNK_FLOATS
        if eval_gradient:
            n_theta = max(int(self.n_dims), 1)
            per_pair *= 1 + n_theta
            if nodal:
                per_pair += n_pad * n_pad * n_theta
        return int(np.clip(budget // per_pair, 1, 4096))

    def _run_chunks(self, theta, bd1, bd2, pf1, pf2, i_jobs, j_jobs, chunk,
                    nodal, lmin, eval_gradient):
        """Solve the jobs in chunks of at most ``chunk`` pairs; returns
        the concatenated results as a numpy array, and the concatenated
        gradients (None without ``eval_gradient``)."""
        outs, grads = [], []
        for s in range(0, len(i_jobs), chunk):
            idx1 = torch.as_tensor(i_jobs[s:s + chunk], device=self.device)
            idx2 = torch.as_tensor(j_jobs[s:s + chunk], device=self.device)
            res, grad = self._solve_chunk(theta, bd1, bd2, idx1, idx2, pf1,
                                          pf2, nodal, lmin, eval_gradient)
            outs.append(res.cpu().numpy())
            if eval_gradient:
                grads.append(grad.cpu().numpy())
        grad = np.concatenate(grads, axis=0) if eval_gradient else None
        return np.concatenate(outs, axis=0), grad

    def _size_classes(self, graphs, align=8):
        """Partition graph indices into padded-size classes."""
        classes = {}
        for gi, g in enumerate(graphs):
            n_pad = max(align, -(-len(g.nodes) // align) * align)
            classes.setdefault(n_pad, []).append(gi)
        return classes

    def _solve_jobs(self, graphs, i_jobs, j_jobs, nodal, lmin,
                    eval_gradient=False):
        """Solve all (i, j) jobs; returns [P(,n1,n2)] numpy arrays, and with
        ``eval_gradient`` a pair (values, [P(,n1,n2), n_dims] gradients).
        With ``buckets`` on and heterogeneous sizes, jobs are grouped into
        per-size-class batches so small pairs are not padded to the global
        maximum."""
        theta = self._theta_vector()
        i_jobs = np.asarray(i_jobs, dtype=np.int64)
        j_jobs = np.asarray(j_jobs, dtype=np.int64)

        classes = self._size_classes(graphs) if self.buckets else None
        if not classes or len(classes) <= 1:
            batch, batch_dict, p_fixed = self._prepare_batch(graphs)
            chunk = self._chunk_size(batch.node_mask.shape[1],
                                     batch.esrc.shape[1], eval_gradient,
                                     nodal)
            out, grad = self._run_chunks(
                theta, batch_dict, batch_dict, p_fixed, p_fixed,
                i_jobs, j_jobs, chunk, nodal, lmin, eval_gradient
            )
            return (out, grad) if eval_gradient else out

        # ---- bucketed path ----
        class_of = np.empty(len(graphs), dtype=np.int64)
        local_of = np.empty(len(graphs), dtype=np.int64)
        batches = {}
        for ck, members in classes.items():
            for li, gi in enumerate(members):
                class_of[gi] = ck
                local_of[gi] = li
            batches[ck] = self._prepare_batch(
                [graphs[gi] for gi in members]
            )

        # group jobs by (class_a <= class_b); remember transposes
        groups = {}
        for p, (gi, gj) in enumerate(zip(i_jobs, j_jobs)):
            ca, cb = class_of[gi], class_of[gj]
            swap = ca > cb
            key = (min(ca, cb), max(ca, cb))
            a, b = (gj, gi) if swap else (gi, gj)
            groups.setdefault(key, []).append(
                (p, local_of[a], local_of[b], swap)
            )

        raw = [None] * len(i_jobs)
        raw_grad = [None] * len(i_jobs) if eval_gradient else None
        for (ca, cb), entries in groups.items():
            _, bd1, pf1 = batches[ca]
            batch_b, bd2, pf2 = batches[cb]
            m_pad = max(
                batches[ca][0].esrc.shape[1], batch_b.esrc.shape[1]
            )
            chunk = self._chunk_size(cb, m_pad, eval_gradient, nodal)
            ps, l1, l2, swaps = map(np.asarray, zip(*entries))
            out, grad = self._run_chunks(
                theta, bd1, bd2, pf1, pf2, l1, l2, chunk, nodal, lmin,
                eval_gradient
            )
            for k, p in enumerate(ps):
                o = out[k]
                g = grad[k] if eval_gradient else None
                if swaps[k] and nodal:
                    o = np.swapaxes(o, 0, 1)
                    if g is not None:
                        g = np.swapaxes(g, 0, 1)
                raw[p] = o
                if eval_gradient:
                    raw_grad[p] = g
        return (raw, raw_grad) if eval_gradient else raw

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
        """
        timer = Timer()
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
        clone = copy.deepcopy(self)
        if theta is not None:
            clone.theta = theta
        return clone
