"""MaxiMin (Hausdorff-like) graph distance; counterpart of
``graphdot_tpu/metric/maximin/_maximin.py``.

The distance of two graphs is the largest of the kernel-induced distances
from a node of one graph to the closest node of the other, with the
marginalized graph kernel's nodal similarities. The solver returns each
pair's whole nodal similarity matrix, so the reduction (induced distance,
row and column minima, their maximum, the hotspot's tie-break) is a masked
reduction over a chunk of pairs at once, in torch on the kernel's device.

Where the port differs from the JAX module:

- ``__call__`` reduces each chunk on the device, in float64, as it comes
  out of :meth:`JobPlan.solve`; for each size-class group only the
  distances, the hotspots and the similarities at the hotspots go to the
  host. The JAX module gathers every pair's nodal block on the host first.
  The nodal self similarities are solved on the device too and stay
  there.
- The hotspot gradient runs through the same :class:`JobPlan` as the
  values (packed once), its entries gathered on the device
  (``MarginalizedGraphKernel._solve_hotspot_grads``). Nothing falls back
  to another backend on a failure: the JAX module's
  ``_hotspot_grad_jobs`` demotes the backend there.
- ``device_distance_fn`` returns a function of a tensor of log-scale
  hyperparameters; it is not traced or compiled. Where a pair may take the
  sum-of-Kronecker route it calibrates the ranks at the call's
  hyperparameters (``JobPlan.calibrate_kron``), where the JAX function
  solves with the default ranks.
"""
import numpy as np
import torch

from ...kernel.marginalized import MarginalizedGraphKernel
from ...kernel.marginalized._kernel import JobPlan
from ...util import Timer
from ...util.trace import span


def _induced_distance(k12, k1, k2):
    """d = sqrt(max(0, 1 - k12 / sqrt(k1 k2)))."""
    return torch.sqrt(torch.clamp(1.0 - k12 / torch.sqrt(k1 * k2), min=0.0))


def _maximin_reduce(ks, k1, k2, rows, cols):
    """The masked maximin reduction of a chunk of pairs: ks [P, a, b] nodal
    cross similarities, k1 [P, a] and k2 [P, b] self similarities (1 where
    a node is padding), rows [P, a] and cols [P, b] the real nodes of the
    two sides. Returns (D [P, a, b] induced distances, valid [P, a, b],
    dh [P] the greatest of the masked row and column minima)."""
    valid = rows[:, :, None] & cols[:, None, :]
    D = _induced_distance(ks, k1[:, :, None], k2[:, None, :])
    masked = torch.where(valid, D, torch.inf)
    to_rows = torch.where(rows, masked.amin(dim=2), -torch.inf).amax(1)
    to_cols = torch.where(cols, masked.amin(dim=1), -torch.inf).amax(1)
    return D, valid, torch.maximum(to_rows, to_cols)


def _fit_width(M, width, fill):
    """Crop or pad the node axis (dim 1) of a padded per-graph view."""
    if M.shape[1] >= width:
        return M[:, :width]
    out = M.new_full((M.shape[0], width) + tuple(M.shape[2:]), fill)
    out[:, :M.shape[1]] = M
    return out


class MaxiMin(MarginalizedGraphKernel):
    """The maximin graph distance: the greatest of all kernel-induced
    distances from a node in one graph to the closest node in the other
    graph, using the marginalized graph kernel as the nodal similarity.

    Accepts the same arguments as MarginalizedGraphKernel (``device``
    included: the card unless the caller asks for the CPU); ``dtype`` is
    always float32.
    """

    #: nudge applied to 1/d in gradient computations for stability near 0
    #: (the reference's ``num_hacks``, ``_backend.cu:29-36``)
    _grad_eps = 1e-4

    def __init__(self, *args, **kwargs):
        kwargs['dtype'] = np.float32
        super().__init__(*args, **kwargs)

    @staticmethod
    def _reduce_block(ks, k1, k2, n1, n2, swap=None):
        """Batched maximin reduction over a chunk of pairs, on its device.

        Parameters: ks [P, a, b] nodal cross similarities; k1 [P, a] and
        k2 [P, b] padded self similarities; n1, n2 [P] node counts of the
        two sides as solved; swap [P] bool (None: none), the pairs solved
        as (j, i) whose own orientation is the transpose.

        Returns (dh, hot): the maximin distance and the hotspot's flat
        index ``i1 * n_j + i2`` in the pair's own orientation, tie-broken
        to the largest such index, as the reference's atomicMax does.
        """
        P, a, b = ks.shape
        dev = ks.device
        ia = torch.arange(a, device=dev)
        ib = torch.arange(b, device=dev)
        D, valid, dh = _maximin_reduce(ks, k1, k2,
                                       ia[None, :] < n1[:, None],
                                       ib[None, :] < n2[:, None])
        flat = ia[None, :, None] * n2[:, None, None] + ib[None, None, :]
        if swap is not None:
            flat = torch.where(swap[:, None, None],
                               ib[None, None, :] * n1[:, None, None]
                               + ia[None, :, None], flat)
        at_max = (D == dh[:, None, None]) & valid
        hot = torch.where(at_max, flat, -1).reshape(P, -1).amax(dim=1)
        return dh, hot.clamp(min=0)

    def _hotspot_gradient(self, k12h, dk12h, k1h, k2h, dk1h, dk2h, dh):
        """Analytic gradient of the maximin distance from flat per-job
        hotspot quantities (numpy, float64): the chain rule of
        d = sqrt(1 - k12 / sqrt(k1 k2)) at the hotspot entry."""
        geo = np.sqrt(k1h * k2h)
        d_ratio = (
            dk12h / geo[:, None]
            - (0.5 * k12h / geo ** 3)[:, None]
            * (dk1h * k2h[:, None] + k1h[:, None] * dk2h)
        )
        return -d_ratio * (0.5 / (dh + self._grad_eps))[:, None]

    def _reduce_chunk(self, R, sl, k_self, dk_self, sizes, gi, gj, first,
                      second, swap):
        """One chunk's maximin reduction on the device: its nodal blocks R
        [C, a, b] are the jobs ``sl`` of a group, whose graphs are ``gi``,
        ``gj`` (``first``, ``second`` as solved; ``swap``). Returns [5 (+ 2
        n_dims), C] float64: dh, the hotspot's flat index in the job's own
        orientation, k12, k1 and k2 at the hotspot (and, with ``dk_self``,
        dk1 and dk2 there)."""
        ks = R.double()
        a, b = ks.shape[1:]
        k1 = _fit_width(k_self[first[sl]], a, 1.0)
        k2 = _fit_width(k_self[second[sl]], b, 1.0)
        dh, hot = self._reduce_block(ks, k1, k2, sizes[first[sl]],
                                     sizes[second[sl]], swap[sl])
        # the hotspot in the job's own orientation (i's node, j's)
        nj = sizes[gj[sl]]
        h1, h2 = hot // nj, hot % nj
        ha = torch.where(swap[sl], h2, h1)    # the same, as solved
        hb = torch.where(swap[sl], h1, h2)
        k = torch.arange(len(hot), device=R.device)
        cols = [dh, hot.double(), ks[k, ha, hb], k_self[gi[sl], h1],
                k_self[gj[sl], h2]]
        if dk_self is not None:
            cols += [dk_self[gi[sl], h1].T, dk_self[gj[sl], h2].T]
        return torch.cat([c.reshape(-1, len(hot)) for c in cols])

    def _nodal_self(self, graphs, eval_gradient, lmin, n_max):
        """The nodal self similarities of every graph, as float64 tensors
        on the device: [G, n_max], padded with ones (so that masked-out
        induced distances stay finite), and with ``eval_gradient`` their
        gradients [G, n_max, n_dims] (linear scale, every hyperparameter),
        padded with zeros; the diagonals of the graphs' own nodal
        solves."""
        jobs = np.arange(len(graphs))
        theta = self._theta_vector()
        plan = JobPlan(self, graphs, jobs, jobs, self.buckets)
        if plan.kron_possible():
            plan.calibrate_kron(theta)
        k_self = torch.ones(len(graphs), n_max, dtype=torch.float64,
                            device=self.device)
        dk_self = torch.zeros(len(graphs), n_max, self.n_dims,
                              dtype=torch.float64, device=self.device) \
            if eval_gradient else None
        for grp in plan.groups:
            rows = torch.as_tensor(plan.i_jobs[grp['pos']], device=self.device)
            s = 0
            for R, dR in plan.solve(theta, grp, True, lmin, eval_gradient):
                at = rows[s:s + R.shape[0]]
                s += R.shape[0]
                width = min(R.shape[1], n_max)
                diag = torch.diagonal(R, dim1=1, dim2=2)[:, :width]
                k_self[at, :width] = diag.double()
                if eval_gradient:
                    ddiag = torch.diagonal(dR, dim1=1, dim2=2)
                    dk_self[at, :width] = ddiag.transpose(1, 2)[:, :width] \
                        .double()
        # the padding of a graph's own block is 1 (its diag is 1 there)
        sizes = torch.as_tensor([len(g.nodes) for g in graphs],
                                device=self.device)
        pad = torch.arange(n_max, device=self.device)[None, :] >= \
            sizes[:, None]
        k_self = torch.where(pad, 1.0, k_self)
        if eval_gradient:
            dk_self = torch.where(pad[:, :, None], 0.0, dk_self)
        return k_self, dk_self

    def device_distance_fn(self, X, lmin=0):
        """The distance matrix over a fixed graph set as a function of the
        hyperparameters, on the device.

        Returns ``(fn, theta0)``: ``fn(theta_log_active) -> [n, n]``, the
        maximin distance matrix (float32, on the kernel's device) at the
        log-scale active hyperparameters (a tensor), and ``theta0``, the
        kernel's current ones as a float32 tensor on the device. The graphs
        are packed once, into one batch padded to the largest graph (a
        :class:`JobPlan` with ``buckets=False``); every call solves all
        pairs of the upper triangle, the diagonal jobs included, at that one
        padded shape, takes the self similarities from the diagonal jobs of
        the same solve, and reduces all pairs at once. ``fn`` itself moves
        nothing to the host (the kernels' wrappers check their index lists
        once a launch), except that a pair that may take the kron route
        calibrates the ranks at the call's hyperparameters on the host.
        This is the device core of :meth:`__call__`, which also returns
        hotspots and gradients and takes rectangular X/Y;
        ``bench_maximin.py`` times its JAX counterpart.
        """
        graphs = list(X)
        self._check_types(graphs)
        n = len(graphs)
        iu, ju = np.triu_indices(n)
        plan = JobPlan(self, graphs, iu, ju, buckets=False)
        (grp,) = plan.groups
        dev = self.device
        full0 = torch.as_tensor(self.flat_hyperparameters, dtype=torch.float64,
                                device=dev)
        active = torch.as_tensor(np.flatnonzero(self.active_theta_mask),
                                 device=dev)
        diag_pos = torch.as_tensor(np.flatnonzero(iu == ju), device=dev)
        iu_t = torch.as_tensor(iu, device=dev)
        ju_t = torch.as_tensor(ju, device=dev)
        mask = grp['bd1']['node_mask'] > 0
        rows, cols = mask[iu_t], mask[ju_t]
        kron = plan.kron_possible()

        def fn(theta_log_active):
            t = torch.as_tensor(theta_log_active, device=dev,
                                dtype=torch.float64)
            full = full0.clone()
            full[active] = torch.exp(t)
            theta = full.to(torch.float32)
            if kron:
                plan.calibrate_kron(theta)
            R = torch.cat([r for r, _ in plan.solve(theta, grp, True, lmin)])
            R = R.double()                                     # [P, a, a]
            k_self = torch.where(mask, torch.diagonal(
                R[diag_pos], dim1=1, dim2=2), 1.0)             # [n, a]
            dh = _maximin_reduce(R, k_self[iu_t], k_self[ju_t], rows,
                                 cols)[2].to(torch.float32)
            out = torch.zeros(n, n, dtype=torch.float32, device=dev)
            out[iu_t, ju_t] = dh
            out[ju_t, iu_t] = dh
            return out

        theta0 = torch.as_tensor(self.theta, dtype=torch.float32, device=dev)
        return fn, theta0

    def __call__(self, X, Y=None, eval_gradient=False, lmin=0,
                 return_hotspot=False, timing=False):
        """Computes the distance matrix, optionally the hotspot node-pair
        indices and the gradient w.r.t. hyperparameters.

        Returns
        -------
        distance: [len(X), len(Y or X)] matrix
        hotspot: (i1, i2) pair of index matrices (if return_hotspot)
        gradient: [.., .., n_active] tensor (if eval_gradient), on the
            linear scale of the hyperparameters
        """
        timer = Timer()
        all_graphs = list(X) + (list(Y) if Y is not None else [])
        self._check_types(all_graphs)

        symmetric = Y is None
        nX = len(X)
        nY = len(Y) if Y is not None else nX
        sizes = np.array([len(g.nodes) for g in all_graphs])
        dev = self.device

        timer.tic('nodal self similarities')
        k_self, dk_self = self._nodal_self(all_graphs, eval_gradient, lmin,
                                           int(sizes.max()))
        timer.toc('nodal self similarities')

        timer.tic('nodal cross similarities and maximin reduction')
        if symmetric:
            i_jobs, j_jobs = np.triu_indices(nX)
        else:
            i_jobs, j_jobs = np.indices((nX, nY))
            j_jobs = j_jobs + nX
        i_jobs, j_jobs = i_jobs.ravel(), j_jobs.ravel()
        theta = self._theta_vector()
        plan = JobPlan(self, all_graphs, i_jobs, j_jobs, self.buckets)
        if plan.kron_possible():
            plan.calibrate_kron(theta)
        P = len(i_jobs)
        dh_all = np.zeros(P)
        hot_all = np.zeros(P, dtype=np.int64)
        k12h, k1h, k2h = np.zeros(P), np.ones(P), np.ones(P)
        dk1h = dk2h = None
        if eval_gradient:
            dk1h = np.zeros((P, self.n_dims))
            dk2h = np.zeros((P, self.n_dims))
        sizes_t = torch.as_tensor(sizes, device=dev)
        for grp in plan.groups:
            pos, swap = grp['pos'], grp['swap']
            gi = torch.as_tensor(i_jobs[pos], device=dev)
            gj = torch.as_tensor(j_jobs[pos], device=dev)
            sw = torch.as_tensor(swap, device=dev)
            first = torch.where(sw, gj, gi)     # the sides as solved
            second = torch.where(sw, gi, gj)
            parts = []
            s = 0
            for R, _ in plan.solve(theta, grp, True, lmin):
                with span('maximin_reduce'):
                    parts.append(self._reduce_chunk(
                        R, slice(s, s + R.shape[0]), k_self, dk_self,
                        sizes_t, gi, gj, first, second, sw))
                s += R.shape[0]
            # one transfer a group: [5 (+ 2 n_dims), n_jobs] float64
            host = torch.cat(parts, dim=1).cpu().numpy()
            dh_all[pos], hot_all[pos] = host[0], host[1].astype(np.int64)
            k12h[pos], k1h[pos], k2h[pos] = host[2], host[3], host[4]
            if eval_gradient:
                nd = self.n_dims
                dk1h[pos] = host[5:5 + nd].T
                dk2h[pos] = host[5 + nd:5 + 2 * nd].T

        n1, n2 = sizes[i_jobs], sizes[j_jobs]
        hot1, hot2 = hot_all // n2, hot_all % n2
        col = j_jobs - nX if not symmetric else j_jobs
        distance = np.zeros((nX, nY), dtype=np.float64)
        hotspot = np.full((nX, nY), -1, dtype=np.int64)
        distance[i_jobs, col] = dh_all
        hotspot[i_jobs, col] = hot_all
        off = i_jobs != j_jobs
        if symmetric:
            distance[j_jobs[off], i_jobs[off]] = dh_all[off]
            hotspot[j_jobs[off], i_jobs[off]] = (hot2 * n1 + hot1)[off]
        timer.toc('nodal cross similarities and maximin reduction')

        gradient = None
        if eval_gradient:
            timer.tic('hotspot gradients')
            dk12 = self._solve_hotspot_grads(plan, hot1, hot2, lmin)
            grad_rows = self._hotspot_gradient(
                k12h, dk12, k1h, k2h, dk1h, dk2h, dh_all)
            gradient = np.zeros((nX, nY, self.n_dims))
            gradient[i_jobs, col] = grad_rows
            if symmetric:
                gradient[j_jobs[off], i_jobs[off]] = grad_rows[off]
            timer.toc('hotspot gradients')

        if timing:
            timer.report(unit='ms')
        timer.reset()

        retval = [distance.astype(self.element_dtype)]
        if return_hotspot is True:
            n = np.array(
                [len(g.nodes) for g in (Y if Y is not None else X)]
            )
            retval.append((hotspot // n, hotspot % n))
        if eval_gradient is True:
            retval.append(
                gradient[:, :, self.active_theta_mask].astype(
                    self.element_dtype
                )
            )
        if len(retval) == 1:
            return retval[0]
        return tuple(retval)
