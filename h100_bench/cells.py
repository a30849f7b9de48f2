"""The request kinds of the traffic mixes, and the checks that decide
``correct``.

A traffic file names its ``kind`` and its parameters; the kind's class
makes the inputs from the seed (:func:`make_graphs`), builds the program's
objects in set-up, serves one request at a time (:meth:`request`), and
after the window compares a seeded sample of the answers with the plain
reference (:meth:`check`). The requests take their hyperparameters within
a factor ``theta_spread`` of the configuration's, log-uniformly by strata:
each block of :data:`BLOCK` requests takes the same :data:`BLOCK` points of
a fixed Latin hypercube (each hyperparameter each stratum once), in an
order drawn from the seed, so that every seed asks for the same work.

- ``gram``: ``Normalization(kernel)(X)`` over a fixed set, a new theta set
  on the same kernel object each request (the kernel's cached factory);
- ``fit``: ``GaussianProcessRegressor.log_marginal_likelihood(theta,
  eval_gradient=True)`` through the model's factory engine, as an L-BFGS-B
  fit calls it;
- ``predict``: ``GaussianProcessRegressor.predict(Z)`` of a model fitted
  in set-up at the configuration's theta, Z drawn without replacement from a
  pool of candidates outside the training set.
"""
import numpy as np

from . import reference, roofline
from .molecules import make_molecules
from .proteins import make_proteins

#: streams of the seed
THETA, SAMPLE, CHECK, WARMUP, STEPS = range(1, 6)
#: requests a block of hyperparameter strata, and the seed of the
#: hypercube that pairs them
BLOCK = 8
DESIGN_SEED = 0
#: the port's launch counters, (module, function)
COUNTERS = (('graphdot_tpu_torch.ops.pcg', 'pcg_resident'),
            ('graphdot_tpu_torch.ops.pcg', 'pcg_cluster'),
            ('graphdot_tpu_torch.ops.pcg', 'pcg_stream'),
            ('graphdot_tpu_torch.ops.pcg', 'pcg_packed'),
            ('graphdot_tpu_torch.kernel.marginalized._kron', 'kron_pcg'))


def rng(seed, stream, *more):
    return np.random.default_rng([int(seed), stream, *more])


def make_graphs(config, n, seed, device, stream=0):
    """n graphs of the configuration's data set from the seed (and a
    stream of it), and their targets (None where the set has none)."""
    data = config['dataset']
    if data['kind'] == 'qm7':
        return make_molecules(seed, n, device, data['heavy_atoms'], stream)
    if data['kind'] == 'contact_map':
        lo, hi = data['residues']
        return make_proteins([seed, stream], n, lo, hi,
                             data.get('contact_class', False)), None
    raise ValueError(f'no data set of kind {data["kind"]!r}')


def port_graphs(graphs):
    """The program's ``Graph`` objects of the benchmark's graphs, the same
    arrays."""
    from graphdot_tpu_torch.graph import Graph
    from graphdot_tpu_torch.graph.frame import DataFrame
    out = []
    for k, g in enumerate(graphs):
        nodes = DataFrame({'!i': np.arange(g['n']), **g['node']})
        edges = DataFrame({'!i': g['src'], '!j': g['dst'], '!w': g['w'],
                           **g['edge']})
        out.append(Graph(nodes, edges, title=f'g{k}'))
    return Graph.unify_datatype(out)


def port_kernel(config, device):
    """The program's kernel of the configuration; checks that its
    hyperparameters are the reference's, in the same order, all active."""
    from graphdot_tpu_torch.kernel import MarginalizedGraphKernel
    from graphdot_tpu_torch.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    kinds = {'kronecker_delta': KroneckerDelta,
             'square_exponential': SquareExponential}
    k = config['kernel']
    kernel = MarginalizedGraphKernel(
        TensorProduct(**{f: kinds[m](h) for f, m, h in k['node']}),
        TensorProduct(**{f: kinds[m](h) for f, m, h in k['edge']}),
        p=k['p'], q=k['q'], ftol=k['ftol'], gtol=k['gtol'], device=device)
    theta0 = reference.KernelSpec(config).theta0()
    if not (np.allclose(kernel.flat_hyperparameters, theta0)
            and kernel.active_theta_mask.all()):
        raise RuntimeError(
            f'the program\'s hyperparameters {kernel.flat_hyperparameters} '
            f'are not the configuration\'s {theta0}')
    return kernel


def counters():
    """The port's launch counters, by function name."""
    import importlib
    return {name: getattr(importlib.import_module(mod), name).launches
            for mod, name in COUNTERS}


class Kind:
    """What the request kinds share: the configuration, the traffic, the
    seed, the theta of request k."""

    def __init__(self, config, traffic, seed, device):
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = device
        self.spec = reference.KernelSpec(config)
        self.logtheta0 = np.log(self.spec.theta0())

    def size(self, key):
        v = self.traffic[key]
        return int(self.config[v] if isinstance(v, str) else v)

    def logtheta(self, k):
        block, i = divmod(k, BLOCK)
        order = rng(self.seed, THETA, block).permutation(BLOCK)
        return self.logtheta0 + np.log(self.traffic['theta_spread']) * \
            self.design[order[i]]

    @property
    def design(self):
        """[BLOCK, D] offsets in (-1, 1) of a block's hyperparameters: for
        each hyperparameter the BLOCK strata's centres, paired across
        hyperparameters by a fixed Latin hypercube, the same for every
        seed."""
        strata = (np.arange(BLOCK) + 0.5) / BLOCK * 2 - 1
        fixed = np.random.default_rng(DESIGN_SEED)
        return np.stack([fixed.permutation(strata) for _ in self.logtheta0],
                        1)

    def checked(self, n_done):
        """The positions of the requests whose answers are compared: all,
        or a seeded sample of ``check_requests`` with the last in it."""
        m = self.traffic.get('check_requests', 0)
        if not m or m >= n_done:
            return list(range(n_done))
        pick = rng(self.seed, CHECK).choice(n_done - 1, m - 1, replace=False)
        return sorted(pick.tolist()) + [n_done - 1]

    def work(self, records, name, ref):
        """(bytes, operations) of the layer ``name`` over the requests done,
        as :mod:`h100_bench.roofline` counts them; None where the kind has
        no such layer."""
        return None

    def solve_work(self, records, ref, tol, systems, pair_bytes):
        """(bytes, operations) of solving every pair i <= j of
        ``self.graphs`` in each request done: ``pair_bytes(n1, m1, n2, m2)``
        a pair, and ``systems`` systems a pair, each taking the steps of the
        reference's float64 conjugate gradients to a residual norm below
        tol n1 n2, counted on a seeded sample of ``steps_sample`` pairs."""
        sizes = roofline.graph_sizes(self.graphs)
        i, j = np.triu_indices(len(self.graphs))
        pairs = np.stack([i, j], 1)
        nbytes = pair_bytes(*sizes[i].T, *sizes[j].T).sum()
        total_b = total_o = 0.0
        for k, rec in enumerate(records):
            if rec is None:
                continue
            sample = rng(self.seed, STEPS, k).choice(
                len(pairs), min(len(pairs), self.traffic['steps_sample']),
                replace=False)
            steps = ref.values(self.graphs, self.graphs, pairs[sample],
                               self.logtheta(k), steps_tol=tol)
            total_b += nbytes
            total_o += systems * roofline.estimate(sizes, sizes, pairs,
                                                   sample, steps)
        return total_b, total_o

    def release(self):
        """Drop the program's objects."""
        for name in list(vars(self)):
            if name.startswith('p_'):
                delattr(self, name)


def limit_check(name, value, limit):
    return {name: {'value': float(value), 'limit': float(limit)}}


class Gram(Kind):
    """``Normalization(kernel)(X)``: the normalized Gram of a set."""

    def make_data(self):
        self.graphs, _ = make_graphs(self.config, self.size('graphs'),
                                     self.seed, self.device)

    def setup(self):
        from graphdot_tpu_torch.kernel import Normalization
        self.make_data()
        self.p_graphs = port_graphs(self.graphs)
        self.p_kernel = port_kernel(self.config, self.device)
        self.p_norm = Normalization(self.p_kernel)
        self.p_kernel.theta = self.logtheta0
        self.p_norm(self.p_graphs)

    def sample(self, k):
        """The pairs i < j of request k whose answers are kept."""
        n = len(self.graphs)
        r = rng(self.seed, SAMPLE, k)
        i = r.integers(0, n, self.traffic['check_pairs'])
        j = r.integers(0, n - 1, self.traffic['check_pairs'])
        j = np.where(j >= i, j + 1, j)
        return np.stack([np.minimum(i, j), np.maximum(i, j)], 1)

    def request(self, k):
        self.p_kernel.theta = self.logtheta(k)
        K = self.p_norm(self.p_graphs)
        ij = self.sample(k)
        n = len(self.graphs)
        return {'pairs': n * (n + 1) // 2,
                'answers': np.asarray(K)[ij[:, 0], ij[:, 1]]}

    def reference_answers(self, ref, k):
        ij = self.sample(k)
        idx = np.unique(ij)
        lt = self.logtheta(k)
        R = ref.values(self.graphs, self.graphs, ij, lt)
        d = dict(zip(idx.tolist(), ref.values(
            self.graphs, self.graphs, np.stack([idx, idx], 1), lt)))
        return R / np.sqrt([d[i] * d[j] for i, j in ij])

    def control_record(self, ref, k):
        """The record of request k with the answers that :meth:`check`
        reads worked out by ``ref`` (the control's reference)."""
        n = len(self.graphs)
        return {'pairs': n * (n + 1) // 2,
                'answers': self.reference_answers(ref, k)}

    def check(self, records, ref):
        worst = 0.0
        for k in self.checked(len(records)):
            rec = records[k]
            if rec is None:
                continue
            err = np.abs(rec['answers'] - self.reference_answers(ref, k))
            worst = max(worst, float(np.max(err)) if np.isfinite(
                err).all() else np.inf)
        return limit_check('gram_abs_err', worst, self.traffic['limit'])

    def work(self, records, name, ref):
        if name != 'value_solve':
            return None
        return self.solve_work(records, ref, self.config['kernel']['ftol'],
                               1, roofline.value_bytes)


class Fit(Kind):
    """``GaussianProcessRegressor.log_marginal_likelihood(theta,
    eval_gradient=True)`` over a training set, through the model's factory
    engine."""

    def make_data(self):
        self.graphs, self.y = make_graphs(self.config, self.size('graphs'),
                                          self.seed, self.device)

    def setup(self):
        from graphdot_tpu_torch.kernel import Normalization
        from graphdot_tpu_torch.model.gaussian_process import (
            GaussianProcessRegressor)
        self.make_data()
        self.p_graphs = port_graphs(self.graphs)
        model = self.config['model']
        gpr = GaussianProcessRegressor(
            Normalization(port_kernel(self.config, self.device)),
            alpha=model['alpha'], normalize_y=model['normalize_y'],
            optimizer=True, device=self.device)
        # as ``fit`` prepares an optimizer's objective
        gpr.X = self.p_graphs
        gpr.y = self.y
        gpr._engine = gpr._make_factory_engine(gpr.kernel, gpr._X)
        if gpr._engine is None:
            raise RuntimeError('the model declined its factory engine')
        self.p_gpr = gpr
        self.evaluate(self.logtheta0)

    def evaluate(self, logtheta):
        return self.p_gpr.log_marginal_likelihood(
            logtheta, eval_gradient=True, clone_kernel=False)

    def request(self, k):
        value, grad = self.evaluate(self.logtheta(k))
        return {'evals': 1, 'value': float(value),
                'grad': np.asarray(grad, dtype=float)}

    def reference_answers(self, ref, k):
        K, dK = ref.gram(self.graphs, self.logtheta(k), with_grad=True)
        return reference.gp_nll(K, self.y, self.config['model']['alpha'],
                                dK)

    def control_record(self, ref, k):
        value, grad = self.reference_answers(ref, k)
        return {'evals': 1, 'value': value, 'grad': grad}

    def check(self, records, ref):
        worst_v = worst_g = 0.0
        for k in self.checked(len(records)):
            rec = records[k]
            if rec is None:
                continue
            value, grad = self.reference_answers(ref, k)
            ev = abs(rec['value'] - value) / abs(value)
            eg = np.max(np.abs(rec['grad'] - grad)) / np.max(np.abs(grad))
            worst_v = max(worst_v, ev if np.isfinite(ev) else np.inf)
            worst_g = max(worst_g, eg if np.isfinite(eg) else np.inf)
        limits = self.traffic['limit']
        return {**limit_check('lml_rel_err', worst_v, limits['lml']),
                **limit_check('grad_rel_err', worst_g, limits['grad'])}

    def work(self, records, name, ref):
        """The tangent solves: k = len(theta) systems a pair, each taken to
        need the steps of the pair's value system to the tangents'
        tolerance."""
        if name != 'tangent_solve':
            return None
        D = len(self.logtheta0)
        return self.solve_work(
            records, ref, self.config['kernel']['gtol'], D,
            lambda n1, m1, n2, m2: roofline.tangent_bytes(n1, m1, n2, m2, D))


class Predict(Kind):
    """``GaussianProcessRegressor.predict(Z)`` of a model fitted in set-up,
    Z a seeded draw from a pool of candidates."""

    def make_data(self):
        self.train, self.y = make_graphs(self.config, self.size('train'),
                                         self.seed, self.device)
        self.pool, _ = make_graphs(self.config, self.size('pool'),
                                   self.seed, self.device, stream=1)

    def setup(self):
        from graphdot_tpu_torch.kernel import Normalization
        from graphdot_tpu_torch.model.gaussian_process import (
            GaussianProcessRegressor)
        self.make_data()
        self.p_train = port_graphs(self.train)
        self.p_pool = port_graphs(self.pool)
        model = self.config['model']
        kernel = port_kernel(self.config, self.device)
        kernel.theta = self.logtheta0
        self.p_gpr = GaussianProcessRegressor(
            Normalization(kernel), alpha=model['alpha'],
            normalize_y=model['normalize_y'], optimizer=None,
            device=self.device).fit(self.p_train, self.y)
        for w in range(self.traffic['warmup']):
            self.p_gpr.predict(self.candidates(w, WARMUP))

    def draw(self, k, stream=SAMPLE):
        return rng(self.seed, stream, k).choice(
            len(self.pool), self.traffic['batch'], replace=False)

    def candidates(self, k, stream=SAMPLE):
        return [self.p_pool[i] for i in self.draw(k, stream)]

    def request(self, k):
        mean = self.p_gpr.predict(self.candidates(k))
        return {'molecules': len(mean), 'answers': np.asarray(mean)}

    def reference_model(self, ref):
        """(the training Gram, the R of the training set's self pairs) at
        the configuration's theta."""
        n = len(self.train)
        diag = ref.values(self.train, self.train,
                          np.stack([np.arange(n)] * 2, 1), self.logtheta0)
        return ref.gram(self.train, self.logtheta0), diag

    def reference_answers(self, ref, k, model):
        K, diag = model
        Z = [self.pool[i] for i in self.draw(k)]
        Ks = ref.cross(Z, self.train, self.logtheta0, diag_X=diag)
        return reference.gp_mean(K, self.y, self.config['model']['alpha'],
                                 Ks)

    def control_record(self, ref, k):
        if getattr(self, '_control_model', (None,))[0] is not ref:
            self._control_model = (ref, self.reference_model(ref))
        answers = self.reference_answers(ref, k, self._control_model[1])
        return {'molecules': len(answers), 'answers': answers}

    def check(self, records, ref):
        model = self.reference_model(ref)
        worst = 0.0
        scale = self.y.std()
        for k in self.checked(len(records)):
            rec = records[k]
            if rec is None:
                continue
            err = np.abs(rec['answers'] - self.reference_answers(ref, k,
                                                                 model))
            worst = max(worst, float(np.max(err)) / scale if np.isfinite(
                err).all() else np.inf)
        return limit_check('mean_rel_err', worst, self.traffic['limit'])

    def logtheta(self, k):
        return self.logtheta0


KINDS = {'gram': Gram, 'fit': Fit, 'predict': Predict}
