"""The port's spans and counters (``graphdot_tpu_torch.util.trace``).

Without a profiler no span enters a range and no counter counts. Under
``torch.profiler`` (CPU activity) a normalized Gram through the factory
route and a GP likelihood with its gradient show every span of the port,
nested as the solver, the factory and the model call each other; the value
solves' step counter equals ``GramFactory.iteration_stats`` group by group
(both are the plain PCG on the CPU); a packed tangent group's steps count
once a real member. The Gram, the likelihood and its gradient are the same
bits with the profiler on and off, on the ``jacfwd`` and the batched
(``vmap``) paths.
"""
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch.inference import GramFactory  # noqa: E402
from graphdot_tpu_torch.kernel import (  # noqa: E402
    MarginalizedGraphKernel, Normalization)
from graphdot_tpu_torch.kernel.marginalized import _solver  # noqa: E402
from graphdot_tpu_torch.model.gaussian_process import (  # noqa: E402
    GaussianProcessRegressor)
from graphdot_tpu_torch.testing import random_molecule_set  # noqa: E402
from graphdot_tpu_torch.util import trace  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread, as the other port tests do (the test
    processes run side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_counters():
    trace.reset_counters()
    yield
    trace.reset_counters()


#: graph sets: (seed, count, atom range); 'two' spans the classes 8 and 16
SETS = {'two': (11, 7, (5, 14)), 'one': (12, 5, (10, 16))}


@lru_cache(maxsize=None)
def graphs(name):
    return random_molecule_set(*SETS[name])


def port_kernel(backend='cuda'):
    return MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.3)),
        tmk.TensorProduct(length=tmk.SquareExponential(0.5)),
        q=0.1, backend=backend, device='cpu')


def profiled(fn):
    """(fn's result, the profiler's ``record_function`` events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()]
    return out, events


def paths(events):
    """The set of 'outer/inner/...' name paths of nested ranges."""
    events = sorted(events, key=lambda e: (e.start_ns(), -e.end_ns()))
    stack, out = [], set()
    for e in events:
        while stack and not (e.start_ns() >= stack[-1].start_ns()
                             and e.end_ns() <= stack[-1].end_ns()):
            stack.pop()
        stack.append(e)
        out.add('/'.join(s.name() for s in stack))
    return out


def gp_model(graphs_):
    gpr = GaussianProcessRegressor(Normalization(port_kernel()), alpha=1e-4,
                                   optimizer=True, device='cpu')
    gpr.X = graphs_
    gpr.y = np.linspace(-1.0, 2.0, len(graphs_))
    gpr._engine = gpr._make_factory_engine(gpr.kernel, gpr._X)
    assert gpr._engine is not None
    return gpr


def test_no_profiler_no_range_and_no_count(monkeypatch):
    monkeypatch.setenv('GRAPHDOT_API_UNION', '1')
    assert not trace.recording()
    assert trace.span('a') is trace.span('b')
    entered = []
    monkeypatch.setattr(torch.profiler, 'record_function',
                        lambda name: entered.append(name))
    trace.count('x', 3)
    Normalization(port_kernel())(graphs('two'))
    assert entered == [] and trace.counters() == {}


def test_counters_sum_host_ints_and_tensors_once_read():
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.recording()
        trace.count('n', 2)
        trace.count('n', torch.tensor([1, 2, 3], dtype=torch.int32), 2)
        trace.count('m', torch.tensor(5))
    trace.count('n', 100)      # no profiler: not counted
    assert trace.counters() == {'n': 14, 'm': 5}
    trace.reset_counters()
    assert trace.counters() == {}


GRAM_PATHS = [
    'normalization/mlgk_call/gram_factory/mlgk_chunk/mlgk_setup/'
    'mlgk_setup_edge',
    'normalization/mlgk_call/gram_factory/mlgk_chunk/mlgk_value_solve/'
    'pcg_resident_call/host_sync',
    'normalization/mlgk_call/host_sync',
]
GP_PATHS = [
    'gp_objective/gram_factory/mlgk_chunk/mlgk_setup/mlgk_setup_edge',
    'gp_objective/gram_factory/mlgk_chunk/mlgk_value_solve/'
    'pcg_resident_call/host_sync',
    'gp_objective/gram_factory/mlgk_chunk/mlgk_tangents/mlgk_tangents_jac',
    'gp_objective/gram_factory/mlgk_chunk/mlgk_tangents/mlgk_tangents_rhs',
    'gp_objective/gram_factory/mlgk_chunk/mlgk_tangent_solve/'
    'pcg_packed_call/host_sync',
    'gp_objective/host_sync',
]


def test_gram_spans_nest(monkeypatch):
    monkeypatch.setenv('GRAPHDOT_API_UNION', '1')
    norm = Normalization(port_kernel())
    K0 = norm(graphs('two'))
    K1, events = profiled(lambda: norm(graphs('two')))
    got = paths(events)
    assert set(GRAM_PATHS) <= got, sorted(got)
    assert np.array_equal(K0, K1)
    c = trace.counters()
    n = len(graphs('two'))
    assert c['cg_systems.value'] == n * (n + 1) // 2
    assert c['cg_steps.value'] >= c['cg_systems.value']
    assert 'cg_systems.tangent' not in c


def test_diag_and_per_pair_call_spans(monkeypatch):
    monkeypatch.setenv('GRAPHDOT_API_UNION', '0')
    kernel = port_kernel()
    G = graphs('two')
    _, events = profiled(lambda: (kernel(G[:3], G[3:]), kernel.diag(G)))
    got = paths(events)
    assert 'mlgk_call/mlgk_chunk/mlgk_value_solve/pcg_resident_call' in got
    assert not any(p.startswith('mlgk_call/mlgk_call') for p in got)
    assert sum(e.name() == 'mlgk_call' for e in events) == 2


def test_gp_objective_spans_nest():
    gpr = gp_model(graphs('two'))
    theta = gpr.kernel.theta
    v0, g0 = gpr.log_marginal_likelihood(theta, eval_gradient=True,
                                         clone_kernel=False)
    (v1, g1), events = profiled(lambda: gpr.log_marginal_likelihood(
        theta, eval_gradient=True, clone_kernel=False))
    got = paths(events)
    assert set(GP_PATHS) <= got, sorted(got)
    assert v0 == v1 and np.array_equal(g0, g1)
    c = trace.counters()
    n, k = len(graphs('two')), gpr.kernel.kernel.n_dims
    assert c['cg_systems.tangent'] == n * (n + 1) // 2 * k
    assert c['cg_steps.tangent'] >= c['cg_systems.tangent']


@pytest.mark.parametrize('loss', ['log_marginal_likelihood',
                                  'squared_loocv_error'])
def test_every_objective_is_a_span(loss):
    gpr = gp_model(graphs('one'))
    _, events = profiled(lambda: getattr(gpr, loss)(
        gpr.kernel.theta, eval_gradient=False, clone_kernel=False))
    assert [e.name() for e in events].count('gp_objective') == 1


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
@pytest.mark.parametrize('name', SETS)
def test_value_steps_match_iteration_stats(name, backend):
    """Group by group: the counters of one group's chunk solves against
    ``iteration_stats`` at the same theta."""
    fac = GramFactory(port_kernel(backend), graphs(name))
    stats = fac.iteration_stats(fac.theta0)
    theta = fac.full_theta(fac.theta0)
    plan = fac._plan
    assert len(stats) == len(plan.groups) == (3 if name == 'two' else 1)
    for grp, st in zip(plan.groups, stats):
        trace.reset_counters()
        profiled(lambda: list(plan.solve(
            theta, grp, False, 0, maxiter=fac._group_maxiter(grp))))
        c = trace.counters()
        assert c['cg_systems.value'] == st['n_jobs']
        assert c['cg_steps.value'] == int(st['iters'].sum())
    trace.reset_counters()
    profiled(lambda: fac.gram(fac.theta0))
    assert trace.counters()['cg_steps.value'] == sum(
        int(st['iters'].sum()) for st in stats)


def test_packed_group_steps_count_once_a_real_member(monkeypatch):
    """k = 5 tangents in groups of 3: the second group carries two real
    members and one padded, which counts no system."""
    P, k, group = 2, 5, 3
    iters = torch.tensor([7, 4, 9, 2], dtype=torch.int32)  # [P * groups]

    def fake_packed(T, *args):
        b = args[-3]
        return torch.zeros_like(b), iters
    monkeypatch.setattr(_solver, 'pcg_packed', fake_packed)
    zeros = torch.zeros(P, 1)
    rhs = torch.ones(P, k, 2, 2)
    with profile(activities=[ProfilerActivity.CPU]):
        _solver._packed_tangents(group, zeros, zeros, zeros, zeros, zeros,
                                 zeros, zeros, rhs, torch.ones(P), 10)
    assert trace.counters() == {'cg_steps.tangent': (7 + 9) * 3
                                + (4 + 2) * 2,
                                'cg_systems.tangent': P * k}


def test_gram_and_gradient_same_bits_with_the_profiler_on():
    """``mlgk_tangents``' jacfwd path and the batched setup over thetas
    (``_setup_over_thetas``, ``vmap``): K and dK equal bit for bit."""
    fac = GramFactory(Normalization(port_kernel()), graphs('two'))
    t = fac.theta0
    thetas = np.stack([t, t + 0.1, t - 0.2])
    off = [fac.gram(t, eval_gradient=True),
           fac.gram(thetas, eval_gradient=True)]
    on, events = profiled(lambda: [fac.gram(t, eval_gradient=True),
                                   fac.gram(thetas, eval_gradient=True)])
    assert {'mlgk_tangents_jac', 'mlgk_setup_edge'} <= {
        e.name() for e in events}
    for a, b in zip(off, on):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
