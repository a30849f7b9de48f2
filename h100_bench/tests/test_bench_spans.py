"""The per-layer metrics that read the program's spans and counters, on
made-up events: device time launched in a span, host self time less the
spans nested in it, the ``host_sync`` split, the counters' ratios; the
metrics of the spans the program had before read the same with the new
spans nested in them; a program without the spans or the counters gives
no value and raises nothing."""
import sys
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from h100_bench import harness, spans  # noqa: E402
from h100_bench.tracing import Trace  # noqa: E402

from test_bench_tracing import Event  # noqa: E402

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def rng(name, start, end):
    return Event(name, CPU, start, end, annotation=True)


def launch(at, corr):
    return Event('cudaLaunchKernel', CPU, at, at + 5, corr=corr)


def op(name, start, end, corr):
    return Event(name, CUDA, start, end, corr=corr)


def gram_events(new_spans=True):
    """Two requests of a Gram: the program's spans (or, without
    ``new_spans``, only those it had before) and one kernel in each of
    T's build, the rest of the set-up and the value solve."""
    ev = [rng('bench.window', 0, 20000)]
    for r, base in enumerate((0, 10000)):
        ev.append(rng('bench.request', base, base + 9000))

        def at(t):
            return base + t
        old = [rng('mlgk_setup', at(500), at(1500)),
               rng('mlgk_value_solve', at(1500), at(3500))]
        new = [rng('normalization', at(100), at(8000)),
               rng('mlgk_call', at(200), at(7600)),
               rng('gram_factory', at(300), at(7000)),
               rng('mlgk_chunk', at(400), at(4000)),
               rng('mlgk_setup_edge', at(600), at(1000)),
               rng('pcg_cluster_call', at(1600), at(3400)),
               rng('host_sync', at(2000), at(3000)),
               rng('host_sync', at(7100), at(7500))]
        ev += old + (new if new_spans else [])
        c = 10 * r
        ev += [launch(at(700), c + 1), op('t_build', at(800), at(1100), c + 1),
               launch(at(1200), c + 2), op('vx', at(1300), at(1400), c + 2),
               launch(at(1700), c + 3), op('pcg', at(1800), at(2600), c + 3)]
    return ev


def fit_events(new_spans=True):
    """One evaluation of a GP objective with its tangents."""
    ev = [rng('bench.window', 0, 10000), rng('bench.request', 0, 9000),
          rng('mlgk_setup', 400, 1000), rng('mlgk_tangents', 1000, 3000),
          rng('mlgk_tangent_solve', 3000, 4000)]
    if new_spans:
        ev += [rng('gp_objective', 100, 8000),
               rng('gram_factory', 200, 5000),
               rng('mlgk_chunk', 300, 4900),
               rng('mlgk_tangents_jac', 1100, 2000),
               rng('mlgk_setup_edge', 1200, 1500),
               rng('mlgk_tangents_rhs', 2000, 2900),
               rng('pcg_packed_call', 3100, 3900),
               rng('host_sync', 3200, 3300),
               rng('host_sync', 5100, 5600),
               rng('host_sync', 7000, 7200)]
    ev += [launch(500, 5), op('t_build', 600, 700, 5),
           launch(1300, 1), op('jac', 1400, 1900, 1),
           launch(2100, 2), op('gather', 2200, 2600, 2),
           launch(2700, 3), op('sub', 2750, 2800, 3),
           launch(3500, 4), op('packed', 3600, 3900, 4)]
    return ev


class FakeRun:
    """What a metric reads of :class:`h100_bench.harness.Run`."""

    def __init__(self, events, n_done):
        self.trace = None if events is None else Trace(events)
        self._done = [{'record': {}}] * n_done

    def done(self):
        return self._done


def read(name, run):
    return harness.metric_module(name).read(run)


def test_host_s_less():
    tr = Trace(gram_events())
    factory = ('normalization', 'mlgk_call', 'gram_factory', 'mlgk_chunk')
    # a request: normalization 7900 less the nested non-factory spans
    # (mlgk_setup 1000, mlgk_value_solve 2000, host_sync 400)
    assert spans.host_s_less(tr, factory) == pytest.approx(2 * 4500e-9)
    assert spans.host_s_less(tr, ('host_sync',), ()) == pytest.approx(
        2 * 1400e-9)
    assert spans.host_s_less(tr, ('pcg_cluster_call',), ('host_sync',)) == \
        pytest.approx(2 * 800e-9)
    # the outermost only: a nested span of the same name is not added
    assert spans.host_s_less(tr, ('mlgk_call', 'mlgk_chunk'), ()) == \
        pytest.approx(2 * 7400e-9)


def test_gram_metrics():
    run = FakeRun(gram_events(), 2)
    assert read('setup_edge_device_ms.gram', run) == pytest.approx(300e-6)
    assert read('factory_host_ms.gram', run) == pytest.approx(4500e-6)
    assert read('pcg_host_ms.gram', run) == pytest.approx(800e-6)
    assert read('host_wait_ms.gram', run) == pytest.approx(1400e-6)


def test_fit_metrics():
    run = FakeRun(fit_events(), 1)
    # gp_objective 7900 less gram_factory 4800 and the two host_syncs
    # outside it (500 + 200)
    assert read('objective_host_ms.fit', run) == pytest.approx(2400e-6)
    assert read('tangents_rhs_device_ms.fit', run) == pytest.approx(450e-6)
    assert read('host_wait_ms.fit', run) == pytest.approx(800e-6)


@pytest.mark.parametrize('events, n_done, names', [
    (gram_events, 2, ['setup_device_ms.gram']),
    (fit_events, 1, ['tangents_host_ms.fit']),
])
def test_old_metrics_read_the_same_with_the_new_spans(events, n_done, names):
    new, old = FakeRun(events(), n_done), FakeRun(events(False), n_done)
    for name in names:
        assert read(name, new) == read(name, old) is not None
    for rng_name in ('mlgk_setup', 'mlgk_value_solve', 'mlgk_tangents',
                     'mlgk_tangent_solve'):
        assert new.trace.device_s_in(rng_name) == \
            old.trace.device_s_in(rng_name)
        assert new.trace.host_s_in(rng_name) == old.trace.host_s_in(rng_name)
    assert new.trace.device_s_in('mlgk_setup') > 0


@pytest.mark.parametrize('name', ['roofline.value_solve.gram',
                                  'roofline.tangent_solve.fit'])
def test_rooflines_read_the_same_with_the_new_spans(name):
    def with_work(run):
        run.work = lambda layer: (1e6, 1e6)
        run.device_name = 'NVIDIA H100 80GB HBM3'
        return run
    events = gram_events if name.endswith('gram') else fit_events
    n = 2 if name.endswith('gram') else 1
    new = read(name, with_work(FakeRun(events(), n)))
    assert new == read(name, with_work(FakeRun(events(False), n)))
    assert new is not None


def test_the_counters_ratios():
    from graphdot_tpu_torch.util import trace
    trace.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            trace.count('cg_steps.value', torch.tensor([3, 5, 7]))
            trace.count('cg_systems.value', 3)
            trace.count('cg_steps.tangent', torch.tensor([4, 6]), 4)
            trace.count('cg_systems.tangent', 8)
        run = FakeRun(gram_events(), 2)
        assert read('value_cg_steps.gram', run) == 5.0
        assert read('tangent_cg_steps.fit', run) == 5.0
        assert read('value_cg_steps.gram', FakeRun(None, 2)) is None
    finally:
        trace.reset_counters()
    assert read('value_cg_steps.gram', FakeRun(gram_events(), 2)) is None


NEW = ['setup_edge_device_ms.gram', 'value_cg_steps.gram',
       'pcg_host_ms.gram', 'factory_host_ms.gram', 'host_wait_ms.gram',
       'objective_host_ms.fit', 'tangent_cg_steps.fit',
       'tangents_rhs_device_ms.fit', 'host_wait_ms.fit']


@pytest.mark.parametrize('name', NEW)
def test_a_program_without_them_gives_no_value(name, monkeypatch):
    """The parent program: no new span in the trace and no counter
    module; every new metric returns None without raising."""
    monkeypatch.setitem(sys.modules, 'graphdot_tpu_torch.util.trace', None)
    events = gram_events if name.endswith('gram') else fit_events
    assert read(name, FakeRun(events(False), 2)) is None
    assert read(name, FakeRun(None, 2)) is None


def test_the_manifest_lists_them():
    manifest = harness.load_manifest()
    per_layer = {m['name']: m for m in manifest['per_layer']}
    for name in NEW:
        cell = 'qm7-gram' if name.endswith('gram') else 'qm7-fit'
        assert per_layer[name]['workloads'] == [cell]
