"""The per-layer metric ``setup_edge_fused_share.gram`` on made-up
counters: the share of the pairs whose T one pass built; 0 where pairs
were counted and none of them in one pass; None without a trace, without
the counters (the parent program) or without the counter module."""
import sys

import pytest
import torch

from test_bench_spans import FakeRun, gram_events, read

from h100_bench import harness

NAME = 'setup_edge_fused_share.gram'


@pytest.mark.parametrize('fused, pairs, share', [
    (300, 400, 75.0), (400, 400, 100.0), (None, 400, 0.0)])
def test_the_share_from_made_up_counters(fused, pairs, share):
    from graphdot_tpu_torch.util import trace
    trace.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            trace.count('setup_edge.pairs', pairs)
            if fused is not None:
                trace.count('setup_edge.fused', fused)
        assert read(NAME, FakeRun(gram_events(), 2)) == share
        assert read(NAME, FakeRun(None, 2)) is None
    finally:
        trace.reset_counters()


def test_a_program_without_the_counters_gives_no_value(monkeypatch):
    from graphdot_tpu_torch.util import trace
    trace.reset_counters()
    assert read(NAME, FakeRun(gram_events(False), 2)) is None
    monkeypatch.setitem(sys.modules, 'graphdot_tpu_torch.util.trace', None)
    assert read(NAME, FakeRun(gram_events(False), 2)) is None


def test_the_manifest_lists_it():
    per_layer = {m['name']: m for m in harness.load_manifest()['per_layer']}
    m = per_layer[NAME]
    assert m['workloads'] == ['qm7-gram'] and m['unit'] == '%'
    assert m['layer'] == per_layer['setup_device_ms.gram']['layer']
    assert harness.metric_module(NAME).UNIT == '%'
