"""The manifest and the files it names: names and units of the allowed
characters, every configuration, traffic mix and metric found by its name,
and a metric added as a file picked up with no edit to any other file."""
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
LINE = re.compile(r'^[^\t\n]{1,200}$')


@pytest.fixture(scope='module')
def manifest():
    return harness.load_manifest()


def test_keys_and_names(manifest):
    assert set(manifest) == {'command', 'paths', 'run_seconds', 'configs',
                             'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= manifest['run_seconds'] <= 51
    for c in manifest['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and LINE.match(c['source'])
        assert LINE.match(c['why'])
        assert all(NAME.match(k) for k in c['reduced'])
    for w in manifest['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        for key in ('name', 'config', 'traffic'):
            assert NAME.match(w[key]), w[key]
        assert w['chips'] in (1, 4) and LINE.match(w['why'])
    metrics = manifest['end_to_end'] + manifest['per_layer']
    for m in metrics:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    for m in manifest['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0 < m['bound'] <= 0.25
    for m in manifest['per_layer']:
        assert LINE.match(m['layer'])
        assert m['moves'] in {e['name'] for e in manifest['end_to_end']}
    names = [m['name'] for m in metrics]
    assert len(names) == len(set(names))
    assert len({w['name'] for w in manifest['workloads']}) == len(
        manifest['workloads'])
    assert len(json.dumps(manifest)) < 64 * 1024


def test_every_name_finds_its_file(manifest):
    for c in manifest['configs']:
        config = harness.config_of(manifest, c['name'])
        assert config['name'] == c['name']
        assert c['reduced'] == config['reduced']
    for w in manifest['workloads']:
        assert harness.traffic_of(w['traffic'])['kind']
    for m in manifest['end_to_end'] + manifest['per_layer']:
        module = harness.metric_module(m['name'])
        assert module.UNIT == m['unit'] and callable(module.read)


def test_every_cell_reports_what_it_must(manifest):
    for w in manifest['workloads']:
        e2e = {m['name'] for m in harness.metrics_of(manifest, w['name'], 0)}
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert harness.metrics_of(manifest, w['name'], 1)
        for m in harness.metrics_of(manifest, w['name'], 1):
            assert m['moves'] in e2e


EXTRA = '''"""Requests completed in the window."""
UNIT = 'count'


def read(run):
    return len(run.done())
'''


def test_a_new_metric_file_is_picked_up(tmp_path, manifest):
    """A copy of the benchmark with one more metric: its file and its entry
    in the manifest, and no other file edited."""
    shutil.copytree(ROOT / 'h100_bench', tmp_path / 'h100_bench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    (tmp_path / 'h100_bench' / 'metrics' / 'requests_done.py').write_text(
        EXTRA)
    extended = json.loads(json.dumps(manifest))
    extended['end_to_end'].append({
        'name': 'requests_done', 'unit': 'count', 'better': 'higher',
        'bound': 0.25, 'source': 'host_clock', 'workloads': ['qm7-gram']})
    result = harness.run_cell(
        extended, 'qm7-gram', 3, 0.5, 0, device='cpu', root=tmp_path,
        traffic_overrides={'graphs': 5, 'check_pairs': 4})
    assert result['correct']
    assert result['metrics']['requests_done']['value'] == \
        result['attempted']
    assert list(result)[-1] == 'checks'
