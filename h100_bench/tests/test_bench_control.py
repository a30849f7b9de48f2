"""The comparison that decides ``correct`` fails where it must, at sizes a
test run holds, on the CPU: the control (the reference in bfloat16 in the
program's place) on every cell, and a run of each cell with its timed path
broken underneath (half of the pairs left out; each pair's answer altered
where it is produced). The guard on JAX's modules is checked here too."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402
from h100_bench.control import control  # noqa: E402

SMALL = {
    'qm7-gram': {'graphs': 6, 'check_pairs': 6, 'steps_sample': 8},
    'qm7-fit': {'graphs': 8, 'steps_sample': 8},
    'qm7-predict': {'train': 8, 'pool': 8, 'batch': 3, 'warmup': 1,
                    'check_requests': 2},
}


#: a cell whose traffic and metric files are here, ready for the manifest
READY = {'name': 'qm7-predict', 'config': 'qm7-tang2019',
         'traffic': 'predict-1024x16', 'chips': 1,
         'why': 'predict 16 new molecules against a GP on 1024'}


@pytest.fixture(scope='module')
def manifest():
    m = harness.load_manifest()
    if READY['name'] not in {w['name'] for w in m['workloads']}:
        m['workloads'].append(READY)
    return m


@pytest.mark.parametrize('cell', sorted(SMALL))
def test_control_fails(manifest, cell):
    out = control(manifest, cell, 21, 2, 'cpu',
                  traffic_overrides=SMALL[cell])
    assert not out['correct'], out
    assert all(np.isfinite(c['value']) for c in out['checks'].values())


def broken_solve(how):
    """``mlgk_solve`` with its solution x broken: ``'half'`` zeroes the
    solutions of every other pair of a chunk; ``'altered'`` scales each
    pair's by its own factor within 1e-2 of 1."""
    from graphdot_tpu_torch.kernel.marginalized import _solver
    solve = _solver.mlgk_solve

    def broken(*args, **kwargs):
        out = solve(*args, **kwargs)
        x = out[0].clone()
        if how == 'half':
            x[::2] = 0
        else:
            gen = np.random.default_rng(len(x))
            scale = 1 + 1e-2 * gen.uniform(-1, 1, len(x))
            x = x * x.new_tensor(scale).reshape(-1, *[1] * (x.dim() - 1))
        return (x, *out[1:])
    return broken


@pytest.mark.parametrize('how', ['half', 'altered'])
@pytest.mark.parametrize('cell', sorted(SMALL))
def test_broken_timed_path_is_not_correct(manifest, cell, how, monkeypatch):
    """The solve is broken once set-up is done, so that the window's
    requests, and not the set-up, run the fault."""
    from graphdot_tpu_torch.kernel.marginalized import _kernel
    from h100_bench import cells
    kind = harness.traffic_of(harness.workload(manifest, cell)['traffic'])[
        'kind']

    class Broken(cells.KINDS[kind]):
        def setup(self):
            super().setup()
            monkeypatch.setattr(_kernel, 'mlgk_solve', broken_solve(how))

    monkeypatch.setitem(cells.KINDS, kind, Broken)
    result = harness.run_cell(manifest, cell, 31, 0.3, 0, device='cpu',
                              traffic_overrides=SMALL[cell])
    assert not result['correct'], result['checks']


def test_guard_compares_whole_top_level_names():
    modules = {'jax': 1, 'jax.numpy': 1, 'jaxlib.xla': 1, 'flax': 1,
               'graphdot_tpu': 1, 'graphdot_tpu.ops': 1,
               'graphdot_tpu_torch': 1, 'graphdot_tpu_torch.ops.pcg': 1,
               'jaxtyping': 1, 'h100_bench': 1}
    assert harness.forbidden_modules(modules) == [
        'flax', 'graphdot_tpu', 'graphdot_tpu.ops', 'jax', 'jax.numpy',
        'jaxlib.xla']


def test_a_run_loads_no_jax():
    """A whole run of a cell, in a fresh process, leaves neither JAX nor
    the JAX package in ``sys.modules``."""
    code = (
        'import sys; sys.path.insert(0, %r)\n'
        'from h100_bench import harness\n'
        'r = harness.run_cell(harness.load_manifest(), "qm7-gram", 5, 0.2, '
        '0, device="cpu", traffic_overrides={"graphs": 4, '
        '"check_pairs": 2})\n'
        'assert r["correct"]\n'
        'print(harness.forbidden_modules())\n' % str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


STUB_METRIC = '''"""Requests completed, from a file that loads a module named jax."""
import sys
sys.path.insert(0, %r)
import jax  # noqa: E402,F401
UNIT = 'count'


def read(run):
    return len(run.done())
'''


def test_jax_loaded_after_the_window_fails_the_run(tmp_path):
    """A metric's file that imports a (stub) ``jax`` module after the window
    has closed: the run raises, names the module, and reports no result."""
    import shutil
    stub = tmp_path / 'stub'
    (stub / 'jax').mkdir(parents=True)
    (stub / 'jax' / '__init__.py').write_text('')
    shutil.copytree(ROOT / 'h100_bench', tmp_path / 'h100_bench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    (tmp_path / 'h100_bench' / 'metrics' / 'requests_done.py').write_text(
        STUB_METRIC % str(stub))
    code = (
        'import sys; sys.path.insert(0, %r)\n'
        'from h100_bench import harness\n'
        'm = harness.load_manifest()\n'
        'm["end_to_end"].append({"name": "requests_done", "unit": "count", '
        '"better": "higher", "bound": 0.25, "source": "host_clock", '
        '"workloads": ["qm7-gram"]})\n'
        'r = harness.run_cell(m, "qm7-gram", 5, 0.2, 0, device="cpu", '
        'root=%r, traffic_overrides={"graphs": 4, "check_pairs": 2})\n'
        'harness.report(r)\n' % (str(ROOT), str(tmp_path)))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0
    assert "the run loaded ['jax']" in out.stderr
    assert '"correct"' not in out.stdout
