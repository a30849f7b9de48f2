"""One run of one cell: set-up, the measured window, the check against the
reference, and the metrics.

Everything that belongs to a configuration, a traffic mix or a metric is a
file found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``. A metric's file holds its ``UNIT`` and a function
``read(run)`` that returns its value from a :class:`Run`, or None when the
run holds nothing it can read.
"""
import gc
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from . import cells

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / 'BENCHMARK.json'
#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'graphdot_tpu')


def load_manifest(path=MANIFEST):
    return json.loads(Path(path).read_text())


def workload(manifest, name):
    for w in manifest['workloads']:
        if w['name'] == name:
            return w
    raise KeyError(f'no workload {name!r} in the manifest')


def config_of(manifest, name, root=HERE.parent):
    for c in manifest['configs']:
        if c['name'] == name:
            return json.loads((root / c['file']).read_text())
    raise KeyError(f'no configuration {name!r} in the manifest')


def traffic_of(name, base=HERE):
    return json.loads((base / 'traffic' / f'{name}.json').read_text())


def metric_module(name, base=HERE):
    """The module of ``metrics/<name>.py``."""
    path = base / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        'h100_bench_metric_' + name.replace('.', '_').replace('-', '_'),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(manifest, cell, trace):
    """The entries of the metrics that a run of ``cell`` reports: the
    end-to-end ones with ``trace`` 0, the per-layer ones with 1; each that
    lists its workloads only in those."""
    group = manifest['per_layer'] if trace else manifest['end_to_end']
    return [m for m in group if cell in m.get('workloads', [cell])]


def forbidden_modules(modules=None):
    """The names in ``sys.modules`` whose top-level name (before the first
    dot, compared whole) is one of :data:`FORBIDDEN`."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split('.')[0] in FORBIDDEN)


def guard():
    """Raise, naming them, where :func:`forbidden_modules` finds any."""
    found = forbidden_modules()
    if found:
        raise RuntimeError(f'the run loaded {found}')


def build_seconds():
    """Seconds that this process spent building the program's kernels with
    nvcc: 0 where every library was already built in the checkout."""
    from graphdot_tpu_torch.ops import _build
    total = 0.0
    for name in _build.KERNELS:
        try:
            total += _build.build_info(name)['seconds']
        except KeyError:            # not loaded in this process
            pass
    return total


class Run:
    """What a metric reads: the cell, its requests and their records, the
    window, the set-up, the launch counters over the window, the trace
    (with ``--trace 1``) and the work of a solve layer
    (:meth:`work`)."""

    def __init__(self, cell, kind, requests, window_s, setup_s,
                 counters, trace, device_name, ref):
        self.cell = cell
        self.kind = kind
        self.requests = requests
        self.window_s = window_s
        self.setup_s = setup_s
        self.counters = counters
        self.trace = trace
        self.device_name = device_name
        self._ref = ref
        self._work = {}

    @property
    def records(self):
        return [r['record'] for r in self.requests]

    def done(self):
        return [r for r in self.requests if r['record'] is not None]

    def work(self, name):
        """(bytes, operations) of the layer ``name`` over the window's
        requests, as :mod:`h100_bench.roofline` counts them; None where
        the cell's kind has no such layer."""
        if name not in self._work:
            self._work[name] = self.kind.work(self.records, name, self._ref)
        return self._work[name]


def run_cell(manifest, cell_name, seed, seconds, trace, device='cuda',
             traffic_overrides=None, t_process=None, log=sys.stderr,
             root=HERE.parent):
    """One run; returns the result line's object. ``device`` 'cpu' runs the
    program's plain paths, for the tests: no device metric is read there.
    ``traffic_overrides`` replace parameters of the traffic file (the
    tests' small sizes); ``root`` is the checkout whose ``h100_bench/``
    holds the cell's files."""
    t_process = time.perf_counter() if t_process is None else t_process
    root = Path(root)
    base = root / 'h100_bench'
    cell = workload(manifest, cell_name)
    config = config_of(manifest, cell['config'], root)
    traffic = dict(traffic_of(cell['traffic'], base),
                   **(traffic_overrides or {}))
    kind = cells.KINDS[traffic['kind']](config, traffic, seed, device)
    on_card = device != 'cpu'

    kind.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    before = cells.counters()

    tracer = None
    if trace and on_card:
        from .tracing import Tracer
        tracer = Tracer().__enter__()
    requests = []
    failed = 0
    record = torch.profiler.record_function
    start = time.perf_counter()
    with record('bench.window'):
        while time.perf_counter() - start < seconds:
            k = len(requests)
            t0 = time.perf_counter()
            try:
                with record('bench.request'):
                    rec = kind.request(k)
            except Exception:          # a request that fails is counted
                traceback.print_exc(file=log)
                rec = None
                failed += 1
            requests.append({'t0': t0 - start,
                             't1': time.perf_counter() - start,
                             'record': rec})
    window_s = requests[-1]['t1'] if requests else 0.0
    if tracer is not None:
        tracer.__exit__(None, None, None)
    after = cells.counters()
    guard()

    device_info = {'platform': 'gpu' if on_card else 'cpu',
                   'kind': torch.cuda.get_device_name() if on_card
                   else 'cpu', 'count': 1,
                   'memory_peak_bytes': int(torch.cuda.max_memory_allocated()
                                            ) if on_card else 0}
    kind.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    from .reference import Reference
    ref = Reference(config, device)
    checks = kind.check([r['record'] for r in requests], ref)
    correct = failed == 0 and len(requests) > 0 and all(
        c['value'] <= c['limit'] for c in checks.values())

    run = Run(cell_name, kind, requests, window_s, setup_s,
              {k: after[k] - before[k] for k in after},
              tracer.trace if tracer else None,
              device_info['kind'], ref)
    metrics = {}
    for m in metrics_of(manifest, cell_name, trace):
        module = metric_module(m['name'], base)
        if module.UNIT != m['unit']:
            raise RuntimeError(f'{m["name"]}: unit {module.UNIT!r} in its '
                               f'file, {m["unit"]!r} in the manifest')
        value = module.read(run)
        if value is not None:
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    result = {'correct': bool(correct), 'attempted': len(requests),
              'failed': failed, 'metrics': metrics, 'device': device_info}
    if tracer is not None:
        tr = tracer.trace
        result['device']['busy_s'] = tr.busy_s()
        result['device']['window_s'] = tr.window_s
        result['breakdown'] = {'device_ops': tr.device_ops(),
                               'idle_gaps': tr.idle_gaps()}
        # device operations that the trace could not tie to a launch
        result['untied_ops'] = tr.untied
    # the part of setup_s that built kernels: a checkout's first run only
    result['setup_build_s'] = build_seconds()
    result['checks'] = checks
    # the reference and the metrics' files ran after the first look
    guard()
    return result


def report(result, out=sys.stdout, err=sys.stderr):
    """Print the compared numbers as the last lines of standard error and
    the result as the last line of standard output."""
    for name, c in result['checks'].items():
        print(f'{name} {c["value"]!r} limit {c["limit"]!r}', file=err,
              flush=True)
    print(json.dumps(result), file=out, flush=True)
