#!/usr/bin/env python3
"""Times the molecule Grams at the edge of ``pcg_resident``'s reach on one
NVIDIA GPU, for comparing two checkouts of the port on the same card.

For 32 random molecules of 48-55 atoms (padded to n = 56) and of 56-63
atoms (n = 64), 528 pairs each, it builds the normalized Gram through
``Normalization(MarginalizedGraphKernel(..., device='cuda'))`` as a value
and with ``eval_gradient=True``, and prints for each:

- which CUDA kernels the build launched (the wrappers' launch counters);
- the wall time of a build, median of :data:`REPEATS` after one warm-up;
- one profiled build (``torch.profiler``): the device time of each PCG
  kernel and of all kernels, and the device span of each of the solver's
  ranges (``mlgk_setup``, ``mlgk_tangents``, ...: first kernel to last,
  gaps included).

It uses only entry points that every slice of the port has, so that
``--root DIR`` can import ``graphdot_tpu_torch`` from another checkout
(an older tree unpacked beside this one) and time it the same way. Run
the two trees in turns on the same card (A, B, B, A) and compare only
within that run. Prints a JSON line of the numbers last. Usage:

    python3 boundary_timing.py [--root DIR]
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

#: (seed, graphs, atoms range) of each set
SETS = {'n56': (7, 32, (48, 56)), 'n64': (7, 32, (56, 64))}
#: timed builds of each Gram
REPEATS = 5


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--root', default=str(Path(__file__).parent),
                        help='checkout whose graphdot_tpu_torch is timed')
    opts = parser.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('boundary_timing: torch finds no CUDA device', file=sys.stderr)
        return 2
    import graphdot_tpu_torch
    from graphdot_tpu_torch.kernel import (
        MarginalizedGraphKernel, Normalization)
    from graphdot_tpu_torch.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu_torch.ops import pcg
    from graphdot_tpu_torch.testing import random_molecule_set
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f'{card}; package {Path(graphdot_tpu_torch.__file__).parent}',
          flush=True)
    counters = ('pcg_resident', 'pcg_packed', 'pcg_stream')
    kernel = MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)), q=0.05, device='cuda')
    gram = Normalization(kernel)
    out = {}
    for name, (seed, count, atoms) in SETS.items():
        graphs = random_molecule_set(seed, count, n_atoms_range=atoms)
        for grad in (False, True):
            what = f'{name} {"gradient" if grad else "value"}'
            t0 = time.perf_counter()
            for c in counters:
                getattr(pcg, c).launches = 0
            gram(graphs, eval_gradient=grad)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            launches = {c: getattr(pcg, c).launches for c in counters}
            walls = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                gram(graphs, eval_gradient=grad)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                gram(graphs, eval_gradient=grad)
                torch.cuda.synchronize()
            device, spans = {}, {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    # the solver's ranges also appear as device spans
                    into = spans if e.name.startswith('mlgk_') else device
                    kname = e.name[:100]
                    into[kname] = into.get(kname, 0.0) + \
                        e.time_range.elapsed_us() / 1e3
            pcg_ms = {k: v for k, v in device.items() if 'pcg_' in k}
            rec = {'launches': launches, 'first_s': first,
                   'wall_ms_median': float(np.median(walls)),
                   'wall_ms': walls, 'device_ms': sum(device.values()),
                   'pcg_device_ms': sum(pcg_ms.values()),
                   'pcg_kernels_ms': pcg_ms, 'range_spans_ms': spans}
            out[what] = rec
            print(f'{what}: launches {launches}; wall median '
                  f'{rec["wall_ms_median"]:.3f} ms over {REPEATS} '
                  f'({", ".join(f"{w:.3f}" for w in walls)}); first '
                  f'{first:.3f} s; profiled device {rec["device_ms"]:.3f} '
                  f'ms, in PCG kernels {rec["pcg_device_ms"]:.3f} ms; '
                  'range spans ' + ', '.join(
                      f'{k} {v:.3f}' for k, v in spans.items()), flush=True)
            top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
            for kname, ms in top:
                print(f'    device {ms:9.3f} ms  {kname}', flush=True)
    print(json.dumps({'card': card, 'root': opts.root, 'sets': out}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
