"""The control of ``correct``: the reference put in the program's place,
computed in the precision below the configuration's (bfloat16 for its
float32 solves), checked as a run is. Its numbers have to exceed their
limits; they are the upper readings the limits are set below.

    python3 h100_bench/control.py --workload qm7-gram --requests 15 \\
        --seeds 11 12 13

prints, for each seed, one JSON line of the compared numbers and whether
the control came out correct (it must not). It makes the cell's inputs
from the seed as a run does, draws the same requests, and computes only the
answers that the check reads; the benchmark's own runs never run it.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def control(manifest, cell_name, seed, requests, device, dtype=None,
            traffic_overrides=None):
    """The checks of the control on ``requests`` requests of a cell."""
    from h100_bench import cells, harness
    from h100_bench.reference import Reference
    cell = harness.workload(manifest, cell_name)
    config = harness.config_of(manifest, cell['config'])
    traffic = dict(harness.traffic_of(cell['traffic']),
                   **(traffic_overrides or {}))
    kind = cells.KINDS[traffic['kind']](config, traffic, seed, device)
    kind.make_data()
    low = Reference(config, device, dtype or torch.bfloat16)
    records = [kind.control_record(low, k) for k in range(requests)]
    checks = kind.check(records, Reference(config, device))
    return {'seed': seed, 'correct': all(
        c['value'] <= c['limit'] for c in checks.values()),
        'checks': checks}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--requests', type=int, required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100_bench import harness
    if not torch.cuda.is_available():
        print('the control runs on the card', file=sys.stderr)
        return 2
    manifest = harness.load_manifest()
    for seed in args.seeds:
        print(json.dumps(control(manifest, args.workload, seed,
                                 args.requests, 'cuda')), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
