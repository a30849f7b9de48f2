"""Run one cell of ``BENCHMARK.json`` once, on the card:

    python3 h100_bench/run.py --workload qm7-gram --seed 7 --seconds 30 \\
        --trace 0

Prints the result as the last line of standard output, and the numbers
that decided ``correct``, each beside its limit, as the last lines of
standard error. Exits with another code than 0, and prints no result, when
there is no CUDA card or fewer than the cell asks for, when the program
cannot be imported, or when the run has loaded JAX or the JAX package.

The program's kernel builds (``build/graphdot_tpu_torch/`` for nvcc) and
any Triton cache stay in fixed directories inside the checkout, so only
the first run of a checkout builds.
"""
import time

T_PROCESS = time.perf_counter()

import argparse   # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    os.environ.setdefault('TRITON_CACHE_DIR', str(ROOT / 'build' / 'triton'))
    os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                          str(ROOT / 'build' / 'torch_extensions'))
    sys.path.insert(0, str(ROOT))
    import torch
    from h100_bench import harness

    manifest = harness.load_manifest()
    cell = harness.workload(manifest, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell['chips']:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'{args.workload} needs {cell["chips"]} CUDA card(s); found '
              f'{found}', file=sys.stderr)
        return 2
    result = harness.run_cell(manifest, args.workload, args.seed,
                              args.seconds, args.trace, device='cuda',
                              t_process=T_PROCESS)
    harness.report(result)
    return 0


if __name__ == '__main__':
    sys.exit(main())
