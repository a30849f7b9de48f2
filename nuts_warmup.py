#!/usr/bin/env python3
"""Mean acceptance of ``bench_nuts.py``'s resumed NUTS run after warmups
of several lengths, on one NVIDIA GPU.

Builds the log posterior of ``chip_smoke.py`` phase 17 (``GPRLogProb`` over
the 32 molecules of ``tests/fixtures/torch_port_nuts_ref.npz``'s
``bench_set``, the Tang-style kernel on the card), then for each
``WARMUP:SEED`` runs ``inference.sample`` with 8 chains, ``max_depth`` 6
and jitter 0.05: a warmup of WARMUP transitions from ``torch.Generator``
seed SEED, then a resumed run of 40 draws at the adapted step size and
mass. Prints the card, then a JSON line a run: the step size, the inverse
mass, the walls of both parts, and the mean ``accept_prob`` of the
resumed run over all chains and a chain. The same WARMUP:SEED twice shows
whether the card's runs repeat. Usage:

    python3 nuts_warmup.py [WARMUP:SEED ...]   # default 50:0 50:0 100:0 100:1
"""
import json
import sys
import time

import numpy as np


def main(runs):
    import torch
    if not torch.cuda.is_available():
        print('nuts_warmup: torch finds no CUDA device', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from graphdot_tpu_torch.inference import (
        GPRLogProb, resume_state, sample)
    from graphdot_tpu_torch.kernel import MarginalizedGraphKernel
    from graphdot_tpu_torch.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu_torch.ops import _build
    from graphdot_tpu_torch.testing import random_molecule_set

    _build.build(*_build.KERNELS)
    ref = np.load(cs.NUTS_FIXTURE)
    seed, count, lo, hi = (int(v) for v in ref['bench_set'])
    graphs = random_molecule_set(seed, count, n_atoms_range=(lo, hi))
    lp = GPRLogProb(MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)), q=0.05,
        device='cuda'),
        graphs, cs.gp_targets(graphs), alpha=float(ref['bench_alpha']),
        normalize_y=True)
    print(cs.nvidia_smi(), flush=True)
    for warmup, gseed in runs:
        gen = torch.Generator().manual_seed(gseed)
        t0 = time.perf_counter()
        out = sample(lp, gen, n_chains=cs.NUTS_CHAINS, n_warmup=warmup,
                     n_samples=2, init=lp.theta0,
                     max_depth=cs.NUTS_MAX_DEPTH,
                     init_jitter=cs.NUTS_JITTER, device='cuda')
        t_warm = time.perf_counter() - t0
        init2, step, inv_mass = resume_state(out)
        t0 = time.perf_counter()
        out2 = sample(lp, gen, n_chains=cs.NUTS_CHAINS,
                      n_samples=cs.NUTS_DRAWS, init=init2, step_size=step,
                      inv_mass=inv_mass, max_depth=cs.NUTS_MAX_DEPTH,
                      device='cuda')
        t_draws = time.perf_counter() - t0
        acc = out2['accept_prob'].cpu().numpy()
        print(json.dumps(dict(
            warmup=warmup, seed=gseed, step_size=step,
            inv_mass=np.asarray(inv_mass).tolist(), warmup_s=t_warm,
            draws_s=t_draws, accept=float(acc.mean()),
            accept_chain=acc.mean(axis=1).tolist(),
            warm_accept=float(out['accept_prob'].mean()))), flush=True)
    return 0


if __name__ == '__main__':
    args = sys.argv[1:] or ['50:0', '50:0', '100:0', '100:1']
    sys.exit(main([tuple(int(v) for v in a.split(':')) for a in args]))
