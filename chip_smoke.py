#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``graphdot_tpu_torch``) on one NVIDIA GPU.

Drives the port's main path once through its public entry point, the
cosine-normalized Gram over the 128 molecule graphs that ``bench.py`` uses
(8256 graph pairs, Tang2019-style kernel, q = 0.05), with the CUDA
resident-PCG kernel, and checks every part of it:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the kernel build from ``graphdot_tpu_torch/csrc`` with ``nvcc``;
3. the kernel against its plain PyTorch twin on the systems of the first
   512 pairs, on the card: max |dx| <= 1e-5 * max |x|;
4. the normalized Gram with ``backend='cuda'``: finite, symmetric, unit
   diagonal; the kernel launched once per job chunk; within 1e-6 of the
   same Gram with ``backend='edge'`` and of the JAX package's reference
   Gram stored in ``tests/fixtures/torch_port_gram_ref.npz``;
5. timings with CUDA events: the kernel and its twin at the slice's chunk
   shape, and the wall time of a whole Gram build.

Prints the kernel summary as one JSON line, then the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, when a phase fails or there is no CUDA
device. Usage: ``python3 chip_smoke.py`` from the root of the checkout.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / 'tests' / 'fixtures' / 'torch_port_gram_ref.npz'
N_COMPARE = 512       # pairs in the kernel-vs-twin comparison
BUILD_REPEATS = 5     # timed Gram builds
TPU_KERNEL = 'graphdot_tpu/ops/pallas_pcg.py:300'   # _pcg_kernel


def say(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f'check failed: {what}')
    say(f'  ok: {what}')


def nvidia_smi():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch finds no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from graphdot_tpu_torch.convert import hyperparameters_from_numpy
    from graphdot_tpu_torch.kernel import (
        MarginalizedGraphKernel, Normalization)
    from graphdot_tpu_torch.kernel.marginalized._solver import mlgk_setup
    from graphdot_tpu_torch.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu_torch.ops import _build
    from graphdot_tpu_torch.ops.pcg import (
        pcg_resident, pcg_resident_reference)
    from graphdot_tpu_torch.testing import random_molecule_set

    say('== 1. device')
    card = nvidia_smi()
    say(card)
    say(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}, '
        f'{torch.cuda.device_count()} device(s)')

    say('== 2. kernel build')
    t0 = time.perf_counter()
    _build.load('pcg_resident')
    info = _build.build_info('pcg_resident')
    say(f'  nvcc: {info["seconds"]:.2f} s, load: '
        f'{time.perf_counter() - t0:.2f} s')
    for line in info['log'].splitlines():
        if 'registers' in line or 'bytes stack' in line or 'spill' in line:
            say('  ' + line.strip())

    ref = np.load(FIXTURE)
    graphs = random_molecule_set(int(ref['seed']), int(ref['n_graphs']),
                                 n_atoms_range=(9, 24))
    n_graphs = len(graphs)
    n_pairs = n_graphs * (n_graphs + 1) // 2

    def make_kernel(backend='auto'):
        kernel = MarginalizedGraphKernel(
            TensorProduct(element=KroneckerDelta(0.2)),
            TensorProduct(length=SquareExponential(0.3)),
            q=0.05, device='cuda', backend=backend)
        return hyperparameters_from_numpy(kernel, ref['theta'])

    kernel = make_kernel()
    check(kernel.backend.mode == 'cuda', "backend 'auto' resolves to cuda")

    say('== 3. kernel against its plain twin')
    batch, bd, _ = kernel._prepare_batch(graphs)
    n_pad, m_pad = batch.node_mask.shape[1], batch.esrc.shape[1]
    maxiter = kernel.maxiter(n_pad)
    chunk = kernel._chunk_size(n_pad, m_pad)
    i_jobs, j_jobs = np.triu_indices(n_graphs)

    def systems(n):
        idx1 = torch.as_tensor(i_jobs[:n], device='cuda')
        idx2 = torch.as_tensor(j_jobs[:n], device='cuda')
        s = mlgk_setup(kernel._theta_vector(),
                       kernel._operands(bd, bd, idx1, idx2),
                       knode=kernel.node_kernel, kedge=kernel.edge_kernel,
                       n_p_theta=1, mode='cuda')
        return (s['T'], s['esrc_1'], s['edst_1'], s['esrc_2'],
                s['edst_2'], s['diag'].contiguous(),
                s['precond'].contiguous(), s['b'].contiguous(), s['tol'],
                maxiter)

    args = systems(N_COMPARE)
    x_k, it_k = pcg_resident(*args)
    x_r, it_r = pcg_resident_reference(*args)
    torch.cuda.synchronize()
    max_abs_err = float((x_k - x_r).abs().max())
    scale = float(x_r.abs().max())
    say(f'  {N_COMPARE} pairs, T {tuple(args[0].shape)}, x '
        f'{tuple(x_k.shape)}; CG steps kernel mean '
        f'{float(it_k.float().mean()):.2f} max {int(it_k.max())}, twin '
        f'mean {float(it_r.float().mean()):.2f} max {int(it_r.max())}')
    check(bool(torch.isfinite(x_k).all()), 'kernel x is finite')
    check(max_abs_err <= 1e-5 * scale,
          f'max |x_kernel - x_twin| = {max_abs_err:.3e} <= 1e-5 * '
          f'max |x| = {1e-5 * scale:.3e}')

    say('== 4. the slice: normalized 128-molecule Gram, backend=cuda')
    n_chunks = math.ceil(n_pairs / chunk)
    pcg_resident.launches = 0
    t0 = time.perf_counter()
    K = Normalization(kernel)(graphs)
    first_build_s = time.perf_counter() - t0
    launches = pcg_resident.launches
    say(f'  first build {first_build_s:.4f} s, {n_pairs} pairs, n_pad '
        f'{n_pad}, m_pad {m_pad}, chunk {chunk}')
    check(K.shape == (n_graphs, n_graphs), f'K is {n_graphs}x{n_graphs}')
    check(bool(np.isfinite(K).all()), 'K is finite')
    sym_err = float(np.abs(K - K.T).max())
    check(sym_err <= 1e-12, f'K is symmetric (max |K - K^T| = '
          f'{sym_err:.1e})')
    diag_err = float(np.abs(np.diag(K) - 1).max())
    check(diag_err <= 1e-12, f'unit diagonal (max |K_ii - 1| = '
          f'{diag_err:.1e})')
    check(launches == n_chunks,
          f'pcg_resident launched {launches} times = {n_chunks} chunks')
    K_edge = Normalization(make_kernel('edge'))(graphs)
    edge_err = float(np.abs(K - K_edge).max())
    check(edge_err <= 1e-6, f'max |K_cuda - K_edge| = {edge_err:.3e} '
          '<= 1e-6')
    n_ref = int(ref['n_first'])
    ref_err = float(np.abs(K[:n_ref, :n_ref] - ref['K']).max())
    check(ref_err <= 1e-6, f'max |K - K_jax| over the first {n_ref} graphs '
          f'= {ref_err:.3e} <= 1e-6')

    say('== 5. timing')
    args = systems(chunk)
    _, steps = pcg_resident(*args)
    kernel_ms = cuda_ms(lambda: pcg_resident(*args), reps=20)
    plain_ms = cuda_ms(lambda: pcg_resident_reference(*args), reps=5)
    say(f'  one chunk of {chunk} pairs (CG steps mean '
        f'{float(steps.float().mean()):.3f}, max {int(steps.max())}): '
        f'kernel {kernel_ms:.4f} ms, plain twin {plain_ms:.4f} ms')
    walls = []
    for _ in range(BUILD_REPEATS):
        t0 = time.perf_counter()
        Normalization(kernel)(graphs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    say(f'  normalized Gram build: median {wall * 1e3:.3f} ms, min '
        f'{min(walls) * 1e3:.3f} ms over {BUILD_REPEATS}; '
        f'{n_pairs / wall:.1f} pairs/s at the median')

    say(json.dumps({'kernels': [{
        'name': 'pcg_resident', 'route': 'cuda',
        'source': 'graphdot_tpu_torch/csrc/pcg_resident.cu',
        'replaces': TPU_KERNEL, 'launches': launches,
        'max_abs_err': max_abs_err, 'ms': kernel_ms, 'plain_ms': plain_ms,
    }]}))
    say(nvidia_smi())
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
