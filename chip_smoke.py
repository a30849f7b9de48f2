#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``graphdot_tpu_torch``) on one NVIDIA GPU.

Drives the port's two paths once each through their public entry point,
``Normalization(MarginalizedGraphKernel(..., device='cuda'))(graphs)``:

- the molecule slice, the cosine-normalized Gram over the 128 molecule
  graphs that ``bench.py`` uses (8256 graph pairs, Tang2019-style kernel,
  q = 0.05), whose pairs fit a block's shared memory and run in the CUDA
  kernel ``pcg_resident``;
- the protein slice, the normalized Gram over the 6 categorical-edge
  contact-map proteins of ``bench_protein.py`` (180-280 residues, 21 pairs
  padded to n = 272 nodes and m = 3736 edges), whose pairs do not fit and
  run in the CUDA kernel ``pcg_stream``;

and checks every part of them:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of both kernels from ``graphdot_tpu_torch/csrc``, one ``nvcc``
   a source, started together;
3. ``pcg_resident`` against its plain PyTorch twin on the systems of the
   first 512 molecule pairs, on the card: max |dx| <= 1e-5 * max |x|;
4. the normalized molecule Gram with ``backend='cuda'``: finite,
   symmetric, unit diagonal; ``pcg_resident`` launched once per job chunk
   and ``pcg_stream`` never; within 1e-6 of the same Gram with
   ``backend='edge'`` and of the JAX package's reference Gram stored in
   ``tests/fixtures/torch_port_gram_ref.npz``;
5. timings with CUDA events: ``pcg_resident`` and its twin at the molecule
   chunk shape, and the wall time of a whole molecule Gram build;
6. ``pcg_stream``'s build, and the kernel against its twin on the systems
   of the first protein chunk, and against ``pcg_resident`` on the first
   512 molecule pairs: max |dx| <= 1e-5 * max |x| for both;
7. the normalized protein Gram with ``backend='cuda'``: finite, symmetric,
   unit diagonal; ``pcg_stream`` launched once per chunk and
   ``pcg_resident`` never; within 1e-5 of ``backend='edge'`` on the card
   (float32 sums over 7.4e4 product nodes run in other orders there than
   over the molecules' 576, hence 1e-5 and not 1e-6);
8. the boundary: the Gram over the small protein set of the JAX fixture
   ``tests/fixtures/torch_port_protein_ref.npz`` (pairs of 5.2 MB of T)
   runs in ``pcg_stream`` and is within 1e-6 of the JAX Gram; 32 molecules
   of 48-72 atoms (n = 72, m = 192, over 227 KB a pair) run in
   ``pcg_stream`` and are within 1e-6 of ``backend='edge'``;
9. timings with CUDA events: ``pcg_stream`` and its twin on one protein
   chunk, ``pcg_stream`` and ``pcg_resident`` on one molecule chunk, the
   CG steps of both, and the protein Gram's wall time per build.

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
PROTEIN_FIXTURE = ROOT / 'tests' / 'fixtures' / 'torch_port_protein_ref.npz'
N_COMPARE = 512       # pairs in the kernel-vs-twin comparison
BUILD_REPEATS = 5     # timed molecule Gram builds
PROTEIN_REPEATS = 3   # timed protein Gram builds
#: the protein slice: protein_niche_set(seed, n, residue range)
PROTEINS = (13, 6, (180, 280))
TPU_KERNEL = 'graphdot_tpu/ops/pallas_pcg.py:300'          # _pcg_kernel
TPU_STREAM_KERNEL = 'graphdot_tpu/ops/pallas_pcg.py:567'   # _pcg_stream_kernel


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
        pcg_resident, pcg_resident_reference, pcg_stream,
        pcg_stream_reference)
    from graphdot_tpu_torch.testing import (
        protein_niche_set, random_molecule_set)

    say('== 1. device')
    card = nvidia_smi()
    say(card)
    say(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}, '
        f'{torch.cuda.device_count()} device(s)')

    def build_report(name):
        info = _build.build_info(name)
        say(f'  {name}: nvcc {info["seconds"]:.2f} s')
        for line in info['log'].splitlines():
            if 'registers' in line or 'bytes stack' in line or \
                    'Compiling entry' in line:
                say('    ' + line.strip())

    say('== 2. kernel build')
    t0 = time.perf_counter()
    _build.build('pcg_resident', 'pcg_stream')
    say(f'  both built and loaded in {time.perf_counter() - t0:.2f} s')
    build_report('pcg_resident')

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

    def systems(n, kern=kernel, bdict=bd, iters=maxiter, jobs=None):
        """The solver's operands for the first n jobs of ``jobs``."""
        i_all, j_all = (i_jobs, j_jobs) if jobs is None else jobs
        idx1 = torch.as_tensor(i_all[:n], device='cuda')
        idx2 = torch.as_tensor(j_all[:n], device='cuda')
        s = mlgk_setup(kern._theta_vector(),
                       kern._operands(bdict, bdict, idx1, idx2),
                       knode=kern.node_kernel, kedge=kern.edge_kernel,
                       n_p_theta=1, mode='cuda')
        return (s['T'], s['esrc_1'], s['edst_1'], s['esrc_2'],
                s['edst_2'], s['diag'].contiguous(),
                s['precond'].contiguous(), s['b'].contiguous(), s['tol'],
                iters)

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

    say('== 4. the molecule slice: normalized 128-molecule Gram, '
        'backend=cuda')
    n_chunks = math.ceil(n_pairs / chunk)
    pcg_resident.launches = pcg_stream.launches = 0
    t0 = time.perf_counter()
    K = Normalization(kernel)(graphs)
    first_build_s = time.perf_counter() - t0
    launches = pcg_resident.launches
    check(pcg_stream.launches == 0, 'pcg_stream launched 0 times')
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

    say('== 6. pcg_stream: build and twin checks')
    build_report('pcg_stream')

    def protein_kernel(backend='auto'):
        return MarginalizedGraphKernel(
            TensorProduct(element=KroneckerDelta(0.2)),
            TensorProduct(length=SquareExponential(3.0),
                          ctype=KroneckerDelta(0.3)),
            q=0.05, device='cuda', backend=backend)

    proteins = protein_niche_set(*PROTEINS)
    pkernel = protein_kernel()
    pbatch, pbd, _ = pkernel._prepare_batch(proteins)
    pn_pad, pm_pad = pbatch.node_mask.shape[1], pbatch.esrc.shape[1]
    p_pairs = len(proteins) * (len(proteins) + 1) // 2
    p_chunk = min(pkernel._chunk_size(pn_pad, pm_pad), p_pairs)
    p_jobs = np.triu_indices(len(proteins))
    p_args = systems(p_chunk, pkernel, pbd, pkernel.maxiter(pn_pad), p_jobs)
    say(f'  proteins: {p_pairs} pairs, n_pad {pn_pad}, m_pad {pm_pad}, '
        f'chunk {p_chunk}, T {tuple(p_args[0].shape)} '
        f'({p_args[0].numel() * 4 / 1e6:.1f} MB)')
    check(pkernel.backend.mode == 'cuda', "backend 'auto' resolves to cuda")
    x_s, it_s = pcg_stream(*p_args)
    x_r, it_r = pcg_stream_reference(*p_args)
    torch.cuda.synchronize()
    stream_err = float((x_s - x_r).abs().max())
    scale = float(x_r.abs().max())
    say(f'  first protein chunk: CG steps kernel {it_s.tolist()}, twin '
        f'{it_r.tolist()}')
    check(bool(torch.isfinite(x_s).all()), 'pcg_stream x is finite')
    check(stream_err <= 1e-5 * scale,
          f'max |x_stream - x_twin| = {stream_err:.3e} <= 1e-5 * max |x| = '
          f'{1e-5 * scale:.3e}')
    del x_s, x_r
    args = systems(N_COMPARE)
    x_s, _ = pcg_stream(*args)
    x_k, _ = pcg_resident(*args)
    torch.cuda.synchronize()
    err = float((x_s - x_k).abs().max())
    scale = float(x_k.abs().max())
    check(err <= 1e-5 * scale,
          f'{N_COMPARE} molecule pairs: max |x_stream - x_resident| = '
          f'{err:.3e} <= 1e-5 * max |x| = {1e-5 * scale:.3e}')

    say('== 7. the protein slice: normalized Gram, backend=cuda')
    p_chunks = math.ceil(p_pairs / p_chunk)
    pcg_resident.launches = pcg_stream.launches = 0
    t0 = time.perf_counter()
    KP = Normalization(pkernel)(proteins)
    say(f'  first build {time.perf_counter() - t0:.4f} s')
    stream_launches = pcg_stream.launches
    check(stream_launches == p_chunks,
          f'pcg_stream launched {stream_launches} times = {p_chunks} chunks')
    check(pcg_resident.launches == 0, 'pcg_resident launched 0 times')
    check(KP.shape == (len(proteins),) * 2 and bool(np.isfinite(KP).all()),
          f'K is a finite {len(proteins)}x{len(proteins)} matrix')
    sym_err = float(np.abs(KP - KP.T).max())
    check(sym_err <= 1e-12, f'K is symmetric (max |K - K^T| = '
          f'{sym_err:.1e})')
    diag_err = float(np.abs(np.diag(KP) - 1).max())
    check(diag_err <= 1e-12, f'unit diagonal (max |K_ii - 1| = '
          f'{diag_err:.1e})')
    t0 = time.perf_counter()
    KP_edge = Normalization(protein_kernel('edge'))(proteins)
    edge_s = time.perf_counter() - t0
    p_edge_err = float(np.abs(KP - KP_edge).max())
    check(p_edge_err <= 1e-5, f'max |K_cuda - K_edge| = {p_edge_err:.3e} '
          f'<= 1e-5 (edge build {edge_s:.3f} s)')

    say('== 8. the boundary')
    pref = np.load(PROTEIN_FIXTURE)
    small = protein_niche_set(int(pref['seed']), int(pref['n_graphs']),
                              tuple(pref['residues']))
    skernel = hyperparameters_from_numpy(protein_kernel(), pref['theta'])
    pcg_resident.launches = pcg_stream.launches = 0
    KS = Normalization(skernel)(small)
    check(pcg_stream.launches >= 1 and pcg_resident.launches == 0,
          f'small proteins: pcg_stream launched {pcg_stream.launches} '
          'times, pcg_resident 0')
    fix_err = float(np.abs(KS - pref['K']).max())
    check(fix_err <= 1e-6, f'max |K - K_jax| over the fixture\'s '
          f'{len(small)} proteins = {fix_err:.3e} <= 1e-6')
    big = random_molecule_set(7, 32, n_atoms_range=(48, 72))
    pcg_resident.launches = pcg_stream.launches = 0
    KB = Normalization(make_kernel())(big)
    check(pcg_stream.launches >= 1 and pcg_resident.launches == 0,
          f'48-72-atom molecules: pcg_stream launched '
          f'{pcg_stream.launches} times, pcg_resident 0')
    big_err = float(np.abs(KB - Normalization(make_kernel('edge'))(big))
                    .max())
    check(big_err <= 1e-6, f'max |K_cuda - K_edge| over 32 molecules of '
          f'48-72 atoms = {big_err:.3e} <= 1e-6')

    say('== 9. timing')
    _, p_steps = pcg_stream(*p_args)
    stream_ms = cuda_ms(lambda: pcg_stream(*p_args), reps=3)
    stream_plain_ms = cuda_ms(lambda: pcg_stream_reference(*p_args), reps=2)
    say(f'  one protein chunk of {p_chunk} pairs (CG steps mean '
        f'{float(p_steps.float().mean()):.3f}, max {int(p_steps.max())}): '
        f'pcg_stream {stream_ms:.4f} ms, plain twin {stream_plain_ms:.4f} ms')
    args = systems(chunk)
    _, m_steps = pcg_stream(*args)
    mol_stream_ms = cuda_ms(lambda: pcg_stream(*args), reps=10)
    mol_resident_ms = cuda_ms(lambda: pcg_resident(*args), reps=10)
    say(f'  one molecule chunk of {chunk} pairs (CG steps mean '
        f'{float(m_steps.float().mean()):.3f}, max {int(m_steps.max())}): '
        f'pcg_stream {mol_stream_ms:.4f} ms, pcg_resident '
        f'{mol_resident_ms:.4f} ms')
    walls = []
    for _ in range(PROTEIN_REPEATS):
        t0 = time.perf_counter()
        Normalization(pkernel)(proteins)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    say(f'  normalized protein Gram build: median {wall * 1e3:.3f} ms over '
        f'{PROTEIN_REPEATS} ({", ".join(f"{w * 1e3:.3f}" for w in walls)});'
        f' {p_pairs / wall:.2f} pairs/s at the median')

    say(json.dumps({'kernels': [{
        'name': 'pcg_resident', 'route': 'cuda',
        'source': 'graphdot_tpu_torch/csrc/pcg_resident.cu',
        'replaces': TPU_KERNEL, 'launches': launches,
        'max_abs_err': max_abs_err, 'ms': kernel_ms, 'plain_ms': plain_ms,
    }, {
        'name': 'pcg_stream', 'route': 'cuda',
        'source': 'graphdot_tpu_torch/csrc/pcg_stream.cu',
        'replaces': TPU_STREAM_KERNEL, 'launches': stream_launches,
        'max_abs_err': stream_err, 'ms': stream_ms,
        'plain_ms': stream_plain_ms,
    }]}))
    say(nvidia_smi())
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
