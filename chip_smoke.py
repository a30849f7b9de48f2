#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``graphdot_tpu_torch``) on one NVIDIA GPU.

Drives the port's paths once each through their public entry point,
``Normalization(MarginalizedGraphKernel(..., device='cuda'))(graphs)``:

- the molecule slice, the cosine-normalized Gram over the 128 molecule
  graphs that ``bench.py`` uses (8256 graph pairs, Tang2019-style kernel,
  q = 0.05), whose pairs fit a block's shared memory and run in the CUDA
  kernel ``pcg_resident``;
- the protein slice, the normalized Gram over the 6 categorical-edge
  contact-map proteins of ``bench_protein.py`` (180-280 residues, 21 pairs
  padded to n = 272 nodes and m = 3736 edges), whose pairs do not fit and
  run in the CUDA kernel ``pcg_stream``;
- the gradient slice, the same molecule Gram with ``eval_gradient=True``
  (d K / d theta for p, q, h and the length scale), whose tangent systems
  run in the CUDA kernel ``pcg_packed``, the 4 tangents of a pair as one
  group; and the gradient of 48-72-atom molecules, whose tangents run in
  ``pcg_stream``;

and checks every part of them:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of the three kernels from ``graphdot_tpu_torch/csrc``, one
   ``nvcc`` a source, started together;
3. ``pcg_resident`` against its plain PyTorch twin on the systems of the
   first 512 molecule pairs, on the card: max |dx| <= 1e-5 * max |x|; and,
   for the TPU timing prototype ``scripts/proto_pallas.py`` that it
   covers, at the prototype's shape (2080 pairs, M = 64, N = 24) and fixed
   16 steps (tol = 0) against the twin at the same step count;
4. the normalized molecule Gram with ``backend='cuda'``: finite,
   symmetric, unit diagonal; ``pcg_resident`` launched once per job chunk
   and ``pcg_stream`` never; within 1e-6 of the same Gram with
   ``backend='edge'`` and of the JAX package's reference Gram stored in
   ``tests/fixtures/torch_port_gram_ref.npz``;
5. timings: ``pcg_resident`` and its twin at the molecule chunk shape,
   the wrapper call by CUDA events beside the kernel's own device time
   (``torch.profiler`` over the same calls), with the chunk's live-edge
   and live-node means and the kernel's occupancy; and the wall time of a
   whole molecule Gram build;
6. ``pcg_stream``'s build, and the kernel against its twin on the systems
   of the first protein chunk and on a lone protein pair, each pair split
   over the default C CTAs (``stream_ctas_per_pair``) and over one, two
   runs at the default C bitwise equal, and against ``pcg_resident`` on
   the first 512 molecule pairs: max |dx| <= 1e-5 * max |x| for all;
7. the normalized protein Gram with ``backend='cuda'``: finite, symmetric,
   unit diagonal; ``pcg_stream`` launched once per chunk and
   ``pcg_resident`` never; within 1e-5 of ``backend='edge'`` on the card
   (float32 sums over 7.4e4 product nodes run in other orders there than
   over the molecules' 576, hence 1e-5 and not 1e-6);
8. the boundary: the Gram over the small protein set of the JAX fixture
   ``tests/fixtures/torch_port_protein_ref.npz`` (pairs of 5.2 MB of T)
   runs in ``pcg_stream`` and is within 1e-6 of the JAX Gram; 32 molecules
   of 48-72 atoms (n = 72, m = 192, over 227 KB a pair) run in
   ``pcg_stream`` and are within 1e-6 of ``backend='edge'``; 32 molecules
   of 48-55 atoms (n = 56, the most product nodes a block of
   ``pcg_resident`` holds) run in ``pcg_resident``, and 32 of 56-63 atoms
   (n = 64) in ``pcg_stream``, both within 1e-6 of ``backend='edge'``;
9. timings with CUDA events, in turns (C = 1, default, default, C = 1):
   ``pcg_stream`` on one protein chunk and on a lone protein pair, beside
   the twin on both; ``pcg_stream`` and ``pcg_resident`` on one molecule
   chunk, the CG steps of both; the protein Gram's wall time per build,
   and one profiled protein build (``torch.profiler``);
10. ``pcg_packed`` against its twin: (a) the tangent groups (k = 4, one
    shared operator) of the first 512 molecule pairs, (b) ``group_pairs(2)``
    over the same pairs (the TPU's layout) against the twin and against
    ``pcg_resident``, max |dx| <= 1e-5 * max |x| for both; (c) a group
    beyond a block's shared memory raises;
11. the gradient slice: K and dK [128, 128, 4] finite, K within 1e-6 of
    phase 4's Gram, dK symmetric, its p column <= 1e-5 (p cancels in a
    normalized kernel); ``pcg_packed`` launched once per job chunk and
    ``pcg_stream`` never; dK within 1e-3 * max |dK| + 1e-5 of
    ``backend='edge'``; K and dK over the first 8 graphs within 1e-6 and
    1e-3 * max |dK| + 1e-5 of the JAX package's reference in
    ``tests/fixtures/torch_port_grad_ref.npz``; central differences in
    log theta (step 1e-3) within rtol 0.05, atol 0.05;
12. the gradient of the 32 molecules of 48-72 atoms: tangents in
    ``pcg_stream``, ``pcg_packed`` never; of the 48-55-atom ones: value
    and tangents (one a CTA) in ``pcg_resident`` only; dK within phase
    11's tolerance of ``edge`` for both;
13. timings: ``pcg_packed`` and its twin on one gradient chunk's tangent
    groups, by CUDA events and by device time, with live means and
    occupancy; ``pcg_packed`` on pair groups
    (k = 2 and 4)
    against ``pcg_resident`` on one 4096-pair chunk, with the CG steps of
    groups and of pairs; the gradient Gram's wall time beside the value
    Gram's (medians of 5, in turns); one profiled gradient build
    (``torch.profiler``): device busy share, device time by kernel, host
    time in the solver's phases.

Prints the kernel summary as one JSON line (each kernel's wrapper time
and device time beside its bound: the larger of the bytes of its inputs
and outputs over 3.35 TB/s
and the float32 operations of the CG steps it ran, over the live edges,
over 67 TFLOP/s), then the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, when a phase fails or there is no CUDA
device. Usage: ``python3 chip_smoke.py`` from the root of the checkout.
"""
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / 'tests' / 'fixtures' / 'torch_port_gram_ref.npz'
GRAD_FIXTURE = ROOT / 'tests' / 'fixtures' / 'torch_port_grad_ref.npz'
PROTEIN_FIXTURE = ROOT / 'tests' / 'fixtures' / 'torch_port_protein_ref.npz'
N_COMPARE = 512       # pairs in the kernel-vs-twin comparison
BUILD_REPEATS = 5     # timed molecule Gram builds
PROTEIN_REPEATS = 3   # timed protein Gram builds
#: the protein slice: protein_niche_set(seed, n, residue range)
PROTEINS = (13, 6, (180, 280))
TPU_KERNEL = 'graphdot_tpu/ops/pallas_pcg.py:300'          # _pcg_kernel
TPU_STREAM_KERNEL = 'graphdot_tpu/ops/pallas_pcg.py:567'   # _pcg_stream_kernel
TPU_PACK_KERNEL = 'graphdot_tpu/ops/pallas_pcg.py:310'     # _pcg_pack_kernel
TPU_PROTO_KERNEL = 'scripts/proto_pallas.py:89'            # pallas_solve
PROTO_PAIRS, PROTO_STEPS = 2080, 16   # scripts/proto_pallas.py's P, ITERS
GRAD_REPEATS = 5      # timed gradient Gram builds, in turns with value ones
#: NVIDIA H100 SXM peaks from its datasheet: HBM3 bytes/s and float32
#: operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: float32 operations of a CG step per element of a system, beside its
#: matvec: Ap, pAp, x, r, z, rz, r.r and p
CG_OPS_PER_ELEMENT = 15


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


def device_ms(fn, reps, match):
    """Mean device milliseconds a call of ``fn`` spends in the kernels
    whose name contains ``match``, from ``torch.profiler``'s
    ``key_averages()`` over ``reps`` calls after one warm-up call; None
    when the profiler records no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for avg in prof.key_averages():
        if match in avg.key:
            us += getattr(avg, 'device_time_total', 0.0) or \
                getattr(avg, 'cuda_time_total', 0.0)
    return us / reps / 1e3 if us else None


def live_report(args, members=1):
    """The live-edge and live-node means of a chunk's systems (the part of
    each system that pcg_resident and pcg_packed solve), as a dict and a
    line of text."""
    from graphdot_tpu_torch.ops.pcg import live_extent
    T, e1s, e1d, e2s, e2d, b = (args[0], *args[1:5], args[7])
    if T.dim() == 4:   # [S, ka, ...]: the first operator of each group
        T, e1s, e1d, e2s, e2d = (a[:, 0] for a in (T, e1s, e1d, e2s, e2d))
    L1, L2, n1, n2 = (v.double() for v in live_extent(
        T, e1s, e1d, e2s, e2d, b))
    live = {'live_edges_1': float(L1.mean()),
            'live_edges_2': float(L2.mean()),
            'live_nodes': float((n1 * n2).mean()),
            'padded_edges': T.shape[-2],
            'padded_nodes': b.shape[-2] * b.shape[-1]}
    return live, (f'live edges a side mean {live["live_edges_1"]:.2f} / '
                  f'{live["live_edges_2"]:.2f} of {T.shape[-2]}, live product '
                  f'nodes mean {live["live_nodes"]:.2f} of '
                  f'{live["padded_nodes"]}')


def time_call(call, reps, match):
    """The wrapper's call by CUDA events and its kernel's device time, in
    turns (events, device, events, device); returns {'ms': mean,
    'device_ms': mean, 'runs': [(ms, device_ms), ...]}."""
    runs = [(cuda_ms(call, reps), device_ms(call, reps, match))
            for _ in range(2)]
    devs = [d for _, d in runs if d is not None]
    return {'ms': float(np.mean([m for m, _ in runs])),
            'device_ms': float(np.mean(devs)) if devs else None,
            'runs': runs}


def step_split(wrapper, args, match, steps=(10, 20)):
    """Device milliseconds of the wrapper's kernel at maxiter 0 (its
    prologue: edge lists, live flags, CSR, T gathered, x written) and at a
    fixed number of CG steps (tol 0), and the cost of one more step."""
    import torch
    fixed = list(args[:9])
    fixed[8] = torch.zeros_like(fixed[8])
    at = {s: device_ms(lambda: wrapper(*fixed, s), 10, match)
          for s in (0, *steps)}
    return {'prologue_ms': at[0], 'steps': {s: at[s] for s in steps},
            'per_step_ms': (at[steps[1]] - at[steps[0]])
            / (steps[1] - steps[0])}


def live_edges(T):
    """(L1, L2): the edges of each operator of T [..., M1, M2] whose row,
    or column, of T holds a nonzero (the edges the solve needs)."""
    nz = T != 0
    return nz.any(dim=-1).sum(dim=-1), nz.any(dim=-2).sum(dim=-1)


def pcg_bound(args, x, steps):
    """The least time the card could take for one PCG call on these
    operands, ``(ms, 'bytes' or 'operations', stream floor ms)``. Bytes:
    every input read once, x and the step counts written once. Operations:
    for each system, the CG steps it ran times, per member, the live matvec
    (2 L1 L2) and CG_OPS_PER_ELEMENT a product-graph node. The stream
    floor adds what a solve whose T exceeds the L2 cache must read: the
    live part of T once per CG step, beside one read of the padded T."""
    import torch
    T = args[0]
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    nbytes += x.numel() * x.element_size() + steps.numel() * 4
    L1, L2 = (v.double() for v in live_edges(T))
    n = x.shape[-1] * x.shape[-2]
    per_step = 2 * L1 * L2 + CG_OPS_PER_ELEMENT * n
    live_T = 4 * L1 * L2
    if T.dim() == 4:   # pcg_packed: [S, ka, ...], k members a group
        members = x.shape[1] // T.shape[1]
        per_step = per_step.sum(dim=1) * members
        live_T = live_T.sum(dim=1)
    ops = float((per_step * steps.double()).sum())
    floor = T.numel() * 4 + float((live_T * steps.double()).sum())
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(by_bytes, by_ops), 'bytes' if by_bytes >= by_ops
            else 'operations', floor / HBM_BYTES_PER_S * 1e3)


def profile_build(build, what):
    """One profiled call of ``build`` (a Gram): wall time, device busy
    share, device time by kernel, host time in the solver's phases."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        build()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    device = {}
    host = {}
    for e in events:
        us = e.time_range.elapsed_us()
        if e.name.startswith('mlgk_'):
            # the solver's phase ranges: the host side only (the profiler
            # also marks each range's span of kernels on the device)
            if e.device_type == DeviceType.CPU:
                host[e.name] = host.get(e.name, 0.0) + us
        elif e.device_type == DeviceType.CUDA:
            device[e.name] = device.get(e.name, 0.0) + us
    busy = sum(device.values())
    say(f'  profiled {what} build: wall {wall_us / 1e3:.3f} ms, device '
        f'time {busy / 1e3:.3f} ms (busy share {busy / wall_us:.4f})')
    if not device:
        say('  the profiler recorded no device time: not measured')
    top = sorted(device.items(), key=lambda kv: -kv[1])[:8]
    for name, us in top:
        say(f'    device {us / 1e3:9.3f} ms  {name[:90]}')
    solves = sum(us for name, us in device.items() if 'pcg_' in name)
    say(f'    device time in the PCG kernels {solves / 1e3:.3f} ms, in all '
        f'other kernels {(busy - solves) / 1e3:.3f} ms')
    for name in ('mlgk_setup', 'mlgk_value_solve', 'mlgk_tangents',
                 'mlgk_tangent_solve'):
        say(f'    host {host.get(name, 0.0) / 1e3:9.3f} ms in {name}')


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
    from graphdot_tpu_torch.kernel.marginalized._solver import (
        mlgk_setup, mlgk_tangents)
    from graphdot_tpu_torch.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu_torch.ops import _build
    from graphdot_tpu_torch.ops.pcg import (
        group_pairs, kernel_occupancy, pcg_packed, pcg_packed_reference,
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
        """nvcc's time and, per kernel, ptxas's registers and spills, one
        line each (instances of the core: K members, NPT nodes a thread,
        shared operator or not)."""
        info = _build.build_info(name)
        say(f'  {name}: nvcc {info["seconds"]:.2f} s')
        entry = spill = None
        for line in info['log'].splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                entry = found.group(1)
                packed = re.search(
                    r'pcg_packed_kernelILi(\d+)ELi(\d+)ELb(\d)', entry)
                resident = re.search(r'pcg_resident_kernelILi(\d+)E', entry)
                if packed:
                    entry = 'pcg_packed_kernel<K={}, NPT={}, shared={}>' \
                        .format(*packed.groups())
                elif resident:
                    entry = 'pcg_resident_kernel<NPT={}>'.format(
                        *resident.groups())
            elif 'bytes stack frame' in line:
                spill = line.split(':', 1)[-1].strip()
            elif 'Used' in line and 'registers' in line and entry:
                used = line.split(':', 1)[-1].strip()
                say(f'    {entry[:60]}: {used}; {spill}')
                entry = spill = None

    say('== 2. kernel build')
    t0 = time.perf_counter()
    _build.build(*_build.KERNELS)
    say(f'  all three built and loaded in {time.perf_counter() - t0:.2f} s')
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
    proto = list(systems(PROTO_PAIRS, iters=PROTO_STEPS))
    proto[8] = torch.zeros_like(proto[8])          # tol = 0: fixed steps
    check(tuple(proto[0].shape[1:]) == (64, 64)
          and tuple(proto[5].shape[1:]) == (24, 24),
          f'{PROTO_PAIRS} pairs at the prototype\'s M = 64, N = 24')
    x_k, it_k = pcg_resident(*proto)
    x_r, it_r = pcg_resident_reference(*proto)
    torch.cuda.synchronize()
    proto_err = float((x_k - x_r).abs().max())
    scale = float(x_r.abs().max())
    check(bool((it_k == PROTO_STEPS).all() and (it_r == PROTO_STEPS).all()),
          f'kernel and twin both ran {PROTO_STEPS} steps on every pair')
    check(proto_err <= 1e-5 * scale,
          f'{TPU_PROTO_KERNEL} covered: max |x_kernel - x_twin| = '
          f'{proto_err:.3e} <= 1e-5 * max |x| = {1e-5 * scale:.3e}')

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
    x_k, steps = pcg_resident(*args)
    resident_bound = pcg_bound(args, x_k, steps)
    resident_live, text = live_report(args)
    say(f'  one chunk of {chunk} pairs: {text}')
    resident_occ = kernel_occupancy('pcg_resident', m_pad, m_pad, n_pad,
                                    n_pad)
    say(f'  pcg_resident occupancy at the chunk shape: {resident_occ}')
    resident_times = time_call(lambda: pcg_resident(*args), 20,
                               'pcg_resident_kernel')
    kernel_ms = resident_times['ms']
    resident_device_ms = resident_times['device_ms']
    plain_ms = cuda_ms(lambda: pcg_resident_reference(*args), reps=5)
    say(f'  one chunk of {chunk} pairs (CG steps mean '
        f'{float(steps.float().mean()):.3f}, max {int(steps.max())}): '
        f'kernel {kernel_ms:.4f} ms by events, device {resident_device_ms} '
        f'ms, plain twin {plain_ms:.4f} ms, bound '
        f'{resident_bound[0]:.4f} ms ({resident_bound[1]})')
    say(f'    in turns (events, device): {resident_times["runs"]}')
    resident_split = step_split(pcg_resident, args, 'pcg_resident_kernel')
    say(f'  device time by part: {resident_split}')
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
    lone = [a[:1] for a in p_args[:-1]] + [p_args[-1]]
    stream_err = 0.0
    for what, sys_args in (('protein chunk', p_args), ('lone pair', lone)):
        x_r, it_r = pcg_stream_reference(*sys_args)
        scale = float(x_r.abs().max())
        for ctas in (None, 1):
            x_s, it_s = pcg_stream(*sys_args, ctas_per_pair=ctas)
            torch.cuda.synchronize()
            used = pcg_stream.last_ctas_per_pair
            err = float((x_s - x_r).abs().max())
            if ctas is None:
                check(used > 1, f'{what}: the default spreads a pair over '
                      f'{used} CTAs')
                if sys_args is p_args:
                    stream_err = err
            say(f'  {what}, C = {used}: CG steps kernel {it_s.tolist()}, '
                f'twin {it_r.tolist()}')
            check(bool(torch.isfinite(x_s).all()) and err <= 1e-5 * scale,
                  f'{what}, C = {used}: x finite, max |x_stream - x_twin| = '
                  f'{err:.3e} <= 1e-5 * max |x| = {1e-5 * scale:.3e}')
    x_a, it_a = pcg_stream(*p_args)
    x_b, it_b = pcg_stream(*p_args)
    torch.cuda.synchronize()
    check(torch.equal(x_a, x_b) and torch.equal(it_a, it_b),
          f'two runs at C = {pcg_stream.last_ctas_per_pair} are bitwise '
          'equal')
    del x_s, x_r, x_a, x_b
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
    stream_ctas = pcg_stream.last_ctas_per_pair
    say(f'  pcg_stream ran {stream_ctas} CTAs a pair')
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
    large = {}
    for atoms, solver in (((48, 56), pcg_resident), ((56, 64), pcg_stream)):
        large[atoms] = random_molecule_set(7, 32, n_atoms_range=atoms)
        lbatch, _, _ = kernel._prepare_batch(large[atoms])
        ln = lbatch.node_mask.shape[1]
        pcg_resident.launches = pcg_stream.launches = 0
        KL = Normalization(make_kernel())(large[atoms])
        check(solver.launches >= 1 and pcg_resident.launches
              + pcg_stream.launches == solver.launches,
              f'{atoms[0]}-{atoms[1] - 1}-atom molecules (n = {ln}, m = '
              f'{lbatch.esrc.shape[1]}): {solver.__name__} launched '
              f'{solver.launches} times, the other 0')
        err = float(np.abs(KL - Normalization(make_kernel('edge'))(
            large[atoms])).max())
        check(err <= 1e-6, f'max |K_cuda - K_edge| = {err:.3e} <= 1e-6')

    say('== 9. timing')
    stream_times = {}
    for what, sys_args, reps in (('chunk', p_args, 3), ('lone', lone, 10)):
        for ctas in (1, None, None, 1):
            stream_times.setdefault((what, ctas), []).append(cuda_ms(
                lambda: pcg_stream(*sys_args, ctas_per_pair=ctas), reps))
        stream_times[what, 'plain'] = cuda_ms(
            lambda: pcg_stream_reference(*sys_args), reps=2)
        x_s, steps = pcg_stream(*sys_args)
        used = pcg_stream.last_ctas_per_pair   # the default C
        bound = pcg_bound(sys_args, x_s, steps)
        stream_times[what, 'bound'] = bound
        say(f'  {what} ({sys_args[0].shape[0]} pairs, CG steps '
            f'{steps.tolist()}): pcg_stream C = 1 '
            f'{stream_times[what, 1]} ms, C = {used} '
            f'{stream_times[what, None]} ms (in turns), plain twin '
            f'{stream_times[what, "plain"]:.4f} ms; bound {bound[0]:.4f} ms '
            f'({bound[1]}), T streamed once a step {bound[2]:.4f} ms')
    lone_ctas = used
    stream_ms = float(np.mean(stream_times['chunk', None]))
    stream_device_ms = device_ms(lambda: pcg_stream(*p_args), 3, 'stream')
    say(f'  chunk at C = {pcg_stream.last_ctas_per_pair}: device time of '
        f'the call\'s kernels {stream_device_ms} ms')
    stream_plain_ms = stream_times['chunk', 'plain']
    stream_bound = stream_times['chunk', 'bound']
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
    profile_build(lambda: Normalization(pkernel)(proteins), 'protein')

    say('== 10. pcg_packed against its twin')
    build_report('pcg_packed')

    def tangent_groups(n):
        """pcg_packed's operands for the tangent systems of the first n
        molecule pairs: one group a pair, its 4 tangents sharing the pair's
        operator, at the pair's value solution."""
        idx1 = torch.as_tensor(i_jobs[:n], device='cuda')
        idx2 = torch.as_tensor(j_jobs[:n], device='cuda')
        ops = kernel._operands(bd, bd, idx1, idx2)
        theta = kernel._theta_vector()
        kw = dict(knode=kernel.node_kernel, kedge=kernel.edge_kernel,
                  n_p_theta=1, mode='cuda')
        s = mlgk_setup(theta, ops, **kw)
        operator = [s[f].contiguous() for f in (
            'T', 'esrc_1', 'edst_1', 'esrc_2', 'edst_2', 'diag', 'precond')]
        x, _ = pcg_resident(*operator, s['b'].contiguous(), s['tol'],
                            maxiter)
        rhs = mlgk_tangents(theta, ops, s, x, **kw)['rhs'].contiguous()
        k = rhs.shape[1]
        return ([a[:, None] for a in operator]
                + [rhs, s['gtol'].contiguous(), min(maxiter * k, 16384)])

    t_args = tangent_groups(N_COMPARE)
    x_k, it_k = pcg_packed(*t_args)
    x_r, it_r = pcg_packed_reference(*t_args)
    torch.cuda.synchronize()
    packed_err = float((x_k - x_r).abs().max())
    scale = float(x_r.abs().max())
    say(f'  (a) {N_COMPARE} tangent groups of k = {t_args[7].shape[1]}, '
        f'shared operator; CG steps kernel mean '
        f'{float(it_k.float().mean()):.2f} max {int(it_k.max())}, twin '
        f'mean {float(it_r.float().mean()):.2f} max {int(it_r.max())}')
    check(bool(torch.isfinite(x_k).all()), 'pcg_packed x is finite')
    check(packed_err <= 1e-5 * scale,
          f'max |x_packed - x_twin| = {packed_err:.3e} <= 1e-5 * max |x| = '
          f'{1e-5 * scale:.3e}')
    args = systems(N_COMPARE)
    grouped = group_pairs(2, *args)
    x_k, it_k = pcg_packed(*grouped)
    x_r, _ = pcg_packed_reference(*grouped)
    x_res, _ = pcg_resident(*args)
    torch.cuda.synchronize()
    x_k = x_k.reshape(-1, *x_k.shape[2:])[:N_COMPARE]
    x_r = x_r.reshape(-1, *x_r.shape[2:])[:N_COMPARE]
    scale = float(x_r.abs().max())
    err_twin = float((x_k - x_r).abs().max())
    err_res = float((x_k - x_res).abs().max())
    check(err_twin <= 1e-5 * scale and err_res <= 1e-5 * scale,
          f'(b) group_pairs(2): max |x_packed - x_twin| = {err_twin:.3e}, '
          f'max |x_packed - x_resident| = {err_res:.3e} <= 1e-5 * max |x| '
          f'= {1e-5 * scale:.3e}')
    try:
        pcg_packed(*group_pairs(16, *systems(64)))
    except ValueError as e:
        check('largest k that fits' in str(e),
              f'(c) a group of 16 pairs raises: {e}')
    else:
        raise RuntimeError('check failed: a group of 16 pairs did not raise')

    say('== 11. the gradient slice: normalized 128-molecule Gram with '
        'eval_gradient=True, backend=cuda')
    g_chunk = kernel._chunk_size(n_pad, m_pad, eval_gradient=True)
    g_chunks = math.ceil(n_pairs / g_chunk)
    pcg_resident.launches = pcg_stream.launches = pcg_packed.launches = 0
    t0 = time.perf_counter()
    KG, dKG = Normalization(kernel)(graphs, eval_gradient=True)
    say(f'  first build {time.perf_counter() - t0:.4f} s, chunk {g_chunk}')
    packed_launches = pcg_packed.launches
    check(packed_launches == g_chunks,
          f'pcg_packed launched {packed_launches} times = {g_chunks} chunks')
    check(pcg_resident.launches == g_chunks and pcg_stream.launches == 0,
          f'pcg_resident launched {pcg_resident.launches} times (value '
          'solves), pcg_stream 0')
    check(KG.shape == (n_graphs, n_graphs)
          and dKG.shape == (n_graphs, n_graphs, 4),
          f'K is {KG.shape}, dK is {dKG.shape}')
    check(bool(np.isfinite(KG).all() and np.isfinite(dKG).all()),
          'K and dK are finite')
    err = float(np.abs(KG - K).max())
    check(err <= 1e-6, f'max |K_grad - K_value| = {err:.3e} <= 1e-6')
    err = float(np.abs(dKG - dKG.transpose(1, 0, 2)).max())
    check(err <= 1e-12, f'dK is symmetric (max |dK - dK^T| = {err:.1e})')
    err = float(np.abs(dKG[:, :, 0]).max())
    check(err <= 1e-5, f'p cancels: max |dK_p| = {err:.3e} <= 1e-5')
    _, dKG_edge = Normalization(make_kernel('edge'))(
        graphs, eval_gradient=True)
    grad_scale = float(np.abs(dKG_edge).max())
    grad_edge_err = float(np.abs(dKG - dKG_edge).max())
    check(grad_edge_err <= 1e-3 * grad_scale + 1e-5,
          f'max |dK_cuda - dK_edge| = {grad_edge_err:.3e} <= 1e-3 * max '
          f'|dK| + 1e-5 = {1e-3 * grad_scale + 1e-5:.3e}')
    gref = np.load(GRAD_FIXTURE)
    n_ref = int(gref['n_first'])
    err = float(np.abs(KG[:n_ref, :n_ref] - gref['K']).max())
    check(err <= 1e-6, f'max |K - K_jax| over the first {n_ref} graphs = '
          f'{err:.3e} <= 1e-6')
    tol = 1e-3 * float(np.abs(gref['dK']).max()) + 1e-5
    err = float(np.abs(dKG[:n_ref, :n_ref] - gref['dK']).max())
    check(err <= tol, f'max |dK - dK_jax| over the first {n_ref} graphs = '
          f'{err:.3e} <= {tol:.3e}')
    few = graphs[:n_ref]
    theta0 = kernel.theta
    for t in range(len(theta0)):
        step = np.zeros_like(theta0)
        step[t] = 1e-3
        Kp = Normalization(kernel.clone_with_theta(theta0 + step))(few)
        Km = Normalization(kernel.clone_with_theta(theta0 - step))(few)
        fd = (Kp - Km) / 2e-3 / np.exp(theta0[t])
        check(np.allclose(dKG[:n_ref, :n_ref, t], fd, rtol=0.05, atol=0.05),
              f'central differences in log theta[{t}] (max |dK - fd| = '
              f'{float(np.abs(dKG[:n_ref, :n_ref, t] - fd).max()):.3e})')

    say('== 12. the gradient beyond shared memory: 32 molecules of 48-72 '
        'atoms')
    pcg_resident.launches = pcg_stream.launches = pcg_packed.launches = 0
    _, dKB = Normalization(make_kernel())(big, eval_gradient=True)
    check(pcg_stream.launches >= 2 and pcg_packed.launches == 0
          and pcg_resident.launches == 0,
          f'pcg_stream launched {pcg_stream.launches} times (value and '
          'tangent solves), pcg_packed and pcg_resident 0')
    _, dKB_edge = Normalization(make_kernel('edge'))(big, eval_gradient=True)
    tol = 1e-3 * float(np.abs(dKB_edge).max()) + 1e-5
    err = float(np.abs(dKB - dKB_edge).max())
    check(bool(np.isfinite(dKB).all()) and err <= tol,
          f'max |dK_cuda - dK_edge| = {err:.3e} <= {tol:.3e}')
    pcg_resident.launches = pcg_stream.launches = pcg_packed.launches = 0
    _, dKL = Normalization(make_kernel())(large[48, 56], eval_gradient=True)
    check(pcg_resident.launches >= 2 and pcg_packed.launches == 0
          and pcg_stream.launches == 0,
          f'48-55-atom molecules: pcg_resident launched '
          f'{pcg_resident.launches} times (value solves and tangents one a '
          'CTA), pcg_packed and pcg_stream 0')
    _, dKL_edge = Normalization(make_kernel('edge'))(
        large[48, 56], eval_gradient=True)
    tol = 1e-3 * float(np.abs(dKL_edge).max()) + 1e-5
    err = float(np.abs(dKL - dKL_edge).max())
    check(bool(np.isfinite(dKL).all()) and err <= tol,
          f'max |dK_cuda - dK_edge| = {err:.3e} <= {tol:.3e}')

    say('== 13. timing of the gradient path')
    t_args = tangent_groups(g_chunk)
    x_k, t_steps = pcg_packed(*t_args)
    packed_bound = pcg_bound(t_args, x_k, t_steps)
    packed_live, text = live_report(t_args)
    say(f'  tangent groups of one gradient chunk: {text}')
    k_t = t_args[7].shape[1]
    packed_occ = kernel_occupancy('pcg_packed', m_pad, m_pad, n_pad, n_pad,
                                  k=k_t, ka=1)
    say(f'  pcg_packed occupancy (k = {k_t}, shared operator): '
        f'{packed_occ}')
    packed_times = time_call(lambda: pcg_packed(*t_args), 10,
                             'pcg_packed_kernel')
    packed_ms = packed_times['ms']
    packed_device_ms = packed_times['device_ms']
    packed_plain_ms = cuda_ms(lambda: pcg_packed_reference(*t_args), reps=3)
    say(f'  tangent groups of one gradient chunk ({g_chunk} pairs x 4, CG '
        f'steps mean {float(t_steps.float().mean()):.3f}, max '
        f'{int(t_steps.max())}): pcg_packed {packed_ms:.4f} ms by events, '
        f'device {packed_device_ms} ms, plain twin '
        f'{packed_plain_ms:.4f} ms, bound {packed_bound[0]:.4f} ms '
        f'({packed_bound[1]})')
    say(f'    in turns (events, device): {packed_times["runs"]}')
    packed_split = step_split(pcg_packed, t_args, 'pcg_packed_kernel')
    say(f'  device time by part: {packed_split}')
    args = systems(chunk)
    _, p_steps = pcg_resident(*args)
    res_ms = cuda_ms(lambda: pcg_resident(*args), reps=20)
    say(f'  one value chunk of {chunk} pairs: pcg_resident {res_ms:.4f} ms '
        f'(CG steps mean {float(p_steps.float().mean()):.3f}, max '
        f'{int(p_steps.max())})')
    for k in (2, 4):
        grouped = group_pairs(k, *args)
        _, g_steps = pcg_packed(*grouped)
        k_ms = cuda_ms(lambda: pcg_packed(*grouped), reps=20)
        alone = p_steps[:grouped[7].shape[0] * k].reshape(-1, k)
        say(f'  the same chunk in groups of k = {k} pairs: pcg_packed '
            f'{k_ms:.4f} ms ({res_ms / k_ms:.3f}x pcg_resident); CG steps '
            f'of groups mean {float(g_steps.float().mean()):.3f} max '
            f'{int(g_steps.max())}, max over each group\'s pairs alone mean '
            f'{float(alone.max(dim=1).values.float().mean()):.3f}')
    walls = {'value': [], 'gradient': []}
    for _ in range(GRAD_REPEATS):
        for what in walls:
            t0 = time.perf_counter()
            Normalization(kernel)(graphs, eval_gradient=what == 'gradient')
            torch.cuda.synchronize()
            walls[what].append(time.perf_counter() - t0)
    for what, ws in walls.items():
        wall = float(np.median(ws))
        say(f'  normalized {what} Gram build: median {wall * 1e3:.3f} ms '
            f'over {GRAD_REPEATS} ({", ".join(f"{w * 1e3:.3f}" for w in ws)})'
            f'; {n_pairs / wall:.1f} pairs/s at the median')
    profile_build(lambda: Normalization(kernel)(
        graphs, eval_gradient=True), 'gradient')

    say(json.dumps({'kernels': [{
        'name': 'pcg_resident', 'route': 'cuda',
        'source': 'graphdot_tpu_torch/csrc/pcg_resident.cu',
        'replaces': TPU_KERNEL, 'covers': TPU_PROTO_KERNEL,
        'launches': launches, 'max_abs_err': max_abs_err, 'ms': kernel_ms,
        'device_ms': resident_device_ms,
        'plain_ms': plain_ms, 'bound_ms': resident_bound[0],
        'bound_by': resident_bound[1], 'library_ms': None,
        'occupancy': resident_occ, 'live': resident_live,
        'split': resident_split,
    }, {
        'name': 'pcg_stream', 'route': 'cuda',
        'source': 'graphdot_tpu_torch/csrc/pcg_stream.cu',
        'replaces': TPU_STREAM_KERNEL, 'launches': stream_launches,
        'max_abs_err': stream_err, 'ms': stream_ms,
        'device_ms': stream_device_ms, 'plain_ms': stream_plain_ms,
        'bound_ms': stream_bound[0],
        'bound_by': stream_bound[1], 'library_ms': None,
        'ctas_per_pair': stream_ctas, 'stream_floor_ms': stream_bound[2],
        'ms_ctas_1': float(np.mean(stream_times['chunk', 1])),
        'lone_pair': {
            'ctas_per_pair': lone_ctas,
            'ms': float(np.mean(stream_times['lone', None])),
            'ms_ctas_1': float(np.mean(stream_times['lone', 1])),
            'plain_ms': stream_times['lone', 'plain'],
            'bound_ms': stream_times['lone', 'bound'][0],
            'stream_floor_ms': stream_times['lone', 'bound'][2]},
    }, {
        'name': 'pcg_packed', 'route': 'cuda',
        'source': 'graphdot_tpu_torch/csrc/pcg_packed.cu',
        'replaces': TPU_PACK_KERNEL, 'launches': packed_launches,
        'max_abs_err': packed_err, 'ms': packed_ms,
        'device_ms': packed_device_ms,
        'plain_ms': packed_plain_ms, 'bound_ms': packed_bound[0],
        'bound_by': packed_bound[1], 'library_ms': None,
        'occupancy': packed_occ, 'live': packed_live,
        'split': packed_split,
    }]}))
    say(nvidia_smi())
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
