#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``graphdot_tpu_torch``) on one NVIDIA GPU.

Drives the port's paths once each through their public entry points,
``Normalization(MarginalizedGraphKernel(..., device='cuda'))(graphs)`` and
``GaussianProcessRegressor(..., device='cuda').fit(graphs, y)``:

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
- the factory route: non-nodal calls of 512 jobs or more (the 128-molecule
  Grams above) run through a ``GramFactory`` cached by the kernel, which
  packs the graphs once, by size class (9-24 atoms: the classes 16 and 24);
- the GP fit: ``GaussianProcessRegressor`` with L-BFGS-B on the 128
  molecules, every objective evaluation a Gram and its jacobian through one
  factory (``pcg_resident`` and ``pcg_packed``), then a prediction;
- the protein classes of ``bench_protein.py`` (150-300, 400-600 and
  800-1000 residues, none cut), whose pairs take the sum-of-Kronecker route
  (two cuBLAS products a CG step over Chebyshev factors, no T) or
  ``pcg_stream``, by the rule of ``_solver.solve_route`` and
  ``KRON_MIN_N``;
- the Bayesian path of ``bench_nuts.py``: ``GPRLogProb`` over its 32
  molecules and multi-chain NUTS (``inference.sample``, 8 chains), each
  leapfrog's live chains in one batched Gram (``pcg_resident`` and
  ``pcg_packed`` once a chunk);
- the MaxiMin path of ``bench_maximin.py``: ``MaxiMin(...,
  device='cuda')`` over its 128 molecules, the nodal solves in
  ``pcg_resident``, the hotspot gradient's tangents in ``pcg_packed``, the
  maximin reduction in torch on the card, and ``device_distance_fn``;
- graphs from atoms: the QM7 surrogate's molecules through
  ``Graph.from_ase``, their Gram, MaxiMin, ``M3`` and ``KernelOverMetric``;
- the Tang & de Jong 2019 workflow: ``HierarchicalDrafter
  (VarianceMinimizer(kernel))`` picks a core of 128 from 896 molecules and
  ``LowRankApproximateGPR`` fits on it with L-BFGS-B, each evaluation a
  two-sided gradient Gram of the 896 against the core and the core's own
  (``pcg_resident`` and ``pcg_packed`` through factories cached by the
  kernel), then predicts the 128 held out;
- the other models: ``GPROutlierDetector``, ``GaussianFieldRegressor`` over
  ``RBFOverDistance(MaxiMin)``, and the microkernels
  ``RationalQuadratic``, ``Convolution`` and ``DotProduct`` in the Gram;

and checks every part of them:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of the three kernels from ``graphdot_tpu_torch/csrc``, one
   ``nvcc`` a source, started together;
3. ``pcg_resident`` against its plain PyTorch twin on the systems of every
   value chunk of the main path: the plan of the factory that the kernel
   caches for the 128 molecules (size classes 16 and 24, the groups (16,
   16), (16, 24) and (24, 24), one chunk each), built as the factory
   builds them, on the card: max |dx| <= 1e-5 * max |x|; and, for the TPU
   timing prototype ``scripts/proto_pallas.py`` that it covers, at the
   prototype's shape (2080 pairs, M = 64, N = 24: the (24, 24) chunk) and
   fixed 16 steps (tol = 0) against the twin at the same step count;
4. the normalized molecule Gram with ``backend='cuda'`` (factory route):
   finite, symmetric, unit diagonal; ``pcg_resident`` launched once per
   chunk of the factory's groups and ``pcg_stream`` never; within 1e-6 of
   the same Gram with
   ``backend='edge'`` and of the JAX package's reference Gram stored in
   ``tests/fixtures/torch_port_gram_ref.npz``;
5. timings: ``pcg_resident`` and its twin on each value chunk of the
   factory, the wrapper call by CUDA events beside the kernel's own device
   time (``torch.profiler`` over the same calls), with the chunk's
   live-edge and live-node means, the kernel's occupancy and bound (the
   summary line's numbers are the largest chunk's, the (16, 24) chunk of
   4096 pairs); and the wall time of a whole molecule Gram build (factory
   route, cache hit);
6. ``pcg_stream``'s build, and the kernel against its twin on the systems
   of the first protein chunk and on a lone protein pair, each pair split
   over the default C CTAs (``stream_ctas_per_pair``) and over one, two
   runs at the default C bitwise equal, and against ``pcg_resident`` on
   the first 512 pairs of the (24, 24) molecule chunk: max |dx| <= 1e-5 *
   max |x| for all;
7. the normalized protein Gram with ``backend='cuda'``: finite, symmetric,
   unit diagonal; ``pcg_stream`` launched once per chunk and
   ``pcg_resident`` never; within 1e-5 of ``backend='edge'`` on the card
   (float32 sums over 7.4e4 product nodes run in other orders there than
   over the molecules' 576, hence 1e-5 and not 1e-6);
8. the boundary, on the per-pair route (``GRAPHDOT_API_UNION=0``: one
   batch padded to the largest graph): the Gram over the small protein set
   of the JAX fixture
   ``tests/fixtures/torch_port_protein_ref.npz`` (pairs of 5.2 MB of T)
   runs in ``pcg_stream`` and is within 1e-6 of the JAX Gram; 32 molecules
   of 48-72 atoms (n = 72, m = 192, over 227 KB a pair) run in
   ``pcg_stream`` and are within 1e-6 of ``backend='edge'``; 32 molecules
   of 48-55 atoms (n = 56, the most product nodes a block of
   ``pcg_resident`` holds) run in ``pcg_resident``, and 32 of 56-63 atoms
   (n = 64) in ``pcg_stream``, both within 1e-6 of ``backend='edge'``;
9. timings with CUDA events, in turns (C = 1, default, default, C = 1):
   ``pcg_stream`` on one protein chunk and on a lone protein pair, beside
   the twin on both; ``pcg_stream`` and ``pcg_resident`` on the (24, 24)
   molecule chunk, the CG steps of both; the protein Gram's wall time per
   build,
   and one profiled protein build (``torch.profiler``);
10. ``pcg_packed`` against its twin: (a) the tangent groups (k = 4, one
    shared operator, as the main path groups them) of every gradient chunk
    of the factory (9 chunks over the three groups), (b) ``group_pairs(2)``
    over the first 512 pairs of the (24, 24) chunk (the TPU's layout)
    against the twin and against ``pcg_resident``, max |dx| <= 1e-5 * max
    |x| for both; (c) a group beyond a block's shared memory raises;
11. the gradient slice (factory route): K and dK [128, 128, 4] finite, K
    within 1e-6 of phase 4's Gram, dK symmetric, its p column <= 1e-5 (p
    cancels in a normalized kernel); ``pcg_packed`` launched once per chunk
    and
    ``pcg_stream`` never; dK within 1e-3 * max |dK| + 1e-5 of
    ``backend='edge'``; K and dK over the first 8 graphs within 1e-6 and
    1e-3 * max |dK| + 1e-5 of the JAX package's reference in
    ``tests/fixtures/torch_port_grad_ref.npz``; central differences in
    log theta (step 1e-3) within rtol 0.05, atol 0.05;
12. on the per-pair route, the gradient of the 32 molecules of 48-72
    atoms: tangents in
    ``pcg_stream``, ``pcg_packed`` never; of the 48-55-atom ones: value
    and tangents (one a CTA) in ``pcg_resident`` only; dK within phase
    11's tolerance of ``edge`` for both;
13. timings: ``pcg_packed`` and its twin on the tangent groups of the
    first gradient chunk of each factory group, by CUDA events and by
    device time, with live means, occupancy and bound (the summary line's
    numbers are the (16, 24) chunk's, 903 pairs); ``pcg_packed`` on pair
    groups (k = 2 and 4) against ``pcg_resident`` on the (24, 24) chunk,
    with the CG steps of groups and of pairs; the gradient Gram's wall
    time beside the value
    Gram's (factory route, medians of 5, in turns); one profiled gradient
    build (``torch.profiler``): device busy share, device time by kernel,
    host time in the solver's phases;
14. the factory route: a fresh kernel's first call packs each size class
    once (``batch_graphs`` calls counted) and caches one factory;
    ``pcg_resident`` launched once per chunk, ``pcg_stream`` never; a second
    call and the gradient call pack nothing; K within 1e-6 and dK within
    1e-3 * max |dK| + 1e-5 of the per-pair route and of the JAX fixtures;
    the 32 x 128 cross-Gram of ``random_molecule_set(7, 32, (9, 24))``
    against the 128 takes a rectangular factory, within 1e-6 * max |K| of
    the per-pair route; value and gradient walls of both routes in turns
    (medians of 5), and one profiled factory build of each; below the
    route's threshold of 512 jobs (16 and 31 molecules: 136 and 496 jobs),
    the unnormalized value and gradient Grams on the per-pair route, on the
    factory route's first call (packing included) and on a cache hit, in
    turns (medians of 5);
15. the GP fit: ``GaussianProcessRegressor(Normalization(kernel), alpha =
    1e-2, normalize_y, optimizer)`` fitted with ``tol = 1e-4`` to
    ``bench_nuts.py``'s targets (-10 |nodes| + N(0, 1)) through the factory
    engine: it converges, its negative LML at the fit is at most theta0's,
    every objective evaluation launches ``pcg_resident`` and ``pcg_packed``
    and ``pcg_stream`` never; the gradient at theta0 within rtol 0.05, atol
    0.05 of central differences in log theta (step 0.1) and within
    1e-3 * max |grad| + 1e-3 of ``backend='edge'`` (LML within 1e-5
    relative); predictions with
    std of the 32 held-out molecules finite, std >= 0; the LML, gradient and
    predictions over 16 + 8 molecules within the tolerances of
    ``tests/test_torch_gpr.py`` of the JAX values in
    ``tests/fixtures/torch_port_gpr_ref.npz``; the evaluations, the fit's
    wall, the wall and the launches an evaluation; one profiled
    evaluation, and the factory's Gram and jacobian timed against the
    float64 objective and its chain rule (medians of 5, in turns);
16. the protein classes of ``bench_protein.py`` (``random_protein_set(7,
    11, (150, 300))``, ``(8, 6, (400, 600))``, ``(9, 4, (800, 1000))``;
    its kernel, ``SquareExponential(3.0)`` on length, q = 0.05,
    normalized), each through ``GramFactory(buckets=False)`` with
    ``backend='kron'`` (ranks calibrated), with ``backend='cuda'`` and
    ``kron_ranks='off'`` (``pcg_stream``), and with ``'auto'``: every Gram
    finite, symmetric and of unit diagonal to 1e-6; kron within 1e-6
    (``KRON_LIMIT``) of ``pcg_stream``; the kron route launches no
    ``pcg_*`` kernel (one ``kron_pcg`` solve a chunk), the stream route
    ``pcg_stream`` once a chunk and nothing else; ``'auto'`` launches the
    route that the rule names (and the per-pair ``__call__`` of the
    150-300 class too); ``pcg_stream`` against ``pcg_stream_reference`` on
    each class's first chunk, max |dx| <= 1e-5 * max |x|; CG steps, ranks,
    factorization error, the bytes each route holds, value walls in turns
    (medians of 3) and one profiled build of each route (device time in
    the products and in the rest, beside the products' float32 bound); for
    150-300 the gradient Gram by both routes, dK within 1e-5, walls in
    turns, and a control: the kron products with TF32 on must miss
    ``KRON_LIMIT`` on K; then the sets of ``ROUTE_LADDER`` below the
    classes (phase 8's 48-72-atom molecules, proteins of 40-64 to 150-290
    residues), each by both routes and ``'auto'``, agreement, launches and
    value walls in turns, where ``KRON_MIN_N``'s crossover lies; the JAX
    kron fixture ``tests/fixtures/torch_port_kron_ref.npz`` within 1e-4
    (K) and 5e-3 (dK), the JAX tests' tolerances;
17. the NUTS path of ``bench_nuts.py`` at full width
    (``random_molecule_set(7, 32, (9, 24))``, its targets, alpha 1e-2,
    ``normalize_y``, 8 chains, ``max_depth`` 6, jitter 0.05): the log
    posterior and its gradient at the 8 thetas of
    ``tests/fixtures/torch_port_nuts_ref.npz`` in one batched call against
    JAX's (logp within 1e-4 |logp| + 1e-3, the gradient within 1e-3 max
    |grad| + 1e-3) and against 8 single calls (K 1e-6, logp 1e-6
    relative); ``pcg_resident`` and ``pcg_packed`` launched once a chunk of
    the batched call and ``pcg_stream`` never; the fixture's GP NUTS
    transition with JAX's draws (``n_leapfrog``, depth and divergence
    equal, q and ``accept_prob`` within 1e-4); at q = 1 and q = 2 the log
    posterior finite where JAX's is; a warmup of 100 transitions (as
    ``bench_nuts.py``: at 50 the last window of dual averaging is 5
    transitions, and the resumed run's mean accept came out at 0.62-0.67
    on an H100) and a resumed run of 40 draws: all finite, every chain's
    standard deviation above 1e-6 in every dimension, the mean
    ``accept_prob`` within 0.15 of 0.8; ``value_and_grad`` at the
    fixture's 8 thetas the same bits twice before the run and once after
    it (the tangent right-hand sides sum in a fixed order on the card:
    ``ops.pcg.offdiag_operator``);
    split-R-hat, bulk ESS, the divergent share, draws/s, min-bulk-ESS/s,
    time to first draw, leapfrog iterations/s with the live chains and
    launches an iteration, gradient Grams of 1 and 8 thetas, and profiled
    Grams and a profiled iteration;
18. the MaxiMin path of ``bench_maximin.py`` at full width
    (``random_molecule_set(11, 128, (9, 24))``, 8256 pairs,
    ``KroneckerDelta(0.2)``, ``SquareExponential(0.3)``, q = 0.05): D
    finite, symmetric, its diagonal <= 5e-3, off the diagonal within the D
    limit of ``backend='edge'`` (1e-4 where both distances exceed 0.01,
    else 5e-3: the sqrt of d = sqrt(1 - ratio) near d = 0); every hotspot
    in range; ``device_distance_fn`` within the D limit of ``__call__``,
    both within it of a float64 brute force over the kernel's nodal Gram of
    the first 16 graphs, and the brute force's nodal distance at each
    hotspot equal to D within it; ``pcg_resident`` launched once a self and
    a value chunk, ``pcg_packed`` once a self and a hotspot-gradient chunk
    of the gradient call, ``pcg_stream`` never; dD finite and, at the pairs
    whose hotspots agree with ``edge`` (at least 0.95 of them), within
    1e-3 max |dD| + 1e-4 of ``edge``; ``pcg_resident`` and ``pcg_packed``
    within 1e-5 max |x| of their plain twins on the first and last value
    and hotspot-gradient chunks of the call's own plan; D, the hotspots (where a pair's top
    two distinct candidate distances, its nodal row and column minima,
    differ by more than 1e-4) and dD off the diagonal against the
    JAX fixture ``tests/fixtures/torch_port_maximin_ref.npz``; pairs/s of
    ``device_distance_fn`` (CUDA events, median of 10 calls), the walls of
    the value and gradient calls (min of 3, in turns), and profiled calls
    (busy share, device time by kernel, host ms in the reduction and in
    the solver's phases);
19. graphs from atoms: the 100 molecules of the QM7 surrogate
    (``dataset.qm7_fixture.load_qm7``) through ``Graph.from_ase(m,
    use_pbc=False)``; their normalized Gram (the kernel of
    ``tests/test_qm7_parity.py``, factory route) finite, symmetric, of unit
    diagonal and within 1e-6 of ``edge``; MaxiMin over the first 32 within
    the D limit of ``edge``; ``M3`` on the card for three pairs: its
    kernel's nodal R within rtol 1e-4, atol 1e-5 of its scipy solve, the
    distance within the D limit of the scipy route's;
    ``KernelOverMetric`` over MaxiMin with ``eval_gradient=True`` over 16
    molecules within rtol 0.1, atol 0.05 of central differences in log
    theta (step 1e-3);
20. the Tang & de Jong 2019 workflow with Nystrom at full size: a pool of
    ``random_molecule_set(42, 1024, (9, 24))`` (``bench.py``'s generator
    and atoms at 8 times its count), targets -10 |nodes| + N(0, 1), the
    normalized Tang-style kernel; ``HierarchicalDrafter(VarianceMinimizer
    (kernel))`` picks 128 distinct graphs of the first 896 (its wall and
    launches); ``LowRankApproximateGPR(alpha = 1e-5, normalize_y,
    optimizer)`` at theta0: the negative LML within 1e-4 relative and its
    gradient within 1e-3 max |grad| + 1e-5 of ``backend='edge'``;
    ``pcg_resident`` and ``pcg_packed`` within 1e-5 max |x| of their twins
    on the first and the last value and tangent chunk of each group of the
    factory that serves the two-sided 896 x 128 Gram; the fit converges,
    every evaluation launching both kernels and ``pcg_stream`` never, no
    factory built during it (the evaluations hit the kernel's cached
    factories over (X, C) and C), the LML at the fit at most theta0's; its
    wall, evaluations and wall an evaluation; ``predict`` of the 128 held
    out with std and ``predict_loocv`` over the 896, finite, with walls;
    one profiled evaluation (busy share); with core = training set on 64
    graphs, the predictions within 1e-3 std(y) of the exact
    ``GaussianProcessRegressor``'s; the 24-graph case of the JAX fixture
    ``tests/fixtures/torch_port_models_ref.npz`` (core indices equal, LML
    1e-4 relative, gradient 1e-3 max |grad| + 1e-3, means 1e-4 relative,
    stds 1e-4);
21. ``GPROutlierDetector`` over ``bench.py``'s 128 molecules, targets a
    draw of the kernel's GP prior (std 10), 4 of them moved by +-50 from a
    seeded generator, the start noises drawn by a seeded ``udist``: the
    negative LML and gradient at the start within 1e-4 relative and 1e-3
    max |grad| + 1e-5 of ``edge``; after the fit the 4 corrupted samples
    have the 4 largest sigma;
    ``GaussianFieldRegressor(RBFOverDistance(MaxiMin(...), sigma=0.5))``
    over ``bench_maximin.py``'s 128 molecules with half of the labels
    hidden: ``loocv2`` and its gradient at the start within 1e-4 relative
    and 1e-3 max |grad| + 1e-4 of the same model over ``MaxiMin(backend=
    'edge')``, then ``fit`` and ``predict`` (finite, walls); the
    128-molecule normalized Gram with ``RationalQuadratic(0.3, 1.0)`` on
    length in place of ``SquareExponential``, K within 1e-6 and dK within
    1e-3 max |dK| + 1e-5 of ``edge``; the 'vario' graphs of
    ``tests/test_mlgk.py`` with ``Convolution`` (and ``DotProduct().
    normalized`` on the edge spectra) on the card, within 1e-6 max |R| of
    ``edge`` and of the dense oracle's Gram stored in the JAX fixture, not
    kron-eligible and no ``kron_pcg`` solve;
22. the multi-GPU layer (``graphdot_tpu_torch.parallel`` and the samplers'
    ``mesh``) in a process group over NCCL of world size 1, the card's one
    rank, made in the phase and destroyed at its end: ``sharded_gram_fn``
    over the 128 molecules within 1e-6 of ``GramFactory.gram`` and of the
    JAX fixture, ``pcg_resident`` launched once a chunk of the rank's
    share; the shares of 2 and 4 ranks, computed in the process, cover
    every job once and assemble the Gram within 1e-6; ``sharded_gp_solve``
    of that Gram plus 1e-2 I in float64 within rtol 1e-4, atol 1e-5 of a
    float64 Cholesky solve; ``sample(mesh=...)`` of 8 chains for 5 draws
    from phase 17's adapted step size and mass, and a 3-stage
    ``smc_sample(mesh=...)`` of 8 particles, each bitwise equal to the
    unsharded call from the same seed; the phase within 90 s.

Prints each phase's wall as the next begins, and all of them with the
script's wall so far as one JSON line (``phase_walls_s``, ``script_s``);
``KRON_MIN_N`` beside the phase 16 walls it follows (a route is
faster on a set when every timed build of it beat every build of the
other), one JSON line;
the kron route table, one JSON line (a row a class); the kernel summary as
one JSON line (each kernel's wrapper time
and device time beside its bound: the larger of the bytes of its inputs
and outputs over 3.35 TB/s
and the float32 operations of the CG steps it ran, over the live edges,
over 67 TFLOP/s; and its launches on each path), then the card's name
and power limit, and as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, when a phase fails or there is no CUDA
device. Usage: ``python3 chip_smoke.py`` from the root of the checkout.
"""
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / 'tests' / 'fixtures' / 'torch_port_gram_ref.npz'
GRAD_FIXTURE = ROOT / 'tests' / 'fixtures' / 'torch_port_grad_ref.npz'
PROTEIN_FIXTURE = ROOT / 'tests' / 'fixtures' / 'torch_port_protein_ref.npz'
KRON_FIXTURE = ROOT / 'tests' / 'fixtures' / 'torch_port_kron_ref.npz'
GPR_FIXTURE = ROOT / 'tests' / 'fixtures' / 'torch_port_gpr_ref.npz'
NUTS_FIXTURE = ROOT / 'tests' / 'fixtures' / 'torch_port_nuts_ref.npz'
#: phase 17, bench_nuts.py's sampler: chains, warmup transitions, draws of
#: the resumed run, tree depth, jitter of the start, dual averaging's target
NUTS_CHAINS, NUTS_WARMUP, NUTS_DRAWS = 8, 100, 40
NUTS_MAX_DEPTH, NUTS_JITTER, NUTS_TARGET = 6, 0.05, 0.8
#: phase 17's timed Grams a shape of theta, in turns
NUTS_TURNS = 10
#: the GP fit of phase 15: bench_nuts.py's alpha, L-BFGS-B's tol, and the
#: step of the central differences in log theta. The float32 Gram leaves
#: ~3e-3 of rounding in the negative LML (~2.6e3 at theta0), so a step of
#: 1e-2 puts ~0.15 of noise in a difference quotient; 0.1 puts ~0.015
GP_ALPHA, GP_TOL, GP_FD_STEP = 1e-2, 1e-4, 0.1
#: phase 18, the path of bench_maximin.py: random_molecule_set(seed, n,
#: atoms), the JAX fixture over its first graphs, the calls of
#: device_distance_fn timed by CUDA events, the walls of __call__, and the
#: graphs of the float64 brute force
MAXIMIN_SET = (11, 128, (9, 24))
MAXIMIN_FIXTURE = ROOT / 'tests' / 'fixtures' / 'torch_port_maximin_ref.npz'
MAXIMIN_FN_CALLS, MAXIMIN_REPEATS, MAXIMIN_BRUTE = 10, 3, 16
#: phase 19: the QM7 surrogate's molecules in the MaxiMin check and in the
#: KernelOverMetric gradient check, and the step of its central differences
ATOMS_MAXIMIN, ATOMS_KOM, ATOMS_FD_STEP = 32, 16, 1e-3
#: phase 20, the Tang & de Jong 2019 workflow with Nystrom: the pool
#: random_molecule_set(seed, n, atoms) (bench.py's generator and atoms at 8
#: times its count), its training part (the rest held out), the core, the
#: model's alpha, L-BFGS-B's tol, and the training graphs of the full-rank
#: check against the exact GPR
NYSTROM_SET, NYSTROM_TRAIN, NYSTROM_CORE = (42, 1024, (9, 24)), 896, 128
NYSTROM_ALPHA, NYSTROM_TOL, NYSTROM_FULL = 1e-5, 1e-5, 64
MODELS_FIXTURE = ROOT / 'tests' / 'fixtures' / 'torch_port_models_ref.npz'
#: phase 21: the outlier detector's molecules (bench.py's 128), the seed of
#: its targets and of the corrupted ones, how many and by how much, its L1
#: weight; the seed of the Gaussian field's hidden labels and its sigma
OUTLIER_SET, OUTLIER_SEED = (42, 128, (9, 24)), 5
OUTLIERS, OUTLIER_SHIFT, OUTLIER_W = 4, 50.0, 0.5
GFR_SEED, GFR_SIGMA = 7, 0.5
N_COMPARE = 512       # pairs in the kernel-vs-twin comparison
BUILD_REPEATS = 5     # timed molecule Gram builds
PROTEIN_REPEATS = 3   # timed protein Gram builds
#: the protein slice: protein_niche_set(seed, n, residue range)
PROTEINS = (13, 6, (180, 280))
#: bench_protein.py's classes: (label, random_protein_set(seed, n, range))
PROTEIN_CLASSES = (('150-300', 7, 11, (150, 300)),
                   ('400-600', 8, 6, (400, 600)),
                   ('800-1000', 9, 4, (800, 1000)))
KRON_REPEATS = 3      # timed Gram builds of each route, in turns
#: the card's limits on kron against pcg_stream, on K and on dK: both
#: routes run in float32 (the kron products with TF32 off) and the
#: factorization is calibrated to 1e-6 on k_edge. On K, TF32 products
#: miss KRON_LIMIT (the control of phase 16); the JAX fixture keeps the
#: JAX tests' 1e-4 and 5e-3
KRON_LIMIT, KRON_GRAD_LIMIT = 1e-6, 1e-5
#: sets below bench_protein.py's classes, each Gram by kron and by
#: pcg_stream, where KRON_MIN_N's crossover is looked for: (label, kind,
#: seed, graphs, size range); proteins are random_protein_set's, molecules
#: random_molecule_set's (phase 8's large molecules, length-only edge
#: kernel, kron-eligible)
ROUTE_LADDER = (('molecules 48-72', 'molecules', 7, 32, (48, 72)),
                ('proteins 40-64', 'proteins', 21, 11, (40, 64)),
                ('proteins 60-100', 'proteins', 22, 11, (60, 100)),
                ('proteins 80-130', 'proteins', 25, 11, (80, 130)),
                ('proteins 100-160', 'proteins', 26, 11, (100, 160)),
                ('proteins 100-200', 'proteins', 23, 11, (100, 200)),
                ('proteins 150-290', 'proteins', 24, 11, (150, 290)))
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


#: the phase under way (its number, from its '== n.' header) and when it
#: began; each phase's wall is printed when the next one begins
_PHASE = {'name': None, 'start': time.perf_counter(), 'walls': {}}


def _end_phase():
    if _PHASE['name'] is not None:
        wall = time.perf_counter() - _PHASE['start']
        _PHASE['walls'][_PHASE['name']] = round(wall, 3)
        print(f'  phase {_PHASE["name"]} took {wall:.3f} s', flush=True)


def say(*args):
    text = ' '.join(str(a) for a in args)
    if text.startswith('== '):
        _end_phase()
        _PHASE.update(name=text[3:].split('.')[0],
                      start=time.perf_counter())
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
            'padded_edges': list(T.shape[-2:]),
            'padded_nodes': b.shape[-2] * b.shape[-1]}
    return live, (f'live edges a side mean {live["live_edges_1"]:.2f} / '
                  f'{live["live_edges_2"]:.2f} of {T.shape[-2]} / '
                  f'{T.shape[-1]}, live product '
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


#: the ``torch.profiler`` ranges of the port: the solver's phases
#: (``_solver.mlgk_solve``) and the log density's (``inference/hmc.py``,
#: ``inference/gp_logprob.py``)
RANGES = ('mlgk_setup', 'mlgk_value_solve', 'mlgk_tangents',
          'mlgk_tangent_solve', 'value_and_grad', 'gp_gram', 'gp_density',
          'gp_gram_backward', 'maximin_reduce')


def profile_build(build, what, host_out=None):
    """One profiled call of ``build`` (a Gram): wall time, device busy
    share, device time by kernel, host time in the solver's phases.
    Returns (wall ms, {kernel name: device ms}); ``host_out``, a dict,
    receives the host ms of each range of RANGES."""
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
        if e.name in RANGES:
            # the solver's and the log density's ranges: the host side only
            # (the profiler also marks each range's span on the device)
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
    for name in RANGES:
        if name.startswith('mlgk_') or name in host:
            say(f'    host {host.get(name, 0.0) / 1e3:9.3f} ms in {name}')
    if host_out is not None:
        host_out.update({name: us / 1e3 for name, us in host.items()})
    return wall_us / 1e3, {name: us / 1e3 for name, us in device.items()}


@contextlib.contextmanager
def api_union(value):
    """``GRAPHDOT_API_UNION`` set to ``value`` within: ``'0'`` keeps
    non-nodal calls on the per-pair route, ``'1'`` sends every one through
    the kernel's cached factory."""
    old = os.environ.get('GRAPHDOT_API_UNION')
    os.environ['GRAPHDOT_API_UNION'] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ['GRAPHDOT_API_UNION']
        else:
            os.environ['GRAPHDOT_API_UNION'] = old


def factory_chunks(kernel, graphs, eval_gradient=False):
    """The chunks of the kernel's cached factory over ``graphs``: one launch
    of the value kernel each, and of ``pcg_packed`` with ``eval_gradient``
    (a cache hit: the factory exists)."""
    plan = kernel._get_call_factory(graphs, None)._plan
    return sum(1 for grp in plan.groups
               for _ in plan.chunks(grp, eval_gradient))


def gp_targets(graphs):
    """``bench_nuts.py``'s targets: -10 |nodes| + N(0, 1), default_rng(0)."""
    rng = np.random.default_rng(0)
    return np.array([-10.0 * len(g.nodes) + rng.normal() for g in graphs])


def gp_phase(graphs, held, make_kernel):
    """Phase 15: fit ``GaussianProcessRegressor`` with L-BFGS-B on the 128
    molecules (``bench_nuts.py``'s targets, alpha 1e-2, ``normalize_y``),
    its Gram and jacobian through the factory engine on the card, and
    predict the held-out molecules; check the fit, its gradient, and the
    JAX fixture. Returns the kernels' launches during the fit."""
    import torch
    from graphdot_tpu_torch.inference import GramFactory
    from graphdot_tpu_torch.kernel import Normalization
    from graphdot_tpu_torch.model.gaussian_process import (
        GaussianProcessRegressor)
    from graphdot_tpu_torch.model.gaussian_process import _objectives as obj
    from graphdot_tpu_torch.ops.pcg import pcg_packed, pcg_resident, pcg_stream

    counters = (pcg_resident, pcg_packed, pcg_stream)
    y = gp_targets(graphs)
    model = GaussianProcessRegressor(
        Normalization(make_kernel()), alpha=GP_ALPHA, normalize_y=True,
        optimizer=True, device='cuda')
    theta0 = model.kernel.theta.copy()
    evaluations = []    # (eval_gradient, theta, launches of each kernel)
    real_gram = GramFactory.gram

    def recorded_gram(self, theta_log, **kwargs):
        before = [c.launches for c in counters]
        out = real_gram(self, theta_log, **kwargs)
        evaluations.append((kwargs.get('eval_gradient', False),
                            np.asarray(theta_log).copy(),
                            [c.launches - b
                             for c, b in zip(counters, before)]))
        return out

    GramFactory.gram = recorded_gram
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    try:
        model.fit(graphs, y, tol=GP_TOL)
        torch.cuda.synchronize()
    except RuntimeError:
        say('  the fit failed; theta at each objective evaluation:')
        for grad, theta, _ in evaluations:
            say(f'    {"gradient" if grad else "value"} {theta.tolist()}')
        raise
    finally:
        GramFactory.gram = real_gram
    fit_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    steps = [e for e in evaluations if e[0]]
    n_evals = len(steps)
    check(model._engine is not None and n_evals >= 2,
          f'the fit converged after {n_evals} objective evaluations through '
          'the factory engine')
    check(all(l[0] >= 1 and l[1] >= 1 for _, _, l in steps)
          and launches['pcg_stream'] == 0,
          'every evaluation launched pcg_resident and pcg_packed; pcg_stream '
          'never')
    say(f'  theta {theta0.tolist()} -> {model.kernel.theta.tolist()}')
    say(f'  fit wall {fit_s:.4f} s, {n_evals} evaluations with gradient and '
        f'{len(evaluations) - n_evals} without, {fit_s / n_evals * 1e3:.3f} '
        'ms an evaluation; launches an evaluation: ' + ', '.join(
            f'{name} {count / n_evals:.3f}'
            for name, count in launches.items()))
    nll_fit = model.log_marginal_likelihood()
    nll0 = model.log_marginal_likelihood(theta0)
    check(nll_fit <= nll0, f'negative LML {nll_fit:.6f} at the fit <= '
          f'{nll0:.6f} at theta0')
    value, grad = model.log_marginal_likelihood(theta0, eval_gradient=True)
    fd = []
    for t in range(len(theta0)):
        step = np.zeros_like(theta0)
        step[t] = GP_FD_STEP
        fd.append((model.log_marginal_likelihood(theta0 + step)
                   - model.log_marginal_likelihood(theta0 - step))
                  / (2 * GP_FD_STEP))
    say(f'  gradient at theta0 {grad.tolist()}, central differences '
        f'(step {GP_FD_STEP}) {fd}')
    check(np.allclose(grad, fd, rtol=0.05, atol=0.05),
          'the gradient matches central differences (rtol 0.05, atol 0.05)')
    edge = GaussianProcessRegressor(
        Normalization(make_kernel('edge')), alpha=GP_ALPHA,
        normalize_y=True, device='cuda')
    edge.X, edge.y = graphs, y
    value_edge, grad_edge = edge.log_marginal_likelihood(
        theta0, eval_gradient=True)
    tol = 1e-3 * float(np.abs(grad_edge).max()) + 1e-3
    check(abs(value - value_edge) <= 1e-5 * abs(value_edge)
          and float(np.abs(grad - grad_edge).max()) <= tol,
          f'backend edge: negative LML {value_edge:.6f} vs {value:.6f} '
          f'(rtol 1e-5), max |grad - grad_edge| = '
          f'{float(np.abs(grad - grad_edge).max()):.3e} <= {tol:.3e}')
    t0 = time.perf_counter()
    mean, std = model.predict(held, return_std=True)
    say(f'  predict {len(held)} held-out molecules with std: '
        f'{time.perf_counter() - t0:.4f} s')
    check(mean.shape == std.shape == (len(held),)
          and bool(np.isfinite(mean).all()) and bool((std >= 0).all()),
          f'means finite, std >= 0 (mean |y - mean| over the held-out set '
          f'{float(np.abs(gp_targets(held) - mean).mean()):.3f}; targets of '
          'their own draw)')

    ref = np.load(GPR_FIXTURE)
    n_train, n_predict = int(ref['n_train']), int(ref['n_predict'])
    check(np.array_equal(ref['y'], y[:n_train]),
          f'the fixture\'s targets are those of the first {n_train} graphs')
    small = GaussianProcessRegressor(
        Normalization(make_kernel()), alpha=float(ref['alpha']),
        normalize_y=True, device='cuda')
    for i, theta in enumerate(ref['theta']):
        small.kernel.theta = theta
        small.fit(graphs[:n_train], y[:n_train])
        lml, g = small.log_marginal_likelihood(eval_gradient=True)
        m, s = small.predict(held[:n_predict], return_std=True)
        gtol = 1e-3 * float(np.abs(ref['grad'][i]).max()) + 1e-3
        check(abs(lml - ref['lml'][i]) <= 1e-4 * abs(ref['lml'][i])
              and float(np.abs(g - ref['grad'][i]).max()) <= gtol
              and np.allclose(m, ref['mean'][i], rtol=1e-4, atol=0)
              and float(np.abs(s - ref['std'][i]).max()) <= 1e-4,
              f'JAX fixture at theta {i}: LML {lml:.6f} vs '
              f'{ref["lml"][i]:.6f} '
              f'(rtol 1e-4), max |grad - grad_jax| '
              f'{float(np.abs(g - ref["grad"][i]).max()):.3e} <= {gtol:.3e}, '
              f'means rtol 1e-4 (max rel '
              f'{float(np.abs(m / ref["mean"][i] - 1).max()):.2e}), max |std '
              f'- std_jax| {float(np.abs(s - ref["std"][i]).max()):.2e} <= '
              '1e-4')
    theta_fit = model.kernel.theta.copy()
    profile_build(lambda: model.log_marginal_likelihood(
        theta_fit, eval_gradient=True, clone_kernel=False), 'fit evaluation')
    # an evaluation's two halves, in turns: the factory's Gram and
    # jacobian on the host, then the float64 objective and its chain rule
    halves = {'gram': [], 'linalg': []}
    for _ in range(5):
        t0 = time.perf_counter()
        K, dK = model._engine_gramian(model.alpha, theta_fit, True)
        t1 = time.perf_counter()
        _, (gK,) = obj.negative_log_marginal(K, model._y, model.beta,
                                             with_grad=True, device='cuda')
        obj.chain_to_theta(gK, dK, theta_fit, device='cuda')
        torch.cuda.synchronize()
        halves['gram'].append(t1 - t0)
        halves['linalg'].append(time.perf_counter() - t1)
    say('  an evaluation at the fit, medians of 5: ' + ', '.join(
        f'{part} {np.median(ts) * 1e3:.3f} ms ('
        + ', '.join(f'{t * 1e3:.3f}' for t in ts) + ')'
        for part, ts in halves.items()))
    return launches


def gemm_split(device):
    """(device ms in the matrix products, in everything else) of a profiled
    build's {kernel name: device ms}: cuBLAS names its kernels ``*gemm*``."""
    gemm = sum(ms for name, ms in device.items() if 'gemm' in name.lower())
    return gemm, sum(device.values()) - gemm


def held_bytes(build):
    """The device bytes a call of ``build`` holds at its peak, above what
    was allocated before it."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def kron_phase():
    """Phase 16: the protein classes of ``bench_protein.py`` on the card,
    each Gram by the kron route and by ``pcg_stream``, and by the rule's own
    route (``'auto'``); the 150-300 class's gradient Gram by both routes; the
    JAX kron fixture. Returns (one row a class for the kron route table,
    pcg_stream's launches in the classes' first stream builds, the
    KRON_MIN_N line)."""
    import torch
    from graphdot_tpu_torch.inference import GramFactory
    from graphdot_tpu_torch.kernel import (
        MarginalizedGraphKernel, Normalization)
    from graphdot_tpu_torch.kernel.marginalized import _kron, _solver
    from graphdot_tpu_torch.kernel.marginalized._solver import mlgk_setup
    from graphdot_tpu_torch.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu_torch.ops.pcg import (pcg_packed, pcg_resident,
                                            pcg_stream, pcg_stream_reference)
    from graphdot_tpu_torch.testing import (random_molecule_set,
                                            random_protein_set)

    counters = {'pcg_resident': pcg_resident, 'pcg_packed': pcg_packed,
                'pcg_stream': pcg_stream, 'kron': _kron.kron_pcg}

    def kern(backend, length_scale=3.0):
        """bench_protein.py:125-130's kernel (the molecules' length scale
        is phase 2's, 0.3)."""
        return MarginalizedGraphKernel(
            TensorProduct(element=KroneckerDelta(0.2)),
            TensorProduct(length=SquareExponential(length_scale)), q=0.05,
            device='cuda', backend=backend)

    @contextlib.contextmanager
    def tf32_products():
        """The control of KRON_LIMIT: the kron products with TF32 on, the
        precision that the port's kron route excludes."""
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def counted(call):
        """call()'s result and the launches of every route during it."""
        for c in counters.values():
            c.launches = 0
        out = call()
        torch.cuda.synchronize()
        return out, {name: c.launches for name, c in counters.items()}

    def check_gram(K, what):
        """Finite, symmetric and a unit diagonal to float32 rounding (the
        factory divides K_ij by sqrt(K_ii) and sqrt(K_jj) in turn)."""
        K = K.cpu().numpy()
        n = K.shape[0]
        sym, diag = (float(np.abs(K - K.T).max()),
                     float(np.abs(np.diag(K) - 1).max()))
        check(K.shape == (n, n) and bool(np.isfinite(K).all())
              and sym <= 1e-6 and diag <= 1e-6,
              f'{what}: K finite, symmetric (max |K - K^T| = {sym:.1e}), '
              f'unit diagonal (max |K_ii - 1| = {diag:.1e})')
        return K

    def walls(builds, reps):
        """``reps`` walls of each build, in turns: (their medians, the
        walls)."""
        times = {name: [] for name in builds}
        for rep in range(reps):
            order = list(builds) if rep % 2 == 0 else list(builds)[::-1]
            for name in order:
                t0 = time.perf_counter()
                builds[name]()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        for name, ts in times.items():
            say(f'    {name}: median {np.median(ts):.3f} ms over {reps} '
                f'({", ".join(f"{t:.3f}" for t in ts)})')
        return ({name: float(np.median(ts)) for name, ts in times.items()},
                times)

    rows, stream_launches = [], 0
    for label, seed, n, residues in PROTEIN_CLASSES:
        say(f'  -- class {label}: random_protein_set({seed}, {n}, '
            f'{residues})')
        graphs = random_protein_set(seed, n, residues)
        fk = GramFactory(kern('kron'), graphs, buckets=False)
        fs = GramFactory(kern('cuda'), graphs, buckets=False,
                         kron_ranks='off')
        fa = GramFactory(kern('auto'), graphs, buckets=False)
        theta0 = fk.theta0
        grp = fk._plan.groups[0]
        n_pad, m_pad = grp['n1'], grp['m_pad']
        plan = fk._plan.kron
        R = int(np.prod(plan.ranks))
        pairs = n * (n + 1) // 2
        say(f'  {len(graphs)} graphs of {min(len(g.nodes) for g in graphs)}'
            f'-{max(len(g.nodes) for g in graphs)} residues, {pairs} pairs '
            f'padded to n = {n_pad}, m = {m_pad}; kron ranks {plan.ranks}, '
            f'factorization error {plan.err:.3e} on the domain '
            f'{plan.domain}')
        check(fs._plan.route(fs._plan.groups[0]) == 'stream'
              and fk._plan.route(grp) == 'kron',
              "the routes: kron_ranks='off' streams, backend 'kron' takes "
              'kron')
        K_kron, launches = counted(lambda: fk.gram(theta0))
        kron_chunks = sum(1 for _ in fk._plan.chunks(grp))
        check(launches['kron'] == kron_chunks and all(
            v == 0 for k, v in launches.items() if k != 'kron'),
            f'kron route: {launches}, one kron solve a chunk '
            f'({kron_chunks}), no pcg_* kernel')
        K_stream, launches = counted(lambda: fs.gram(theta0))
        stream_chunks = sum(1 for _ in fs._plan.chunks(fs._plan.groups[0]))
        stream_launches += launches['pcg_stream']
        check(launches['pcg_stream'] == stream_chunks and all(
            v == 0 for k, v in launches.items() if k != 'pcg_stream'),
            f'stream route: {launches}, pcg_stream once a chunk '
            f'({stream_chunks}), nothing else')
        K_kron = check_gram(K_kron, 'kron')
        K_stream = check_gram(K_stream, 'pcg_stream')
        err = float(np.abs(K_kron - K_stream).max())
        check(err <= KRON_LIMIT,
              f'max |K_kron - K_stream| = {err:.3e} <= {KRON_LIMIT}')
        named = fa._plan.route(fa._plan.groups[0])
        K_auto, launches = counted(lambda: fa.gram(theta0))
        ran = [k for k, v in launches.items() if v]
        check(ran == [{'kron': 'kron', 'stream': 'pcg_stream'}[named]],
              f"backend 'auto': the rule names {named} (KRON_MIN_N = "
              f'{_solver.KRON_MIN_N}, n1 n2 = {n_pad * n_pad}), and '
              f'{ran} launched')
        auto_err = float(np.abs(K_auto.cpu().numpy() - K_stream).max())
        check(auto_err <= KRON_LIMIT,
              f"backend 'auto': max |K - K_stream| = {auto_err:.3e} <= "
              f'{KRON_LIMIT}')
        if label == '150-300':
            K_call, launches = counted(lambda: Normalization(kern('auto'))(
                graphs))
            ran_call = [k for k, v in launches.items() if v]
            call_err = float(np.abs(K_call - K_stream).max())
            check(ran_call == ran and call_err <= KRON_LIMIT,
                  f'the per-pair __call__ ({pairs} jobs) takes the same '
                  f'route, {ran_call}: max |K - K_stream| = {call_err:.3e} '
                  f'<= {KRON_LIMIT}')
        kron_steps = np.concatenate(
            [s['iters'] for s in fk.iteration_stats(theta0)])
        stream_steps = []
        sgrp = fs._plan.groups[0]
        for c, (_, idx1, idx2) in enumerate(fs._plan.chunks(sgrp)):
            k = fs.kernel
            sd = mlgk_setup(torch.as_tensor(fs._full0, dtype=torch.float32,
                                            device=k.device),
                            k._operands(sgrp['bd1'], sgrp['bd2'], idx1, idx2),
                            knode=k.node_kernel, kedge=k.edge_kernel,
                            n_p_theta=1, mode='cuda')
            args = (sd['T'], sd['esrc_1'], sd['edst_1'], sd['esrc_2'],
                    sd['edst_2'], sd['diag'].contiguous(),
                    sd['precond'].contiguous(), sd['b'].contiguous(),
                    sd['tol'], fs._group_maxiter(sgrp))
            x, iters = pcg_stream(*args)
            stream_steps.append(iters.cpu().numpy())
            if c == 0:
                # the kernel against its plain twin on this class's first
                # chunk, the shapes and CTA split of the stream route
                x_r, _ = pcg_stream_reference(*args)
                scale = float(x_r.abs().max())
                twin_err = float((x - x_r).abs().max())
                check(bool(torch.isfinite(x).all())
                      and twin_err <= 1e-5 * scale,
                      f'pcg_stream against pcg_stream_reference on the first '
                      f'chunk ({len(idx1)} pairs, '
                      f'{pcg_stream.last_ctas_per_pair} CTAs a pair): max '
                      f'|dx| = {twin_err:.3e} <= 1e-5 * max |x| = '
                      f'{1e-5 * scale:.3e}')
                del x_r
            del sd, args, x
        stream_steps = np.concatenate(stream_steps)
        say(f'  CG steps: kron mean {kron_steps.mean():.3f} max '
            f'{kron_steps.max()}, pcg_stream mean {stream_steps.mean():.3f} '
            f'max {stream_steps.max()}')
        flops = float((kron_steps.astype(float) * 2 * R * n_pad * n_pad
                       * 2 * n_pad).sum())
        bound_ms = flops / FP32_OPS_PER_S * 1e3
        kron_bytes = held_bytes(lambda: fk.gram(theta0))
        stream_bytes = held_bytes(lambda: fs.gram(theta0))
        say(f'  held at the peak: kron {kron_bytes / 1e9:.3f} GB, '
            f'pcg_stream {stream_bytes / 1e9:.3f} GB')
        say('  value Gram walls, in turns:')
        w, w_all = walls({'kron': lambda: fk.gram(theta0),
                          'pcg_stream': lambda: fs.gram(theta0)},
                         KRON_REPEATS)
        k_wall, k_dev = profile_build(lambda: fk.gram(theta0),
                                      f'kron {label}')
        s_wall, s_dev = profile_build(lambda: fs.gram(theta0),
                                      f'pcg_stream {label}')
        gemm, other = gemm_split(k_dev)
        row = {'class': label, 'pairs': pairs, 'n_pad': n_pad,
               'm_pad': m_pad, 'n1n2': n_pad * n_pad,
               'ranks': list(plan.ranks), 'factorization_error': plan.err,
               'kron_chunks': kron_chunks, 'stream_chunks': stream_chunks,
               'kron_steps_mean': float(kron_steps.mean()),
               'kron_steps_max': int(kron_steps.max()),
               'stream_steps_mean': float(stream_steps.mean()),
               'stream_steps_max': int(stream_steps.max()),
               'kron_wall_ms': w['kron'], 'stream_wall_ms': w['pcg_stream'],
               'kron_walls_ms': w_all['kron'],
               'stream_walls_ms': w_all['pcg_stream'],
               'kron_device_gemm_ms': gemm, 'kron_device_other_ms': other,
               'kron_profiled_wall_ms': k_wall,
               'stream_device_ms': sum(s_dev.values()),
               'stream_device_pcg_ms': sum(
                   v for name, v in s_dev.items() if 'pcg_' in name),
               'stream_profiled_wall_ms': s_wall,
               'kron_flop_bound_ms': bound_ms, 'kron_bytes': kron_bytes,
               'stream_bytes': stream_bytes, 'max_abs_err': err,
               'stream_twin_err': twin_err, 'auto_route': named}
        say(f'  kron: device {gemm:.3f} ms in the products, {other:.3f} ms '
            f'in the rest (setup, CG vectors); float32 bound of the products '
            f'{bound_ms:.3f} ms at 67 TFLOP/s')
        if label == '150-300':
            KG_kron, dK_kron = fk.gram(theta0, eval_gradient=True)
            KG_stream, dK_stream = fs.gram(theta0, eval_gradient=True)
            dK_kron, dK_stream = dK_kron.cpu().numpy(), \
                dK_stream.cpu().numpy()
            saved = _kron._fp32_matmul
            _kron._fp32_matmul = tf32_products
            try:
                K_tf32 = fk.gram(theta0).cpu().numpy()
                dK_tf32 = fk.gram(theta0, eval_gradient=True)[1].cpu().numpy()
            finally:
                _kron._fp32_matmul = saved
            tf32_err = float(np.abs(K_tf32 - K_stream).max())
            tf32_gerr = float(np.abs(dK_tf32 - dK_stream).max())
            row['tf32_control_err'] = tf32_err
            row['tf32_control_grad_err'] = tf32_gerr
            check(tf32_err > KRON_LIMIT,
                  f'control: kron with TF32 products misses the limit, max '
                  f'|K - K_stream| = {tf32_err:.3e} > {KRON_LIMIT} (max |dK '
                  f'- dK_stream| = {tf32_gerr:.3e})')
            check(bool(np.isfinite(dK_kron).all()
                       and np.isfinite(dK_stream).all()),
                  'gradient Grams: dK finite on both routes')
            gerr = float(np.abs(dK_kron - dK_stream).max())
            check(gerr <= KRON_GRAD_LIMIT, f'max |dK_kron - dK_stream| = '
                  f'{gerr:.3e} <= {KRON_GRAD_LIMIT}')
            check(float(np.abs(KG_kron.cpu().numpy() - K_kron).max()) <= 1e-6,
                  'the gradient build\'s K is the value build\'s')
            _, launches = counted(lambda: fk.gram(theta0, eval_gradient=True))
            check(launches['kron'] >= 2 and all(
                v == 0 for k, v in launches.items() if k != 'kron'),
                f'kron gradient: {launches}, no pcg_* kernel')
            _, launches = counted(lambda: fs.gram(theta0, eval_gradient=True))
            check(launches['pcg_stream'] >= 2 and all(
                v == 0 for k, v in launches.items() if k != 'pcg_stream'),
                f'stream gradient: {launches} (values and tangents), '
                'nothing else')
            say('  gradient Gram walls, in turns:')
            gw, _ = walls({
                'kron': lambda: fk.gram(theta0, eval_gradient=True),
                'pcg_stream': lambda: fs.gram(theta0, eval_gradient=True)},
                KRON_REPEATS)
            gk_wall, gk_dev = profile_build(
                lambda: fk.gram(theta0, eval_gradient=True),
                f'kron gradient {label}')
            gs_wall, gs_dev = profile_build(
                lambda: fs.gram(theta0, eval_gradient=True),
                f'pcg_stream gradient {label}')
            ggemm, gother = gemm_split(gk_dev)
            row['gradient'] = {
                'kron_wall_ms': gw['kron'], 'stream_wall_ms': gw['pcg_stream'],
                'kron_device_gemm_ms': ggemm, 'kron_device_other_ms': gother,
                'stream_device_ms': sum(gs_dev.values()),
                'kron_bytes': held_bytes(
                    lambda: fk.gram(theta0, eval_gradient=True)),
                'stream_bytes': held_bytes(
                    lambda: fs.gram(theta0, eval_gradient=True)),
                'max_abs_err': gerr}
        rows.append(row)
        del fk, fs, fa
        torch.cuda.empty_cache()

    say('  -- below the classes: where the crossover of KRON_MIN_N lies')
    ladder = []
    for label, kind, seed, n, sizes in ROUTE_LADDER:
        if kind == 'proteins':
            graphs, scale = random_protein_set(seed, n, sizes), 3.0
        else:
            graphs = random_molecule_set(seed, n, n_atoms_range=sizes)
            scale = 0.3
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            fk = GramFactory(kern('kron', scale), graphs, buckets=False)
        fs = GramFactory(kern('cuda', scale), graphs, buckets=False,
                         kron_ranks='off')
        fa = GramFactory(kern('auto', scale), graphs, buckets=False)
        grp = fk._plan.groups[0]
        n_pad, plan = grp['n1'], fk._plan.kron
        check(fs._plan.route(fs._plan.groups[0]) == 'stream'
              and fk._plan.route(grp) == 'kron',
              f'{label}: {len(graphs)} graphs padded to n = {n_pad}, m = '
              f"{grp['m_pad']}; kron ranks {plan.ranks}, factorization error "
              f'{plan.err:.3e}; the routes stream and kron')
        K_kron, launches = counted(lambda: fk.gram(fk.theta0))
        check(launches['kron'] >= 1 and all(
            v == 0 for k, v in launches.items() if k != 'kron'),
            f'kron route: {launches}')
        K_stream, launches = counted(lambda: fs.gram(fs.theta0))
        check(launches['pcg_stream'] >= 1 and all(
            v == 0 for k, v in launches.items() if k != 'pcg_stream'),
            f'stream route: {launches}')
        K_kron = check_gram(K_kron, f'{label} kron')
        K_stream = check_gram(K_stream, f'{label} pcg_stream')
        err = float(np.abs(K_kron - K_stream).max())
        if plan.err <= _kron.ACCURACY_LIMIT:
            check(err <= KRON_LIMIT,
                  f'max |K_kron - K_stream| = {err:.3e} <= {KRON_LIMIT}')
        else:
            say(f'  max |K_kron - K_stream| = {err:.3e}: calibration '
                'rejects this factorization for mode cuda')
        named = fa._plan.route(fa._plan.groups[0])
        K_auto, launches = counted(lambda: fa.gram(fa.theta0))
        ran = [k for k, v in launches.items() if v]
        auto_err = float(np.abs(K_auto.cpu().numpy() - K_stream).max())
        check(ran == [{'kron': 'kron', 'stream': 'pcg_stream'}[named]]
              and auto_err <= KRON_LIMIT,
              f"backend 'auto': the rule names {named} (n1 n2 = "
              f'{n_pad * n_pad}), {ran} launched, max |K - K_stream| = '
              f'{auto_err:.3e} <= {KRON_LIMIT}')
        say('  value Gram walls, in turns:')
        w, w_all = walls({'kron': lambda: fk.gram(fk.theta0),
                          'pcg_stream': lambda: fs.gram(fs.theta0)},
                         KRON_REPEATS)
        ladder.append({'class': label, 'graphs': len(graphs),
                       'n_pad': n_pad, 'm_pad': grp['m_pad'],
                       'n1n2': n_pad * n_pad, 'ranks': list(plan.ranks),
                       'factorization_error': plan.err,
                       'kron_wall_ms': w['kron'],
                       'stream_wall_ms': w['pcg_stream'],
                       'kron_walls_ms': w_all['kron'],
                       'stream_walls_ms': w_all['pcg_stream'],
                       'max_abs_err': err, 'auto_route': named})
        del fk, fs, fa
        torch.cuda.empty_cache()

    say('  -- the JAX kron fixture')
    ref = np.load(KRON_FIXTURE)
    seed, n, lo, hi = (int(v) for v in ref['proteins'])
    fx = GramFactory(kern('kron'), random_protein_set(seed, n, (lo, hi)),
                     buckets=False)
    check(np.allclose(fx.theta0, ref['theta'], rtol=1e-6)
          and tuple(fx._kron_ranks) == tuple(int(r) for r in ref['ranks']),
          f'fixture theta0 and ranks {fx._kron_ranks} as JAX\'s')
    K, dK = fx.gram(fx.theta0, eval_gradient=True)
    err = float(np.abs(K.cpu().numpy() - ref['K']).max())
    gerr = float(np.abs(dK.cpu().numpy() - ref['dK']).max())
    check(err <= 1e-4 and gerr <= 5e-3,
          f'max |K - K_jax| = {err:.3e} <= 1e-4, max |dK - dK_jax| = '
          f'{gerr:.3e} <= 5e-3 over {n} proteins')

    def faster(r):
        """The route whose every timed build beat every build of the
        other; None where they overlap (a tie, which the host's spread of
        the small sets' walls makes common near the crossover)."""
        k, s = r['kron_walls_ms'], r['stream_walls_ms']
        if max(k) < min(s):
            return 'kron'
        return 'stream' if max(s) < min(k) else None

    # KRON_MIN_N sits below every set where kron was faster and at or
    # above every set where pcg_stream was; a tie agrees with either side
    sets = ladder + rows
    wins = [r['n1n2'] for r in sets if faster(r) == 'kron']
    losses = [r['n1n2'] for r in sets if faster(r) == 'stream']
    chosen = _solver.KRON_MIN_N
    line = {'kron_min_n': {
        'chosen': chosen,
        'kron_faster_from_n1n2': min(wins) if wins else None,
        'stream_faster_up_to_n1n2': max(losses) if losses else None,
        'ties_n1n2': [r['n1n2'] for r in sets if faster(r) is None],
        'agrees_with_this_run': all(n > chosen for n in wins)
        and all(n <= chosen for n in losses),
        'walls_ms': [{'set': r['class'], 'n1n2': r['n1n2'],
                      'm_pad': r['m_pad'], 'kron': r['kron_wall_ms'],
                      'pcg_stream': r['stream_wall_ms'],
                      'faster': faster(r)} for r in sets]}}
    return rows, stream_launches, line


def twin_check(name, wrapper, reference, args, what):
    """A kernel's wrapper against its plain twin on the same operands:
    finite, and within 1e-5 max |x| of the twin. Returns max |x - x_twin|."""
    import torch
    x_k, _ = wrapper(*args)
    x_r, _ = reference(*args)
    err = float((x_k - x_r).abs().max())
    scale = float(x_r.abs().max())
    check(bool(torch.isfinite(x_k).all()) and err <= 1e-5 * scale,
          f'{what}, {args[7].shape[0]} systems: max |x_{name} - x_twin| '
          f'{err:.3e} <= 1e-5 max |x| = {1e-5 * scale:.3e}')
    return err


def batched_systems(kern, grp, idx1, idx2, theta, iters):
    """The operands that ``JobPlan.solve`` gives ``pcg_resident`` and
    ``pcg_packed`` for the jobs (idx1, idx2) of a group of ``kern``: the
    C * P systems at the C rows of ``theta`` (the full linear-scale
    vectors, [C, n_dims]), theta by theta, built as ``JobPlan.solve`` and
    ``mlgk_solve`` build them with at most ``iters`` CG steps, the tangents
    at the value solutions of ``pcg_resident``, the k tangents of a pair
    one group that shares its operator. Returns (value operands, tangent
    operands)."""
    from graphdot_tpu_torch.kernel.marginalized._solver import (
        _setup_over_thetas, mlgk_tangents)
    from graphdot_tpu_torch.ops.pcg import largest_packed_k, pcg_resident
    from graphdot_tpu_torch.util.iterable import flatten
    ops = kern._operands(grp['bd1'], grp['bd2'], idx1, idx2)
    kw = dict(knode=kern.node_kernel, kedge=kern.edge_kernel,
              n_p_theta=len(list(flatten(kern.p.theta))), mode='cuda')
    s = _setup_over_thetas(theta, ops, **kw)
    operator = [s[f].contiguous() for f in (
        'T', 'esrc_1', 'edst_1', 'esrc_2', 'edst_2', 'diag', 'precond')]
    value = operator + [s['b'].contiguous(), s['tol'], iters]
    x, _ = pcg_resident(*value)
    rhs = mlgk_tangents(theta, ops, s, x, **kw)['rhs'].contiguous()
    k = rhs.shape[1]
    M1, M2 = operator[0].shape[1:]
    check(largest_packed_k(k, M1, M2, grp['n1'], grp['n2'], x.device,
                           shared=True) == k,
          f'group ({grp["n1"]}, {grp["n2"]}): the {k} tangents of a pair are '
          'one group')
    tangent = [a[:, None] for a in operator] + [
        rhs, s['gtol'].contiguous(), min(iters * k, 16384)]
    return value, tangent


def nuts_phase(warmup=NUTS_WARMUP, draws=NUTS_DRAWS):
    """Phase 17: the Bayesian path of ``bench_nuts.py`` at full width (32
    molecules, 8 chains, ``max_depth`` 6): ``GPRLogProb`` of the 8 chains
    in one batched call against the JAX fixture, its launches, K and dK
    against single calls, ``pcg_resident`` and ``pcg_packed`` against
    their twins on the batched chunks' systems, the fixture's GP NUTS
    transition draw for draw, q >= 1, a warmup of ``warmup`` transitions
    and a resumed run of ``draws`` draws (timed as a user runs it), the
    Gram of one theta as [n] and as [1, n], and profiled Grams and a
    profiled iteration; ``value_and_grad`` at the fixture's 8 thetas gives
    the same bits twice before the sampling run and once after it. Returns
    the kernels' launches during the resumed run, their count a leapfrog
    iteration, and the resumed run's start (``lp``, ``init``,
    ``step_size``, ``inv_mass``) for phase 22."""
    import torch
    from graphdot_tpu_torch.inference import (
        GPRLogProb, HMCState, ess, nuts_step, resume_state, sample,
        split_rhat)
    from graphdot_tpu_torch.inference.gp_logprob import _mvn_logdensity
    from graphdot_tpu_torch.kernel import MarginalizedGraphKernel
    from graphdot_tpu_torch.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu_torch.ops.pcg import (
        pcg_packed, pcg_packed_reference, pcg_resident,
        pcg_resident_reference, pcg_stream)
    from graphdot_tpu_torch.testing import random_molecule_set

    counters = (pcg_resident, pcg_packed, pcg_stream)
    card = nvidia_smi()
    ref = np.load(NUTS_FIXTURE)

    def kernel():
        return MarginalizedGraphKernel(
            TensorProduct(element=KroneckerDelta(0.2)),
            TensorProduct(length=SquareExponential(0.3)), q=0.05,
            device='cuda')

    def launches():
        return {c.__name__: c.launches for c in counters}

    def reset():
        for c in counters:
            c.launches = 0

    seed, count, lo, hi = (int(v) for v in ref['bench_set'])
    t0 = t_phase = time.perf_counter()
    graphs = random_molecule_set(seed, count, n_atoms_range=(lo, hi))
    lp = GPRLogProb(kernel(), graphs, gp_targets(graphs),
                    alpha=float(ref['bench_alpha']), normalize_y=True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    plan = lp.factory._plan
    say(f'  bench_nuts.py: {count} molecules of {lo}-{hi} atoms, '
        f'{len(plan.i_jobs)} jobs in groups '
        + ', '.join(f'({g["n1"]}, {g["n2"]}) of {len(g["pos"])}'
                    for g in plan.groups)
        + f'; D = {lp.n_dims}; factory built in {t_build:.4f} s')
    check(np.allclose(ref['thetas'][0], lp.theta0.astype(np.float32)),
          'the fixture\'s first theta is theta0')

    def chunks(eval_gradient, copies):
        return sum(1 for g in plan.groups
                   for _ in plan.chunks(g, eval_gradient, copies=copies))

    C = len(ref['thetas'])
    thetas = torch.as_tensor(ref['thetas'], device='cuda')
    vg = lp.value_and_grad()
    vg(thetas)       # the first call of the vectorized setup
    reset()
    logp, grad = vg(thetas)
    torch.cuda.synchronize()
    got = launches()
    grad_chunks, value_chunks = chunks(True, C), chunks(False, C)
    logp, grad = logp.cpu().numpy(), grad.cpu().numpy()
    gtol = 1e-3 * np.abs(ref['grad']).max(axis=1) + 1e-3
    gerr = np.abs(grad - ref['grad']).max(axis=1)
    lerr = np.abs(logp - ref['logp'])
    check(np.isfinite(logp).all() and (lerr <= 1e-4 * np.abs(ref['logp'])
                                       + 1e-3).all()
          and (gerr <= gtol).all(),
          f'GPRLogProb at the fixture\'s {C} thetas, one batched call '
          f'[{C}, {lp.n_dims}]: max |logp - logp_jax| {lerr.max():.3e} '
          f'(limit 1e-4 |logp| + 1e-3), max |grad - grad_jax| per theta '
          f'{gerr.max():.3e} <= 1e-3 max |grad| + 1e-3')
    check(got['pcg_resident'] == grad_chunks
          and got['pcg_packed'] == grad_chunks and got['pcg_stream'] == 0,
          f'the batched gradient call launched pcg_resident '
          f'{got["pcg_resident"]} and pcg_packed {got["pcg_packed"]} times, '
          f'once a gradient chunk ({grad_chunks} chunks for {C} thetas; '
          f'{chunks(True, 1)} for one), pcg_stream never')
    reset()
    with torch.no_grad():
        values = lp(thetas)
    torch.cuda.synchronize()
    got = launches()
    check(got['pcg_resident'] == value_chunks and got['pcg_packed'] == 0
          and got['pcg_stream'] == 0
          and np.allclose(values.cpu().numpy(), logp, rtol=1e-6, atol=0),
          f'the batched value call launched pcg_resident '
          f'{got["pcg_resident"]} times, once a value chunk ({value_chunks} '
          f'for {C} thetas; {chunks(False, 1)} for one), and gave the same '
          'logp')
    K_batched, dK_batched = lp.factory.gram(thetas, eval_gradient=True)
    dk_scale = float(dK_batched.abs().max())
    k_err = dk_err = l_err = 0.0
    for c in range(C):
        K1, dK1 = lp.factory.gram(thetas[c], eval_gradient=True)
        k_err = max(k_err, float((K1 - K_batched[c]).abs().max()))
        dk_err = max(dk_err, float((dK1 - dK_batched[c]).abs().max()))
        with torch.no_grad():
            l1 = float(lp(thetas[c]))
        l_err = max(l_err, abs(l1 - float(logp[c])) / abs(float(logp[c])))
    check(k_err <= 1e-6 and dk_err <= 1e-6 * dk_scale and l_err <= 1e-6,
          f'{C} single calls against the batched one: max |K - K_batched| '
          f'{k_err:.3e} <= 1e-6, max |dK - dK_batched| {dk_err:.3e} <= 1e-6 '
          f'max |dK| = {1e-6 * dk_scale:.3e}, max relative logp difference '
          f'{l_err:.3e} <= 1e-6')

    # the kernels against their plain twins on the systems of the batched
    # calls: all C chains, and a live count below C (a NUTS iteration
    # evaluates only the chains whose trajectories go on)
    twin_errs = {'pcg_resident': 0.0, 'pcg_packed': 0.0}
    for rows in (list(range(C)), [1, 4, 6]):
        sub = thetas[rows]
        for eval_gradient in (False, True):
            for grp in plan.groups:
                for _, idx1, idx2 in plan.chunks(grp, eval_gradient,
                                                 copies=len(rows)):
                    value, tangent = batched_systems(
                        lp.factory.kernel, grp, idx1, idx2,
                        lp.factory.full_theta(sub),
                        lp.factory._group_maxiter(grp))
                    pairs = [('pcg_resident', pcg_resident,
                              pcg_resident_reference, value)]
                    if eval_gradient:
                        pairs.append(('pcg_packed', pcg_packed,
                                      pcg_packed_reference, tangent))
                    kind = 'gradient' if eval_gradient else 'value'
                    for name, wrapper, reference, args in pairs:
                        twin_errs[name] = max(twin_errs[name], twin_check(
                            name, wrapper, reference, args,
                            f'C = {len(rows)}, group ({grp["n1"]}, '
                            f'{grp["n2"]}), {kind} chunk of {len(idx1)} '
                            'pairs'))
    say('  the batched systems against the twins: max |x - x_twin| '
        + ', '.join(f'{k} {v:.3e}' for k, v in twin_errs.items()))

    # the fixture's GP NUTS transition (gp_problem), with JAX's draws
    seed, count, lo, hi = (int(v) for v in ref['gp_set'])
    small = random_molecule_set(seed, count, n_atoms_range=(lo, hi))
    lp_small = GPRLogProb(kernel(), small, np.random.default_rng(1).normal(
        size=count), alpha=float(ref['gp_alpha']))

    def f(name, dtype=torch.float32):
        return torch.as_tensor(ref[name], dtype=dtype, device='cuda')

    state = HMCState(q=f('nuts_q0')[None], logp=f('nuts_logp0')[None],
                     grad=f('nuts_grad0')[None])
    step_draws = {'p0': f('nuts_p0'),
                  'direction': f('nuts_direction', torch.bool),
                  'within': f('nuts_within'), 'merge': f('nuts_merge')}
    state, info = nuts_step(step_draws, state, lp_small,
                            float(ref['nuts_step']), f('nuts_inv_mass'),
                            max_depth=int(ref['nuts_max_depth']))
    q_err = float(np.abs(state.q[0].cpu().numpy() - ref['nuts_q']).max())
    a_err = abs(float(info['accept_prob'][0]) - float(ref['nuts_accept']))
    check(int(info['n_leapfrog'][0]) == int(ref['nuts_n_leapfrog'])
          and int(info['depth'][0]) == int(ref['nuts_depth'])
          and bool(info['divergent'][0]) == bool(ref['nuts_divergent'])
          and q_err <= 1e-4 and a_err <= 1e-4,
          f'the fixture\'s GP NUTS transition ({count} molecules) with '
          f'JAX\'s draws: n_leapfrog {int(info["n_leapfrog"][0])}, depth '
          f'{int(info["depth"][0])}, divergent '
          f'{bool(info["divergent"][0])} as JAX; max |q - q_jax| '
          f'{q_err:.3e} <= 1e-4, |accept - accept_jax| {a_err:.3e} <= 1e-4')

    # out of the model's domain: q >= 1
    cap = max(lp_small.factory._group_maxiter(g)
              for g in lp_small.factory._plan.groups)
    t0 = time.perf_counter()
    ood_logp, ood_grad = lp_small.value_and_grad()(
        torch.as_tensor(ref['ood_theta'], device='cuda'))
    torch.cuda.synchronize()
    t_ood = time.perf_counter() - t0
    finite = np.isfinite(ood_logp.cpu().numpy())
    check(np.array_equal(finite, ref['ood_finite']) and cap <= 64,
          f'q = {np.exp(ref["ood_theta"][:, 1]).tolist()}: logp '
          f'{ood_logp.cpu().numpy().tolist()}, finite {finite.tolist()} as '
          f'JAX\'s; the call returned in {t_ood:.4f} s at <= {cap} CG steps '
          'a solve')

    # the log density repeats bit for bit: no call leaves state behind
    # that changes the next, and the card sums in a fixed order
    first_vg = vg(thetas)
    again = vg(thetas)
    check(torch.equal(first_vg[0], again[0])
          and torch.equal(first_vg[1], again[1]),
          f'value_and_grad at the fixture\'s {C} thetas, twice: the same '
          'bits')

    # the sampling run, as bench_nuts.py: a warmup, then a resumed run.
    # The sampler gets the log density as a user passes it, in a wrapper
    # that only counts its calls (one a leapfrog iteration) and their rows
    say(f'  checks done {time.perf_counter() - t_phase:.1f} s into the '
        'phase')
    evals = {'calls': 0, 'rows': 0}

    def counted(t):
        evals['calls'] += 1
        evals['rows'] += t.shape[0]
        return lp(t)

    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    out = sample(counted, gen, n_chains=NUTS_CHAINS, n_warmup=warmup,
                 n_samples=2, init=lp.theta0, max_depth=NUTS_MAX_DEPTH,
                 init_jitter=NUTS_JITTER, device='cuda')
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    init2, step_size, inv_mass = resume_state(out)
    say(f'  warmup of {warmup} transitions and 2 draws: {t_warm:.3f} s, '
        f'{evals["calls"]} log-density calls; step size {step_size:.5f}, '
        f'inverse mass {inv_mass.tolist()}')
    evals.update(calls=0, rows=0)
    reset()
    t0 = time.perf_counter()
    out2 = sample(counted, gen, n_chains=NUTS_CHAINS, n_samples=draws,
                  init=init2, step_size=step_size, inv_mass=inv_mass,
                  max_depth=NUTS_MAX_DEPTH, device='cuda')
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    run_launches = launches()
    iters, rows = evals['calls'], evals['rows']
    s = out2['samples'].cpu().numpy()
    sd = s.std(axis=1)
    accept = float(out2['accept_prob'].mean())
    rhat, bulk = split_rhat(s), ess(s)
    check(s.shape == (NUTS_CHAINS, draws, lp.n_dims)
          and np.isfinite(s).all(),
          f'{NUTS_CHAINS} chains x {draws} draws, all finite')
    check((sd > 1e-6).all(),
          f'every chain moves in every dimension: least standard deviation '
          f'{sd.min():.3e} > 1e-6')
    check(abs(accept - NUTS_TARGET) <= 0.15,
          f'mean accept_prob {accept:.4f} within 0.15 of {NUTS_TARGET}')
    check(run_launches['pcg_stream'] == 0 and run_launches['pcg_resident']
          >= iters and run_launches['pcg_packed'] >= iters,
          'every leapfrog iteration launched pcg_resident and pcg_packed, '
          'pcg_stream never')
    after = vg(thetas)
    check(torch.equal(first_vg[0], after[0])
          and torch.equal(first_vg[1], after[1]),
          f'value_and_grad at the {C} thetas after the sampling run: the '
          'bits of the first call')
    say(f'  split-R-hat {np.round(rhat, 4).tolist()}, bulk ESS '
        f'{np.round(bulk, 2).tolist()}, divergent share '
        f'{float(out2["divergent"].float().mean()):.4f}')
    say(f'  [{card}] {draws} draws of {NUTS_CHAINS} chains in {dt:.4f} s: '
        f'{NUTS_CHAINS * draws / dt:.4f} draws/s, min bulk ESS '
        f'{bulk.min():.2f}, {bulk.min() / dt:.4f} min-bulk-ESS/s')
    say(f'  [{card}] time to first draw (factory build and warmup): '
        f'{t_build + t_warm:.3f} s ({t_build:.4f} + {t_warm:.3f})')
    say(f'  [{card}] {iters} leapfrog iterations in {dt:.4f} s: '
        f'{iters / dt:.4f} iterations/s, {dt / iters * 1e3:.3f} ms an '
        f'iteration, {rows / iters:.4f} live chains an iteration mean; '
        'launches an iteration: ' + ', '.join(
            f'{k} {v / iters:.4f}' for k, v in run_launches.items()))

    # the Gram of one theta as [n] and as [1, n] in turns, and of the C
    # chains, by wall
    walls = {}
    for _ in range(NUTS_TURNS):
        for key, t in (('[n]', thetas[0]), ('[1, n]', thetas[:1]),
                       (f'[{C}, n]', thetas)):
            for grad in (False, True):
                t0 = time.perf_counter()
                lp.factory.gram(t, eval_gradient=grad)
                torch.cuda.synchronize()
                walls.setdefault((key, grad), []).append(
                    time.perf_counter() - t0)
    for (key, grad), ws in walls.items():
        ws = np.array(ws) * 1e3
        say(f'  [{card}] {"gradient" if grad else "value"} Gram of theta '
            f'{key}: median {np.median(ws):.3f} ms, min {ws.min():.3f}, max '
            f'{ws.max():.3f} over {len(ws)} in turns (' + ', '.join(
                f'{w:.3f}' for w in ws) + ')')
    K, dK = lp.factory.gram(thetas, eval_gradient=True)
    density = []
    for _ in range(5):
        t0 = time.perf_counter()
        Kg = K.detach().requires_grad_(True)
        value = _mvn_logdensity(Kg, lp._y, lp.alpha)
        gK, = torch.autograd.grad(value.sum(), Kg)
        torch.sum(gK[..., None] * dK, dim=(-3, -2))
        torch.cuda.synchronize()
        density.append(time.perf_counter() - t0)
    say(f'  [{card}] the float64 density and its chain rule for {C} thetas: '
        f'median {np.median(density) * 1e3:.3f} ms over 5')
    profile_build(lambda: lp.factory.gram(thetas[0], eval_gradient=True),
                  'gradient Gram of theta [n]')
    profile_build(lambda: lp.factory.gram(thetas[:1], eval_gradient=True),
                  'gradient Gram of theta [1, n]')
    profile_build(lambda: vg(thetas), f'NUTS iteration ({C} chains)')
    resume = {'lp': lp, 'init': init2, 'step_size': step_size,
              'inv_mass': inv_mass}
    return (run_launches, {k: v / iters for k, v in run_launches.items()},
            resume)

def d_limit(a, b):
    """The limit on a distance matrix of phases 18-19: 1e-4 where both
    sides' distance exceeds 0.01, else 5e-3 (the sqrt of d = sqrt(1 -
    ratio) turns a 1e-6 error of the ratio into ~1e-3 near d = 0)."""
    return np.where((a > 0.01) & (b > 0.01), 1e-4, 5e-3)


def nodal_distances(R, sizes):
    """Every pair's nodal distance matrix from a nodal Gram R, in float64:
    {(a, b): sqrt(max(0, 1 - R_ab / sqrt(diag_a diag_b^T)))}."""
    starts = np.concatenate([[0], np.cumsum(sizes)])
    diag = np.diagonal(R)
    out = {}
    for a in range(len(sizes)):
        for b in range(len(sizes)):
            k12 = R[starts[a]:starts[a + 1], starts[b]:starts[b + 1]]
            out[a, b] = np.sqrt(np.maximum(0, 1 - k12 / np.sqrt(np.outer(
                diag[starts[a]:starts[a + 1]],
                diag[starts[b]:starts[b + 1]]))))
    return out


def maximin_chunks(metric, graphs, eval_gradient):
    """The chunks of ``metric(graphs, eval_gradient=...)``, built as its
    call builds them: (self-similarity chunks, value chunks, hotspot
    chunks); each launches the value kernel once, and with
    ``eval_gradient`` the self and hotspot chunks launch ``pcg_packed``
    once too."""
    from graphdot_tpu_torch.kernel.marginalized._kernel import JobPlan
    n = len(graphs)
    jobs = np.arange(n)
    i, j = np.triu_indices(n)
    own = JobPlan(metric, graphs, jobs, jobs, metric.buckets)
    plan = JobPlan(metric, graphs, i, j, metric.buckets)

    def count(p, grad, nodal):
        return sum(1 for g in p.groups for _ in p.chunks(g, grad, nodal))
    return (count(own, eval_gradient, True), count(plan, False, True),
            count(plan, True, False) if eval_gradient else 0)


def maximin_phase():
    """Phase 18: the path of ``bench_maximin.py`` at full width (128
    molecules of 9-24 atoms, 8256 pairs): ``MaxiMin.__call__`` with and
    without the hotspot gradient and ``device_distance_fn`` on the card,
    against ``backend='edge'``, a float64 brute force, the JAX fixture; the
    launches of each call; pairs/s of ``device_distance_fn``, the walls of
    ``__call__`` and profiled calls. Returns the kernels' launches by
    call."""
    import torch
    from graphdot_tpu_torch.kernel import MarginalizedGraphKernel
    from graphdot_tpu_torch.kernel.marginalized._kernel import JobPlan
    from graphdot_tpu_torch.metric import MaxiMin
    from graphdot_tpu_torch.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu_torch.ops.pcg import (
        pcg_packed, pcg_packed_reference, pcg_resident,
        pcg_resident_reference, pcg_stream)
    from graphdot_tpu_torch.testing import random_molecule_set

    counters = (pcg_resident, pcg_packed, pcg_stream)
    card = nvidia_smi()

    def launches():
        return {c.__name__: c.launches for c in counters}

    def reset():
        for c in counters:
            c.launches = 0

    def make(backend='auto'):
        return MaxiMin(TensorProduct(element=KroneckerDelta(0.2)),
                       TensorProduct(length=SquareExponential(0.3)),
                       q=0.05, backend=backend, device='cuda')

    seed, count, atoms = MAXIMIN_SET
    graphs = random_molecule_set(seed, count, n_atoms_range=atoms)
    sizes = np.array([len(g.nodes) for g in graphs])
    n_pairs = count * (count + 1) // 2
    off = ~np.eye(count, dtype=bool)
    metric = make()
    own, value, _ = maximin_chunks(metric, graphs, False)
    own_grad, _, hot = maximin_chunks(metric, graphs, True)
    say(f'  bench_maximin.py: {count} molecules of {atoms[0]}-{atoms[1]} '
        f'atoms, {n_pairs} pairs; chunks: {own} self, {value} value, '
        f'{hot} hotspot-gradient ({own_grad} self with gradients)')

    reset()
    D, (h1, h2) = metric(graphs, return_hotspot=True)
    torch.cuda.synchronize()
    value_launches = launches()
    check(value_launches == {'pcg_resident': own + value, 'pcg_packed': 0,
                             'pcg_stream': 0},
          f'metric(graphs) launched {value_launches}: pcg_resident once a '
          f'self and a value chunk ({own} + {value}), nothing else')
    check(D.shape == (count, count) and np.isfinite(D).all()
          and np.array_equal(D, D.T) and np.abs(np.diag(D)).max() <= 5e-3,
          f'D finite, symmetric, max |diag| {np.abs(np.diag(D)).max():.3e} '
          '<= 5e-3 (bench_maximin.py\'s limit)')
    check((h1 >= 0).all() and (h1 < sizes[:, None]).all()
          and (h2 >= 0).all() and (h2 < sizes[None, :]).all(),
          'every hotspot within its graphs\' nodes')
    D_edge = make('edge')(graphs)
    err = np.abs(D - D_edge)
    check((err <= d_limit(D, D_edge))[off].all(),
          f'off the diagonal within the D limit of backend=\'edge\': max '
          f'|D - D_edge| {err[off].max():.3e} (where both d > 0.01: '
          f'{err[off & (D > 0.01) & (D_edge > 0.01)].max():.3e} <= 1e-4)')

    fn, theta0 = metric.device_distance_fn(graphs)
    reset()
    D_fn = fn(theta0)
    torch.cuda.synchronize()
    fn_launches = launches()
    check(fn_launches == {'pcg_resident': value, 'pcg_packed': 0,
                          'pcg_stream': 0},
          f'device_distance_fn launched {fn_launches}: pcg_resident once a '
          f'value chunk ({value}), nothing else')
    D_fn = D_fn.cpu().numpy()
    err = np.abs(D_fn - D)
    check(np.isfinite(D_fn).all() and (err <= d_limit(D_fn, D)).all(),
          f'device_distance_fn within the D limit of __call__: max |D_fn - '
          f'D| {err.max():.3e}')

    b = MAXIMIN_BRUTE
    R = MarginalizedGraphKernel(
        metric.node_kernel, metric.edge_kernel, q=metric.q,
        device='cuda')(graphs[:b], nodal=True).astype(np.float64)
    nodal = nodal_distances(R, sizes[:b])
    D_bf = np.array([[max(nodal[x, y].min(axis=1).max(),
                          nodal[x, y].min(axis=0).max())
                      for y in range(b)] for x in range(b)])
    for name, M in (('__call__', D[:b, :b]),
                    ('device_distance_fn', D_fn[:b, :b])):
        err = np.abs(M - D_bf)
        check((err <= d_limit(M, D_bf)).all(),
              f'{name} over the first {b} graphs within the D limit of a '
              f'float64 brute force over kernel(G, nodal=True): max |D - '
              f'D_brute| {err.max():.3e}')
    at_hot = np.array([[nodal[x, y][h1[x, y], h2[x, y]] for y in range(b)]
                       for x in range(b)])
    err = np.abs(at_hot - D[:b, :b])
    check((err <= d_limit(at_hot, D[:b, :b])).all(),
          f'the brute force\'s nodal distance at each hotspot is D: max '
          f'|d(hotspot) - D| {err.max():.3e}')
    # a pair's hotspot is clear where its top two distinct candidate
    # distances (row and column minima) differ by more than 1e-4
    clear = np.zeros((b, b), dtype=bool)
    for (x, y), d in nodal.items():
        top = np.unique(np.concatenate([d.min(axis=1), d.min(axis=0)]))
        clear[x, y] = len(top) < 2 or top[-1] - top[-2] > 1e-4

    reset()
    D_g, (g1, g2), dD = metric(graphs, return_hotspot=True,
                               eval_gradient=True)
    torch.cuda.synchronize()
    grad_launches = launches()
    check(grad_launches == {'pcg_resident': own_grad + value + hot,
                            'pcg_packed': own_grad + hot, 'pcg_stream': 0},
          f'metric(graphs, eval_gradient=True) launched {grad_launches}: '
          f'pcg_resident once a self, value and hotspot chunk ({own_grad} + '
          f'{value} + {hot}), pcg_packed once a self and hotspot chunk')
    err = float(np.abs(D_g - D).max())
    check(dD.shape == (count, count, len(metric.theta))
          and np.isfinite(dD).all() and err <= 1e-6,
          f'dD {list(dD.shape)} finite; D within 1e-6 of the value call\'s '
          f'({err:.3e})')
    D_ge, (e1, e2), dD_e = make('edge')(graphs, return_hotspot=True,
                                        eval_gradient=True)
    agree = (g1 == e1) & (g2 == e2) & off
    limit = 1e-3 * np.abs(dD_e).max() + 1e-4
    err = np.abs(dD - dD_e)[agree].max()
    check(agree.sum() >= 0.95 * off.sum() and err <= limit,
          f'hotspots as edge\'s at {agree.sum()} of {off.sum()} pairs off '
          f'the diagonal (>= 0.95), dD there within 1e-3 max |dD| + 1e-4 = '
          f'{limit:.3e} of edge: {err:.3e}')

    # the kernels against their plain twins on this path's own chunks:
    # the first and the last value chunk (nodal) and hotspot-gradient
    # chunk of the call's plan, one batch padded to the largest graph
    plan = JobPlan(metric, graphs, *np.triu_indices(count), metric.buckets)
    theta = metric._theta_vector()[None]
    for grp in plan.groups:
        iters = metric.maxiter(max(grp['n1'], grp['n2']))
        for eval_gradient, nodal in ((False, True), (True, False)):
            chunks = list(plan.chunks(grp, eval_gradient, nodal))
            for s, idx1, idx2 in {chunks[0][0]: chunks[0],
                                  chunks[-1][0]: chunks[-1]}.values():
                value, tangent = batched_systems(metric, grp, idx1, idx2,
                                                 theta, iters)
                what = (f'maximin group ({grp["n1"]}, {grp["n2"]}), '
                        f'{"hotspot-gradient" if eval_gradient else "value"}'
                        f' chunk at {s} of {len(idx1)} pairs')
                if eval_gradient:
                    twin_check('pcg_packed', pcg_packed,
                               pcg_packed_reference, tangent, what)
                else:
                    twin_check('pcg_resident', pcg_resident,
                               pcg_resident_reference, value, what)

    ref = np.load(MAXIMIN_FIXTURE)
    f = len(ref['D'])
    offf = ~np.eye(f, dtype=bool)
    check(tuple(ref['bench_set']) == (seed, f, *atoms) and f <= b,
          f'the JAX fixture covers the first {f} of these graphs')
    for name, M, J in (('D', D[:f, :f], ref['D']),
                       ('device_distance_fn', D_fn[:f, :f], ref['D_fn'])):
        err = np.abs(M - J)
        check((err <= d_limit(M, J))[offf].all(),
              f'{name} within the D limit of JAX\'s off the diagonal: max '
              f'{err[offf].max():.3e}')
    # dD off the diagonal only: at d = 0 (the sqrt's kink) the gradient
    # divides the ratio's rounding by d + 1e-4
    jagree = (h1[:f, :f] == ref['h1']) & (h2[:f, :f] == ref['h2'])
    jlimit = 1e-3 * np.abs(ref['dD']).max() + 1e-4
    err = np.abs(dD[:f, :f] - ref['dD'])
    check(jagree[clear[:f, :f]].all()
          and err[jagree & offf].max() <= jlimit,
          f'hotspots as JAX\'s at all {clear[:f, :f].sum()} pairs with a '
          f'clear hotspot (top two distinct candidates 1e-4 apart; '
          f'{jagree.sum()} of {f * f} agree), dD there off the diagonal '
          f'within {jlimit:.3e}: {err[jagree & offf].max():.3e} (on the '
          f'diagonal {err[~offf].max():.3e})')

    # timings: device_distance_fn by CUDA events, one call at a time
    fn(theta0)
    torch.cuda.synchronize()
    ms = []
    for _ in range(MAXIMIN_FN_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(theta0)
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
    med = float(np.median(ms))
    say(f'  [{card}] device_distance_fn over {count} molecules ({n_pairs} '
        f'pairs): median {med:.3f} ms by CUDA events over {len(ms)} calls '
        f'(min {min(ms):.3f}, max {max(ms):.3f}): {n_pairs / med * 1e3:.1f} '
        'pairs/s')
    walls = {False: [], True: []}
    for _ in range(MAXIMIN_REPEATS):
        for grad in (False, True):
            t0 = time.perf_counter()
            metric(graphs, eval_gradient=grad)
            torch.cuda.synchronize()
            walls[grad].append((time.perf_counter() - t0) * 1e3)
    for grad, ws in walls.items():
        say(f'  [{card}] metric(graphs{", eval_gradient=True" if grad else ""}'
            f'): min {min(ws):.3f} ms over {len(ws)} in turns ('
            + ', '.join(f'{w:.3f}' for w in ws) + ')')
    profile_build(lambda: fn(theta0), 'device_distance_fn')
    host_v, host_g = {}, {}
    wall_v, _ = profile_build(lambda: metric(graphs), 'MaxiMin value',
                              host_v)
    wall_g, _ = profile_build(lambda: metric(graphs, eval_gradient=True),
                              'MaxiMin gradient', host_g)
    solves = sum(v for k, v in host_v.items() if k.startswith('mlgk_'))
    say(f'  value call: host {host_v.get("maximin_reduce", 0.0):.3f} ms in '
        f'the reduction against {solves:.3f} ms in the solver\'s phases')
    tangents = host_g.get('mlgk_tangents', 0.0)
    say(f'  gradient call: host mlgk_tangents {tangents:.3f} ms, '
        f'{tangents / wall_g:.4f} of the profiled wall {wall_g:.3f} ms; '
        f'host {host_g.get("maximin_reduce", 0.0):.3f} ms in the reduction')
    return {'value': value_launches, 'device_distance_fn': fn_launches,
            'gradient': grad_launches}


def atoms_phase():
    """Phase 19: graphs from atoms. The QM7 surrogate's 100 molecules
    through ``Graph.from_ase``: their normalized Gram (factory route)
    against ``edge``, MaxiMin over the first 32 against ``edge``, ``M3`` on
    the card against its scipy solve, and ``KernelOverMetric`` over MaxiMin
    with its gradient against central differences. Returns the kernels' launches during the Gram."""
    import torch
    from graphdot_tpu_torch.dataset.qm7_fixture import load_qm7
    from graphdot_tpu_torch.experimental.metric import M3
    from graphdot_tpu_torch.graph import Graph
    from graphdot_tpu_torch.kernel import (
        MarginalizedGraphKernel, Normalization)
    from graphdot_tpu_torch.kernel._kernel_over_metric import (
        KernelOverMetric)
    from graphdot_tpu_torch.metric import MaxiMin
    from graphdot_tpu_torch.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu_torch.ops.pcg import (
        pcg_packed, pcg_resident, pcg_stream)

    counters = (pcg_resident, pcg_packed, pcg_stream)

    def make(cls=MarginalizedGraphKernel, backend='auto'):
        """The kernel of tests/test_qm7_parity.py on the card."""
        return cls(TensorProduct(element=KroneckerDelta(0.3)),
                   TensorProduct(length=SquareExponential(0.3)), q=0.05,
                   backend=backend, device='cuda')

    mols, _, source = load_qm7()
    t0 = time.perf_counter()
    graphs = Graph.unify_datatype([Graph.from_ase(m, use_pbc=False)
                                   for m in mols])
    t_graphs = time.perf_counter() - t0
    sizes = [len(g.nodes) for g in graphs]
    edges = [len(g.edges) for g in graphs]
    check(source == 'surrogate' and len(graphs) == 100,
          f'{len(graphs)} molecules of the QM7 surrogate through '
          f'Graph.from_ase in {t_graphs:.3f} s: {min(sizes)}-{max(sizes)} '
          f'atoms, {min(edges)}-{max(edges)} edges')
    for c in counters:
        c.launches = 0
    K = Normalization(make())(graphs)
    torch.cuda.synchronize()
    gram_launches = {c.__name__: c.launches for c in counters}
    K_edge = Normalization(make(backend='edge'))(graphs)
    err = float(np.abs(K - K_edge).max())
    sym = float(np.abs(K - K.T).max())
    diag = float(np.abs(np.diag(K) - 1).max())
    check(np.isfinite(K).all() and diag <= 1e-6 and sym <= 1e-12
          and err <= 1e-6
          and gram_launches['pcg_resident'] + gram_launches['pcg_stream'] > 0,
          f'the normalized Gram [{len(graphs)}, {len(graphs)}] finite, '
          f'symmetric (max |K - K^T| {sym:.1e} <= 1e-12), unit diagonal (max '
          f'|K_ii - 1| {diag:.1e} <= 1e-6); max |K - K_edge| {err:.3e} <= '
          f'1e-6; launches {gram_launches}')

    sub = graphs[:ATOMS_MAXIMIN]
    D = make(MaxiMin)(sub)
    D_edge = make(MaxiMin, 'edge')(sub)
    err = np.abs(D - D_edge)
    check(np.isfinite(D).all() and (err <= d_limit(D, D_edge)).all(),
          f'MaxiMin over the first {len(sub)}: within the D limit of edge, '
          f'max |D - D_edge| {err.max():.3e}')

    m3 = M3(q=0.05, device='cuda')
    for a, b in ((0, 1), (2, 7), (11, 11)):
        g1, g2 = m3._graphs(mols[a], mols[b])
        R_scipy = [m3._mlgk(x, y) for x, y in ((g1, g1), (g1, g2), (g2, g2))]
        n1 = len(g1.nodes)
        R = m3.kernel([g1, g2], nodal=True)
        top, low = slice(n1), slice(n1, None)
        pairs = [(r, R[b]) for r, b in zip(
            R_scipy, ((top, top), (top, low), (low, low)))]
        err = max(float(np.abs(r - k).max()) for r, k in pairs)
        ok = all(np.allclose(r, k, rtol=1e-4, atol=1e-5) for r, k in pairs)
        d = m3(mols[a], mols[b])
        d_scipy = M3._maximin(np.diagonal(R_scipy[0]), R_scipy[1],
                              np.diagonal(R_scipy[2]))
        check(ok and abs(d - d_scipy) <= d_limit(d, d_scipy),
              f'M3 ({a}, {b}) on the card: the nodal R of its kernel within '
              f'rtol 1e-4, atol 1e-5 of scipy\'s sparse CG (max |dR| '
              f'{err:.3e}); distance {d:.6f} within the D limit of the '
              f'scipy route\'s {d_scipy:.6f}')

    kom = KernelOverMetric(make(MaxiMin), 'v * exp(-d**2 / (2 * s**2))',
                           'd', v=1.0, s=1.0)
    few = graphs[:ATOMS_KOM]
    K, dK = kom(few, eval_gradient=True)
    theta0 = kom.theta.copy()
    off = ~np.eye(len(few), dtype=bool)
    worst = 0.0
    for i in range(len(theta0)):
        tp, tm = theta0.copy(), theta0.copy()
        tp[i] += ATOMS_FD_STEP
        tm[i] -= ATOMS_FD_STEP
        kom.theta = tp
        Kp = kom(few)
        kom.theta = tm
        Km = kom(few)
        kom.theta = theta0
        fd = (Kp - Km) / (2 * ATOMS_FD_STEP) / np.exp(theta0[i])
        ok = np.abs(dK[:, :, i] - fd) <= 0.05 + 0.1 * np.abs(fd)
        worst = max(worst, float(np.abs(dK[:, :, i] - fd)[off].max()))
        check(ok[off].all(), f'KernelOverMetric over {len(few)} molecules: '
              f'dK / d theta[{i}] within rtol 0.1, atol 0.05 of central '
              'differences off the diagonal')
    check(np.isfinite(K).all() and np.isfinite(dK).all(),
          f'KernelOverMetric K and dK {list(dK.shape)} finite; max |dK - '
          f'fd| off the diagonal {worst:.3e}')
    return gram_launches


def models_kernel(backend='auto'):
    """The Tang-style normalized kernel of phases 20-21 on the card:
    ``KroneckerDelta(0.2)`` on element, ``SquareExponential(0.3)`` on
    length, q = 0.05."""
    from graphdot_tpu_torch.kernel import (
        MarginalizedGraphKernel, Normalization)
    from graphdot_tpu_torch.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    return Normalization(MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)), q=0.05,
        backend=backend, device='cuda'))


def launch_counts():
    """Reset and read the PCG kernels' launch counters: returns a function
    giving {name: launches since the reset}."""
    from graphdot_tpu_torch.ops.pcg import (
        pcg_packed, pcg_resident, pcg_stream)
    counters = (pcg_resident, pcg_packed, pcg_stream)
    for c in counters:
        c.launches = 0

    def read():
        import torch
        torch.cuda.synchronize()
        return {c.__name__: c.launches for c in counters}
    return read


def factory_twin_checks(kernel, factory, what):
    """``pcg_resident`` and ``pcg_packed`` against their plain twins on the
    first and the last value chunk and gradient (tangent) chunk of each
    group of a factory's plan, the systems built as the factory's gram
    builds them (``batched_systems``)."""
    from graphdot_tpu_torch.ops.pcg import (
        pcg_packed, pcg_packed_reference, pcg_resident,
        pcg_resident_reference)
    plan = factory._plan
    theta = kernel._theta_vector()[None]
    for grp in plan.groups:
        iters = factory._group_maxiter(grp)
        for gradient in (False, True):
            chunks = list(plan.chunks(grp, gradient))
            for s, idx1, idx2 in {chunks[0][0]: chunks[0],
                                  chunks[-1][0]: chunks[-1]}.values():
                value, tangent = batched_systems(kernel, grp, idx1, idx2,
                                                 theta, iters)
                where = (f'{what} group ({grp["n1"]}, {grp["n2"]}), '
                         f'{"tangent" if gradient else "value"} chunk at '
                         f'{s} of {len(chunks)}')
                if gradient:
                    twin_check('pcg_packed', pcg_packed,
                               pcg_packed_reference, tangent, where)
                else:
                    twin_check('pcg_resident', pcg_resident,
                               pcg_resident_reference, value, where)


def models_fixture_case(ref):
    """The 24-graph case of ``tests/fixtures/torch_port_models_ref.npz`` on
    the card: the core by the drafter, the Nystrom LML and gradient at
    theta0 and the predictions of the held-out graphs, held by the limits
    of ``tests/test_torch_lowrank_models.py``."""
    from graphdot_tpu_torch.model.active_learning import (
        HierarchicalDrafter, VarianceMinimizer)
    from graphdot_tpu_torch.model.gaussian_process import (
        LowRankApproximateGPR)
    from graphdot_tpu_torch.testing import random_molecule_set
    seed, count, lo, hi = (int(v) for v in ref['graph_set'])
    n_train, n_core = int(ref['n_train']), int(ref['n_core'])
    graphs = random_molecule_set(seed, count, (lo, hi))
    y = gp_targets(graphs)
    train = graphs[:n_train]
    kernel = models_kernel()
    core = HierarchicalDrafter(VarianceMinimizer(kernel))(
        train, n_core, random_state=0)
    model = LowRankApproximateGPR(kernel, alpha=float(ref['alpha']),
                                  normalize_y=True, device='cuda')
    model.fit([train[i] for i in core], train, y[:n_train])
    lml, grad = model.log_marginal_likelihood(eval_gradient=True)
    mean, std = model.predict(graphs[n_train:], return_std=True)
    gtol = 1e-3 * float(np.abs(ref['grad']).max()) + 1e-3
    check(np.array_equal(core, ref['core']) and np.array_equal(y, ref['y'])
          and abs(lml - ref['lml']) <= 1e-4 * abs(ref['lml'])
          and float(np.abs(grad - ref['grad']).max()) <= gtol
          and np.allclose(mean, ref['mean'], rtol=1e-4, atol=0)
          and float(np.abs(std - ref['std']).max()) <= 1e-4,
          f'the JAX fixture\'s {count}-graph case: core {core.tolist()} as '
          f'JAX\'s, LML {lml:.6f} vs {float(ref["lml"]):.6f} (rtol 1e-4), '
          'max |grad - grad_jax| '
          f'{float(np.abs(grad - ref["grad"]).max()):.3e} <= {gtol:.3e}, '
          'means rtol 1e-4 (max rel '
          f'{float(np.abs(mean / ref["mean"] - 1).max()):.2e}), max |std - '
          f'std_jax| {float(np.abs(std - ref["std"]).max()):.2e} <= 1e-4')


def nystrom_phase():
    """Phase 20: the Tang & de Jong 2019 workflow with Nystrom at full
    size. ``HierarchicalDrafter(VarianceMinimizer(kernel))`` picks the core
    from the training graphs, ``LowRankApproximateGPR`` fits with L-BFGS-B
    (every evaluation a two-sided gradient Gram of the training graphs
    against the core and the core's own, through factories cached by the
    kernel), then predicts the held-out graphs and runs ``predict_loocv``.
    Checks the LML and gradient against ``backend='edge'``, the kernels
    against their twins on the path's own chunks, the full-rank case
    against the exact GPR and the JAX fixture. Returns the kernels'
    launches by step (drafter, fit, predict)."""
    import torch
    from graphdot_tpu_torch.inference import gram as gram_module
    from graphdot_tpu_torch.model.active_learning import (
        HierarchicalDrafter, VarianceMinimizer)
    from graphdot_tpu_torch.model.gaussian_process import (
        GaussianProcessRegressor, LowRankApproximateGPR)
    from graphdot_tpu_torch.testing import random_molecule_set

    card = nvidia_smi()
    seed, count, atoms = NYSTROM_SET
    pool = random_molecule_set(seed, count, atoms)
    y = gp_targets(pool)
    train, held = pool[:NYSTROM_TRAIN], pool[NYSTROM_TRAIN:]
    y_train = y[:NYSTROM_TRAIN]
    n_cross = NYSTROM_TRAIN * NYSTROM_CORE
    n_core_pairs = NYSTROM_CORE * (NYSTROM_CORE + 1) // 2
    say(f'  pool random_molecule_set{(seed, count, atoms)}: '
        f'{NYSTROM_TRAIN} training, {count - NYSTROM_TRAIN} held out; core '
        f'{NYSTROM_CORE}: an evaluation solves {n_cross} cross pairs and '
        f'{n_core_pairs} core pairs, 4 tangents each')
    kernel = models_kernel()
    launches = {}

    read = launch_counts()
    t0 = time.perf_counter()
    core_idx = HierarchicalDrafter(VarianceMinimizer(kernel))(
        train, NYSTROM_CORE, random_state=0)
    drafter_s = time.perf_counter() - t0
    launches['drafter'] = read()
    check(len(core_idx) == NYSTROM_CORE
          and len(set(core_idx.tolist())) == NYSTROM_CORE
          and bool(np.all(np.diff(core_idx) > 0))
          and launches['drafter']['pcg_resident'] > 0
          and launches['drafter']['pcg_stream'] == 0,
          f'[{card}] the drafter picked {NYSTROM_CORE} distinct sorted '
          f'graphs of {NYSTROM_TRAIN} in {drafter_s:.3f} s; launches '
          f'{launches["drafter"]}')
    core = [train[i] for i in core_idx]

    model = LowRankApproximateGPR(kernel, alpha=NYSTROM_ALPHA,
                                  normalize_y=True, optimizer=True,
                                  device='cuda')
    model.C, model.X, model.y = core, train, y_train
    theta0 = model.kernel.theta.copy()
    t0 = time.perf_counter()
    lml0, grad0 = model.log_marginal_likelihood(eval_gradient=True)
    first_s = time.perf_counter() - t0
    edge = LowRankApproximateGPR(models_kernel('edge'), alpha=NYSTROM_ALPHA,
                                 normalize_y=True, device='cuda')
    edge.C, edge.X, edge.y = core, train, y_train
    t0 = time.perf_counter()
    lml_e, grad_e = edge.log_marginal_likelihood(eval_gradient=True)
    edge_s = time.perf_counter() - t0
    gtol = 1e-3 * float(np.abs(grad_e).max()) + 1e-5
    check(abs(lml0 - lml_e) <= 1e-4 * abs(lml_e)
          and float(np.abs(grad0 - grad_e).max()) <= gtol,
          f'at theta0 the negative LML {lml0:.6f} vs edge {lml_e:.6f} (rtol '
          f'1e-4), max |grad - grad_edge| '
          f'{float(np.abs(grad0 - grad_e).max()):.3e} <= {gtol:.3e} (first '
          f'evaluation {first_s:.3f} s with the factories\' build, edge '
          f'{edge_s:.3f} s)')
    inner = kernel.kernel
    cross = inner._get_call_factory(model.X, core)
    own = inner._get_call_factory(core, None)
    factory_twin_checks(inner, cross, 'Kxc')

    evaluations = []
    built = []
    real_lml = model.log_marginal_likelihood
    real_init = gram_module.GramFactory.__init__

    def counted_lml(*args, **kwargs):
        out = real_lml(*args, **kwargs)
        evaluations.append(read())
        return out

    def counted_init(self, *args, **kwargs):
        built.append(len(args[1]) if len(args) > 1 else None)
        real_init(self, *args, **kwargs)

    model.log_marginal_likelihood = counted_lml
    gram_module.GramFactory.__init__ = counted_init
    read = launch_counts()
    t0 = time.perf_counter()
    try:
        model.fit(core, train, y_train, tol=NYSTROM_TOL)
        torch.cuda.synchronize()
    finally:
        gram_module.GramFactory.__init__ = real_init
        del model.log_marginal_likelihood
    fit_s = time.perf_counter() - t0
    launches['fit'] = read()
    per_eval = [{k: v - (evaluations[i - 1][k] if i else 0)
                 for k, v in e.items()} for i, e in enumerate(evaluations)]
    n_evals = len(evaluations)
    check(n_evals >= 2 and all(e['pcg_resident'] >= 1 and e['pcg_packed'] >= 1
                               for e in per_eval)
          and launches['fit']['pcg_stream'] == 0,
          f'the fit converged after {n_evals} evaluations, each launching '
          'pcg_resident and pcg_packed, pcg_stream never')
    check(not built and inner._get_call_factory(model.X, core) is cross
          and inner._get_call_factory(core, None) is own,
          'every evaluation of the fit hit the kernel\'s cached factories '
          f'(Kxc over {NYSTROM_TRAIN} x {NYSTROM_CORE}, Kcc over '
          f'{NYSTROM_CORE}): none built during the fit')
    say(f'  [{card}] theta {theta0.tolist()} -> {model.kernel.theta.tolist()}')
    say(f'  [{card}] fit wall {fit_s:.4f} s, {n_evals} evaluations, '
        f'{fit_s / n_evals * 1e3:.3f} ms an evaluation; launches an '
        'evaluation: ' + ', '.join(f'{k} {v / n_evals:.3f}'
                                   for k, v in launches['fit'].items()))
    lml_fit = model.log_marginal_likelihood()
    check(lml_fit <= lml0, f'negative LML {lml_fit:.6f} at the fit <= '
          f'{lml0:.6f} at theta0')

    read = launch_counts()
    t0 = time.perf_counter()
    mean, std = model.predict(held, return_std=True)
    predict_s = time.perf_counter() - t0
    launches['predict'] = read()
    y_held = y[NYSTROM_TRAIN:]
    check(mean.shape == std.shape == (len(held),)
          and bool(np.isfinite(mean).all()) and bool((std >= 0).all()),
          f'[{card}] predict {len(held)} held-out graphs with std in '
          f'{predict_s:.4f} s: finite, std >= 0; mean |y - mean| '
          f'{float(np.abs(y_held - mean).mean()):.3f} (std of y '
          f'{float(y.std()):.3f})')
    t0 = time.perf_counter()
    loo = model.predict_loocv(train, y_train)
    loocv_s = time.perf_counter() - t0
    check(loo.shape == (NYSTROM_TRAIN,) and bool(np.isfinite(loo).all()),
          f'[{card}] predict_loocv over the {NYSTROM_TRAIN} training graphs '
          f'in {loocv_s:.4f} s: finite; mean |y - loo| '
          f'{float(np.abs(y_train - loo).mean()):.3f}')

    theta_fit = model.kernel.theta.copy()
    wall, device = profile_build(lambda: model.log_marginal_likelihood(
        theta_fit, eval_gradient=True, clone_kernel=False),
        'Nystrom evaluation')

    sub = train[:NYSTROM_FULL]
    exact = GaussianProcessRegressor(models_kernel(), alpha=NYSTROM_ALPHA,
                                     normalize_y=True, device='cuda').fit(
        sub, y_train[:NYSTROM_FULL])
    full = LowRankApproximateGPR(models_kernel(), alpha=NYSTROM_ALPHA,
                                 normalize_y=True, device='cuda').fit(
        sub, sub, y_train[:NYSTROM_FULL])
    err = float(np.abs(full.predict(held) - exact.predict(held)).max())
    tol = 1e-3 * float(y_train[:NYSTROM_FULL].std())
    check(err <= tol, f'core = training set ({NYSTROM_FULL} graphs): the '
          f'Nystrom predictions of the held-out graphs within 1e-3 std(y) = '
          f'{tol:.3e} of the exact GPR\'s: {err:.3e}')
    models_fixture_case(np.load(MODELS_FIXTURE))
    return launches


def vario_graphs():
    """The variable-length-feature graphs of ``tests/test_mlgk.py``
    ('vario'), as the port's graphs."""
    import networkx as nx
    from graphdot_tpu_torch.graph import Graph

    def nx_graph(nodes, edges):
        g = nx.Graph()
        for n, attrs in nodes:
            g.add_node(n, **attrs)
        for u, v, attrs in edges:
            g.add_edge(u, v, **attrs)
        return g
    graphs = [
        nx_graph([('O1', dict(rings=(5, 6))), ('H1', dict(rings=(3,))),
                  ('H2', dict(rings=(2, 3, 4)))],
                 [('O1', 'H1', dict(w=1.0, spectrum=(3, 4))),
                  ('O1', 'H2', dict(w=2.0, spectrum=(3, 5)))]),
        nx_graph([('H1', dict(rings=(3, 4))), ('H2', dict(rings=(3,)))],
                 [('H1', 'H2', dict(w=3.0, spectrum=(2, 4)))]),
    ]
    return Graph.unify_datatype([Graph.from_networkx(g, weight='w')
                                 for g in graphs])


def fields_phase():
    """Phase 21: outliers, the Gaussian field and the new microkernels on
    the card. ``GPROutlierDetector`` over ``bench.py``'s 128 molecules with
    4 corrupted targets; ``GaussianFieldRegressor`` over
    ``RBFOverDistance(MaxiMin)`` on ``bench_maximin.py``'s 128 molecules,
    half of the labels hidden, fitted with ``loocv2``; the 128-molecule
    normalized Gram with ``RationalQuadratic`` on length (value and
    gradient); ``Convolution`` and ``DotProduct`` over the 'vario' graphs.
    Each against ``backend='edge'``. Returns the kernels' launches by
    step."""
    import torch
    from graphdot_tpu_torch.kernel import (
        MarginalizedGraphKernel, Normalization)
    from graphdot_tpu_torch.kernel.marginalized._kron import (
        kron_eligible, kron_pcg)
    from graphdot_tpu_torch.metric import MaxiMin
    from graphdot_tpu_torch.microkernel import (
        Convolution, DotProduct, KroneckerDelta, RationalQuadratic,
        SquareExponential, TensorProduct)
    from graphdot_tpu_torch.model.gaussian_field import (
        GaussianFieldRegressor, RBFOverDistance)
    from graphdot_tpu_torch.model.gaussian_process import GPROutlierDetector
    from graphdot_tpu_torch.testing import random_molecule_set

    card = nvidia_smi()
    launches = {}

    # the outlier detector
    # targets the model describes: a draw of the GP prior at theta0 (10
    # times L z, L the Cholesky factor of K + 1e-6 I), so that the
    # corrupted ones are the only misfits; a normalized kernel cannot fit
    # -10 |nodes|, and its residuals there are as large as the shift
    seed, count, atoms = OUTLIER_SET
    graphs = random_molecule_set(seed, count, atoms)
    K = models_kernel()(graphs).astype(np.float64)
    rng = np.random.default_rng(OUTLIER_SEED)
    y = 10.0 * np.linalg.cholesky(K + 1e-6 * np.eye(count)) @ \
        rng.standard_normal(count)
    corrupted = np.sort(rng.choice(count, OUTLIERS, replace=False))
    y[corrupted] += rng.choice([-OUTLIER_SHIFT, OUTLIER_SHIFT], OUTLIERS)
    draws = np.random.default_rng(OUTLIER_SEED + 1)

    def make_detector(backend='auto'):
        return GPROutlierDetector(models_kernel(backend), normalize_y=True,
                                  device='cuda')
    detector = make_detector()
    detector.X, detector.y = graphs, y
    start = np.concatenate([detector.kernel.theta,
                            np.log(draws.lognormal(-1.0, 1.0, count))])
    value, grad = detector.log_marginal_likelihood(start, eval_gradient=True)
    edge = make_detector('edge')
    edge.X, edge.y = graphs, y
    value_e, grad_e = edge.log_marginal_likelihood(start, eval_gradient=True)
    gtol = 1e-3 * float(np.abs(grad_e).max()) + 1e-5
    check(abs(value - value_e) <= 1e-4 * abs(value_e)
          and float(np.abs(grad - grad_e).max()) <= gtol,
          f'outlier detector over {count} molecules: the negative LML at the '
          f'start {value:.6f} vs edge {value_e:.6f} (rtol 1e-4), max |grad - '
          f'grad_edge| {float(np.abs(grad - grad_e).max()):.3e} <= {gtol:.3e}')
    draws = np.random.default_rng(OUTLIER_SEED + 1)
    read = launch_counts()
    t0 = time.perf_counter()
    detector.fit(graphs, y, w=OUTLIER_W,
                 udist=lambda k: draws.lognormal(-1.0, 1.0, k))
    fit_s = time.perf_counter() - t0
    launches['outlier fit'] = read()
    top = np.sort(np.argsort(detector.y_uncertainty)[-OUTLIERS:])
    sigma = detector.y_uncertainty
    check(np.array_equal(top, corrupted) and launches['outlier fit'][
        'pcg_packed'] > 0 and launches['outlier fit']['pcg_stream'] == 0,
          f'[{card}] the fit ({fit_s:.3f} s) gave the {OUTLIERS} corrupted '
          f'targets {corrupted.tolist()} the {OUTLIERS} largest sigma '
          f'({np.sort(sigma[corrupted]).round(3).tolist()}; the largest of '
          f'the rest {float(np.delete(sigma, corrupted).max()):.3f}); '
          f'launches {launches["outlier fit"]}')

    # the Gaussian field over MaxiMin
    seed, count, atoms = MAXIMIN_SET
    graphs = np.asarray(random_molecule_set(seed, count, atoms), dtype=object)
    labels = gp_targets(graphs)
    hidden = np.random.default_rng(GFR_SEED).choice(count, count // 2,
                                                    replace=False)
    y = labels.copy()
    y[hidden] = np.nan

    def make_field(backend='auto', optimizer=None):
        metric = MaxiMin(TensorProduct(element=KroneckerDelta(0.2)),
                         TensorProduct(length=SquareExponential(0.3)),
                         q=0.05, backend=backend, device='cuda')
        return GaussianFieldRegressor(
            RBFOverDistance(metric, sigma=GFR_SIGMA), optimizer=optimizer,
            device='cuda')
    field = make_field(optimizer=True)
    loss, grad = field.loocv_error_2(graphs, y, eval_gradient=True)
    loss_e, grad_e = make_field('edge').loocv_error_2(graphs, y,
                                                      eval_gradient=True)
    gtol = 1e-3 * float(np.abs(grad_e).max()) + 1e-4
    check(abs(loss - loss_e) <= 1e-4 * abs(loss_e)
          and float(np.abs(grad - grad_e).max()) <= gtol,
          f'Gaussian field over MaxiMin ({count} molecules, {len(hidden)} '
          f'labels hidden): loocv2 at the start {loss:.6f} vs edge '
          f'{loss_e:.6f} (rtol 1e-4), max |grad - grad_edge| '
          f'{float(np.abs(grad - grad_e).max()):.3e} <= {gtol:.3e}')
    read = launch_counts()
    t0 = time.perf_counter()
    field.fit(graphs, y, loss='loocv2')
    fit_s = time.perf_counter() - t0
    launches['field fit'] = read()
    t0 = time.perf_counter()
    z = field.predict(graphs, y)
    predict_s = time.perf_counter() - t0
    check(bool(np.isfinite(z).all()) and launches['field fit'][
        'pcg_packed'] > 0 and launches['field fit']['pcg_stream'] == 0,
          f'[{card}] the field\'s fit {fit_s:.3f} s (theta '
          f'{field.weight.theta.round(4).tolist()}), predict {predict_s:.3f}'
          f' s: finite; mean |y - z| over the hidden labels '
          f'{float(np.abs(z[hidden] - labels[hidden]).mean()):.3f} (std of y '
          f'{float(labels.std()):.3f}); fit launches {launches["field fit"]}')

    # RationalQuadratic on length: the normalized Gram and its gradient
    seed, count, atoms = OUTLIER_SET
    graphs = random_molecule_set(seed, count, atoms)

    def rq_kernel(backend='auto'):
        return Normalization(MarginalizedGraphKernel(
            TensorProduct(element=KroneckerDelta(0.2)),
            TensorProduct(length=RationalQuadratic(0.3, 1.0)), q=0.05,
            backend=backend, device='cuda'))
    read = launch_counts()
    K, dK = rq_kernel()(graphs, eval_gradient=True)
    launches['RationalQuadratic gradient Gram'] = read()
    K_e, dK_e = rq_kernel('edge')(graphs, eval_gradient=True)
    err = float(np.abs(K - K_e).max())
    derr = float(np.abs(dK - dK_e).max())
    dtol = 1e-3 * float(np.abs(dK_e).max()) + 1e-5
    check(np.isfinite(dK).all() and err <= 1e-6 and derr <= dtol
          and launches['RationalQuadratic gradient Gram']['pcg_packed'] > 0,
          f'RationalQuadratic on length, {count} molecules: max |K - K_edge| '
          f'{err:.3e} <= 1e-6, max |dK - dK_edge| {derr:.3e} <= {dtol:.3e}; '
          f'launches {launches["RationalQuadratic gradient Gram"]}')

    # Convolution and DotProduct over variable-length features
    ref = np.load(MODELS_FIXTURE)
    G = vario_graphs()
    q = float(ref['vario_q'])
    node = TensorProduct(rings=Convolution(KroneckerDelta(0.3)))
    for name, edge_kernel, oracle in (
            ('Convolution', Convolution(SquareExponential(1.0)),
             ref['vario_oracle']),
            ('DotProduct', DotProduct().normalized, None)):
        def vario_kernel(backend='auto'):
            return MarginalizedGraphKernel(
                node, TensorProduct(spectrum=edge_kernel), q=q,
                backend=backend, device='cuda')
        kernel = vario_kernel()
        _, bd, _ = kernel._prepare_batch(G)
        ops = kernel._operands(bd, bd, torch.tensor([0], device='cuda'),
                               torch.tensor([1], device='cuda'))
        read = launch_counts()
        kron_before = kron_pcg.launches
        R = kernel(G)
        launches[f'{name} Gram'] = read()
        R_e = vario_kernel('edge')(G)
        scale = float(np.abs(R_e).max())
        err = float(np.abs(R - R_e).max())
        ok = err <= 1e-6 * scale
        text = (f'{name} on the card over the vario graphs: max |R - R_edge| '
                f'{err:.3e} <= 1e-6 max |R| = {1e-6 * scale:.3e}')
        if oracle is not None:
            oerr = float(np.abs(R - oracle).max())
            ok = ok and oerr <= 1e-6 * float(np.abs(oracle).max())
            text += (f', max |R - R_oracle| (JAX fixture) {oerr:.3e} <= '
                     f'{1e-6 * float(np.abs(oracle).max()):.3e}')
        check(ok and not kron_eligible(ops)
              and kron_pcg.launches == kron_before
              and launches[f'{name} Gram']['pcg_resident'] > 0,
              text + f'; not kron-eligible, kron_pcg never, launches '
              f'{launches[f"{name} Gram"]}')
    return launches


def parallel_phase(resume):
    """Phase 22: the multi-GPU layer (``graphdot_tpu_torch.parallel``, the
    samplers' ``mesh``) over NCCL at world size 1, the card's one rank, in
    a process group made here and destroyed at the end. (a)
    ``sharded_gram_fn`` over ``bench.py``'s 128 molecules within 1e-6 of
    ``GramFactory.gram`` and of the JAX fixture, one ``pcg_resident`` launch
    a chunk of the share; (b) the shares of 2 and 4 ranks, computed here,
    cover every job once and assemble the Gram within 1e-6; (c)
    ``sharded_gp_solve`` of that Gram plus 1e-2 I, in float64, within rtol
    1e-4 and atol 1e-5 of a float64 Cholesky solve; (d) ``sample(mesh=...)``
    of 8 chains for 5 draws, resumed at phase 17's step size and mass, and
    a short ``smc_sample(mesh=...)``, each bitwise equal to the unsharded
    call from the same seed. Returns the kernels' launches of the sharded
    Gram and of the sharded chains."""
    import socket
    import torch
    import torch.distributed as dist
    from graphdot_tpu_torch.convert import hyperparameters_from_numpy
    from graphdot_tpu_torch.inference import GramFactory, sample, smc_sample
    from graphdot_tpu_torch.kernel import MarginalizedGraphKernel
    from graphdot_tpu_torch.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu_torch.parallel import (
        init_distributed, make_mesh, sharded_gp_solve, sharded_gram_fn)
    from graphdot_tpu_torch.parallel.gram import (
        assemble, share_groups, solve_share)
    from graphdot_tpu_torch.testing import random_molecule_set

    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    device = init_distributed(f'localhost:{port}', 1, 0, device='cuda')
    out = {}
    try:
        check(dist.get_backend() == 'nccl' and dist.get_world_size() == 1
              and device == torch.device('cuda', 0),
              f'a process group over NCCL, world size 1, rank 0 on {device}')
        pairs = make_mesh({'pairs': -1})
        chains = make_mesh({'chains': -1})

        # (a) the sharded Gram
        ref = np.load(FIXTURE)
        graphs = random_molecule_set(int(ref['seed']), int(ref['n_graphs']),
                                     n_atoms_range=(9, 24))
        kernel = hyperparameters_from_numpy(MarginalizedGraphKernel(
            TensorProduct(element=KroneckerDelta(0.2)),
            TensorProduct(length=SquareExponential(0.3)), q=0.05,
            device='cuda'), ref['theta'])
        factory = GramFactory(kernel, graphs)
        theta = factory.theta0
        plan = factory._plan
        K_factory = factory.gram(theta)
        gram = sharded_gram_fn(factory, pairs)
        chunks = sum(1 for g in gram.shares for _ in plan.chunks(g))
        read = launch_counts()
        K = gram(theta)
        got = read()
        out['sharded Gram'] = got
        err = float((K - K_factory).abs().max())
        n_ref = int(ref['n_first'])
        ref_err = float(np.abs(K[:n_ref, :n_ref].cpu().numpy()
                               - ref['K']).max())
        check(K.shape == K_factory.shape and err <= 1e-6
              and ref_err <= 1e-6,
              f'sharded_gram_fn over {len(graphs)} molecules: max |K - '
              f'GramFactory.gram| {err:.3e}, max |K - K_jax| over the first '
              f'{n_ref} {ref_err:.3e} (limit 1e-6)')
        check(got['pcg_resident'] == chunks and got['pcg_packed'] == 0
              and got['pcg_stream'] == 0,
              f'pcg_resident launched {got["pcg_resident"]} times, once a '
              f'chunk of the share ({chunks}), the others never')

        # (b) the shares of 2 and 4 ranks, computed in this process
        for size in (2, 4):
            shares = [share_groups(factory, rank, size)
                      for rank in range(size)]
            covered = all(np.array_equal(np.concatenate(
                [sh[g]['pos'] for sh in shares]), grp['pos'])
                for g, grp in enumerate(plan.groups))
            values = [solve_share(factory, theta, sh) for sh in shares]
            K_size = assemble(factory, [torch.cat(v) for v in zip(*values)])
            err = float((K_size - K).abs().max())
            check(covered and err <= 1e-6,
                  f'{size} ranks: the shares cover every job of the '
                  f'{len(plan.groups)} groups once, and their Gram is '
                  f'within {err:.3e} <= 1e-6')

        # (c) the sharded CG
        y = torch.as_tensor(np.random.default_rng(0).normal(
            size=len(graphs)), device='cuda')
        # K_ij / d_i / d_j leaves K symmetric only to a rounding; the
        # Cholesky factor reads one triangle, the CG the whole matrix
        K64 = 0.5 * (K.double() + K.double().T)
        t0 = time.perf_counter()
        x = sharded_gp_solve(pairs, K64, y, 1e-2, tol=1e-8)
        torch.cuda.synchronize()
        t_cg = time.perf_counter() - t0
        A = K64.cpu() + 1e-2 * torch.eye(len(graphs), dtype=torch.float64)
        exact = torch.cholesky_solve(y.cpu()[:, None], torch.linalg.cholesky(
            A))[:, 0].numpy()
        x = x.cpu().numpy()
        check(np.allclose(x, exact, rtol=1e-4, atol=1e-5),
              f'sharded_gp_solve of K + 1e-2 I in float64 in {t_cg:.4f} s: '
              f'max |x - x_cholesky| {np.abs(x - exact).max():.3e} within '
              'rtol 1e-4, atol 1e-5')

        # (d) sharded chains and particles against the unsharded calls
        lp = resume['lp']
        kwargs = dict(n_chains=NUTS_CHAINS, n_samples=5,
                      init=resume['init'], step_size=resume['step_size'],
                      inv_mass=resume['inv_mass'],
                      max_depth=NUTS_MAX_DEPTH, device='cuda')
        read = launch_counts()
        t0 = time.perf_counter()
        sharded = sample(lp, torch.Generator().manual_seed(1), mesh=chains,
                         chain_axis='chains', **kwargs)
        got = read()
        t_chains = time.perf_counter() - t0
        out['sharded chains'] = got
        plain = sample(lp, torch.Generator().manual_seed(1), **kwargs)
        same = all(torch.equal(sharded[k], plain[k]) for k in (
            'samples', 'logp', 'accept_prob', 'divergent'))
        check(same and sharded['samples'].shape == (NUTS_CHAINS, 5,
                                                     lp.n_dims),
              f'sample(mesh=...) of {NUTS_CHAINS} chains for 5 draws '
              f'({t_chains:.3f} s) equals the unsharded call bit for bit')
        check(got['pcg_resident'] > 0 and got['pcg_packed'] > 0
              and got['pcg_stream'] == 0,
              f'the sharded chains launched pcg_resident '
              f'{got["pcg_resident"]} and pcg_packed {got["pcg_packed"]} '
              'times, pcg_stream never')
        center = torch.as_tensor(lp.theta0, dtype=torch.float32,
                                 device='cuda')

        def log_prior(t):
            return -0.5 * torch.sum((t - center) ** 2, dim=-1)

        particles = center + 0.1 * torch.as_tensor(
            np.random.default_rng(2).normal(size=(NUTS_CHAINS, lp.n_dims)),
            dtype=torch.float32, device='cuda')
        runs = [smc_sample(log_prior, lp, torch.Generator().manual_seed(2),
                           n_particles=NUTS_CHAINS, init=particles,
                           n_moves=2, max_stages=3, moves='rw', mesh=mesh,
                           particle_axis='chains', device='cuda')
                for mesh in (chains, None)]
        check(torch.equal(runs[0]['samples'], runs[1]['samples'])
              and runs[0]['log_evidence'] == runs[1]['log_evidence']
              and runs[0]['beta_history'] == runs[1]['beta_history'],
              f'smc_sample(mesh=...) of {NUTS_CHAINS} particles, '
              f'{runs[0]["n_stages"]} stages, equals the unsharded call bit '
              'for bit')
    finally:
        dist.destroy_process_group()
    wall = time.perf_counter() - t_phase
    check(wall <= 90, f'phase 22 took {wall:.1f} s <= 90 s')
    return out


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
    from graphdot_tpu_torch.kernel.marginalized._kernel import JobPlan
    from graphdot_tpu_torch.kernel.marginalized._solver import (
        mlgk_setup, mlgk_tangents)
    from graphdot_tpu_torch.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu_torch.ops import _build
    from graphdot_tpu_torch.ops.pcg import (
        group_pairs, kernel_occupancy, largest_packed_k, pcg_packed,
        pcg_packed_reference,
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

    say('== 3. pcg_resident against its plain twin, on the value chunks of '
        'the main path')
    # the factory that the kernel caches for the 128 molecules serves the
    # Grams of phases 4, 5, 11 and 13-15; its plan is what they solve
    fac = kernel._get_call_factory(graphs, None)
    plan = fac._plan

    def shape_of(grp):
        return f'({grp["n1"]}, {grp["n2"]})'

    def systems(kern, bd1, bd2, idx1, idx2, iters):
        """The solver's operands for the jobs (idx1[k], idx2[k]) of two
        prepared batches."""
        s = mlgk_setup(kern._theta_vector(),
                       kern._operands(bd1, bd2, idx1, idx2),
                       knode=kern.node_kernel, kedge=kern.edge_kernel,
                       n_p_theta=1, mode='cuda')
        return (s['T'], s['esrc_1'], s['edst_1'], s['esrc_2'],
                s['edst_2'], s['diag'].contiguous(),
                s['precond'].contiguous(), s['b'].contiguous(), s['tol'],
                iters)

    def chunk_systems(grp, idx1, idx2):
        """The operands that the factory gives pcg_resident for the jobs
        (idx1, idx2) of a group, at the group's step bound."""
        return systems(kernel, grp['bd1'], grp['bd2'], idx1, idx2,
                       fac._group_maxiter(grp))

    # (group, local indices 1, local indices 2): one launch each
    value_chunks = [(grp, idx1, idx2) for grp in plan.groups
                    for _, idx1, idx2 in plan.chunks(grp)]
    resident_errs = []
    for grp, idx1, idx2 in value_chunks:
        args = chunk_systems(grp, idx1, idx2)
        x_k, it_k = pcg_resident(*args)
        x_r, it_r = pcg_resident_reference(*args)
        torch.cuda.synchronize()
        err = float((x_k - x_r).abs().max())
        scale = float(x_r.abs().max())
        resident_errs.append(err)
        say(f'  group {shape_of(grp)}: {len(idx1)} pairs, T '
            f'{tuple(args[0].shape)}, x {tuple(x_k.shape)}; CG steps kernel '
            f'mean {float(it_k.float().mean()):.2f} max {int(it_k.max())}, '
            f'twin mean {float(it_r.float().mean()):.2f} max '
            f'{int(it_r.max())}')
        check(bool(torch.isfinite(x_k).all()) and err <= 1e-5 * scale,
              f'group {shape_of(grp)}: x finite, max |x_kernel - x_twin| = '
              f'{err:.3e} <= 1e-5 * max |x| = {1e-5 * scale:.3e}')
    max_abs_err = max(resident_errs)
    # the (24, 24) chunk: 2080 pairs at M = 64, N = 24, the prototype's
    # shape; its first pairs also hold pcg_stream and the pair groups of
    # pcg_packed against pcg_resident in phases 6, 9, 10 and 13
    square = next(c for c in value_chunks
                  if (c[0]['n1'], c[0]['n2']) == (24, 24))
    proto = list(chunk_systems(*square))
    proto[8] = torch.zeros_like(proto[8])          # tol = 0: fixed steps
    proto[9] = PROTO_STEPS
    check(proto[0].shape == (PROTO_PAIRS, 64, 64)
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
    proto_bound = pcg_bound(proto, x_k, it_k)
    proto_times = time_call(lambda: pcg_resident(*proto), 20,
                            'pcg_resident_kernel')
    proto_row = {'name': TPU_PROTO_KERNEL, 'pairs': PROTO_PAIRS,
                 'steps': PROTO_STEPS, 'ms': proto_times['ms'],
                 'device_ms': proto_times['device_ms'],
                 'plain_ms': cuda_ms(lambda: pcg_resident_reference(*proto),
                                     reps=2),
                 'bound_ms': proto_bound[0], 'bound_by': proto_bound[1],
                 'max_abs_err': proto_err}
    say(f'  at the prototype\'s shape: pcg_resident {proto_row["ms"]:.4f} ms '
        f'by events, device {proto_row["device_ms"]} ms, plain twin '
        f'{proto_row["plain_ms"]:.4f} ms, bound {proto_bound[0]:.4f} ms '
        f'({proto_bound[1]})')

    say('== 4. the molecule slice: normalized 128-molecule Gram, '
        'backend=cuda, through the cached factory')
    pcg_resident.launches = pcg_stream.launches = 0
    t0 = time.perf_counter()
    K = Normalization(kernel)(graphs)
    first_build_s = time.perf_counter() - t0
    launches = pcg_resident.launches
    check(pcg_stream.launches == 0, 'pcg_stream launched 0 times')
    check(kernel._get_call_factory(graphs, None) is fac,
          'the call took the factory of phase 3')
    n_chunks = factory_chunks(kernel, graphs)
    say(f'  first build (the factory packed in phase 3) '
        f'{first_build_s:.4f} s, '
        f'{n_pairs} pairs in {n_chunks} chunks of the factory\'s size-class '
        'groups')
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

    def time_chunk(name, wrapper, reference, grp, args, reps, err):
        """One chunk's wrapper by events and device time, its twin, bound,
        live means and occupancy, as a row of the summary line."""
        x, steps = wrapper(*args)
        bound = pcg_bound(args, x, steps)
        live, text = live_report(args)
        (M1, M2), (N1, N2) = args[0].shape[-2:], args[5].shape[-2:]
        k = x.shape[1] if x.dim() == 4 else 1
        occ = kernel_occupancy(name, M1, M2, N1, N2, k=k)
        times = time_call(lambda: wrapper(*args), reps, name + '_kernel')
        plain = cuda_ms(lambda: reference(*args), reps=3)
        row = {'group': [grp['n1'], grp['n2']], 'pairs': x.shape[0],
               'M': [M1, M2], 'max_abs_err': err, 'ms': times['ms'],
               'device_ms': times['device_ms'], 'plain_ms': plain,
               'bound_ms': bound[0], 'bound_by': bound[1],
               'cg_steps_mean': float(steps.float().mean()),
               'cg_steps_max': int(steps.max()), 'occupancy': occ,
               'live': live}
        say(f'  group {shape_of(grp)}, a chunk of {x.shape[0]} pairs (M = '
            f'{M1}, {M2}; CG steps mean {row["cg_steps_mean"]:.3f}, max '
            f'{row["cg_steps_max"]}): {name} {times["ms"]:.4f} ms by events, '
            f'device {times["device_ms"]} ms, plain twin {plain:.4f} ms, '
            f'bound {bound[0]:.4f} ms ({bound[1]})')
        say(f'    in turns (events, device): {times["runs"]}; {text}; '
            f'occupancy {occ}')
        return row

    resident_rows = []
    for (grp, idx1, idx2), err in zip(value_chunks, resident_errs):
        resident_rows.append(time_chunk(
            'pcg_resident', pcg_resident, pcg_resident_reference, grp,
            chunk_systems(grp, idx1, idx2), 20, err))
        resident_rows[-1]['chunks_in_group'] = sum(
            1 for g, _, _ in value_chunks if g is grp)
    # the summary line's row: the largest chunk, (16, 24) of 4096 pairs
    main = max(range(len(value_chunks)),
               key=lambda c: resident_rows[c]['pairs'])
    resident_main = resident_rows[main]
    resident_split = step_split(pcg_resident,
                                chunk_systems(*value_chunks[main]),
                                'pcg_resident_kernel')
    say(f'  device time by part, group '
        f'{shape_of(value_chunks[main][0])}: {resident_split}')
    walls = []
    for _ in range(BUILD_REPEATS):
        t0 = time.perf_counter()
        Normalization(kernel)(graphs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    say(f'  normalized Gram build (factory route, cache hit): median '
        f'{wall * 1e3:.3f} ms, min {min(walls) * 1e3:.3f} ms over '
        f'{BUILD_REPEATS}; {n_pairs / wall:.1f} pairs/s at the median')

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
    p_jobs = [torch.as_tensor(j[:p_chunk], device='cuda')
              for j in np.triu_indices(len(proteins))]
    p_args = systems(pkernel, pbd, pbd, *p_jobs, pkernel.maxiter(pn_pad))
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
    args = chunk_systems(square[0], square[1][:N_COMPARE],
                         square[2][:N_COMPARE])
    x_s, _ = pcg_stream(*args)
    x_k, _ = pcg_resident(*args)
    torch.cuda.synchronize()
    err = float((x_s - x_k).abs().max())
    scale = float(x_k.abs().max())
    check(err <= 1e-5 * scale,
          f'{N_COMPARE} molecule pairs of the (24, 24) chunk: max '
          f'|x_stream - x_resident| = '
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
    niche = JobPlan(pkernel, proteins, *np.triu_indices(len(proteins)),
                    False)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        niche_kron = niche.calibrate_kron(pkernel._theta_vector())
    check(niche_kron.ranks == 'off'
          and niche.route(niche.groups[0]) == 'stream',
          f'the route stays pcg_stream: calibration rejects the ctype '
          f'factor (factorization error {niche_kron.err:.3g}; n1 n2 = '
          f'{pn_pad * pn_pad})')

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
    # the 32-molecule sets below (528 jobs) take the per-pair route: one
    # batch padded to the largest graph, the boundary these checks hold
    say('  the molecule sets of 32 (528 jobs) on the per-pair route')
    big = random_molecule_set(7, 32, n_atoms_range=(48, 72))
    with api_union('0'):
        pcg_resident.launches = pcg_stream.launches = 0
        KB = Normalization(make_kernel())(big)
        check(pcg_stream.launches >= 1 and pcg_resident.launches == 0,
              f'48-72-atom molecules: pcg_stream launched '
              f'{pcg_stream.launches} times, pcg_resident 0')
        big_err = float(np.abs(
            KB - Normalization(make_kernel('edge'))(big)).max())
        check(big_err <= 1e-6, f'max |K_cuda - K_edge| over 32 molecules '
              f'of 48-72 atoms = {big_err:.3e} <= 1e-6')
        large = {}
        for atoms, solver in (((48, 56), pcg_resident),
                              ((56, 64), pcg_stream)):
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
    lone_device_ms = device_ms(lambda: pcg_stream(*lone), 10, 'stream')
    say(f'  lone pair at C = {lone_ctas}: device time of the call\'s kernels '
        f'{lone_device_ms} ms')
    stream_ms = float(np.mean(stream_times['chunk', None]))
    stream_device_ms = device_ms(lambda: pcg_stream(*p_args), 3, 'stream')
    say(f'  chunk at C = {pcg_stream.last_ctas_per_pair}: device time of '
        f'the call\'s kernels {stream_device_ms} ms')
    stream_plain_ms = stream_times['chunk', 'plain']
    stream_bound = stream_times['chunk', 'bound']
    args = chunk_systems(*square)
    _, m_steps = pcg_stream(*args)
    mol_stream_ms = cuda_ms(lambda: pcg_stream(*args), reps=10)
    mol_resident_ms = cuda_ms(lambda: pcg_resident(*args), reps=10)
    say(f'  the (24, 24) molecule chunk of {args[0].shape[0]} pairs (CG '
        'steps mean '
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

    def tangent_groups(grp, idx1, idx2):
        """pcg_packed's operands for the tangent systems of the jobs (idx1,
        idx2) of a factory group, as the main path's tangent route builds
        them: one group a pair, its 4 tangents sharing the pair's operator,
        at the pair's value solution, the step bound scaled by k."""
        ops = kernel._operands(grp['bd1'], grp['bd2'], idx1, idx2)
        theta = kernel._theta_vector()
        kw = dict(knode=kernel.node_kernel, kedge=kernel.edge_kernel,
                  n_p_theta=1, mode='cuda')
        s = mlgk_setup(theta, ops, **kw)
        operator = [s[f].contiguous() for f in (
            'T', 'esrc_1', 'edst_1', 'esrc_2', 'edst_2', 'diag', 'precond')]
        iters = fac._group_maxiter(grp)
        x, _ = pcg_resident(*operator, s['b'].contiguous(), s['tol'], iters)
        rhs = mlgk_tangents(theta, ops, s, x, **kw)['rhs'].contiguous()
        k = rhs.shape[1]
        M1, M2 = operator[0].shape[1:]
        check(largest_packed_k(k, M1, M2, grp['n1'], grp['n2'],
                               torch.device('cuda'), shared=True) == k,
              f'group {shape_of(grp)}: the main path runs the {k} tangents '
              'of a pair as one group')
        return ([a[:, None] for a in operator]
                + [rhs, s['gtol'].contiguous(), min(iters * k, 16384)])

    # (group, local indices 1, local indices 2): one launch each
    gradient_chunks = [(grp, idx1, idx2) for grp in plan.groups
                       for _, idx1, idx2 in plan.chunks(grp, True)]
    packed_errs = []
    for grp, idx1, idx2 in gradient_chunks:
        t_args = tangent_groups(grp, idx1, idx2)
        x_k, it_k = pcg_packed(*t_args)
        x_r, it_r = pcg_packed_reference(*t_args)
        torch.cuda.synchronize()
        err = float((x_k - x_r).abs().max())
        scale = float(x_r.abs().max())
        packed_errs.append(err)
        say(f'  (a) group {shape_of(grp)}: {len(idx1)} tangent groups of k '
            f'= {t_args[7].shape[1]}, shared operator; CG steps kernel mean '
            f'{float(it_k.float().mean()):.2f} max {int(it_k.max())}, twin '
            f'mean {float(it_r.float().mean()):.2f} max {int(it_r.max())}')
        check(bool(torch.isfinite(x_k).all()) and err <= 1e-5 * scale,
              f'group {shape_of(grp)}: x finite, max |x_packed - x_twin| = '
              f'{err:.3e} <= 1e-5 * max |x| = {1e-5 * scale:.3e}')
    packed_err = max(packed_errs)
    del t_args
    args = chunk_systems(square[0], square[1][:N_COMPARE],
                         square[2][:N_COMPARE])
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
        pcg_packed(*group_pairs(16, *chunk_systems(
            square[0], square[1][:64], square[2][:64])))
    except ValueError as e:
        check('largest k that fits' in str(e),
              f'(c) a group of 16 pairs raises: {e}')
    else:
        raise RuntimeError('check failed: a group of 16 pairs did not raise')

    say('== 11. the gradient slice: normalized 128-molecule Gram with '
        'eval_gradient=True, backend=cuda, through the cached factory')
    g_chunks = factory_chunks(kernel, graphs, eval_gradient=True)
    pcg_resident.launches = pcg_stream.launches = pcg_packed.launches = 0
    t0 = time.perf_counter()
    KG, dKG = Normalization(kernel)(graphs, eval_gradient=True)
    say(f'  first build {time.perf_counter() - t0:.4f} s, {g_chunks} chunks')
    packed_launches = pcg_packed.launches
    grad_resident_launches = pcg_resident.launches
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
        'atoms, on the per-pair route')
    with api_union('0'):
        pcg_resident.launches = pcg_stream.launches = 0
        pcg_packed.launches = 0
        _, dKB = Normalization(make_kernel())(big, eval_gradient=True)
        check(pcg_stream.launches >= 2 and pcg_packed.launches == 0
              and pcg_resident.launches == 0,
              f'pcg_stream launched {pcg_stream.launches} times (value and '
              'tangent solves), pcg_packed and pcg_resident 0')
        _, dKB_edge = Normalization(make_kernel('edge'))(
            big, eval_gradient=True)
        tol = 1e-3 * float(np.abs(dKB_edge).max()) + 1e-5
        err = float(np.abs(dKB - dKB_edge).max())
        check(bool(np.isfinite(dKB).all()) and err <= tol,
              f'max |dK_cuda - dK_edge| = {err:.3e} <= {tol:.3e}')
        pcg_resident.launches = pcg_stream.launches = 0
        pcg_packed.launches = 0
        _, dKL = Normalization(make_kernel())(large[48, 56],
                                              eval_gradient=True)
        check(pcg_resident.launches >= 2 and pcg_packed.launches == 0
              and pcg_stream.launches == 0,
              f'48-55-atom molecules: pcg_resident launched '
              f'{pcg_resident.launches} times (value solves and tangents one '
              'a CTA), pcg_packed and pcg_stream 0')
        _, dKL_edge = Normalization(make_kernel('edge'))(
            large[48, 56], eval_gradient=True)
        tol = 1e-3 * float(np.abs(dKL_edge).max()) + 1e-5
        err = float(np.abs(dKL - dKL_edge).max())
        check(bool(np.isfinite(dKL).all()) and err <= tol,
              f'max |dK_cuda - dK_edge| = {err:.3e} <= {tol:.3e}')

    say('== 13. timing of the gradient path')
    # the first gradient chunk of each group; the summary line's row is
    # the (16, 24) group's, a chunk of 903 pairs
    packed_rows = []
    for grp in plan.groups:
        c = next(c for c, (g, _, _) in enumerate(gradient_chunks)
                 if g is grp)
        packed_rows.append(time_chunk(
            'pcg_packed', pcg_packed, pcg_packed_reference, grp,
            tangent_groups(*gradient_chunks[c]), 10, packed_errs[c]))
        packed_rows[-1]['chunks_in_group'] = sum(
            1 for g, _, _ in gradient_chunks if g is grp)
    main_t = next(c for c, (g, _, _) in enumerate(gradient_chunks)
                  if g is value_chunks[main][0])
    packed_main = next(row for row, grp in zip(packed_rows, plan.groups)
                       if grp is value_chunks[main][0])
    packed_split = step_split(pcg_packed,
                              tangent_groups(*gradient_chunks[main_t]),
                              'pcg_packed_kernel')
    say(f'  device time by part, group '
        f'{shape_of(gradient_chunks[main_t][0])}: {packed_split}')
    args = chunk_systems(*square)
    _, p_steps = pcg_resident(*args)
    res_ms = cuda_ms(lambda: pcg_resident(*args), reps=20)
    say(f'  the (24, 24) value chunk of {args[0].shape[0]} pairs: '
        f'pcg_resident {res_ms:.4f} ms (CG steps mean '
        f'{float(p_steps.float().mean()):.3f}, max {int(p_steps.max())})')
    for k in (2, 4):
        grouped = group_pairs(k, *args)
        _, g_steps = pcg_packed(*grouped)
        k_ms = cuda_ms(lambda: pcg_packed(*grouped), reps=20)
        alone = p_steps[:len(p_steps) // k * k].reshape(-1, k)
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
        say(f'  normalized {what} Gram build (factory route): median '
            f'{wall * 1e3:.3f} ms over {GRAD_REPEATS} '
            f'({", ".join(f"{w * 1e3:.3f}" for w in ws)}); '
            f'{n_pairs / wall:.1f} pairs/s at the median')
    profile_build(lambda: Normalization(kernel)(
        graphs, eval_gradient=True), 'gradient (factory route)')

    say('== 14. the factory route: __call__ through a cached GramFactory')
    import graphdot_tpu_torch.kernel.marginalized._kernel as kernel_module
    packings = []
    real_batch_graphs = kernel_module.batch_graphs

    def counted_batch_graphs(batch, *args, **kwargs):
        packings.append(len(batch))
        return real_batch_graphs(batch, *args, **kwargs)

    kernel_module.batch_graphs = counted_batch_graphs
    fkernel = make_kernel()
    pcg_resident.launches = pcg_stream.launches = pcg_packed.launches = 0
    t0 = time.perf_counter()
    KF = Normalization(fkernel)(graphs)
    say(f'  first call (packing included) {time.perf_counter() - t0:.4f} s')
    fac = fkernel._get_call_factory(graphs, None)
    check(len(fkernel._factory_cache) == 1 and not fac.normalize,
          'one cached factory over the 128 molecules')
    groups = [(g['n1'], g['n2'], len(g['pos'])) for g in fac._plan.groups]
    f_chunks = factory_chunks(fkernel, graphs)
    say(f'  size-class groups (n1, n2, jobs): {groups}; packings '
        f'{packings}; {f_chunks} chunks')
    check(len(packings) == fac._plan.n_classes == 2,
          f'{len(packings)} packings, one a size class')
    check(pcg_resident.launches == f_chunks and pcg_stream.launches == 0,
          f'pcg_resident launched {pcg_resident.launches} times = '
          f'{f_chunks} chunks, pcg_stream 0')
    KF2 = Normalization(fkernel)(graphs)
    check(len(packings) == 2, 'a second call hits the cache: no packing')
    check(float(np.abs(KF2 - KF).max()) <= 1e-7, 'and gives the same K')
    with api_union('0'):
        KP = Normalization(fkernel)(graphs)
    err = float(np.abs(KF - KP).max())
    check(err <= 1e-6, f'max |K_factory - K_per_pair| = {err:.3e} <= 1e-6')
    err = float(np.abs(KF[:n_ref, :n_ref] - ref['K']).max())
    check(err <= 1e-6, f'max |K - K_jax| over the first {n_ref} graphs = '
          f'{err:.3e} <= 1e-6')
    n_packed = len(packings)   # the per-pair route packs at every call
    pcg_resident.launches = pcg_stream.launches = pcg_packed.launches = 0
    KFG, dKF = Normalization(fkernel)(graphs, eval_gradient=True)
    fg_chunks = factory_chunks(fkernel, graphs, eval_gradient=True)
    check(len(packings) == n_packed, 'the gradient call reuses the factory: '
          'no packing')
    check(pcg_resident.launches == pcg_packed.launches == fg_chunks
          and pcg_stream.launches == 0,
          f'gradient: pcg_resident and pcg_packed launched '
          f'{pcg_resident.launches} and {pcg_packed.launches} times = '
          f'{fg_chunks} chunks, pcg_stream 0')
    factory_launches = {'pcg_resident': pcg_resident.launches,
                        'pcg_packed': pcg_packed.launches,
                        'pcg_stream': pcg_stream.launches}
    with api_union('0'):
        KPG, dKP = Normalization(fkernel)(graphs, eval_gradient=True)
    err = float(np.abs(KFG - KPG).max())
    check(err <= 1e-6, f'max |K_factory - K_per_pair| = {err:.3e} <= 1e-6')
    tol = 1e-3 * float(np.abs(dKP).max()) + 1e-5
    err = float(np.abs(dKF - dKP).max())
    check(bool(np.isfinite(dKF).all()) and err <= tol,
          f'max |dK_factory - dK_per_pair| = {err:.3e} <= {tol:.3e}')
    tol = 1e-3 * float(np.abs(gref['dK']).max()) + 1e-5
    err = float(np.abs(dKF[:n_ref, :n_ref] - gref['dK']).max())
    check(err <= tol, f'max |dK - dK_jax| over the first {n_ref} graphs = '
          f'{err:.3e} <= {tol:.3e}')
    held = random_molecule_set(7, 32, n_atoms_range=(9, 24))
    pcg_resident.launches = pcg_stream.launches = 0
    KX = fkernel(held, graphs)
    check(len(fkernel._factory_cache) == 2 and pcg_stream.launches == 0
          and pcg_resident.launches >= 1,
          f'the cross-Gram of 32 x 128 ({32 * 128} jobs) took a rectangular '
          f'factory: pcg_resident launched {pcg_resident.launches} times, '
          'pcg_stream 0')
    with api_union('0'):
        KXP = fkernel(held, graphs)
    err = float(np.abs(KX - KXP).max())
    scale = float(np.abs(KXP).max())
    check(KX.shape == (32, 128) and err <= 1e-6 * scale,
          f'max |K_factory - K_per_pair| = {err:.3e} <= 1e-6 * max |K| = '
          f'{1e-6 * scale:.3e}')
    kernel_module.batch_graphs = real_batch_graphs
    route_walls = {}
    for rep in range(GRAD_REPEATS):
        for gradient in (False, True):
            routes = ('factory', 'per-pair')
            for route in routes if rep % 2 == 0 else routes[::-1]:
                ctx = api_union('0') if route == 'per-pair' \
                    else contextlib.nullcontext()
                with ctx:
                    t0 = time.perf_counter()
                    Normalization(fkernel)(graphs, eval_gradient=gradient)
                    torch.cuda.synchronize()
                route_walls.setdefault((route, gradient), []).append(
                    time.perf_counter() - t0)
    for (route, gradient), ws in route_walls.items():
        say(f'  {"gradient" if gradient else "value"} Gram, {route} route: '
            f'median {np.median(ws) * 1e3:.3f} ms over {GRAD_REPEATS} '
            f'({", ".join(f"{w * 1e3:.3f}" for w in ws)})')
    profile_build(lambda: Normalization(fkernel)(graphs), 'factory value')
    profile_build(lambda: Normalization(fkernel)(graphs, eval_gradient=True),
                  'factory gradient')
    say(f'  below the threshold of {fkernel._API_UNION_MIN_JOBS} jobs: the '
        'unnormalized Grams on each route, in turns')
    for n in (16, 31):
        few_graphs = graphs[:n]
        sub_walls = {}
        routes = ('per-pair', 'factory first call', 'factory cache hit')
        for rep in range(GRAD_REPEATS):
            for gradient in (False, True):
                for route in routes if rep % 2 == 0 else routes[::-1]:
                    with api_union('0' if route == 'per-pair' else '1'):
                        if route == 'factory first call':
                            fkernel._factory_cache.clear()
                        elif route == 'factory cache hit':
                            fkernel(few_graphs)     # the entry exists
                        t0 = time.perf_counter()
                        fkernel(few_graphs, eval_gradient=gradient)
                        torch.cuda.synchronize()
                    sub_walls.setdefault((route, gradient), []).append(
                        time.perf_counter() - t0)
        for (route, gradient), ws in sub_walls.items():
            say(f'    {n * (n + 1) // 2} jobs, '
                f'{"gradient" if gradient else "value"} Gram, {route}: '
                f'median {np.median(ws) * 1e3:.3f} ms over {GRAD_REPEATS} '
                f'({", ".join(f"{w * 1e3:.3f}" for w in ws)})')

    say('== 15. the GP fit: GaussianProcessRegressor on the 128 molecules')
    gp_launches = gp_phase(graphs, held, make_kernel)

    say('== 16. the protein classes of bench_protein.py: kron against '
        'pcg_stream')
    kron_rows, kron_stream_launches, kron_min_n = kron_phase()

    say('== 17. the NUTS path of bench_nuts.py: GPRLogProb over 32 '
        'molecules, 8 chains')
    nuts_launches, nuts_per_iteration, nuts_resume = nuts_phase()

    say('== 18. the MaxiMin path of bench_maximin.py: 128 molecules')
    maximin_launches = maximin_phase()

    say('== 19. graphs from atoms: the QM7 surrogate through from_ase')
    atoms_launches = atoms_phase()

    say('== 20. the Tang & de Jong 2019 workflow with Nystrom: 1024 '
        'molecules, core 128')
    nystrom_launches = nystrom_phase()

    say('== 21. outliers, the Gaussian field and the new microkernels')
    field_launches = fields_phase()

    say('== 22. the multi-GPU layer over NCCL, world size 1: sharded Gram, '
        'CG, chains and particles')
    parallel_launches = parallel_phase(nuts_resume)

    def by_path(name):
        """A kernel's launches on each path, counted from 0 before it."""
        return {'value Gram (4)': launches if name == 'pcg_resident' else 0,
                'protein Gram (7)': stream_launches
                if name == 'pcg_stream' else 0,
                'gradient Gram (11)': {
                    'pcg_resident': grad_resident_launches,
                    'pcg_packed': packed_launches, 'pcg_stream': 0}[name],
                'factory gradient (14)': factory_launches[name],
                'GP fit (15)': gp_launches[name],
                'bench_protein classes, stream route (16)':
                kron_stream_launches if name == 'pcg_stream' else 0,
                'nuts': nuts_launches[name],
                'nuts, a leapfrog iteration': nuts_per_iteration[name],
                'maximin value (18)': maximin_launches['value'][name],
                'maximin device_distance_fn (18)':
                maximin_launches['device_distance_fn'][name],
                'maximin gradient (18)': maximin_launches['gradient'][name],
                'QM7 surrogate Gram (19)': atoms_launches[name],
                **{f'Nystrom {step} (20)': counts[name]
                   for step, counts in nystrom_launches.items()},
                **{f'{step} (21)': counts[name]
                   for step, counts in field_launches.items()},
                **{f'{step} (22)': counts[name]
                   for step, counts in parallel_launches.items()}}

    def headline(row, rows):
        """A kernel's numbers on the summary line: those of its timed
        chunk ``row``, and a row for each factory group."""
        out = {k: row[k] for k in ('ms', 'device_ms', 'plain_ms', 'bound_ms',
                                   'bound_by', 'occupancy', 'live')}
        out['timed_chunk'] = {'group': row['group'], 'pairs': row['pairs']}
        out['groups'] = [{k: v for k, v in r.items()
                          if k not in ('occupancy', 'live')} for r in rows]
        return out

    _end_phase()
    say(json.dumps({'phase_walls_s': _PHASE['walls'],
                    'script_s': round(time.perf_counter() - T_START, 3)}))
    say(json.dumps(kron_min_n))
    say(json.dumps({'kron_route': kron_rows}))
    say(json.dumps({'kernels': [{
        'name': 'pcg_resident', 'route': 'cuda',
        'source': 'graphdot_tpu_torch/csrc/pcg_resident.cu',
        'replaces': TPU_KERNEL, 'covers': proto_row,
        'launches': launches, 'max_abs_err': max_abs_err,
        **headline(resident_main, resident_rows), 'library_ms': None,
        'split': resident_split,
        'launches_by_path': by_path('pcg_resident'),
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
            'device_ms': lone_device_ms,
            'plain_ms': stream_times['lone', 'plain'],
            'bound_ms': stream_times['lone', 'bound'][0],
            'stream_floor_ms': stream_times['lone', 'bound'][2]},
        'launches_by_path': by_path('pcg_stream'),
    }, {
        'name': 'pcg_packed', 'route': 'cuda',
        'source': 'graphdot_tpu_torch/csrc/pcg_packed.cu',
        'replaces': TPU_PACK_KERNEL, 'launches': packed_launches,
        'max_abs_err': packed_err,
        **headline(packed_main, packed_rows), 'library_ms': None,
        'split': packed_split,
        'launches_by_path': by_path('pcg_packed'),
    }]}))
    say(nvidia_smi())
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
