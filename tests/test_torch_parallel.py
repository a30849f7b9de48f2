"""The port's multi-process layer (``graphdot_tpu_torch.parallel``, and the
samplers' ``mesh``) against the JAX package's ``parallel``, on the CPU.

Two gloo ranks run in subprocesses, as ``tests/test_distributed.py`` starts
its two JAX processes (a free port on localhost, 120 s each). On the
molecules of ``tests/test_inference.py``'s ``gp_problem`` (8 of 5-9 atoms,
one size class) and on 10 molecules of ``bench_nuts.py``'s set (three size
classes), each rank solves its share of the jobs of every group and
``sharded_gram_fn`` assembles the whole Gram on both ranks:

- the ``gp_problem`` Gram within 1e-6 of the JAX ``sharded_gram_fn`` over
  the 8 CPU devices of ``tests/conftest.py`` (backend ``'edge'``), and both
  Grams within 1e-6 of the unsharded ``GramFactory.gram``;
- ``sharded_gp_solve`` of ``test_sharded_cg_solve_matches_cholesky``'s
  system against the JAX ``sharded_gp_solve`` and a float64 solve (rtol
  1e-4, atol 1e-5);
- ``sample(mesh=...)`` (NUTS over ``gp_problem``'s ``GPRLogProb``, 4
  chains, 2 a rank) and ``smc_sample(mesh=...)`` (a Gaussian, NUTS and
  random-walk moves) bitwise equal to the unsharded calls from the same
  seed.

In one process: the partition covers every job once for 1-5 ranks, the
shares of 2 and 4 ranks assemble the Gram within 1e-6, ``make_mesh``'s -1
and its cover check, two-sided factories and a CUDA rank without a card
raise.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu import testing as jax_testing  # noqa: E402
from graphdot_tpu.inference import GramFactory as JaxGramFactory  # noqa
from graphdot_tpu.kernel import MarginalizedGraphKernel as JaxMGK  # noqa
from graphdot_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from graphdot_tpu.parallel import sharded_gp_solve as jax_gp_solve  # noqa
from graphdot_tpu.parallel import sharded_gram_fn as jax_gram_fn  # noqa

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch import testing as port_testing  # noqa: E402
from graphdot_tpu_torch.inference import GramFactory  # noqa: E402
from graphdot_tpu_torch.kernel import MarginalizedGraphKernel  # noqa: E402
from graphdot_tpu_torch.parallel import (  # noqa: E402
    init_distributed, make_mesh, sharded_gram_fn)
from graphdot_tpu_torch.parallel.gram import (  # noqa: E402
    assemble, job_share, share_groups, solve_share)

ROOT = Path(__file__).resolve().parent.parent
#: gp_problem of tests/test_inference.py, and 10 of bench_nuts.py's set
GP_SET, BENCH_SET = (0, 8, (5, 9)), (7, 32, (9, 24))

_CHILD = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from graphdot_tpu_torch import microkernel as tmk, testing
from graphdot_tpu_torch.inference import GPRLogProb, GramFactory, sample, \
    smc_sample
from graphdot_tpu_torch.kernel import MarginalizedGraphKernel
from graphdot_tpu_torch.parallel import (init_distributed, make_mesh,
    sharded_gp_solve, sharded_gram_fn)

port, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
assert init_distributed(f'localhost:{port}', 2, rank,
                        device='cpu') == torch.device('cpu')
assert torch.distributed.get_backend() == 'gloo'


def kernel():
    return MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
        tmk.TensorProduct(length=tmk.SquareExponential(0.3)), q=0.05,
        device='cpu')


result = {}
gp = testing.random_molecule_set(0, 8, n_atoms_range=(5, 9))
bench = testing.random_molecule_set(7, 32, n_atoms_range=(9, 24))[:10]
pairs = make_mesh({'pairs': -1})
assert pairs.shape == {'pairs': 2} and pairs.axis_index() == rank
for name, graphs in (('gp', gp), ('bench', bench)):
    factory = GramFactory(kernel(), graphs, maxiter=64)
    gram = sharded_gram_fn(factory, pairs)
    theta = factory.theta0
    K = gram(theta)
    want = factory.gram(theta)
    err = float((K - want).abs().max())
    assert err <= 1e-6, (name, err)
    result[f'K_{name}'] = K.numpy()

rng = np.random.default_rng(0)
n = 64
A = rng.normal(size=(n, n)).astype(np.float32) * 0.1
Kcg = torch.from_numpy(A @ A.T + np.eye(n, dtype=np.float32))
y = torch.from_numpy(rng.normal(size=n).astype(np.float32))
result['x_cg'] = sharded_gp_solve(pairs, Kcg, y, 0.01, tol=1e-7).numpy()

chains = make_mesh({'chains': 2})
lp = GPRLogProb(kernel(), gp, np.random.default_rng(1).normal(size=8),
                alpha=1e-2)
runs = {}
for mesh in (chains, None):
    if mesh is None and rank != 0:
        break
    runs[mesh is None] = sample(
        lp, torch.Generator().manual_seed(3), n_chains=4, n_warmup=12,
        n_samples=3, init=lp.theta0, max_depth=4, init_jitter=0.05,
        mesh=mesh, chain_axis='chains', device='cpu')
assert runs[False]['samples'].shape == (4, 3, 4)


def log_prior(t):
    return -0.5 * torch.sum(t * t, dim=-1)


def log_like(t):
    return -0.5 * torch.sum(((t - 1.0) / 0.5) ** 2, dim=-1)


smc = {}
for moves in ('nuts', 'rw'):
    for mesh in (chains, None):
        if mesh is None and rank != 0:
            break
        smc[moves, mesh is None] = smc_sample(
            log_prior, log_like, torch.Generator().manual_seed(5),
            n_particles=16, init=torch.from_numpy(np.random.default_rng(
                2).normal(size=(16, 2)).astype(np.float32)), n_moves=2,
            moves=moves, max_depth=3, mesh=mesh, particle_axis='chains',
            device='cpu')
if rank == 0:
    a, b = runs[False], runs[True]
    for key in ('samples', 'logp', 'accept_prob', 'divergent', 'inv_mass'):
        assert torch.equal(a[key], b[key]), key
    assert a['step_size'] == b['step_size']
    for moves in ('nuts', 'rw'):
        a, b = smc[moves, False], smc[moves, True]
        assert torch.equal(a['samples'], b['samples']), moves
        assert a['log_evidence'] == b['log_evidence'], moves
        assert a['beta_history'] == b['beta_history'], moves
        assert a['n_stages'] == b['n_stages'] > 1, moves
    np.savez(out, **result)
torch.distributed.destroy_process_group()
print('RANK', rank, 'OK', flush=True)
"""


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread, as the test processes run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def bench_factory():
    """The factory of 10 of bench_nuts.py's molecules: three groups."""
    graphs = port_testing.random_molecule_set(
        BENCH_SET[0], BENCH_SET[1], n_atoms_range=BENCH_SET[2])[:10]
    return GramFactory(port_kernel(), graphs, maxiter=64)


def jax_kernel():
    return JaxMGK(jmk.TensorProduct(element=jmk.KroneckerDelta(0.2)),
                  jmk.TensorProduct(length=jmk.SquareExponential(0.3)),
                  q=0.05, backend='edge')


def port_kernel():
    return MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
        tmk.TensorProduct(length=tmk.SquareExponential(0.3)), q=0.05,
        device='cpu')


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    """Runs the two gloo ranks once; returns rank 0's npz."""
    out = tmp_path_factory.mktemp('ranks') / 'rank0.npz'
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [str(ROOT)] + env.get('PYTHONPATH', '').split(os.pathsep))
    procs = [subprocess.Popen(
        [sys.executable, '-c', _CHILD, str(port), str(rank), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out_text, _ = p.communicate(timeout=120)
            outs.append(out_text)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {rank} failed:\n{text}'
        assert f'RANK {rank} OK' in text, text
    return np.load(out)


def test_two_ranks_gram_matches_jax_sharded(two_ranks):
    graphs = jax_testing.random_molecule_set(
        GP_SET[0], GP_SET[1], n_atoms_range=GP_SET[2])
    factory = JaxGramFactory(jax_kernel(), graphs, normalize=True)
    gram = jax_gram_fn(factory, jax_make_mesh({'pairs': 8}))
    want = np.asarray(gram(jnp.asarray(factory.theta0, jnp.float32)))
    np.testing.assert_allclose(two_ranks['K_gp'], want, rtol=0, atol=1e-6)
    assert two_ranks['K_bench'].shape == (10, 10)
    np.testing.assert_allclose(np.diagonal(two_ranks['K_bench']), 1.0,
                               rtol=0, atol=1e-6)


def test_two_ranks_cg_matches_jax_sharded(two_ranks):
    rng = np.random.default_rng(0)
    n = 64
    A = rng.normal(size=(n, n)).astype(np.float32) * 0.1
    K = A @ A.T + np.eye(n, dtype=np.float32)
    y = rng.normal(size=n).astype(np.float32)
    want = np.asarray(jax_gp_solve(jax_make_mesh({'pairs': 8}),
                                   jnp.asarray(K), jnp.asarray(y), 0.01,
                                   tol=1e-7))
    exact = np.linalg.solve(K.astype(np.float64) + 0.01 * np.eye(n), y)
    np.testing.assert_allclose(two_ranks['x_cg'], exact, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(two_ranks['x_cg'], want, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize('size', [1, 2, 3, 4, 5])
def test_shares_cover_every_job_once(size, bench_factory):
    factory = bench_factory
    per_rank = [share_groups(factory, rank, size) for rank in range(size)]
    for g, grp in enumerate(factory._plan.groups):
        pos = np.concatenate([shares[g]['pos'] for shares in per_rank])
        assert np.array_equal(pos, grp['pos'])
        for key in ('l1', 'l2', 'rows', 'cols'):
            assert torch.equal(torch.cat([s[g][key] for s in per_rank]),
                               grp[key])
    n = 11
    bounds = [job_share(n, rank, size) for rank in range(size)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


@pytest.mark.parametrize('size', [2, 4])
def test_shares_assemble_the_gram(size, bench_factory):
    factory = bench_factory
    theta = factory.theta0
    values = [solve_share(factory, theta, share_groups(factory, rank, size))
              for rank in range(size)]
    K = assemble(factory, [torch.cat(v) for v in zip(*values)])
    want = factory.gram(theta)
    assert float((K - want).abs().max()) <= 1e-6
    # one process, no process group: the mesh has one rank
    K1 = sharded_gram_fn(factory, make_mesh())(theta)
    assert float((K1 - want).abs().max()) <= 1e-6


def test_make_mesh_and_errors():
    mesh = make_mesh({'pairs': -1, 'chains': 1})
    assert mesh.shape == {'pairs': 1, 'chains': 1}
    assert mesh.axis_index('chains') == 0 and mesh.axis_size() == 1
    with pytest.raises(AssertionError):
        make_mesh({'pairs': 2})
    graphs = port_testing.random_molecule_set(0, 4, n_atoms_range=(5, 9))
    two = GramFactory(port_kernel(), graphs[:2], normalize=False,
                      graphs2=graphs[2:])
    with pytest.raises(NotImplementedError):
        sharded_gram_fn(two, mesh)
    if not torch.cuda.is_available():
        # a CUDA rank without a card raises; nothing falls back to gloo
        with pytest.raises(RuntimeError):
            init_distributed('localhost:1', 1, 0, device='cuda')
        assert not torch.distributed.is_initialized()


def test_world_of_one_rank_over_gloo():
    """A process group of one rank, as the card runs over NCCL: the
    collectives go through the backend, the Gram equals the factory's,
    the chains the unsharded ones, bit for bit."""
    import torch.distributed as dist
    from graphdot_tpu_torch.inference import GPRLogProb, sample
    from graphdot_tpu_torch.parallel import sharded_gp_solve
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    assert init_distributed(f'localhost:{port}', 1, 0, device='cpu') == \
        torch.device('cpu')
    try:
        assert dist.get_backend() == 'gloo' and dist.get_world_size() == 1
        mesh = make_mesh({'pairs': -1})
        graphs = port_testing.random_molecule_set(
            GP_SET[0], GP_SET[1], n_atoms_range=GP_SET[2])
        factory = GramFactory(port_kernel(), graphs, maxiter=64)
        K = sharded_gram_fn(factory, mesh)(factory.theta0)
        assert torch.equal(K, factory.gram(factory.theta0))
        y = torch.from_numpy(np.random.default_rng(0).normal(size=8))
        x = sharded_gp_solve(mesh, K.double(), y, 1e-2, tol=1e-10)
        exact = np.linalg.solve(K.double().numpy() + 1e-2 * np.eye(8), y)
        np.testing.assert_allclose(x.numpy(), exact, rtol=1e-4, atol=1e-5)
        lp = GPRLogProb(port_kernel(), graphs, np.random.default_rng(
            1).normal(size=8), alpha=1e-2)
        runs = [sample(lp, torch.Generator().manual_seed(0), n_chains=2,
                       n_samples=2, init=lp.theta0, step_size=0.3,
                       inv_mass=np.ones(4), max_depth=3, mesh=m,
                       device='cpu')
                for m in (make_mesh({'chains': 1}), None)]
        assert torch.equal(runs[0]['samples'], runs[1]['samples'])
    finally:
        dist.destroy_process_group()
