"""The port's samplers (``graphdot_tpu_torch.inference``) against the JAX
package's, on the CPU.

- Dual averaging and the Welford estimate against the JAX functions over 50
  steps (1e-6); ``split_rhat`` and ``ess`` on the same arrays (1e-10).
- ``hmc_step`` and ``nuts_step`` fed JAX's own draws (this file unpacks
  them by the JAX modules' key-fold scheme into the port's layout): 25
  transitions on ``_gauss_target`` of ``tests/test_inference.py``, as its
  ``test_nuts_flat_matches_nested``; q within rtol 1e-5 and atol 1e-6,
  ``n_leapfrog``, ``depth`` and ``divergent`` equal, ``accept_prob``
  within 1e-4. A 4-chain batched transition equals 4 one-chain ones (1e-6).
- The Stan-style warmup windows against the lists of the JAX ``sample``'s loop
  (``graphdot_tpu/inference/mcmc.py``), written out.
- The Gaussian-moment tests of ``tests/test_inference.py`` (NUTS, HMC, SMC
  with each move, ADVI, checkpoint resume) with the same assertions, on a
  seeded ``torch.Generator``.
- Checkpoints: a file written by either package loads in the other.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphdot_tpu.inference import checkpoint as jax_checkpoint  # noqa
from graphdot_tpu.inference import diagnostics as jax_diag  # noqa: E402
from graphdot_tpu.inference import dual_averaging as jax_da  # noqa: E402
from graphdot_tpu.inference.hmc import (  # noqa: E402
    hmc_init as jax_hmc_init, hmc_step as jax_hmc_step)
from graphdot_tpu.inference.nuts import nuts_step as jax_nuts_step  # noqa

from graphdot_tpu_torch.inference import (  # noqa: E402
    advi, ess, hmc_init, hmc_step, load_chains, nuts_step, resume_state,
    sample, save_chains, smc_sample, split_rhat)
from graphdot_tpu_torch.inference import dual_averaging as da  # noqa: E402
from graphdot_tpu_torch.inference.mcmc import warmup_windows  # noqa: E402
from graphdot_tpu_torch.inference.nuts import nuts_draws  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread. The test processes run side by side, and
    torch's default of a thread a core then makes every small op wait on
    descheduled threads (tens of times slower than one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gauss_target(D=3, seed=0):
    """``_gauss_target`` of ``tests/test_inference.py`` in both packages:
    (JAX log density of [D], the port's of [C, D], mean, covariance)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D)) * 0.5
    cov = A @ A.T + np.eye(D)
    prec = np.linalg.inv(cov).astype(np.float32)
    mu = rng.normal(size=D).astype(np.float32)
    jprec, jmu = jnp.asarray(prec), jnp.asarray(mu)
    tprec, tmu = torch.from_numpy(prec), torch.from_numpy(mu)

    def jax_logp(t):
        d = t - jmu
        return -0.5 * d @ jprec @ d

    def port_logp(t):
        d = t - tmu
        return -0.5 * torch.einsum('ci,ij,cj->c', d, tprec, d)

    return jax_logp, port_logp, mu, cov


def jax_nuts_draws(key, n_dims, max_depth):
    """The draws of JAX's ``nuts_step(key, ...)`` for one chain, in
    :func:`~graphdot_tpu_torch.inference.nuts.nuts_draws`'s layout (a
    leading chain axis of 1), by the JAX module's folds of its key."""
    k_mom, k_tree = jax.random.split(key)
    fold = jax.random.fold_in
    half = 1 << (max_depth - 1)
    within = [[jax.random.uniform(fold(fold(k_tree, 2 * d + 1), j))
               for j in range(half)] for d in range(max_depth)]
    return {
        'p0': np.asarray(jax.random.normal(k_mom, (n_dims,)))[None],
        'direction': np.array([[bool(jax.random.bernoulli(
            fold(k_tree, 2 * d))) for d in range(max_depth)]]),
        'within': np.asarray(within, dtype=np.float32)[None],
        'merge': np.array([[jax.random.uniform(fold(k_tree, 2 * d + 11311))
                            for d in range(max_depth)]], dtype=np.float32),
    }


def jax_hmc_draws(key, n_dims):
    """The draws of JAX's ``hmc_step(key, ...)`` for one chain, in
    ``hmc_draws``'s layout."""
    k_mom, k_acc = jax.random.split(key)
    return {'p0': np.asarray(jax.random.normal(k_mom, (n_dims,)))[None],
            'u': np.asarray(jax.random.uniform(k_acc))[None]}


def as_torch(draws):
    return {k: torch.as_tensor(np.array(v)) for k, v in draws.items()}


# ---------------------------------------------------------------------------
# adaptation and diagnostics
# ---------------------------------------------------------------------------


def test_dual_averaging_matches_jax():
    rng = np.random.default_rng(0)
    accepts = rng.uniform(size=50).astype(np.float32)
    j, t = jax_da.da_init(jnp.float32(0.7)), da.da_init(0.7)
    for a in accepts:
        j = jax_da.da_update(j, jnp.float32(a), target=0.8)
        t = da.da_update(t, torch.tensor(a), target=0.8)
        for name in j._fields:
            np.testing.assert_allclose(float(getattr(t, name)),
                                       float(getattr(j, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)


def test_welford_matches_jax():
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(50, 3, 4)).astype(np.float32) * [1, 2, 3, 0.5]
    j = jax.vmap(lambda _: jax_da.welford_init(4))(jnp.arange(3))
    t = da.welford_init(3, 4)
    for x in xs:
        j = jax.vmap(jax_da.welford_update)(j, jnp.asarray(x))
        t = da.welford_update(t, torch.from_numpy(x))
        for name in j._fields:
            np.testing.assert_allclose(getattr(t, name).numpy(),
                                       np.asarray(getattr(j, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    for reg in (True, False):
        np.testing.assert_allclose(
            da.welford_variance(t, reg).numpy(),
            np.asarray(jax.vmap(lambda s: jax_da.welford_variance(s, reg))(
                j)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('shape', [(4, 100), (4, 101, 3), (2, 40, 1)])
def test_diagnostics_match_jax(shape):
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).cumsum(axis=1) * 0.1 \
        + rng.normal(size=shape)
    np.testing.assert_allclose(split_rhat(x), jax_diag.split_rhat(x),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(ess(x), jax_diag.ess(x), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(ess(torch.from_numpy(x)), jax_diag.ess(x),
                               rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# transitions, draw for draw
# ---------------------------------------------------------------------------


def _assert_same_transition(state, info, jstate, jinfo, i):
    np.testing.assert_allclose(state.q.numpy()[0], np.asarray(jstate.q),
                               rtol=1e-5, atol=1e-6, err_msg=str(i))
    for key in ('n_leapfrog', 'depth', 'divergent'):
        if key in jinfo:
            assert int(info[key][0]) == int(jinfo[key]), (i, key)
    np.testing.assert_allclose(float(info['accept_prob'][0]),
                               float(jinfo['accept_prob']), rtol=0,
                               atol=1e-4, err_msg=str(i))


def test_nuts_step_matches_jax_draw_for_draw():
    """25 transitions from JAX's keys, as ``test_nuts_flat_matches_nested``:
    the port's batched flat loop fed JAX's draws makes JAX's transition."""
    jlogp, tlogp, mu, _ = gauss_target(3, seed=4)
    jstate = jax_hmc_init(jlogp, jnp.asarray(mu) + 0.5)
    state = hmc_init(tlogp, torch.from_numpy(mu + 0.5)[None])
    inv_mass = np.array([1.0, 0.5, 2.0], dtype=np.float32)
    flat = jax.jit(lambda k, s: jax_nuts_step(
        k, s, jlogp, 0.4, jnp.asarray(inv_mass), max_depth=6))
    depths = set()
    for i in range(25):
        key = jax.random.PRNGKey(100 + i)
        jstate, jinfo = flat(key, jstate)
        state, info = nuts_step(as_torch(jax_nuts_draws(key, 3, 6)), state,
                                tlogp, 0.4, torch.from_numpy(inv_mass),
                                max_depth=6)
        _assert_same_transition(state, info, jstate, jinfo, i)
        depths.add(int(jinfo['depth']))
    assert len(depths) >= 3, depths


def test_hmc_step_matches_jax_draw_for_draw():
    jlogp, tlogp, mu, _ = gauss_target(3, seed=4)
    jstate = jax_hmc_init(jlogp, jnp.asarray(mu) + 0.5)
    state = hmc_init(tlogp, torch.from_numpy(mu + 0.5)[None])
    inv_mass = np.array([1.0, 0.5, 2.0], dtype=np.float32)
    step = jax.jit(lambda k, s: jax_hmc_step(
        k, s, jlogp, 0.6, jnp.asarray(inv_mass), 8))
    accepted = 0
    for i in range(25):
        key = jax.random.PRNGKey(200 + i)
        q_before = state.q.clone()
        jstate, jinfo = step(key, jstate)
        state, info = hmc_step(as_torch(jax_hmc_draws(key, 3)), state,
                               tlogp, 0.6, torch.from_numpy(inv_mass), 8)
        _assert_same_transition(state, info, jstate, jinfo, i)
        assert bool(info['divergent'][0]) == bool(jinfo['divergent'])
        accepted += int(not torch.equal(q_before, state.q))
    assert 0 < accepted < 25, accepted


def test_batched_nuts_equals_single_chains():
    """4 chains in one batched transition, against each chain alone with
    its own rows of the same draws: chains stop at different iterations,
    and the stopped ones are masked."""
    _, tlogp, mu, _ = gauss_target(3, seed=5)
    gen = torch.Generator().manual_seed(11)
    q0 = torch.from_numpy(mu) + torch.randn(4, 3, generator=gen)
    inv_mass = torch.tensor([1.0, 0.5, 2.0])
    batched = hmc_init(tlogp, q0)
    singles = [hmc_init(tlogp, q0[c:c + 1]) for c in range(4)]
    seen = set()
    for i in range(10):
        draws = nuts_draws(gen, 4, 3, 6)
        batched, info = nuts_step(draws, batched, tlogp, 0.5, inv_mass,
                                  max_depth=6)
        seen.add(tuple(info['n_leapfrog'].tolist()))
        for c in range(4):
            mine = {k: v[c:c + 1] for k, v in draws.items()}
            singles[c], one = nuts_step(mine, singles[c], tlogp, 0.5,
                                        inv_mass, max_depth=6)
            for field in ('q', 'logp', 'grad'):
                np.testing.assert_allclose(
                    getattr(singles[c], field).numpy(),
                    getattr(batched, field)[c:c + 1].numpy(), rtol=0,
                    atol=1e-6, err_msg=f'{i} {c} {field}')
            for key in ('n_leapfrog', 'depth', 'divergent'):
                assert int(one[key][0]) == int(info[key][c]), (i, c, key)
            np.testing.assert_allclose(float(one['accept_prob'][0]),
                                       float(info['accept_prob'][c]),
                                       rtol=0, atol=1e-6)
    # the chains' trees differed within a transition
    assert any(len(set(n)) > 1 for n in seen), seen


#: n_warmup -> (first fast window, slow windows, last fast window), the
#: lists that the JAX ``sample``'s loop (graphdot_tpu/inference/mcmc.py) gives
JAX_WINDOWS = {
    16: (2, [13], 1),
    40: (6, [10, 20], 4),
    100: (15, [10, 20, 45], 10),
    300: (45, [28, 56, 112, 29], 30),
    1000: (150, [93, 186, 372, 99], 100),
}


@pytest.mark.parametrize('n_warmup', sorted(JAX_WINDOWS))
def test_warmup_windows_match_jax(n_warmup):
    assert warmup_windows(n_warmup) == JAX_WINDOWS[n_warmup]


# ---------------------------------------------------------------------------
# the Gaussian-moment tests of tests/test_inference.py
# ---------------------------------------------------------------------------


def test_nuts_gaussian_moments():
    # the JAX test's limits on 8 chains of 1000 draws, where JAX draws 4 of
    # 400: with a bulk ESS near 1000 a mean's standard error is ~0.06, so
    # 0.1 fails at one seed in ten; at 8 x 1000 it is ~0.02, and the limit
    # holds ~5 standard errors whatever the seed
    D = 3
    _, logp, mu, cov = gauss_target(D)
    out = sample(logp, torch.Generator().manual_seed(0), n_chains=8,
                 n_warmup=300, n_samples=1000, init=torch.zeros(D),
                 device='cpu')
    assert out['samples'].shape == (8, 1000, D)
    assert out['logp'].shape == out['accept_prob'].shape == (8, 1000)
    s = out['samples'].numpy().reshape(-1, D)
    assert np.abs(s.mean(0) - mu).max() < 0.1
    assert np.abs(np.cov(s.T) - cov).max() / np.abs(cov).max() < 0.15
    assert np.all(split_rhat(out['samples']) < 1.05)
    assert np.all(ess(out['samples']) > 100)
    assert out['divergent'].float().mean() < 0.01


def test_hmc_gaussian_moments():
    D = 3
    _, logp, mu, cov = gauss_target(D, seed=1)
    out = sample(logp, torch.Generator().manual_seed(1), n_chains=4,
                 n_warmup=300, n_samples=400, init=torch.zeros(D),
                 algorithm='hmc', n_leapfrog=16, device='cpu')
    s = out['samples'].numpy().reshape(-1, D)
    assert np.abs(s.mean(0) - mu).max() < 0.15
    assert np.all(split_rhat(out['samples']) < 1.1)


def _prior_and_like(logp):
    def log_prior(t):
        return -0.5 * torch.sum((t / 5.0) ** 2, dim=-1)

    def log_like(t):
        return logp(t) - log_prior(t)
    return log_prior, log_like


def test_smc_gaussian():
    D = 2
    _, logp, mu, cov = gauss_target(D, seed=2)
    gen = torch.Generator().manual_seed(3)
    init = 5.0 * torch.randn(1024, D, generator=gen)
    out = smc_sample(*_prior_and_like(logp), gen, init=init, n_moves=10,
                     step_size=0.5, device='cpu')
    s = out['samples'].numpy()
    assert np.abs(s.mean(0) - mu).max() < 0.3
    assert out['beta_history'][-1] == 1.0
    assert np.isfinite(out['log_evidence'])


@pytest.mark.parametrize('moves', ['hmc', 'nuts'])
def test_smc_gradient_moves(moves):
    D = 4
    _, logp, mu, cov = gauss_target(D, seed=7)
    gen = torch.Generator().manual_seed(8)
    init = 5.0 * torch.randn(256, D, generator=gen)
    out = smc_sample(*_prior_and_like(logp), gen, init=init, n_moves=3,
                     step_size=0.3, moves=moves, device='cpu')
    s = out['samples'].numpy()
    assert np.abs(s.mean(0) - mu).max() < 0.35
    assert out['beta_history'][-1] == 1.0


def test_advi_gaussian():
    D = 3
    _, logp, mu, cov = gauss_target(D, seed=3)
    out = advi(logp, torch.Generator().manual_seed(5), init=torch.zeros(D),
               n_steps=1500, learning_rate=2e-2, device='cpu')
    assert np.abs(out['mu'].numpy() - mu).max() < 0.15
    # marginal stds bounded by true stds for mean-field
    assert np.all(out['sigma'].numpy() <= np.sqrt(np.diag(cov)) + 0.1)
    assert out['elbo_history'].shape == (1500,)
    draws = out['sample'](torch.Generator().manual_seed(0), 7)
    assert draws.shape == (7, D)


def test_checkpoint_resume(tmp_path):
    _, logp, mu, cov = gauss_target(2, seed=9)
    out = sample(logp, torch.Generator().manual_seed(9), n_chains=2,
                 n_warmup=100, n_samples=50, init=torch.zeros(2),
                 device='cpu')
    path = str(tmp_path / 'chains.npz')
    save_chains(path, out, extra={'round': 1})
    loaded = load_chains(path)
    assert np.allclose(loaded['samples'], out['samples'].numpy())
    assert loaded['extra']['round'] == 1

    init, step_size, inv_mass = resume_state(loaded)
    out2 = sample(logp, torch.Generator().manual_seed(10), n_chains=2,
                  n_samples=50, init=init, step_size=step_size,
                  inv_mass=inv_mass, device='cpu')
    s = out2['samples'].numpy()
    assert np.all(np.isfinite(s))
    assert out2['step_size'] == pytest.approx(step_size)
    # resumed chains continue sampling the same target
    assert np.abs(s.reshape(-1, 2).mean(0) - mu).max() < 0.5


def test_checkpoints_load_across_packages(tmp_path):
    """A checkpoint written by the port loads with JAX's ``load_chains``,
    and one written by JAX with the port's: the same ``.npz`` format."""
    rng = np.random.default_rng(3)
    out = {'samples': torch.from_numpy(rng.normal(size=(2, 5, 3))
                                       .astype(np.float32)),
           'logp': torch.zeros(2, 5), 'accept_prob': torch.ones(2, 5),
           'divergent': torch.zeros(2, 5, dtype=torch.bool),
           'step_size': 0.25, 'inv_mass': torch.tensor([1.0, 2.0, 3.0])}
    port_path = str(tmp_path / 'port.npz')
    save_chains(port_path, out, extra={'seed': 4})
    got = jax_checkpoint.load_chains(port_path)
    assert np.array_equal(got['samples'], out['samples'].numpy())
    assert got['divergent'].dtype == bool and float(got['step_size']) == 0.25
    assert got['extra']['seed'] == 4
    jax_out = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
                   else jnp.float32(v)) for k, v in out.items()}
    jax_path = str(tmp_path / 'jax.npz')
    jax_checkpoint.save_chains(jax_path, jax_out, extra={'seed': 5})
    back = load_chains(jax_path)
    assert np.array_equal(back['samples'], out['samples'].numpy())
    assert back['extra']['seed'] == 5
    init, step_size, inv_mass = resume_state(back)
    assert np.array_equal(init, out['samples'].numpy()[:, -1])
    assert step_size == 0.25 and np.array_equal(inv_mass, [1.0, 2.0, 3.0])
