"""The PyTorch port's MarginalizedGraphKernel against the JAX package.

The same graphs and the same hyperparameters (carried over by
``graphdot_tpu_torch.convert``) go through the JAX kernel with
``backend='pallas'`` (the fused PCG, in interpret mode on the CPU) and
through the port, whose ``backend='cuda'`` runs the CUDA kernel's plain
twin on CPU tensors and whose ``backend='edge'`` is the plain torch path.

Tolerances: rtol 1e-5, atol 1e-7 for raw Grams and atol 1e-6 for
normalized ones, as in ``test_mlgk.py``: both sides run float32 CG
stopped at ftol * N, with a different summation order.

Run as a script to rewrite ``fixtures/torch_port_gram_ref.npz``.
"""
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import networkx as nx
import pytest

torch = pytest.importorskip('torch')

from graphdot_tpu import Graph  # noqa: E402
from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu.kernel import (  # noqa: E402
    MarginalizedGraphKernel as JaxMGK,
    Normalization as JaxNormalization,
    Tang2019MolecularKernel as JaxTang2019,
)
from graphdot_tpu.testing import random_molecule_set  # noqa: E402

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch.convert import hyperparameters_from_numpy  # noqa
from graphdot_tpu_torch.kernel import (  # noqa: E402
    MarginalizedGraphKernel,
    Normalization,
    Tang2019MolecularKernel,
)
from graphdot_tpu_torch.ops import pcg_resident  # noqa: E402

from oracle import mlgk, mlgk_pair  # noqa: E402

FIXTURE = Path(__file__).parent / 'fixtures' / 'torch_port_gram_ref.npz'
#: the slice's graph set (bench.py) and how much of it the fixture covers
SLICE_SEED, SLICE_GRAPHS, FIXTURE_GRAPHS = 42, 128, 8

PORT_BACKENDS = ['cuda', 'edge']


def slice_kernels(m, **kwargs):
    """The slice's kernel, built from microkernel module ``m``."""
    return dict(
        node_kernel=m.TensorProduct(element=m.KroneckerDelta(0.2)),
        edge_kernel=m.TensorProduct(length=m.SquareExponential(0.3)),
        q=0.05, **kwargs)


def jax_reference_gram():
    """The JAX package's normalized Gram over the first graphs of the
    slice's set, with the fused PCG in interpret mode; returns (K, theta)."""
    graphs = random_molecule_set(
        SLICE_SEED, SLICE_GRAPHS, n_atoms_range=(9, 24))[:FIXTURE_GRAPHS]
    kernel = JaxMGK(**slice_kernels(jmk, backend='pallas'))
    K = JaxNormalization(kernel)(graphs)
    return K, kernel.flat_hyperparameters


# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def molecules():
    """6 molecules of 5-14 atoms (two padded-size classes)."""
    return random_molecule_set(11, 6, n_atoms_range=(5, 14))


def jax_kernel(**kwargs):
    """The JAX kernel under test, at hyperparameters away from the
    defaults so that carrying them over matters."""
    return JaxMGK(
        jmk.TensorProduct(element=jmk.KroneckerDelta(0.3)),
        jmk.TensorProduct(length=jmk.SquareExponential(0.5)),
        p=1.5, q=0.1, backend='pallas', **kwargs)


def port_kernel(jk, backend, **kwargs):
    """A port kernel with default hyperparameters, set to ``jk``'s."""
    tk = MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
        tmk.TensorProduct(length=tmk.SquareExponential(0.3)),
        backend=backend, device='cpu', **kwargs)
    return hyperparameters_from_numpy(tk, jk.flat_hyperparameters,
                                      bounds=jk.hyperparameter_bounds)


def _split(G):
    return G[:2], G[2:]


#: case -> (kernel kwargs, call)
CASES = {
    'symmetric': ({}, lambda k, G: k(G)),
    'rectangular': ({}, lambda k, G: k(*_split(G))),
    'diag': ({}, lambda k, G: k.diag(G)),
    'diag_nodal': ({}, lambda k, G: k.diag(G, nodal=True)),
    'diag_block': ({}, lambda k, G: k.diag(G, nodal='block')),
    'nodal': ({}, lambda k, G: k(G, nodal=True)),
    'nodal_rectangular': ({}, lambda k, G: k(*_split(G), nodal=True)),
    'lmin': ({}, lambda k, G: k(G, lmin=1)),
    'buckets': (dict(buckets=True), lambda k, G: k(G)),
    'buckets_nodal': (dict(buckets=True), lambda k, G: k(G, nodal=True)),
}


@lru_cache(maxsize=None)
def jax_result(case):
    kwargs, call = CASES[case]
    return call(jax_kernel(**kwargs), molecules())


@pytest.mark.parametrize('backend', PORT_BACKENDS)
@pytest.mark.parametrize('case', CASES)
def test_matches_jax(case, backend):
    kwargs, call = CASES[case]
    tk = port_kernel(jax_kernel(**kwargs), backend, **kwargs)
    want = jax_result(case)
    got = call(tk, molecules())
    if case == 'diag_block':
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
    else:
        assert got.shape == np.shape(want)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('backend', PORT_BACKENDS)
def test_normalization_matches_jax(backend):
    G = molecules()
    want = JaxNormalization(jax_kernel())(G)
    got = Normalization(port_kernel(jax_kernel(), backend))(G)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.diag(got), 1.0, rtol=0, atol=1e-12)
    # rectangular normalization goes through diag() on both sides
    want = JaxNormalization(jax_kernel())(*_split(G))
    got = Normalization(port_kernel(jax_kernel(), backend))(*_split(G))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_tang2019_matches_jax():
    G = molecules()
    jk = JaxTang2019(stopping_probability=0.05, edge_length_scale=0.3,
                     backend='pallas')
    tk = Tang2019MolecularKernel(stopping_probability=0.05,
                                 edge_length_scale=0.3, device='cpu')
    np.testing.assert_allclose(tk.theta, jk.theta, rtol=0, atol=0)
    np.testing.assert_allclose(tk.bounds, jk.bounds, rtol=0, atol=0)
    np.testing.assert_allclose(tk(G), jk(G), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tk.diag(G), jk.diag(G), rtol=1e-5,
                               atol=1e-7)


def test_reference_fixture_is_current():
    """The stored JAX reference Gram regenerates from the JAX package."""
    ref = np.load(FIXTURE)
    K, theta = jax_reference_gram()
    np.testing.assert_allclose(ref['theta'], theta, rtol=0, atol=0)
    np.testing.assert_allclose(ref['K'], K, rtol=0, atol=1e-6)


@pytest.mark.parametrize('backend', PORT_BACKENDS)
def test_port_matches_reference_fixture(backend):
    ref = np.load(FIXTURE)
    graphs = random_molecule_set(
        SLICE_SEED, SLICE_GRAPHS, n_atoms_range=(9, 24))[:FIXTURE_GRAPHS]
    tk = MarginalizedGraphKernel(**slice_kernels(tmk, backend=backend,
                                                device='cpu'))
    hyperparameters_from_numpy(tk, ref['theta'])
    K = Normalization(tk)(graphs)
    np.testing.assert_allclose(K, ref['K'], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the dense oracle (graph cases of test_mlgk.py)
# ---------------------------------------------------------------------------


def _nx(title, nodes, edges):
    g = nx.Graph(title=title)
    for n, attrs in nodes:
        g.add_node(n, **attrs)
    for u, v, attrs in edges:
        g.add_edge(u, v, **attrs)
    return g


def oracle_cases():
    unlabeled = [
        _nx('U1', [(i, {}) for i in range(3)], [(0, 1, {}), (0, 2, {})]),
        _nx('U2', [(i, {}) for i in range(3)],
            [(0, 1, {}), (0, 2, {}), (1, 2, {})]),
    ]
    labeled = [
        _nx('L1',
            [('O1', dict(category=2, charge=1.0)),
             ('H1', dict(category=3, charge=-1.0)),
             ('H2', dict(category=1, charge=2.0))],
            [('O1', 'H1', dict(order=1, length=0.5)),
             ('O1', 'H2', dict(order=2, length=1.0))]),
        _nx('L2',
            [('H1', dict(category=1, charge=1.0)),
             ('H2', dict(category=1, charge=-1.0))],
            [('H1', 'H2', dict(order=2, length=1.0))]),
    ]
    weighted = [
        _nx('W1',
            [('O1', dict(category=2)), ('H1', dict(category=3)),
             ('H2', dict(category=1))],
            [('O1', 'H1', dict(w=1.0, length=0.5)),
             ('O1', 'H2', dict(w=2.0, length=1.0))]),
        _nx('W2',
            [('H1', dict(category=1)), ('H2', dict(category=1))],
            [('H1', 'H2', dict(w=3.0, length=1.0))]),
    ]
    return {
        'unlabeled': dict(
            graphs=Graph.unify_datatype(
                [Graph.from_networkx(g) for g in unlabeled]),
            knode=tmk.Constant(1.0),
            kedge=tmk.Constant(1.0),
        ),
        'labeled': dict(
            graphs=Graph.unify_datatype(
                [Graph.from_networkx(g) for g in labeled]),
            knode=tmk.TensorProduct(
                category=tmk.KroneckerDelta(0.3),
                charge=tmk.SquareExponential(1.0) + 0.01
            ).normalized,
            kedge=tmk.Additive(
                order=tmk.KroneckerDelta(0.3),
                length=tmk.SquareExponential(0.05)
            ).normalized,
        ),
        'weighted': dict(
            graphs=Graph.unify_datatype(
                [Graph.from_networkx(g, weight='w') for g in weighted]),
            knode=tmk.TensorProduct(category=tmk.KroneckerDelta(0.3)),
            kedge=tmk.TensorProduct(length=tmk.SquareExponential(0.05)),
        ),
    }


@pytest.mark.parametrize('backend', ['cuda', 'edge', 'dense'])
@pytest.mark.parametrize('case', ['unlabeled', 'labeled', 'weighted'])
def test_matches_oracle(case, backend):
    c = oracle_cases()[case]
    G = c['graphs']
    for q in [0.01, 0.05, 0.1, 0.5]:
        k = MarginalizedGraphKernel(c['knode'], c['kedge'], q=q,
                                    backend=backend, device='cpu')
        R = k(G)
        assert R.shape == (len(G), len(G))
        np.testing.assert_allclose(R, R.T, rtol=0, atol=0)
        for idx in range(len(G)):
            gnd = mlgk(G[idx], G[idx], c['knode'], c['kedge'], q)
            assert R[idx, idx] == pytest.approx(gnd, rel=1e-4)
        gnd = mlgk(G[0], G[1], c['knode'], c['kedge'], q)
        assert R[0, 1] == pytest.approx(gnd, rel=1e-4)
    R_nodal = k(G, nodal=True)
    starts = np.concatenate([[0], np.cumsum([len(g.nodes) for g in G])])
    for idx, g in enumerate(G):
        gnd = mlgk_pair(g, g, c['knode'], c['kedge'], q)
        sub = R_nodal[starts[idx]:starts[idx + 1],
                      starts[idx]:starts[idx + 1]]
        np.testing.assert_allclose(sub, gnd, rtol=1e-4, atol=1e-6)
    gnd = mlgk(G[0], G[1], c['knode'], c['kedge'], q, lmin=1)
    assert k(G, lmin=1)[0, 1] == pytest.approx(gnd, rel=1e-4, abs=1e-6)


# ---------------------------------------------------------------------------
# variable-length and vector features (the 'vario' graphs of test_mlgk.py)
# ---------------------------------------------------------------------------


def vario_kernels(m, case):
    """(node kernel, edge kernel) of a variable-length-feature case, from
    microkernel module ``m``: 'conv' is ``tests/test_mlgk.py``'s,
    'rq' puts a rational quadratic inside the edge convolution, 'dot'
    takes the normalized inner product of the (length-2) edge spectra."""
    knode = m.TensorProduct(rings=m.Convolution(m.KroneckerDelta(0.3)))
    kedge = {
        'conv': lambda: m.Convolution(m.SquareExponential(1.0)),
        'rq': lambda: m.Convolution(m.RationalQuadratic(0.9, 1.5)),
        'dot': lambda: m.DotProduct().normalized,
    }[case]()
    return knode, m.TensorProduct(spectrum=kedge)


def vario_graphs(package):
    from test_mlgk import _g_vario
    return package.unify_datatype(
        [package.from_networkx(g, weight='w') for g in _g_vario])


VARIO_CASES = ['conv', 'rq', 'dot']


@pytest.mark.parametrize('backend', ['cuda', 'edge', 'dense'])
@pytest.mark.parametrize('case', VARIO_CASES)
def test_vario_matches_oracle(case, backend):
    """Every entry of the Gram within 1e-5 relative of the dense oracle
    (``tests/oracle.py``, float64) at each q of ``tests/test_mlgk.py``."""
    from graphdot_tpu_torch.graph import Graph as PortGraph
    G = vario_graphs(PortGraph)
    knode, kedge = vario_kernels(tmk, case)
    for q in [0.01, 0.05, 0.1, 0.5]:
        R = MarginalizedGraphKernel(knode, kedge, q=q, backend=backend,
                                    device='cpu')(G)
        want = np.array([[mlgk(a, b, knode, kedge, q) for b in G]
                         for a in G])
        np.testing.assert_allclose(R, want, rtol=1e-5, atol=0,
                                   err_msg=f'q={q}')


@pytest.mark.parametrize('backend', PORT_BACKENDS)
@pytest.mark.parametrize('case', VARIO_CASES)
def test_vario_matches_jax(case, backend):
    """K and dK against the JAX kernel (``edge``) on the same graphs: K
    rtol 1e-5, dK 1e-4 max |dK| (both float32 CG)."""
    from graphdot_tpu_torch.graph import Graph as PortGraph
    jk = JaxMGK(*vario_kernels(jmk, case), q=0.05, backend='edge')
    tk = MarginalizedGraphKernel(*vario_kernels(tmk, case), q=0.05,
                                 backend=backend, device='cpu')
    K, dK = tk(vario_graphs(PortGraph), eval_gradient=True)
    JK, JdK = jk(vario_graphs(Graph), eval_gradient=True)
    np.testing.assert_allclose(K, JK, rtol=1e-5, atol=0)
    assert dK.shape == JdK.shape == (2, 2, len(tk.theta))
    np.testing.assert_allclose(dK, JdK, rtol=0,
                               atol=1e-4 * np.abs(JdK).max())


def test_vario_is_not_kron_eligible():
    """A variable-length edge feature keeps the pairs off the kron route:
    the operands are not eligible and ``backend='kron'`` refuses them."""
    from graphdot_tpu_torch.graph import Graph as PortGraph
    from graphdot_tpu_torch.kernel.marginalized._kron import kron_eligible
    G = vario_graphs(PortGraph)
    tk = MarginalizedGraphKernel(*vario_kernels(tmk, 'conv'), q=0.05,
                                 device='cpu')
    _, bd, _ = tk._prepare_batch(G)
    ops = tk._operands(bd, bd, torch.tensor([0]), torch.tensor([1]))
    assert isinstance(ops['edge_elist_feats_1']['spectrum'], tuple)
    assert not kron_eligible(ops)
    with pytest.raises(ValueError, match='plain scalar edge features'):
        MarginalizedGraphKernel(*vario_kernels(tmk, 'conv'), q=0.05,
                                backend='kron', device='cpu')(G)


@pytest.mark.parametrize('case', VARIO_CASES)
def test_hyperparameters_from_numpy_vario(case):
    """``hyperparameters_from_numpy`` carries the three kernels'
    hyperparameters across from a JAX kernel."""
    from graphdot_tpu_torch.graph import Graph as PortGraph
    jk = JaxMGK(*vario_kernels(jmk, case), q=0.05, backend='edge')
    jk.theta = jk.theta - 0.1
    tk = MarginalizedGraphKernel(*vario_kernels(tmk, case), q=0.05,
                                 device='cpu')
    hyperparameters_from_numpy(tk, jk.flat_hyperparameters,
                               bounds=jk.hyperparameter_bounds)
    np.testing.assert_allclose(tk.flat_hyperparameters,
                               jk.flat_hyperparameters, rtol=1e-12)
    np.testing.assert_allclose(tk.theta, jk.theta, rtol=1e-12)
    np.testing.assert_allclose(tk(vario_graphs(PortGraph)),
                               jk(vario_graphs(Graph)), rtol=1e-5)


# ---------------------------------------------------------------------------
# contracts of the port
# ---------------------------------------------------------------------------


def test_import_loads_no_jax():
    code = (
        'import sys\n'
        'import graphdot_tpu_torch, graphdot_tpu_torch.kernel, '
        'graphdot_tpu_torch.microkernel, graphdot_tpu_torch.ops, '
        'graphdot_tpu_torch.convert, graphdot_tpu_torch.testing\n'
        'from graphdot_tpu_torch.ops import _build\n'
        'bad = sorted(m for m in sys.modules if m == "jax" '
        'or m.startswith(("jax.", "jaxlib")))\n'
        'assert not bad, bad\n'
    )
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, '-c', code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_eval_gradient_not_ported():
    """The gradient is ported now: every entry point returns it (values
    held against JAX in ``test_torch_gradient.py``)."""
    G = molecules()[:2]
    k = MarginalizedGraphKernel(**slice_kernels(tmk, device='cpu'))
    n_theta = len(k.theta)
    K, dK = k(G, eval_gradient=True)
    assert K.shape == (2, 2) and dK.shape == (2, 2, n_theta)
    np.testing.assert_allclose(K, k(G), rtol=0, atol=0)
    D, dD = k.diag(G, eval_gradient=True)
    assert D.shape == (2,) and dD.shape == (2, n_theta)
    K, dK = Normalization(k)(G, eval_gradient=True)
    assert dK.shape == (2, 2, n_theta)
    assert np.isfinite(dK).all()


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        MarginalizedGraphKernel(**slice_kernels(tmk, device='cuda'))


def test_backend_resolution():
    k = MarginalizedGraphKernel(**slice_kernels(tmk, device='cpu'))
    assert k.device == torch.device('cpu')
    assert k.backend.mode == 'edge'
    with pytest.raises(ValueError):
        MarginalizedGraphKernel(**slice_kernels(tmk, backend='pallas',
                                                device='cpu'))


def test_cuda_backend_on_cpu_runs_plain_twin():
    """backend='cuda' with CPU tensors runs the kernel's plain twin and
    launches nothing."""
    before = pcg_resident.launches
    G = molecules()[:3]
    R_cuda = MarginalizedGraphKernel(
        **slice_kernels(tmk, backend='cuda', device='cpu'))(G)
    R_edge = MarginalizedGraphKernel(
        **slice_kernels(tmk, backend='edge', device='cpu'))(G)
    np.testing.assert_allclose(R_cuda, R_edge, rtol=1e-6, atol=0)
    assert pcg_resident.launches == before


def test_theta_protocol_matches_jax():
    jk = JaxMGK(
        jmk.TensorProduct(element=jmk.KroneckerDelta(0.3, h_bounds='fixed')),
        jmk.TensorProduct(length=jmk.SquareExponential(0.5)),
        p=1.5, q=0.1)
    tk = MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.3, h_bounds='fixed')),
        tmk.TensorProduct(length=tmk.SquareExponential(0.5)),
        p=1.5, q=0.1, device='cpu')
    np.testing.assert_array_equal(tk.theta, jk.theta)
    np.testing.assert_array_equal(tk.bounds, jk.bounds)
    np.testing.assert_array_equal(tk.active_theta_mask, jk.active_theta_mask)
    assert tk.n_dims == jk.n_dims
    clone = tk.clone_with_theta(tk.theta + 0.1)
    np.testing.assert_allclose(clone.theta, tk.theta + 0.1)
    np.testing.assert_array_equal(tk.theta, jk.theta)


def test_hyperparameters_from_numpy_checks():
    jk = jax_kernel()
    tk = port_kernel(jk, 'edge')
    np.testing.assert_array_equal(tk.flat_hyperparameters,
                                  jk.flat_hyperparameters)
    with pytest.raises(ValueError, match='hyperparameters given'):
        hyperparameters_from_numpy(tk, jk.flat_hyperparameters[:-1])
    other = JaxMGK(
        jmk.TensorProduct(element=jmk.KroneckerDelta(0.3, (0.1, 1))),
        jmk.TensorProduct(length=jmk.SquareExponential(0.5)), q=0.1)
    with pytest.raises(ValueError, match='bounds'):
        hyperparameters_from_numpy(tk, other.flat_hyperparameters,
                                   bounds=other.hyperparameter_bounds)
    theta = jk.flat_hyperparameters.copy()
    theta[1] = 2.0   # q outside (1e-4, 1 - 1e-4)
    with pytest.raises(ValueError, match='outside their bounds'):
        hyperparameters_from_numpy(tk, theta)


if __name__ == '__main__':
    import jax
    jax.config.update('jax_platforms', 'cpu')
    K, theta = jax_reference_gram()
    np.savez(FIXTURE, K=K, theta=theta, seed=SLICE_SEED,
             n_graphs=SLICE_GRAPHS, n_first=FIXTURE_GRAPHS)
    print(f'wrote {FIXTURE}: K {K.shape}, theta {theta}')
