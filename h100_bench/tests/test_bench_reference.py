"""The plain reference against a dense product-graph solve in numpy at a
tiny size (both of its paths), its gradients against central differences,
the Gaussian-process objective's gradient, and the program's CPU path
against the reference."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from h100_bench import reference  # noqa: E402
from h100_bench.molecules import make_molecules  # noqa: E402
from h100_bench.proteins import make_proteins  # noqa: E402

HIST = json.loads((Path(__file__).resolve().parents[1] / 'configs' /
                   'qm7-tang2019.json').read_text())['dataset']['heavy_atoms']

QM7 = {'kernel': {'p': 1.0, 'q': 0.05,
                  'node': [['element', 'kronecker_delta', 0.3]],
                  'edge': [['length', 'square_exponential', 0.3]],
                  'ftol': 1e-8, 'gtol': 1e-6}}
PROTEIN = {'kernel': {'p': 1.0, 'q': 0.05,
                      'node': [['element', 'kronecker_delta', 0.2]],
                      'edge': [['length', 'square_exponential', 3.0],
                               ['ctype', 'kronecker_delta', 0.3]],
                      'ftol': 1e-8, 'gtol': 1e-6}}


def dense_numpy(g1, g2, config, theta):
    """R of a pair by the product graph written out and solved densely."""
    k = config['kernel']
    p, q = theta[0], theta[1]
    nn = len(k['node'])
    th_node, th_edge = theta[2:2 + nn], theta[2 + nn:]

    def micro(kind, x, y, h):
        if kind == 'kronecker_delta':
            return 1.0 if x == y else h
        return np.exp(-0.5 * (x - y) ** 2 / h ** 2)

    def adjacency(g):
        A = np.zeros((g['n'], g['n']))
        F = {f: np.zeros((g['n'], g['n'])) for f in g['edge']}
        for e, (i, j) in enumerate(zip(g['src'], g['dst'])):
            A[i, j] = A[j, i] = g['w'][e]
            for f in F:
                F[f][i, j] = F[f][j, i] = g['edge'][f][e]
        return A, F

    A1, F1 = adjacency(g1)
    A2, F2 = adjacency(g2)
    n1, n2 = g1['n'], g2['n']
    V = np.ones((n1, n2))
    for (f, kind, _), h in zip(k['node'], th_node):
        V *= np.array([[micro(kind, a, b, h) for b in g2['node'][f]]
                       for a in g1['node'][f]])
    E = np.ones((n1, n1, n2, n2))
    for (f, kind, _), h in zip(k['edge'], th_edge):
        E *= np.vectorize(lambda a, b: micro(kind, a, b, h))(
            F1[f][:, :, None, None], F2[f][None, None, :, :])
    W = (A1[:, :, None, None] * A2[None, None, :, :] * E).transpose(
        0, 2, 1, 3).reshape(n1 * n2, n1 * n2)
    Dx = np.kron(A1.sum(1), A2.sum(1)) / (1 - q) ** 2
    x = np.linalg.solve(np.diag(Dx / V.ravel()) - W, Dx)
    return p * p * x.sum()


def test_dense_path_agrees_with_numpy():
    graphs, _ = make_molecules(9, 6, 'cpu', HIST)
    ref = reference.Reference(QM7, 'cpu')
    theta = np.array([1.3, 0.07, 0.4, 0.25])
    pairs = np.array([[0, 1], [2, 2], [3, 5], [4, 0]])
    R = ref.values(graphs, graphs, pairs, np.log(theta))
    want = [dense_numpy(graphs[i], graphs[j], QM7, theta) for i, j in pairs]
    assert np.allclose(R, want, rtol=1e-10)


def test_edge_path_agrees_with_numpy():
    graphs = make_proteins(3, 2, 30, 40)
    ref = reference.Reference(PROTEIN, 'cpu')
    theta = np.array([0.9, 0.04, 0.25, 2.5, 0.35])
    pairs = np.array([[0, 1], [1, 1]])
    assert graphs[0]['n'] * graphs[1]['n'] > reference.DENSE_MAX
    R = ref.values(graphs, graphs, pairs, np.log(theta))
    want = [dense_numpy(graphs[i], graphs[j], PROTEIN, theta)
            for i, j in pairs]
    assert np.allclose(R, want, rtol=1e-9)


def test_gram_gradient_against_central_differences():
    graphs, _ = make_molecules(10, 4, 'cpu', HIST)
    ref = reference.Reference(QM7, 'cpu')
    lt = np.log([1.1, 0.06, 0.35, 0.28])
    K, dK = ref.gram(graphs, lt, with_grad=True)
    h = 1e-5
    for d in range(len(lt)):
        e = np.zeros_like(lt)
        e[d] = h
        fd = (ref.gram(graphs, lt + e) - ref.gram(graphs, lt - e)) / (2 * h)
        assert np.allclose(dK[:, :, d], fd, atol=1e-7), d
    assert np.allclose(np.diag(K), 1.0)


def test_gp_nll_gradient_against_central_differences():
    graphs, y = make_molecules(12, 8, 'cpu', HIST)
    ref = reference.Reference(QM7, 'cpu')
    lt = np.log([1.0, 0.05, 0.3, 0.3])
    K, dK = ref.gram(graphs, lt, with_grad=True)
    value, grad = reference.gp_nll(K, y, 0.01, dK)
    h = 1e-5
    for d in range(len(lt)):
        e = np.zeros_like(lt)
        e[d] = h
        fd = (reference.gp_nll(ref.gram(graphs, lt + e), y, 0.01)
              - reference.gp_nll(ref.gram(graphs, lt - e), y, 0.01)) / (2 * h)
        assert abs(grad[d] - fd) <= 1e-5 * max(1.0, abs(fd)), d
    assert np.isfinite(value)


@pytest.mark.parametrize('dtype', [torch.bfloat16])
def test_low_precision_reference_is_farther(dtype):
    """The control's reference in bfloat16 lies far from the float64 one."""
    graphs, _ = make_molecules(13, 5, 'cpu', HIST)
    lt = np.log([1.0, 0.05, 0.3, 0.3])
    K = reference.Reference(QM7, 'cpu').gram(graphs, lt)
    K_low = reference.Reference(QM7, 'cpu', dtype).gram(graphs, lt)
    assert 1e-4 < np.abs(K - K_low).max() < 0.5


def test_programs_cpu_path_agrees_with_the_reference():
    """The program's plain path (float32) within 1e-5 of the float64
    reference on the same arrays."""
    from graphdot_tpu_torch.kernel import Normalization
    from h100_bench.cells import port_graphs, port_kernel
    graphs, _ = make_molecules(14, 6, 'cpu', HIST)
    lt = np.log([1.2, 0.045, 0.33, 0.31])
    kernel = port_kernel(dict(QM7, kernel=dict(QM7['kernel'])), 'cpu')
    kernel.theta = lt
    K = Normalization(kernel)(port_graphs(graphs))
    K_ref = reference.Reference(QM7, 'cpu').gram(graphs, lt)
    assert np.abs(K - K_ref).max() < 1e-5
