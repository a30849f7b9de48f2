"""The port's per-phase timing (``timing=``, its copy of ``Timer``) and
``traits`` against the JAX package's; the live extent that the CUDA PCG
kernels solve over, checked on the plain twins; and the build key of the
kernel libraries.

The live-extent tests hold the rule of ``csrc/pcg_block.cuh`` (an edge is
live when its row or column of T holds a nonzero; a side's extent ends at
the largest node of a live edge or of a nonzero b) to what the plain twins
compute: x is exactly 0 on every product node outside the extent, for the
value and tangent systems that ``mlgk_setup`` and ``mlgk_tangents`` build
for molecule pairs of mixed sizes, one graph with an isolated last node
among them. A kernel that skips those nodes therefore loses nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from graphdot_tpu.kernel import MarginalizedGraphKernel as JaxKernel  # noqa
from graphdot_tpu.util import Timer as JaxTimer  # noqa: E402

from graphdot_tpu_torch.graph import Graph  # noqa: E402
from graphdot_tpu_torch.graph.frame import DataFrame  # noqa: E402
from graphdot_tpu_torch.kernel import (  # noqa: E402
    MarginalizedGraphKernel, Normalization, Tang2019MolecularKernel)
from graphdot_tpu_torch.kernel.marginalized import _solver  # noqa: E402
from graphdot_tpu_torch.kernel.marginalized._solver import (  # noqa: E402
    _packed_tangents, _plain_solve, cuda_tangent_solver, mlgk_setup,
    mlgk_tangents)
from graphdot_tpu_torch.microkernel import (  # noqa: E402
    KroneckerDelta, SquareExponential, TensorProduct)
from graphdot_tpu_torch.ops import _build  # noqa: E402
from graphdot_tpu_torch.ops.pcg import (  # noqa: E402
    live_extent, pcg_packed_reference, pcg_resident_reference)
from graphdot_tpu_torch.testing import random_molecule_set  # noqa: E402
from graphdot_tpu_torch.util import Timer  # noqa: E402


def _kernel(**kw):
    return MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)), q=0.05, device='cpu',
        **kw)


def _isolated_last(n):
    """A molecule-like chain of n - 1 atoms and one more atom, the last
    node, with no bond."""
    src = np.arange(n - 2, dtype=np.uint32)
    length = np.linspace(1.1, 1.6, n - 2).astype(np.float32)
    nodes = DataFrame({'!i': np.arange(n),
                       'element': np.resize([6, 8, 1], n).astype(np.int8)})
    edges = DataFrame({'!i': src, '!j': src + 1,
                       '!w': np.exp(-0.5 * (length - 1.4) ** 2)
                       .astype(np.float32), 'length': length})
    return Graph(nodes, edges, title=f'isolated-{n}')


def _graphs():
    """Molecules of 3-13 atoms and one of 7 whose last atom is isolated."""
    return Graph.unify_datatype(
        list(random_molecule_set(21, 5, n_atoms_range=(3, 14)))
        + [_isolated_last(7)])


# ---------------------------------------------------------------------------
# timing= and traits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('wrap', ['kernel', 'normalization', 'tang2019'])
@pytest.mark.parametrize('method', ['call', 'diag'])
def test_timing_report(capsys, wrap, method):
    """timing=True prints the per-phase report through the kernel and
    both wrappers that pass options on, as tests/test_graph.py holds the
    JAX class to."""
    graphs = random_molecule_set(5, 3, n_atoms_range=(4, 8))
    if wrap == 'tang2019':
        k = Tang2019MolecularKernel(device='cpu')
    elif wrap == 'normalization':
        k = Normalization(_kernel())
    else:
        k = _kernel()
    if method == 'diag' and wrap == 'normalization':
        Normalization(_kernel())(graphs, graphs[:2], timing=True)
    elif method == 'diag':
        k.diag(graphs, timing=True)
    else:
        k(graphs, timing=True)
    out = capsys.readouterr().out
    assert 'ms on solving pair jobs' in out
    if method == 'call':
        assert 'ms on generating jobs' in out
        assert 'ms on collecting result' in out
    k(graphs)
    assert capsys.readouterr().out == ''


def test_timing_report_with_gradient(capsys):
    graphs = random_molecule_set(5, 3, n_atoms_range=(4, 8))
    Normalization(_kernel())(graphs, eval_gradient=True, timing=True)
    assert 'ms on solving pair jobs' in capsys.readouterr().out


def test_timer_matches_jax(monkeypatch, capsys):
    """The same tic/toc sequence on a fake clock accumulates and reports
    alike in both timers."""
    import time
    reports = []
    for timer in (Timer(), JaxTimer()):
        clock = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125, 3.0, 3.0625])
        monkeypatch.setattr(time, 'perf_counter', lambda: next(clock))
        for tag in ('a', 'b', 'a', 'c'):
            timer.tic(tag)
            timer.toc(tag)
        assert timer.dt == {'a': 0.375, 'b': 0.5, 'c': 0.0625}
        for unit in ('s', 'ms', 'us'):
            timer.report(unit=unit)
        with pytest.raises(ValueError, match='Unknown unit'):
            timer.report(unit='h')
        reports.append(capsys.readouterr().out)
        timer.reset()
        assert timer.dt == {}
    assert reports[0] == reports[1]
    assert '375.0 ms on a' in reports[0]


@pytest.mark.parametrize('kwargs', [
    {}, dict(diagonal=True), dict(symmetric=True, nodal=True),
    dict(nodal='block', lmin=1, eval_gradient=True),
])
def test_traits_match_jax(kwargs):
    port = MarginalizedGraphKernel.traits(**kwargs)
    jax = JaxKernel.traits(**kwargs)
    assert port._fields == jax._fields
    assert tuple(port) == tuple(jax)
    assert type(port).__name__ == type(jax).__name__ == 'Traits'


# ---------------------------------------------------------------------------
# the live extent of csrc/pcg_block.cuh, on the plain twins
# ---------------------------------------------------------------------------

def _systems():
    graphs = _graphs()
    kernel = _kernel(backend='cuda')
    batch, bd, _ = kernel._prepare_batch(graphs)
    i, j = np.triu_indices(len(graphs))
    ops = kernel._operands(bd, bd, torch.as_tensor(i), torch.as_tensor(j))
    theta = kernel._theta_vector()
    kw = dict(knode=kernel.node_kernel, kedge=kernel.edge_kernel,
              n_p_theta=1, mode='cuda')
    s = mlgk_setup(theta, ops, **kw)
    maxiter = kernel.maxiter(batch.node_mask.shape[1])
    operator = [s[f].contiguous() for f in (
        'T', 'esrc_1', 'edst_1', 'esrc_2', 'edst_2', 'diag', 'precond')]
    return s, operator, maxiter, (theta, ops, kw), (i, j)


def _outside(n1, n2, N1, N2):
    """[P, N1, N2] mask of the product nodes outside each extent."""
    i1 = torch.arange(N1)[None, :, None]
    i2 = torch.arange(N2)[None, None, :]
    return (i1 >= n1[:, None, None]) | (i2 >= n2[:, None, None])


def test_extent_rule_on_a_small_case():
    T = torch.zeros(2, 4, 3)
    T[0, 1, 2] = 0.5
    esrc1 = torch.tensor([[0, 1, 2, 3], [0, 0, 0, 0]])
    edst1 = torch.tensor([[1, 2, 3, 0], [0, 0, 0, 0]])
    esrc2 = torch.tensor([[0, 1, 2], [0, 0, 0]])
    edst2 = torch.tensor([[1, 0, 4], [0, 0, 0]])
    b = torch.zeros(2, 5, 5)
    b[1, 3, 1] = 1.0          # an isolated node with b != 0 sets the extent
    L1, L2, n1, n2 = live_extent(T, esrc1, edst1, esrc2, edst2, b)
    assert L1.tolist() == [1, 0] and L2.tolist() == [1, 0]
    assert n1.tolist() == [3, 4] and n2.tolist() == [5, 2]
    L1, L2, n1, n2 = live_extent(T, esrc1, edst1, esrc2, edst2, 0 * b)
    assert n1.tolist() == [3, 0] and n2.tolist() == [5, 0]


def test_value_solution_is_zero_outside_the_extent():
    s, operator, maxiter, _, (i, j) = _systems()
    b = s['b'].contiguous()
    L1, L2, n1, n2 = live_extent(*operator[:5], b)
    N1, N2 = b.shape[1:]
    # padding shrinks the solve: fewer live edges and nodes than padded
    assert int(L1.min()) < operator[0].shape[1]
    assert bool((n1 * n2 < N1 * N2).any())
    # the isolated atom (index 6 of graph 5) is beyond graph 5's extent
    lone = int(np.flatnonzero((i == 5) & (j == 5))[0])
    assert int(n1[lone]) == 6 and int(n2[lone]) == 6
    x, _ = pcg_resident_reference(*operator, b, s['tol'], maxiter)
    outside = _outside(n1, n2, N1, N2)
    assert bool(outside.any())
    assert not bool(x[outside].any())
    assert bool(x[~outside].any())


def test_tangent_solutions_are_zero_outside_the_extent():
    s, operator, maxiter, (theta, ops, kw), _ = _systems()
    x, _ = pcg_resident_reference(*operator, s['b'].contiguous(), s['tol'],
                                  maxiter)
    rhs = mlgk_tangents(theta, ops, s, x, **kw)['rhs'].contiguous()
    k = rhs.shape[1]
    _, _, n1, n2 = live_extent(*operator[:5], rhs)
    grouped = [a[:, None] for a in operator]
    xt, _ = pcg_packed_reference(*grouped, rhs, s['gtol'].contiguous(),
                                 maxiter * k)
    outside = _outside(n1, n2, *rhs.shape[2:])
    assert bool(outside.any())
    assert not bool(xt.permute(1, 0, 2, 3)[:, outside].any())
    want = _plain_solve(s, 'edge', rhs, s['gtol'], maxiter)
    assert not bool(want.permute(1, 0, 2, 3)[:, outside].any())


# ---------------------------------------------------------------------------
# the tangent route's group sizes, and the library build key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('k,fit,group', [
    (4, 4, 4), (6, 4, 3), (7, 4, 4), (5, 2, 2), (4, 3, 2), (1, 4, 1),
])
def test_tangent_route_balances_groups(monkeypatch, k, fit, group):
    """On the card the route runs the fewest groups whose size fits, as
    even as they can be (the fit itself is the card's to decide)."""
    monkeypatch.setattr(_solver, 'resident_fits', lambda *a: True)
    monkeypatch.setattr(_solver, 'largest_packed_k',
                        lambda k, *a, **kw: min(k, fit))
    solve = cuda_tangent_solver(k, 64, 64, 24, 24, torch.device('cuda'))
    assert solve.func is _packed_tangents and solve.args == (group,)


def test_tangent_route_beyond_a_block_streams(monkeypatch):
    """Beyond a block and beyond a cluster, the tangents stream."""
    monkeypatch.setattr(_solver, 'resident_fits', lambda *a: False)
    monkeypatch.setattr(_solver, 'cluster_fits', lambda *a: False)
    solve = cuda_tangent_solver(4, 64, 64, 72, 72, torch.device('cuda'))
    assert solve is _solver._stream_tangents


def test_tangent_route_beyond_a_block_in_a_cluster(monkeypatch):
    """Beyond a block, within a cluster: one pcg_cluster launch."""
    monkeypatch.setattr(_solver, 'resident_fits', lambda *a: False)
    monkeypatch.setattr(_solver, 'cluster_fits', lambda *a: True)
    solve = cuda_tangent_solver(4, 192, 192, 72, 72, torch.device('cuda'))
    assert solve is _solver._cluster_tangents


def test_build_key_follows_included_headers(monkeypatch, tmp_path):
    """An edited csrc/*.cuh that a source includes changes the library's
    name, so a stale build is never reused; an unrelated header does not."""
    for f in _build._CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    (tmp_path / 'unused.cuh').write_bytes(b'// not included\n')
    monkeypatch.setattr(_build, '_CSRC', tmp_path)
    monkeypatch.setattr(_build, 'nvcc_path', lambda: 'nvcc')
    names = {k: _build._target(k)[2].name for k in _build.KERNELS}
    assert [p.name for p in _build._sources(tmp_path / 'pcg_packed.cu')] \
        == ['pcg_packed.cu', 'pcg_block.cuh']
    header = tmp_path / 'pcg_block.cuh'
    header.write_bytes(header.read_bytes() + b'\n// edited\n')
    after = {k: _build._target(k)[2].name for k in _build.KERNELS}
    assert after['pcg_resident'] != names['pcg_resident']
    assert after['pcg_packed'] != names['pcg_packed']
    assert after['pcg_stream'] == names['pcg_stream']
    (tmp_path / 'unused.cuh').write_bytes(b'// edited too\n')
    assert {k: _build._target(k)[2].name for k in _build.KERNELS} == after
