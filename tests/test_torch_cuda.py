"""The CUDA PCG kernels on the card, against their plain twins.

Every test here needs an NVIDIA GPU with ``nvcc`` (a CUDA kernel has no
interpret mode): they carry the ``cuda`` marker and skip without a card.
This file imports no JAX, so on a machine without it run

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerance: max |x_kernel - x_twin| <= 1e-5 max |x| (both float32 CG to
ftol * N; the kernels sum in a fixed order, the twins with index_add_).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from graphdot_tpu_torch.kernel import (  # noqa: E402
    MarginalizedGraphKernel, Normalization)
from graphdot_tpu_torch.kernel.marginalized._solver import (  # noqa: E402
    cuda_solver, mlgk_setup)
from graphdot_tpu_torch.microkernel import (  # noqa: E402
    KroneckerDelta, SquareExponential, TensorProduct)
from graphdot_tpu_torch.ops.pcg import (  # noqa: E402
    group_pairs, pcg_packed, pcg_packed_reference, pcg_resident,
    pcg_resident_reference, pcg_stream, pcg_stream_reference, stream_grid)
from graphdot_tpu_torch.testing import (  # noqa: E402
    protein_niche_set, random_molecule_set)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel runs only there')
    return torch.device('cuda')


def _kernel(device, backend='auto'):
    return MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)), q=0.05,
        device=device, backend=backend)


def _systems(device, atoms1, atoms2):
    """Operands for all pairs between 5 graphs of ``atoms1`` atoms and 4
    of ``atoms2`` atoms (rectangular when the ranges differ)."""
    kernel = _kernel(device)
    _, bd1, _ = kernel._prepare_batch(random_molecule_set(3, 5, atoms1))
    _, bd2, _ = kernel._prepare_batch(random_molecule_set(4, 4, atoms2))
    i, j = np.indices((5, 4))
    s = mlgk_setup(kernel._theta_vector(),
                   kernel._operands(bd1, bd2,
                                    torch.as_tensor(i.ravel(), device=device),
                                    torch.as_tensor(j.ravel(), device=device)),
                   knode=kernel.node_kernel, kedge=kernel.edge_kernel,
                   n_p_theta=1, mode='cuda')
    n_pad = max(bd1['node_mask'].shape[1], bd2['node_mask'].shape[1])
    return (s['T'], s['esrc_1'], s['edst_1'], s['esrc_2'], s['edst_2'],
            s['diag'].contiguous(), s['precond'].contiguous(),
            s['b'].contiguous(), s['tol'], kernel.maxiter(n_pad))


@pytest.mark.parametrize('atoms1,atoms2', [
    ((9, 24), (9, 24)),     # the slice's molecules
    ((5, 9), (20, 24)),     # rectangular: n1 != n2, M1 != M2
    ((30, 45), (30, 45)),   # over 48 KB of shared memory per pair
])
def test_kernel_matches_twin(card, atoms1, atoms2):
    args = _systems(card, atoms1, atoms2)
    before = pcg_resident.launches
    x, iters = pcg_resident(*args)
    torch.cuda.synchronize()
    assert pcg_resident.launches == before + 1
    x_ref, iters_ref = pcg_resident_reference(*args)
    assert bool(torch.isfinite(x).all())
    err = float((x - x_ref).abs().max())
    assert err <= 1e-5 * float(x_ref.abs().max())
    assert int((iters - iters_ref).abs().max()) <= 1
    assert int(iters.max()) < args[-1]


def test_kernel_stop_rules(card):
    args = list(_systems(card, (9, 24), (9, 24)))
    x, iters = pcg_resident(*args[:-1], 0)
    assert not x.any() and not iters.any()
    x, iters = pcg_resident(*args[:-1], 2)
    assert bool(torch.all(iters == 2))
    x_ref, _ = pcg_resident_reference(*args[:-1], 2)
    assert float((x - x_ref).abs().max()) <= 1e-5 * float(x_ref.abs().max())
    args[7] = torch.zeros_like(args[7])     # b = 0
    x, iters = pcg_resident(*args)
    assert not x.any() and not iters.any()
    args[7] = torch.ones_like(args[7])
    args[6] = torch.zeros_like(args[6])     # precond = 0: rz == 0
    x, iters = pcg_resident(*args)
    torch.cuda.synchronize()
    assert not x.any() and bool(torch.all(iters == 1))


def test_no_pairs_launches_nothing(card):
    args = [a[:0] for a in _systems(card, (9, 24), (9, 24))[:-1]]
    before = pcg_resident.launches
    x, iters = pcg_resident(*args, 10)
    assert x.shape[0] == 0 and iters.shape == (0,)
    assert pcg_resident.launches == before


def test_pair_beyond_shared_memory_raises(card):
    P, M, N = 1, 256, 24
    T = torch.zeros(P, M, M, device=card)
    e = torch.zeros(P, M, dtype=torch.int32, device=card)
    d = torch.ones(P, N, N, device=card)
    with pytest.raises(ValueError, match='shared memory.*pcg_stream'):
        pcg_resident(T, e, e, e, e, d, d, d, torch.ones(P, device=card), 8)


@pytest.mark.parametrize('nodal', [False, True])
def test_gram_cuda_matches_edge(card, nodal):
    graphs = random_molecule_set(5, 12, n_atoms_range=(9, 24))
    before = pcg_resident.launches
    R = _kernel(card)(graphs, nodal=nodal)
    assert pcg_resident.launches == before + 1
    R_edge = _kernel(card, 'edge')(graphs, nodal=nodal)
    assert pcg_resident.launches == before + 1
    np.testing.assert_allclose(R, R_edge, rtol=1e-5, atol=1e-7)
    if not nodal:
        K = Normalization(_kernel(card))(graphs)
        K_edge = Normalization(_kernel(card, 'edge'))(graphs)
        np.testing.assert_allclose(K, K_edge, rtol=0, atol=1e-6)


def _niche_systems(device):
    """Operands for the 3 pairs of 2 categorical-edge proteins of 83-88
    residues (n = 88, m = 1144: beyond a block's shared memory)."""
    kernel = MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(3.0),
                      ctype=KroneckerDelta(0.3)),
        q=0.05, device=device)
    batch, bd, _ = kernel._prepare_batch(protein_niche_set(13, 2, (60, 90)))
    i, j = np.triu_indices(2)
    s = mlgk_setup(kernel._theta_vector(),
                   kernel._operands(bd, bd,
                                    torch.as_tensor(i, device=device),
                                    torch.as_tensor(j, device=device)),
                   knode=kernel.node_kernel, kedge=kernel.edge_kernel,
                   n_p_theta=1, mode='cuda')
    return (s['T'], s['esrc_1'], s['edst_1'], s['esrc_2'], s['edst_2'],
            s['diag'].contiguous(), s['precond'].contiguous(),
            s['b'].contiguous(), s['tol'],
            kernel.maxiter(batch.node_mask.shape[1]))


@pytest.mark.parametrize('shape', ['molecules', 'proteins'])
def test_stream_kernel_matches_twin(card, shape):
    args = (_systems(card, (5, 9), (20, 24)) if shape == 'molecules'
            else _niche_systems(card))
    before = pcg_stream.launches
    x, iters = pcg_stream(*args)
    torch.cuda.synchronize()
    assert pcg_stream.launches == before + 1
    x_ref, iters_ref = pcg_stream_reference(*args)
    assert bool(torch.isfinite(x).all())
    err = float((x - x_ref).abs().max())
    assert err <= 1e-5 * float(x_ref.abs().max())
    assert int((iters - iters_ref).abs().max()) <= 1
    assert 0 < int(iters.min()) and int(iters.max()) < args[-1]


def test_stream_kernel_stop_rules(card):
    args = list(_niche_systems(card))
    x, iters = pcg_stream(*args[:-1], 0)
    assert not x.any() and not iters.any()
    tol = args[8]
    args[8] = torch.zeros_like(tol)         # tol = 0: runs maxiter steps
    x, iters = pcg_stream(*args[:-1], 3)
    assert bool(torch.all(iters == 3))
    x_ref, _ = pcg_stream_reference(*args[:-1], 3)
    assert float((x - x_ref).abs().max()) <= 1e-5 * float(x_ref.abs().max())
    args[8] = tol
    args[7] = torch.zeros_like(args[7])     # b = 0: stops before a step
    x, iters = pcg_stream(*args)
    torch.cuda.synchronize()
    assert not x.any() and not iters.any()


@pytest.fixture(scope='module')
def protein_chunk():
    """(operands, twin's x) of the 21 pairs of the 6 contact-map proteins
    of ``bench_protein.py`` (n = 272, m = 3736): the protein Gram's chunk."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel runs only there')
    card = torch.device('cuda')
    kernel = MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(3.0),
                      ctype=KroneckerDelta(0.3)),
        q=0.05, device=card)
    batch, bd, _ = kernel._prepare_batch(protein_niche_set(13, 6, (180, 280)))
    i, j = np.triu_indices(6)
    s = mlgk_setup(kernel._theta_vector(),
                   kernel._operands(bd, bd, torch.as_tensor(i, device=card),
                                    torch.as_tensor(j, device=card)),
                   knode=kernel.node_kernel, kedge=kernel.edge_kernel,
                   n_p_theta=1, mode='cuda')
    args = (s['T'], s['esrc_1'], s['edst_1'], s['esrc_2'], s['edst_2'],
            s['diag'].contiguous(), s['precond'].contiguous(),
            s['b'].contiguous(), s['tol'],
            kernel.maxiter(batch.node_mask.shape[1]))
    return args, pcg_stream_reference(*args)[0]


def _close(x, x_ref):
    assert bool(torch.isfinite(x).all())
    err = float((x - x_ref).abs().max())
    assert err <= 1e-5 * float(x_ref.abs().max()), err


@pytest.mark.parametrize('ctas', [1, 2, 7, None])
def test_stream_split_matches_twin(protein_chunk, ctas):
    """The 21-pair protein chunk with each pair over C CTAs (None: the
    default, floor(G / 21))."""
    args, x_ref = protein_chunk
    before = pcg_stream.launches
    x, _ = pcg_stream(*args, ctas_per_pair=ctas)
    torch.cuda.synchronize()
    assert pcg_stream.launches == before + 1
    if ctas is None:
        assert pcg_stream.last_ctas_per_pair > 1
    else:
        assert pcg_stream.last_ctas_per_pair == ctas
    _close(x, x_ref)


def test_stream_split_lone_pair(protein_chunk):
    """One protein pair spread over up to the whole grid."""
    args, x_ref = protein_chunk
    one = [a[1:2] for a in args[:-1]] + [args[-1]]
    x, _ = pcg_stream(*one)
    torch.cuda.synchronize()
    assert pcg_stream.last_ctas_per_pair > 21
    _close(x, x_ref[1:2])


def test_stream_split_repeats_bitwise(protein_chunk):
    args, _ = protein_chunk
    for ctas in (7, None):
        x1, it1 = pcg_stream(*args, ctas_per_pair=ctas)
        x2, it2 = pcg_stream(*args, ctas_per_pair=ctas)
        torch.cuda.synchronize()
        assert torch.equal(x1, x2) and torch.equal(it1, it2)


def test_stream_split_more_ctas_than_nodes(card):
    """2 molecule pairs forced to C = 24, more CTAs than side-1 nodes with
    live edges: CTAs with empty ranges meet the barriers and add zeros."""
    full = _systems(card, (5, 9), (20, 24))
    args = [a[:2] for a in full[:-1]] + [full[-1]]
    x, iters = pcg_stream(*args, ctas_per_pair=24)
    x_ref, iters_ref = pcg_stream_reference(*args)
    torch.cuda.synchronize()
    _close(x, x_ref)
    assert int((iters - iters_ref).abs().max()) <= 1


def test_stream_split_stop_rules(card):
    """A zero right-hand side takes 0 steps, and the maxiter stop holds,
    inside pairs split over 7 CTAs."""
    args = list(_niche_systems(card))
    b = args[7]
    args[7] = torch.zeros_like(b)
    x, iters = pcg_stream(*args, ctas_per_pair=7)
    torch.cuda.synchronize()
    assert not x.any() and not iters.any()
    args[7] = b
    args[8] = torch.zeros_like(args[8])     # tol = 0: runs maxiter steps
    x, iters = pcg_stream(*args[:-1], 3, ctas_per_pair=7)
    x_ref, _ = pcg_stream_reference(*args[:-1], 3)
    torch.cuda.synchronize()
    assert bool(torch.all(iters == 3))
    _close(x, x_ref)


def test_stream_split_more_pairs_than_grid(card):
    """The 528 pairs of 32 molecules of 48-72 atoms (beyond a block's
    shared memory): more pairs than the grid holds, so several
    cooperative launches of one CTA a pair, counted as one call."""
    kernel = _kernel(card)
    batch, bd, _ = kernel._prepare_batch(
        random_molecule_set(7, 32, n_atoms_range=(48, 72)))
    i, j = np.triu_indices(32)
    s = mlgk_setup(kernel._theta_vector(),
                   kernel._operands(bd, bd, torch.as_tensor(i, device=card),
                                    torch.as_tensor(j, device=card)),
                   knode=kernel.node_kernel, kedge=kernel.edge_kernel,
                   n_p_theta=1, mode='cuda')
    args = (s['T'], s['esrc_1'], s['edst_1'], s['esrc_2'], s['edst_2'],
            s['diag'].contiguous(), s['precond'].contiguous(),
            s['b'].contiguous(), s['tol'],
            kernel.maxiter(batch.node_mask.shape[1]))
    M, N = args[0].shape[1], args[5].shape[1]
    assert stream_grid(M, M, N, N, card) < len(i)
    before = pcg_stream.launches
    x, iters = pcg_stream(*args)
    torch.cuda.synchronize()
    assert pcg_stream.launches == before + 1
    assert pcg_stream.last_ctas_per_pair == 1
    x_ref, iters_ref = pcg_stream_reference(*args)
    _close(x, x_ref)
    assert int((iters - iters_ref).abs().max()) <= 1


def test_stream_split_beyond_grid_raises(card):
    args = _niche_systems(card)
    M, N = args[0].shape[1], args[5].shape[1]
    grid = stream_grid(M, M, N, N, card)
    with pytest.raises(ValueError, match='cooperative grid'):
        pcg_stream(*args, ctas_per_pair=grid + 1)


def test_stream_no_pairs_launches_nothing(card):
    args = [a[:0] for a in _niche_systems(card)[:-1]]
    before = pcg_stream.launches
    x, iters = pcg_stream(*args, 10)
    assert x.shape[0] == 0 and iters.shape == (0,)
    assert pcg_stream.launches == before


@pytest.mark.parametrize('k', [2, 3])
def test_packed_kernel_matches_twin_on_pairs(card, k):
    """Groups of k different pairs (the TPU's layout), P not a multiple of
    k: against the twin and against pcg_resident per pair."""
    args = _systems(card, (9, 24), (9, 24))     # 20 pairs
    grouped = group_pairs(k, *args)
    before = pcg_packed.launches
    x, iters = pcg_packed(*grouped)
    torch.cuda.synchronize()
    assert pcg_packed.launches == before + 1
    x_ref, iters_ref = pcg_packed_reference(*grouped)
    scale = float(x_ref.abs().max())
    assert bool(torch.isfinite(x).all())
    assert float((x - x_ref).abs().max()) <= 1e-5 * scale
    assert int((iters - iters_ref).abs().max()) <= 1
    P = args[0].shape[0]
    x_res, _ = pcg_resident(*args)
    assert float((x.reshape(-1, *x.shape[2:])[:P] - x_res).abs().max()) \
        <= 1e-5 * scale


def test_packed_kernel_shared_operator(card):
    """Tangent-style groups (one operator shared by the k members, a
    member stride of 0) against the twin and against the operator copied
    k times; a zero member stays zero, an all-zero group takes 0 steps."""
    args = _systems(card, (9, 24), (9, 24))
    S, k = 6, 4
    shared = [a[:S, None].contiguous() for a in args[:7]]
    rng = np.random.default_rng(1)
    b = torch.tensor(rng.normal(size=(S, k, *args[5].shape[1:])),
                     dtype=torch.float32, device=card)
    b[1] = 0.0
    b[2, 3] = 0.0
    tol, maxiter = args[8][:S], args[9] * k
    x, iters = pcg_packed(*shared, b, tol, maxiter)
    x_ref, iters_ref = pcg_packed_reference(*shared, b, tol, maxiter)
    copied = [a.expand(S, k, *a.shape[2:]).contiguous() for a in shared]
    x_cp, _ = pcg_packed(*copied, b, tol, maxiter)
    torch.cuda.synchronize()
    scale = float(x_ref.abs().max())
    assert float((x - x_ref).abs().max()) <= 1e-5 * scale
    assert float((x_cp - x_ref).abs().max()) <= 1e-5 * scale
    assert int((iters - iters_ref).abs().max()) <= 1
    assert int(iters[1]) == 0 and not x[1].any() and not x[2, 3].any()


def test_packed_group_beyond_shared_memory_raises(card):
    M, N, k = 128, 24, 8
    T = torch.zeros(1, k, M, M, device=card)
    e = torch.zeros(1, k, M, dtype=torch.int32, device=card)
    d = torch.ones(1, k, N, N, device=card)
    with pytest.raises(ValueError, match='largest k that fits is [1-7]'):
        pcg_packed(T, e, e, e, e, d, d, d, torch.ones(1, device=card), 8)


def test_gradient_cuda_matches_edge(card):
    graphs = random_molecule_set(5, 12, n_atoms_range=(9, 24))
    packed, stream = pcg_packed.launches, pcg_stream.launches
    K, dK = Normalization(_kernel(card))(graphs, eval_gradient=True)
    assert pcg_packed.launches == packed + 1
    assert pcg_stream.launches == stream
    K_edge, dK_edge = Normalization(_kernel(card, 'edge'))(
        graphs, eval_gradient=True)
    np.testing.assert_allclose(K, K_edge, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dK, dK_edge, rtol=0,
                               atol=1e-3 * np.abs(dK_edge).max() + 1e-5)


def test_route_by_shared_memory(card):
    """Molecule pairs fit a block and run pcg_resident; the protein pairs
    of the niche do not, and run pcg_stream, in the kernel class too."""
    assert cuda_solver(64, 64, 24, 24, card) is pcg_resident
    assert cuda_solver(1144, 1144, 88, 88, card) is pcg_stream
    assert cuda_solver(3736, 3736, 272, 272, card) is pcg_stream
    graphs = protein_niche_set(13, 2, (60, 90))
    kernel = MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(3.0),
                      ctype=KroneckerDelta(0.3)),
        q=0.05, device=card)
    resident, stream = pcg_resident.launches, pcg_stream.launches
    kernel(graphs)
    assert pcg_resident.launches == resident
    assert pcg_stream.launches == stream + 1
