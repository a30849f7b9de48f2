"""The CUDA PCG kernels on the card, against their plain twins.

Every test here needs an NVIDIA GPU with ``nvcc`` (a CUDA kernel has no
interpret mode): they carry the ``cuda`` marker and skip without a card.
This file imports no JAX, so on a machine without it run

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerance: max |x_kernel - x_twin| <= 1e-5 max |x| (both float32 CG to
ftol * N; the kernels sum in a fixed order, the twins with index_add_).

``pcg_resident`` and ``pcg_packed`` solve over the live edges and the live
node extent only (``csrc/pcg_block.cuh``); the cases below include batches
padded far beyond their graphs, an isolated highest-index node with
b != 0, live edges whose T is exactly 0, every group size, and pairs up
to the 3328 product nodes (13 a thread) that a block holds.
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
from graphdot_tpu_torch.kernel.marginalized._solver import (  # noqa: E402
    cuda_tangent_solver, mlgk_tangents)
from graphdot_tpu_torch.ops.pcg import (  # noqa: E402
    PACKED_MAX_K, group_pairs, largest_packed_k, live_extent,
    offdiag_operator, pcg_packed,
    pcg_packed_reference, pcg_resident, pcg_resident_reference, pcg_stream,
    pcg_stream_reference, stream_grid)
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


def _padded(args, N, M):
    """The systems of ``args`` padded to N nodes and M edges a side, as a
    batch with larger graphs pads them: T 0, edges 0 -> 0, diag and
    precond 1, b 0 on the padding."""
    T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol, maxiter = args
    P, M1, M2 = T.shape
    N1, N2 = diag.shape[1:]
    Tp = T.new_zeros(P, M, M)
    Tp[:, :M1, :M2] = T

    def edges(e):
        out = e.new_zeros(P, M)
        out[:, :e.shape[1]] = e
        return out

    def nodes(a, value):
        out = a.new_full((P, N, N), value)
        out[:, :N1, :N2] = a
        return out

    return (Tp, edges(esrc1), edges(edst1), edges(esrc2), edges(edst2),
            nodes(diag, 1.0), nodes(precond, 1.0), nodes(b, 0.0), tol,
            maxiter)


def _edited(args, edit):
    """A copy of the operands with ``edit`` applied to the list."""
    args = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    edit(args)
    return args


def _isolated_top(args):
    """The highest-index product node of every pair, which no edge
    touches in the slice's padded batch, gets b != 0."""
    args[7][:, -1, -1] = 1.0
    args[5][:, -1, -1] = 2.0
    args[6][:, -1, -1] = 0.5


def _dead_live_edges(args):
    """Edges whose T is exactly 0 (an edge kernel of 0 on a feature):
    side-1 edge 3 and side-2 edge 5 of every pair, and every other row
    of pair 0."""
    args[0][:, 3, :] = 0.0
    args[0][:, :, 5] = 0.0
    args[0][0, ::2, :] = 0.0


@pytest.mark.parametrize('atoms1,atoms2', [
    ((9, 24), (9, 24)),     # the slice's molecules
    ((5, 9), (20, 24)),     # rectangular: n1 != n2, M1 != M2
    ((30, 45), (30, 45)),   # over 48 KB of shared memory a pair, 8 nodes
    ((40, 48), (48, 56)),   # 48 x 56 nodes: 11 a thread
    ((48, 56), (48, 56)),   # n = 56: 13 product nodes a thread, the most
])                          # a block holds
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


@pytest.mark.parametrize('case', ['padded', 'isolated', 'dead', 'tol0'])
def test_kernel_live_extent_cases(card, case):
    """9-atom molecules padded to n = 24, m = 64; an isolated
    highest-index node with b != 0; live edges whose T is exactly 0; and
    16 fixed steps (tol = 0), each against the twin."""
    if case == 'padded':
        args = _padded(_systems(card, (9, 10), (9, 10)), 24, 64)
        L1, _, n1, n2 = live_extent(*args[:5], args[7])
        assert int(L1.max()) < 32 and int((n1 * n2).max()) < 24 * 24
    else:
        base = _systems(card, (9, 24), (9, 24))
        edit = {'isolated': _isolated_top, 'dead': _dead_live_edges,
                'tol0': lambda a: a.__setitem__(8, torch.zeros_like(a[8]))}
        args = _edited(base, edit[case])
        if case == 'tol0':
            args[9] = 16
    x, iters = pcg_resident(*args)
    x_ref, iters_ref = pcg_resident_reference(*args)
    torch.cuda.synchronize()
    _close(x, x_ref)
    assert int((iters - iters_ref).abs().max()) <= 1
    if case == 'isolated':
        # the node couples to nothing: x = b / diag there
        assert bool(torch.allclose(x[:, -1, -1], torch.full_like(
            x[:, -1, -1], 0.5)))
    if case == 'tol0':
        assert bool(torch.all(iters == 16))


def test_kernels_repeat_bitwise(card):
    args = _systems(card, (9, 24), (9, 24))
    x1, it1 = pcg_resident(*args)
    x2, it2 = pcg_resident(*args)
    grouped = group_pairs(3, *args)
    y1, jt1 = pcg_packed(*grouped)
    y2, jt2 = pcg_packed(*grouped)
    torch.cuda.synchronize()
    assert torch.equal(x1, x2) and torch.equal(it1, it2)
    assert torch.equal(y1, y2) and torch.equal(jt1, jt2)


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


def test_pair_beyond_registers_raises(card):
    """64 x 64 product nodes fit shared memory but exceed the 13 a thread
    that the registers hold."""
    P, M, N = 1, 64, 64
    T = torch.zeros(P, M, M, device=card)
    e = torch.zeros(P, M, dtype=torch.int32, device=card)
    d = torch.ones(P, N, N, device=card)
    with pytest.raises(ValueError, match='registers.*pcg_stream'):
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


@pytest.mark.parametrize('k', [1, 2, 3, 4])
def test_packed_kernel_matches_twin_on_pairs(card, k):
    """Groups of k different pairs (the TPU's layout), P not a multiple of
    k: against the twin and against pcg_resident per pair."""
    args = _systems(card, (9, 24), (9, 24))     # 20 pairs
    grouped = group_pairs(k, *args)
    counter = pcg_resident if k == 1 else pcg_packed   # k = 1: one pair
    before = counter.launches
    x, iters = pcg_packed(*grouped)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
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


def _tangent_systems(device, case='slice'):
    """pcg_packed's operands for the n_theta = 4 tangent systems of each of
    20 molecule pairs, one shared operator a pair, at the value solution:
    the slice's molecules ('slice'), the same with edges whose T is
    exactly 0 ('dead'), 9-atom molecules padded to n = 24, m = 64
    ('padded'), or molecules of 48-55 atoms (n = 56, 'large')."""
    kernel = _kernel(device)
    atoms = {'padded': (9, 10), 'large': (48, 56)}.get(case, (9, 24))
    _, bd1, _ = kernel._prepare_batch(random_molecule_set(3, 5, atoms))
    _, bd2, _ = kernel._prepare_batch(random_molecule_set(4, 4, atoms))
    i, j = np.indices((5, 4))
    ops = kernel._operands(bd1, bd2,
                           torch.as_tensor(i.ravel(), device=device),
                           torch.as_tensor(j.ravel(), device=device))
    theta = kernel._theta_vector()
    kw = dict(knode=kernel.node_kernel, kedge=kernel.edge_kernel,
              n_p_theta=1, mode='cuda')
    s = mlgk_setup(theta, ops, **kw)
    operator = [s[f].contiguous() for f in (
        'T', 'esrc_1', 'edst_1', 'esrc_2', 'edst_2', 'diag', 'precond')]
    maxiter = kernel.maxiter(bd1['node_mask'].shape[1])
    x, _ = pcg_resident_reference(*operator, s['b'].contiguous(), s['tol'],
                                  maxiter)
    rhs = mlgk_tangents(theta, ops, s, x, **kw)['rhs'].contiguous()
    args = operator + [rhs, s['gtol'].contiguous(), maxiter]
    if case == 'dead':
        args = _edited(args, _dead_live_edges)
    elif case == 'padded':
        args = list(_padded(args[:7] + [rhs[:, 0], args[8], maxiter], 24, 64))
        pad = rhs.new_zeros(rhs.shape[0], rhs.shape[1], 24, 24)
        pad[:, :, :rhs.shape[2], :rhs.shape[3]] = rhs
        args[7] = pad
    return args


@pytest.mark.parametrize('case', ['slice', 'dead'])
@pytest.mark.parametrize('group', [1, 2, 3, 4])
def test_packed_tangent_groups(card, case, group):
    """A pair's tangent systems in groups of every size the tangent route
    can pick, the members sharing the pair's operator, against the twin
    (a group of one runs pcg_resident's kernel)."""
    args = _tangent_systems(card, case)
    operator, rhs, tol, maxiter = args[:7], args[7], args[8], args[9]
    assert rhs.shape[1] == 4 == PACKED_MAX_K
    assert largest_packed_k(4, *args[0].shape[1:], *rhs.shape[2:], card,
                            shared=True) == 4
    grouped = ([a[:, None] for a in operator]
               + [rhs[:, :group].contiguous(), tol, maxiter * group])
    counter = pcg_resident if group == 1 else pcg_packed
    before = counter.launches
    x, iters = pcg_packed(*grouped)
    x_ref, iters_ref = pcg_packed_reference(*grouped)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    _close(x, x_ref)
    assert int((iters - iters_ref).abs().max()) <= 1


def test_tangent_route_on_the_card(card):
    """cuda_tangent_solver's groups on the card give the twin's
    solutions, for the slice's molecules, for 9-atom molecules padded
    far beyond their graphs, and for 48-55-atom molecules, whose tangents
    run one a CTA in pcg_resident's kernel."""
    for case in ('slice', 'padded', 'large'):
        args = _tangent_systems(card, case)
        operator, rhs, tol, maxiter = args[:7], args[7], args[8], args[9]
        k = rhs.shape[1]
        solve = cuda_tangent_solver(k, *operator[0].shape[1:],
                                    *rhs.shape[2:], card)
        group = solve.args[0]
        assert group == (1 if case == 'large' else k)
        resident, packed = pcg_resident.launches, pcg_packed.launches
        x, _ = solve(*operator, rhs, tol, maxiter)
        if case == 'large':
            assert pcg_resident.launches == resident + 1
            assert pcg_packed.launches == packed
        else:
            assert pcg_packed.launches == packed + 1
        # the twin on the route's groups: each stops at its own residual
        x_ref = torch.cat([pcg_packed_reference(
            *[a[:, None] for a in operator],
            rhs[:, s:s + group].contiguous(), tol, maxiter * group)[0]
            for s in range(0, k, group)], dim=1)
        torch.cuda.synchronize()
        _close(x, x_ref)


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
    """Molecule pairs fit a block and run pcg_resident; pairs whose
    product nodes exceed a block's registers, and the protein pairs of the
    niche, do not, and run pcg_stream, in the kernel class too."""
    assert cuda_solver(64, 64, 24, 24, card) is pcg_resident
    # all fit shared memory; 56 x 56 nodes are 13 a thread, the most a
    # thread holds in registers; 64 x 64 exceed it
    assert cuda_solver(64, 64, 48, 48, card) is pcg_resident
    assert cuda_solver(64, 64, 56, 56, card) is pcg_resident
    assert cuda_solver(168, 168, 64, 64, card) is pcg_stream
    # the boundary molecules (48-72 atoms) exceed shared memory
    assert cuda_solver(192, 192, 72, 72, card) is pcg_stream
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


def test_large_molecules_run_resident(card):
    """The value and gradient Grams of 48-55-atom molecules (n = 56, 13
    product nodes a thread) run in pcg_resident's kernel alone, tangents
    one a CTA, and match the edge backend."""
    graphs = random_molecule_set(11, 6, n_atoms_range=(48, 56))
    counts = [c.launches for c in (pcg_resident, pcg_packed, pcg_stream)]
    K, dK = Normalization(_kernel(card))(graphs, eval_gradient=True)
    after = [c.launches for c in (pcg_resident, pcg_packed, pcg_stream)]
    assert after[0] == counts[0] + 2 and after[1:] == counts[1:]
    K_edge, dK_edge = Normalization(_kernel(card, 'edge'))(
        graphs, eval_gradient=True)
    np.testing.assert_allclose(K, K_edge, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dK, dK_edge, rtol=0,
                               atol=1e-3 * np.abs(dK_edge).max() + 1e-5)


def _maximin(device, **kw):
    from graphdot_tpu_torch.metric import MaxiMin
    return MaxiMin(TensorProduct(element=KroneckerDelta(0.2)),
                   TensorProduct(length=SquareExponential(0.3)), q=0.05,
                   device=device, **kw)


def _d_limit(a, b):
    """1e-4 where both distances exceed 0.01, else 5e-3 (the sqrt of
    d = sqrt(1 - ratio) near d = 0)."""
    return np.where((a > 0.01) & (b > 0.01), 1e-4, 5e-3)


def test_maximin_device_distance_fn_on_the_card(card):
    """``device_distance_fn`` on the card: one pcg_resident launch a value
    chunk, no pcg_stream, within the D limit of its CPU twin and of
    ``__call__`` on the card."""
    graphs = random_molecule_set(11, 16, n_atoms_range=(9, 24))
    fn, theta0 = _maximin(card).device_distance_fn(graphs)
    assert theta0.device.type == 'cuda'
    counts = [c.launches for c in (pcg_resident, pcg_stream)]
    D = fn(theta0)
    torch.cuda.synchronize()
    assert D.device.type == 'cuda'
    assert pcg_resident.launches > counts[0]
    assert pcg_stream.launches == counts[1]
    D = D.cpu().numpy()
    fn_cpu, theta_cpu = _maximin('cpu').device_distance_fn(graphs)
    D_cpu = fn_cpu(theta_cpu).numpy()
    assert (np.abs(D - D_cpu) <= _d_limit(D, D_cpu)).all()
    D_call = _maximin(card)(graphs)
    assert (np.abs(D - D_call) <= _d_limit(D, D_call)).all()


@pytest.mark.parametrize('buckets', [False, True])
def test_maximin_hotspot_gradient_on_the_card(card, buckets):
    """The hotspot gradient on the card (tangents in pcg_packed) against
    its CPU twin: D within the D limit, dD within 1e-3 max |dD| + 1e-4 off
    the diagonal at the pairs whose hotspots agree (at d = 0, the sqrt's
    kink, the gradient divides rounding by d + 1e-4)."""
    graphs = random_molecule_set(11, 12, n_atoms_range=(9, 24))
    packed = pcg_packed.launches
    D, hot, dD = _maximin(card, buckets=buckets)(
        graphs, return_hotspot=True, eval_gradient=True)
    assert pcg_packed.launches > packed
    D_cpu, hot_cpu, dD_cpu = _maximin('cpu', buckets=buckets)(
        graphs, return_hotspot=True, eval_gradient=True)
    assert (np.abs(D - D_cpu) <= _d_limit(D, D_cpu)).all()
    agree = (hot[0] == hot_cpu[0]) & (hot[1] == hot_cpu[1])
    assert agree.mean() > 0.5
    agree &= ~np.eye(len(graphs), dtype=bool)
    assert np.abs(dD - dD_cpu)[agree].max() <= \
        1e-3 * np.abs(dD_cpu).max() + 1e-4


def test_offdiag_repeats_bit_for_bit_on_the_card(card):
    """The off-diagonal matvec of the tangent right-hand sides on the card
    (segment sums, no float atomics): the same bits at every call, and the
    bits of the CPU's ``index_add_``, on the tangent systems of a molecule
    chunk."""
    kernel = _kernel(card)
    graphs = random_molecule_set(7, 12, n_atoms_range=(9, 24))
    _, bd, _ = kernel._prepare_batch(graphs)
    i, j = np.triu_indices(len(graphs))
    idx1, idx2 = (torch.as_tensor(a, device=card) for a in (i, j))
    ops = kernel._operands(bd, bd, idx1, idx2)
    theta = kernel._theta_vector()
    s = mlgk_setup(theta, ops, knode=kernel.node_kernel,
                   kedge=kernel.edge_kernel, n_p_theta=1, mode='cuda')
    args = [s['T']] + [s[f] for f in ('esrc_1', 'edst_1', 'esrc_2',
                                      'edst_2')]
    Y = torch.randn(s['diag'].shape, generator=torch.Generator(
        device=card).manual_seed(0), device=card)
    first = offdiag_operator(*args)(Y)
    for _ in range(3):
        assert torch.equal(offdiag_operator(*args)(Y), first)
    cpu = offdiag_operator(*(a.cpu() for a in args))(Y.cpu())
    assert torch.equal(first.cpu(), cpu)
    x = torch.rand_like(s['diag'])
    rhs = [mlgk_tangents(theta, ops, s, x, knode=kernel.node_kernel,
                         kedge=kernel.edge_kernel, n_p_theta=1,
                         mode='cuda')['rhs'] for _ in range(3)]
    assert all(torch.equal(r, rhs[0]) for r in rhs)
