"""Sum-of-Kronecker MLGK solver for protein-scale pairs; counterpart of
``graphdot_tpu/kernel/marginalized/_kron.py``.

Where the edge kernel is a smooth function of one or two scalar edge
features (contact maps: the residue distance, maybe a sequence
separation), the edge-coupling matrix ``T[e1, e2] = w1 w2 k_edge(x1, x2)``
has low numerical rank. Chebyshev interpolation on a tensor grid of R
nodes gives

    k(x, y) ~= sum_{p,q} L_p(x) C_pq L_q(y),   C_pq = k(t_p, t_q)

and the off-diagonal matvec collapses into node space:

    offdiag(Y) = sum_p A1_p Y B_p^T,   B_p = sum_q C_pq A2_q
    A_p[i, j] = sum_{e: src=i, dst=j} w[e] L_p(x[e])

The rank sum runs as two batched products (cuBLAS ``bmm`` on the card,
the same calls on the CPU) over row-stacked factors:

    G   = A1s @ Y    [c, n1*R, n1] x [c, n1, n2]
    out = G' @ B2s   [c, n1, R*n2] x [c, R*n2, n2]

with G' the view of G that folds the rank axis into the contraction. The
hyperparameters enter only through the [R, R] grid kernel C, folded into
side 2 by one flat [c*n2^2, R] x [R, R] product; the basis values are data.
:func:`kron_offdiag_sequential` keeps the rank loop of R small products as
the fused form's plain twin. Both run in full float32: the products run
with TF32 off (:func:`_fp32_matmul`), whatever the caller set.

Where the port differs from the JAX module:

- the Chebyshev domain of each feature comes from all real edges of the
  graphs of a plan (:func:`kron_domain`), once, and the calibration and the
  solve share it (:class:`KronPlan`); the JAX module takes the solve's
  domain from the chunk and the calibration's from its sample;
- :func:`_normalize_ranks` shrinks the default grid of three or more
  features by a real decrement, where the JAX loop never ends;
- :func:`factorization_error` and :func:`calibrate_ranks` sample with a
  ``torch.Generator``, where the JAX functions take a ``PRNGKey`` seed;
- ``kron_mlgk_solve`` has no single counterpart: :func:`kron_factors`
  builds the system in ``_solver.mlgk_setup``, :func:`kron_pcg` solves it,
  ``_solver.mlgk_solve`` routes it beside the other routes (differentiably,
  and with tangents), and the kernel's ``_chunk_size`` chunks it; there is
  no ``GRAPHDOT_KRON_*`` environment switch and no optimization barrier.
"""
import contextlib
import math
import warnings
from collections import namedtuple

import torch

from ...ops.pcg import pcg
from ...util.trace import spanned

#: Chebyshev nodes a scalar feature, when no calibration chose them
DEFAULT_RANK = 32
#: ranks tried by :func:`calibrate_ranks` for one feature
RANK_CANDIDATES = (8, 12, 16, 24, 32, 48, 64)
#: ranks tried a feature for two features
RANK_CANDIDATES_2 = (4, 6, 8, 12, 16, 24, 32)
#: the factorization error a calibrated rank must stay below
RANK_TOL = 1e-6
#: the largest default tensor grid (product of the ranks of the features)
MAX_GRID = 96
#: the factorization error above which mode ``'cuda'`` declines kron
ACCURACY_LIMIT = 1e-4

#: a plan's Chebyshev grid: ``ranks`` (a tuple a feature, or ``'off'``
#: when calibration rejected the factorization), ``domain`` (feature name
#: -> (lo, hi)) and ``err``, the factorization error that calibration
#: measured (None for ranks that were given)
KronPlan = namedtuple('KronPlan', 'ranks domain err')


def _plain_scalar_columns(feats):
    """The dict of plain scalar feature columns, or None if any column is
    variable-length ((values, mask) tuple) or not 2-D."""
    if not feats:
        return None
    for v in feats.values():
        if isinstance(v, tuple) or v.ndim != 2:
            return None
    return feats


def kron_eligible_feats(feats_1, feats_2, max_features=2):
    """Whether both sides carry the same 1 to ``max_features`` plain scalar
    edge-feature columns."""
    f1 = _plain_scalar_columns(feats_1)
    f2 = _plain_scalar_columns(feats_2)
    return (f1 is not None and f2 is not None and set(f1) == set(f2)
            and 1 <= len(f1) <= max_features)


def kron_eligible(ops, max_features=2):
    """The Kronecker path applies when both sides of the operands ``ops``
    carry the same 1-2 plain scalar edge-feature columns."""
    return kron_eligible_feats(ops.get('edge_elist_feats_1'),
                               ops.get('edge_elist_feats_2'), max_features)


def _cheb_nodes(lo, hi, R, device=None):
    """First-kind Chebyshev nodes on [lo, hi] and their barycentric
    weights, in float32 throughout."""
    i = torch.arange(R, dtype=torch.float32, device=device)
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=device)
              for v in (lo, hi))
    ang = math.pi * (2 * i + 1) / (2 * R)
    t = (lo + hi) / 2 + (hi - lo) / 2 * torch.cos(ang)
    w = (1.0 - 2.0 * (i % 2)) * torch.sin(ang)
    return t, w


def _cheb_basis(x, t, w):
    """Barycentric Lagrange basis values L_p(x): [..., R]. Exact hits
    x == t_p resolve to the one-hot row (the 0/0 limit)."""
    d = x[..., None] - t
    hit = d == 0.0
    any_hit = hit.any(dim=-1, keepdim=True)
    ratio = w / torch.where(hit, 1.0, d)
    L_smooth = ratio / ratio.sum(dim=-1, keepdim=True)
    return torch.where(any_hit, hit.to(x.dtype), L_smooth)


def _feature_domain(x1, ew1, x2, ew2):
    """Joint range (lo, hi) of the real (weight-carrying) values of one
    scalar edge feature on both sides, as 0-d tensors; padding edges (w ==
    0) are left out."""
    big = torch.tensor(3e38, dtype=torch.float32, device=x1.device)

    def lohi(x, ew):
        real = ew != 0
        return (torch.where(real, x, big).min(),
                torch.where(real, x, -big).max())

    lo1, hi1 = lohi(x1, ew1)
    lo2, hi2 = lohi(x2, ew2)
    lo = torch.minimum(lo1, lo2)
    hi = torch.maximum(hi1, hi2)
    lo = torch.minimum(lo, hi)                  # empty-graph guard
    hi = torch.where(hi - lo < 1e-6, lo + 1.0, hi)
    return lo, hi


def kron_domain(feats_1, ew1, feats_2, ew2):
    """The Chebyshev domain of every feature column over the real edges of
    both sides: a dict name -> (lo, hi) of floats."""
    out = {}
    for name in sorted(feats_1):
        lo, hi = _feature_domain(feats_1[name], ew1, feats_2[name], ew2)
        out[name] = (float(lo), float(hi))
    return out


def _normalize_ranks(ranks, names):
    """Per-feature rank tuple for the name-sorted feature columns. The
    default keeps the tensor grid within :data:`MAX_GRID` nodes: 8 a
    feature for two features, as the JAX module, and a decrement from there
    for more."""
    if ranks == 'off':          # calibration sentinel; treat as default
        ranks = None
    if ranks is None:
        R = DEFAULT_RANK
        if R ** len(names) > MAX_GRID:
            R = 8
        while R ** len(names) > MAX_GRID and R > 1:
            R -= 1
        return (R,) * len(names)
    if isinstance(ranks, int) or getattr(ranks, 'ndim', None) == 0:
        return (int(ranks),) * len(names)
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != len(names):
        raise ValueError(f'{len(ranks)} ranks for the {len(names)} edge '
                         f'features {names}')
    return ranks


def _outer_basis(Ls):
    """Tensor-product combination of per-feature basis values."""
    L = Ls[0]
    for Lf in Ls[1:]:
        L = L[..., :, None] * Lf[..., None, :]
        L = L.reshape(*L.shape[:-2], -1)
    return L


def _grid_axes(names, ranks, domain, device=None):
    """Per-feature Chebyshev nodes and weights on ``domain`` (name -> (lo,
    hi)), and the flattened tensor-grid coordinates (first sorted feature
    outermost): (axes: name -> (lo, hi, t, w), grids: name -> [Rg])."""
    axes = {}
    for name, R in zip(names, ranks):
        lo, hi = domain[name]
        t, w = _cheb_nodes(lo, hi, R, device)
        axes[name] = (lo, hi, t, w)
    ts = [axes[n][2] for n in names]
    mesh = torch.meshgrid(*ts, indexing='ij') if len(ts) > 1 else ts
    grids = {name: g.reshape(-1) for name, g in zip(names, mesh)}
    return axes, grids


def _grid_basis(feats1, feats2, ew1, ew2, ranks, domain=None):
    """Tensor-grid Chebyshev basis over the name-sorted scalar feature
    columns of both sides: (L1 [..., Rg], L2 [..., Rg], grids). Without a
    ``domain``, the joint range of both sides' real edges. Features are
    clamped into the domain first: padding edges carry 0, which can lie far
    outside it, where the barycentric form returns inf or NaN that a zero
    weight cannot cancel."""
    names = sorted(feats1)
    if domain is None:
        domain = kron_domain(feats1, ew1, feats2, ew2)
    device = next(iter(feats1.values())).device
    axes, grids = _grid_axes(names, ranks, domain, device)
    Ls1, Ls2 = [], []
    for name in names:
        lo, hi, t, w = axes[name]
        Ls1.append(_cheb_basis(feats1[name].clamp(lo, hi), t, w))
        Ls2.append(_cheb_basis(feats2[name].clamp(lo, hi), t, w))
    return _outer_basis(Ls1), _outer_basis(Ls2), grids


def _dense_grid_values(esrc, edst, ew, xcols, n_pad, names, axes):
    """Weighted tensor-grid basis values on the dense (i, j) node grid:
    [c, n_pad^2, Rg], w_e L(x_e) at each edge's (i, j) slot and 0 elsewhere.

    The edge weights and each feature are scattered into the grid (at most
    one directed edge an (i, j), the Graph contract; padding edges, w = 0,
    go to a trash slot that is cut off), then the basis is evaluated on
    the whole grid. Empty slots hold 0 and are clamped into the domain
    like padding edges; their zero weight removes them."""
    c, M = esrc.shape
    slots = n_pad * n_pad
    flat = torch.where(ew != 0, esrc.long() * n_pad + edst.long(), slots)
    Wg = torch.zeros(c, slots + 1, dtype=torch.float32, device=ew.device)
    Wg = Wg.scatter_add(1, flat, ew.to(torch.float32))[:, :-1]
    Ls = []
    for f, name in enumerate(names):
        lo, hi, t, w = axes[name]
        Xg = torch.zeros(c, slots + 1, dtype=torch.float32, device=ew.device)
        Xg = Xg.scatter(1, flat, xcols[:, :, f].to(torch.float32))[:, :-1]
        Ls.append(_cheb_basis(Xg.clamp(lo, hi), t, w))
    return _outer_basis(Ls) * Wg[..., None]


def _edge_kernel_grid(apply_on_features, kedge, te, grids):
    """C[p, q] = k_edge(grid_p, grid_q) on the flattened tensor grid."""
    X = {name: g[:, None] for name, g in grids.items()}
    Y = {name: g[None, :] for name, g in grids.items()}
    return apply_on_features(kedge, te, X, Y)


def _assemble_stack(esrc, edst, ew, L, n_pad):
    """A_p[i, j] = sum_{e: src=i, dst=j} w[e] L_p(x[e]) for one side of a
    chunk: esrc/edst [c, M], ew [c, M], L [c, M, R] -> [c, R, N, N].
    Padding edges carry w = 0 and add nothing."""
    c, M, R = L.shape
    A = torch.zeros(c, R, n_pad, n_pad, dtype=torch.float32, device=L.device)
    vals = (ew[:, :, None] * L).transpose(1, 2)          # [c, R, M]
    ci = torch.arange(c, device=L.device)[:, None, None]
    ri = torch.arange(R, device=L.device)[None, :, None]
    return A.index_put_((ci, ri, esrc.long()[:, None, :],
                         edst.long()[:, None, :]), vals, accumulate=True)


@contextlib.contextmanager
def _fp32_matmul():
    """float32 products without TF32 inside, the caller's setting restored
    on the way out (the JAX module asks for ``Precision.HIGH``)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def fold_side_2(V2, C):
    """B2s [c, R*n2, n2] from the side-2 grid values V2 [c, n2^2, R] and the
    grid kernel C [R, R]: ``B_p = sum_q C_pq A2_q``, rank-major rows."""
    c, nn, R = V2.shape
    n2 = math.isqrt(nn)
    with _fp32_matmul():
        V2f = (V2.reshape(c * nn, R) @ C.T).reshape(c, n2, n2, R)
    return V2f.permute(0, 3, 2, 1).reshape(c, R * n2, n2)


def stack_side_1(V1):
    """A1s [c, n1*R, n1] from the side-1 grid values V1 [c, n1^2, R]:
    node-major, rank-minor rows."""
    c, nn, R = V1.shape
    n1 = math.isqrt(nn)
    return V1.reshape(c, n1, n1, R).permute(0, 1, 3, 2).reshape(
        c, n1 * R, n1)


def kron_offdiag(A1s, B2s, Y):
    """The fused off-diagonal matvec over the k systems a pair:
    Y [c, k, n1, n2] -> [c, k, n1, n2], two ``bmm`` calls; the k right-hand
    sides of a pair share its factors and go through both products side by
    side (as columns of the first, rows of the second)."""
    c, k, n1, n2 = Y.shape
    R = A1s.shape[1] // n1
    with _fp32_matmul():
        # [c, n1, k * n2]: the k systems side by side as columns
        Yc = Y.permute(0, 2, 1, 3).reshape(c, n1, k * n2)
        G = torch.bmm(A1s, Yc)                           # [c, n1*R, k*n2]
        if k > 1:
            G = G.view(c, n1, R, k, n2).permute(0, 1, 3, 2, 4)
        G = G.reshape(c, n1 * k, R * n2)
        out = torch.bmm(G, B2s)                          # [c, n1*k, n2]
    return out.view(c, n1, k, n2).permute(0, 2, 1, 3)


def kron_offdiag_sequential(A1, B2, Y):
    """The plain twin of :func:`kron_offdiag`: the rank loop ``sum_r A1_r Y
    B2_r^T`` over unstacked factors A1 [c, R, n1, n1], B2 [c, R, n2, n2]
    (``B2_r = sum_q C_rq A2_q``); Y [c, n1, n2]."""
    out = torch.zeros_like(Y)
    with _fp32_matmul():
        for r in range(A1.shape[1]):
            out = out + torch.bmm(torch.bmm(A1[:, r], Y),
                                  B2[:, r].transpose(1, 2))
    return out


def _kron_grid(ops, plan):
    """(names, axes, grids) of the chunk's tensor grid: ``plan`` (a
    :class:`KronPlan`) gives the ranks and the domain; without one, the
    default ranks and the domain of the chunk's own real edges, the JAX
    module's default."""
    if not kron_eligible(ops):
        raise ValueError(
            "backend 'kron' needs one or two plain scalar edge features, the "
            'same on both sides')
    f1, f2 = ops['edge_elist_feats_1'], ops['edge_elist_feats_2']
    names = sorted(f1)
    ranks, domain = (None, None) if plan is None else plan[:2]
    ranks = _normalize_ranks(ranks, names)
    if domain is None:
        domain = kron_domain(f1, ops['ew_1'], f2, ops['ew_2'])
    axes, grids = _grid_axes(names, ranks, domain, ops['ew_1'].device)
    return names, axes, grids


def kron_grid_kernel(ops, apply_on_features, kedge, te, plan=None):
    """The chunk's grid kernel C [R, R] at the edge hyperparameters
    ``te``."""
    return _edge_kernel_grid(apply_on_features, kedge, te,
                             _kron_grid(ops, plan)[2])


def kron_factors(ops, apply_on_features, kedge, te, plan=None):
    """The kron system's coupling for a chunk of pairs: a dict with ``A1s``
    [P, n1*R, n1], ``B2s`` [P, R*n2, n2], the grid kernel ``C`` [R, R] (the
    only part that depends on the hyperparameters ``te``, differentiably)
    and ``V2`` [P, n2^2, R], side 2's grid values before C, which the
    tangents fold with C's derivatives. ``plan`` as :func:`_kron_grid`."""
    names, axes, grids = _kron_grid(ops, plan)
    C = _edge_kernel_grid(apply_on_features, kedge, te, grids)
    f1, f2 = ops['edge_elist_feats_1'], ops['edge_elist_feats_2']
    V1 = _dense_grid_values(ops['esrc_1'], ops['edst_1'], ops['ew_1'],
                            torch.stack([f1[n] for n in names], dim=-1),
                            ops['node_mask_1'].shape[1], names, axes)
    V2 = _dense_grid_values(ops['esrc_2'], ops['edst_2'], ops['ew_2'],
                            torch.stack([f2[n] for n in names], dim=-1),
                            ops['node_mask_2'].shape[1], names, axes)
    return {'A1s': stack_side_1(V1), 'B2s': fold_side_2(V2, C), 'C': C,
            'V2': V2}


def kron_tangent_offdiag(A1s, V2, C_d, x):
    """``offdiag_d(x)`` for every direction d of the grid kernel's
    derivative C_d [k, R, R]: [c, k, n1, n2], zero where C_d is. ``A1s @ x``
    runs once for all directions; each direction with a nonzero C_d folds
    side 2 with it (``B2s_d = V2 C_d^T``) for the second product."""
    c, n1, n2 = x.shape
    k, R = C_d.shape[0], C_d.shape[1]
    out = x.new_zeros(c, k, n1, n2)
    live = torch.nonzero(C_d.reshape(k, -1).abs().amax(dim=1) > 0)
    if live.numel() == 0:
        return out
    with _fp32_matmul():
        G = torch.bmm(A1s, x).reshape(c, n1, R * n2)
        for d in live[:, 0].tolist():
            out[:, d] = torch.bmm(G, fold_side_2(V2, C_d[d]))
    return out


@spanned('kron_pcg_call')
def kron_pcg(A1s, B2s, diag, precond, b, tol, maxiter, return_iters=False):
    """Solve the kron systems of a chunk for b [P, k, n1, n2] (k right-hand
    sides a pair, each to its pair's tol [P]) by the batched Jacobi-PCG of
    ``ops/pcg.py`` with the fused matvec: the kron route's solve, on the
    card and on the CPU alike. Returns x [P, k, n1, n2] (and the [P * k]
    step counts with ``return_iters``). Each call adds one to
    ``kron_pcg.launches``."""
    kron_pcg.launches += 1
    P, k, n1, n2 = b.shape
    N = n1 * n2
    diag_k = diag.reshape(P, 1, N).expand(P, k, N).reshape(P * k, N)

    def matvec(y):
        off = kron_offdiag(A1s, B2s, y.view(P, k, n1, n2))
        return diag_k * y - off.reshape(P * k, N)

    out = pcg(matvec, b.reshape(P * k, N),
              precond.reshape(P, 1, N).expand(P, k, N).reshape(P * k, N),
              tol.repeat_interleave(k), maxiter, return_iters=return_iters)
    if return_iters:
        return out[0].view(P, k, n1, n2), out[1]
    return out.view(P, k, n1, n2)


kron_pcg.launches = 0


def factorization_error(apply_on_features, kedge, te, feats_1, ew1,
                        feats_2, ew2, ranks=None, n_sample=1024,
                        generator=None, domain=None):
    """Max |k(x, y) - Chebyshev approx| over a random sample of real edge
    pairs: the kron path's accuracy diagnostic.

    ``feats_1``/``feats_2`` are dicts of scalar feature columns [P, M] (one
    tensor is taken as ``{'x': value}``), ``ew1``/``ew2`` their edge
    weights; rows of real edges (w != 0) are drawn with replacement by
    ``generator`` (a ``torch.Generator``; default seed 0). The grid lies on
    ``domain`` (name -> (lo, hi)), by default the range of ALL real edges of
    both sides, the domain the solve uses, not only the sample's."""
    if not isinstance(feats_1, dict):
        feats_1, feats_2 = {'x': feats_1}, {'x': feats_2}
    names = sorted(feats_1)
    ranks = _normalize_ranks(ranks, names)
    if domain is None:
        domain = kron_domain(feats_1, ew1, feats_2, ew2)
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def sample(feats, ew):
        # whole rows, so the columns of two features stay paired
        p = (ew.reshape(-1) != 0).to(torch.float32).cpu()
        idx = torch.multinomial(p, n_sample, replacement=True,
                                generator=generator).to(ew.device)
        return {n: feats[n].reshape(-1)[idx] for n in names}

    Xs = sample(feats_1, ew1)
    Ys = sample(feats_2, ew2)
    exact = apply_on_features(kedge, te, Xs, Ys)
    ones = torch.ones(1, n_sample, dtype=torch.float32, device=ew1.device)
    L1, L2, grids = _grid_basis({n: Xs[n][None, :] for n in names},
                                {n: Ys[n][None, :] for n in names},
                                ones, ones, ranks, domain)
    C = _edge_kernel_grid(apply_on_features, kedge, te, grids)
    approx = torch.einsum('sp,pq,sq->s', L1[0], C, L2[0])
    return (exact - approx).abs().max()


def calibrate_ranks(apply_on_features, kedge, te, feats_1, ew1, feats_2,
                    ew2, tol=None, candidates=None, n_sample=2048,
                    generator=None, domain=None):
    """The smallest per-feature Chebyshev rank whose
    :func:`factorization_error` is below ``tol`` (default :data:`RANK_TOL`)
    at the concrete edge hyperparameters ``te``: ``(ranks, err)``.

    Each rung draws a fresh sample from ``generator`` (default seed 0); the
    grid lies on ``domain``, by default that of all real edges of both
    sides. If the largest candidate misses ``tol``, or the error stops
    improving (a float32 floor, or a discontinuous factor such as a
    ``KroneckerDelta``, which no polynomial interpolates), the best rung
    is returned with its error, and a warning when that error exceeds
    :data:`ACCURACY_LIMIT`: mode ``'cuda'`` then keeps such pairs off the
    kron route."""
    if tol is None:
        tol = RANK_TOL
    if not isinstance(feats_1, dict):
        feats_1, feats_2 = {'x': feats_1}, {'x': feats_2}
    if domain is None:
        domain = kron_domain(feats_1, ew1, feats_2, ew2)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    n_feat = len(feats_1)
    if candidates is None:
        candidates = RANK_CANDIDATES if n_feat == 1 else RANK_CANDIDATES_2
    prev = None                       # (ranks, err) of the previous rung
    for R in candidates:
        err = float(factorization_error(
            apply_on_features, kedge, te, feats_1, ew1, feats_2, ew2,
            ranks=(R,) * n_feat, n_sample=n_sample, generator=generator,
            domain=domain))
        if err < tol:
            return (R,) * n_feat, err
        # plateau: more nodes only cost operations; keep the cheaper rung
        # if it was within 2x
        if prev is not None and err > 0.5 * prev[1]:
            best = prev if prev[1] <= 2 * err else ((R,) * n_feat, err)
            _warn_inaccurate(*best)
            return best
        prev = ((R,) * n_feat, err)
    _warn_inaccurate((R,) * n_feat, err)
    return (R,) * n_feat, err


def _warn_inaccurate(ranks, err):
    if err > ACCURACY_LIMIT:
        warnings.warn(
            f'kron rank calibration stopped at R = {ranks} with '
            f'factorization error {err:.3g} > {ACCURACY_LIMIT}: the edge '
            "kernel is not smooth enough for the Kronecker path; mode 'cuda' "
            'keeps these pairs on pcg_stream.')
