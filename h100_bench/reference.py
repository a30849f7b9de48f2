"""The plain reference of the marginalized graph kernel and of the Gaussian
process objectives, in plain PyTorch, independent of the program.

The kernel of a graph pair is that of Kashima et al. (2003) in the form of
Tang & de Jong (2019), as the suite's dense oracle (``tests/oracle.py``)
states it: with the node kernel's product-graph diagonal ``Vx[i1, i2] =
k_node(f1_i1, f2_i2)``, the degrees ``d = A 1`` of the weighted adjacency
A of each graph and ``Dx = kron(d1, d2) / (1 - q)^2``,

    [diag(Dx / Vx) - (A1 (x) A2) o Ex] x = Dx,    R = p^2 sum(x),

where ``Ex[(i1, i2), (j1, j2)] = k_edge(e1_{i1 j1}, e2_{i2 j2})``. A node
pair whose Dx or Vx is 0 has x = 0. The normalized kernel is ``R_ij /
sqrt(R_ii R_jj)``.

The hyperparameters are ``theta = [p, q, node..., edge...]``, the node and
edge kernels' in the order that the configuration lists them; the
reference takes their logarithms, as the program's ``kernel.theta`` does.

Two solvers: pairs of at most :data:`DENSE_MAX` product nodes are built as
dense matrices, many pairs a batch, and solved by Cholesky in float64;
larger pairs are solved one at a time by Jacobi-preconditioned conjugate
gradients over their directed edge lists (``T[e1, e2] = w1 w2
k_edge``), to a relative residual of 1e-12 in float64. Both build the
system in another ``dtype`` too (the control: the kernel values, degrees,
weights and so the matrix and the right-hand side computed and held in
bfloat16, as a program that stored T in bfloat16 would hold them), and
solve it from there in float64 as above.

Nothing here reads the program or what it made: the graphs are the
benchmark's arrays (:mod:`h100_bench.molecules`,
:mod:`h100_bench.proteins`).
"""
import numpy as np
import torch

#: the largest product graph (n1 * n2) that the dense path builds
DENSE_MAX = 1024
#: bytes of one batch's matrices on the dense path
DENSE_BATCH_BYTES = 1 << 30
#: relative residual at which the float64 edge path stops
EDGE_RTOL = 1e-12
MAXITER = 10000


def kronecker_delta(x, y, h):
    return torch.where(x == y, torch.ones_like(h), h)


def square_exponential(x, y, length_scale):
    return torch.exp(-0.5 * (x - y) ** 2 / length_scale ** 2)


MICROKERNELS = {'kronecker_delta': kronecker_delta,
                'square_exponential': square_exponential}


class KernelSpec:
    """The kernel of a configuration: ``config['kernel']`` holds ``p``,
    ``q``, and ``node`` and ``edge``, lists of [feature, microkernel,
    hyperparameter]; the tensor product of each list."""

    def __init__(self, config):
        k = config['kernel']
        self.p = float(k['p'])
        self.q = float(k['q'])
        self.node = [(f, MICROKERNELS[m], float(h)) for f, m, h in k['node']]
        self.edge = [(f, MICROKERNELS[m], float(h)) for f, m, h in k['edge']]

    def theta0(self):
        """The configuration's hyperparameters, linear scale."""
        return np.array([self.p, self.q] + [h for *_, h in self.node]
                        + [h for *_, h in self.edge])

    def split(self, theta):
        """(p, q, node hyperparameters, edge hyperparameters) of a linear
        theta tensor."""
        nn = len(self.node)
        return theta[0], theta[1], theta[2:2 + nn], theta[2 + nn:]

    def node_kernel(self, feats1, feats2, th):
        out = None
        for (f, k, _), h in zip(self.node, th):
            v = k(feats1[f], feats2[f], h)
            out = v if out is None else out * v
        return out

    def edge_kernel(self, feats1, feats2, th):
        out = None
        for (f, k, _), h in zip(self.edge, th):
            v = k(feats1[f], feats2[f], h)
            out = v if out is None else out * v
        return out


class DenseSet:
    """A graph set padded to its largest node count A, on ``device``: node
    counts [G], node features [G, A], weighted adjacency and edge features
    [G, A, A] (symmetric; 0 off the edges)."""

    def __init__(self, graphs, device, dtype=torch.float64):
        G = len(graphs)
        A = max(g['n'] for g in graphs)
        self.n = torch.tensor([g['n'] for g in graphs], device=device)
        node = {f: np.zeros((G, A)) for f in graphs[0]['node']}
        edge = {f: np.zeros((G, A, A)) for f in graphs[0]['edge']}
        W = np.zeros((G, A, A))
        for k, g in enumerate(graphs):
            for f, v in g['node'].items():
                node[f][k, :g['n']] = v
            i, j = g['src'].astype(np.int64), g['dst'].astype(np.int64)
            W[k, i, j] = W[k, j, i] = g['w']
            for f, v in g['edge'].items():
                edge[f][k, i, j] = edge[f][k, j, i] = v
        self.W = torch.tensor(W, dtype=dtype, device=device)
        self.node = {f: torch.tensor(v, dtype=dtype, device=device)
                     for f, v in node.items()}
        self.edge = {f: torch.tensor(v, dtype=dtype, device=device)
                     for f, v in edge.items()}


def _dense_system(spec, s1, s2, i1, i2, a1, a2, logtheta):
    """(A [B, N, N], b [B, N]) of the pairs (s1[i1], s2[i2]), padded to a1
    and a2 nodes (N = a1 a2), in the dtype of the sets."""
    p, q, tn, te = spec.split(torch.exp(logtheta))
    del p
    nf1 = {f: v[i1, :a1, None] for f, v in s1.node.items()}
    nf2 = {f: v[i2, None, :a2] for f, v in s2.node.items()}
    Vx = spec.node_kernel(nf1, nf2, tn)
    real1 = torch.arange(a1, device=s1.W.device)[None, :] < s1.n[i1, None]
    real2 = torch.arange(a2, device=s1.W.device)[None, :] < s2.n[i2, None]
    W1 = s1.W[i1, :a1, :a1]
    W2 = s2.W[i2, :a2, :a2]
    Dx = W1.sum(-1)[:, :, None] * W2.sum(-1)[:, None, :] / (1 - q) ** 2
    ok = real1[:, :, None] & real2[:, None, :] & (Dx > 0) & (Vx > 0)
    diag = torch.where(ok, Dx / torch.where(ok, Vx, 1.0), 1.0)
    b = torch.where(ok, Dx, 0.0)
    ef1 = {f: v[i1, :a1, :a1, None, None] for f, v in s1.edge.items()}
    ef2 = {f: v[i2, None, None, :a2, :a2] for f, v in s2.edge.items()}
    Ke = spec.edge_kernel(ef1, ef2, te)
    B, N = len(i1), a1 * a2
    W = (W1[:, :, :, None, None] * W2[:, None, None, :, :] * Ke)
    W = W.permute(0, 1, 3, 2, 4).reshape(B, N, N)
    okf = ok.reshape(B, N).to(W.dtype)
    W = W * okf[:, :, None] * okf[:, None, :]
    return torch.diag_embed(diag.reshape(B, N)) - W, b.reshape(B, N)


def _cg(matvec, b, precond, tol, maxiter):
    """Jacobi-preconditioned conjugate gradients over a batch: b, precond
    [B, N], tol [B] on the residual's norm; (x, steps [B])."""
    def dot(u, v):
        return (u * v).sum(-1)

    x = torch.zeros_like(b)
    r = b
    z = precond * r
    p = z
    rz = dot(r, z)
    done = torch.sqrt(dot(r, r)) < tol
    steps = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    for _ in range(maxiter):
        if bool(done.all()):
            break
        Ap = matvec(p)
        pAp = dot(p, Ap)
        live = ~done & (pAp != 0) & (rz != 0)
        alpha = torch.where(live, rz / torch.where(pAp != 0, pAp, 1), 0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = precond * r
        rz_new = dot(r, z)
        beta = torch.where(live, rz_new / torch.where(rz != 0, rz, 1), 0)
        p = z + beta[:, None] * p
        rz = torch.where(live, rz_new, rz)
        steps = steps + live.long()
        done = done | ~live | (torch.sqrt(dot(r, r)) < tol)
    return x, steps


def _batches(n1, n2, pairs):
    """Pairs of the dense path grouped by their padded sizes: yields
    (positions in ``pairs``, a1, a2); pairs sorted by size, each batch
    within :data:`DENSE_BATCH_BYTES`."""
    order = np.lexsort((n2[pairs[:, 1]], n1[pairs[:, 0]]))
    start = 0
    while start < len(order):
        a1 = int(n1[pairs[order[start], 0]])
        # a batch spans node counts up to a1 + 3 on side 1
        stop = start
        a2 = 0
        while stop < len(order) and n1[pairs[order[stop], 0]] <= a1 + 3:
            a2 = max(a2, int(n2[pairs[order[stop], 1]]))
            stop += 1
        a1 = int(n1[pairs[order[stop - 1], 0]])
        per = max(1, DENSE_BATCH_BYTES // (8 * (a1 * a2) ** 2))
        for s in range(start, stop, per):
            yield order[s:min(s + per, stop)], a1, a2
        start = stop


def dense_values(spec, s1, s2, pairs, logtheta, with_grad=False,
                 steps_tol=None):
    """R of the pairs (s1[i], s2[j]) for the rows (i, j) of ``pairs``
    [P, 2] on the dense path: the system built in the dtype of the sets,
    solved by Cholesky in float64, and with ``with_grad`` also dR / d log
    theta [P, D] (each direction's tangent system solved with the same
    factor). With ``steps_tol`` (a factor f), returns instead the
    conjugate-gradient steps [P] that each pair takes to a residual norm
    below f n1 n2."""
    device = s1.W.device
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    P = len(pairs)
    D = len(logtheta)
    n1, n2 = s1.n.cpu().numpy(), s2.n.cpu().numpy()
    R = torch.zeros(P, dtype=torch.float64, device=device)
    dR = torch.zeros(P, D, dtype=torch.float64, device=device)
    steps = torch.zeros(P, dtype=torch.int64, device=device)
    logtheta = torch.as_tensor(logtheta, dtype=torch.float64, device=device)
    lt = logtheta.to(s1.W.dtype)
    p2 = torch.exp(2 * logtheta[0])

    def system(i1, i2, a1, a2, t):
        return _dense_system(spec, s1, s2, i1, i2, a1, a2, t)

    for pos, a1, a2 in _batches(n1, n2, pairs):
        i1 = torch.as_tensor(pairs[pos, 0], device=device)
        i2 = torch.as_tensor(pairs[pos, 1], device=device)
        pos_t = torch.as_tensor(pos, device=device)
        A, b = (v.double() for v in system(i1, i2, a1, a2, lt))
        if steps_tol is not None:
            diag = torch.diagonal(A, dim1=1, dim2=2)
            tol = steps_tol * (s1.n[i1] * s2.n[i2]).to(torch.float64)
            _, st = _cg(lambda v: torch.bmm(A, v[:, :, None])[:, :, 0], b,
                        1 / diag, tol, MAXITER)
            steps[pos_t] = st
            continue
        L = torch.linalg.cholesky(A)
        x = torch.cholesky_solve(b[:, :, None], L)[:, :, 0]
        R[pos_t] = p2 * x.sum(-1)
        for d in range(D if with_grad else 0):
            e = torch.zeros_like(lt)
            e[d] = 1.0
            _, (dA, db) = torch.func.jvp(
                lambda t: system(i1, i2, a1, a2, t), (lt,), (e,))
            rhs = db.double() - torch.bmm(dA.double(), x[:, :, None])[:, :, 0]
            dx = torch.cholesky_solve(rhs[:, :, None], L)[:, :, 0]
            dR[pos_t, d] = p2 * dx.sum(-1) + (2 * R[pos_t] if d == 0
                                              else 0.0)
        del A, L
    if steps_tol is not None:
        return steps
    return (R, dR) if with_grad else R


def _directed(g, dtype, device):
    """(src, dst, w, edge features) of a graph's directed edges, each
    undirected edge both ways."""
    def both(a):
        return torch.as_tensor(np.concatenate([a, a])).to(device)
    src = torch.as_tensor(np.concatenate([g['src'], g['dst']]).astype(
        np.int64), device=device)
    dst = torch.as_tensor(np.concatenate([g['dst'], g['src']]).astype(
        np.int64), device=device)
    return (src, dst, both(g['w']).to(dtype),
            {f: both(v).to(dtype) for f, v in g['edge'].items()})


def edge_value(spec, g1, g2, logtheta, device, dtype=torch.float64,
               steps_tol=None):
    """R of one pair on the edge path (a float): T, the diagonal and b
    built in ``dtype``, the solve in float64; with ``steps_tol`` the
    conjugate-gradient steps to a residual norm below steps_tol n1 n2
    instead."""
    logtheta = torch.as_tensor(logtheta, dtype=torch.float64, device=device)
    p, q, tn, te = spec.split(torch.exp(logtheta).to(dtype))
    s1, d1, w1, ef1 = _directed(g1, dtype, device)
    s2, d2, w2, ef2 = _directed(g2, dtype, device)
    n1, n2 = g1['n'], g2['n']
    nf1 = {f: torch.as_tensor(v, device=device).to(dtype)[:, None]
           for f, v in g1['node'].items()}
    nf2 = {f: torch.as_tensor(v, device=device).to(dtype)[None, :]
           for f, v in g2['node'].items()}
    Vx = spec.node_kernel(nf1, nf2, tn)
    deg1 = torch.zeros(n1, dtype=dtype, device=device).index_add_(0, s1, w1)
    deg2 = torch.zeros(n2, dtype=dtype, device=device).index_add_(0, s2, w2)
    Dx = deg1[:, None] * deg2[None, :] / (1 - q) ** 2
    ok = (Dx > 0) & (Vx > 0)
    diag = torch.where(ok, Dx / torch.where(ok, Vx, 1.0), 1.0).double()
    b = torch.where(ok, Dx, 0.0).double().reshape(1, -1)
    T = (w1[:, None] * w2[None, :] * spec.edge_kernel(
        {f: v[:, None] for f, v in ef1.items()},
        {f: v[None, :] for f, v in ef2.items()}, te)).double()
    zero = torch.zeros((), dtype=torch.float64, device=device)

    def matvec(v):
        x = v.reshape(n1, n2)
        Z = T * x[d1][:, d2]
        y = torch.zeros(len(s1), n2, dtype=torch.float64, device=device)
        y.index_add_(1, s2, Z)
        y = torch.zeros(n1, n2, dtype=torch.float64,
                        device=device).index_add_(0, s1, y)
        return (diag * x - torch.where(ok, y, zero)).reshape(1, -1)

    precond = (1 / diag).reshape(1, -1)
    if steps_tol is not None:
        tol = torch.tensor([steps_tol * n1 * n2], dtype=torch.float64,
                           device=device)
        return int(_cg(matvec, b, precond, tol, MAXITER)[1][0])
    tol = EDGE_RTOL * torch.linalg.vector_norm(b, dim=-1)
    x, _ = _cg(matvec, b, precond, tol, MAXITER)
    return float(p.double() ** 2 * x.sum())


class Reference:
    """The reference over one or two graph lists of a configuration, on
    ``device`` and in ``dtype`` (float64; bfloat16 for the control)."""

    def __init__(self, config, device, dtype=torch.float64):
        self.spec = KernelSpec(config)
        self.device = device
        self.dtype = dtype
        self._dense = {}

    def _set(self, graphs):
        key = id(graphs)
        if key not in self._dense:
            self._dense[key] = (graphs, DenseSet(graphs, self.device,
                                                 self.dtype))
        return self._dense[key][1]

    def values(self, X, Y, pairs, logtheta, with_grad=False,
               steps_tol=None):
        """R (and dR / d log theta) of the pairs (X[i], Y[j]) for the rows
        of ``pairs``, as float64 numpy; with ``steps_tol`` the float64
        conjugate-gradient steps of each pair instead."""
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        nx = np.array([g['n'] for g in X])
        ny = np.array([g['n'] for g in Y])
        big = nx[pairs[:, 0]] * ny[pairs[:, 1]] > DENSE_MAX
        if big.any() and with_grad:
            raise NotImplementedError(
                'gradients of pairs beyond the dense path')
        out = np.zeros(len(pairs), dtype=np.int64 if steps_tol else float)
        grad = np.zeros((len(pairs), len(logtheta)))
        small = np.flatnonzero(~big)
        if len(small):
            res = dense_values(self.spec, self._set(X), self._set(Y),
                               pairs[small], logtheta, with_grad, steps_tol)
            if with_grad:
                out[small] = res[0].cpu().numpy()
                grad[small] = res[1].cpu().numpy()
            else:
                out[small] = res.cpu().numpy()
        for k in np.flatnonzero(big):
            out[k] = edge_value(self.spec, X[pairs[k, 0]], Y[pairs[k, 1]],
                                logtheta, self.device, self.dtype,
                                steps_tol)
        return (out, grad) if with_grad else out

    def gram(self, X, logtheta, with_grad=False):
        """The normalized Gram of X [n, n] (and d K / d log theta [n, n,
        D]), float64 numpy."""
        n = len(X)
        i, j = np.triu_indices(n)
        res = self.values(X, X, np.stack([i, j], 1), logtheta, with_grad)
        R, dR = res if with_grad else (res, None)
        full = np.zeros((n, n))
        full[i, j] = full[j, i] = R
        d = np.sqrt(np.diag(full))
        K = full / d[:, None] / d[None, :]
        if not with_grad:
            return K
        dfull = np.zeros((n, n, len(logtheta)))
        dfull[i, j] = dfull[j, i] = dR
        ddiag = dfull[np.arange(n), np.arange(n)] / np.diag(full)[:, None]
        dK = dfull / d[:, None, None] / d[None, :, None] - 0.5 * K[
            :, :, None] * (ddiag[:, None, :] + ddiag[None, :, :])
        return K, dK

    def cross(self, Z, X, logtheta, diag_X=None):
        """The normalized cross Gram [len(Z), len(X)]; ``diag_X`` the R of
        X's self pairs where they are known."""
        nz, nx = len(Z), len(X)
        i, j = np.indices((nz, nx))
        R = self.values(Z, X, np.stack([i.ravel(), j.ravel()], 1),
                        logtheta).reshape(nz, nx)
        rz = self.values(Z, Z, np.stack([np.arange(nz)] * 2, 1), logtheta)
        rx = diag_X if diag_X is not None else self.values(
            X, X, np.stack([np.arange(nx)] * 2, 1), logtheta)
        return R / np.sqrt(rz)[:, None] / np.sqrt(rx)[None, :]


#: eigenvalue floor, relative to the largest, of the clamped inverse that
#: stands in for a Cholesky factor of a Gram that is not positive definite
#: (the model's ``beta``, its default)
RCOND = 1e-8


def _inverse(K, alpha):
    """(K + alpha I)^-1 and log |K + alpha I| in float64, by Cholesky, or,
    where that fails, by the eigendecomposition with the eigenvalues
    clamped below at RCOND times the largest, as the model falls back."""
    Kt = torch.as_tensor(K, dtype=torch.float64)
    Kt = Kt + alpha * torch.eye(len(Kt), dtype=torch.float64)
    L, info = torch.linalg.cholesky_ex(Kt)
    if int(info) == 0:
        eye = torch.eye(len(Kt), dtype=torch.float64)
        return (torch.cholesky_solve(eye, L),
                2 * torch.log(torch.diagonal(L)).sum())
    w, Q = torch.linalg.eigh(0.5 * (Kt + Kt.T))
    w = torch.clamp(w, min=float(w[-1]) * RCOND)
    return (Q / w) @ Q.T, torch.log(w).sum()


def gp_nll(K, y, alpha, dK=None):
    """The Gaussian process objective of a normalized Gram K, float64:
    ``y^T (K + alpha I)^-1 y + log |K + alpha I|`` with y standardized
    (mean 0, population std 1), the negative log marginal likelihood as
    ``GaussianProcessRegressor.log_marginal_likelihood`` defines it (twice
    the usual, without its constant); with dK [n, n, D], also its gradient
    in log theta [D]."""
    y = torch.as_tensor((y - y.mean()) / y.std(), dtype=torch.float64)
    Kinv, logdet = _inverse(K, alpha)
    a = Kinv @ y
    value = float(y @ a + logdet)
    if dK is None:
        return value
    G = Kinv - a[:, None] * a[None, :]
    grad = torch.einsum('ij,ijk->k', G, torch.as_tensor(dK))
    return value, grad.numpy()


def gp_mean(K_train, y, alpha, Ks):
    """The posterior mean at the rows of the cross Gram Ks [m, n] of a
    Gaussian process on the normalized training Gram K_train with noise
    alpha and y standardized as :func:`gp_nll` takes it, float64."""
    mean, std = y.mean(), y.std()
    Kinv, _ = _inverse(K_train, alpha)
    w = Kinv @ torch.as_tensor((y - mean) / std, dtype=torch.float64)
    return (torch.as_tensor(Ks) @ w).numpy() * std + mean
