"""T's build in one pass (``ops/setup_edge.py``, ``csrc/setup_edge.cu``).

On the CPU: every microkernel the library exports, alone and under
``TensorProduct``, ``Normalize``, ``+``, ``*`` and ``**``, either gives its
C expression (``MicroKernel.c_expr``) or declines; the generated C itself,
built for the host by the system's C++ compiler (its twin here), equals
``_solver._apply_on_features`` on random features to float32 rounding and
builds the plain operations' T on real chunks, zero at every padded edge
(also at a tiny length scale); with the twin in the launcher's place a
Gram is the plain path's; the rule that engages the pass keeps the plain
operations on the CPU, in the plain modes, under ``jacfwd`` and ``vmap``,
with theta requiring grad and for kernels or columns that do not lower;
the counters ``setup_edge.pairs`` and ``setup_edge.fused`` count nothing
without a profiler and every pair with one.

On the card (``cuda`` marker, skipped without one): the kernel's T equals
the plain T within 1e-6 max|T| and is exactly 0 at every padded edge, on
the QM7 surrogate's first chunk of each class pair, at a length scale of
1e-4, with a normalized two-feature edge kernel, with a categorical
``KroneckerDelta`` on protein chunks and on rows of odd widths; a whole
Gram through ``GramFactory`` equals the plain path's within 1e-6. This
file imports no JAX:

    python -m pytest --noconftest tests/test_torch_setup_edge.py
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from graphdot_tpu_torch.inference import GramFactory  # noqa: E402
from graphdot_tpu_torch.kernel import MarginalizedGraphKernel  # noqa: E402
from graphdot_tpu_torch.kernel.marginalized import _solver  # noqa: E402
from graphdot_tpu_torch.microkernel import (  # noqa: E402
    Constant, Convolution, DotProduct, KroneckerDelta, MicroKernel,
    Normalize, Product, RationalQuadratic, SquareExponential, TensorProduct)
from graphdot_tpu_torch.ops import setup_edge as se  # noqa: E402
from graphdot_tpu_torch.testing import (  # noqa: E402
    protein_niche_set, random_molecule_set)
from graphdot_tpu_torch.util import trace  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread, as the other port tests do (the test
    processes run side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: the generated C on the host: the template's entry of T, row by row
HOST_SOURCE = """
#include <math.h>
#define __device__
#define __forceinline__ inline
namespace k{i} {{
{source}
}}
extern "C" void coupling_{i}(const float *const *c1, const float *const *c2,
                             const float *w1, const float *w2,
                             const float *th, float *T, long P, long M1,
                             long M2) {{
    using namespace k{i};
    for (long p = 0; p < P; ++p)
        for (long a = 0; a < M1; ++a)
            for (long b = 0; b < M2; ++b) {{
                float x[kSlots], y[kSlots];
                for (int c = 0; c < kFeatures; ++c) {{
                    x[c] = c1[c][p * M1 + a];
                    y[c] = c2[c][p * M2 + b];
                }}
                const float wx = w1[p * M1 + a], wy = w2[p * M2 + b];
                T[(p * M1 + a) * M2 + b] = wx != 0.f && wy != 0.f
                    ? (edge_kernel(x, y, th) * wx) * wy : 0.f;
            }}
}}
"""


class HostTwin:
    """The generated C of lowered edge kernels built for the host by one
    ``g++`` call a batch (``-ffp-contract=off``: no fused multiply-adds, as
    torch on the CPU), called through ctypes."""

    def __init__(self, directory):
        self.directory = directory
        self.functions = {}

    def build(self, lowered):
        sources = sorted({lo.source for lo in lowered} - set(self.functions))
        if not sources:
            return
        n = len(list(self.directory.glob('twin*.so')))
        cpp = self.directory / f'twin{n}.cpp'
        lib_path = cpp.with_suffix('.so')
        cpp.write_text(''.join(HOST_SOURCE.format(i=i, source=src)
                               for i, src in enumerate(sources)))
        subprocess.run([shutil.which('g++') or 'c++', '-O2', '-std=c++17',
                        '-ffp-contract=off', '-shared', '-fPIC', str(cpp),
                        '-o', str(lib_path)], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(lib_path))
        for i, src in enumerate(sources):
            fn = getattr(lib, f'coupling_{i}')
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_long] * 3
            self.functions[src] = fn

    def __call__(self, lowered, theta, cols1, cols2, w1, w2):
        """T [P, M1, M2] of the generated C, as ``setup_edge`` takes its
        arguments, on the CPU."""
        self.build([lowered])
        keep = [t.detach().to(torch.float32).contiguous()
                for t in (theta, w1, w2, *cols1, *cols2)]
        theta, w1, w2 = keep[:3]
        n = len(lowered.columns)
        cols = [(ctypes.c_void_p * max(n, 1))(*(t.data_ptr() for t in part))
                for part in (keep[3:3 + n], keep[3 + n:])]
        P, M1, M2 = w1.shape[0], w1.shape[1], w2.shape[1]
        T = torch.empty(P, M1, M2, dtype=torch.float32)
        self.functions[lowered.source](
            ctypes.addressof(cols[0]), ctypes.addressof(cols[1]),
            w1.data_ptr(), w2.data_ptr(), theta.data_ptr(), T.data_ptr(),
            P, M1, M2)
        return T


#: every microkernel the library exports, by name; None: it declines
ELEMENTARY = {
    'Constant': lambda: Constant(0.7),
    'KroneckerDelta': lambda: KroneckerDelta(0.3),
    'SquareExponential': lambda: SquareExponential(0.8),
    'RationalQuadratic': lambda: RationalQuadratic(0.9, 1.5),
    'Product': lambda: Product(),
    'Convolution': lambda: Convolution(KroneckerDelta(0.5)),
    'DotProduct': lambda: DotProduct(),
}
DECLINE = {'Convolution', 'DotProduct'}
#: how each is wrapped, over the columns 'a' (and 'b')
WRAPPERS = {
    'alone': lambda k: k,
    'TensorProduct': lambda k: TensorProduct(a=k,
                                             b=SquareExponential(0.5)),
    'Normalize': Normalize,
    'add': lambda k: k + KroneckerDelta(0.4),
    'mul': lambda k: k * RationalQuadratic(1.2, 0.7),
    'pow': lambda k: k ** 2,
    'scaled_pair': lambda k: Normalize(TensorProduct(
        b=SquareExponential(0.6), a=k)) * 0.5,
}


def features(kind, shape, rng):
    """A column of random features of the kernel ``kind`` wants:
    (values, mask) pairs for the vector kernels, else small integers as
    float32 (so that categorical ones meet equal values)."""
    if kind in DECLINE:
        L = 3
        v = torch.as_tensor(rng.integers(0, 3, (*shape, L)),
                            dtype=torch.float32)
        return (v, torch.ones_like(v))
    return torch.as_tensor(rng.integers(0, 4, shape) * 0.37,
                           dtype=torch.float32)


def feature_dicts(kind, wrapper, rng, P=3, M1=5, M2=6):
    X = {'a': features(kind, (P, M1), rng)}
    Y = {'a': features(kind, (P, M2), rng)}
    if wrapper in ('TensorProduct', 'scaled_pair'):
        X['b'] = torch.as_tensor(rng.uniform(0, 2, (P, M1)),
                                 dtype=torch.float32)
        Y['b'] = torch.as_tensor(rng.uniform(0, 2, (P, M2)),
                                 dtype=torch.float32)
    return X, Y


@pytest.fixture(scope='module')
def host(tmp_path_factory):
    """The host twin, with the generated C of every kernel below built in
    one ``g++`` call."""
    twin = HostTwin(tmp_path_factory.mktemp('setup_edge_twin'))
    rng = np.random.default_rng(0)
    lowered = [se.lower(WRAPPERS[w](ELEMENTARY[k]()),
                        list(feature_dicts(k, w, rng)[0]))
               for k in ELEMENTARY for w in WRAPPERS]
    lowered += [se.lower(EDGE_KERNELS[name](), [c]) for name, c in (
        ('square_exponential', 'length'), ('tiny_length_scale', 'length'),
        ('categorical', 'ctype'))]
    twin.build([lo for lo in lowered if lo is not None])
    return twin


@pytest.mark.parametrize('wrapper', WRAPPERS)
@pytest.mark.parametrize('kind', ELEMENTARY)
def test_the_walker_lowers_or_declines_and_its_twin_agrees(kind, wrapper,
                                                           host):
    """Each exported microkernel, wrapped: the vector ones decline (None),
    the others give a C expression, and that C, built for the host, is the
    plain evaluation of the kernel to float32 rounding."""
    kernel = WRAPPERS[wrapper](ELEMENTARY[kind]())
    rng = np.random.default_rng(7)
    X, Y = feature_dicts(kind, wrapper, rng)
    lowered = se.lower(kernel, list(X))
    if kind in DECLINE:
        assert lowered is None
        return
    assert lowered is not None and lowered.n_theta == kernel.n_theta
    assert set(lowered.columns) <= set(X)
    assert 'edge_kernel(' in lowered.source
    assert se._MARKER not in lowered.kernel_source
    assert lowered.source in lowered.kernel_source
    theta = torch.tensor(kernel.flat_theta, dtype=torch.float32)
    want = _solver._apply_on_features(
        kernel, theta, _solver._expand_dict(X, (2,)),
        _solver._expand_dict(Y, (1,)))
    P, M1, M2 = 3, 5, 6
    got = host(lowered, theta, [X[c] for c in lowered.columns],
               [Y[c] for c in lowered.columns], torch.ones(P, M1),
               torch.ones(P, M2))
    want = want.expand(got.shape)
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert se.lower(kernel, list(X)) is lowered     # cached


def test_the_source_follows_the_expression_not_theta():
    """Two kernels of one expression and other hyperparameters give one
    text; the C of the preset's kernel reads theta from th[] and squares
    by products."""
    a = se.lower(TensorProduct(length=SquareExponential(0.05)), ['length'])
    b = se.lower(TensorProduct(length=SquareExponential(3.0)), ['length'])
    assert a is not b and a.kernel_source == b.kernel_source
    assert 'th[0]' in a.source and 'powf' not in a.source
    assert 'expf(' in a.source and '0.05' not in a.source


class _NoC(MicroKernel):
    """A microkernel of its own, with ``apply`` and no C expression."""

    name = 'NoC'
    n_theta = 1
    theta = bounds = minmax = (0.5,)

    def __call__(self, i, j, jac=False):
        return 0.5

    def __repr__(self):
        return 'NoC()'

    def apply(self, theta, X, Y):
        return theta[0] * X * Y


@pytest.mark.parametrize('case', ['elementary_on_two_columns',
                                  'missing_column', 'unknown_node'])
def test_the_walker_declines(case):
    if case == 'elementary_on_two_columns':
        # the plain path raises its own error for this kernel
        assert se.lower(KroneckerDelta(0.5), ['a', 'b']) is None
    elif case == 'missing_column':
        assert se.lower(TensorProduct(c=KroneckerDelta(0.5)), ['a']) is None
    else:
        assert se.lower(TensorProduct(a=_NoC()), ['a']) is None
        assert se.lower(Normalize(_NoC()) + 1.0, ['a']) is None


def port_kernel(edge, device='cpu'):
    """The ``cuda`` route's kernel (its plain twins on the CPU)."""
    return MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)), edge, q=0.05,
        device=device, backend='cuda')


EDGE_KERNELS = {
    'square_exponential': lambda: TensorProduct(
        length=SquareExponential(0.3)),
    'tiny_length_scale': lambda: TensorProduct(
        length=SquareExponential(1e-4)),
    'normalized_two_features': lambda: Normalize(TensorProduct(
        length=SquareExponential(3.0), ctype=KroneckerDelta(0.3))),
    'categorical': lambda: TensorProduct(ctype=KroneckerDelta(0.3)),
}


def chunk_operands(kernel, graphs1, graphs2):
    """The per-pair operands of every pair between two graph sets, and
    theta."""
    device = kernel.device
    _, bd1, _ = kernel._prepare_batch(graphs1)
    _, bd2, _ = kernel._prepare_batch(graphs2)
    i, j = np.indices((len(graphs1), len(graphs2)))
    ops = kernel._operands(bd1, bd2,
                           torch.as_tensor(i.ravel(), device=device),
                           torch.as_tensor(j.ravel(), device=device))
    return ops, kernel._theta_vector()


def graph_sets(name):
    if name in ('normalized_two_features', 'categorical'):
        return protein_niche_set(5, 3, (20, 30)), protein_niche_set(6, 2,
                                                                    (25, 35))
    return random_molecule_set(3, 5, (9, 16)), random_molecule_set(4, 4,
                                                                   (9, 24))


def setup(kernel, ops, theta):
    return _solver.mlgk_setup(theta, ops, knode=kernel.node_kernel,
                              kedge=kernel.edge_kernel, n_p_theta=1,
                              mode='cuda')


def padded_edges(ops):
    return (ops['ew_1'] == 0)[:, :, None] | (ops['ew_2'] == 0)[:, None, :]


@pytest.mark.parametrize('name', EDGE_KERNELS)
def test_the_twin_builds_the_plain_T(name, host, monkeypatch):
    """The generated C over a chunk's operands, built for the host, is the
    plain operations' T: its shape, dtype, contiguity, zeros at every
    padded edge, within 1e-6 max|T|; with the twin in the launcher's place
    ``mlgk_setup`` takes the pass and returns it."""
    kernel = port_kernel(EDGE_KERNELS[name]())
    ops, theta = chunk_operands(kernel, *graph_sets(name))
    plain = setup(kernel, ops, theta)['T']
    monkeypatch.setattr(_solver, '_on_card', lambda t: True)
    fused = _solver.fused_edge_setup(
        'cuda', theta, kernel.edge_kernel, ops['edge_elist_feats_1'],
        ops['edge_elist_feats_2'], ops['ew_1'])
    assert fused is not None
    _, _, te = _solver._split_theta(theta, kernel.node_kernel,
                                    kernel.edge_kernel, 1)
    T = host(*fused[:1], te, *fused[1:], ops['ew_1'], ops['ew_2'])
    assert T.shape == plain.shape and T.dtype == torch.float32
    assert T.is_contiguous() and torch.isfinite(T).all()
    assert (T[padded_edges(ops).expand(T.shape)] == 0).all()
    assert padded_edges(ops).any()
    assert (T - plain).abs().max() <= 1e-6 * plain.abs().max()
    monkeypatch.setattr(_solver, 'setup_edge', host)
    assert torch.equal(setup(kernel, ops, theta)['T'], T)


def test_a_gram_through_the_twin_is_the_plain_gram(host, monkeypatch):
    """A normalized Gram through ``GramFactory`` with the pass engaged
    (the host twin in the launcher's place) is the plain path's Gram
    within 1e-6."""
    kernel = port_kernel(EDGE_KERNELS['square_exponential']())
    graphs = random_molecule_set(11, 7, (5, 14))
    plain = GramFactory(kernel, graphs).gram(np.log(
        kernel.flat_hyperparameters))
    calls = []
    monkeypatch.setattr(_solver, '_on_card', lambda t: True)
    monkeypatch.setattr(_solver, 'setup_edge',
                        lambda *args: calls.append(1) or host(*args))
    fused = GramFactory(kernel, graphs).gram(np.log(
        kernel.flat_hyperparameters))
    assert calls
    assert (fused - plain).abs().max() <= 1e-6


RULE_CASES = ['card', 'cpu', 'edge_mode', 'dense_mode', 'jacfwd', 'vmap',
              'requires_grad', 'requires_grad_no_grad', 'declines',
              'vector_column', 'integer_column']


@pytest.mark.parametrize('case', RULE_CASES)
def test_the_rule_that_engages_the_pass(case, monkeypatch):
    """Only mode 'cuda' on the card, with no autograd graph wanted and no
    torch.func transform, over a kernel that lowers on float32 columns,
    takes the pass; everything else keeps the plain operations."""
    kernel = port_kernel(EDGE_KERNELS['square_exponential']())
    ops, theta = chunk_operands(kernel, *graph_sets('square_exponential'))
    if case != 'cpu':
        monkeypatch.setattr(_solver, '_on_card', lambda t: True)
    kedge = kernel.edge_kernel
    f1, f2 = ops['edge_elist_feats_1'], ops['edge_elist_feats_2']
    mode = {'edge_mode': 'edge', 'dense_mode': 'dense'}.get(case, 'cuda')
    if case == 'declines':
        kedge = TensorProduct(length=Convolution(KroneckerDelta(0.5)))
    if case == 'vector_column':
        f1 = {'length': (f1['length'][..., None], torch.ones_like(
            f1['length'][..., None]))}
    if case == 'integer_column':
        f2 = {'length': f2['length'].to(torch.int32)}
    seen = []

    def rule(t):
        seen.append(_solver.fused_edge_setup(mode, t, kedge, f1, f2,
                                             ops['ew_1']))
        return t * 2

    if case == 'jacfwd':
        torch.func.jacfwd(rule)(theta)
    elif case == 'vmap':
        torch.func.vmap(rule)(theta[None].expand(2, -1))
    elif case.startswith('requires_grad'):
        t = theta.clone().requires_grad_()
        if case == 'requires_grad':
            rule(t)
        else:
            with torch.no_grad():
                rule(t)
    else:
        rule(theta)
    engaged = [s is not None for s in seen]
    want = case in ('card', 'requires_grad_no_grad')
    assert engaged == [want]
    if want:
        lowered, cols1, cols2 = seen[0]
        assert lowered.columns == ('length',)
        assert cols1[0] is f1['length'] and cols2[0] is f2['length']


@pytest.mark.parametrize('engaged', [False, True])
def test_the_counters_count_pairs_only_under_a_profiler(engaged, host,
                                                        monkeypatch):
    """``setup_edge.pairs`` counts every pair that reaches T's build and
    ``setup_edge.fused`` those the pass built, only while a profiler
    records; the tangents' jacobian builds T by the plain operations."""
    kernel = port_kernel(EDGE_KERNELS['square_exponential']())
    ops, theta = chunk_operands(kernel, *graph_sets('square_exponential'))
    P = ops['ew_1'].shape[0]
    if engaged:
        monkeypatch.setattr(_solver, '_on_card', lambda t: True)
        monkeypatch.setattr(_solver, 'setup_edge', host)
    trace.reset_counters()
    try:
        setup(kernel, ops, theta)
        assert trace.counters() == {}
        with profile(activities=[ProfilerActivity.CPU]):
            setup(kernel, ops, theta)
            torch.func.jacfwd(lambda t: setup(kernel, ops, t)['T'])(theta)
        c = trace.counters()
        assert c['setup_edge.pairs'] == 2 * P
        assert c.get('setup_edge.fused', 0) == (P if engaged else 0)
    finally:
        trace.reset_counters()


def test_the_launch_wrapper_takes_only_cuda_tensors():
    """``setup_edge`` on CPU tensors raises, and launches nothing."""
    lowered = se.lower(TensorProduct(length=SquareExponential(0.3)),
                       ['length'])
    f1, f2 = torch.ones(2, 8), torch.ones(2, 5)
    before = se.setup_edge.launches
    with pytest.raises(ValueError, match='CUDA'):
        se.setup_edge(lowered, torch.tensor([0.3]), [f1], [f2], f1, f2)
    assert se.setup_edge.launches == before


def test_a_generated_source_builds_once_by_the_hash_of_its_text(
        monkeypatch, tmp_path):
    """``_build.load_text`` writes the text beside its library, both named
    by the hash of the text and the flags; the same text is one build, and
    another text (another expression) a new one."""
    from graphdot_tpu_torch.ops import _build
    built = []

    def build_all(targets):
        for key, (src, _, lib) in targets.items():
            built.append((key, src.read_text(), lib.name))
            _build._LOADED[key] = (f'lib {key}', {})
    monkeypatch.setattr(_build, '_BUILD_DIR', tmp_path)
    monkeypatch.setattr(_build, 'nvcc_path', lambda: 'nvcc')
    monkeypatch.setattr(_build, '_build_all', build_all)
    monkeypatch.setattr(_build, '_LOADED', {})
    a = se.lower(TensorProduct(length=SquareExponential(0.05)), ['length'])
    b = se.lower(TensorProduct(length=RationalQuadratic(0.5, 2.0)),
                 ['length'])
    lib_a = _build.load_text('setup_edge', a.kernel_source)
    assert _build.load_text('setup_edge', a.kernel_source) == lib_a
    lib_b = _build.load_text('setup_edge', b.kernel_source)
    assert lib_b != lib_a and len(built) == 2
    (key, text, lib), _ = built
    assert key.startswith('setup_edge-') and lib == f'{key}.so'
    assert text == a.kernel_source
    assert (tmp_path / f'{key}.cu').read_text() == a.kernel_source


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel runs only there')
    return torch.device('cuda')


def tang2019_kernel(length_scale=0.05):
    """The benchmark configuration's kernel (Tang and de Jong 2019's
    preset) on the card."""
    return MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(length_scale)), q=0.01,
        device='cuda')


def qm7_graphs():
    from graphdot_tpu_torch.dataset.qm7_fixture import load_qm7
    from graphdot_tpu_torch.graph import Graph
    mols, _, _ = load_qm7()
    return Graph.unify_datatype([Graph.from_ase(m, use_pbc=False)
                                 for m in mols])


def both_T(kernel, ops, theta, monkeypatch):
    """(the kernel's T, the plain operations' T) of the operands."""
    before = se.setup_edge.launches
    T = setup(kernel, ops, theta)['T']
    torch.cuda.synchronize()
    assert se.setup_edge.launches == before + 1
    with monkeypatch.context() as m:
        m.setattr(_solver, '_on_card', lambda t: False)
        plain = setup(kernel, ops, theta)['T']
    return T, plain


def check_T(T, plain, ops):
    assert T.shape == plain.shape and T.dtype == torch.float32
    assert T.is_contiguous() and torch.isfinite(T).all()
    assert (T[padded_edges(ops).expand(T.shape)] == 0).all()
    scale = plain.abs().max()
    assert scale > 0
    assert (T - plain).abs().max() <= 1e-6 * scale


@pytest.mark.cuda
@pytest.mark.parametrize('length_scale', [0.05, 1e-4])
def test_card_qm7_chunks_of_each_class_pair(card, length_scale,
                                            monkeypatch):
    kernel = tang2019_kernel(length_scale)
    fac = GramFactory(kernel, qm7_graphs())
    plan = fac._plan
    assert len(plan.groups) >= 3
    theta = fac.full_theta(fac.theta0)
    for grp in plan.groups:
        _, idx1, idx2 = next(iter(plan.chunks(grp)))
        ops = kernel._operands(grp['bd1'], grp['bd2'], idx1, idx2)
        T, plain = both_T(kernel, ops, theta, monkeypatch)
        check_T(T, plain, ops)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['normalized_two_features', 'categorical'])
def test_card_protein_chunks(card, name, monkeypatch):
    kernel = port_kernel(EDGE_KERNELS[name](), device='cuda')
    ops, theta = chunk_operands(kernel, protein_niche_set(13, 4, (60, 90)),
                                protein_niche_set(14, 3, (40, 70)))
    T, plain = both_T(kernel, ops, theta, monkeypatch)
    check_T(T, plain, ops)


@pytest.mark.cuda
@pytest.mark.parametrize('M2', [7, 13, 1030])
def test_card_odd_widths_and_wide_rows(card, M2):
    """Rows that are not a multiple of 4 floats (scalar stores) and rows
    wider than one CTA's 1024 columns, against the plain operations."""
    edge = TensorProduct(length=SquareExponential(0.3))
    lowered = se.lower(edge, ['length'])
    rng = np.random.default_rng(M2)

    def t(*shape, lo=0.0, hi=2.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape),
                               dtype=torch.float32, device=card)
    P, M1 = 3, 37
    f1, f2 = t(P, M1), t(P, M2)
    w1 = t(P, M1) * (t(P, M1) > 0.5)
    w2 = t(P, M2) * (t(P, M2) > 0.5)
    theta = torch.tensor([0.3], device=card)
    T = se.setup_edge(lowered, theta, [f1], [f2], w1, w2)
    want = _solver.plain_edge_coupling(edge, theta, {'length': f1},
                                       {'length': f2}, w1, w2)
    check_T(T, want, {'ew_1': w1, 'ew_2': w2})


@pytest.mark.cuda
def test_card_gram_matches_the_plain_path(card, monkeypatch):
    kernel = tang2019_kernel()
    graphs = qm7_graphs()[:64]
    theta = np.log(kernel.flat_hyperparameters)
    before = se.setup_edge.launches
    K = GramFactory(kernel, graphs).gram(theta)
    assert se.setup_edge.launches > before
    monkeypatch.setattr(_solver, '_on_card', lambda t: False)
    plain = GramFactory(kernel, graphs).gram(theta)
    assert (K - plain).abs().max() <= 1e-6
