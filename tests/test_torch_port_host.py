"""The port's own host layer against the JAX package's, and its default
device.

``graphdot_tpu_torch`` carries copies of the graph container, the padded
batcher, the synthetic sets and the hyperparameter-tree helpers, so that
it imports nothing of ``graphdot_tpu``. These tests hold the copies to the
originals array by array (same seeds, same numbers), check that graphs of
either package batch in the other, and that the port's kernel runs on the
card unless the caller asks for the CPU.
"""
import fnmatch
import os
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from graphdot_tpu.graph.batch import (  # noqa: E402
    batch_graphs as jax_batch_graphs)
from graphdot_tpu import testing as jax_testing  # noqa: E402

import graphdot_tpu_torch  # noqa: E402
from graphdot_tpu_torch import testing as port_testing  # noqa: E402
from graphdot_tpu_torch.graph import Graph, batch_graphs  # noqa: E402
from graphdot_tpu_torch.kernel import (  # noqa: E402
    MarginalizedGraphKernel, Normalization, Tang2019MolecularKernel)
from graphdot_tpu_torch.microkernel import (  # noqa: E402
    KroneckerDelta, SquareExponential, TensorProduct)

from test_torch_stream import bench_protein_recipe  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_nothing_of_the_jax_package():
    """Every module of the port imported, and a CPU Gram built, in a fresh
    interpreter: no ``graphdot_tpu`` module and no JAX module loaded."""
    code = (
        'import importlib, pkgutil, sys\n'
        'import graphdot_tpu_torch\n'
        'names = [m.name for m in pkgutil.walk_packages(\n'
        '    graphdot_tpu_torch.__path__, "graphdot_tpu_torch.")]\n'
        'for name in names:\n'
        '    importlib.import_module(name)\n'
        'assert len(names) >= 40, names\n'
        'from graphdot_tpu_torch.kernel import (\n'
        '    MarginalizedGraphKernel, Normalization)\n'
        'from graphdot_tpu_torch.microkernel import (\n'
        '    KroneckerDelta, SquareExponential, TensorProduct)\n'
        'from graphdot_tpu_torch.testing import random_molecule_set\n'
        'k = MarginalizedGraphKernel(\n'
        '    TensorProduct(element=KroneckerDelta(0.2)),\n'
        '    TensorProduct(length=SquareExponential(0.3)), q=0.05,\n'
        '    device="cpu")\n'
        'K = Normalization(k)(random_molecule_set(0, 3, (5, 8)))\n'
        'assert K.shape == (3, 3)\n'
        'from graphdot_tpu_torch.inference import GramFactory\n'
        'from graphdot_tpu_torch.model.gaussian_process import (\n'
        '    GaussianProcessRegressor)\n'
        'f = GramFactory(k, random_molecule_set(0, 3, (5, 8)))\n'
        'assert f.gram(f.theta0).shape == (3, 3)\n'
        'assert GaussianProcessRegressor(k).device == "cuda"\n'
        'import graphdot_tpu_torch.inference as inference\n'
        'from graphdot_tpu_torch.inference import (\n'
        '    GPRLogProb, GramFactory, sample, nuts_step, hmc_step,\n'
        '    hmc_init, HMCState, smc_sample, advi, split_rhat, ess,\n'
        '    da_init, da_update, save_chains, load_chains, resume_state)\n'
        'assert len(inference.__all__) == 16, inference.__all__\n'
        'lp = GPRLogProb(k, random_molecule_set(0, 3, (5, 8)), [0., 1., 2.])\n'
        'assert lp(lp.theta0).shape == ()\n'
        'import graphdot_tpu_torch.metric\n'
        'import graphdot_tpu_torch.experimental\n'
        'import graphdot_tpu_torch.graph.adjacency\n'
        'import graphdot_tpu_torch.dataset\n'
        'from graphdot_tpu_torch.metric import (\n'
        '    MaxiMin, KernelInducedDistance)\n'
        'from graphdot_tpu_torch.experimental.metric import M3\n'
        'from graphdot_tpu_torch.dataset.qm7_fixture import load_qm7\n'
        'from graphdot_tpu_torch.graph import Graph\n'
        'mols = load_qm7(n=3)[0]\n'
        'G = [Graph.from_ase(m, use_pbc=False) for m in mols]\n'
        'm = MaxiMin(TensorProduct(element=KroneckerDelta(0.2)),\n'
        '            TensorProduct(length=SquareExponential(0.3)), q=0.05,\n'
        '            device="cpu")\n'
        'assert m(G).shape == (3, 3)\n'
        'assert M3(q=0.05, device="cpu")(mols[0], mols[1]) > 0\n'
        'from graphdot_tpu_torch.model.gaussian_process import (\n'
        '    LowRankApproximateGPR, GPROutlierDetector)\n'
        'from graphdot_tpu_torch.model.active_learning import (\n'
        '    VarianceMinimizer, DeterminantMaximizer, HierarchicalDrafter)\n'
        'from graphdot_tpu_torch.model.gaussian_field import (\n'
        '    GaussianFieldRegressor, Weight, RBFOverDistance,\n'
        '    RBFOverFixedDistance)\n'
        'from graphdot_tpu_torch.microkernel import (\n'
        '    Convolution, DotProduct, RationalQuadratic)\n'
        'from graphdot_tpu_torch.linalg import (\n'
        '    block, cg, cholesky, low_rank, spectral)\n'
        'from graphdot_tpu_torch.kernel import Normalization\n'
        'nk = Normalization(k)\n'
        'core = HierarchicalDrafter(VarianceMinimizer(nk))(G, 2,\n'
        '                                                  random_state=0)\n'
        'nys = LowRankApproximateGPR(nk, alpha=1e-4, device="cpu")\n'
        'nys.fit([G[i] for i in core], G, [1.0, 2.0, 3.0])\n'
        'assert nys.predict(G).shape == (3,)\n'
        'w = RBFOverDistance(m, sigma=0.5)\n'
        'z = GaussianFieldRegressor(w, device="cpu").predict(\n'
        '    G, [1.0, float("nan"), 3.0])\n'
        'assert z.shape == (3,)\n'
        'assert cholesky.CholSolver([[4.0]], device="cpu") @ [8.0] == 2.0\n'
        'from graphdot_tpu_torch.parallel import (\n'
        '    make_mesh, sharded_gram_fn, sharded_gp_solve, init_distributed)\n'
        'assert sharded_gram_fn(f, make_mesh())(f.theta0).shape == (3, 3)\n'
        'from graphdot_tpu_torch.model.tree_search import (\n'
        '    MCTSGraphTransformer, LookAheadSequenceRewriter)\n'
        'from graphdot_tpu_torch.graph.reorder import rcm, pbr\n'
        'assert sorted(pbr(G[0])) == list(range(len(G[0].nodes)))\n'
        'from graphdot_tpu_torch.minipandas import DataFrame, Series\n'
        'from graphdot_tpu_torch.util.flops import gram_flop_report\n'
        'from graphdot_tpu_torch.util.random import as_generator\n'
        'bad = sorted(m for m in sys.modules\n'
        '             if m == "graphdot_tpu" or m.startswith("graphdot_tpu.")\n'
        '             or m == "jax" or m.startswith(("jax.", "jaxlib")))\n'
        'assert not bad, bad\n'
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


#: set -> (the port's graphs, the JAX package's graphs), small sizes
SETS = {
    'molecules': lambda m: m.random_molecule_set(42, 8, (9, 24)),
    'proteins': lambda m: m.random_protein_set(5, 3, (40, 70)),
    'niche': lambda m: (m.protein_niche_set(13, 3, (40, 70))
                        if m is port_testing
                        else bench_protein_recipe(13, 3, (40, 70))),
}


def _assert_tree_equal(got, want, where):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for key in want:
            _assert_tree_equal(got[key], want[key], f'{where}.{key}')
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f'{where}[{i}]')
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)


def _assert_graphs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.title == w.title
        for part in ('nodes', 'edges'):
            gf, wf = getattr(g, part), getattr(w, part)
            assert list(gf.columns) == list(wf.columns)
            for col in wf.columns:
                _assert_tree_equal(gf[col], wf[col], f'{part}.{col}')


@pytest.mark.parametrize('name', SETS)
def test_synthetic_sets_and_batches_match_the_jax_package(name):
    got = SETS[name](port_testing)
    want = SETS[name](jax_testing)
    assert all(type(g) is Graph for g in got)
    _assert_graphs_equal(got, want)
    port_batch = batch_graphs(got)
    jax_batch = jax_batch_graphs(want, use_native=False)
    assert port_batch._fields == jax_batch._fields
    for field in jax_batch._fields:
        _assert_tree_equal(getattr(port_batch, field),
                           getattr(jax_batch, field), field)


def test_graphs_batch_across_packages():
    """A JAX Graph batches in the port and a port Graph in the JAX
    package, each as it does at home; each package caches its packing in
    the graph's cookie under a key of its own."""
    port_graphs = port_testing.random_molecule_set(3, 4, (5, 12))
    jax_graphs = jax_testing.random_molecule_set(3, 4, (5, 12))
    want = batch_graphs(port_graphs)
    for field in want._fields:
        _assert_tree_equal(getattr(batch_graphs(jax_graphs), field),
                           getattr(want, field), field)
        _assert_tree_equal(
            getattr(jax_batch_graphs(port_graphs, use_native=False), field),
            getattr(want, field), field)
    keys = set(port_graphs[0].cookie)
    assert keys == {'graphdot_tpu.packed', 'graphdot_tpu_torch.packed'}


@pytest.mark.parametrize('seed', [0, 7, 'generator'])
def test_random_copy_matches_the_jax_package(seed):
    from graphdot_tpu.util.random import as_generator as jax_as_generator
    from graphdot_tpu_torch.util.random import as_generator
    if seed == 'generator':
        rng = np.random.default_rng(3)
        assert as_generator(rng) is rng
        seed = 3
    got, want = as_generator(seed), jax_as_generator(seed)
    np.testing.assert_array_equal(got.random(7), want.random(7))
    np.testing.assert_array_equal(got.integers(0, 100, 9),
                                  want.integers(0, 100, 9))
    assert isinstance(as_generator(None), np.random.Generator)


def test_minipandas_copy_matches_the_jax_package():
    from graphdot_tpu import minipandas as jax_minipandas
    from graphdot_tpu_torch import minipandas
    data = {'a': [3, 1, 2], 'b': [0.5, -1.0, 2.25], 'c': ['x', 'y', 'z']}
    got, want = minipandas.DataFrame(data), jax_minipandas.DataFrame(data)
    assert list(got.columns) == list(want.columns) and len(got) == 3
    for col in data:
        _assert_tree_equal(got[col], want[col], col)
        assert got[col].concrete_type == want[col].concrete_type
    assert list(got.itertuples()) == list(want.itertuples())
    got['d'] = got.a * 2
    want['d'] = want.a * 2
    _assert_tree_equal(got.drop(['a']).d, want.drop(['a']).d, 'd')
    assert got.to_pandas().equals(want.to_pandas())
    _assert_tree_equal(minipandas.Series([1.0, 2.0]),
                       jax_minipandas.Series([1.0, 2.0]), 'series')


def _kernel_kwargs():
    return dict(node_kernel=TensorProduct(element=KroneckerDelta(0.2)),
                edge_kernel=TensorProduct(length=SquareExponential(0.3)),
                q=0.05)


def test_kernel_defaults_to_the_card(monkeypatch):
    """With no ``device`` the kernel asks for the card, and raises where
    torch finds none: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        MarginalizedGraphKernel(**_kernel_kwargs())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Tang2019MolecularKernel()


def test_metrics_default_to_the_card(monkeypatch):
    """``MaxiMin``, ``M3``, ``KernelOverMetric`` and ``RBFKernel`` ask for
    the card unless told otherwise, and raise where torch finds none."""
    from graphdot_tpu_torch.experimental.metric import M3
    from graphdot_tpu_torch.kernel._kernel_over_metric import (
        KernelOverMetric)
    from graphdot_tpu_torch.kernel.rbf import RBFKernel
    from graphdot_tpu_torch.metric import MaxiMin

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        MaxiMin(**_kernel_kwargs())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        M3()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        RBFKernel('exp(-d)', 'd')

    class NoDevice:
        """A distance that names no device."""
        theta = np.zeros(0)

    with pytest.raises(RuntimeError, match='no CUDA device'):
        KernelOverMetric(NoDevice(), 'v * exp(-d)', 'd', v=1.0)
    metric = MaxiMin(**_kernel_kwargs(), device='cpu')
    assert metric.device == torch.device('cpu')
    assert M3(device='cpu').kernel.device == torch.device('cpu')
    assert KernelOverMetric(metric, 'v * exp(-d)', 'd', v=1.0).device == \
        torch.device('cpu')


def test_kernel_runs_on_the_cpu_when_asked():
    graphs = port_testing.random_molecule_set(0, 3, (5, 8))
    kernel = MarginalizedGraphKernel(**_kernel_kwargs(), device='cpu')
    assert kernel.device == torch.device('cpu')
    K = Normalization(kernel)(graphs)
    np.testing.assert_allclose(np.diag(K), 1.0, rtol=0, atol=1e-12)
    clone = Normalization(kernel).clone_with_theta(kernel.theta)
    assert clone.kernel.device == torch.device('cpu')
    np.testing.assert_allclose(clone(graphs), K, rtol=0, atol=0)
    tang = Tang2019MolecularKernel(device='cpu')
    assert tang.clone_with_theta(tang.theta).kernel.device == \
        torch.device('cpu')


def test_graph_copy_carries_no_converters_of_the_jax_package():
    """The copy carries ``from_ase`` (numpy and scipy only; duck-typed
    atoms) and none of the converters that need pymatgen or RDKit;
    NetworkX round trips."""
    assert callable(Graph.from_ase)
    for name in ('from_pymatgen', 'from_smiles', 'from_rdkit'):
        assert not hasattr(Graph, name)
    g = port_testing.random_molecule_set(1, 1, (5, 8))[0]
    h = Graph.from_networkx(g.to_networkx())
    assert len(h.nodes) == len(g.nodes) and len(h.edges) == len(g.edges)
    assert graphdot_tpu_torch.Graph is Graph


def test_package_data_ships_every_kernel_source_and_include():
    """An installed (non-editable) copy of the port builds its kernels from
    the package data: every file under ``graphdot_tpu_torch/csrc/``, and
    every quoted ``#include`` of its ``.cu`` files, matches a glob of
    ``pyproject.toml``'s package data."""
    with open(ROOT / 'pyproject.toml', 'rb') as f:
        globs = tomllib.load(f)['tool']['setuptools']['package-data'][
            'graphdot_tpu_torch']
    package = ROOT / 'graphdot_tpu_torch'
    csrc = package / 'csrc'
    needed = {p.relative_to(package).as_posix() for p in csrc.iterdir()}
    for source in csrc.glob('*.cu'):
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                               source.read_text(), flags=re.M):
            included = (source.parent / name).resolve()
            assert included.is_file(), (source.name, name)
            needed.add(included.relative_to(package).as_posix())
    assert {'csrc/pcg_block.cuh', 'csrc/pcg_resident.cu'} <= needed
    missing = sorted(p for p in needed
                     if not any(fnmatch.fnmatch(p, g) for g in globs))
    assert not missing, missing
