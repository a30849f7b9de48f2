"""The port's dataset loaders against the JAX package's, on the same
synthetic files, on the CPU (no test downloads anything).

The files are built as in ``tests/test_dataset.py``: a ``qm7.mat`` at the
published column layout (X, T, Z, R, P), a ``dsgdb9nsd``-style ``tar.bz2``
of QM9 records, a METLIN CSV with ';' and one with ',', and an AMES CSV.
Every column is compared exactly: arrays by ``np.array_equal`` with their
dtype, floats bit for bit, atoms by numbers, positions and charges. Also:
``load_qm7``'s real-file branch, ``get`` on an existing file (returned
untouched, ``requests`` never imported) and on a missing one (a fake
``requests`` module stands in for the network), and the graphs that
``Graph.from_ase`` builds from the loaded atoms in either package.
"""
import io
import os
import subprocess
import sys
import tarfile
import types
from pathlib import Path

import numpy as np
import pytest
import scipy.io

pd = pytest.importorskip('pandas')

from graphdot_tpu import dataset as jax_dataset  # noqa: E402
from graphdot_tpu.dataset._atoms import (  # noqa: E402
    make_atoms as jax_make_atoms)
from graphdot_tpu.dataset.qm7_fixture import (  # noqa: E402
    load_qm7 as jax_load_qm7)
from graphdot_tpu.graph import Graph as JaxGraph  # noqa: E402

from graphdot_tpu_torch import dataset  # noqa: E402
from graphdot_tpu_torch.dataset.qm7_fixture import load_qm7  # noqa: E402
from graphdot_tpu_torch.graph import Graph  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _assert_atoms_equal(a, b):
    for get in ('get_atomic_numbers', 'get_positions',
                'get_initial_charges'):
        x, y = getattr(a, get)(), getattr(b, get)()
        assert x.dtype == y.dtype and np.array_equal(x, y), get


def _assert_value_equal(a, b, where):
    if hasattr(b, 'get_atomic_numbers'):
        _assert_atoms_equal(a, b)
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), where
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), where
    elif isinstance(b, float):
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), where
    else:
        assert type(a) is type(b) and a == b, where


def assert_frames_equal(df, jdf):
    """Same columns in the same order, dtypes and index; every value the
    same bits (numeric columns as arrays, the others value by value)."""
    assert isinstance(df, pd.DataFrame) and isinstance(jdf, pd.DataFrame)
    assert list(df.columns) == list(jdf.columns)
    assert df.index.equals(jdf.index)
    for col in jdf.columns:
        a, b = df[col], jdf[col]
        assert a.dtype == b.dtype, col
        if getattr(b.dtype, 'kind', 'O') in 'biuf':
            assert a.to_numpy().tobytes() == b.to_numpy().tobytes(), col
        else:
            assert len(a) == len(b), col
            for i, (x, y) in enumerate(zip(a, b)):
                _assert_value_equal(x, y, (col, i))


def write_qm7_mat(path, molecules, energies):
    """``molecules`` (Atoms-like) and their energies as a ``qm7.mat`` at
    QM7's column layout: X [n, 23, 23] Coulomb matrices, Z [n, 23] charges
    and R [n, 23, 3] positions (0-padded), T [1, n], P [5, n // 5]."""
    n = len(molecules)
    Z, R, X = np.zeros((n, 23)), np.zeros((n, 23, 3)), np.zeros((n, 23, 23))
    for i, m in enumerate(molecules):
        z, r = m.get_atomic_numbers(), m.get_positions()
        Z[i, :len(z)], R[i, :len(z)] = z, r
        d = np.linalg.norm(r[:, None] - r[None], axis=-1)
        np.fill_diagonal(d, 1.0)
        c = np.outer(z, z) / d
        np.fill_diagonal(c, 0.5 * z ** 2.4)
        X[i, :len(z), :len(z)] = c
    scipy.io.savemat(path, {
        'X': X.astype(np.float32), 'Z': Z.astype(np.float32),
        'R': R.astype(np.float32), 'T': np.asarray(energies)[None],
        'P': np.arange(n - n % 5).reshape(5, -1)})


@pytest.fixture(scope='module')
def qm7_mat(tmp_path_factory):
    """A qm7.mat of the surrogate's first 30 molecules."""
    mols, energy, _ = load_qm7(n=30)
    path = tmp_path_factory.mktemp('qm7') / 'qm7.mat'
    write_qm7_mat(path, mols, energy)
    return path


def test_qm7_matches_jax_on_the_offline_fixture(tmp_path):
    """The synthetic qm7.mat of ``tests/test_dataset.py``, random values at
    float64."""
    n = 10
    rng = np.random.default_rng(0)
    Z = np.zeros((n, 23))
    R = np.zeros((n, 23, 3))
    for i in range(n):
        na = rng.integers(3, 8)
        Z[i, :na] = rng.choice([1, 6, 7, 8], size=na)
        R[i, :na] = rng.normal(size=(na, 3))
    f = tmp_path / 'qm7.mat'
    scipy.io.savemat(f, {'X': rng.normal(size=(n, 23, 23)),
                         'T': rng.normal(size=(1, n)) * 100, 'Z': Z,
                         'R': R, 'P': np.arange(n).reshape(5, 2)})
    for ase in (False, True):
        qm7 = dataset.QM7(local_filename=str(f), ase=ase)
        assert_frames_equal(qm7, jax_dataset.QM7(local_filename=str(f),
                                                 ase=ase))
    assert sorted(qm7.split.unique()) == [0, 1, 2, 3, 4]
    assert len(qm7.atoms[0]) == int((Z[0] != 0).sum())


def test_qm7_matches_jax_on_surrogate_molecules(qm7_mat):
    qm7 = dataset.QM7(local_filename=str(qm7_mat), ase=True)
    assert_frames_equal(qm7, jax_dataset.QM7(local_filename=str(qm7_mat),
                                             ase=True))
    assert len(qm7) == 30 and list(np.bincount(qm7.split)) == [6] * 5


def test_load_qm7_real_file_branch_matches_jax(qm7_mat):
    """``load_qm7`` reads the file through QM7 when it exists (source
    'qm7.mat'), with ``n`` as JAX's, and the surrogate when it does not;
    the molecules are the surrogate's at float32 and their graphs equal
    the JAX package's."""
    for n in (None, 12):
        mols, energy, source = load_qm7(n=n, real_path=str(qm7_mat))
        jmols, jenergy, jsource = jax_load_qm7(n=n, real_path=str(qm7_mat))
        assert source == jsource == 'qm7.mat'
        assert len(mols) == len(jmols) == (n or 30)
        assert energy.tobytes() == jenergy.tobytes()
        for m, jm in zip(mols, jmols):
            _assert_atoms_equal(m, jm)
    surrogate, _, _ = load_qm7(n=12)
    for m, s in zip(mols, surrogate):
        assert np.array_equal(m.get_atomic_numbers(), s.get_atomic_numbers())
        np.testing.assert_allclose(m.get_positions(), s.get_positions(),
                                   rtol=1e-6, atol=1e-6)
    for m, jm in zip(mols, jmols):
        _assert_graph_equal(Graph.from_ase(m, use_pbc=False),
                            JaxGraph.from_ase(jm, use_pbc=False))
    assert load_qm7(n=3, real_path=str(qm7_mat) + '.absent')[2] == \
        'surrogate'


def _assert_graph_equal(g, jg):
    for part in ('nodes', 'edges'):
        frame, jframe = getattr(g, part), getattr(jg, part)
        assert list(frame.columns) == list(jframe.columns), part
        for col in jframe.columns:
            a, b = np.asarray(frame[col]), np.asarray(jframe[col])
            assert a.dtype == b.dtype and np.array_equal(a, b), (part, col)


def xyz_record(idx, symbols, coords, charges):
    """One record of the GDB-9 archive (``qm9._parse_record``'s layout)."""
    lines = [str(len(symbols))]
    props = ['gdb', str(idx)] + [f'{v:.6f}' for v in range(1, 16)]
    lines.append('\t'.join(props))
    for s, (x, y, z), c in zip(symbols, coords, charges):
        lines.append(f'{s}\t{x:.4f}\t{y:.4f}\t{z:.4f}\t{c:.4f}')
    lines.append('\t'.join(['100.0'] * 3))          # frequencies
    lines.append('C\tC')                            # smiles
    lines.append('InChI=1S/x\tInChI=1S/x')          # inchi
    return '\n'.join(lines) + '\n'


def write_qm9_archive(path, records):
    with tarfile.open(path, 'w:bz2') as tf:
        for idx, text in enumerate(records):
            raw = text.encode()
            info = tarfile.TarInfo(f'dsgdb9nsd_{idx + 1:06d}.xyz')
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))


def test_qm9_matches_jax(tmp_path):
    """The two records of ``tests/test_dataset.py`` (with the raw files'
    '*^' exponents) and the surrogate's first 8 molecules. JAX's
    ``ase=True`` needs ASE; the port's atoms are held to the parsed
    columns, and their graphs to JAX's graphs of the same atoms."""
    symbol = {1: 'H', 6: 'C', 7: 'N', 8: 'O', 16: 'S'}
    records = [
        xyz_record(idx + 1, syms,
                   [(0.1 * k, 0.2 * k, 0.3 * k) for k in range(len(syms))],
                   [-0.1] * len(syms)).replace('e-01', '*^-01')
        for idx, syms in enumerate([['C', 'H', 'H', 'H', 'H'],
                                    ['O', 'H', 'H']])]
    rng = np.random.default_rng(3)
    for i, m in enumerate(load_qm7(n=8)[0]):
        z = m.get_atomic_numbers()
        records.append(xyz_record(
            i + 3, [symbol[int(v)] for v in z], m.get_positions(),
            rng.normal(scale=0.3, size=len(z))))
    f = tmp_path / 'qm9.tar.bz2'
    write_qm9_archive(f, records)
    qm9 = dataset.QM9(local_filename=str(f))
    assert_frames_equal(qm9, jax_dataset.QM9(local_filename=str(f)))
    assert list(qm9.id) == list(range(1, 11))
    assert qm9.symbols[0] == ('C', 'H', 'H', 'H', 'H')

    with_atoms = dataset.QM9(local_filename=str(f), ase=True)
    assert_frames_equal(with_atoms.drop(columns='atoms'), qm9)
    number = {s: z for z, s in symbol.items()}
    for row in with_atoms.itertuples():
        a = row.atoms
        want = jax_make_atoms(
            [number[s] for s in row.symbols], row.xyz,
            np.asarray(row.charges_mulliken, dtype=float))
        _assert_atoms_equal(a, want)
        assert a.get_initial_charges()[0] == float(row.charges_mulliken[0])
        _assert_graph_equal(Graph.from_ase(a, use_pbc=False),
                            JaxGraph.from_ase(want, use_pbc=False))


@pytest.mark.parametrize('sep', [';', ','])
def test_metlin_smrt_matches_jax(tmp_path, sep):
    """METLIN reads ';' and falls back to ',' when that gives one
    column."""
    f = tmp_path / 'smrt.csv'
    f.write_text(sep.join(['pubchem', 'inchi', 'rt']) + '\n'
                 + sep.join(['1', 'InChI=1S/x', '120.5']) + '\n'
                 + sep.join(['2', 'InChI=1S/y', '98.1']) + '\n')
    df = dataset.METLIN_SMRT(local_filename=str(f))
    assert_frames_equal(df, jax_dataset.METLIN_SMRT(local_filename=str(f)))
    assert list(df.columns) == ['pubchem', 'inchi', 'rt']
    assert df.rt[0] == 120.5


def test_ames_matches_jax(tmp_path):
    f = tmp_path / 'ames.csv'
    f.write_text('smiles,label\nC1=CC=CC=C1,1\nCCO,0\nc1ccncc1,1\n')
    df = dataset.AMES(local_filename=str(f))
    assert_frames_equal(df, jax_dataset.AMES(local_filename=str(f)))
    assert list(df.label) == [1, 0, 1]


def test_loaders_raise_as_jax_on_a_bad_file(tmp_path):
    f = tmp_path / 'broken.mat'
    f.write_bytes(b'not a mat file')
    for QM7 in (dataset.QM7, jax_dataset.QM7):
        with pytest.raises(RuntimeError, match='broken.mat'):
            QM7(local_filename=str(f))


def test_get_returns_an_existing_file_untouched():
    """In a fresh interpreter: ``get`` returns the path of a file that
    exists, or ``parser``'s result on it, leaves its bytes and times as
    they were, and never imports ``requests``."""
    code = (
        'import os, sys, tempfile\n'
        'from graphdot_tpu_torch.dataset import get\n'
        'd = tempfile.mkdtemp()\n'
        'f = os.path.join(d, "data.csv")\n'
        'open(f, "w").write("a,b\\n1,2\\n")\n'
        'before = os.stat(f)\n'
        'assert get("http://localhost:9/none", f) == f\n'
        'assert get("http://localhost:9/none", f,\n'
        '           parser=lambda p: open(p).read()) == "a,b\\n1,2\\n"\n'
        'after = os.stat(f)\n'
        'assert (before.st_mtime_ns, before.st_size) == \\\n'
        '    (after.st_mtime_ns, after.st_size)\n'
        'assert "requests" not in sys.modules, "requests imported"\n'
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize('status', [200, 404])
def test_get_fetches_a_missing_file_as_jax(tmp_path, monkeypatch, status):
    """A missing file (or ``overwrite``) is fetched through
    ``requests.get``, here a fake module that records the URL: the same
    bytes written, or the same error, in both packages."""
    urls = []

    def fake_get(url):
        urls.append(url)
        return types.SimpleNamespace(status_code=status,
                                     content=b'x,y\n3,4\n')

    monkeypatch.setitem(sys.modules, 'requests',
                        types.SimpleNamespace(get=fake_get))
    for name, get in (('port', dataset.get), ('jax', jax_dataset.get)):
        f = tmp_path / f'{name}.csv'
        if status != 200:
            with pytest.raises(RuntimeError, match='status code 404'):
                get('http://localhost:9/data', str(f))
            assert not f.exists()
            continue
        assert get('http://localhost:9/data', str(f)) == str(f)
        assert f.read_bytes() == b'x,y\n3,4\n'
        f.write_bytes(b'old')
        get('http://localhost:9/data', str(f), overwrite=True)
        assert f.read_bytes() == b'x,y\n3,4\n'
    assert urls == ['http://localhost:9/data'] * (4 if status == 200 else 2)


def test_make_atoms_takes_ase_where_it_is_installed(monkeypatch):
    """With an ``ase`` module importable (a fake here), ``make_atoms`` of
    either package builds its ``Atoms``, charges set as JAX's; the port
    looks ASE up once a process, so the lookup is cleared around the
    fake."""
    from graphdot_tpu_torch.dataset import _atoms

    class Atoms:
        def __init__(self, numbers, positions):
            self.numbers, self.positions = numbers, positions
            self.charges = None

        def set_initial_charges(self, charges):
            self.charges = charges

    monkeypatch.setitem(sys.modules, 'ase', types.SimpleNamespace(
        Atoms=Atoms))
    _atoms._ase_atoms.cache_clear()
    try:
        for charges in (None, [0.5, -0.5]):
            a = _atoms.make_atoms([8, 1], [[0, 0, 0], [1.0, 0, 0]], charges)
            b = jax_make_atoms([8, 1], [[0, 0, 0], [1.0, 0, 0]], charges)
            assert type(a) is type(b) is Atoms
            assert vars(a) == vars(b)
    finally:
        monkeypatch.undo()
        _atoms._ase_atoms.cache_clear()
    assert type(_atoms.make_atoms([8], [[0, 0, 0]])) is _atoms.SimpleAtoms
