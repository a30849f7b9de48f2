"""Builds the CUDA sources in ``csrc/`` with ``nvcc`` at first use and
loads them with ``ctypes``.

Each source compiles on its own into a shared library with a plain C
interface, under ``build/graphdot_tpu_torch/`` at the root of the checkout;
the file name carries a hash of the source and the flags, so an edited
source builds anew and an unchanged one is reused. A failed build raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / 'csrc'
_BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / \
    'graphdot_tpu_torch'
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

#: source name -> (ctypes.CDLL, {'seconds': build time, 'log': nvcc output})
_LOADED = {}


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get('CUDA_HOME')
    candidates = [Path(home) / 'bin' / 'nvcc'] if home else []
    on_path = shutil.which('nvcc')
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        'nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA '
        'kernels of graphdot_tpu_torch are built from source at first use')


def load(name):
    """Build (if needed) and load ``csrc/<name>.cu``; returns the CDLL."""
    if name in _LOADED:
        return _LOADED[name][0]
    src = _CSRC / f'{name}.cu'
    nvcc = nvcc_path()
    key = hashlib.sha256(
        src.read_bytes() + '\0'.join((nvcc,) + NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = _BUILD_DIR / f'{name}-{key}.so'
    info = {'seconds': 0.0, 'log': ''}
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f'.{os.getpid()}.tmp')
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(src)],
            capture_output=True, text=True)
        info['seconds'] = time.perf_counter() - t0
        info['log'] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f'nvcc failed to build {src} (exit {proc.returncode}):\n'
                f'{info["log"]}')
        os.replace(tmp, lib_path)   # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = (lib, info)
    return lib


def build_info(name):
    """{'seconds', 'log'} of the build that ``load(name)`` did in this
    process (seconds 0 and an empty log when the library was reused)."""
    return _LOADED[name][1]
