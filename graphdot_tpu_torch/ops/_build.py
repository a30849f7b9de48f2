"""Builds the CUDA sources in ``csrc/`` with ``nvcc`` at first use and
loads them with ``ctypes``.

Each source compiles on its own into a shared library with a plain C
interface, under ``build/graphdot_tpu_torch/`` at the root of the checkout;
the file name carries a hash of the source, of every ``csrc/`` header it
includes (``#include "name.cuh"``, followed into headers too) and of the
flags, so an edited source or header builds anew and an unchanged one is
reused. :func:`build` starts
one ``nvcc`` a source, all at once, for the sources of :data:`KERNELS`. A
source generated at run time from a ``csrc/`` template (:func:`load_text`)
is written beside its library, both named by the hash of its text and the
flags. A failed build raises.
"""
import ctypes
import hashlib
import os
import re
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
    # the template instances of csrc/pcg_block.cuh optimize in parallel
    '--split-compile=0',
)

#: the kernel sources in ``csrc/``, by name
KERNELS = ('pcg_resident', 'pcg_stream', 'pcg_packed', 'pcg_cluster')

#: source name -> (ctypes.CDLL, {'seconds': build wall time until it was
#: collected, 'log': nvcc output})
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(src):
    """``src`` and the ``csrc/`` files it includes with quotes, directly or
    through other headers, each once, in the order first met."""
    found = [src]
    for path in found:
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = _CSRC / inc.decode()
            if dep not in found:
                found.append(dep)
    return found


def _target(name):
    """(source path, nvcc, library path) of ``csrc/<name>.cu``."""
    if name not in KERNELS:
        raise ValueError(f'unknown kernel source {name!r}; one of {KERNELS}')
    src = _CSRC / f'{name}.cu'
    nvcc = nvcc_path()
    digest = hashlib.sha256()
    for path in _sources(src):
        digest.update(path.name.encode() + b'\0' + path.read_bytes())
    digest.update('\0'.join((nvcc,) + NVCC_FLAGS).encode())
    return src, nvcc, _BUILD_DIR / f'{name}-{digest.hexdigest()[:16]}.so'


def build(*names):
    """Build (where needed) and load ``csrc/<name>.cu`` for every name, one
    ``nvcc`` process a source, all started together. A failed build stops
    the others and raises."""
    _build_all({name: _target(name) for name in names if name not in _LOADED})


def load_text(name, text):
    """Build (where needed) and load the CUDA source ``text``, generated
    from the template ``csrc/<name>.cu``; returns the CDLL. The source and
    the library are named ``<name>-<hash>`` by the hash of the text, the
    compiler and the flags, so one text builds once a checkout."""
    nvcc = nvcc_path()
    digest = hashlib.sha256(
        '\0'.join((name, text, nvcc) + NVCC_FLAGS).encode()).hexdigest()
    key = f'{name}-{digest[:16]}'
    if key not in _LOADED:
        src = _BUILD_DIR / f'{key}.cu'
        lib_path = _BUILD_DIR / f'{key}.so'
        if not lib_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = src.with_suffix(f'.{os.getpid()}.tmp')
            tmp.write_text(text)
            os.replace(tmp, src)
        _build_all({key: (src, nvcc, lib_path)})
    return _LOADED[key][0]


def _build_all(targets):
    """Build (where needed) and load each ``{key: (source, nvcc,
    library)}``, one ``nvcc`` process a source, all started together."""
    started = {}
    try:
        for name, (src, nvcc, lib_path) in targets.items():
            if lib_path.exists():
                started[name] = (None, lib_path, None, 0.0)
                continue
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f'.{os.getpid()}.tmp')
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            started[name] = (proc, lib_path, tmp, time.perf_counter())
        for name, (proc, lib_path, tmp, t0) in started.items():
            info = {'seconds': 0.0, 'log': ''}
            if proc is not None:
                log, _ = proc.communicate()
                info = {'seconds': time.perf_counter() - t0, 'log': log}
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f'nvcc failed to build {targets[name][0]} (exit '
                        f'{proc.returncode}):\n{log}')
                os.replace(tmp, lib_path)   # atomic: concurrent builds agree
            _LOADED[name] = (ctypes.CDLL(str(lib_path)), info)
    finally:
        for proc, _, tmp, _ in started.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)


def load(name):
    """Build (if needed) and load ``csrc/<name>.cu``; returns the CDLL."""
    build(name)
    return _LOADED[name][0]


def build_info(name):
    """{'seconds', 'log'} of the build that ``load(name)`` did in this
    process (seconds 0 and an empty log when the library was reused)."""
    return _LOADED[name][1]
