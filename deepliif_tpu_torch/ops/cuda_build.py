"""Build and load the hand-written CUDA kernels.

Each library is compiled from ``deepliif_tpu_torch/csrc`` with nvcc for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ctypes. The build runs at first use, goes into
``deepliif_tpu_torch/_build/`` (git-ignored) and is keyed by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused. A missing nvcc or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_loaded = {}
build_seconds = {}


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin): the CUDA '
                       'kernels of deepliif_tpu_torch are built from source '
                       'at first use')


def load(name, sources):
    """ctypes handle of library ``name`` built from ``sources`` (file names
    under csrc/). Builds once per process and per source hash."""
    if name in _loaded:
        return _loaded[name]
    paths = [os.path.join(CSRC, s) for s in sources]
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, 'rb') as f:
            h.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f'lib{name}-{h.hexdigest()[:16]}.so')
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{lib_path}.tmp-{os.getpid()}'
        t0 = time.perf_counter()
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, *paths],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc failed building {name}:\n'
                               f'{res.stdout}\n{res.stderr}')
        os.replace(tmp, lib_path)
        build_seconds[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(lib_path)
    _loaded[name] = lib
    return lib
