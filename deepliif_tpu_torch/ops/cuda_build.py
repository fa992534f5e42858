"""Build and load the hand-written CUDA kernels.

Each library is compiled from ``deepliif_tpu_torch/csrc`` with nvcc for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ctypes. The build runs at first use, goes into
``deepliif_tpu_torch/_build/`` (git-ignored) and is keyed by a hash of the
sources, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and an unchanged one is reused. ``build`` starts one nvcc
per library, all at once. A missing nvcc or a failed build raises: there is
no fallback. ``build`` holds a process-wide lock, so threads that ask for
the same library at once (the server's request threads) build and load it
once; each temporary file carries the pid and the thread id.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_loaded = {}
build_seconds = {}
_lock = threading.Lock()


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


def _lib_path(name, sources):
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in [os.path.join(CSRC, s) for s in sources] + sorted(
            glob.glob(os.path.join(CSRC, '*.cuh'))):
        with open(p, 'rb') as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f'lib{name}-{h.hexdigest()[:16]}.so')


def build(libs):
    """Compile the libraries ``libs`` ({name: [source file names under
    csrc/]}) that are not built yet, one nvcc process each, all started
    together; returns {name: ctypes handle}. Thread-safe: a second caller
    waits for the first one's build and gets its handles."""
    with _lock:
        return _build_locked(libs)


def _build_locked(libs):
    todo = {name: srcs for name, srcs in libs.items() if name not in _loaded}
    procs = {}
    try:
        for name, srcs in todo.items():
            path = _lib_path(name, srcs)
            if os.path.exists(path):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f'{path}.tmp-{os.getpid()}-{threading.get_ident()}'
            cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp,
                   *[os.path.join(CSRC, s) for s in srcs]]
            procs[name] = (path, tmp, time.perf_counter(),
                           subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))
        for name, (path, tmp, t0, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed building {name}:\n{out}\n{err}')
            os.replace(tmp, path)
            build_seconds[name] = time.perf_counter() - t0
    finally:
        for _, _, _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, srcs in todo.items():
        _loaded[name] = ctypes.CDLL(_lib_path(name, srcs))
    return {name: _loaded[name] for name in libs}


_count_lock = threading.Lock()


def count(fn, attr='launches'):
    """Add one to the counter ``attr`` of a kernel wrapper ``fn`` (its
    launches, or its input relayouts) under a lock: a session's replicas
    launch from one host thread per card, and ``fn.launches += 1`` is a
    read and a write that two threads can interleave."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)


def load(name, sources):
    """ctypes handle of library ``name`` built from ``sources`` (file names
    under csrc/). Builds once per process and per source hash."""
    return build({name: sources})[name]
