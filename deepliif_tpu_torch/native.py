"""Native (C++) host helpers of the quantifier, loaded via ctypes.

The port's copy of deepliif_tpu/native/__init__.py. ``csrc/postproc.cc`` is
compiled on first use with the system C++ compiler into the git-ignored
``_build/`` directory (keyed by a hash of the source, never beside it).
Callers check for ``None`` and fall back to the numpy/scipy code of
``postprocessing``, which stays the reference semantics; this is host
code, not a GPU kernel. The first call builds and loads under a lock, so
threads that call at once (the server's request threads) all get the
library once it is built, and ``None`` only when the build failed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, 'csrc', 'postproc.cc')
_BUILD_DIR = os.path.join(_PKG, '_build')
_FLAGS = ('-O3', '-shared', '-fPIC')
_lib = None
_tried = False
_lock = threading.Lock()


def _build(lib_path):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f'{lib_path}.tmp-{os.getpid()}-{threading.get_ident()}'
    for cc in ('c++', 'g++', 'clang++'):
        try:
            subprocess.run([cc, *_FLAGS, '-o', tmp, _SRC], check=True,
                           capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            continue
        os.replace(tmp, lib_path)
        return True
    return False


def _load():
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if not _tried:
            _load_locked()
    return _lib


def _load_locked():
    """Build (where needed) and load the library; sets ``_tried`` only once
    that has finished or failed, so a caller that finds it set finds
    ``_lib`` set too where the build worked."""
    global _lib, _tried
    try:
        with open(_SRC, 'rb') as f:
            h = hashlib.sha256(f.read() + ' '.join(_FLAGS).encode()).hexdigest()
        lib_path = os.path.join(_BUILD_DIR, f'libpostproc-{h[:16]}.so')
        if not os.path.exists(lib_path) and not _build(lib_path):
            return
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            return
        lib.moore_trace.restype = ctypes.c_int
        lib.moore_trace.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
        lib.label8.restype = ctypes.c_int
        lib.label8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    finally:
        _tried = True


def available():
    return _load() is not None


def moore_trace(mask, x, y):
    """Boundary trace; returns (bbox list, boundary list) like the Python
    get_cell_boundary, or None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    max_pts = 4 * (h + w) + 16
    while True:
        out = np.empty(max_pts * 2, np.int32)
        bbox = np.empty(4, np.int32)
        n = lib.moore_trace(
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, x, y,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_pts,
            bbox.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if n >= 0:
            pts = out[:2 * n].reshape(-1, 2)
            return ([(int(bbox[0]), int(bbox[1])), (int(bbox[2]), int(bbox[3]))],
                    [(int(a), int(b)) for a, b in pts])
        if max_pts > 16 * (h * w + 16):
            return None
        max_pts *= 4


def label8(mask):
    """8-connected labeling (raster first-pixel order); returns
    (labels int32 array, n) or None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    n = lib.label8(mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                   labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if n < 0:
        return None
    return labels, n
