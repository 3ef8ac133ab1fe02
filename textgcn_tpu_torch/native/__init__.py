"""ctypes binding of the native graph core (``graphcore.cpp`` beside this file).

Port of ``textgcn_tpu/native/``: the host's hot loops of graph preparation
in C++ (``parse_edgelist``, ``coalesce``, ``sym_normalize``,
``window_cooccurrence``), with the JAX binding's signatures. The source is the
port's own copy; it differs from the JAX package's in one point, stated in its
header: ``window_cooccurrence`` returns its pairs sorted by (i, j).

The library is built with the C++ compiler (``$CXX``, else ``g++``) at first
use, into ``textgcn_tpu_torch/_build/`` (listed in ``.gitignore``), under a
name that carries a hash of the compiler, the flags and the source, so an
edited source is rebuilt and a stale library is never loaded. The build
writes to a temporary name and renames it, so processes that build at the
same time never load a half-written file. There is no ``-march=native``: the
build directory may be shared between hosts of different CPUs.

:func:`available` is False only when no compiler is on ``PATH``; the callers
(``graph/build_topic.read_weighted_edgelist``,
``train/prepare.normalize_edges``, ``graph/build_textgcn.word_word_pmi``) then
take their numpy path, and each logs once which path it took. With a
compiler, a failed build raises with the compiler's output, and so does a
failed call: nothing falls back in silence.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "graphcore.cpp"
BUILD_DIR = SRC.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_log = logging.getLogger(__name__)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX") or "g++")


def available() -> bool:
    """True when a C++ compiler is on ``PATH``: the native core is then built
    (or reused) at first use, and a failure to build raises."""
    return _compiler() is not None


@functools.lru_cache(maxsize=None)
def log_path(caller: str, native: bool) -> None:
    """Log, once per process for each caller and path, which path it took."""
    if native:
        _log.info("%s: native graph core (%s)", caller, SRC.name)
    else:
        _log.warning("%s: numpy path (the native graph core needs a C++ compiler on PATH)", caller)


def library_path(cxx: str) -> Path:
    h = hashlib.sha256(" ".join((os.path.basename(cxx), *CXX_FLAGS)).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libgraphcore_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile :data:`SRC` into :data:`BUILD_DIR` unless that library exists;
    returns its path. Raises if there is no compiler or it fails."""
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler on PATH ($CXX or g++) for the native graph core")
    path = library_path(cxx)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = os.path.join(work, path.name)
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native graph core failed ({proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The library, built on first use and loaded once per process, with
    the JAX binding's prototypes."""
    lib = ctypes.CDLL(str(build()))
    lib.tg_parse_edgelist.restype = ctypes.c_void_p
    lib.tg_parse_edgelist.argtypes = [ctypes.c_char_p, _I64P]
    lib.tg_copy_edges.restype = None
    lib.tg_copy_edges.argtypes = [ctypes.c_void_p, _I64P, _I64P, _F64P]
    lib.tg_free.restype = None
    lib.tg_free.argtypes = [ctypes.c_void_p]
    lib.tg_coalesce.restype = ctypes.c_void_p
    lib.tg_coalesce.argtypes = [
        _I64P, _I64P, _F64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _I64P,
    ]
    lib.tg_sym_normalize.restype = ctypes.c_void_p
    lib.tg_sym_normalize.argtypes = [
        _I64P, _I64P, _F64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _I64P,
    ]
    lib.tg_window_cooccurrence.restype = ctypes.c_void_p
    lib.tg_window_cooccurrence.argtypes = [
        _I32P, _I64P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _I64P, _I64P, _I64P,
    ]
    return lib


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(t)


def _take(lib, handle, n: int, what: str):
    """Copy a result handle's ``n`` edges out and free it."""
    if not handle:
        raise RuntimeError(f"native {what} returned no result")
    rows = np.empty(n, dtype=np.int64)
    cols = np.empty(n, dtype=np.int64)
    vals = np.empty(n, dtype=np.float64)
    try:
        lib.tg_copy_edges(handle, _ptr(rows, _I64P), _ptr(cols, _I64P), _ptr(vals, _F64P))
    finally:
        lib.tg_free(handle)
    return rows, cols, vals


def _coo(rows, cols, vals, n_nodes: int):
    """Contiguous int64 / float64 copies of a COO, checked: equal lengths and
    every index in [0, n_nodes) (the C++ indexes per-node arrays with them)."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    if not (rows.ndim == cols.ndim == vals.ndim == 1 and len(rows) == len(cols) == len(vals)):
        raise ValueError(f"COO arrays of shapes {rows.shape}, {cols.shape}, {vals.shape}")
    if len(rows) and (min(rows.min(), cols.min()) < 0 or max(rows.max(), cols.max()) >= n_nodes):
        raise ValueError(f"a COO index falls outside [0, {n_nodes})")
    return rows, cols, vals


def parse_edgelist(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """"u v [w]" lines into (rows, cols, weights); a line without a weight
    gets 1, and a line whose u or v is not an integer is skipped."""
    lib = _library()
    n = ctypes.c_int64(0)
    handle = lib.tg_parse_edgelist(os.fsencode(path), ctypes.byref(n))
    if not handle:
        raise FileNotFoundError(path)
    return _take(lib, handle, n.value, "parse_edgelist")


def coalesce(
    rows, cols, vals, n_nodes: int, reduce: str = "sum", symmetrize: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge duplicate (row, col) entries by ``reduce`` (``sum`` or ``max``),
    after adding the transpose when ``symmetrize``; sorted by (row, col)."""
    if reduce not in ("sum", "max"):
        raise ValueError(f"unknown reduce: {reduce}")
    lib = _library()
    rows, cols, vals = _coo(rows, cols, vals, n_nodes)
    n_out = ctypes.c_int64(0)
    handle = lib.tg_coalesce(
        _ptr(rows, _I64P), _ptr(cols, _I64P), _ptr(vals, _F64P), len(rows), n_nodes,
        1 if reduce == "max" else 0, 1 if symmetrize else 0, ctypes.byref(n_out),
    )
    return _take(lib, handle, n_out.value, "coalesce")


def sym_normalize(
    rows, cols, vals, n_nodes: int, add_self_loops: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """D̃^{-1/2} (A + I) D̃^{-1/2} of a coalesced COO. Self-loops merge into
    existing diagonal entries; missing ones are appended after the edges."""
    lib = _library()
    rows, cols, vals = _coo(rows, cols, vals, n_nodes)
    n_out = ctypes.c_int64(0)
    handle = lib.tg_sym_normalize(
        _ptr(rows, _I64P), _ptr(cols, _I64P), _ptr(vals, _F64P), len(rows), n_nodes,
        1 if add_self_loops else 0, ctypes.byref(n_out),
    )
    return _take(lib, handle, n_out.value, "sym_normalize")


def window_cooccurrence(
    tokens: np.ndarray, offsets: np.ndarray, vocab: int, window: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Returns (i, j, count, occ, n_windows): for every pair i < j the number
    of sliding windows (width ``window``; a document no longer than it is one
    window) holding both, sorted by (i, j); ``occ[v]`` the windows holding
    word v."""
    lib = _library()
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if window < 1:
        raise ValueError(f"window {window} < 1")
    if offsets.ndim != 1 or len(offsets) < 1 or offsets[0] < 0 or offsets[-1] > len(tokens) \
            or np.any(np.diff(offsets) < 0):
        raise ValueError("offsets must rise from >= 0 to at most len(tokens)")
    if len(tokens) and (tokens.min() < 0 or tokens.max() >= vocab):
        raise ValueError(f"a token falls outside [0, {vocab})")
    occ = np.zeros(vocab, dtype=np.int64)
    n_windows = ctypes.c_int64(0)
    n_out = ctypes.c_int64(0)
    handle = lib.tg_window_cooccurrence(
        _ptr(tokens, _I32P), _ptr(offsets, _I64P), len(offsets) - 1, vocab, window,
        _ptr(occ, _I64P), ctypes.byref(n_windows), ctypes.byref(n_out),
    )
    i, j, cnt = _take(lib, handle, n_out.value, "window_cooccurrence")
    return i, j, cnt, occ, n_windows.value
