"""Build and load the port's CUDA kernels (``textgcn_tpu_torch/csrc/*.cu``).

No JAX counterpart: the JAX package's Pallas kernels are compiled by XLA.

``nvcc`` compiles every source in ``csrc/`` (one process per source, all
started together; the shared headers ``csrc/*.cuh`` are included, and
hashed with every library) and links the objects into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), which
``ctypes`` loads. Tensors cross as raw device pointers and the launch goes on
PyTorch's current stream. The build runs at the first CUDA launch, into
``textgcn_tpu_torch/_build/`` (listed in ``.gitignore``). The library's file
name carries a hash of the sources and flags, so an edited kernel is rebuilt
and a stale library is never loaded. ``build(defines, srcs)`` builds a
variant beside it (``scripts/sweep_kernels.py`` sets a kernel's constants
with ``-D``), which :func:`open_library` loads; the port itself loads only
the default library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: (pointers..., scalars..., stream) -> cudaError_t as int
_SIGNATURES = {
    "textgcn_bsr_spmm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "textgcn_bsr_spmm_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "textgcn_bsr_spmm_f32_segment_tiles": [],
    "textgcn_bsr_spmm_segment_tiles": [],
    "textgcn_row_reduce": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "textgcn_row_reduce_run": [_P, _I, _I, _P, _P, _I, _P],
    "textgcn_row_reduce_segment_edges": [],
    "textgcn_attn_stats": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _I, _I, _I, _P],
    "textgcn_attn_agg": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "textgcn_sddmm": [_P, _P, _P, _P, _P, _I, _I, _P],
    "textgcn_rowsum": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}


class _Loaded:
    """The process's one loaded library, with how it was obtained."""

    lib = None
    build_seconds = None  # None when an existing library was reused
    log = ""  # nvcc's output (ptxas register and shared-memory report)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "textgcn_tpu_torch are built from csrc/ at first use"
    )


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path(defines=(), srcs=None) -> Path:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    # the shared headers (csrc/*.cuh) are part of every source
    for src in [*(srcs or sources()), *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtextgcn_kernels_{h.hexdigest()[:16]}.so"


def build(defines=(), srcs=None) -> Path:
    """Compile ``csrc/*.cu`` (or the paths ``srcs``) with the macros
    ``defines`` (``"NAME=VALUE"``) unless that library exists.

    Each source compiles to an object in its own ``nvcc`` process, all in
    parallel, and one ``nvcc -shared`` links them. The library is written
    to a temporary name and renamed, so a concurrent or interrupted build
    never leaves a half-written library under the final name.
    """
    path = library_path(defines, srcs)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs, procs = [], []
        for src in srcs or sources():
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, failed = [], []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(work, path.name)
        cmd = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    _Loaded.build_seconds = time.perf_counter() - t0
    _Loaded.log = "".join(logs)
    return path


def open_library(path) -> ctypes.CDLL:
    """Load a built library and declare the C entry points it has."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once per process."""
    if _Loaded.lib is None:
        _Loaded.lib = open_library(build())
    return _Loaded.lib


def build_info() -> dict:
    """Seconds the build took in this process (None if it reused a library)
    and nvcc's output."""
    return {"seconds": _Loaded.build_seconds, "log": _Loaded.log}


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
