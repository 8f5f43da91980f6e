"""Build and bind the port's CUDA kernels.

The sources in ``repro_torch/csrc/*.cu`` have a plain C interface; the
ELL kernels (``spmv_ell``, ``jacobi``, ``agg_vote``) share the TMA-staged
row tiles of ``csrc/ell_tiles.cuh``, and they and ``embedding_bag`` the
bulk-copy primitives of ``csrc/bulk_copy.cuh``; ``embedding_bag`` and
``embedding_bag_backward`` share the row split of their wide-row paths
(``csrc/row_slabs.cuh``), and ``bag_grad_plan`` (its sorted ids) includes the CUDA
toolkit's CUB. On first use they are compiled for ``sm_90a``
with ``nvcc`` (one process per source, all started together, then one
link) into a shared library under
``<repo>/build/repro_torch_kernels/``, named by a hash of the sources and
flags, and loaded with ``ctypes``. Nothing here runs at import time: the
CPU tests import every module of the package on a machine without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch_kernels"
SOURCES = ("spmv_ell.cu", "jacobi.cu", "agg_vote.cu", "embedding_bag.cu",
           "embedding_bag_backward.cu", "bag_grad_plan.cu")
HEADERS = ("bulk_copy.cuh", "ell_tiles.cuh", "row_slabs.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_PL = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "repro_spmv_ell_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "repro_spmv_ell_block_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _P),
    "repro_jacobi_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P),
    "repro_jacobi_block_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                               _I, _I, _I, _I, _I, _P),
    "repro_agg_vote_i32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P),
    "repro_agg_vote_batched_i32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _P),
    "repro_embedding_bag_f32": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P),
    "repro_embedding_bag_rows_f32": (_P, _P, _P, _L, _I, _I, _I, _P),
    "repro_embedding_bag_backward_f32": (_P, _P, _P, _P, _P, _L, _L, _I, _I,
                                         _I, _I, _P),
    "repro_embedding_bag_backward_rows_f32": (_P, _P, _P, _P, _P, _L, _L,
                                              _I, _I, _I, _I, _I, _P),
    "repro_bag_grad_plan_i32": (_P, _L, _I, _I, _P, _P, _P, _P, _P, _PL,
                                _P),
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build() -> Path:
    """Compile the kernels (if this exact build is absent) and return the
    library's path. ``build_info`` records the seconds taken and the
    ptxas resource report of each source."""
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in (*srcs, *(CSRC / f for f in HEADERS)):
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"
    if lib.exists():
        build_info.update(seconds=0.0, cached=True)
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for s in srcs:
        obj = BUILD_DIR / f"{s.stem}-{os.getpid()}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {}
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        reports[s.name] = out
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s.name}:\n{out}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      ptxas=reports)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
