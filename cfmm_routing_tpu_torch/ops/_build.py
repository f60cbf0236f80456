"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Builds happen
at first use (or through :func:`build`), all sources in parallel, into
``.torch_ext_build/`` beside the package sources.  A library's file name
carries a hash of its sources and flags, so an edited source is rebuilt.
A failed build raises: there is no fallback.

Every kernel wrapper adds one to its entry in :data:`LAUNCHES` where it
launches its kernel, so a run can show which kernels it went through (the
folded launches of the fused steps count under ``*_fold``, the merged
K-group launches under ``fused_step_merged``).  The grouped kernels launch
once per group of buckets with the same slot count: one launch of
``project``, ``project_delta``, ``fused_step``, ``fused_step_delta`` or
``classic_step`` (or the fused steps' ``*_fold`` forms) covers every bucket
of its group, geo-mean and constant-sum alike; ``classic_z`` ends a block
of classic steps once per group and ``consensus`` runs once a step.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = [
    "LAUNCHES", "reset_launch_counts", "build", "library", "check_launch",
    "BUILD_DIR", "NVCC_FLAGS",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / ".torch_ext_build"

# IEEE math throughout: no --use_fast_math; no FMA contraction either, so a
# kernel rounds every product and sum as the plain PyTorch version does.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
]

_C = ctypes.c_int
_P = ctypes.c_void_p
_D = ctypes.c_double
# library -> (source, {symbol: argtypes})
_LIBS = {
    "projection": (
        "projection.cu",
        {"cfmm_project": [_C, _C, _C, _P, _P, _C, _C, _P]},
    ),
    "projection_delta": (
        "projection_delta.cu",
        {"cfmm_project_delta": [_C, _C, _C, _P, _P, _C, _C, _P]},
    ),
    "fused_step": (
        "fused_step.cu",
        {"cfmm_fused_step": [_C] * 4 + [_D, _D] + [_P] * 3 + [_C, _C, _P],
         "cfmm_fused_step_merged": [_C] * 5 + [_D, _D] + [_P] * 3
                                   + [_C, _C, _P]},
    ),
    "fused_step_delta": (
        "fused_step_delta.cu",
        {"cfmm_fused_step_delta": [_C] * 4 + [_D, _D] + [_P] * 3
                                  + [_C, _C, _P]},
    ),
    "segment_sum": (
        "segment_sum.cu",
        {"cfmm_segment_sum": [_C] * 4 + [_P] * 6},
    ),
    "classic_step": (
        "classic_step.cu",
        {"cfmm_classic_step": [_C, _C, _C, _P, _P, _C, _C, _D, _D, _P, _P, _C,
                               _C, _P],
         "cfmm_classic_z": [_C, _C, _C] + [_P] * 4,
         "cfmm_consensus": [_C] * 3 + [_P] * 3},
    ),
}
_HEADERS = ("projection.cuh", "projection_delta.cuh")

LAUNCHES: Dict[str, int] = {"project": 0, "project_delta": 0,
                            "fused_step": 0, "fused_step_delta": 0,
                            "fused_step_fold": 0, "fused_step_delta_fold": 0,
                            "fused_step_merged": 0, "segment_sum": 0,
                            "classic_step": 0, "classic_z": 0, "consensus": 0}

_loaded: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from csrc/ at first "
            "use and need the CUDA toolkit"
        )
    return path


def _target(name: str) -> Path:
    src, _ = _LIBS[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (src,) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named libraries (all by default) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns the seconds
    each build took (0.0 for one found already built).  The compiler's
    output (``-Xptxas=-v``: registers, spills) is kept beside each library
    as ``<library>.log``."""
    names = list(_LIBS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {}
    for name in names:
        out = _target(name)
        if out.exists():
            times[name] = 0.0
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / _LIBS[name][0])]
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (
            subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
            log, tmp, out, time.perf_counter(),
        )
    failed = []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append((name, out.with_suffix(".log").read_text()[-4000:]))
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "CUDA kernel build failed:\n"
            + "\n".join(f"[{n}]\n{msg}" for n, msg in failed)
        )
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    out = _target(name)
    if not out.exists():
        build([name])
    lib = ctypes.CDLL(str(out))
    for sym, argtypes in _LIBS[name][1].items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check_launch(rc: int, what: str) -> None:
    """Raise if a C launcher reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
