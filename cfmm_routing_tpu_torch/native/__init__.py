"""The native (C++) problem packer, built at first use and loaded through
ctypes.

``packer.cpp`` (``fill_bucket``, ``bucket_keys``) is compiled with
``g++ -O3 -shared -fPIC`` into the package's build directory
(``.torch_ext_build/``, beside the CUDA libraries of ``ops/_build.py``),
and rebuilt when the source is newer than the library.  Arrays cross as raw
pointers from numpy.  :func:`available` says whether the build succeeded;
``compile_table(backend="auto")`` takes this packer when it did and the
numpy packer otherwise, and ``backend="native"`` raises with the build's
error.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

__all__ = ["available", "fill_bucket", "bucket_keys"]

_SRC = Path(__file__).resolve().parent / "packer.cpp"
_SO = BUILD_DIR / "libpacker.so"
_lock = threading.Lock()
_lib = None
_error = None  # why the build or the load failed

_P64 = ctypes.POINTER(ctypes.c_double)
_P32 = ctypes.POINTER(ctypes.c_int32)
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PU8 = ctypes.POINTER(ctypes.c_uint8)


def _build_and_load():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        tmp = _SO.with_suffix(f".build{os.getpid()}.so")
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, _SO)
    lib = ctypes.CDLL(str(_SO))
    lib.fill_bucket.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        _P32, _P32, _PI64, _P32, _P64, _P64, _P64, _P64,
        _P64, _P64, _P64, _P64, _P64, _P32, _P64, _P64, _P64,
    ]
    lib.fill_bucket.restype = None
    lib.bucket_keys.argtypes = [ctypes.c_int64, _P32, _PU8, _PU8, _P32]
    lib.bucket_keys.restype = None
    return lib


def _try_load():
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _build_and_load()
            except (OSError, subprocess.CalledProcessError) as e:
                detail = getattr(e, "stderr", None) or str(e)
                _error = f"{type(e).__name__}: {detail}"
        return _lib


def available() -> bool:
    """Whether the packer built and loaded (built at the first call)."""
    return _try_load() is not None


def _load() -> ctypes.CDLL:
    """The loaded packer library; raises if ``g++`` could not build it."""
    lib = _try_load()
    if lib is None:
        raise RuntimeError(
            f"the native packer ({_SRC.name}) did not build with g++: {_error}"
        )
    return lib


def _ptr(a, ty):
    return a.ctypes.data_as(ty)


def fill_bucket(m, m_real, K, is_gm, rows, width, offset, assets, reserves,
                weights, shifts, fees, R, W, S, G, mask, asset_out, degree,
                logk0, k0) -> None:
    """Fill one bucket's padded arrays in place (``packer.cpp``'s contract:
    rows >= ``m_real`` and slots past a pool's width are inert padding;
    ``degree`` accumulates)."""
    _load().fill_bucket(
        m, m_real, K, is_gm,
        _ptr(rows, _P32), _ptr(width, _P32), _ptr(offset, _PI64),
        _ptr(assets, _P32), _ptr(reserves, _P64), _ptr(weights, _P64),
        _ptr(shifts, _P64), _ptr(fees, _P64),
        _ptr(R, _P64), _ptr(W, _P64), _ptr(S, _P64), _ptr(G, _P64),
        _ptr(mask, _P64), _ptr(asset_out, _P32), _ptr(degree, _P64),
        _ptr(logk0, _P64), _ptr(k0, _P64),
    )


def bucket_keys(width, kind, floor_flag) -> np.ndarray:
    """The (kind, K = max(2, next_pow2(width)), floor) key of every pool,
    packed as ``kind << 24 | K << 1 | floor``."""
    lib = _load()
    keys = np.empty(len(width), np.int32)
    lib.bucket_keys(
        len(width), _ptr(width, _P32), _ptr(kind, _PU8),
        _ptr(floor_flag, _PU8), _ptr(keys, _P32),
    )
    return keys
