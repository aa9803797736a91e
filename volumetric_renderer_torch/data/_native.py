"""ctypes binding to the native decode library (``native/volio.c``).

Loads ``native/libvolio.so``, building it on first use if a C compiler is
available; falls back to NumPy transparently.  The exposed operation is the
reference's import hot path — widen any NRRD scalar type to float32 and scan
min/max (``src/data/nrrd_file_parser.cpp:38-77``) — done in one pass in C.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DTYPE_CODES = {
    "int8": 0, "uint8": 1, "int16": 2, "uint16": 3,
    "int32": 4, "uint32": 5, "int64": 6, "uint64": 7,
    "float32": 8, "float64": 9,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _native_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
    )


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = os.path.join(_native_dir(), "libvolio.so")
        if not os.path.exists(so):
            try:
                subprocess.run(
                    ["make", "-C", _native_dir()],
                    check=True, capture_output=True, timeout=120,
                )
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(so)
            lib.vio_widen_f32_minmax.restype = ctypes.c_int
            lib.vio_widen_f32_minmax.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.vio_minmax_f32.restype = None
            lib.vio_minmax_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ]
            if hasattr(lib, "vio_parse_csv"):
                lib.vio_parse_csv.restype = ctypes.c_long
                lib.vio_parse_csv.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                    ctypes.c_size_t, ctypes.POINTER(ctypes.c_long),
                ]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def have_native() -> bool:
    return _load() is not None


def widen_to_f32_minmax(arr: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """Widen ``arr`` (any supported scalar dtype, any byte order) to a flat
    float32 array plus its (min, max)."""
    arr = np.ascontiguousarray(arr)
    name = arr.dtype.name
    lib = _load()
    if lib is not None and name in _DTYPE_CODES and arr.size > 0:
        # numpy reports '=' or '<' on little-endian hosts; '>' needs a swap
        swap = 1 if arr.dtype.byteorder == ">" else 0
        out = np.empty(arr.size, dtype=np.float32)
        mm = np.empty(2, dtype=np.float32)
        rc = lib.vio_widen_f32_minmax(
            arr.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
            arr.size, _DTYPE_CODES[name], swap,
            mm.ctypes.data_as(ctypes.c_void_p),
        )
        if rc == 0:
            return out, float(mm[0]), float(mm[1])
    # NumPy fallback
    out = arr.astype(np.float32).reshape(-1)
    if out.size == 0:
        return out, 0.0, 0.0
    return out, float(out.min()), float(out.max())


def minmax_f32(arr: np.ndarray) -> Tuple[float, float]:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    lib = _load()
    if lib is not None and arr.size > 0:
        mm = np.empty(2, dtype=np.float32)
        lib.vio_minmax_f32(
            arr.ctypes.data_as(ctypes.c_void_p), arr.size,
            mm.ctypes.data_as(ctypes.c_void_p),
        )
        return float(mm[0]), float(mm[1])
    if arr.size == 0:
        return 0.0, 0.0
    return float(arr.min()), float(arr.max())


def parse_csv(text: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """Parse a CSV buffer of comma-separated floats via the C fast path.

    Returns ``(flat_values_f32, n_cols)``, or ``None`` when the native
    library is unavailable or lacks the symbol (caller falls back to the
    Python parser).  Raises ``ValueError`` on a malformed or ragged row —
    the same failure the reference surfaces as "Inconsistant dimensions"
    (``csv_file_parser.cpp:37,43``).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "vio_parse_csv"):
        return None
    # upper bound on value count: one value per 1-2 bytes is impossible;
    # a comma-separated float needs >= 2 chars, use len/2 + 1
    cap = len(text) // 2 + 2
    out = np.empty(cap, dtype=np.float32)
    cols = ctypes.c_long(0)
    rc = lib.vio_parse_csv(text, len(text),
                           out.ctypes.data_as(ctypes.c_void_p), cap,
                           ctypes.byref(cols))
    if rc < 0:
        raise ValueError(f"malformed CSV at line {-rc}")
    return out[:rc].copy(), int(cols.value)
