"""ctypes loader for the native codec core (native/framecodec.cpp).

Always compiles the shared library from source (on first use, with g++)
into a gitignored build directory — no prebuilt binary is committed or
loaded, so the running code is exactly what's in the reviewed .cpp.
Every entry point has a numpy fallback with IDENTICAL semantics
(including int16 saturation) so the codec works, and produces the same
bytes, on machines without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_SRC = Path(__file__).resolve().parents[2] / "native" / "framecodec.cpp"
_BUILD_DIR = _SRC.parent / ".build"
_SO = _BUILD_DIR / "libframecodec.so"
_ABI = 2

_I16_MIN, _I16_MAX = -32768.0, 32767.0


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", str(_SO),
                     str(_SRC)],
                    check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(str(_SO))
            lib.delta_encode_i16.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_float]
            lib.delta_encode_i16.restype = ctypes.c_int64
            lib.delta_decode_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_float]
            lib.codec_abi_version.restype = ctypes.c_int
            if lib.codec_abi_version() != _ABI:
                return None
            _lib = lib
        except Exception as exc:  # no toolchain: numpy fallback
            if os.environ.get("SPATIALSIM_DEBUG"):
                print(f"[native] codec build failed: {exc}")
            _lib = None
        return _lib


def have_native() -> bool:
    return _load() is not None


def delta_encode(cur: np.ndarray, prev: np.ndarray, scale: float
                 ) -> Tuple[np.ndarray, int]:
    """Quantize (cur - prev) * scale to int16 (round-to-nearest,
    saturating).  Returns (deltas, saturated_count) — a nonzero count
    means the frame moved too far for the delta format and the caller
    must emit an absolute frame instead.
    """
    cur = np.ascontiguousarray(cur, np.float32)
    prev = np.ascontiguousarray(prev, np.float32)
    lib = _load()
    if lib is None:
        d = (cur - prev) * scale
        saturated = int(np.count_nonzero((d < _I16_MIN) | (d > _I16_MAX)))
        return (np.rint(np.clip(d, _I16_MIN, _I16_MAX)).astype(np.int16),
                saturated)
    out = np.empty(cur.shape, np.int16)
    saturated = lib.delta_encode_i16(cur.ctypes.data, prev.ctypes.data,
                                     out.ctypes.data, cur.size,
                                     ctypes.c_float(scale))
    return out, int(saturated)


def delta_decode(delta: np.ndarray, prev: np.ndarray, inv_scale: float
                 ) -> np.ndarray:
    """Reconstruct prev + delta * inv_scale as float32."""
    delta = np.ascontiguousarray(delta, np.int16)
    prev = np.ascontiguousarray(prev, np.float32)
    lib = _load()
    if lib is None:
        return (prev + delta.astype(np.float32) * inv_scale
                ).astype(np.float32)
    out = np.empty(prev.shape, np.float32)
    lib.delta_decode_f32(delta.ctypes.data, prev.ctypes.data,
                         out.ctypes.data, prev.size,
                         ctypes.c_float(inv_scale))
    return out
