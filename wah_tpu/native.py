"""ctypes bindings for the native C++ host codec (csrc/wah_core.cpp).

The reference's host layer is C++ (compress.cu/decompress.cu); this is
this package's native host runtime: a fast CPU WAH codec for stream
validation, differential testing against the device kernels, and a
no-device fallback. Builds on first use (g++ -O3) into
csrc/libwah_core.so; `available()` reports whether the toolchain
succeeded, so pure-Python environments degrade gracefully.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = [
    "available",
    "encode",
    "decode",
    "decoded_chunks",
    "validate",
    "chunk_count",
]

_SRC = os.path.join(os.path.dirname(__file__), "..", "csrc", "wah_core.cpp")
_LIB = os.path.join(os.path.dirname(__file__), "..", "csrc", "libwah_core.so")
_lock = threading.Lock()
_lib = None
_tried = False

_u32p = ctypes.POINTER(ctypes.c_uint32)


def _build() -> bool:
    src = os.path.abspath(_SRC)
    lib = os.path.abspath(_LIB)
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return True
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", lib, src],
            check=True,
            capture_output=True,
        )
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _get():
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            if _build():
                lib = ctypes.CDLL(os.path.abspath(_LIB))
                lib.wah_chunk_count.restype = ctypes.c_int64
                lib.wah_chunk_count.argtypes = [ctypes.c_int64]
                lib.wah_encode.restype = ctypes.c_int64
                lib.wah_encode.argtypes = [_u32p, ctypes.c_int64, _u32p]
                lib.wah_decoded_chunks.restype = ctypes.c_int64
                lib.wah_decoded_chunks.argtypes = [_u32p, ctypes.c_int64]
                lib.wah_decode.restype = ctypes.c_int64
                lib.wah_decode.argtypes = [
                    _u32p, ctypes.c_int64, _u32p, ctypes.c_int64,
                ]
                lib.wah_validate.restype = ctypes.c_int32
                lib.wah_validate.argtypes = [_u32p, ctypes.c_int64]
                _lib = lib
        return _lib


def available() -> bool:
    return _get() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u32p)


def chunk_count(n_ints: int) -> int:
    return int(_get().wah_chunk_count(n_ints))


def encode(ints: np.ndarray) -> np.ndarray:
    """Compress a uint32 bitmap -> WAH stream (native CPU path)."""
    ints = np.ascontiguousarray(ints, dtype=np.uint32)
    lib = _get()
    cap = int(lib.wah_chunk_count(ints.shape[0]))
    out = np.empty(max(cap, 1), dtype=np.uint32)
    n = int(lib.wah_encode(_ptr(ints), ints.shape[0], _ptr(out)))
    return out[:n].copy()


def decoded_chunks(words: np.ndarray) -> int:
    words = np.ascontiguousarray(words, dtype=np.uint32)
    n = int(_get().wah_decoded_chunks(_ptr(words), words.shape[0]))
    if n < 0:
        raise ValueError("invalid WAH stream: zero-length fill")
    return n


def decode(words: np.ndarray, out_ints: int | None = None) -> np.ndarray:
    """Decompress a WAH stream -> uint32 bitmap (native CPU path)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    lib = _get()
    nc = decoded_chunks(words)
    full = (31 * nc + 31) // 32
    cap = full if out_ints is None else out_ints
    out = np.empty(max(cap, 1), dtype=np.uint32)
    n = int(lib.wah_decode(_ptr(words), words.shape[0], _ptr(out), cap))
    if n < 0:
        raise ValueError("invalid WAH stream")
    return out[:cap] if out_ints is not None else out[:n]


def validate(words: np.ndarray) -> None:
    """Raise ValueError on format violations (native fast path of
    api.validate_stream)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    rc = int(_get().wah_validate(_ptr(words), words.shape[0]))
    if rc == 1:
        raise ValueError("invalid WAH stream: contains literal-fill word")
    if rc == 2:
        raise ValueError("invalid WAH stream: fill length out of range")
