"""ctypes binding to the native OBJ parser (native/obj_loader.cpp).

Same role split as the native BVH builder (accel/native.py): the .so
compiles on first use with native/Makefile into native/build/, the ABI is plain C via
ctypes (pybind11 is not in the image), and parse results are
BIT-IDENTICAL to the Python parser (scene/objloader.py parse_obj) —
tested — so the two are interchangeable. The native path exists for
Sponza-class OBJ files where per-token Python overhead dominates the
load (the reference's loader is C++, OBJLoader.hpp:12-181).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils.native import build_library

_lib = None
_lib_failed = False


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(build_library("libtrt_obj.so")))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.trt_obj_parse.restype = ctypes.c_void_p
        lib.trt_obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.trt_obj_counts.restype = None
        lib.trt_obj_counts.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
        ]
        lib.trt_obj_fill.restype = ctypes.c_int32
        lib.trt_obj_fill.argtypes = [
            ctypes.c_void_p, f32p, f32p, f32p, f32p, f32p, f32p, u8p,
        ]
        lib.trt_obj_free.restype = None
        lib.trt_obj_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib_failed = True
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def parse_obj_native(text: str):
    """Parse OBJ source with the C++ parser; same returns as
    objloader.parse_obj. Raises RuntimeError when the library is
    unavailable and ValueError on malformed input (where the Python
    parser would raise)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native OBJ parser unavailable")
    raw = text.encode("utf-8", errors="replace")
    handle = lib.trt_obj_parse(raw, len(raw))
    if not handle:
        raise ValueError("malformed OBJ input")
    try:
        n = ctypes.c_int64()
        lib.trt_obj_counts(handle, ctypes.byref(n))
        num = int(n.value)
        v0 = np.empty((num, 3), np.float32)
        v1 = np.empty((num, 3), np.float32)
        v2 = np.empty((num, 3), np.float32)
        uv0 = np.empty((num, 2), np.float32)
        uv1 = np.empty((num, 2), np.float32)
        uv2 = np.empty((num, 2), np.float32)
        has_uv = np.empty(num, np.uint8)
        if num and lib.trt_obj_fill(
            handle, v0, v1, v2, uv0, uv1, uv2, has_uv
        ) != 0:
            raise ValueError("OBJ face index out of range")
    finally:
        lib.trt_obj_free(handle)
    return v0, v1, v2, uv0, uv1, uv2, has_uv.astype(bool)
