"""ctypes binding to the native C++ BVH builder (native/bvh_builder.cpp).

The builder .so is compiled on first use with native/Makefile into
native/build/ (g++ is part of the toolchain; pybind11 is not, so the
ABI is plain C via ctypes). Construction semantics are bit-identical to the numpy builder
(accel/bvh.py) — tested — so the two are interchangeable; the native
path exists for Sponza-class meshes (250k+ triangles) where per-node
Python overhead dominates the build (SURVEY.md §7 hard part 5).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils.native import build_library
from .bvh import BVHArrays

_lib = None
_lib_failed = False


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(build_library("libtrt_bvh.so")))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.trt_build_bvh.restype = ctypes.c_int32
        lib.trt_build_bvh.argtypes = [
            f32p, f32p, f32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            f32p, f32p, i32p, i32p, i32p, i32p, i32p,
        ]
        lib.trt_build_bvh_sweep.restype = ctypes.c_int32
        lib.trt_build_bvh_sweep.argtypes = [
            f32p, f32p, f32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            f32p, f32p, i32p, i32p, i32p, i32p, i32p,
        ]
        _lib = lib
    except Exception:
        _lib_failed = True
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def build_bvh_native(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    max_depth: int = 48,
    tests_per_axis: int = 5,
    min_leaf_size: int = 1,
    mode: str = "reference",
) -> BVHArrays:
    """Build a BVH with the C++ builder. Raises RuntimeError when the
    native library is unavailable (callers fall back to numpy).
    ``mode="sweep"`` selects the exact-SAH sweep (bit-identical to
    accel/bvh.py build_bvh(mode="sweep"))."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native BVH builder unavailable")
    v0 = np.ascontiguousarray(v0, np.float32).reshape(-1, 3)
    v1 = np.ascontiguousarray(v1, np.float32).reshape(-1, 3)
    v2 = np.ascontiguousarray(v2, np.float32).reshape(-1, 3)
    t = len(v0)
    cap = max(2 * t - 1, 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    child_a = np.empty(cap, np.int32)
    child_b = np.empty(cap, np.int32)
    leaf_start = np.empty(cap, np.int32)
    leaf_count = np.empty(cap, np.int32)
    order = np.empty(max(t, 1), np.int32)
    if mode == "sweep":
        n = lib.trt_build_bvh_sweep(
            v0.reshape(-1), v1.reshape(-1), v2.reshape(-1),
            t, max_depth, min_leaf_size,
            node_min.reshape(-1), node_max.reshape(-1),
            child_a, child_b, leaf_start, leaf_count, order,
        )
    else:
        n = lib.trt_build_bvh(
            v0.reshape(-1), v1.reshape(-1), v2.reshape(-1),
            t, max_depth, tests_per_axis, min_leaf_size,
            node_min.reshape(-1), node_max.reshape(-1),
            child_a, child_b, leaf_start, leaf_count, order,
        )
    return BVHArrays(
        node_min=node_min[:n].copy(),
        node_max=node_max[:n].copy(),
        child_a=child_a[:n].copy(),
        child_b=child_b[:n].copy(),
        leaf_start=leaf_start[:n].copy(),
        leaf_count=leaf_count[:n].copy(),
        order=order[:t].copy(),
    )
