"""MeshPrimitive: triangle soup + BVH, host side.

Counterpart of the reference's MeshPrimitive (MeshPrimitive.h:27-43,
MeshPrimitive.cpp:1-57): owns the triangle arrays and builds a BVH at
construction (``fill(1, 32)``, MeshPrimitive.cpp:54). Instead of the
reference's AoS TrianglePrimitive array, triangles live as SoA numpy
arrays, already REORDERED into BVH-leaf-contiguous order so the device
arrays slice densely at leaves (SURVEY.md §7 design delta 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..accel.bvh import MAX_BVH_DEPTH, BVHArrays, build_bvh
from ..core.vecmath import q_rsqrt

# BVH-build disk cache: keyed on triangle content + builder knobs + a
# builder-semantics version (bump when either builder's tree changes).
# Big builds dominate large-scene startup (the 1.28M-tri colonnade
# takes minutes); the reference rebuilds from OBJ every launch
# (MeshPrimitive.cpp:14) — this is the checkpoint-gap fix at mesh level.
_BVH_BUILDER_VERSION = b"bvh-v2-forcesplit512-depth48"


def _bvh_cache_dir() -> "str":
    """BVH build cache: ``TRT_BVH_CACHE`` or ``.cache/bvh`` in the
    checkout (git-ignored), so a run reads and writes nothing outside
    its tree."""
    import os

    return os.environ.get(
        "TRT_BVH_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".cache", "bvh"),
    )


def _cached_bvh_build(v0, v1, v2, max_depth, min_leaf_size, builder, num):
    import hashlib
    import os

    # sweep-SAH quality mode (accel/bvh.py build_bvh mode="sweep") is
    # the DEFAULT tree: strictly cheaper SAH (colonnade -37%) and
    # faster builds. Opt out with TRT_BVH_SWEEP=0 or builder="native" (reference-parity tree;
    # build_bvh mode="reference" stays the parity surface for tests).
    sweep = builder == "sweep" or (
        builder in ("auto", "numpy")
        and os.environ.get("TRT_BVH_SWEEP", "1") == "1"
    )
    # TRT_BVH_OPT=N: N rounds of reinsertion optimization on top of
    # the built tree (accel/optimize.py). Opt-in A/B knob: measured
    # SAH gain over the sweep tree is a few percent (the sweep is
    # already near the object-split optimum at leaf granularity).
    opt_rounds = int(os.environ.get("TRT_BVH_OPT", "0"))
    # TRT_BVH_PRESPLIT=<budget factor>: pre-split oversized triangles
    # into multiple clipped-box refs before the build
    # (accel/presplit.py). Opt-in; no-op on uniform meshes (area gate);
    # images bit-identical (same triangle records, different node
    # membership). Whether it pays on the GPU is not measured yet.
    presplit = float(os.environ.get("TRT_BVH_PRESPLIT", "0"))
    presplit_gate = float(os.environ.get("TRT_PRESPLIT_GATE", "16"))

    def build():
        bvh = _build_tree()
        if opt_rounds > 0:
            from ..accel.optimize import optimize_bvh

            bvh = optimize_bvh(bvh, rounds=opt_rounds, max_depth=max_depth)
        return bvh

    def _build_tree():
        if presplit > 0:
            from ..accel.presplit import presplit_refs

            refs = presplit_refs(
                v0, v1, v2, budget_factor=presplit,
                gate_mult=presplit_gate,
            )
            if refs is not None:  # None -> normal (native-capable) path
                return build_bvh(
                    v0, v1, v2, max_depth=max_depth,
                    min_leaf_size=min_leaf_size,
                    mode="sweep" if sweep else "reference", refs=refs,
                )
        if sweep:
            if builder != "numpy" and num >= 4096:
                from .. import accel

                if accel.native.native_available():
                    return accel.native.build_bvh_native(
                        v0, v1, v2, max_depth=max_depth,
                        min_leaf_size=min_leaf_size, mode="sweep",
                    )
            return build_bvh(
                v0, v1, v2, max_depth=max_depth,
                min_leaf_size=min_leaf_size, mode="sweep",
            )
        if builder != "numpy":
            from .. import accel

            use_native = builder == "native" or (
                builder == "auto" and num >= 4096
                and accel.native.native_available()
            )
            if use_native:
                return accel.native.build_bvh_native(
                    v0, v1, v2, max_depth=max_depth,
                    min_leaf_size=min_leaf_size,
                )
            if builder == "native":
                raise RuntimeError("native BVH builder unavailable")
        return build_bvh(
            v0, v1, v2, max_depth=max_depth, min_leaf_size=min_leaf_size
        )

    if num < 65536:  # small builds are faster than hashing + IO churn
        return build()
    h = hashlib.sha256()
    h.update(_BVH_BUILDER_VERSION)
    if sweep:  # extend the key only for the new mode: old entries stay valid
        h.update(b"sweep")
    if opt_rounds > 0:
        h.update(b"opt%d-v2" % opt_rounds)  # v2: both-subtree depth cap
    if presplit > 0:
        h.update(b"presplit%r-%r" % (presplit, presplit_gate))
    h.update(np.int64(max_depth).tobytes())
    h.update(np.int64(min_leaf_size).tobytes())
    for a in (v0, v1, v2):
        h.update(np.ascontiguousarray(a).tobytes())
    fp = os.path.join(_bvh_cache_dir(), f"bvh_{h.hexdigest()[:24]}.npz")
    if os.path.exists(fp):
        try:
            with np.load(fp) as data:
                return BVHArrays(**{k: data[k] for k in data.files})
        except Exception:
            os.unlink(fp)
    bvh = build()
    os.makedirs(os.path.dirname(fp), exist_ok=True)
    # write-to-tmp + atomic rename: a concurrent reader never sees a
    # partially written archive, and two writers can't interleave
    # keep the .npz suffix: np.savez appends it to other extensions
    tmp = fp[:-4] + f".tmp.{os.getpid()}.npz"
    try:
        np.savez_compressed(
            tmp, **{f.name: getattr(bvh, f.name)
                    for f in dataclasses.fields(bvh)}
        )
        os.replace(tmp, fp)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return bvh


def _normalize_host(v: np.ndarray, exact: bool) -> np.ndarray:
    sq = np.sum(v * v, axis=-1, keepdims=True).astype(np.float32)
    if exact:
        inv = 1.0 / np.sqrt(sq)
    else:  # reference host code normalizes with Q_rsqrt (utils.hpp:41-47)
        inv = np.asarray(q_rsqrt(sq))
    return (v * inv).astype(np.float32)


@dataclasses.dataclass
class MeshPrimitive:
    """Triangle mesh with per-vertex UVs, face normals, and a built BVH.

    All arrays are in BVH leaf order (``bvh.order`` already applied).
    """

    v0: np.ndarray  # [T, 3] f32
    v1: np.ndarray
    v2: np.ndarray
    normal: np.ndarray  # [T, 3] f32 face normals
    uv0: np.ndarray  # [T, 2] f32
    uv1: np.ndarray
    uv2: np.ndarray
    bvh: BVHArrays
    # Optional per-corner VERTEX normals for smooth shading (the
    # reference's disabled vn-averaging path, OBJLoader.hpp:119-135):
    # corner order matches (v0, v1, v2); vn_mask flags triangles whose
    # face carried complete vn indices (others shade flat).
    vn0: np.ndarray | None = None  # [T, 3] f32
    vn1: np.ndarray | None = None
    vn2: np.ndarray | None = None
    vn_mask: np.ndarray | None = None  # [T] bool

    @classmethod
    def from_triangles(
        cls,
        v0,
        v1,
        v2,
        normal=None,
        uv0=None,
        uv1=None,
        uv2=None,
        max_depth: int = MAX_BVH_DEPTH,
        exact_normals: bool = True,
        builder: str = "auto",
        min_leaf_size: int | None = None,
        vn0=None,
        vn1=None,
        vn2=None,
        vn_mask=None,
    ) -> "MeshPrimitive":
        """Build from raw triangle arrays; computes winding normals when
        none are given (TrianglePrimitive.hpp:15-23) and builds the BVH
        (MeshPrimitive.cpp:38-56).

        ``builder``: "auto" uses the native C++ builder for large
        meshes when available (identical trees), "native" forces it,
        "numpy" forces the Python path.

        ``min_leaf_size`` defaults to 16 (the reference splits to single
        triangles, BVHTree.hpp:214; pass 1 for that). Rendered images
        are identical either way; only traversal cost changes.

        ``max_depth`` may not exceed MAX_BVH_DEPTH: every traversal
        stack is sized from it."""
        if not 1 <= max_depth <= MAX_BVH_DEPTH:
            raise ValueError(
                f"max_depth must be in [1, {MAX_BVH_DEPTH}], got {max_depth}"
            )
        if min_leaf_size is None:
            # default 16; TRT_MIN_LEAF overrides for sweeps
            import os

            min_leaf_size = int(os.environ.get("TRT_MIN_LEAF", "16"))
        v0 = np.asarray(v0, np.float32).reshape(-1, 3)
        v1 = np.asarray(v1, np.float32).reshape(-1, 3)
        v2 = np.asarray(v2, np.float32).reshape(-1, 3)
        num = len(v0)
        if normal is None:
            normal = _normalize_host(np.cross(v1 - v0, v2 - v0), exact_normals)
        else:
            normal = np.asarray(normal, np.float32).reshape(-1, 3)
        zeros_uv = np.zeros((num, 2), np.float32)
        uv0 = zeros_uv if uv0 is None else np.asarray(uv0, np.float32).reshape(-1, 2)
        uv1 = zeros_uv if uv1 is None else np.asarray(uv1, np.float32).reshape(-1, 2)
        uv2 = zeros_uv if uv2 is None else np.asarray(uv2, np.float32).reshape(-1, 2)

        bvh = _cached_bvh_build(
            v0, v1, v2, max_depth, min_leaf_size, builder, num
        )
        p = bvh.order  # reorder into leaf-contiguous order
        kw = {}
        if vn0 is not None:
            kw = dict(
                vn0=np.asarray(vn0, np.float32).reshape(-1, 3)[p],
                vn1=np.asarray(vn1, np.float32).reshape(-1, 3)[p],
                vn2=np.asarray(vn2, np.float32).reshape(-1, 3)[p],
                vn_mask=np.asarray(vn_mask, bool).reshape(-1)[p],
            )
        return cls(
            v0=v0[p], v1=v1[p], v2=v2[p], normal=normal[p],
            uv0=uv0[p], uv1=uv1[p], uv2=uv2[p], bvh=bvh, **kw,
        )

    @property
    def num_triangles(self) -> int:
        return len(self.v0)

    def print_stats(self) -> None:
        """BVH diagnostics (BVHTree.hpp:117-172)."""
        s = self.bvh.stats()
        print("BVH Stats:")
        print(f"Number of nodes: {s['num_nodes']}")
        print(f"Max triangles per node: {s['max_triangles_per_leaf']}")
        print(f"Min triangles per node: {s['min_triangles_per_leaf']}")
        print(f"Max depth: {s['max_depth']}")
        print(f"Number of leaves: {s['num_leaves']}")
        print(f"Average triangles per leaf: {s['avg_triangles_per_leaf']}")
