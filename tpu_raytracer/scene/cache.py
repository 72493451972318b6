"""Compiled-scene disk cache.

The reference rebuilds every BVH from OBJ text on every launch
(MeshPrimitive.cpp:14) — SURVEY.md §5 flags the absence of any
checkpoint/resume as a real gap. Here, ``compile_cached`` hashes the
scene's source data (triangles, instances, materials, builder params)
and memoizes the full compiled ``SceneArrays`` (BVH included) as an
npz next to a content hash, so repeat runs skip BVH construction.
"""

from __future__ import annotations

import hashlib
import os
import pathlib

import numpy as np

from .scene import Scene, SceneArrays

# TRT_SCENE_CACHE, else .cache/scenes inside the checkout (git-ignored)
DEFAULT_CACHE_DIR = os.environ.get(
    "TRT_SCENE_CACHE",
    str(pathlib.Path(__file__).resolve().parents[2] / ".cache" / "scenes"),
)


# Bump when SceneArrays' field set or compile semantics change, so old
# cache entries never alias a new-format scene.
_FORMAT_VERSION = b"scenearrays-v8-unpadded"


def scene_fingerprint(scene: Scene) -> str:
    """Content hash over everything that affects compile output:
    triangle data, the BUILT BVH of each mesh (which also pins the
    builder knobs — min_leaf_size, max_depth, builder choice — since
    they shape the tree), instances, materials, and a format version."""
    h = hashlib.sha256()
    h.update(_FORMAT_VERSION)
    for mesh in scene.meshes:
        for arr in (mesh.v0, mesh.v1, mesh.v2, mesh.normal,
                    mesh.uv0, mesh.uv1, mesh.uv2):
            h.update(np.ascontiguousarray(arr).tobytes())
        b = mesh.bvh
        for arr in (b.node_min, b.node_max, b.child_a, b.child_b,
                    b.leaf_start, b.leaf_count):
            h.update(np.ascontiguousarray(arr).tobytes())
    for inst in scene.mesh_instances:
        h.update(np.int64(inst.mesh_index).tobytes())
        h.update(np.int64(inst.material_index).tobytes())
        h.update(np.ascontiguousarray(inst.pose).tobytes())
        h.update(np.ascontiguousarray(inst.scale).tobytes())
    for m in scene.materials:
        h.update(np.asarray(
            [*m.albedo, m.roughness, m.metallic, m.illumination,
             m.reflectivity], np.float32).tobytes())
        if m.texture is not None:
            h.update(np.ascontiguousarray(m.texture).tobytes())
    if scene.sky_texture is not None:
        h.update(b"sky")
        h.update(np.ascontiguousarray(scene.sky_texture).tobytes())
    return h.hexdigest()[:24]


def compile_cached(scene: Scene, cache_dir: str | None = None) -> SceneArrays:
    """Scene.compile with a disk cache keyed on scene content."""
    cache_dir = pathlib.Path(cache_dir or DEFAULT_CACHE_DIR)
    cache_dir.mkdir(parents=True, exist_ok=True)
    fp = cache_dir / f"scene_{scene_fingerprint(scene)}.npz"
    if fp.exists():
        try:
            return SceneArrays.load(str(fp))
        except Exception:
            fp.unlink(missing_ok=True)
    arrays = scene.compile()
    arrays.save(str(fp))
    return arrays
