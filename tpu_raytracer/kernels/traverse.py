"""Per-ray BVH traversal kernel, called through ``jax.ffi``.

One thread per ray with a private stack, every instance looped inside
the thread: the reference's own GPU design (raycast.cu:21-142). The
traversal lives in ``native/traverse.h`` as ``__host__ __device__`` code
and is built twice from it:

  * ``libtrt_traverse_cuda.so`` (nvcc, sm_90a) — the CUDA target, the
    only one a GPU computation can select;
  * ``libtrt_traverse_cpu.so`` (g++) — the same code as a CPU target, so
    the CPU tests run the kernel's own arithmetic against the oracle.

Each library is built from the committed sources on first use
(utils/native.py); a failed build raises — there is no fallback to the
XLA walk. This module packs the scene into the kernel's tables
(documented in traverse.h) inside the caller's jit, flattens the rays,
and returns the same ``Hit`` record as every other backend, with the
accepted triangle's barycentric ``u``/``v`` and face normal ``n`` when
``want_normals`` is set.
"""

from __future__ import annotations

import ctypes
import math
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..core import transforms as T
from ..render.intersect import barycentric_rows
from ..scene.scene import SceneArrays
from ..utils.native import build_library

TARGET = "trt_traverse"
ANY_HIT = 1      # traverse.h kAnyHit
WANT_ATTRS = 2   # traverse.h kWantAttrs

# jax platform -> (library, handler symbol, XLA platform name)
_LIBRARIES = {
    "gpu": ("libtrt_traverse_cuda.so", "TrtTraverseCuda", "CUDA"),
    "cpu": ("libtrt_traverse_cpu.so", "TrtTraverseCpu", "cpu"),
}
_loaded: dict[str, dict] = {}


def prepare(platform: str | None = None) -> dict:
    """Build (if needed) and register the traversal target for
    ``platform`` (default: JAX's default backend). Idempotent. Returns
    ``{"platform", "library", "build_s"}``; build_s is the time this
    process spent building and loading the library."""
    platform = platform or jax.default_backend()
    if platform in _loaded:
        return _loaded[platform]["info"]
    if platform not in _LIBRARIES:
        raise RuntimeError(
            f"the traversal kernel has no build for platform {platform!r}"
        )
    lib_name, symbol, xla_platform = _LIBRARIES[platform]
    t0 = time.perf_counter()
    path = build_library(lib_name)
    lib = ctypes.CDLL(str(path))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(getattr(lib, symbol)), platform=xla_platform
    )
    info = {"platform": platform, "library": str(path),
            "build_s": time.perf_counter() - t0}
    _loaded[platform] = {"lib": lib, "info": info}
    return info


def pack_nodes(scene: SceneArrays) -> jax.Array:
    """[N, 16] int32 node records: each internal node carries its two
    children's boxes (as float bits) and indices; a leaf carries
    -(first triangle) - 1 and its triangle count."""
    ca, cb = scene.node_child_a, scene.node_child_b
    internal = ca >= 0
    ia, ib = jnp.maximum(ca, 0), jnp.maximum(cb, 0)
    bits = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
    col = lambda x: x[:, None]
    zero = jnp.zeros_like(ca)
    return jnp.concatenate([
        bits(scene.node_min[ia]),
        col(jnp.where(internal, ca, -scene.node_leaf_start - 1)),
        bits(scene.node_max[ia]),
        col(jnp.where(internal, cb, scene.node_leaf_count)),
        bits(scene.node_min[ib]), col(zero),
        bits(scene.node_max[ib]), col(zero),
    ], axis=1)


def pack_triangles(scene: SceneArrays) -> jax.Array:
    """[T, 12] f32 triangle records: v0, face normal and the affine
    barycentric rows rA, rB the oracle uses (intersect.barycentric_rows)."""
    ra, rb = barycentric_rows(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    return jnp.concatenate([scene.tri_v0, scene.tri_normal, ra, rb], axis=1)


def pack_instances(scene: SceneArrays) -> tuple[jax.Array, jax.Array]:
    """([I, 10] f32 quaternion | pose xyz | inverse scale, [I] root)."""
    q = T.euler2quat(scene.inst_pose[:, 3:6])
    rec = jnp.concatenate(
        [q, scene.inst_pose[:, 0:3], scene.inst_inv_scale], axis=1
    )
    return rec, scene.mesh_root[scene.inst_mesh]


def cast_rays_kernel(scene: SceneArrays, origin, directions, *,
                     want_normals: bool = False, any_hit: bool = False):
    """Nearest hit (or, with ``any_hit``, the first accepted hit — all a
    boolean shadow query needs) of every ray. ``origin`` broadcasts
    against ``directions`` ([..., 3] each)."""
    from ..render.renderer import Hit

    prepare()
    directions = jnp.asarray(directions, jnp.float32)
    origin = jnp.broadcast_to(jnp.asarray(origin, jnp.float32),
                              directions.shape)
    shape = directions.shape[:-1]
    n = math.prod(shape)
    na = n if want_normals else 0
    mode = (ANY_HIT if any_hit else 0) | (WANT_ATTRS if want_normals else 0)
    f32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)
    inst, roots = pack_instances(scene)
    t, tri, hit_inst, u, v, nrm = jax.ffi.ffi_call(
        TARGET,
        (f32(n), i32(n), i32(n), f32(na), f32(na), f32(na, 3)),
        vmap_method="sequential",
    )(
        pack_nodes(scene), pack_triangles(scene), inst, roots,
        origin.reshape(n, 3), directions.reshape(n, 3),
        mode=np.int32(mode),
    )
    hit = Hit(t=t.reshape(shape), tri=tri.reshape(shape),
              inst=hit_inst.reshape(shape))
    if want_normals:
        hit = hit._replace(u=u.reshape(shape), v=v.reshape(shape),
                           n=nrm.reshape(shape + (3,)))
    return hit
