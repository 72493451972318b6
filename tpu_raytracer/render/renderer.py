"""Nearest-hit queries + primary render pipeline (XLA backends).

The reference's ``cast_ray`` megakernel inner loop (raycast.cu:21-142)
becomes pure batched stages here. Every backend returns the same compact
hit record — ``(t, tri_idx, inst_idx)`` per ray — and the shared
``hit_attributes`` stage reconstructs location/normal/uv/material for
shading. Backends:

  * ``cast_rays_brute``: dense all-triangles test — the oracle renderer
    (SURVEY.md §4 test strategy item 5). O(rays x tris), test-only.
  * ``cast_rays_bvh``: per-ray short-stack BVH walk (vmapped
    lax.while_loop) with the reference's ordered near-child-first push
    and t-pruning (raycast.cu:54-138). Runs anywhere; the default off
    the GPU.
  * ``cuda`` (kernels/traverse.py): the same walk as a per-ray CUDA
    kernel through jax.ffi — the GPU default; on the CPU its host build
    runs for tests.

Instance handling matches raycast.cu:26-51: rays are transformed into
object space with precomputed inverse transforms, hit points are mapped
back to world space by scale + inv_pose, and distances compared in
world units. The normal transform uses the reference's formula
(normal * scale, raycast.cu:115-122); see shade.py for notes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel.bvh import MAX_BVH_DEPTH
from ..core import transforms as T
from ..core.vecmath import FLT_MAX, dot, magnitude, normalize
from ..scene.scene import SceneArrays
from .intersect import (
    bary_interp,
    barycentric_uv,
    point_in_triangle_uv,
    ray_aabb_entry,
    ray_plane_hit,
    safe_reciprocal,
)

# A walk holds at most one pending sibling per tree level plus the two
# children just pushed: MAX_BVH_DEPTH entries, and one spare. A push past
# the end would be dropped silently by .at[].set and lose hits.
STACK_SIZE = MAX_BVH_DEPTH + 1


class Hit(NamedTuple):
    """Compact per-ray hit record. ``t`` is world-space distance
    (FLT_MAX = miss), indices are -1 on miss.

    ``u``/``v`` (optional, None when the backend does not carry them):
    the accepted triangle's barycentric coordinates, recorded by the
    traversal kernel at accept time when the caller wants normals. When
    present, hit_attributes derives shading UVs from them directly —
    skipping the [T, 18] record gather and the barycentric redo. Same
    affine rows as the redo (intersect.py); equal up to FMA contraction
    of the kernel's compiler."""

    t: jax.Array
    tri: jax.Array
    inst: jax.Array
    u: jax.Array | None = None
    v: jax.Array | None = None
    # object-space face normal [..., 3] of the accepted triangle —
    # carried on request (want_normals) by the traversal kernel; a copy
    # of the record's normal, so identical to the tri_normal gather
    n: jax.Array | None = None


def _instance_object_ray(scene: SceneArrays, i, origin, direction):
    """World ray -> instance object space (raycast.cu:32-51)."""
    rot = scene.inst_pose[i, 3:6]
    inv_scale = scene.inst_inv_scale[i]
    obj_dir = T.apply_euler(rot, direction) * inv_scale
    obj_org = T.apply_lre(scene.inst_pose[i], origin) * inv_scale
    return obj_org, obj_dir




# ---------------------------------------------------------------------------
# Brute-force oracle
# ---------------------------------------------------------------------------


def cast_rays_brute(scene: SceneArrays, origin, directions) -> Hit:
    """All-triangles nearest hit. ``origin`` broadcasts against
    ``directions`` ([..., 3] each)."""
    directions = jnp.asarray(directions, jnp.float32)
    origin = jnp.broadcast_to(jnp.asarray(origin, jnp.float32), directions.shape)
    shape = directions.shape[:-1]

    best = Hit(
        t=jnp.full(shape, FLT_MAX, jnp.float32),
        tri=jnp.full(shape, -1, jnp.int32),
        inst=jnp.full(shape, -1, jnp.int32),
    )
    tri_ids = jnp.arange(scene.num_triangles, dtype=jnp.int32)

    for i in range(scene.num_instances):
        obj_org, obj_dir = _instance_object_ray(scene, i, origin, directions)
        o = obj_org[..., None, :]
        d = obj_dir[..., None, :]
        t, _, valid = ray_plane_hit(o, d, scene.tri_v0, scene.tri_normal)
        _, inside = point_in_triangle_uv(
            o, d, t, scene.tri_v0, scene.tri_v1, scene.tri_v2,
            scene.tri_uv0, scene.tri_uv1, scene.tri_uv2,
        )
        backface = dot(d, scene.tri_normal) < 0.0
        in_mesh = scene.tri_mesh == scene.inst_mesh[i]
        mask = valid & inside & backface & in_mesh
        dist = jnp.where(mask, t, FLT_MAX)

        j = jnp.argmin(dist, axis=-1)
        dj = jnp.take_along_axis(dist, j[..., None], axis=-1)[..., 0]
        better = dj < best.t
        best = Hit(
            t=jnp.where(better, dj, best.t),
            tri=jnp.where(better, tri_ids[j], best.tri),
            inst=jnp.where(better, jnp.int32(i), best.inst),
        )
    return best


# ---------------------------------------------------------------------------
# BVH traversal (XLA while_loop, vmapped per ray)
# ---------------------------------------------------------------------------


def _cast_one_bvh(scene: SceneArrays, origin, direction) -> Hit:
    """Single-ray nearest hit via short-stack BVH walk over every
    instance (raycast.cu:21-142), written with lax control flow so it
    vmaps/jits. All scene indexing is dynamic gathers."""
    best = (jnp.float32(FLT_MAX), jnp.int32(-1), jnp.int32(-1))

    for i in range(scene.num_instances):
        obj_org, obj_dir = _instance_object_ray(scene, i, origin, direction)
        inv_dir = safe_reciprocal(obj_dir)

        def leaf_fn(node, is_leaf, carry):
            t_best, tri_best = carry

            def tri_body(k, c):
                t_b, tr_b = c
                t, _, valid = ray_plane_hit(
                    obj_org, obj_dir, scene.tri_v0[k], scene.tri_normal[k]
                )
                _, inside = point_in_triangle_uv(
                    obj_org, obj_dir, t,
                    scene.tri_v0[k], scene.tri_v1[k], scene.tri_v2[k],
                    scene.tri_uv0[k], scene.tri_uv1[k], scene.tri_uv2[k],
                )
                backface = dot(obj_dir, scene.tri_normal[k]) < 0.0
                ok = valid & inside & backface & (t < t_b)
                return (
                    jnp.where(ok, t, t_b),
                    jnp.where(ok, k, tr_b),
                )

            start = scene.node_leaf_start[node]
            count = jnp.where(is_leaf, scene.node_leaf_count[node], 0)
            return jax.lax.fori_loop(start, start + count, tri_body, (t_best, tri_best))

        def step(carry):
            sp, stack, t_best, tri_best = carry
            sp = sp - 1
            node = stack[sp]
            ca = scene.node_child_a[node]
            cb = scene.node_child_b[node]
            is_leaf = ca < 0

            # Internal: ordered push, near child popped first, both
            # pruned against t_best (raycast.cu:69-79).
            da = ray_aabb_entry(obj_org, inv_dir, scene.node_min[ca], scene.node_max[ca])
            db = ray_aabb_entry(obj_org, inv_dir, scene.node_min[cb], scene.node_max[cb])
            a_near = da < db
            first = jnp.where(a_near, cb, ca)   # pushed first (far)
            d_first = jnp.where(a_near, db, da)
            second = jnp.where(a_near, ca, cb)  # pushed last (near)
            d_second = jnp.where(a_near, da, db)

            push1 = (~is_leaf) & (d_first < t_best)
            stack = stack.at[sp].set(jnp.where(push1, first, stack[sp]))
            sp1 = sp + push1.astype(jnp.int32)
            push2 = (~is_leaf) & (d_second < t_best)
            stack = stack.at[sp1].set(jnp.where(push2, second, stack[sp1]))
            sp2 = sp1 + push2.astype(jnp.int32)

            # internal nodes run the leaf loop zero times. (A lax.cond
            # here becomes a select under vmap whose batching rule
            # broadcasts every closed-over scene table to [rays, ...]:
            # rays x triangles records, terabytes at 1080p.)
            t_leaf, tri_leaf = leaf_fn(node, is_leaf, (t_best, tri_best))
            return sp2, stack, t_leaf, tri_leaf

        stack0 = jnp.zeros(STACK_SIZE, jnp.int32).at[0].set(scene.mesh_root[scene.inst_mesh[i]])
        carry = (jnp.int32(1), stack0, best[0], best[1])
        carry = jax.lax.while_loop(lambda c: c[0] > 0, step, carry)
        _, _, t_new, tri_new = carry
        improved = t_new < best[0]
        best = (
            t_new,
            jnp.where(improved, tri_new, best[1]),
            jnp.where(improved, jnp.int32(i), best[2]),
        )
    return Hit(*best)


def cast_rays_bvh(scene: SceneArrays, origin, directions) -> Hit:
    """Batched BVH nearest-hit: vmap of the single-ray walk."""
    directions = jnp.asarray(directions, jnp.float32)
    origin = jnp.broadcast_to(jnp.asarray(origin, jnp.float32), directions.shape)
    shape = directions.shape[:-1]
    flat_o = origin.reshape(-1, 3)
    flat_d = directions.reshape(-1, 3)
    hit = jax.vmap(lambda o, d: _cast_one_bvh(scene, o, d))(flat_o, flat_d)
    return Hit(*(None if x is None else x.reshape(shape) for x in hit))


# ---------------------------------------------------------------------------
# Hit attribute reconstruction (shared by all backends)
# ---------------------------------------------------------------------------


class HitAttributes(NamedTuple):
    hit: jax.Array  # [...] bool
    t: jax.Array  # [...] f32 world distance
    location: jax.Array  # [..., 3] world hit point
    normal: jax.Array  # [..., 3] world normal (unit)
    uv: jax.Array  # [..., 2]
    material: jax.Array  # [...] i32 (clamped to 0 on miss)
    inst: jax.Array  # [...] i32


def hit_attributes(
    scene: SceneArrays, origin, directions, hit: Hit, exact: bool = True,
    normal_mode: str = "reference",
) -> HitAttributes:
    """Reconstruct shading inputs from (t, tri, inst): re-runs the
    plane/barycentric math once for the selected triangle per ray and
    applies the world-space transforms of raycast.cu:98-124.

    ``normal_mode``: "reference" multiplies the rotated normal by the
    instance scale (raycast.cu:115-122) — correct only for uniform
    scale, preserved as the parity default. "inverse_transpose" applies
    the mathematically correct normal transform for the object->world
    map M = R diag(s): n_w = normalize(R (n_o / s)) (SURVEY.md §7
    step 4's ordered fix)."""
    directions = jnp.asarray(directions, jnp.float32)
    origin = jnp.broadcast_to(jnp.asarray(origin, jnp.float32), directions.shape)
    ok = hit.t < FLT_MAX
    tri = jnp.maximum(hit.tri, 0)
    inst = jnp.maximum(hit.inst, 0)

    # one [I, 18] lookup for all per-instance transform fields. With a
    # SINGLE instance the clamped index is statically 0 — the lookup
    # is a row-0 broadcast.
    ipack = jnp.concatenate(
        [scene.inst_pose, scene.inst_inv_pose, scene.inst_scale,
         scene.inst_inv_scale], axis=1
    )
    irec = ipack[0] if scene.inst_pose.shape[0] == 1 else ipack[inst]
    inst_pose = irec[..., 0:6]
    inst_inv_pose = irec[..., 6:12]
    scale = irec[..., 12:15]
    inv_scale = irec[..., 15:18]

    obj_dir = T.apply_euler(inst_pose[..., 3:6], directions) * inv_scale
    obj_org = T.apply_lre(inst_pose, origin) * inv_scale

    carried = hit.u is not None or hit.n is not None
    if carried:
        # Kernel-carried hit attributes (Hit.u/v/n when the caller wants
        # normals): each chain collapses to at most one narrow gather.
        # u/v come from the oracle's affine rows, n is a copy of the
        # record's normal, and the interpolation below is
        # point_in_triangle_uv's expression.
        if hit.u is not None:
            uvpack = jnp.concatenate(
                [scene.tri_uv0, scene.tri_uv1, scene.tri_uv2], axis=1
            )
            uvr = uvpack[tri]
            u_b, v_b = hit.u, hit.v
            uv = bary_interp(u_b, v_b, uvr[..., 0:2], uvr[..., 2:4],
                             uvr[..., 4:6])
        # hit.t IS the plane parameter on accepted lanes (the kernel
        # runs ray_plane_hit's arithmetic), so the plane redo drops;
        # same point formula as ray_plane_hit. Misses keep finite
        # garbage (t clamped to 0) like the redo produced.
        tp = jnp.where(ok, hit.t, 0.0)
        point = obj_org + tp[..., None] * obj_dir
        tnormal = hit.n if hit.n is not None else scene.tri_normal[tri]
        if hit.u is None:
            # normals carried but no carried uv (untextured scene):
            # derive uv by the redo for any consumer that wants it
            # (the uv AOV); XLA DCEs this whole chain when unused
            # (untextured shading never reads uv)
            uvrec = jnp.concatenate(
                [scene.tri_v0, scene.tri_v1, scene.tri_v2,
                 scene.tri_uv0, scene.tri_uv1, scene.tri_uv2], axis=1
            )[tri]
            u_b, v_b = barycentric_uv(
                obj_org, obj_dir, tp, uvrec[..., 0:3], uvrec[..., 3:6],
                uvrec[..., 6:9],
            )
            uv = bary_interp(u_b, v_b, uvrec[..., 9:11],
                             uvrec[..., 11:13], uvrec[..., 13:15])
    else:
        # ONE wide row gather instead of 7 separate table gathers (the
        # [T, 18] concat is a cheap bandwidth pass inside the same jit)
        packed = jnp.concatenate(
            [scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_normal,
             scene.tri_uv0, scene.tri_uv1, scene.tri_uv2], axis=1
        )
        rec = packed[tri]
        tv0 = rec[..., 0:3]
        tnormal = rec[..., 9:12]
        tp, point, _ = ray_plane_hit(obj_org, obj_dir, tv0, tnormal)
        u_b, v_b = barycentric_uv(
            obj_org, obj_dir, tp, tv0, rec[..., 3:6], rec[..., 6:9]
        )
        uv = bary_interp(u_b, v_b, rec[..., 12:14], rec[..., 14:16],
                         rec[..., 16:18])
    if scene.tri_vnorm is not None:
        # Smooth shading normals (the reference's disabled vn fan path,
        # OBJLoader.hpp:119-135): interpolate the per-corner vertex
        # normals at the hit's barycentrics; triangles whose face had
        # no vn records (flag 0) keep the flat face normal. The world
        # transform + normalize below apply to the interpolated vector
        # unchanged (normalize absorbs its non-unit length).
        vrec = scene.tri_vnorm[tri]
        n_int = bary_interp(u_b, v_b, vrec[..., 0:3], vrec[..., 3:6],
                            vrec[..., 6:9])
        smooth = (vrec[..., 9] > 0) & ok
        tnormal = jnp.where(smooth[..., None], n_int, tnormal)
    location = T.apply_lre(inst_inv_pose, point * scale)
    if normal_mode == "inverse_transpose":
        # (R diag(s))^-T = R diag(1/s): scale in OBJECT axes, then
        # rotate — correct under nonuniform scale.
        normal = normalize(
            T.apply_euler(inst_inv_pose[..., 3:6], tnormal * inv_scale),
            exact=exact,
        )
    else:
        # World normal: reference multiplies the rotated normal by
        # scale in world axes (raycast.cu:115-122); correct only for
        # uniform scale, preserved for parity.
        normal = normalize(
            T.apply_euler(inst_inv_pose[..., 3:6], tnormal) * scale,
            exact=exact,
        )
    # per-triangle material override (flattened static scenes bake the
    # source instance's material into tri_mat; -1 = resolve via inst)
    tmat = scene.tri_mat[tri]
    imat = (scene.inst_material[0] if scene.inst_pose.shape[0] == 1
            else scene.inst_material[inst])
    material = jnp.where(tmat >= 0, tmat, imat)
    return HitAttributes(
        hit=ok,
        t=hit.t,
        location=location,
        normal=normal,
        uv=uv,
        material=material,
        inst=inst,
    )


# Terminated-lane parking spot: origin far outside every scene with a
# direction pointing away, so a dead lane misses both children of every
# root and costs one node visit per instance instead of a full walk.
# Bounce and shadow casts keep the image shape and cast every lane;
# parking makes their cost track the LIVE ray population. slab:
# t = (box - 1e9) * 1 < 0 on every axis => far < 0 => miss, no inf/NaN.
PARK_ORIGIN = 1.0e9
PARK_DIRECTION = (1.0, 1.0, 1.0)


def park_dead_rays(o, d, live):
    """Replace dead lanes' rays with the guaranteed-miss parked ray;
    live lanes pass through unchanged."""
    keep = live[..., None]
    return (
        jnp.where(keep, o, PARK_ORIGIN),
        jnp.where(keep, d, jnp.asarray(PARK_DIRECTION, jnp.float32)),
    )


BACKENDS = ("brute", "bvh", "cuda")
# packet kernels of an earlier version of this renderer; asking for one
# is an error, never a silent substitute
REMOVED_BACKENDS = ("pallas", "paged", "paged_major")


def default_backend() -> str:
    """The traversal backend for JAX's default platform: the per-ray
    CUDA kernel on a GPU, the XLA walk elsewhere."""
    return "cuda" if jax.default_backend() == "gpu" else "bvh"


def resolve_backend(backend: str | None) -> str:
    """``None`` -> default_backend(); a known name passes through;
    removed or unknown names raise ValueError."""
    if backend is None:
        return default_backend()
    if backend in REMOVED_BACKENDS:
        raise ValueError(
            f"backend {backend!r} was a packet kernel of an earlier "
            f"version and has been removed; choose one of {BACKENDS} "
            f"(default on this "
            f"platform: {default_backend()!r})"
        )
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose one of {BACKENDS}")
    return backend


def occlusion_cast_fn(backend: str | None):
    """ANY-HIT cast for BOOLEAN shadow queries (occluded iff
    t < FLT_MAX): the traversal kernel stops a ray at its first accepted
    hit, which is all a hard shadow needs. The other backends return
    their nearest-hit cast (same boolean). Distance-bounded queries
    (point lights, ambient occlusion) must NOT use this."""
    backend = resolve_backend(backend)
    if backend == "cuda":
        from ..kernels.traverse import cast_rays_kernel

        return functools.partial(cast_rays_kernel, any_hit=True)
    return get_cast_fn(backend)


def get_cast_fn(backend: str | None, want_normals: bool = False):
    """Nearest-hit cast of ``backend`` (None = the platform default).

    ``want_normals``: the caller's shading mode reads attrs.normal (any
    non-flat lighting, bounce integrators, AOVs) — the traversal kernel
    then carries the accepted triangle's barycentric u/v and face normal
    on the Hit, so hit_attributes skips the triangle-record redo. The
    XLA backends ignore the request (attrs falls back to the redo)."""
    backend = resolve_backend(backend)
    if backend == "cuda":
        from ..kernels.traverse import cast_rays_kernel

        return functools.partial(cast_rays_kernel, want_normals=want_normals)
    return {"brute": cast_rays_brute, "bvh": cast_rays_bvh}[backend]
