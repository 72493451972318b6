"""Scene-SHARDED multichip rendering (the SURVEY §2 TP-analog).

The standard multichip path (parallel/sharding.py) shards RAYS and
replicates the scene — right up to the point where the scene itself
outgrows one chip's HBM. This module shards the GEOMETRY instead:

  * the scene is flattened to world space (Scene.flattened — the same
    static bake the whitted benchmarks use) and its merged, BVH-ordered
    triangle soup is split into ``n`` contiguous chunks (leaf order is
    spatially coherent, so chunks are compact, not interleaved);
  * each chunk compiles into its own SceneArrays (own BVH), padded so
    the stacked pytree is treedef-uniform, and the n pytrees are
    stacked on a leading shard axis — materials/atlas are replicated
    (identical rows), only geometry diverges;
  * every device casts ALL rays against ITS chunk (any backend,
    the traversal kernel included), then one lexicographic
    (t, global-tri) min-reduction over the mesh axis — ``jax.lax.pmin``
    — crowns the scene-wide nearest hit. Shading runs on the combined
    attributes (each field a winner-masked ``psum``), and hard-shadow
    occlusion is the pmin of the per-shard any-hit casts — point
    lights ride pmin-combined NEAREST casts — so every lighting mode
    composes. ``render_image_whitted_scene_sharded`` extends the same
    combine to every reflection bounce, and
    ``render_image_path_scene_sharded`` runs the full path integrator
    (NEE + fast tail) inside the shard body.

Combine semantics: the winner is the smallest t, ties broken by the
smaller GLOBAL triangle id (``shard * stride + local-BVH-index``) —
deterministic and unique because the chunks are disjoint. A cross-shard
EXACT-t tie may pick a different winner than the single-scene walk's
traversal order would; scenes with unique nearest hits — all of them,
in practice — render identically.

The reference has no distributed mode at all (single GPU, everything
resident — Scene.cpp:41-64); this mode goes beyond it. Like sharding.py, the mesh here is virtual-CPU-testable
and the same code drives several GPUs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..render.camera import generate_rays
from ..render.pipeline import RenderConfig
from ..render.renderer import FLT_MAX, Hit, get_cast_fn, hit_attributes
from ..scene.scene import SceneArrays

_MISS_TRI = jnp.int32(2 ** 30)


def shard_compile(scene, n_shards: int, **compile_kw) -> SceneArrays:
    """Flatten ``scene`` to world space, split the merged triangle soup
    into ``n_shards`` contiguous chunks, compile each chunk and stack
    the results on a leading shard axis (every leaf padded to the
    largest chunk's shape). Host work, once per scene.

    The returned stacked SceneArrays is NOT renderable directly — pass
    it to cast_rays_scene_sharded / render_image_scene_sharded with a
    mesh of exactly ``n_shards`` devices."""
    from ..scene.scene import MeshInstance, Scene
    from ..scene.mesh import MeshPrimitive

    flat, tri_mat = scene.flattened()
    merged = flat.meshes[0]
    total = merged.num_triangles
    if total < n_shards:
        raise ValueError("fewer triangles than shards")
    per = -(-total // n_shards)

    shards = []
    for s in range(n_shards):
        lo, hi = s * per, min((s + 1) * per, total)
        if lo >= hi:  # degenerate trailing shard: one real triangle
            lo, hi = total - 1, total
        chunk = Scene()
        chunk.materials = flat.materials
        chunk.sky_texture = getattr(scene, "sky_texture", None)
        sl = slice(lo, hi)
        kw = {}
        if merged.vn0 is not None:
            kw = dict(vn0=merged.vn0[sl], vn1=merged.vn1[sl],
                      vn2=merged.vn2[sl], vn_mask=merged.vn_mask[sl])
        mp = MeshPrimitive.from_triangles(
            merged.v0[sl], merged.v1[sl], merged.v2[sl], merged.normal[sl],
            merged.uv0[sl], merged.uv1[sl], merged.uv2[sl], **kw,
        )
        chunk.add_mesh(mp)
        chunk.add_mesh_instance(MeshInstance(0, 0))
        # per-triangle materials survive the flatten (aligned to the
        # chunk BVH's reorder, like Scene.compile(flatten_static=True))
        shards.append(chunk.compile(
            _tri_mat=tri_mat[sl][mp.bvh.order], **compile_kw,
        ))

    # pad every array leaf to the max shape per field, then stack
    leaves_list = [jax.tree.leaves(a) for a in shards]
    treedef = jax.tree.structure(shards[0])
    stacked = []
    for field in zip(*leaves_list):
        arrs = [np.asarray(x) for x in field]
        shape = tuple(max(a.shape[i] for a in arrs)
                      for i in range(arrs[0].ndim))
        padded = []
        for a in arrs:
            pad = [(0, shape[i] - a.shape[i]) for i in range(a.ndim)]
            if any(p[1] for p in pad):
                fill = -1 if a.dtype.kind in "iu" else 0
                a = np.pad(a, pad, constant_values=fill)
            padded.append(a)
        stacked.append(jnp.asarray(np.stack(padded)))
    out = jax.tree.unflatten(treedef, stacked)
    # padded trailing nodes are (-1, -1, -1, -1) leaves with zero boxes:
    # unreachable from the root, so they never traverse. Padded
    # triangles are all-zero (normal 0 fails every denom test).
    return out


def _local(scene_stacked: SceneArrays) -> SceneArrays:
    """Inside shard_map: peel the leading (length-1) shard axis."""
    return jax.tree.map(lambda a: a[0], scene_stacked)


def _tri_stride(scene_stacked: SceneArrays) -> int:
    return int(scene_stacked.tri_v0.shape[1])


def _combine_hit(hit: Hit, shard_id, stride, axis: str) -> Hit:
    """Lexicographic (t, global-tri) min over the shard axis. Matches
    the single-scene oracle's tie rule: smallest t, then smallest
    global triangle id (chunks are disjoint, so the winner is unique
    and the psum-broadcasts below are exact selects)."""
    t_min = jax.lax.pmin(hit.t, axis)
    gtri = hit.tri + shard_id * stride
    cand = jnp.where((hit.t == t_min) & (hit.tri >= 0), gtri, _MISS_TRI)
    gtri_min = jax.lax.pmin(cand, axis)
    miss = gtri_min >= _MISS_TRI
    # exclude all-miss lanes: every shard ties at _MISS_TRI there, and
    # a True winner on N shards would break the one-hot invariant the
    # psum-select combiners rely on (they'd sum N shards' garbage)
    winner = (cand == gtri_min) & ~miss
    out_tri = jnp.where(miss, jnp.int32(-1), gtri_min)
    inst = jax.lax.psum(jnp.where(winner, hit.inst, 0), axis)
    out_inst = jnp.where(miss, jnp.int32(-1), inst)
    return Hit(t=t_min, tri=out_tri, inst=out_inst), winner


def _combined_occ(local, axis, backend):
    """Mesh-combined ANY-HIT cast: occluded iff ANY shard occludes
    (t drops below FLT_MAX under the pmin)."""
    from ..render.renderer import occlusion_cast_fn

    loc_occ = occlusion_cast_fn(backend)

    def occ(_scene, so, sd):
        h = loc_occ(local, so, sd)
        return Hit(t=jax.lax.pmin(h.t, axis), tri=h.tri, inst=h.inst)

    return occ


def _combined_nearest(local, axis, backend):
    """Mesh-combined NEAREST cast, distance only: point-light
    visibility (lit = t >= dist) needs the true nearest t — an
    any-hit's first-accepted hit could sit past the light with a
    closer occluder unreported."""
    ncast = get_cast_fn(backend)

    def nearest(_scene, so, sd):
        h = ncast(local, so, sd)
        return Hit(t=jax.lax.pmin(h.t, axis), tri=h.tri, inst=h.inst)

    return nearest


def _combined_cast_attrs(local, sid, stride, axis, cast, config):
    """Build the sharded-combined ``(o, d) -> attrs`` closure: local
    cast, lex-min hit combine over the mesh axis, winner-psum of every
    shading input (the psum is an exact select because the winner mask
    is one-hot across the axis)."""
    def cast_attrs(o, d):
        hit = cast(local, o, d)
        combined, winner = _combine_hit(
            Hit(t=hit.t, tri=hit.tri, inst=hit.inst), sid, stride, axis,
        )
        attrs = hit_attributes(local, o, d, hit, exact=config.exact_math,
                               normal_mode=config.normal_mode)
        sel = lambda x, m: jax.lax.psum(jnp.where(m, x, 0), axis)
        wv = winner[..., None]
        return attrs._replace(
            hit=combined.t < FLT_MAX,
            t=combined.t,
            location=sel(attrs.location, wv),
            normal=sel(attrs.normal, wv),
            uv=sel(attrs.uv, wv),
            material=sel(attrs.material, winner),
            inst=combined.inst,
        )

    return cast_attrs


def cast_rays_scene_sharded(
    mesh: Mesh, scene_stacked: SceneArrays, origin, directions,
    backend: str | None = None,
) -> Hit:
    """Scene-wide nearest hit with the geometry sharded over ``mesh``.
    Returns GLOBAL triangle ids (shard * stride + local)."""
    axis = mesh.axis_names[0]
    stride = _tri_stride(scene_stacked)

    def body(sc, o, d):
        local = _local(sc)
        hit = get_cast_fn(backend)(local, o, d)
        combined, _ = _combine_hit(
            Hit(t=hit.t, tri=hit.tri, inst=hit.inst),
            jax.lax.axis_index(axis), stride, axis,
        )
        return combined

    origin = jnp.broadcast_to(
        jnp.asarray(origin, jnp.float32), jnp.asarray(directions).shape
    )
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(scene_stacked, origin, jnp.asarray(directions, jnp.float32))


@functools.partial(jax.jit, static_argnums=(0, 1))
def render_image_scene_sharded(
    config: RenderConfig,
    mesh: Mesh,
    scene_stacked: SceneArrays,
    K_inv: jax.Array,
    D: jax.Array,
    pose: jax.Array,
    inv_pose: jax.Array,
) -> jax.Array:
    """Primary render with the SCENE sharded over ``mesh`` and rays
    replicated: per-shard cast + attrs, one lex-min hit combine, a
    winner-masked psum of every shading input, and (lambert_shadow)
    per-shard any-hit occlusion min-combined — so the shadow test sees
    the WHOLE scene. Output matches the equivalent single-chip render
    of the same flattened geometry."""
    from ..render.integrators import to_u8, tonemap
    from ..render.shade import shade_primary
    from .sharding import check_sharded_config

    check_sharded_config(config)
    axis = mesh.axis_names[0]
    stride = _tri_stride(scene_stacked)
    want_n = config.lighting != "flat"

    origin, directions = generate_rays(
        config.width, config.height, K_inv, D, pose, inv_pose,
        exact=config.exact_math,
    )
    origin_b = jnp.broadcast_to(origin, directions.shape)

    def body(sc, o, d):
        local = _local(sc)
        sid = jax.lax.axis_index(axis)
        cattrs = _combined_cast_attrs(
            local, sid, stride, axis,
            get_cast_fn(config.backend, want_normals=want_n), config,
        )(o, d)
        img = shade_primary(
            local, cattrs, config.light_direction, config.lighting,
            exact=config.exact_math, backend=config.backend,
            directions=directions, tex_filter=config.texture_filter,
            point_lights=config.point_lights,
            cast_fn=_combined_occ(local, axis, config.backend),
            nearest_cast_fn=_combined_nearest(local, axis, config.backend),
        )
        return img

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(scene_stacked, origin_b, directions)


@functools.partial(jax.jit, static_argnums=(0, 1, 7, 8))
def render_image_whitted_scene_sharded(
    config: RenderConfig,
    mesh: Mesh,
    scene_stacked: SceneArrays,
    K_inv: jax.Array,
    D: jax.Array,
    pose: jax.Array,
    inv_pose: jax.Array,
    max_bounces: int = 2,
    shadows: bool = True,
) -> jax.Array:
    """Whitted reflections with the GEOMETRY sharded: every bounce's
    nearest-hit cast runs against the local chunk and is lex-min
    combined over the mesh axis — so reflection chains see the whole
    scene while each chip holds 1/n of it. Directional shadows
    are pmin-combined any-hit casts; POINT lights ride pmin-combined
    nearest casts — their query only reads the combined t. The
    estimator IS integrators.render_whitted, run inside the shard body
    through its ``_sharded_hooks`` seam (no duplicated shading math);
    replicated per-chip compute keeps every shard's radiance
    identical, so out_specs replicate without a gather."""
    from ..render.integrators import render_whitted, to_u8, tonemap
    from .sharding import check_sharded_config

    check_sharded_config(config)
    axis = mesh.axis_names[0]
    stride = _tri_stride(scene_stacked)

    origin, directions = generate_rays(
        config.width, config.height, K_inv, D, pose, inv_pose,
        exact=config.exact_math,
    )
    origin_b = jnp.broadcast_to(origin, directions.shape)

    def body(sc, o0, d0):
        local = _local(sc)
        sid = jax.lax.axis_index(axis)
        radiance = render_whitted(
            local, o0, d0, max_bounces=max_bounces,
            backend=config.backend,
            light_direction=config.light_direction,
            point_lights=config.point_lights,
            shadows=shadows, exact=config.exact_math,
            tex_filter=config.texture_filter,
            normal_mode=config.normal_mode,
            _sharded_hooks={
                "cast_attrs": _combined_cast_attrs(
                    local, sid, stride, axis,
                    get_cast_fn(config.backend, want_normals=True),
                    config,
                ),
                "occ": _combined_occ(local, axis, config.backend),
                "nearest": _combined_nearest(local, axis, config.backend),
            },
        )
        return to_u8(tonemap(radiance, config.tonemap, config.exposure))

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(scene_stacked, origin_b, directions)


@functools.partial(jax.jit, static_argnums=(0, 1, 8, 9))
def render_image_path_scene_sharded(
    config: RenderConfig,
    mesh: Mesh,
    scene_stacked: SceneArrays,
    K_inv: jax.Array,
    D: jax.Array,
    pose: jax.Array,
    inv_pose: jax.Array,
    key: jax.Array,
    max_bounces: int = 3,
    samples: int = 4,
) -> jax.Array:
    """Monte-Carlo path tracing with the GEOMETRY sharded over
    ``mesh``: the full integrator (integrators.render_path_traced —
    the realization of the reference's curand scaffolding,
    raycast.cu:190-193) runs inside the shard body through its
    ``_sharded_hooks`` seam, so every nearest-hit/NEE/fast-tail cast is
    the COMBINED cast (local chunk + lex-min over the mesh axis) and the
    estimator math is the single-chip integrator by construction.
    Sampling keys are replicated, so every chip draws the identical
    random stream and radiance stays replicated without a gather.
    NEE (config.path_lights) works: point-light visibility reads the
    pmin-combined nearest t; directional shadows the pmin'd any-hit."""
    from ..render.integrators import render_path_traced, to_u8, tonemap
    from .sharding import check_sharded_config

    check_sharded_config(config, path=True)
    axis = mesh.axis_names[0]
    stride = _tri_stride(scene_stacked)

    origin, directions = generate_rays(
        config.width, config.height, K_inv, D, pose, inv_pose,
        exact=config.exact_math,
    )
    origin_b = jnp.broadcast_to(origin, directions.shape)

    def body(sc, o0, d0, k):
        local = _local(sc)
        sid = jax.lax.axis_index(axis)
        cast = get_cast_fn(config.backend, want_normals=True)
        radiance = render_path_traced(
            local, o0, d0, k,
            max_bounces=max_bounces, samples=samples,
            backend=config.backend, exact=config.exact_math,
            tex_filter=config.texture_filter,
            light_direction=(config.light_direction
                             if config.path_lights else None),
            point_lights=(config.point_lights
                          if config.path_lights else ()),
            sun_intensity=config.sun_intensity,
            normal_mode=config.normal_mode,
            _sharded_hooks={
                "cast_attrs": _combined_cast_attrs(
                    local, sid, stride, axis, cast, config),
                "occ": _combined_occ(local, axis, config.backend),
                "nearest": _combined_nearest(local, axis, config.backend),
            },
        )
        return to_u8(tonemap(radiance, config.tonemap, config.exposure))

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(scene_stacked, origin_b, directions, key)
