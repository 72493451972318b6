"""Multi-chip rendering: data-parallel image tiling over a device mesh.

The reference is strictly single-GPU (SURVEY.md §2 parallelism table);
its only parallel axis is pixels. The scale-out here keeps that axis: the pixel-ray batch is sharded across a 1-D ``Mesh`` via
``shard_map`` (contiguous blocks of image rows), the flat scene arrays are
replicated to every chip, and each chip runs the full raygen -> traverse
-> shade pipeline on its shard. No collectives are needed in the render
loop — assembly happens when the sharded uint8 image is fetched (the
``all_gather``/download analog of kernel.cu:37).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..render.camera import generate_rays
from ..render.pipeline import RenderConfig
from ..render.renderer import get_cast_fn, hit_attributes
from ..render.shade import shade_primary
from ..scene.scene import SceneArrays


def make_mesh(n_devices: int | None = None, axis: str = "rays") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis,))


def check_sharded_config(config: RenderConfig, path: bool = False) -> None:
    """The sharded pipelines run the integrators directly (no
    ``_with_ssaa`` wrapper, no denoiser): reject configs that would
    silently render differently from the single-device pipeline
    instead of dropping the feature. Trace-time (config is static)."""
    if config.ssaa != 1:
        raise ValueError(
            "sharded rendering does not apply ssaa supersampling; "
            "render at a higher resolution or supersample per shard"
        )
    if path and getattr(config, "denoise", 0):
        raise ValueError(
            "sharded path rendering does not run the denoiser; "
            "denoise the gathered image on one device"
        )


def _shard_body(config: RenderConfig, scene: SceneArrays, origin, directions):
    """Per-chip slice of the render pipeline (runs under shard_map)."""
    cast = get_cast_fn(config.backend,
                       want_normals=config.lighting != "flat")
    hit = cast(scene, origin, directions)
    attrs = hit_attributes(scene, origin, directions, hit, exact=config.exact_math)
    return shade_primary(
        scene, attrs, config.light_direction, config.lighting,
        exact=config.exact_math, backend=config.backend,
        directions=directions, point_lights=config.point_lights,
        tex_filter=config.texture_filter,
    )


@functools.partial(jax.jit, static_argnums=(0, 1))
def render_image_sharded(
    config: RenderConfig,
    mesh: Mesh,
    scene: SceneArrays,
    K_inv: jax.Array,
    D: jax.Array,
    pose: jax.Array,
    inv_pose: jax.Array,
) -> jax.Array:
    """Render one frame with image rows sharded over ``mesh``.

    Row constraint: H must be divisible by n_devices.
    """
    check_sharded_config(config)
    axis = mesh.axis_names[0]
    n = mesh.shape[axis]
    if config.height % n != 0:
        raise ValueError(
            f"height {config.height} not divisible by {n} devices"
        )
    origin, directions = generate_rays(
        config.width, config.height, K_inv, D, pose, inv_pose,
        exact=config.exact_math,
    )
    directions = jax.lax.with_sharding_constraint(
        directions, NamedSharding(mesh, P(axis, None, None))
    )
    body = functools.partial(_shard_body, config)
    origin_b = jnp.broadcast_to(origin, directions.shape)
    img = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(axis, None, None), P(axis, None, None)),
        out_specs=P(axis, None, None),
        # check_vma off: the body is embarrassingly parallel (no
        # collectives), and vma inference rejects lax.while_loop
        # carries whose init is unvarying
        check_vma=False,
    )(scene, origin_b, directions)
    return img


def _whitted_body(config: RenderConfig, bounces, scene, origin, directions):
    from ..render.integrators import render_whitted, to_u8, tonemap

    radiance = render_whitted(
        scene, origin, directions, max_bounces=bounces,
        backend=config.backend, light_direction=config.light_direction,
        point_lights=config.point_lights, exact=config.exact_math,
        tex_filter=config.texture_filter,
    )
    # elementwise + shard-local, so sharded output == unsharded output
    return to_u8(tonemap(radiance, config.tonemap, config.exposure))


@functools.partial(jax.jit, static_argnums=(0, 1, 7))
def render_image_whitted_sharded(
    config: RenderConfig,
    mesh: Mesh,
    scene: SceneArrays,
    K_inv: jax.Array,
    D: jax.Array,
    pose: jax.Array,
    inv_pose: jax.Array,
    bounces: int = 2,
) -> jax.Array:
    """Whitted reflections with image rows sharded over ``mesh``.
    Secondary rays derive from each chip's own pixels, so the whole
    bounce loop stays shard-local — no collectives."""
    check_sharded_config(config)
    axis = mesh.axis_names[0]
    if config.height % mesh.shape[axis] != 0:
        raise ValueError("height not divisible by the device count")
    origin, directions = generate_rays(
        config.width, config.height, K_inv, D, pose, inv_pose,
        exact=config.exact_math,
    )
    directions = jax.lax.with_sharding_constraint(
        directions, NamedSharding(mesh, P(axis, None, None))
    )
    body = functools.partial(_whitted_body, config, bounces)
    origin_b = jnp.broadcast_to(origin, directions.shape)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(axis, None, None), P(axis, None, None)),
        out_specs=P(axis, None, None),
        # check_vma off: the body is embarrassingly parallel (no
        # collectives), and vma inference rejects lax.while_loop
        # carries whose init is unvarying
        check_vma=False,
    )(scene, origin_b, directions)


def _path_body(config: RenderConfig, bounces, samples, scene, origin,
               directions, key):
    from ..render.integrators import render_path_traced, to_u8, tonemap

    radiance = render_path_traced(
        scene, origin, directions, key[0], max_bounces=bounces,
        samples=samples, backend=config.backend, exact=config.exact_math,
        tex_filter=config.texture_filter,
    )
    return to_u8(tonemap(radiance, config.tonemap, config.exposure))


@functools.partial(jax.jit, static_argnums=(0, 1, 8, 9))
def render_image_path_traced_sharded(
    config: RenderConfig,
    mesh: Mesh,
    scene: SceneArrays,
    K_inv: jax.Array,
    D: jax.Array,
    pose: jax.Array,
    inv_pose: jax.Array,
    key: jax.Array,
    bounces: int = 2,
    samples: int = 2,
) -> jax.Array:
    """Path tracing with image rows sharded over ``mesh``; every chip
    gets a DISTINCT fold of the rng key so samples decorrelate across
    shards."""
    check_sharded_config(config, path=True)
    axis = mesh.axis_names[0]
    n = mesh.shape[axis]
    if config.height % n != 0:
        raise ValueError("height not divisible by the device count")
    origin, directions = generate_rays(
        config.width, config.height, K_inv, D, pose, inv_pose,
        exact=config.exact_math,
    )
    directions = jax.lax.with_sharding_constraint(
        directions, NamedSharding(mesh, P(axis, None, None))
    )
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    body = functools.partial(_path_body, config, bounces, samples)
    origin_b = jnp.broadcast_to(origin, directions.shape)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(axis, None, None), P(axis, None, None), P(axis)),
        out_specs=P(axis, None, None),
        check_vma=False,  # see render_image_sharded
    )(scene, origin_b, directions, keys)
