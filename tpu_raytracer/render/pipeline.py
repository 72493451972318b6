"""Top-level render pipeline: raygen -> cast -> attributes -> shade.

The jit boundary is ``render_image``: scene arrays and camera pose are
runtime arguments (animating the camera or instances never recompiles,
like the reference where pose is a kernel argument, Camera.cu:29-31);
image size, backend and lighting mode are static config.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..scene.scene import SceneArrays
from .camera import Camera, generate_rays
from .renderer import get_cast_fn, hit_attributes
from .shade import DEFAULT_LIGHT_DIRECTION, shade_primary


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render options (hashable -> usable as a jit static arg)."""

    width: int
    height: int
    # brute | bvh | cuda; None = renderer.default_backend() for JAX's
    # default platform (cuda on a GPU, bvh elsewhere)
    backend: str | None = None
    lighting: str = "flat"  # flat | lambert | lambert_shadow | blinn_phong
    light_direction: tuple = DEFAULT_LIGHT_DIRECTION
    exact_math: bool = True  # False = reference Q_rsqrt normalize parity
    # Point lights (tuple of integrators.PointLight — frozen/hashable,
    # so the config stays a valid jit static arg). The reference sketch:
    # cast_toward_lights, raycast.cu:286-287. Used by the whitted path;
    # set light_direction=None to render with point lights alone.
    point_lights: tuple = ()
    # nearest = the reference's exact sampling (raycast.cu:224-240);
    # bilinear / trilinear = framework extensions (trilinear = mip-mapped
    # with screen-derivative LOD on primary rays, bilinear on bounces).
    texture_filter: str = "nearest"
    # Supersampled anti-aliasing factor (framework extension; the
    # reference shoots exactly one ray per pixel, raycast.cu:147-152).
    # ssaa=s renders at s*width x s*height with the intrinsics scaled
    # to keep the field of view, then box-averages s x s blocks.
    ssaa: int = 1
    # Path-tracer next-event estimation: when True, --mode path samples
    # light_direction + point_lights directly at every bounce (explicit
    # shadow casts). Off by default — the classic sky-ambient-only path
    # look, at its recorded cost.
    path_lights: bool = False
    sun_intensity: float = 1.0
    # HDR -> display mapping for the whitted/path integrators (the
    # primary pass stays the reference's raw truncating cast):
    # none | reinhard | aces (integrators.tonemap).
    tonemap: str = "none"
    exposure: float = 1.0
    # À-trous wavelet denoiser iterations for --mode path (0 = off;
    # effective radius ~2^n pixels). Guided by first-hit normal/depth;
    # applied in HDR space ahead of tonemap (denoise.atrous_denoise).
    denoise: int = 0
    # Normal transform under instance scale: "reference" keeps the
    # reference's rotate-then-multiply-by-scale (raycast.cu:115-122,
    # wrong under nonuniform scale, parity default); "inverse_transpose"
    # is the correct R diag(1/s) transform (SURVEY §7 step 4).
    normal_mode: str = "reference"


def _with_ssaa(config: RenderConfig, K_inv, body):
    """Run ``body(cfg, K_inv) -> u8 [h, w, 3]`` at ssaa x resolution and
    box-downsample. K' = diag(s, s, 1) @ K keeps the FOV, so
    K'_inv = K_inv @ diag(1/s, 1/s, 1) (column scale)."""
    s = config.ssaa
    if s <= 1:
        return body(config, K_inv)
    sub = dataclasses.replace(
        config, width=config.width * s, height=config.height * s, ssaa=1
    )
    K_inv_s = jnp.asarray(K_inv, jnp.float32) * jnp.array(
        [1.0 / s, 1.0 / s, 1.0], jnp.float32
    )
    big = body(sub, K_inv_s)
    f = big.astype(jnp.float32).reshape(
        config.height, s, config.width, s, 3
    ).mean(axis=(1, 3))
    return jnp.round(f).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnums=(0,))
def render_image(
    config: RenderConfig,
    scene: SceneArrays,
    K_inv: jax.Array,
    D: jax.Array,
    pose: jax.Array,
    inv_pose: jax.Array,
) -> jax.Array:
    """Render one frame -> uint8 [H, W, 3] (reference channel order)."""
    def body(cfg, K_inv_b):
        origin, directions = generate_rays(
            cfg.width, cfg.height, K_inv_b, D, pose, inv_pose,
            exact=cfg.exact_math,
        )
        cast = get_cast_fn(cfg.backend,
                           want_normals=cfg.lighting != "flat")
        hit = cast(scene, origin, directions)
        attrs = hit_attributes(
            scene, origin, directions, hit, exact=cfg.exact_math,
            normal_mode=cfg.normal_mode,
        )
        return shade_primary(
            scene, attrs, cfg.light_direction, cfg.lighting,
            exact=cfg.exact_math, backend=cfg.backend,
            directions=directions, point_lights=cfg.point_lights,
            tex_filter=cfg.texture_filter,
        )

    return _with_ssaa(config, K_inv, body)


@functools.partial(jax.jit, static_argnums=(0,))
def render_aovs(
    config: RenderConfig,
    scene: SceneArrays,
    K_inv: jax.Array,
    D: jax.Array,
    pose: jax.Array,
    inv_pose: jax.Array,
) -> dict:
    """Arbitrary-output-variable render (framework extension — the
    reference only ever writes the beauty image, raycast.cu:292-294).

    Returns a dict of per-pixel buffers: ``depth`` [H, W] f32 world
    distance (+inf on miss), ``normal`` [H, W, 3] f32 world unit normal
    (0 on miss), ``uv`` [H, W, 2] f32, ``instance`` / ``triangle``
    [H, W] i32 (-1 on miss), ``hit`` [H, W] bool. Useful for denoisers,
    compositing, and debugging BVH traversal."""
    origin, directions = generate_rays(
        config.width, config.height, K_inv, D, pose, inv_pose,
        exact=config.exact_math,
    )
    cast = get_cast_fn(config.backend, want_normals=True)
    hit = cast(scene, origin, directions)
    attrs = hit_attributes(
        scene, origin, directions, hit, exact=config.exact_math,
        normal_mode=config.normal_mode,
    )
    miss_i = jnp.int32(-1)
    return {
        "depth": jnp.where(attrs.hit, attrs.t, jnp.float32(jnp.inf)),
        "normal": jnp.where(attrs.hit[..., None], attrs.normal, 0.0),
        "uv": jnp.where(attrs.hit[..., None], attrs.uv, 0.0),
        "instance": jnp.where(attrs.hit, attrs.inst, miss_i),
        "triangle": jnp.where(attrs.hit, hit.tri, miss_i),
        "hit": attrs.hit,
    }


def render(camera: Camera, scene: SceneArrays, config: RenderConfig | None = None, **kw) -> jax.Array:
    """Convenience: render with a host Camera (computes inv_pose on the
    host per call, Camera.cu:21)."""
    if config is None:
        config = RenderConfig(width=camera.width, height=camera.height, **kw)
    p = camera.ray_params()
    return render_image(config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])


@functools.partial(jax.jit, static_argnums=(0, 6, 7))
def render_image_whitted(
    config: RenderConfig,
    scene: SceneArrays,
    K_inv: jax.Array,
    D: jax.Array,
    pose: jax.Array,
    inv_pose: jax.Array,
    max_bounces: int = 2,
    shadows: bool = True,
) -> jax.Array:
    """Whitted reflective render -> uint8 [H, W, 3] (BASELINE config 4)."""
    from .integrators import render_whitted, to_u8, tonemap

    def body(cfg, K_inv_b):
        origin, directions = generate_rays(
            cfg.width, cfg.height, K_inv_b, D, pose, inv_pose,
            exact=cfg.exact_math,
        )
        radiance = render_whitted(
            scene, origin, directions,
            max_bounces=max_bounces, backend=cfg.backend,
            light_direction=cfg.light_direction,
            point_lights=cfg.point_lights, shadows=shadows,
            exact=cfg.exact_math, tex_filter=cfg.texture_filter,
            normal_mode=cfg.normal_mode,
        )
        return to_u8(tonemap(radiance, cfg.tonemap, cfg.exposure))

    return _with_ssaa(config, K_inv, body)


@functools.partial(jax.jit, static_argnums=(0, 7, 8))
def render_image_ao(
    config: RenderConfig,
    scene: SceneArrays,
    K_inv: jax.Array,
    D: jax.Array,
    pose: jax.Array,
    inv_pose: jax.Array,
    key: jax.Array,
    samples: int = 8,
    radius: float = 1.0,
) -> jax.Array:
    """Ambient-occlusion render -> grayscale uint8 [H, W, 3]
    (integrators.render_ao; a standard lighting-debug / compositing
    pass the reference lacks)."""
    from .integrators import render_ao, to_u8

    def body(cfg, K_inv_b):
        origin, directions = generate_rays(
            cfg.width, cfg.height, K_inv_b, D, pose, inv_pose,
            exact=cfg.exact_math,
        )
        ao = render_ao(
            scene, origin, directions, key, samples=samples,
            radius=radius, backend=cfg.backend, exact=cfg.exact_math,
            normal_mode=cfg.normal_mode,
        )
        return to_u8(jnp.broadcast_to(ao[..., None], ao.shape + (3,)))

    return _with_ssaa(config, K_inv, body)


@functools.partial(jax.jit, static_argnums=(0, 7, 8, 9, 10))
def render_radiance_path_traced(
    config: RenderConfig,
    scene: SceneArrays,
    K_inv: jax.Array,
    D: jax.Array,
    pose: jax.Array,
    inv_pose: jax.Array,
    key: jax.Array,
    max_bounces: int = 3,
    samples: int = 4,
    lens_radius: float = 0.0,
    focus_distance: float = 4.0,
) -> jax.Array:
    """Path-traced HDR radiance -> f32 [H, W, 3] (no tonemap/u8/ssaa).
    The accumulation entry point: progressive renderers average these
    across frames in linear space and tonemap only for display
    (app/interactive.py path mode)."""
    from .integrators import render_path_traced

    origin, directions = generate_rays(
        config.width, config.height, K_inv, D, pose, inv_pose,
        exact=config.exact_math,
    )
    return render_path_traced(
        scene, origin, directions, key,
        max_bounces=max_bounces, samples=samples, backend=config.backend,
        exact=config.exact_math, tex_filter=config.texture_filter,
        lens_radius=lens_radius, focus_distance=focus_distance,
        light_direction=config.light_direction if config.path_lights else None,
        point_lights=config.point_lights if config.path_lights else (),
        sun_intensity=config.sun_intensity,
        normal_mode=config.normal_mode,
    )


@functools.partial(jax.jit, static_argnums=(0, 7, 8, 9, 10))
def render_image_path_traced(
    config: RenderConfig,
    scene: SceneArrays,
    K_inv: jax.Array,
    D: jax.Array,
    pose: jax.Array,
    inv_pose: jax.Array,
    key: jax.Array,
    max_bounces: int = 3,
    samples: int = 4,
    lens_radius: float = 0.0,
    focus_distance: float = 4.0,
) -> jax.Array:
    """Monte-Carlo path-traced render -> uint8 (BASELINE config 5).
    ``lens_radius > 0`` adds thin-lens depth of field."""
    from .integrators import render_path_traced, to_u8, tonemap

    def body(cfg, K_inv_b):
        origin, directions = generate_rays(
            cfg.width, cfg.height, K_inv_b, D, pose, inv_pose,
            exact=cfg.exact_math,
        )
        radiance = render_path_traced(
            scene, origin, directions, key,
            max_bounces=max_bounces, samples=samples, backend=cfg.backend,
            exact=cfg.exact_math, tex_filter=cfg.texture_filter,
            lens_radius=lens_radius, focus_distance=focus_distance,
            light_direction=cfg.light_direction if cfg.path_lights else None,
            point_lights=cfg.point_lights if cfg.path_lights else (),
            sun_intensity=cfg.sun_intensity,
            normal_mode=cfg.normal_mode,
        )
        if cfg.denoise > 0:
            # one extra primary cast for the normal/depth guides — a
            # 1/(S*B+1) cost next to the sample loop above
            from .denoise import atrous_denoise

            hit = get_cast_fn(cfg.backend, want_normals=True)(
                scene, origin, directions)
            attrs = hit_attributes(
                scene, origin, directions, hit, exact=cfg.exact_math,
                normal_mode=cfg.normal_mode,
            )
            radiance = atrous_denoise(
                radiance,
                jnp.where(attrs.hit[..., None], attrs.normal, 0.0),
                jnp.where(attrs.hit, attrs.t, jnp.float32(jnp.inf)),
                iterations=cfg.denoise,
            )
        return to_u8(tonemap(radiance, cfg.tonemap, cfg.exposure))

    return _with_ssaa(config, K_inv, body)
