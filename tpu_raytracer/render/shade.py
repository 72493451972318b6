"""Shading stages (reference: the tail of the render megakernel,
raycast.cu:208-294).

Exact reference semantics preserved for the parity path:
  * miss -> sky color (255, 204, 153) in the reference's channel order
    (raycast.cu:208-216);
  * textured materials sample nearest-neighbor with v flipped and
    C-style truncating modulo wrap clamped at 0 (raycast.cu:224-240),
    scaling by the literal 1/255 constant 0.0039215 (raycast.cu:237);
  * untextured materials multiply by albedo (raycast.cu:242-245);
  * illumination forced to 1.0 and clamped to [0.4, 1.0]
    (raycast.cu:282-290) in ``flat`` mode — ``lambert`` /
    ``lambert_shadow`` enable the cosine/shadow-ray logic the reference
    left commented out (raycast.cu:263-287);
  * final uint8 conversion truncates like the C cast (raycast.cu:292-294).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..core.vecmath import FLT_MAX, dot, normalize
from ..scene.scene import SceneArrays
from .renderer import HitAttributes, get_cast_fn, park_dead_rays

SKY_COLOR = (255, 204, 153)  # raycast.cu:211-213 (1.0, 0.8, 0.6) * 255
SHADOW_EPS = jnp.float32(1e-4)  # raycast.cu:259
DEFAULT_LIGHT_DIRECTION = (-0.2, 0.0, 1.0)  # raycast.cu:249


def point_light_illumination(
    scene: SceneArrays, attrs, point_lights, cast=None
) -> jax.Array:
    """Summed point-light contribution at the hit points — the
    reference's cast_toward_lights sketch (raycast.cu:286-287):
    inverse-square falloff, cosine weighting, and (when ``cast`` is
    given) a hard shadow ray per light that checks for occluders
    BETWEEN the surface point and the light."""
    illum = jnp.zeros(attrs.t.shape, jnp.float32)
    for light in point_lights:
        lpos = jnp.asarray(light.position, jnp.float32)
        to_light = lpos - attrs.location
        dist = jnp.sqrt(jnp.sum(to_light * to_light, -1))
        ldir = to_light / jnp.maximum(dist, 1e-8)[..., None]
        cos_i = jnp.maximum(dot(attrs.normal, ldir), 0.0)
        falloff = light.intensity / jnp.maximum(dist * dist, 1e-8)
        if cast is not None:
            occ = cast(scene, *park_dead_rays(
                attrs.location + ldir * SHADOW_EPS, ldir, attrs.hit
            ))
            lit = occ.t >= dist
            cos_i = jnp.where(lit, cos_i, 0.0)
        illum = illum + cos_i * falloff
    return illum


def _c_mod(a: jax.Array, b: jax.Array) -> jax.Array:
    """C-style truncating integer modulo (negative stays negative), as
    produced by the reference's ``%`` (raycast.cu:229-230)."""
    return jnp.where(a >= 0, a % jnp.maximum(b, 1), -((-a) % jnp.maximum(b, 1)))


def sample_texture(
    scene: SceneArrays, material, uv, tex_filter: str = "nearest"
) -> jax.Array:
    """Texture fetch from the flat atlas. ``nearest`` reproduces the
    reference's wrap semantics exactly (raycast.cu:224-240);
    ``bilinear`` is a framework extension (the reference has no
    filtering) — texel-center convention, positive wrap on both
    corners. Returns [..., 3] f32 in [0, 1]."""
    pack = jnp.stack(
        [scene.mat_tex_start, scene.mat_tex_w, scene.mat_tex_h], axis=1
    )
    rec = pack[material]
    return _sample_texture_vals(
        scene, rec[..., 0], rec[..., 1], rec[..., 2], uv,
        tex_filter=tex_filter,
    )


def _fetch_texel(scene, idx) -> jax.Array:
    # atlas texels are PACKED one-i32-per-texel (r | g<<8 | b<<16,
    # scene.py): one word per texel fetch; unpack with shifts
    word = scene.tex_atlas[jnp.clip(idx, 0, scene.tex_atlas.shape[0] - 1)]
    return jnp.stack(
        [word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF], axis=-1
    ).astype(jnp.float32)


def _sample_texture_vals(scene, start, w, h, uv, tex_filter="nearest"):
    if tex_filter == "bilinear":
        return _sample_texture_bilinear(scene, start, w, h, uv)
    if tex_filter != "nearest":
        raise ValueError(f"unknown texture filter: {tex_filter!r}")
    tex_x = (uv[..., 0] * w.astype(jnp.float32)).astype(jnp.int32)
    tex_y = ((1.0 - uv[..., 1]) * h.astype(jnp.float32)).astype(jnp.int32)
    tex_x = jnp.maximum(_c_mod(tex_x, w), 0)
    tex_y = jnp.maximum(_c_mod(tex_y, h), 0)
    idx = jnp.maximum(start, 0) + tex_y * w + tex_x
    return _fetch_texel(scene, idx) * jnp.float32(0.0039215)


def uv_screen_derivatives(attrs: HitAttributes) -> tuple:
    """Per-pixel UV screen derivatives for mip LOD selection — valid
    only for image-shaped shading ([H, W] attrs). Forward differences
    via roll; where the +1 neighbour is a different surface (other
    material or a miss) fall back to the backward difference, else 0
    (lod clamps to the sharpest level, the standard conservative
    choice)."""
    uv = attrs.uv
    same = lambda a, sh, ax: jnp.roll(a, sh, axis=ax)
    valid_with = lambda sh, ax: (
        attrs.hit & same(attrs.hit, sh, ax)
        & (attrs.material == same(attrs.material, sh, ax))
        & (attrs.inst == same(attrs.inst, sh, ax))
    )

    def axis_diff(ax):
        fwd = same(uv, -1, ax) - uv
        bwd = uv - same(uv, 1, ax)
        okf = valid_with(-1, ax)[..., None]
        okb = valid_with(1, ax)[..., None]
        return jnp.where(okf, fwd, jnp.where(okb, bwd, 0.0))

    return axis_diff(1), axis_diff(0)  # (d/dx, d/dy)


def _sample_texture_trilinear(scene, mat, uv, duv_dx, duv_dy) -> jax.Array:
    """Mip-mapped trilinear sample: LOD from the max texel-space
    footprint of the screen derivatives, bilinear taps on the two
    bracketing mip levels, lerp. Levels live in the same packed atlas
    (scene.mat_tex_mip_start)."""
    whp = jnp.stack([scene.mat_tex_w, scene.mat_tex_h], axis=1)[mat]
    w = whp[..., 0]
    h = whp[..., 1]
    wh = whp.astype(jnp.float32)
    fx = duv_dx * wh
    fy = duv_dy * wh
    rho2 = jnp.maximum(
        jnp.sum(fx * fx, -1), jnp.sum(fy * fy, -1)
    )
    n_levels = scene.mat_tex_mip_start.shape[1]
    lod = jnp.clip(
        0.5 * jnp.log2(jnp.maximum(rho2, 1e-12)), 0.0,
        jnp.float32(n_levels - 1),
    )
    l0 = lod.astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, n_levels - 1)
    frac = (lod - l0.astype(jnp.float32))[..., None]

    flat_starts = scene.mat_tex_mip_start.reshape(-1)

    def level_tap(lev):
        start = flat_starts[mat * n_levels + lev]
        wl = jnp.maximum(jax.lax.shift_right_logical(w, lev), 1)
        hl = jnp.maximum(jax.lax.shift_right_logical(h, lev), 1)
        return _sample_texture_bilinear(scene, start, wl, hl, uv)

    c0 = level_tap(l0)
    c1 = level_tap(l1)
    return c0 + (c1 - c0) * frac


def _sample_texture_bilinear(scene, start, w, h, uv) -> jax.Array:
    """Bilinear filter over the packed atlas: 4 corner gathers + lerp.
    Texel centers sit at (i + 0.5) / w (the GL convention), v flipped
    like the nearest path; corners wrap toroidally (true positive
    modulo — bilinear has no C-truncation history to preserve)."""
    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)
    x = uv[..., 0] * wf - 0.5
    y = (1.0 - uv[..., 1]) * hf - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0.astype(jnp.float32))[..., None]
    fy = (y - y0.astype(jnp.float32))[..., None]
    wp = jnp.maximum(w, 1)
    hp = jnp.maximum(h, 1)
    wrap = lambda i, n: ((i % n) + n) % n
    xw = (wrap(x0, wp), wrap(x0 + 1, wp))
    yw = (wrap(y0, hp), wrap(y0 + 1, hp))
    base = jnp.maximum(start, 0)
    c00 = _fetch_texel(scene, base + yw[0] * w + xw[0])
    c10 = _fetch_texel(scene, base + yw[0] * w + xw[1])
    c01 = _fetch_texel(scene, base + yw[1] * w + xw[0])
    c11 = _fetch_texel(scene, base + yw[1] * w + xw[1])
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return (top + (bot - top) * fy) * jnp.float32(0.0039215)


def sky_radiance(scene: SceneArrays, directions, exact: bool = True):
    """Per-ray sky radiance [..., 3] f32 in [0, 1]: the equirect
    environment map (scene.set_sky) sampled by direction when present,
    else the reference's flat constant (raycast.cu:211-213). World is
    y-forward / z-up (raycast.cu:181-182): u = yaw about z from +y,
    v = 0 at the zenith."""
    flat = jnp.broadcast_to(
        jnp.asarray(SKY_COLOR, jnp.float32) / 255.0,
        directions.shape[:-1] + (3,),
    )
    # STATIC gate: 4 gathers + arctan2/arcsin per ray are pure waste on
    # skyless scenes (the traced `where` below keeps both sides live)
    if not scene.has_sky:
        return flat
    d = normalize(jnp.asarray(directions, jnp.float32), exact=exact)
    u = jnp.arctan2(d[..., 0], d[..., 1]) * jnp.float32(
        1.0 / (2.0 * math.pi)
    ) + 0.5
    v = 1.0 - (
        0.5 - jnp.arcsin(jnp.clip(d[..., 2], -1.0, 1.0)) / jnp.float32(math.pi)
    )  # pre-flip: _sample_texture_bilinear flips v again
    h = jnp.maximum(scene.sky_tex_h, 1)
    v = jnp.clip(v, 0.5 / h.astype(jnp.float32),
                 1.0 - 0.5 / h.astype(jnp.float32))  # no pole wrap
    tex = _sample_texture_bilinear(
        scene, scene.sky_tex_start, scene.sky_tex_w, scene.sky_tex_h,
        jnp.stack([u, v], -1),
    )
    return jnp.where(scene.sky_tex_start >= 0, tex, flat)


def surface_color(
    scene: SceneArrays,
    attrs: HitAttributes,
    tex_filter: str = "nearest",
    uv_ddx=None,
    uv_ddy=None,
) -> jax.Array:
    """Texture sample where textured, else albedo (raycast.cu:224-245).
    Multiplied against the ray color (init (1,1,1), Ray.hpp:21).
    The integer (tex_start, w, h) pack stays i32 end-to-end, so atlas
    offsets past 2^24 texels (a single 4096x4096 texture is 16.78M)
    never round through f32.

    ``trilinear`` needs screen-space UV derivatives (``uv_ddx/ddy``,
    see uv_screen_derivatives); without them it degrades to bilinear
    (secondary/bounce rays have no screen footprint)."""
    alb = scene.mat_albedo[attrs.material]
    if not scene.has_textures:
        # STATIC gate: no material anywhere is textured, so the atlas
        # sample below is pure discarded work — skip it at trace time
        return alb
    ipack = jnp.stack(
        [scene.mat_tex_start, scene.mat_tex_w, scene.mat_tex_h], axis=1
    )
    mi = ipack[attrs.material]
    start = mi[..., 0]
    w = mi[..., 1]
    h = mi[..., 2]
    if tex_filter == "trilinear":
        if uv_ddx is not None:
            tex = _sample_texture_trilinear(
                scene, attrs.material, attrs.uv, uv_ddx, uv_ddy
            )
        else:
            tex = _sample_texture_vals(scene, start, w, h, attrs.uv,
                                       tex_filter="bilinear")
    else:
        tex = _sample_texture_vals(scene, start, w, h, attrs.uv,
                                   tex_filter=tex_filter)
    return jnp.where((start >= 0)[..., None], tex, alb)


# Blinn-Phong constants (BASELINE config 3: "Blinn-Phong, 1080p") — the
# reference has no specular term at all, so these are framework knobs.
BLINN_SHININESS = 32.0
BLINN_SPECULAR = 0.5


def compute_illumination(
    scene: SceneArrays,
    attrs: HitAttributes,
    light_direction,
    mode: str,
    exact: bool = True,
    backend: str | None = None,
    directions=None,
    point_lights: tuple = (),
    cast_fn=None,
    nearest_cast_fn=None,
) -> jax.Array:
    """Scalar illumination per ray.

    ``flat``: the reference's active path — 1.0 clamped to [0.4, 1.0]
    (raycast.cu:282-290). ``lambert``: cosine-weighted. ``lambert_shadow``:
    cosine-weighted with a hard shadow ray toward the directional light —
    the reference's disabled scaffolding (raycast.cu:263-287) done
    properly. ``blinn_phong``: lambert plus a half-vector specular lobe
    (BASELINE config 3; needs ``directions`` = the primary ray
    directions for the view vector). All modes end with the reference
    clamp. ``point_lights`` add inverse-square point-light terms in the
    non-flat modes (shadowed in ``lambert_shadow``);
    ``light_direction=None`` drops the directional sun entirely.
    """
    if mode == "flat":
        illum = jnp.ones(attrs.t.shape, jnp.float32)
    elif light_direction is None:
        cos_illum = jnp.zeros(attrs.t.shape, jnp.float32)
        illum = cos_illum
    else:
        light_dir = normalize(
            jnp.asarray(light_direction, jnp.float32), exact=exact
        )
        cos_illum = dot(attrs.normal, light_dir)
        illum = jnp.maximum(cos_illum, 0.0)
        if mode == "blinn_phong":
            if directions is None:
                raise ValueError("blinn_phong needs the ray directions")
            view = -normalize(jnp.asarray(directions, jnp.float32), exact=exact)
            half = normalize(light_dir + view, exact=exact)
            spec = jnp.maximum(dot(attrs.normal, half), 0.0)
            illum = illum + BLINN_SPECULAR * spec ** BLINN_SHININESS
        elif mode == "lambert_shadow":
            from .renderer import occlusion_cast_fn

            # cast_fn override: scene-sharded rendering injects a cast
            # whose occlusion t is already min-combined across shards
            # (parallel/scene_shard.py); default = the local any-hit
            cast = cast_fn if cast_fn is not None else occlusion_cast_fn(backend)
            shadow_origin = attrs.location + light_dir * SHADOW_EPS
            # no shadow ray where the primary missed: parked lanes fail
            # the root box test so sky-dominated tiles cast for free.
            # Clamp-aware parking: with no point lights, the final
            # [0.4, 1.0] clamp (raycast.cu:289-290) maps lit (cos) and
            # shadowed (0.4*cos) to the SAME 0.4 whenever cos <= 0.4 —
            # the occlusion answer is unobservable there, so those rays
            # (backfacing walls/ceilings, terminator bands) park too.
            # Bit-exact: parked lanes miss -> lit -> clip(cos) = 0.4.
            need_shadow = attrs.hit
            if not point_lights:
                need_shadow = need_shadow & (cos_illum > 0.4)
            occ = cast(scene, *park_dead_rays(
                shadow_origin,
                jnp.broadcast_to(light_dir, attrs.location.shape),
                need_shadow,
            ))
            lit = occ.t >= FLT_MAX
            # Shadowed points keep the 0.4*cos ambient floor the
            # reference sketched (raycast.cu:263-266, 278).
            illum = jnp.where(lit, cos_illum, 0.4 * cos_illum)
        elif mode != "lambert":
            raise ValueError(f"unknown lighting mode: {mode}")
    if point_lights and mode != "flat":
        if cast_fn is not None and nearest_cast_fn is None:
            raise ValueError(
                "point lights with a cast_fn override also need "
                "nearest_cast_fn (scene-sharded rendering injects the "
                "min-combined NEAREST cast: the any-hit override is "
                "wrong for distance-bounded light visibility)"
            )
        if mode != "lambert_shadow":
            pcast = None  # unshadowed point term
        elif nearest_cast_fn is not None:
            pcast = nearest_cast_fn
        else:
            pcast = get_cast_fn(backend)
        illum = illum + point_light_illumination(
            scene, attrs, point_lights, cast=pcast
        )
    illum = jnp.minimum(1.0, illum)  # raycast.cu:289
    illum = jnp.maximum(0.4, illum)  # raycast.cu:290
    return illum


def shade_primary(
    scene: SceneArrays,
    attrs: HitAttributes,
    light_direction=DEFAULT_LIGHT_DIRECTION,
    mode: str = "flat",
    exact: bool = True,
    backend: str | None = None,
    directions=None,
    point_lights: tuple = (),
    tex_filter: str = "nearest",
    cast_fn=None,
    nearest_cast_fn=None,
) -> jax.Array:
    """Full primary-hit shade -> uint8 image in the reference's channel
    order. Misses get the sky color (raycast.cu:208-216)."""
    ddx = ddy = None
    if tex_filter == "trilinear" and attrs.uv.ndim == 3:
        ddx, ddy = uv_screen_derivatives(attrs)
    color = surface_color(scene, attrs, tex_filter=tex_filter,
                          uv_ddx=ddx, uv_ddy=ddy)
    illum = compute_illumination(
        scene, attrs, light_direction, mode, exact=exact, backend=backend,
        directions=directions, point_lights=point_lights, cast_fn=cast_fn,
        nearest_cast_fn=nearest_cast_fn,
    )
    rgb = illum[..., None] * color * jnp.float32(255.0)
    shaded = rgb.astype(jnp.uint8)  # C-cast truncation (raycast.cu:292-294)
    sky = jnp.asarray(SKY_COLOR, jnp.uint8)
    if directions is not None and scene.has_sky:
        # environment-map sky on miss rays (scene.set_sky); skyless
        # scenes skip this statically and keep the EXACT reference
        # constant
        tex = (sky_radiance(scene, directions, exact=exact)
               * jnp.float32(255.0)).astype(jnp.uint8)
        sky = jnp.where(scene.sky_tex_start >= 0, tex, sky)
    return jnp.where(attrs.hit[..., None], shaded, sky)
