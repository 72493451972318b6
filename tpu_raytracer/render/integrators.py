"""Multi-bounce integrators: Whitted reflections, point lights, and
path tracing.

The reference carries scaffolding for all of this — ``Ray.color`` /
``illumination`` / ``terminated`` (Ray.hpp:10-14), the commented-out
shadow/light-source code (raycast.cu:263-287), and per-pixel curand
state (raycast.cu:190-193) — but only the flat-shaded primary pass is
active. These integrators realize that scaffolding as a *wavefront*:
each bounce casts the full ray batch through the shared nearest-hit
backends (renderer.py, kernels/traverse.py), with terminated rays
parked on a guaranteed-miss ray rather than compacted.

Colors here are float [0, 1]; the uint8 conversion at the end matches
the reference's truncating cast (raycast.cu:292-294).
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..core.vecmath import FLT_MAX, dot, normalize
from ..scene.scene import SceneArrays
from .renderer import (
    get_cast_fn, hit_attributes, occlusion_cast_fn, park_dead_rays as _park,
)
from .shade import (
    DEFAULT_LIGHT_DIRECTION, SHADOW_EPS, sky_radiance, surface_color,
)

SKY_F32 = (1.0, 0.8, 0.6)  # raycast.cu:211-213 before the *255


@dataclasses.dataclass(frozen=True)
class PointLight:
    """A point light (the reference's cast_toward_lights sketch,
    raycast.cu:286-287: position + intensity)."""

    position: tuple
    intensity: float = 100.0


def _reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


def _direct_illumination(
    scene, cast, attrs, light_direction, point_lights, exact, shadows,
    occ_cast=None, shadow_floor=0.4, clamp_floor=None,
):
    """Directional + point-light contribution at the hit points, with
    hard shadow rays (the disabled reference path, raycast.cu:263-287).
    ``occ_cast``: ANY-HIT cast for the boolean directional shadow
    (renderer.occlusion_cast_fn); point lights keep the nearest-hit
    ``cast`` (their query is distance-bounded). ``shadow_floor``: the
    occluded directional term keeps floor*cos_i — 0.4 is the
    reference's ambient clamp look (raycast.cu:289-290); the path
    tracer passes 0.0 (true shadows; ambient comes from the sky)."""
    illum = jnp.zeros(attrs.t.shape, jnp.float32)
    if light_direction is not None:
        ldir = normalize(jnp.asarray(light_direction, jnp.float32), exact=exact)
        cos_i = jnp.maximum(dot(attrs.normal, ldir), 0.0)
        if shadows:
            # no shadow ray where the primary missed. Rays with
            # cos_i == 0 (light behind the surface) park too: lit
            # (cos_i) and shadowed (floor*cos_i) are both 0, so the
            # occlusion answer is unobservable — for cosine-scattered
            # path bounces this parks roughly half the hit points.
            # With a caller-side clamp (whitted's clip(illum, 0.4, 1))
            # and no point lights the threshold rises to clamp_floor:
            # both branches clip to the same value below it. Bit-exact
            # either way (parked lanes miss -> the lit branch).
            thresh = (
                clamp_floor
                if clamp_floor is not None and not point_lights
                else 0.0
            )
            need = attrs.hit & (cos_i > thresh)
            occ = (occ_cast or cast)(
                scene,
                *_park(
                    attrs.location + ldir * SHADOW_EPS,
                    jnp.broadcast_to(ldir, attrs.location.shape),
                    need,
                ),
            )
            lit = occ.t >= FLT_MAX
            cos_i = jnp.where(lit, cos_i, shadow_floor * cos_i)
        illum = illum + cos_i
    if point_lights:
        from .shade import point_light_illumination

        illum = illum + point_light_illumination(
            scene, attrs, point_lights, cast=cast if shadows else None
        )
    return illum


def render_whitted(
    scene: SceneArrays,
    origin,
    directions,
    max_bounces: int = 2,
    backend: str | None = None,
    light_direction=DEFAULT_LIGHT_DIRECTION,
    point_lights: tuple = (),
    shadows: bool = True,
    exact: bool = True,
    tex_filter: str = "nearest",
    normal_mode: str = "reference",
    _sharded_hooks: dict | None = None,
) -> jax.Array:
    """Whitted-style recursive reflections, iteratively unrolled.

    Local shading is weighted (1 - reflectivity); a mirror bounce
    continues with weight reflectivity (material.reflectivity — the
    roughness/metallic fields the reference stores but never reads,
    Material.hpp:8-10, realized as an explicit knob). Returns float
    [..., 3] radiance in [0, 1]."""
    cast = get_cast_fn(backend, want_normals=True)
    dcast = get_cast_fn(backend)
    occ_cast = occlusion_cast_fn(backend)
    # Scene-sharded seam (parallel/scene_shard.py; same contract as
    # render_path_traced's): the hooks swap exactly the cast+attrs and
    # shadow-cast sites for mesh-combined versions, so the sharded
    # whitted image is THIS estimator by construction, not a copy.
    if _sharded_hooks is not None:
        dcast = _sharded_hooks["nearest"]
        occ_cast = _sharded_hooks["occ"]
    directions = jnp.asarray(directions, jnp.float32)
    origin = jnp.broadcast_to(jnp.asarray(origin, jnp.float32), directions.shape)
    shape = directions.shape[:-1]

    radiance = jnp.zeros(shape + (3,), jnp.float32)
    throughput = jnp.ones(shape + (3,), jnp.float32)  # Ray.color (Ray.hpp:21)
    active = jnp.ones(shape, bool)

    o, d = origin, directions
    for bounce in range(max_bounces + 1):
        if _sharded_hooks is not None:
            attrs = _sharded_hooks["cast_attrs"](o, d)
        else:
            attrs = hit_attributes(scene, o, d, cast(scene, o, d),
                                   exact=exact, normal_mode=normal_mode)

        miss = active & ~attrs.hit
        sky = sky_radiance(scene, d, exact=exact)
        radiance = radiance + jnp.where(miss[..., None], throughput * sky, 0.0)

        live = active & attrs.hit
        color = surface_color(scene, attrs, tex_filter=tex_filter)
        illum = _direct_illumination(
            scene, dcast, attrs, light_direction, point_lights, exact,
            shadows, occ_cast=occ_cast,
            clamp_floor=0.4,  # matches the clip below: shadow rays with
        )                     # cos <= 0.4 are unobservable and park
        illum = jnp.clip(illum, 0.4, 1.0)  # reference clamp (raycast.cu:289-290)
        rpack = jnp.stack(
            [scene.mat_reflectivity, scene.mat_illumination], axis=1
        )
        rrec = rpack[attrs.material]
        refl = rrec[..., 0]
        emit = rrec[..., 1]
        local = color * illum[..., None] * (1.0 - refl[..., None]) + emit[..., None]
        radiance = radiance + jnp.where(live[..., None], throughput * local, 0.0)

        if bounce == max_bounces:
            break
        # continue the mirror bounce
        throughput = throughput * jnp.where(live[..., None], color * refl[..., None], 0.0)
        active = live & (refl > 0.0)
        d = normalize(_reflect(d, attrs.normal), exact=exact)
        o = attrs.location + d * SHADOW_EPS
        o, d = _park(o, d, active)
    return radiance


def _cosine_sample(key, normal, exact):
    """Cosine-weighted hemisphere sample around the normal."""
    shape = normal.shape[:-1]
    u = jax.random.uniform(key, shape + (2,), jnp.float32)
    r = jnp.sqrt(u[..., 0])
    phi = 2.0 * jnp.pi * u[..., 1]
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(1.0 - u[..., 0], 0.0))
    # orthonormal basis around n
    n = normal
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + sign * n[..., 0] ** 2 * a, sign * b, -sign * n[..., 0]], -1
    )
    bvec = jnp.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    d = x[..., None] * t + y[..., None] * bvec + z[..., None] * n
    return normalize(d, exact=exact)


def render_path_traced(
    scene: SceneArrays,
    origin,
    directions,
    key: jax.Array,
    max_bounces: int = 3,
    samples: int = 4,
    backend: str | None = None,
    sky_strength: float = 1.0,
    exact: bool = True,
    tex_filter: str = "nearest",
    lens_radius: float = 0.0,
    focus_distance: float = 4.0,
    light_direction=None,
    point_lights: tuple = (),
    sun_intensity: float = 1.0,
    normal_mode: str = "reference",
    sample_batch: bool = True,
    _sharded_hooks: dict | None = None,
) -> jax.Array:
    """Monte-Carlo path tracing (the stochastic bounce design the
    reference's curand setup anticipated, raycast.cu:190-193).

    ``light_direction`` / ``point_lights`` enable NEXT-EVENT
    ESTIMATION: at every bounce the diffuse lobe adds the delta
    lights' direct contribution through an explicit shadow cast
    (cos_i * vis * intensity * albedo/pi), which converges in a
    fraction of the samples that waiting for bounce rays to luck into
    lighting needs. Delta lights are invisible to BSDF samples (a
    continuous lobe hits a delta direction with probability zero), so
    there is no double counting against the sky. Defaults keep the
    sky-ambient-only behavior (and its cost) unchanged.

    Materials follow the reference's stored-but-unused PBR fields
    (Material.hpp:8-10): with probability ``mat_reflectivity`` a
    sample continues in the SPECULAR lobe — the mirror direction
    blended toward a cosine sample by ``mat_roughness`` (0 = perfect
    mirror, 1 = diffuse-wide gloss) — otherwise in the cosine-diffuse
    lobe. Lobe choice by its own weight keeps throughput = albedo
    for both (the discrete-choice pdf cancels the lobe weight).

    ``lens_radius > 0`` enables thin-lens depth of field: per sample,
    primary origins jitter on a lens disk (perpendicular to the mean
    view axis) and re-aim at the focal point at ``focus_distance``
    along each ray — surfaces off the focal plane blur. With a zero
    radius the primary cast is sample-independent and stays hoisted
    out of the sample scan.

    Lambertian BRDF with cosine-weighted sampling, emissive materials
    via mat_illumination, sky as the ambient environment. The bounce
    loop is a dense masked wavefront with terminated lanes PARKED on a
    guaranteed-miss ray; samples run as one batched wavefront (or, with
    ``sample_batch=False``, accumulate via lax.scan in constant memory).
    Returns float [..., 3].
    """
    cast = get_cast_fn(backend, want_normals=True)
    occ_cast = occlusion_cast_fn(backend)
    nee = light_direction is not None or bool(point_lights)
    # FAST TAIL: with no emissive materials and no NEE, the FINAL
    # bounce's nearest-hit cast is observable only as hit-vs-miss
    # (miss adds throughput * sky; a hit adds emit == 0 and the loop
    # ends), so it collapses to the ANY-HIT occlusion cast — in the
    # traversal kernel a ray stops at its FIRST accepted hit instead
    # of refining nearest-t through the tree. Bit-exact by
    # construction (same intersection predicate decides the boolean).
    # scene.has_emissive is a STATIC flag: the choice is made at trace
    # time (the r3 lesson — never gate dead casts on traced scalars).
    fast_tail = (
        not nee
        and not scene.has_emissive
        and max_bounces >= 1
        and os.environ.get("TRT_PATH_TAIL", "1") != "0"
    )
    # Scene-sharded seam (parallel/scene_shard.py): when the geometry is
    # sharded over a device mesh, every cast must be the COMBINED cast
    # (local chunk + lex-min over the mesh axis) and hit attributes the
    # winner-psum'd combined attrs. The hooks replace exactly the
    # cast+attrs sites; the estimator math above/below is untouched, so
    # the sharded path is the same integrator by construction.
    if _sharded_hooks is None:
        def _attrs_primary(o, d):
            return hit_attributes(scene, o, d, cast(scene, o, d),
                                  exact=exact, normal_mode=normal_mode)

        _attrs_bounce = _attrs_primary
        _tail_occ = occ_cast
        _nee_cast, _nee_occ = cast, occ_cast
    else:
        _attrs_primary = _attrs_bounce = _sharded_hooks["cast_attrs"]
        _tail_occ = _sharded_hooks["occ"]
        _nee_cast, _nee_occ = _sharded_hooks["nearest"], _sharded_hooks["occ"]
    directions = jnp.asarray(directions, jnp.float32)
    origin = jnp.broadcast_to(jnp.asarray(origin, jnp.float32), directions.shape)
    shape = directions.shape[:-1]
    inv_pi = 1.0 / np.pi

    def bounce_from_attrs(state, attrs, key_b):
        o, d, throughput, radiance, active = state
        lshape = active.shape  # (samples,)+shape when sample-batched
        miss = active & ~attrs.hit
        sky = sky_radiance(scene, d, exact=exact) * sky_strength
        radiance = radiance + jnp.where(miss[..., None], throughput * sky, 0.0)
        live = active & attrs.hit
        color = surface_color(scene, attrs, tex_filter=tex_filter)
        # one packed [M, 3] material lookup (illum/refl/rough)
        mpack = jnp.stack(
            [scene.mat_illumination, scene.mat_reflectivity,
             scene.mat_roughness], axis=1
        )[attrs.material]
        emit = mpack[..., 0]
        radiance = radiance + jnp.where(
            live[..., None], throughput * emit[..., None], 0.0
        )
        throughput = throughput * jnp.where(live[..., None], color, 1.0)
        refl = mpack[..., 1]
        if nee:
            # direct delta-light term on the diffuse part of the lobe
            # mix: T * (1-refl) * albedo/pi * cos_i * vis * intensity
            # (albedo is already folded into throughput above)
            illum = _direct_illumination(
                scene, _nee_cast, attrs, light_direction, point_lights,
                exact, shadows=True, occ_cast=_nee_occ, shadow_floor=0.0,
            )
            w = (1.0 - refl) * illum * (inv_pi * sun_intensity)
            radiance = radiance + jnp.where(
                live[..., None], throughput * w[..., None], 0.0
            )
        d_diff = _cosine_sample(key_b, attrs.normal, exact)
        # glossy lobe: mirror blended toward the cosine sample by
        # roughness, flipped back to the diffuse sample if it dips
        # under the surface. When every reflectivity is 0 the selects
        # all pick d_diff — identical output, and the extra elementwise ops
        # are noise next to a cast.
        rough = mpack[..., 2][..., None]
        mirror = _reflect(d, attrs.normal)
        d_spec = normalize(
            (1.0 - rough) * mirror + rough * d_diff, exact=exact
        )
        d_spec = jnp.where(
            (dot(d_spec, attrs.normal) > 0.0)[..., None], d_spec, d_diff
        )
        u = jax.random.uniform(jax.random.fold_in(key_b, 3), lshape)
        d_new = jnp.where((u < refl)[..., None], d_spec, d_diff)
        o_new = attrs.location + d_new * SHADOW_EPS
        o_next, d_next = _park(
            jnp.where(live[..., None], o_new, o),
            jnp.where(live[..., None], d_new, d),
            live,
        )
        return (o_next, d_next, throughput, radiance, live)

    # The primary cast is sample-INDEPENDENT (unless a lens makes it
    # stochastic): hoist it out of the sample scan so S samples x (B+1)
    # casts become S*B + 1 casts (the reference's per-pixel curand
    # design re-traces primaries per sample; raycast.cu:190-204).
    dof = lens_radius > 0.0
    if not dof:
        attrs0 = _attrs_primary(origin, directions)
    else:
        # lens basis perpendicular to the mean view axis
        axis = normalize(
            jnp.mean(directions.reshape(-1, 3), axis=0), exact=exact
        )
        ref = jnp.where(jnp.abs(axis[2]) < 0.9,
                        jnp.array([0.0, 0.0, 1.0], jnp.float32),
                        jnp.array([1.0, 0.0, 0.0], jnp.float32))
        right = normalize(jnp.cross(axis, ref), exact=exact)
        up = jnp.cross(right, axis)

    def run_bounces(state, a0, keys):
        """Bounce chain from primary attrs to final radiance. State is
        shape-polymorphic: per-sample under the scan, (samples,)+shape
        under the sample-batched wavefront."""
        state = bounce_from_attrs(state, a0, keys[0])
        for b in range(1, max_bounces + 1):
            o, d = state[0], state[1]
            if fast_tail and b == max_bounces:
                # final bounce: boolean visibility is the whole answer
                throughput, radiance, active = state[2], state[3], state[4]
                sky = sky_radiance(scene, d, exact=exact) * sky_strength
                miss = active & (_tail_occ(scene, o, d).t >= FLT_MAX)
                radiance = radiance + jnp.where(
                    miss[..., None], throughput * sky, 0.0
                )
                return radiance
            attrs = _attrs_bounce(o, d)
            state = bounce_from_attrs(state, attrs, keys[b])
        return state[3]

    # SAMPLE-BATCHED WAVEFRONT (default; TRT_PATH_SAMPLE_BATCH=0 falls
    # back to the per-sample lax.scan): run all S samples as one
    # (S,)+shape ray batch instead of a sequential scan — S times fewer
    # cast launches, each S times wider. Same
    # estimator/distribution, different random stream than the scan
    # (draws are shaped (S,)+shape rather than per-sample), so images
    # differ sample-noise-level only. Wavefront memory scales with S —
    # for very high spp at large resolutions prefer the scan.
    env_sb = os.environ.get("TRT_PATH_SAMPLE_BATCH")
    if env_sb is not None:
        sample_batch = env_sb != "0"
    sample_batch = sample_batch and samples > 1 and not dof
    if sample_batch:
        bshape = (samples,) + shape
        bc = lambda a: jnp.broadcast_to(a[None], (samples,) + a.shape)
        a0 = type(attrs0)(*(bc(x) for x in attrs0))
        state = (
            bc(origin),
            bc(directions),
            jnp.ones(bshape + (3,), jnp.float32),
            jnp.zeros(bshape + (3,), jnp.float32),
            jnp.ones(bshape, bool),
        )
        keys = jax.random.split(key, max_bounces + 1)
        return jnp.mean(run_bounces(state, a0, keys), axis=0)

    def one_sample(carry, key):
        keys = jax.random.split(key, max_bounces + 2)
        o0, d0 = origin, directions
        if dof:
            r = jnp.sqrt(jax.random.uniform(keys[-1], shape)) * lens_radius
            # independent angle stream folded from the same key
            phi = jax.random.uniform(
                jax.random.fold_in(keys[-1], 1), shape,
                minval=0.0, maxval=2.0 * np.pi,
            )
            off = (r * jnp.cos(phi))[..., None] * right \
                + (r * jnp.sin(phi))[..., None] * up
            focal = origin + directions * focus_distance
            o0 = jnp.broadcast_to(origin, directions.shape) + off
            d0 = normalize(focal - o0, exact=exact)
            a0 = _attrs_primary(o0, d0)
        else:
            a0 = attrs0
        state = (
            o0,
            d0,
            jnp.ones(shape + (3,), jnp.float32),
            jnp.zeros(shape + (3,), jnp.float32),
            jnp.ones(shape, bool),
        )
        return carry + run_bounces(state, a0, keys), None

    keys = jax.random.split(key, samples)
    # zeros_like(directions) (not a fresh zeros): under shard_map the
    # scan carry must inherit the inputs' varying mesh axes
    total = jnp.zeros_like(directions)
    total, _ = jax.lax.scan(one_sample, total, keys)
    return total / samples


def render_ao(
    scene: SceneArrays,
    origin,
    directions,
    key: jax.Array,
    samples: int = 8,
    radius: float = 1.0,
    backend: str | None = None,
    exact: bool = True,
    normal_mode: str = "reference",
) -> jax.Array:
    """Ambient occlusion: the fraction of the cosine-weighted
    hemisphere above each primary hit that is unoccluded within
    ``radius`` (framework extension — a standard production AOV the
    reference's curand scaffolding, raycast.cu:190-193, anticipates but
    never uses). Miss pixels are fully open (1.0). Returns [H, W] f32
    in [0, 1].

    Occlusion queries are DISTANCE-BOUNDED (hit counts only if
    t < radius), so they use the nearest-hit cast, not the unbounded
    any-hit shadow cast (renderer.occlusion_cast_fn docstring)."""
    cast = get_cast_fn(backend, want_normals=True)
    cast2 = get_cast_fn(backend)
    directions = jnp.asarray(directions, jnp.float32)
    origin = jnp.broadcast_to(jnp.asarray(origin, jnp.float32), directions.shape)
    shape = directions.shape[:-1]

    attrs = hit_attributes(
        scene, origin, directions, cast(scene, origin, directions),
        exact=exact, normal_mode=normal_mode,
    )

    def one_sample(acc, k):
        d = _cosine_sample(k, attrs.normal, exact)
        o, dd = _park(attrs.location + d * SHADOW_EPS, d, attrs.hit)
        occluded = cast2(scene, o, dd).t < radius
        open_frac = jnp.where(attrs.hit, 1.0 - occluded.astype(jnp.float32), 1.0)
        return acc + open_frac, None

    keys = jax.random.split(key, samples)
    total, _ = jax.lax.scan(one_sample, jnp.zeros(shape, jnp.float32), keys)
    return total / samples


def to_u8(radiance: jax.Array) -> jax.Array:
    """Float radiance -> uint8 with the reference's truncating cast
    (raycast.cu:292-294), clamped to the displayable range."""
    return jnp.clip(radiance * 255.0, 0.0, 255.0).astype(jnp.uint8)


def tonemap(radiance: jax.Array, mode: str = "none",
            exposure: float = 1.0) -> jax.Array:
    """HDR -> display mapping ahead of the uint8 cast (framework
    extension; the reference writes linear radiance straight to uchar3,
    raycast.cu:292-294, which clips everything past 1.0).

    ``none``     linear * exposure (exposure=1 is bit-identical to the
                 historical output);
    ``reinhard`` x/(1+x) then sRGB-ish 1/2.2 gamma;
    ``aces``     Narkowicz's ACES filmic fit then 1/2.2 gamma.
    All elementwise math — XLA fuses it into the shading epilogue.
    """
    x = radiance * exposure
    if mode == "none":
        return x
    if mode == "reinhard":
        y = x / (1.0 + x)
    elif mode == "aces":
        y = jnp.clip(
            (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14),
            0.0, 1.0,
        )
    else:
        raise ValueError(f"unknown tonemap mode {mode!r}")
    return jnp.power(jnp.maximum(y, 0.0), 1.0 / 2.2)
