"""Ray/triangle and ray/AABB intersection math, shared by every backend
(brute force, XLA BVH walk; native/traverse.h repeats it operation for
operation in the traversal kernel) so they agree.

Semantics match the reference exactly:
  * two-step triangle test — plane hit point first
    (TrianglePrimitive.hpp:62-79), then barycentric inside test with UV
    interpolation w*uv0 + v*uv1 + u*uv2 (TrianglePrimitive.hpp:151-185).
    NOT Moller-Trumbore, by design: the hit POINT (not t) is what the
    instance transform maps back to world space (raycast.cu:98-104).
  * slab AABB test returning entry distance or +inf
    (BVHTree.hpp:40-54), using the reciprocal direction (Ray.hpp:20) so
    zero components give +/-inf that min/max handle.

All functions broadcast: rays may be [..., 3], triangles [..., 3]; any
mutually broadcastable combination works (e.g. rays [R, 1, 3] against
triangles [1, T, 3] gives [R, T] results).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.vecmath import FLT_MAX, dot

PARALLEL_EPS = jnp.float32(1e-6)
WATERTIGHT_NUDGE = 1e-12  # absolute box out-round, applied in t-space
# Inclusive barycentric bound. Exactly-on-edge rays (axis-aligned
# cameras + vertex rings produce them SYSTEMATICALLY) have u or v == 0
# in exact math, so f32 rounding decides the hit — and rounds
# differently between XLA and nvcc (FMA contraction), and can round
# NEGATIVE on BOTH triangles sharing the edge (a crack). Accepting down
# to -EDGE_EPS (dimensionless — barycentric coords are scale-free)
# moves the accept boundary off the tie point: backends agree and
# shared edges are watertight. The reference's raw u >= 0 test has the
# crack. Magnitude: the f32 computation error of u/v is about
# eps_f32 * |hit point| / edge_length (measured up to ~1e-5 on the
# colonnade's 0.05-unit cylinder facets 5+ units out), so the margin
# must dominate that; 1e-3 of an edge length of world-space overhang is
# far below pixel footprint at any sane resolution.
EDGE_EPS = 1e-3


def ray_plane_hit(origin, direction, tv0, normal):
    """Plane-hit step (TrianglePrimitive.hpp:62-79).

    Returns (t [...], point [..., 3], valid [...]): the ray parameter
    and hit point on the triangle's plane; valid=False where the ray is
    parallel (|denom| < 1e-6) or the hit is behind the origin (t < 0).

    Distance note: because instance object space is reached by a
    rotation (isometry) followed by an inv_scale that the world mapping
    multiplies back out, ``t`` along the object-space direction of a
    unit world ray EQUALS the world-space hit distance the reference
    computes by round-tripping the hit point through the instance
    transform (raycast.cu:98-104) — so ``t`` is used directly as the
    nearest-hit key everywhere.
    """
    denom = dot(direction, normal)
    safe_denom = jnp.where(jnp.abs(denom) < PARALLEL_EPS, jnp.float32(1.0), denom)
    t = dot(tv0 - origin, normal) / safe_denom
    valid = (jnp.abs(denom) >= PARALLEL_EPS) & (t >= 0.0)
    point = origin + t[..., None] * direction
    return t, point, valid


def barycentric_rows(tv0, tv1, tv2):
    """Precompute the AFFINE barycentric row vectors rA, rB such that
    u = rA . (p - v0) and v = rB . (p - v0) for any plane point p.

    Folding the 2x2 Cramer inverse into per-triangle constants removes
    ~8 elementwise ops per (ray, triangle) from every backend's inner test
    relative to the textbook dot00/dot01/... evaluation. Basis matches
    the reference (e0 = C - A, e1 = B - A, TrianglePrimitive.hpp:151-
    177); the row form is algebraically identical, rounded once per
    triangle instead of per ray. All backends (brute oracle, XLA walk,
    traversal kernel via its triangle records) use THESE rows, so they
    agree on u/v."""
    e0 = tv2 - tv0
    e1 = tv1 - tv0
    dot00 = dot(e0, e0)
    dot01 = dot(e0, e1)
    dot11 = dot(e1, e1)
    inv_denom = 1.0 / (dot00 * dot11 - dot01 * dot01)
    ra = (dot11[..., None] * e0 - dot01[..., None] * e1) * inv_denom[..., None]
    rb = (dot00[..., None] * e1 - dot01[..., None] * e0) * inv_denom[..., None]
    return ra, rb


def barycentric_uv(origin, direction, t, tv0, tv1, tv2):
    """Raw barycentric coordinates of the ray's plane point
    (TrianglePrimitive.hpp:151-169). Takes the RAY (origin, direction,
    plane parameter t) rather than the hit point: the local offset is
    evaluated as (origin - v0) + t*d, the form the traversal kernel
    uses (computing p = o + t*d first then p - v0 rounds differently).
    Returns (u, v)."""
    ra, rb = barycentric_rows(tv0, tv1, tv2)
    e2 = (origin - tv0) + t[..., None] * direction
    u = dot(ra, e2)
    v = dot(rb, e2)
    return u, v


def bary_interp(u, v, a0, a1, a2):
    """Barycentric attribute interpolation w*a0 + v*a1 + u*a2 — the
    reference's weight order (TrianglePrimitive.hpp:179): corner 0
    carries w = 1-u-v, corner 1 carries v, corner 2 carries u."""
    w = 1.0 - u - v
    return w[..., None] * a0 + v[..., None] * a1 + u[..., None] * a2


def point_in_triangle_uv(origin, direction, t, tv0, tv1, tv2, uv0, uv1, uv2):
    """Barycentric inside test + UV interpolation
    (TrianglePrimitive.hpp:151-185). Same op order as the pre-split
    form (barycentric_uv + bary_interp), so results are bit-identical.
    Returns (uv [..., 2], inside [...])."""
    u, v = barycentric_uv(origin, direction, t, tv0, tv1, tv2)
    inside = (u >= -EDGE_EPS) & (v >= -EDGE_EPS) & (u + v <= 1.0 + EDGE_EPS)
    return bary_interp(u, v, uv0, uv1, uv2), inside


def ray_aabb_entry(origin, inv_direction, box_min, box_max):
    """Slab test: entry distance to an AABB or +inf on miss
    (BVHTree.hpp:40-54). ``hit = far >= near and far > 0``; a ray whose
    origin is inside returns its (negative) entry distance, like the
    reference.

    Watertightness: the slab numerators are nudged outward by an
    ABSOLUTE 1e-12. A ray lying exactly IN a box boundary plane
    (numerator 0, direction component 0 -> clamped reciprocal ~1e30;
    axis-aligned scenes + cameras hit this systematically) then gets
    -1e18/+1e18 instead of a degenerate [0, 0] slab interval, so it
    correctly counts as inside the slab for all t. For every other ray
    the t shift is <= 1e-12 * |1/d| — immeasurably small — unlike
    geometric box padding, whose t error scales as pad/|d| and was
    measured to cost 62% on axis-aligned scenes via inflated visits."""
    nudge = jnp.float32(WATERTIGHT_NUDGE)
    tmin = (box_min - origin - nudge) * inv_direction
    tmax = (box_max - origin + nudge) * inv_direction
    # fmin/fmax suppress NaN (0 * inf when the origin sits exactly on a
    # box plane with a zero direction component) like the CUDA
    # fminf/fmaxf in the reference slab test — jnp.minimum would
    # propagate the NaN and turn real hits into misses.
    t1 = jnp.fmin(tmin, tmax)
    t2 = jnp.fmax(tmin, tmax)
    far = jnp.min(t2, axis=-1)
    near = jnp.max(t1, axis=-1)
    hit = (far >= near) & (far > 0.0)
    return jnp.where(hit, near, FLT_MAX)


def safe_reciprocal(direction):
    """Componentwise 1/d (Ray.hpp:17-22), with near-zero components
    clamped to +/-1e-30 first so the reciprocal stays FINITE (~1e30).

    The reference's raw 1/d yields +/-inf; when a ray then lies exactly
    IN a box boundary plane (origin coordinate == box bound and d == 0,
    which axis-aligned scenes hit systematically), (bound - o) * inf =
    0 * inf = NaN and the slab test falsely misses. With a finite huge
    inverse, 0 * 1e30 = 0 (on the plane counts as inside) and
    eps * 1e30 is effectively infinity — strictly more watertight than
    the reference, identical everywhere else."""
    tiny = jnp.float32(1e-30)
    d = jnp.where(
        jnp.abs(direction) < tiny,
        jnp.where(direction < 0, -tiny, tiny) + 0.0 * direction,
        direction,
    )
    return 1.0 / d
