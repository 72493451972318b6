"""Vector math primitives for the ray tracer.

Counterpart of the reference's float3 helper library
(reference: CudaRaytracer/utils.hpp:12-160). Everything here operates on
jnp arrays whose last axis is the vector axis (shape ``[..., 3]`` /
``[..., 2]``), so a single call vectorizes over an entire ray batch —
there is no scalar path.

Conventions:
  * dtype is float32 throughout (geometry needs the mantissa).
  * ``FLT_MAX`` mirrors the reference's miss sentinel (CUDA ``FLT_MAX``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

FLT_MAX = jnp.float32(3.4028235e38)


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched dot product over the last axis (utils.hpp:53-55)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched 3-vector cross product (utils.hpp:49-51)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def magnitude(v: jax.Array) -> jax.Array:
    """Euclidean norm over the last axis (utils.hpp:29-35)."""
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def q_rsqrt(x: jax.Array) -> jax.Array:
    """Bit-exact emulation of the fast inverse square root.

    The reference normalizes every vector with the Quake ``Q_rsqrt``
    trick — one Newton iteration off the 0x5f3759df magic constant
    (utils.hpp:12-27). Its output differs from a true rsqrt in the 3rd
    decimal, which is visible in pixel-exact comparisons, so we provide
    the identical computation (the int32 bitcast is free).
    """
    x = jnp.asarray(x, jnp.float32)
    i = jax.lax.bitcast_convert_type(x, jnp.int32)
    i = jnp.int32(0x5F3759DF) - (i >> 1)
    y = jax.lax.bitcast_convert_type(i, jnp.float32)
    return y * (jnp.float32(1.5) - (x * jnp.float32(0.5)) * y * y)


def normalize(v: jax.Array, *, exact: bool = True) -> jax.Array:
    """Normalize over the last axis.

    ``exact=True`` uses the hardware rsqrt (better quality, default);
    ``exact=False`` reproduces the reference's ``Q_rsqrt`` normalize
    (utils.hpp:41-47) for pixel-matching runs.
    """
    sq = jnp.sum(v * v, axis=-1, keepdims=True)
    if exact:
        inv = jax.lax.rsqrt(sq)
    else:
        inv = q_rsqrt(sq)
    return v * inv


def apply_mat3(m: jax.Array, v: jax.Array) -> jax.Array:
    """Apply a 3x3 matrix (or batch thereof) to vectors: ``m @ v``.

    Mirrors ``apply_matrix(float3x3, float3)`` (utils.hpp:134-140).
    ``m`` is ``[..., 3, 3]``, ``v`` is ``[..., 3]``. Written as explicit
    multiply-adds (not dot_general) so precision never silently degrades
    to bf16 or TF32 under a backend's default matmul precision.
    """
    return jnp.sum(m * v[..., None, :], axis=-1)


def invert_intrinsic(K) -> jax.Array:
    """Closed-form inverse of a pinhole intrinsic matrix (utils.hpp:142-160).

    Assumes zero skew: K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]].
    """
    K = jnp.asarray(K, jnp.float32)
    fx_inv = 1.0 / K[0, 0]
    fy_inv = 1.0 / K[1, 1]
    cx = K[0, 2]
    cy = K[1, 2]
    return jnp.array(
        [
            [fx_inv, 0.0, -cx * fx_inv],
            [0.0, fy_inv, -cy * fy_inv],
            [0.0, 0.0, 1.0],
        ],
        jnp.float32,
    )
