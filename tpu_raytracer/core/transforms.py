"""6-DoF pose ("lre") library — counterpart of the reference's
transform stack (reference: CudaRaytracer/transforms.hpp:8-299).

A pose is a plain float32 array of shape ``[..., 6]`` holding
``(x, y, z, yaw, pitch, roll)`` — the reference's ``lre`` struct
(transforms.hpp:10-14) as a batchable pytree leaf. All functions
vectorize over leading axes and are jit/vmap/grad-safe.

Semantics preserved exactly from the reference:
  * ``apply_lre(pose, v) = R(euler) @ (v - pose.xyz)`` — a pose maps
    world-space points INTO its local frame (transforms.hpp:223-226).
  * Euler order/convention matches ``euler2rotmat`` (transforms.hpp:129-144)
    and the quaternion path ``euler2quat``/``apply_quat``
    (transforms.hpp:148-176); the two agree and we test that.
  * ``compose_homo(H1, H2) = H2 @ H1`` (transforms.hpp:113-116).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .vecmath import apply_mat3

# ---------------------------------------------------------------------------
# Pose constructors / accessors
# ---------------------------------------------------------------------------


def pose(x=0.0, y=0.0, z=0.0, yaw=0.0, pitch=0.0, roll=0.0) -> jax.Array:
    """Build an lre pose array (transforms.hpp:10-14)."""
    return jnp.array([x, y, z, yaw, pitch, roll], jnp.float32)


def pose_xyz(p: jax.Array) -> jax.Array:
    return p[..., 0:3]


def pose_euler(p: jax.Array) -> jax.Array:
    """(yaw, pitch, roll) triple of a pose."""
    return p[..., 3:6]


# ---------------------------------------------------------------------------
# Euler <-> rotation matrix <-> quaternion
# ---------------------------------------------------------------------------


def euler2rotmat(euler: jax.Array) -> jax.Array:
    """Euler (yaw, pitch, roll) -> 3x3 rotation (transforms.hpp:129-144)."""
    sy, cy = jnp.sin(euler[..., 0]), jnp.cos(euler[..., 0])
    sp, cp = jnp.sin(euler[..., 1]), jnp.cos(euler[..., 1])
    sr, cr = jnp.sin(euler[..., 2]), jnp.cos(euler[..., 2])
    row0 = jnp.stack([cr * cy + sr * sp * sy, -cr * sy + sr * sp * cy, -sr * cp], -1)
    row1 = jnp.stack([cp * sy, cp * cy, sp], -1)
    row2 = jnp.stack([sr * cy - cr * sp * sy, -sr * sy - cr * sp * cy, cr * cp], -1)
    return jnp.stack([row0, row1, row2], axis=-2)


def rotmat2euler(rotmat: jax.Array) -> jax.Array:
    """3x3 rotation -> euler (yaw, pitch, roll) (transforms.hpp:119-126)."""
    a = jnp.clip(rotmat[..., 1, 2], -1.0, 1.0)
    yaw = jnp.arctan2(rotmat[..., 1, 0], rotmat[..., 1, 1])
    pitch = jnp.arcsin(a)
    roll = jnp.arctan2(-rotmat[..., 0, 2], rotmat[..., 2, 2])
    return jnp.stack([yaw, pitch, roll], axis=-1)


def invert_rotmat(rotmat: jax.Array) -> jax.Array:
    """Rotation inverse = transpose (transforms.hpp:55-61)."""
    return jnp.swapaxes(rotmat, -1, -2)


def euler2quat(euler: jax.Array) -> jax.Array:
    """Euler -> quaternion with the reference's (w, x, y, z) component
    layout and sign convention (transforms.hpp:148-163)."""
    sy, cy = jnp.sin(euler[..., 0] * 0.5), jnp.cos(euler[..., 0] * 0.5)
    sp, cp = jnp.sin(euler[..., 1] * 0.5), jnp.cos(euler[..., 1] * 0.5)
    sr, cr = jnp.sin(euler[..., 2] * 0.5), jnp.cos(euler[..., 2] * 0.5)
    return jnp.stack(
        [
            sy * sp * sr + cy * cp * cr,
            cy * sp * cr + sy * cp * sr,
            -sy * sp * cr + cy * cp * sr,
            cy * sp * sr - sy * cp * cr,
        ],
        axis=-1,
    )


def apply_quat(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vectors by a quaternion, q stored as (w, x, y, z) in
    components (0, 1, 2, 3) — matches transforms.hpp:165-176 where the
    struct fields (x, y, z, w) hold (w, x, y, z) respectively."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    a = -vx * qx - vy * qy - vz * qz
    b = vx * qw + vy * qz - vz * qy
    c = vy * qw + vz * qx - vx * qz
    d = vz * qw + vx * qy - vy * qx
    return jnp.stack(
        [
            qw * b - qx * a - qy * d + qz * c,
            qw * c - qy * a - qz * b + qx * d,
            qw * d - qz * a - qx * c + qy * b,
        ],
        axis=-1,
    )


def apply_euler(euler: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate by euler angles via the quaternion path (transforms.hpp:219-221)."""
    return apply_quat(euler2quat(euler), v)


# ---------------------------------------------------------------------------
# lre <-> homogeneous 4x4
# ---------------------------------------------------------------------------


def lre2homo(p: jax.Array) -> jax.Array:
    """Pose -> 4x4 homogeneous transform H with H @ [v;1] = R(v - t)
    (transforms.hpp:178-193)."""
    R = euler2rotmat(pose_euler(p))
    shift = -pose_xyz(p)
    rot_shift = apply_mat3(R, shift)
    top = jnp.concatenate([R, rot_shift[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def homo2lre(H: jax.Array) -> jax.Array:
    """4x4 homogeneous -> pose (transforms.hpp:195-216)."""
    R = H[..., 0:3, 0:3]
    euler = rotmat2euler(R)
    shift = H[..., 0:3, 3]
    shift = apply_mat3(invert_rotmat(R), shift)
    return jnp.concatenate([-shift, euler], axis=-1)


def invert_homo(H: jax.Array) -> jax.Array:
    """Invert a rigid homogeneous transform (transforms.hpp:72-96)."""
    R_inv = invert_rotmat(H[..., 0:3, 0:3])
    t_inv = apply_mat3(R_inv, -H[..., 0:3, 3])
    top = jnp.concatenate([R_inv, t_inv[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def compose_homo(H1: jax.Array, H2: jax.Array) -> jax.Array:
    """Compose transforms: H2 @ H1 (transforms.hpp:113-116).

    Uses ``precision='highest'`` — geometry composition must stay f32
    even where the backend's default contraction precision is lower.
    """
    return jnp.matmul(H2, H1, precision="highest")


# ---------------------------------------------------------------------------
# Pose application / composition
# ---------------------------------------------------------------------------


def apply_lre(p: jax.Array, v: jax.Array) -> jax.Array:
    """Map world points into the pose's local frame:
    R(euler) @ (v - xyz) (transforms.hpp:223-226). Broadcasts a single
    pose over a batch of points and vice versa."""
    return apply_euler(pose_euler(p), v - pose_xyz(p))


def compose_lre(p1: jax.Array, p2: jax.Array) -> jax.Array:
    """Pose composition via homogeneous matrices (transforms.hpp:228-230)."""
    return homo2lre(compose_homo(lre2homo(p1), lre2homo(p2)))


def invert_lre(p: jax.Array) -> jax.Array:
    """Pose inverse via homogeneous matrices (transforms.hpp:232-235)."""
    return homo2lre(invert_homo(lre2homo(p)))
