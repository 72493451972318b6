"""Camera model + primary ray generation.

Counterpart of the reference Camera (Camera.h:10-30, Camera.cu:1-41) and
the ray-generation prologue of the render megakernel
(raycast.cu:156-188). The exact back-projection chain is preserved:

  pixel (x, y, 1) -> K_inv -> Kannala-Brandt fisheye distortion
  thetad = theta * (1 + D1*t + D2*t^2 + D3*t^3 + D4*t^4) applied as a
  radial scale -> normalize -> axis swap to y-forward/z-up world
  (x, z, -y) -> rotate by the inverse camera pose euler -> normalize.

With D = 0 this is an equidistant fisheye (thetad = atan(r)), exactly
like the reference running with zero distortion coefficients.

Ray generation is pure jnp over the whole pixel grid — one fused
elementwise stage, no per-pixel anything.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core import transforms as T
from ..core.vecmath import apply_mat3, invert_intrinsic, normalize


def default_intrinsics(width: int, height: int, fov_deg: float = 60.0):
    """Convenience pinhole-ish K for procedural scenes. The focal length
    is chosen so the horizontal FOV after the equidistant fisheye
    mapping is ~fov_deg."""
    theta_half = np.deg2rad(fov_deg) / 2.0
    r_half = np.tan(theta_half)  # K_inv radius at the image edge
    f = (width / 2.0) / r_half
    return np.array(
        [[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]],
        np.float32,
    )


#: The reference app's real fisheye calibration (kernel.cu:158-164):
#: a 1920x1080 Kannala-Brandt camera with nonzero distortion — the one
#: workload that exercises the full thetad polynomial (raycast.cu:165-177).
REFERENCE_K = np.array(
    [[862.097835972576, 0.0, 998.1702383680802],
     [0.0, 862.1368447300727, 569.6759403225842],
     [0.0, 0.0, 1.0]],
    np.float32,
)
REFERENCE_D = np.array(
    [0.016233999489849514, -0.013875757716177956,
     0.03264329940126211, -0.019561619947134234],
    np.float32,
)
REFERENCE_CALIB_SIZE = (1920, 1080)


def reference_calibration(width: int = 1920, height: int = 1080):
    """The reference's real fisheye K/D (kernel.cu:158-164), with K
    rescaled from its native 1920x1080 to ``width x height`` (fx/cx by
    the width ratio, fy/cy by the height ratio — D is resolution
    independent, it acts on normalized K_inv coordinates). At the native
    resolution this is bit-identical to the reference's literals."""
    rw = width / REFERENCE_CALIB_SIZE[0]
    rh = height / REFERENCE_CALIB_SIZE[1]
    K = REFERENCE_K * np.array(
        [[rw, 1.0, rw], [1.0, rh, rh], [1.0, 1.0, 1.0]], np.float64
    )
    return K.astype(np.float32), REFERENCE_D.copy()


@dataclasses.dataclass
class Camera:
    """Host-side camera (Camera.h:10-30). ``pose`` is an lre array; it is
    a per-frame argument to the jitted renderer, so animating the camera
    never recompiles (the analog of pose being a kernel argument,
    Camera.cu:29-31)."""

    width: int
    height: int
    K: np.ndarray
    D: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(4, np.float32))
    pose: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(6, np.float32))

    def __post_init__(self):
        self.K = np.asarray(self.K, np.float32).reshape(3, 3)
        self.D = np.asarray(self.D, np.float32).reshape(4)
        self.pose = np.asarray(self.pose, np.float32).reshape(6)
        self.K_inv = np.asarray(invert_intrinsic(self.K))

    @classmethod
    def looking(cls, width: int, height: int, fov_deg: float = 60.0, pose=None):
        cam = cls(width, height, default_intrinsics(width, height, fov_deg))
        if pose is not None:
            cam.pose = np.asarray(pose, np.float32).reshape(6)
        return cam

    def ray_params(self) -> dict:
        """The per-frame scalars handed to the jitted render step: the
        host-side invert_lre per call matches Camera.cu:21."""
        pose = jnp.asarray(self.pose)
        return {
            "K_inv": jnp.asarray(self.K_inv),
            "D": jnp.asarray(self.D),
            "pose": pose,
            "inv_pose": T.invert_lre(pose),
        }


def generate_rays(
    width: int,
    height: int,
    K_inv: jax.Array,
    D: jax.Array,
    pose: jax.Array,
    inv_pose: jax.Array,
    exact: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Primary rays for the full image (raycast.cu:156-188).

    Returns (origin [3], directions [H, W, 3]). Directions follow the
    reference bit by bit: K_inv backprojection of integer pixel centers
    (x, y, 1), fisheye radial scale, normalize, (x, z, -y) swap, inverse
    camera rotation, renormalize.
    """
    x = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1)
    y = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0)
    ph = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
    direction = apply_mat3(K_inv, ph)

    a = direction[..., 0]
    b = direction[..., 1]
    radius = jnp.sqrt(a * a + b * b)
    theta = jnp.arctan(radius)
    thetad = theta * (
        1.0
        + D[0] * theta
        + D[1] * theta**2
        + D[2] * theta**3
        + D[3] * theta**4
    )
    # Reference computes thetad/radius unguarded (raycast.cu:174); guard
    # the radius=0 center pixel (scale -> 1 in the limit).
    scale = jnp.where(radius > 0.0, thetad / jnp.where(radius > 0.0, radius, 1.0), 1.0)
    direction = jnp.stack([scale * a, scale * b, direction[..., 2]], axis=-1)
    direction = normalize(direction, exact=exact)

    # Rotate 90 deg: y forward, z up in world space (raycast.cu:181-182)
    direction = jnp.stack(
        [direction[..., 0], direction[..., 2], -direction[..., 1]], axis=-1
    )
    direction = T.apply_euler(T.pose_euler(inv_pose), direction)
    direction = normalize(direction, exact=exact)

    origin = T.pose_xyz(pose)
    return origin, direction
