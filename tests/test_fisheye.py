"""Fisheye distortion with the reference's REAL calibration (D != 0).

The reference's default demo runs an actual fisheye camera through the
Kannala-Brandt polynomial (kernel.cu:158-164 calibration values;
raycast.cu:165-177 thetad chain). Everything else in the suite runs
D = 0, so these tests pin the distortion path itself: an analytic
thetad spot check against the raygen output, and brute-vs-BVH-vs-kernel
agreement under distorted raygen.
"""

import numpy as np
import pytest

from tpu_raytracer.core import transforms as T
from tpu_raytracer.render import Camera, render
from tpu_raytracer.render.camera import (
    REFERENCE_D,
    REFERENCE_K,
    generate_rays,
    reference_calibration,
)
from tpu_raytracer.scene import (
    Material,
    MeshInstance,
    Scene,
    objloader,
    procgen,
)


def _expected_thetad(x, y, K, D):
    """The reference chain (raycast.cu:159-177) in float32 numpy."""
    K = np.asarray(K, np.float32)
    D = np.asarray(D, np.float32)
    K_inv = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    ph = np.array([x, y, 1.0], np.float32)
    d = (K_inv.astype(np.float64) @ ph.astype(np.float64)).astype(np.float32)
    radius = np.float32(np.sqrt(d[0] * d[0] + d[1] * d[1]))
    theta = np.float32(np.arctan(radius))
    thetad = theta * (
        1.0 + D[0] * theta + D[1] * theta**2
        + D[2] * theta**3 + D[3] * theta**4
    )
    return np.float32(thetad)


def test_thetad_analytic_spot_check():
    """With the identity pose, the angle between a pixel's world ray and
    the camera forward axis (+y after the y-forward swap) is
    atan(thetad): direction pre-normalize is [s*a, s*b, 1] with
    s*radius = thetad, so tan(angle off +z) = thetad exactly."""
    cam = Camera(1920, 1080, REFERENCE_K, REFERENCE_D)
    p = cam.ray_params()
    origin, dirs = generate_rays(
        1920, 1080, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
    )
    dirs = np.asarray(dirs)
    for (px, py) in [(0, 0), (1919, 1079), (300, 900), (998, 570)]:
        d = dirs[py, px]
        # forward = +y (world); lateral = (x, z) plane
        lateral = np.sqrt(d[0] ** 2 + d[2] ** 2)
        measured = np.arctan2(lateral, d[1])
        expected = np.arctan(_expected_thetad(px, py, REFERENCE_K, REFERENCE_D))
        assert abs(measured - expected) < 2e-6, (px, py, measured, expected)
        assert np.isclose(np.linalg.norm(d), 1.0, atol=1e-6)


def test_distortion_actually_bends_rays():
    """D != 0 must change directions vs D = 0 (the polynomial is live,
    not dead code): at the image corner theta ~ 0.86 rad, where the
    reference D shifts thetad by ~1.4%."""
    cam_d = Camera(1920, 1080, REFERENCE_K, REFERENCE_D)
    cam_0 = Camera(1920, 1080, REFERENCE_K, np.zeros(4, np.float32))
    pd, p0 = cam_d.ray_params(), cam_0.ray_params()
    _, dirs_d = generate_rays(1920, 1080, pd["K_inv"], pd["D"], pd["pose"], pd["inv_pose"])
    _, dirs_0 = generate_rays(1920, 1080, p0["K_inv"], p0["D"], p0["pose"], p0["inv_pose"])
    corner_angle = np.arccos(
        np.clip(np.dot(np.asarray(dirs_d[0, 0]), np.asarray(dirs_0[0, 0])), -1, 1)
    )
    assert corner_angle > 5e-3, corner_angle
    # center pixel is (nearly) undistorted: theta ~ 0
    cx, cy = 998, 570
    center_angle = np.arccos(
        np.clip(np.dot(np.asarray(dirs_d[cy, cx]), np.asarray(dirs_0[cy, cx])), -1, 1)
    )
    # (998, 570) sits ~0.2px off the principal point, so theta ~ 2e-4
    # and the distortion shift is O(theta^2) ~ tiny but nonzero
    assert center_angle < 1e-3, center_angle
    assert center_angle < corner_angle / 5


def _calib_scene(size=64):
    """Textured cube + posed board under the rescaled real calibration:
    distorted raygen feeding the full BVH + shading pipeline."""
    scene = Scene()
    mat = Material()
    mat.set_texture(procgen.checkerboard_texture(64, 8))
    scene.add_material(mat)
    scene.add_material(Material(albedo=(0.2, 0.7, 0.3)))
    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    scene.add_mesh(objloader.loads(procgen.board_obj()))
    scene.add_mesh_instance(MeshInstance(0, 0))
    board = MeshInstance(1, 1)
    board.pose = np.array([-0.6, 1.48, 0.73, 0.0, 0.0, 0.2], np.float32)
    scene.add_mesh_instance(board)
    K, D = reference_calibration(size, size)
    cam = Camera(size, size, K, D)
    cam.pose = np.array([-0.2, -2.6, 0.3, 0.0, 0.0, 0.0], np.float32)
    return scene.compile(), cam


def test_bvh_matches_brute_with_real_distortion():
    arrays, cam = _calib_scene(64)
    img_brute = np.asarray(render(cam, arrays, backend="brute"))
    img_bvh = np.asarray(render(cam, arrays, backend="bvh"))
    np.testing.assert_array_equal(img_bvh, img_brute)
    # the distorted frame must actually see geometry
    hit = (img_brute != img_brute[0, 0]).any(-1).mean()
    assert hit > 0.05, hit


def test_kernel_matches_brute_with_real_distortion():
    """The traversal kernel (its host build here) under distorted
    fisheye raygen, held to the oracle's image tolerance."""
    from tpu_raytracer.oracle import image_agreement

    arrays, cam = _calib_scene(64)
    img_brute = np.asarray(render(cam, arrays, backend="brute"))
    img_kernel = np.asarray(render(cam, arrays, backend="cuda"))
    agree = image_agreement(img_kernel, img_brute)
    assert agree["ok"], agree


def test_reference_calibration_exact_at_native_resolution():
    K, D = reference_calibration(1920, 1080)
    np.testing.assert_array_equal(K, REFERENCE_K)
    np.testing.assert_array_equal(D, REFERENCE_D)
    # rescale: fx/cx by width ratio, fy/cy by height ratio
    K2, _ = reference_calibration(960, 540)
    np.testing.assert_allclose(K2[0, 0], REFERENCE_K[0, 0] / 2, rtol=1e-6)
    np.testing.assert_allclose(K2[1, 2], REFERENCE_K[1, 2] / 2, rtol=1e-6)
    assert K2[2, 2] == 1.0
