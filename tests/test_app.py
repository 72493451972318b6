"""App-layer tests: staged scenes, camera controls, demo driver."""

import numpy as np

from tpu_raytracer.app import controls, scenes
from tpu_raytracer.core import transforms as T
from tpu_raytracer.render import RenderConfig, render_image
from tpu_raytracer.render.shade import SKY_COLOR


def test_scene_cube_renders():
    arrays, cam = scenes.scene_cube(64)
    p = cam.ray_params()
    config = RenderConfig(width=64, height=64, backend="bvh")
    img = np.asarray(
        render_image(config, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    )
    hit = (img != np.asarray(SKY_COLOR, np.uint8)).any(-1)
    assert 0.02 < hit.mean() < 0.9


def test_scene_cornell_encloses_camera():
    arrays, cam = scenes.scene_cornell(32)
    p = cam.ray_params()
    config = RenderConfig(width=32, height=32, backend="bvh",
                          lighting="lambert_shadow")
    img = np.asarray(
        render_image(config, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    )
    # enclosed box: every ray hits geometry
    assert (img != np.asarray(SKY_COLOR, np.uint8)).any(-1).all()


def test_scene_instances_compiles():
    arrays, cam = scenes.scene_instances(32, 32)
    assert arrays.num_instances == 4
    assert float(np.asarray(arrays.mat_reflectivity).max()) > 0


def test_scene_colonnade_is_sponza_class():
    arrays, cam = scenes.scene_colonnade(64, 64)
    assert arrays.num_triangles > 250_000
    assert int(np.asarray(arrays.node_leaf_count).max()) < 1024


def test_point_light_end_to_end():
    """Point lights reach the app surface: a point
    light inside the Cornell box lights the scene with hard shadows via
    the public RenderConfig + whitted pipeline (raycast.cu:286-287)."""
    from tpu_raytracer.render.integrators import PointLight
    from tpu_raytracer.render.pipeline import render_image_whitted

    arrays, cam = scenes.scene_cornell(64)
    p = cam.ray_params()
    base = dict(width=64, height=64, backend="bvh", light_direction=None)
    lit_cfg = RenderConfig(
        **base, point_lights=(PointLight(position=(1.0, 0.2, 1.6),
                                         intensity=6.0),),
    )
    dark_cfg = RenderConfig(**base)
    args = (arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    lit = np.asarray(render_image_whitted(lit_cfg, *args, 0))
    dark = np.asarray(render_image_whitted(dark_cfg, *args, 0))
    # the light brightens the scene above the 0.4-ambient floor...
    assert lit.astype(int).sum() > dark.astype(int).sum() * 1.05
    # ...and the occluding box casts a hard shadow: some pixels stay at
    # the ambient floor while their neighbors are lit
    assert (lit.astype(int) - dark.astype(int)).max() > 30


def test_point_light_primary_mode():
    """lambert_shadow primary shading also honors config.point_lights."""
    from tpu_raytracer.render.integrators import PointLight

    arrays, cam = scenes.scene_cornell(32)
    p = cam.ray_params()
    args = (arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    base = dict(width=32, height=32, backend="bvh",
                lighting="lambert_shadow", light_direction=None)
    lit_cfg = RenderConfig(
        **base, point_lights=(PointLight(position=(1.0, 0.2, 1.6),
                                         intensity=6.0),),
    )
    lit = np.asarray(render_image(lit_cfg, *args))
    dark = np.asarray(render_image(RenderConfig(**base), *args))
    assert lit.astype(int).sum() > dark.astype(int).sum()


def test_orbit_matches_reference_semantics():
    pose = np.zeros(6, np.float32)
    p2 = controls.orbit(pose, dx=100, dy=50)
    np.testing.assert_allclose(p2[3], 0.1, atol=1e-6)
    np.testing.assert_allclose(p2[4], -0.05, atol=1e-6)


def test_fly_moves_along_camera_axes():
    pose = np.array([1.0, 2.0, 3.0, 0, 0, 0], np.float32)
    p2 = controls.fly(pose, forward=0.5)
    np.testing.assert_allclose(p2[0:3], [1.0, 2.5, 3.0], atol=1e-5)
    # with yaw, forward is rotated
    pose_yaw = np.array([0, 0, 0, np.pi / 2, 0, 0], np.float32)
    p3 = controls.fly(pose_yaw, forward=1.0)
    np.testing.assert_allclose(p3[0:3], [1.0, 0.0, 0.0], atol=1e-5)


def test_fly_through_generates_poses():
    poses = list(controls.fly_through(np.zeros(6, np.float32), 5))
    assert len(poses) == 5
    assert poses[-1][1] > poses[0][1] - 1e-6  # moved forward-ish


def test_interactive_scripted_loop(tmp_path):
    """The interactive event loop (app/interactive.py) in headless
    scripted mode: keys drive the camera between frames (the
    reference's disabled WASD/orbit path, kernel.cu:51-139) and the
    loop exits cleanly on 'x'."""
    from tpu_raytracer.app import interactive

    out = str(tmp_path / "shot.png")
    img = interactive.run_interactive(
        scene_name="cube", width=32, height=32, backend="brute",
        keys=iter("wwjpx"), out=out,
    )
    assert img is not None and img.shape == (32, 32, 3)
    import os
    assert os.path.exists(out)


def test_interactive_progressive_path_mode(tmp_path):
    """Viewer path mode accumulates one sample per frame on a still
    camera ('z' is unmapped, so the pose never changes and the
    accumulator never resets) and returns a tonemapped u8 frame."""
    from tpu_raytracer.app import interactive

    out = str(tmp_path / "progressive.png")
    img = interactive.run_interactive(
        scene_name="cube", width=32, height=32, backend="brute",
        keys=iter("zz"), mode="path", bounces=1, out=out,
    )
    assert img is not None and img.shape == (32, 32, 3)
    assert img.dtype == np.uint8
    assert img.std() > 0  # actually rendered something


def test_interactive_apply_key_pure():
    from tpu_raytracer.app.interactive import apply_key

    pose = np.zeros(6, np.float32)
    fwd, act = apply_key(pose, "w", speed=0.5)
    assert act is None and abs(fwd[1] - 0.5) < 1e-6  # y-forward
    turned, _ = apply_key(pose, "l")
    assert turned[3] > 0  # yaw+
    _, act = apply_key(pose, "x")
    assert act == "quit"


def test_ansi_preview_shape():
    from tpu_raytracer.app.interactive import ansi_preview

    img = np.zeros((64, 64, 3), np.uint8)
    img[:32] = (255, 0, 0)
    s = ansi_preview(img, cols=16)
    lines = s.split("\n")
    assert len(lines) == 8  # 16 preview rows (cols * h/w), two per line
    assert "38;2;255;0;0" in lines[0] and "38;2;0;0;0" in lines[-1]
