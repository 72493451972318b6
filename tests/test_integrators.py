"""Whitted reflection + path tracing integrator tests (BASELINE
configs 4 and 5)."""

import jax
import numpy as np

from tpu_raytracer.render import Camera, generate_rays
from tpu_raytracer.render.integrators import (
    PointLight,
    render_path_traced,
    render_whitted,
    to_u8,
)
from tpu_raytracer.scene import (
    Material,
    MeshInstance,
    MeshPrimitive,
    Scene,
    procgen,
)


def cornell_scene(mirror=False):
    scene = Scene()
    white = scene.add_material(Material(albedo=(0.9, 0.9, 0.9)))
    red = scene.add_material(Material(albedo=(0.1, 0.1, 0.9)))
    green = scene.add_material(Material(albedo=(0.1, 0.9, 0.1)))
    mirror_mat = scene.add_material(
        Material(albedo=(0.95, 0.95, 0.95), reflectivity=0.8 if mirror else 0.0)
    )
    walls = procgen.cornell_box()
    mats = {"floor": white, "ceiling": white, "back": white, "left": red, "right": green}
    for name, tris in walls.items():
        mesh = MeshPrimitive.from_triangles(tris[:, 0], tris[:, 1], tris[:, 2])
        mid = scene.add_mesh(mesh)
        scene.add_mesh_instance(MeshInstance(mid, mats[name]))
    # a cube in the box, mirror-able
    from tpu_raytracer.scene import objloader

    cube = objloader.loads(procgen.cube_obj(0.6))
    cid = scene.add_mesh(cube)
    inst = MeshInstance(cid, mirror_mat)
    inst.pose = np.array([1.0, 1.2, 0.3, 0.4, 0, 0], np.float32)
    scene.add_mesh_instance(inst)
    cam = Camera.looking(48, 48, fov_deg=70.0, pose=[1.0, -0.8, 1.0, 0, 0, 0])
    return scene.compile(), cam


def _rays(cam):
    p = cam.ray_params()
    return generate_rays(
        cam.width, cam.height, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
    )


def test_whitted_zero_bounces_matches_structure():
    arrays, cam = cornell_scene(mirror=False)
    o, d = _rays(cam)
    img = np.asarray(to_u8(render_whitted(arrays, o, d, max_bounces=0)))
    assert img.shape == (48, 48, 3)
    # enclosed box: every ray hits something
    assert (img != np.array([255, 204, 153])).any(-1).all()


def test_whitted_mirror_changes_cube_pixels():
    arrays_flat, cam = cornell_scene(mirror=False)
    arrays_mirror, _ = cornell_scene(mirror=True)
    o, d = _rays(cam)
    img_flat = np.asarray(to_u8(render_whitted(arrays_flat, o, d, max_bounces=2)))
    img_mirror = np.asarray(to_u8(render_whitted(arrays_mirror, o, d, max_bounces=2)))
    changed = (img_flat != img_mirror).any(-1).mean()
    assert changed > 0.01, f"mirror changed only {changed:.3%} of pixels"


def test_whitted_point_light_shadowing():
    arrays, cam = cornell_scene(mirror=False)
    o, d = _rays(cam)
    lit = np.asarray(
        render_whitted(
            arrays, o, d, max_bounces=0, light_direction=None,
            point_lights=(PointLight((1.0, 1.0, 1.8), 2.0),), shadows=False,
        )
    )
    shadowed = np.asarray(
        render_whitted(
            arrays, o, d, max_bounces=0, light_direction=None,
            point_lights=(PointLight((1.0, 1.0, 1.8), 2.0),), shadows=True,
        )
    )
    # shadows only remove light
    assert (shadowed <= lit + 1e-5).all()
    assert (shadowed < lit - 1e-3).any(), "no pixel actually shadowed"


def test_path_tracer_runs_and_converges_sanely():
    arrays, cam = cornell_scene(mirror=False)
    o, d = _rays(cam)
    key = jax.random.PRNGKey(0)
    img = np.asarray(
        render_path_traced(arrays, o, d, key, max_bounces=2, samples=2)
    )
    assert img.shape == (48, 48, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.01  # light reaches the film
    # left wall red-ish vs right wall green-ish tint in channel space
    left = img[:, :5].mean(axis=(0, 1))
    right = img[:, -5:].mean(axis=(0, 1))
    assert left[2] / (left[1] + 1e-6) > right[2] / (right[1] + 1e-6)


def test_occlusion_shadow_cast_matches_nearest(monkeypatch):
    """ANY-HIT shadow casts (the traversal kernel stops a shadow ray at
    its first accepted hit) produce the exact same shadow booleans —
    whitted images bit-match nearest-hit shadow casts through the same
    kernel."""
    from tpu_raytracer.render import integrators
    from tpu_raytracer.render.renderer import get_cast_fn

    arrays, cam = cornell_scene(mirror=True)
    o, d = _rays(cam)
    on = np.asarray(render_whitted(arrays, o, d, max_bounces=1,
                                   backend="cuda"))
    monkeypatch.setattr(integrators, "occlusion_cast_fn",
                        lambda backend: get_cast_fn(backend))
    off = np.asarray(render_whitted(arrays, o, d, max_bounces=1,
                                    backend="cuda"))
    np.testing.assert_array_equal(on, off)


def test_path_fast_tail_bit_exact(monkeypatch):
    """With no emissive materials (and no NEE) the path tracer's FINAL
    bounce collapses to the ANY-HIT occlusion cast (integrators.py
    fast_tail): the image must bit-match the nearest-hit tail through
    the traversal kernel — hit-vs-miss is decided by the same
    intersection predicate either way."""
    arrays, cam = cornell_scene(mirror=True)
    assert not arrays.has_emissive
    o, d = _rays(cam)
    key = jax.random.PRNGKey(7)
    monkeypatch.setenv("TRT_PATH_TAIL", "0")
    base = np.asarray(render_path_traced(
        arrays, o, d, key, max_bounces=2, samples=1, backend="cuda"))
    monkeypatch.setenv("TRT_PATH_TAIL", "1")
    fast = np.asarray(render_path_traced(
        arrays, o, d, key, max_bounces=2, samples=1, backend="cuda"))
    np.testing.assert_array_equal(fast, base)


def test_path_fast_tail_emissive_gate():
    """Scenes with emissive materials keep the nearest-hit tail: the
    static has_emissive flag gates the rewrite at trace time (final-
    bounce emission needs the nearest hit's material)."""
    scene = Scene()
    scene.add_material(Material(albedo=(0.9, 0.9, 0.9), illumination=0.8))
    v0, v1, v2 = procgen.blob(subdivisions=2)
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2))
    scene.add_mesh_instance(MeshInstance(0, 0))
    arrays = scene.compile()
    assert arrays.has_emissive


def test_path_sample_batch_statistics_and_exactness(monkeypatch):
    """The default sample-batched wavefront runs all S samples as one
    (S,)+shape pool (S times fewer, wider casts);
    TRT_PATH_SAMPLE_BATCH=0 falls back to the per-sample scan.
    Different random stream — images agree statistically, not bitwise —
    but within a mode the estimator is deterministic and
    backend-independent: batched bvh == batched brute bit-for-bit."""
    arrays, cam = cornell_scene(mirror=True)
    o, d = _rays(cam)
    key = jax.random.PRNGKey(3)
    batched = np.asarray(render_path_traced(
        arrays, o, d, key, max_bounces=2, samples=8, backend="bvh"))
    batched_brute = np.asarray(render_path_traced(
        arrays, o, d, key, max_bounces=2, samples=8, backend="brute"))
    np.testing.assert_array_equal(batched, batched_brute)
    monkeypatch.setenv("TRT_PATH_SAMPLE_BATCH", "0")
    scan = np.asarray(render_path_traced(
        arrays, o, d, key, max_bounces=2, samples=8, backend="bvh"))
    # same estimator: image means agree to sample noise at 8 spp
    assert abs(scan.mean() - batched.mean()) < 0.02
    assert np.isfinite(batched).all()
