"""End-to-end render tests: the minimum slice (BASELINE config 1), the
brute-force-vs-BVH oracle (SURVEY.md §4 item 5), and shading semantics."""

import numpy as np
import pytest

from tpu_raytracer.oracle import cube_scene, sphere_scene
from tpu_raytracer.render import Camera, RenderConfig, render
from tpu_raytracer.render.renderer import cast_rays_brute, cast_rays_bvh
from tpu_raytracer.render.shade import SKY_COLOR
from tpu_raytracer.scene import (
    Material,
    MeshInstance,
    MeshPrimitive,
    Scene,
    objloader,
    procgen,
)


def test_cube_render_hits_center_misses_corners():
    arrays, cam = cube_scene()
    img = np.asarray(render(cam, arrays, backend="brute"))
    assert img.shape == (64, 64, 3)
    np.testing.assert_array_equal(img[0, 0], SKY_COLOR)
    np.testing.assert_array_equal(img[-1, -1], SKY_COLOR)
    # center pixel hits the cube: albedo (0.1, 0.2, 0.9) * 255 truncated
    np.testing.assert_array_equal(img[32, 32], (25, 51, 229))
    # a solid blob of hit pixels exists
    hit_mask = (img != np.asarray(SKY_COLOR)).any(-1)
    assert 0.05 < hit_mask.mean() < 0.9


def test_bvh_matches_brute_force_on_cube():
    arrays, cam = cube_scene(textured=True)
    img_brute = np.asarray(render(cam, arrays, backend="brute"))
    img_bvh = np.asarray(render(cam, arrays, backend="bvh"))
    np.testing.assert_array_equal(img_bvh, img_brute)


def test_bvh_matches_brute_force_on_deformed_sphere():
    # nonuniform scale + rotation + real multi-level BVH
    arrays, cam = sphere_scene(subdiv=3)
    img_brute = np.asarray(render(cam, arrays, backend="brute"))
    img_bvh = np.asarray(render(cam, arrays, backend="bvh"))
    mismatch = (img_brute != img_bvh).any(-1).mean()
    assert mismatch == 0.0, f"{mismatch:.4%} pixels differ"


def test_bvh_matches_brute_multi_instance():
    scene = Scene()
    scene.add_material(Material(albedo=(0.9, 0.9, 0.9)))
    mat = Material()
    mat.set_texture(procgen.gradient_texture(32, 32))
    scene.add_material(mat)
    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    scene.add_mesh(objloader.loads(procgen.board_obj(3, 3)))
    a = MeshInstance(0, 0)
    b = MeshInstance(1, 1)
    b.pose = np.array([0, 1.5, 0.6, 0.2, 0.4, 0.1], np.float32)
    c = MeshInstance(0, 1)
    c.pose = np.array([1.2, 0.5, -0.4, 0, 0, 0.7], np.float32)
    c.scale = np.array([0.5, 0.5, 0.5], np.float32)
    for inst in (a, b, c):
        scene.add_mesh_instance(inst)
    arrays = scene.compile()
    cam = Camera.looking(48, 48, fov_deg=55.0, pose=[0, -4, 0.2, 0, 0, 0])
    img_brute = np.asarray(render(cam, arrays, backend="brute"))
    img_bvh = np.asarray(render(cam, arrays, backend="bvh"))
    np.testing.assert_array_equal(img_bvh, img_brute)


def test_textured_cube_samples_checkerboard():
    arrays, cam = cube_scene(textured=True)
    img = np.asarray(render(cam, arrays, backend="bvh"))
    hit = (img != np.asarray(SKY_COLOR)).any(-1)
    vals = np.unique(img[hit])
    # checkerboard texture: dark (25) and light (235) texels only
    # (+/-1 from the truncating uint8 cast, raycast.cu:292-294:
    #  235 * 0.0039215 * 255 = 234.99...)
    assert set(vals.tolist()) <= {24, 25, 234, 235}, vals
    assert len(vals) >= 2


def test_backface_culling():
    # A single board faces -y; from behind (+y side) it must be invisible
    scene = Scene()
    scene.add_material(Material(albedo=(1, 0, 0)))
    scene.add_mesh(objloader.loads(procgen.board_obj()))
    scene.add_mesh_instance(MeshInstance(0, 0))
    arrays = scene.compile()
    front = Camera.looking(16, 16, fov_deg=40, pose=[0, -2, 0, 0, 0, 0])
    img_front = np.asarray(render(front, arrays, backend="brute"))
    assert (img_front != np.asarray(SKY_COLOR)).any()
    back = Camera.looking(16, 16, fov_deg=40, pose=[0, 2, 0, np.pi, 0, 0])
    img_back = np.asarray(render(back, arrays, backend="brute"))
    np.testing.assert_array_equal(img_back, np.broadcast_to(SKY_COLOR, img_back.shape))


def test_lambert_shadow_mode_runs():
    arrays, cam = cube_scene()
    img = np.asarray(
        render(cam, arrays, backend="bvh", lighting="lambert_shadow",
               light_direction=(-0.2, 0.0, 1.0))
    )
    hit = (img != np.asarray(SKY_COLOR)).any(-1)
    assert hit.any()


def test_golden_cube_checksum_stable():
    """Golden-image regression for the minimum end-to-end slice."""
    arrays, cam = cube_scene(textured=True)
    img = np.asarray(render(cam, arrays, backend="bvh"))
    golden = np.load("tests/golden/cube_64.npy")
    np.testing.assert_array_equal(img, golden)


def test_blinn_phong_adds_specular():
    """blinn_phong = lambert + a clamped half-vector specular lobe
    (BASELINE config 3), so it can only brighten pixels. Light chosen
    near the camera-facing normal so the lobe is visibly nonzero but
    the diffuse term stays below the clamp ceiling."""
    arrays, cam = cube_scene()
    kw = dict(backend="bvh", light_direction=(-0.3, -1.0, 0.3))
    a = np.asarray(render(cam, arrays, lighting="lambert", **kw))
    b = np.asarray(render(cam, arrays, lighting="blinn_phong", **kw))
    assert (b.astype(int) >= a.astype(int)).all()
    assert (b != a).any(), "no specular highlight anywhere"


def test_edge_eps_overhang_bounded():
    """Pin the EDGE_EPS visible-artifact bound (intersect.py:41): the
    inclusive barycentric slack accepts hits at most ~EDGE_EPS edge
    lengths outside a triangle, so a glancing ray passing a LARGE
    triangle's edge by more than that must still miss, while rays
    safely inside must hit — on every backend."""
    import jax.numpy as jnp

    from tpu_raytracer.render.intersect import EDGE_EPS
    from tpu_raytracer.render.renderer import cast_rays_brute, cast_rays_bvh
    from tpu_raytracer.scene import Material, MeshInstance, MeshPrimitive, Scene

    # one big triangle in the y=0 plane, edges ~100 units: the world
    # overhang bound is EDGE_EPS * 100 = 0.1 units along the x edge
    scene = Scene()
    scene.add_material(Material())
    v0 = np.array([[0.0, 0.0, 0.0]], np.float32)
    v1 = np.array([[100.0, 0.0, 0.0]], np.float32)  # winding: normal -y
    v2 = np.array([[0.0, 0.0, 100.0]], np.float32)
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2))
    scene.add_mesh_instance(MeshInstance(0, 0))
    arrays = scene.compile()

    bound = EDGE_EPS * 100.0
    origin = np.array([0.0, -10.0, 0.0], np.float32)
    # rays through y=0 at x positions straddling the x=0 edge (z=50,
    # mid-edge, far from vertices): outside by 3x the bound -> miss;
    # inside by 3x the bound -> hit
    xs = np.array([-3.0 * bound, -1.5 * bound, 1.5 * bound, 3.0 * bound],
                  np.float32)
    targets = np.stack(
        [xs, np.zeros_like(xs), np.full_like(xs, 50.0)], axis=-1
    )
    d = targets - origin
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    for cast in (cast_rays_brute, cast_rays_bvh):
        hit = cast(arrays, jnp.asarray(origin), jnp.asarray(d))
        t = np.asarray(hit.t)
        assert (t[:2] >= 3e38).all(), f"{cast.__name__}: overhang beyond bound"
        assert (t[2:] < 3e38).all(), f"{cast.__name__}: interior ray missed"
