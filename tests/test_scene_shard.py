"""Scene-SHARDED multichip rendering (parallel/scene_shard.py) on the
virtual CPU mesh — the SURVEY §2 TP-analog row (geometry sharded, rays
replicated, lex-min hit combine + winner-psum shading over ICI
collectives)."""

import jax
import numpy as np
import pytest

from tpu_raytracer.parallel import (
    cast_rays_scene_sharded,
    make_mesh,
    render_image_scene_sharded,
    shard_compile,
)
from tpu_raytracer.render import Camera, RenderConfig
from tpu_raytracer.render.camera import generate_rays
from tpu_raytracer.render.pipeline import render_image
from tpu_raytracer.render.renderer import cast_rays_brute
from tpu_raytracer.scene import (
    Material, MeshInstance, MeshPrimitive, Scene, procgen,
)

needs4 = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 virtual devices"
)


def _scene():
    """Textured sphere + posed cube: two instances so the flatten path
    and per-triangle materials are exercised."""
    from tpu_raytracer.scene import objloader

    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.3, 0.2)))
    mat = Material()
    mat.set_texture(procgen.checkerboard_texture(32, 4))
    scene.add_material(mat)
    v0, v1, v2 = procgen.icosphere(2)
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2))
    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    a = MeshInstance(0, 0)
    a.pose = np.array([-0.9, 0.0, 0.0, 0.4, 0.1, 0.0], np.float32)
    b = MeshInstance(1, 1)
    b.pose = np.array([1.1, 0.5, 0.2, 0.0, 0.3, 0.2], np.float32)
    scene.add_mesh_instance(a)
    scene.add_mesh_instance(b)
    cam = Camera.looking(64, 64, fov_deg=55.0, pose=[0, -4.5, 0, 0, 0, 0])
    return scene, cam


def _rays(cam):
    p = cam.ray_params()
    return generate_rays(cam.width, cam.height, p["K_inv"], p["D"],
                         p["pose"], p["inv_pose"])


@needs4
def test_sharded_cast_matches_full_scene():
    """The 4-shard lex-min combine is exact: bit-equal to the 1-shard
    run of the SAME code path (isolates the split + collectives), and
    t-equal to the full-scene bvh walk over the same flattened
    geometry (per-triangle math is identical ops in the same backend;
    only tri IDS are shard-local)."""
    from tpu_raytracer.render.renderer import cast_rays_bvh

    scene, cam = _scene()
    o, d = _rays(cam)
    got4 = cast_rays_scene_sharded(make_mesh(4, axis="scene"),
                                   shard_compile(scene, 4), o, d)
    got1 = cast_rays_scene_sharded(make_mesh(1, axis="scene"),
                                   shard_compile(scene, 1), o, d)
    np.testing.assert_array_equal(np.asarray(got4.t), np.asarray(got1.t))
    np.testing.assert_array_equal(
        np.asarray(got4.inst), np.asarray(got1.inst)
    )

    flat, _ = scene.flattened()
    full = flat.compile()
    ref = cast_rays_bvh(full, o, d)
    np.testing.assert_array_equal(np.asarray(got4.t), np.asarray(ref.t))
    assert (np.asarray(got4.t) < 3e38).sum() > 200  # real hits


@needs4
def test_sharded_render_matches_full_scene():
    """End-to-end shaded image (textures + lambert_shadow shadow rays
    min-combined across shards) == the single-device render of the
    same flattened scene."""
    scene, cam = _scene()
    stacked = shard_compile(scene, 4)
    mesh = make_mesh(4, axis="scene")
    p = cam.ray_params()
    cfg = RenderConfig(cam.width, cam.height, backend="bvh",
                       lighting="lambert_shadow")
    img = np.asarray(render_image_scene_sharded(
        cfg, mesh, stacked, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
    ))

    # exact vs the 1-shard run of the same code path
    img1 = np.asarray(render_image_scene_sharded(
        cfg, make_mesh(1, axis="scene"), shard_compile(scene, 1),
        p["K_inv"], p["D"], p["pose"], p["inv_pose"]
    ))
    np.testing.assert_array_equal(img, img1)

    # vs the single-device full-scene render: same geometry, same
    # shading chain; only coplanar-edge tie pixels may flip (different
    # BVH order), so allow a tiny mismatch fraction
    flat, tri_mat = scene.flattened()
    full = flat.compile(_tri_mat=tri_mat)
    ref = np.asarray(render_image(
        cfg, full, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
    ))
    mismatch = (img != ref).any(-1).mean()
    assert mismatch < 0.01, mismatch


@needs4
def test_sharded_render_point_lights():
    """Primary scene-sharded render with POINT lights: their
    distance-bounded visibility rides the pmin-combined NEAREST cast
    (shade.compute_illumination's nearest_cast_fn injection) — matches
    the single-device render of the same flattened scene."""
    from tpu_raytracer.render.integrators import PointLight

    scene, cam = _scene()
    stacked = shard_compile(scene, 4)
    mesh = make_mesh(4, axis="scene")
    p = cam.ray_params()
    cfg = RenderConfig(
        cam.width, cam.height, backend="bvh", lighting="lambert_shadow",
        point_lights=(PointLight((0.0, -1.0, 2.0), 5.0),),
    )
    img = np.asarray(render_image_scene_sharded(
        cfg, mesh, stacked, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
    ))
    flat, tri_mat = scene.flattened()
    full = flat.compile(_tri_mat=tri_mat)
    ref = np.asarray(render_image(
        cfg, full, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
    ))
    mismatch = (img != ref).any(-1).mean()
    assert mismatch < 0.01, mismatch
    # the point light actually changed pixels vs the no-light render
    cfg0 = RenderConfig(cam.width, cam.height, backend="bvh",
                        lighting="lambert_shadow")
    ref0 = np.asarray(render_image(
        cfg0, full, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
    ))
    assert (ref != ref0).any(-1).mean() > 0.01


@needs4
def test_sharded_cast_kernel_backend():
    """The traversal kernel runs INSIDE the shard body: each device
    casts against its chunk through the FFI target, and the combined
    distances match the bvh-walk sharded cast to the oracle's
    tolerance; ids may differ only on exact t-ties."""
    scene, cam = _scene()
    o, d = _rays(cam)
    mesh = make_mesh(4, axis="scene")
    stacked = shard_compile(scene, 4)
    got_k = cast_rays_scene_sharded(mesh, stacked, o, d, backend="cuda")
    got_b = cast_rays_scene_sharded(mesh, stacked, o, d, backend="bvh")
    tk, tb = np.asarray(got_k.t), np.asarray(got_b.t)
    np.testing.assert_array_equal(tk >= 3e38, tb >= 3e38)
    np.testing.assert_allclose(np.where(tk < 3e38, tk, 0.0),
                               np.where(tb < 3e38, tb, 0.0), rtol=1e-5)
    flips = (np.asarray(got_k.tri) != np.asarray(got_b.tri)).mean()
    assert flips < 0.02, flips


@needs4
def test_whitted_scene_sharded_matches_full_scene():
    """Whitted with geometry sharded: reflection bounces + directional
    shadows + a POINT light, all combined per bounce over the mesh
    axis — matches the single-device whitted render of the same
    flattened scene (tie pixels only may flip)."""
    from tpu_raytracer.parallel import render_image_whitted_scene_sharded
    from tpu_raytracer.render.integrators import PointLight
    from tpu_raytracer.render.pipeline import render_image_whitted

    scene, cam = _scene()
    scene.materials[0].reflectivity = 0.5  # make bounces real
    stacked = shard_compile(scene, 4)
    mesh = make_mesh(4, axis="scene")
    p = cam.ray_params()
    cfg = RenderConfig(cam.width, cam.height, backend="bvh",
                       point_lights=(PointLight((0.0, -1.0, 2.0), 5.0),))
    img = np.asarray(render_image_whitted_scene_sharded(
        cfg, mesh, stacked, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
        max_bounces=1,
    ))

    # exact vs the 1-shard run of the same code path
    img1 = np.asarray(render_image_whitted_scene_sharded(
        cfg, make_mesh(1, axis="scene"), shard_compile(scene, 1),
        p["K_inv"], p["D"], p["pose"], p["inv_pose"], max_bounces=1,
    ))
    np.testing.assert_array_equal(img, img1)

    flat, tri_mat = scene.flattened()
    full = flat.compile(_tri_mat=tri_mat)
    ref = np.asarray(render_image_whitted(
        cfg, full, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
        max_bounces=1,
    ))
    mismatch = (img != ref).any(-1).mean()
    assert mismatch < 0.01, mismatch
    # the bounce actually changed pixels vs a 0-bounce render
    ref0 = np.asarray(render_image_whitted(
        cfg, full, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
        max_bounces=0,
    ))
    assert (ref != ref0).any(-1).mean() > 0.005


@needs4
def test_path_scene_sharded_matches_full_scene():
    """Path tracing with geometry sharded (the _sharded_hooks seam in
    integrators.render_path_traced): NEE point + directional lights,
    bounce casts, and the fast-tail occlusion cast all combined over
    the mesh axis. The random stream depends only on (key, shape) —
    identical across shards and vs the single-device render — so the
    4-shard image matches the full-scene path render bit-for-bit
    except on exact-t tie pixels (different per-chunk BVH order)."""
    from tpu_raytracer.parallel import render_image_path_scene_sharded
    from tpu_raytracer.render.integrators import PointLight
    from tpu_raytracer.render.pipeline import render_image_path_traced

    scene, cam = _scene()
    scene.materials[0].reflectivity = 0.3  # exercise the specular lobe
    stacked = shard_compile(scene, 4)
    mesh = make_mesh(4, axis="scene")
    p = cam.ray_params()
    cfg = RenderConfig(
        cam.width, cam.height, backend="bvh", path_lights=True,
        point_lights=(PointLight((0.0, -1.0, 2.0), 5.0),),
    )
    key = jax.random.key(7)
    img = np.asarray(render_image_path_scene_sharded(
        cfg, mesh, stacked, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
        key, max_bounces=2, samples=2,
    ))

    # exact vs the 1-shard run of the same code path
    img1 = np.asarray(render_image_path_scene_sharded(
        cfg, make_mesh(1, axis="scene"), shard_compile(scene, 1),
        p["K_inv"], p["D"], p["pose"], p["inv_pose"], key,
        max_bounces=2, samples=2,
    ))
    np.testing.assert_array_equal(img, img1)

    flat, tri_mat = scene.flattened()
    full = flat.compile(_tri_mat=tri_mat)
    ref = np.asarray(render_image_path_traced(
        cfg, full, p["K_inv"], p["D"], p["pose"], p["inv_pose"], key,
        max_bounces=2, samples=2,
    ))
    mismatch = (img != ref).any(-1).mean()
    assert mismatch < 0.01, mismatch
    assert (img != img[0, 0]).any()  # not a constant image


@needs4
def test_path_scene_sharded_fast_tail_skyonly():
    """The no-NEE sky-ambient configuration routes its FINAL bounce
    through the pmin-combined ANY-HIT cast (the fast tail): sharded ==
    single-device on the same flattened geometry (tie pixels only)."""
    from tpu_raytracer.parallel import render_image_path_scene_sharded
    from tpu_raytracer.render.pipeline import render_image_path_traced

    scene, cam = _scene()
    stacked = shard_compile(scene, 4)
    mesh = make_mesh(4, axis="scene")
    p = cam.ray_params()
    cfg = RenderConfig(cam.width, cam.height, backend="bvh")
    key = jax.random.key(3)
    img = np.asarray(render_image_path_scene_sharded(
        cfg, mesh, stacked, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
        key, max_bounces=2, samples=2,
    ))
    flat, tri_mat = scene.flattened()
    full = flat.compile(_tri_mat=tri_mat)
    ref = np.asarray(render_image_path_traced(
        cfg, full, p["K_inv"], p["D"], p["pose"], p["inv_pose"], key,
        max_bounces=2, samples=2,
    ))
    mismatch = (img != ref).any(-1).mean()
    assert mismatch < 0.01, mismatch


@needs4
def test_shard_count_must_match_mesh():
    scene, cam = _scene()
    stacked = shard_compile(scene, 2)
    mesh = make_mesh(4, axis="scene")
    o, d = _rays(cam)
    with pytest.raises(Exception):
        jax.block_until_ready(
            cast_rays_scene_sharded(mesh, stacked, o, d).t
        )
