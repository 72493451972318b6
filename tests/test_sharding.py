"""Multi-chip sharded rendering on the 8-device virtual CPU mesh
(SURVEY.md §4 item 6)."""

import jax
import numpy as np
import pytest

from tpu_raytracer.parallel import make_mesh, render_image_sharded
from tpu_raytracer.render import Camera, RenderConfig, render
from tpu_raytracer.scene import Material, MeshInstance, Scene, objloader, procgen


def small_scene(width, height):
    scene = Scene()
    mat = Material()
    mat.set_texture(procgen.checkerboard_texture(32, 4))
    scene.add_material(mat)
    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    scene.add_mesh_instance(MeshInstance(0, 0))
    cam = Camera.looking(width, height, fov_deg=45.0, pose=[0, -4, 0, 0, 0, 0])
    return scene.compile(), cam


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_render_matches_single_device():
    arrays, cam = small_scene(64, 64)
    mesh = make_mesh(8)
    config = RenderConfig(width=64, height=64, backend="brute")
    p = cam.ray_params()
    img_sharded = np.asarray(
        render_image_sharded(
            config, mesh, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
        )
    )
    img_single = np.asarray(render(cam, arrays, backend="brute"))
    np.testing.assert_array_equal(img_sharded, img_single)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_sharded_render_is_actually_sharded():
    arrays, cam = small_scene(64, 64)
    mesh = make_mesh(4)
    config = RenderConfig(width=64, height=64, backend="brute")
    p = cam.ray_params()
    img = render_image_sharded(
        config, mesh, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
    )
    assert len(img.sharding.device_set) == 4


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_render_bvh_backend_matches():
    """Sharded rendering with a real BVH backend (not brute): a
    shard_map bug interacting with the while_loop walk would slip past
    the brute-only tests."""
    arrays, cam = small_scene(64, 64)
    mesh = make_mesh(8)
    config = RenderConfig(width=64, height=64, backend="bvh")
    p = cam.ray_params()
    img_sharded = np.asarray(
        render_image_sharded(
            config, mesh, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
        )
    )
    img_single = np.asarray(render(cam, arrays, backend="bvh"))
    np.testing.assert_array_equal(img_sharded, img_single)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_sharded_render_kernel():
    """shard_map x the traversal kernel's FFI call (its host build on
    the CPU mesh; chip_smoke.py --four runs the CUDA build on 4 cards)."""
    arrays, cam = small_scene(64, 64)
    mesh = make_mesh(4)
    config = RenderConfig(width=64, height=64, backend="cuda")
    p = cam.ray_params()
    img_sharded = np.asarray(
        render_image_sharded(
            config, mesh, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
        )
    )
    # reference on a 1-device mesh: same shard-body code path (the
    # broadcast-origin kernel), so the comparison isolates the
    # shard_map axis split itself
    img_single = np.asarray(
        render_image_sharded(
            config, make_mesh(1), arrays, p["K_inv"], p["D"], p["pose"],
            p["inv_pose"],
        )
    )
    np.testing.assert_array_equal(img_sharded, img_single)


def test_graft_dryrun_multichip():
    import sys

    sys.path.insert(0, ".")
    from __graft_entry__ import dryrun_multichip

    n = min(len(jax.devices()), 8)
    dryrun_multichip(n)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_sharded_whitted_matches_single_device():
    from tpu_raytracer.parallel import render_image_whitted_sharded
    from tpu_raytracer.render.integrators import render_whitted, to_u8
    from tpu_raytracer.render.camera import generate_rays

    arrays, cam = small_scene(64, 64)
    mesh = make_mesh(4)
    config = RenderConfig(width=64, height=64, backend="brute")
    p = cam.ray_params()
    img_sharded = np.asarray(render_image_whitted_sharded(
        config, mesh, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
    ))
    o, d = generate_rays(64, 64, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    img_single = np.asarray(to_u8(render_whitted(
        arrays, o, d, max_bounces=2, backend="brute",
        light_direction=config.light_direction,
    )))
    np.testing.assert_array_equal(img_sharded, img_single)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_sharded_path_traced_runs_and_shards():
    from tpu_raytracer.parallel import render_image_path_traced_sharded

    arrays, cam = small_scene(64, 64)
    mesh = make_mesh(4)
    config = RenderConfig(width=64, height=64, backend="brute")
    p = cam.ray_params()
    img = render_image_path_traced_sharded(
        config, mesh, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
        jax.random.PRNGKey(0), 1, 1,
    )
    assert len(img.sharding.device_set) == 4
    img = np.asarray(img)
    assert img.shape == (64, 64, 3)
    assert (img != 0).any()
