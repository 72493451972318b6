#!/usr/bin/env python
"""Phase-decomposition microbench: where do the whitted / path frames
spend their time? One JSON line per variant (pipelined multi-frame
timing like bench_all; one process on the default device).

Usage: python bench_decomp.py [whitted|path]
"""

import json
import os
import sys
import time

if "path" in sys.argv[1:2]:
    os.environ.setdefault("TRT_BVH_OPT", "2")

import jax
import numpy as np


def timed(fn, frames=12):
    out = fn()
    jax.block_until_ready(out)
    start = time.perf_counter()
    for _ in range(frames):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - start) / frames


def report(name, dt):
    print(json.dumps({"variant": name, "frame_ms": round(dt * 1000, 2),
                      "fps": round(1 / dt, 2)}), flush=True)


def _instances_notex(width, height):
    """scene_instances with the textured floor swapped for plain
    albedo — isolates the texture-sampling cost per shaded stage."""
    from tpu_raytracer.render import Camera
    from tpu_raytracer.scene import (Material, MeshInstance, MeshPrimitive,
                                     Scene, objloader, procgen)

    scene = Scene()
    matte = scene.add_material(Material(albedo=(0.9, 0.9, 0.9)))
    blue = scene.add_material(Material(albedo=(0.9, 0.2, 0.1)))
    mirror = scene.add_material(Material(albedo=(0.95, 0.95, 0.95),
                                         reflectivity=0.8))
    grey = scene.add_material(Material(albedo=(0.6, 0.6, 0.6)))
    sphere = scene.add_mesh(MeshPrimitive.from_triangles(*procgen.icosphere(4)))
    cube = scene.add_mesh(objloader.loads(procgen.cube_obj()))
    board = scene.add_mesh(objloader.loads(procgen.board_obj(8, 8)))
    floor = MeshInstance(board, grey)
    floor.pose = np.array([0, 2, -1.2, 0, 0, np.pi], np.float32)
    scene.add_mesh_instance(floor)
    a = MeshInstance(sphere, mirror)
    a.pose = np.array([-1.2, 2.5, 0.0, 0, 0, 0], np.float32)
    scene.add_mesh_instance(a)
    b = MeshInstance(cube, blue)
    b.pose = np.array([1.1, 2.0, -0.6, 0.5, 0, 0], np.float32)
    b.scale = np.array([0.8, 0.8, 1.4], np.float32)
    scene.add_mesh_instance(b)
    c = MeshInstance(sphere, matte)
    c.pose = np.array([0.3, 3.5, -0.7, 0, 0, 0], np.float32)
    c.scale = np.array([0.5, 0.5, 0.5], np.float32)
    scene.add_mesh_instance(c)
    cam = Camera.looking(width, height, fov_deg=60.0,
                         pose=[0, -1.5, 0.3, 0, 0, 0])
    return scene.compile(flatten_static=True), cam


def whitted():
    from tpu_raytracer.app import scenes
    from tpu_raytracer.render import RenderConfig, render_image_whitted, render_image
    from tpu_raytracer.render.renderer import default_backend

    backend = default_backend()
    variants = [("flat", lambda: scenes.scene_instances(512, 512, flatten=True)),
                ("notex", lambda: _instances_notex(512, 512))]
    for tag, mk in variants:
        arrays, cam = mk()
        cfg = RenderConfig(cam.width, cam.height, backend=backend)
        p = cam.ray_params()
        args = (cfg, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        report(f"{tag} primary flat-lit (render_image)",
               timed(lambda: render_image(*args)))
        for b, s in ((0, False), (0, True), (1, False), (2, False), (2, True)):
            report(f"{tag} whitted b={b} shadows={s}",
                   timed(lambda: render_image_whitted(*args, max_bounces=b,
                                                      shadows=s)))


def path():
    from tpu_raytracer.app import scenes
    from tpu_raytracer.render import RenderConfig, render_image_path_traced
    from tpu_raytracer.render.renderer import default_backend

    backend = default_backend()
    arrays, cam = scenes.scene_colonnade(512, 512)
    cfg = RenderConfig(cam.width, cam.height, backend=backend)
    p = cam.ray_params()
    key = jax.random.PRNGKey(0)

    def frame(b, s=2):
        return render_image_path_traced(
            cfg, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
            key, b, s)

    for b in (0, 1, 2):
        report(f"path b={b} 2spp", timed(lambda: frame(b)))


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "whitted"
    {"whitted": whitted, "path": path}[which]()
