#!/usr/bin/env python
"""Benchmark driver: primary-ray throughput on the flagship config.

BASELINE config 3: bunny-class mesh (~82k triangles, full BVH) at
1920x1088 — the reference's own instrumented metric is wall-clock FPS
over full-frame kernel launches (kernel.cu:275-293); ours is Mrays/s
over jitted full-frame renders on one device.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mrays/s", "device": ..., ...}
with the median over timed reps and the device it ran on.
"""

import json
import sys
import time

import numpy as np


def build_bench_scene():
    import os

    from tpu_raytracer.render import Camera
    from tpu_raytracer.scene import Material, MeshInstance, MeshPrimitive, Scene, procgen

    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.3, 0.2)))
    v0, v1, v2 = procgen.blob(subdivisions=6)  # 81 920 tris, bunny-class
    min_leaf = int(os.environ.get("TRT_MIN_LEAF", "16"))
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2, min_leaf_size=min_leaf))
    inst = MeshInstance(0, 0)
    scene.add_mesh_instance(inst)
    cam = Camera.looking(1920, 1088, fov_deg=50.0, pose=[0.0, -3.2, 0.13, 0, 0, 0])
    return scene.compile(), cam


def main():
    import jax

    from tpu_raytracer.render import RenderConfig, render_image
    from tpu_raytracer.render.renderer import resolve_backend
    from tpu_raytracer.utils import enable_compilation_cache

    enable_compilation_cache()  # repeat runs skip recompiling
    # (utils/compile_cache.py; TRT_COMPILE_CACHE=0 opts out)

    arrays, cam = build_bench_scene()
    p = cam.ray_params()

    backend = resolve_backend(sys.argv[1] if len(sys.argv) > 1 else None)
    config = RenderConfig(width=cam.width, height=cam.height, backend=backend)

    def frame():
        return render_image(config, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])

    img = np.asarray(frame())  # compile + warm
    rays = cam.width * cam.height

    # median over reps of n_iters pipelined frames each
    n_iters, reps = 10, 10
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        for _ in range(n_iters):
            out = frame()
        jax.block_until_ready(out)
        times.append((time.perf_counter() - start) / n_iters)
    frame_s = float(np.median(times))

    dev = jax.devices()[0]
    hit_frac = float((img != np.array([255, 204, 153], np.uint8)).any(-1).mean())
    result = {
        "metric": f"primary-ray throughput, 82k-tri BVH scene @1920x1088 ({backend})",
        "value": round(rays / frame_s / 1e6, 2),
        "unit": "Mrays/s",
        "frame_ms": round(frame_s * 1e3, 3),
        "frame_ms_q1_q3": [round(float(q) * 1e3, 3)
                           for q in np.percentile(times, [25, 75])],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "hit_fraction": round(hit_frac, 4),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
