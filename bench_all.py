#!/usr/bin/env python
"""Multi-config benchmark across the BASELINE.md staged scenes.

(bench.py remains the driver's single-line flagship benchmark; this
script reports one JSON line per config for the record.)

Each config runs in its OWN SUBPROCESS (r3 bench hygiene): in-process
sequencing lets earlier configs' executables/memory pressure shift later
readings, so the recorded numbers are
order-independent. `bench_all.py <config>` runs a single config
in-process.
"""

import json
import subprocess
import sys
import time

import jax
import numpy as np


def timed(fn, frames=8):
    out = fn()
    jax.block_until_ready(out)  # compile + warm
    start = time.perf_counter()
    for _ in range(frames):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - start) / frames


def _report(name, cam, dt, casts=1.0):
    rays = cam.width * cam.height
    line = {
        "config": name,
        "resolution": f"{cam.width}x{cam.height}",
        "frame_ms": round(dt * 1000, 2),
        "fps": round(1 / dt, 2),
        "mrays_per_s": round(rays * casts / dt / 1e6, 2),
    }
    print(json.dumps(line), flush=True)


def _backend():
    from tpu_raytracer.render.renderer import default_backend

    return default_backend()


def config_cube():
    from tpu_raytracer.app import scenes
    from tpu_raytracer.render import RenderConfig, render_image

    arrays, cam = scenes.scene_cube(256)
    cfg = RenderConfig(cam.width, cam.height, backend=_backend())
    p = cam.ray_params()
    args = (cfg, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    _report("1 cube 256^2 flat", cam, timed(lambda: render_image(*args)))


def config_cornell():
    from tpu_raytracer.app import scenes
    from tpu_raytracer.render import RenderConfig, render_image

    arrays, cam = scenes.scene_cornell(512)
    cfg = RenderConfig(cam.width, cam.height, backend=_backend(),
                       lighting="lambert_shadow")
    p = cam.ray_params()
    args = (cfg, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    _report("2 cornell 512^2 shadows", cam,
            timed(lambda: render_image(*args)), casts=2.0)


def config_bunny():
    from tpu_raytracer.app import scenes
    from tpu_raytracer.render import RenderConfig, render_image

    arrays, cam = scenes.scene_bunny()
    cfg = RenderConfig(cam.width, cam.height, backend=_backend())
    p = cam.ray_params()
    args = (cfg, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    _report("3 bunny 82k-tri 1080p", cam, timed(lambda: render_image(*args)))


def config_bunny_fisheye():
    from tpu_raytracer.app import scenes
    from tpu_raytracer.render import Camera, RenderConfig, render_image
    from tpu_raytracer.render.camera import reference_calibration

    # config 3 through the reference's REAL fisheye calibration
    # (kernel.cu:158-164): D != 0 exercises the Kannala-Brandt
    # polynomial (raycast.cu:165-177) in the recorded bench surface
    arrays, cam = scenes.scene_bunny()
    K, D = reference_calibration(cam.width, cam.height)
    cam = Camera(cam.width, cam.height, K, D, pose=cam.pose)
    cfg = RenderConfig(cam.width, cam.height, backend=_backend())
    p = cam.ray_params()
    args = (cfg, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    _report("3f bunny 1080p real-fisheye K/D", cam,
            timed(lambda: render_image(*args)))


def config_instances():
    from tpu_raytracer.app import scenes
    from tpu_raytracer.render import RenderConfig, render_image_whitted

    arrays, cam = scenes.scene_instances(512, 512)
    cfg = RenderConfig(cam.width, cam.height, backend=_backend())
    p = cam.ray_params()
    args = (cfg, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    _report("4 instances whitted x2", cam,
            timed(lambda: render_image_whitted(*args)), casts=5.0)


def config_instances_flat():
    from tpu_raytracer.app import scenes
    from tpu_raytracer.render import RenderConfig, render_image_whitted

    # static instances flattened into one world-space mesh
    # (Scene.flattened) — one traversal per cast
    arrays, cam = scenes.scene_instances(512, 512, flatten=True)
    cfg = RenderConfig(cam.width, cam.height, backend=_backend())
    p = cam.ray_params()
    args = (cfg, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    _report("4b instances whitted x2 (flattened)", cam,
            timed(lambda: render_image_whitted(*args)), casts=5.0)


def config_instances16():
    from tpu_raytracer.app import scenes
    from tpu_raytracer.render import RenderConfig, render_image

    # 16 dynamic instances: the TLAS benchmark (vs its flattened bake)
    arrays, cam = scenes.scene_instances16(512, 512)
    cfg = RenderConfig(cam.width, cam.height, backend=_backend())
    p = cam.ray_params()
    args = (cfg, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    _report("6 instances16 dynamic (TLAS)", cam,
            timed(lambda: render_image(*args)))

    arrays_f, cam = scenes.scene_instances16(512, 512, flatten=True)
    p = cam.ray_params()
    args = (cfg, arrays_f, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    _report("6b instances16 flattened-static", cam,
            timed(lambda: render_image(*args)))


def config_colonnade():
    from tpu_raytracer.app import scenes
    from tpu_raytracer.render import RenderConfig, render_image

    arrays, cam = scenes.scene_colonnade(512, 512)
    cfg = RenderConfig(cam.width, cam.height, backend=_backend())
    p = cam.ray_params()
    args = (cfg, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    _report("5a colonnade 256k-tri primary", cam,
            timed(lambda: render_image(*args)))


def config_colonnade_path():
    # 2 reinsertion-optimizer rounds on the tree; an explicit env wins
    # (the subprocess isolation keeps it out of other configs)
    import os

    os.environ.setdefault("TRT_BVH_OPT", "2")
    from tpu_raytracer.app import scenes
    from tpu_raytracer.app.controls import fly_through
    from tpu_raytracer.core import transforms as T
    from tpu_raytracer.render import RenderConfig, render_image_path_traced

    # the full BASELINE config 5 — multi-bounce path tracing with an
    # animated camera fly-through (poses are per-frame runtime args, so
    # the fly-through never recompiles). SAMPLES x (BOUNCES+1) casts of
    # the full pixel grid per frame.
    arrays, cam = scenes.scene_colonnade(512, 512)
    cfg = RenderConfig(cam.width, cam.height, backend=_backend())
    p = cam.ray_params()
    SAMPLES, BOUNCES = 2, 2
    casts = SAMPLES * (BOUNCES + 1)

    def pt_frame(pose_arr, inv_pose_arr, k):
        return render_image_path_traced(
            cfg, arrays, p["K_inv"], p["D"], pose_arr, inv_pose_arr,
            jax.random.PRNGKey(k), BOUNCES, SAMPLES,
        )

    poses = list(fly_through(np.asarray(p["pose"]), frames=5,
                             forward_per_frame=0.15))
    inv_poses = [np.asarray(T.invert_lre(q)) for q in poses]
    out = pt_frame(poses[0], inv_poses[0], 0)
    jax.block_until_ready(out)  # compile + warm
    start = time.perf_counter()
    for k, (q, iq) in enumerate(zip(poses, inv_poses)):
        out = pt_frame(q, iq, k)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - start) / len(poses)
    _report("5b colonnade path-traced fly-through "
            f"({SAMPLES}spp x {BOUNCES+1} casts)", cam, dt, casts=casts)


CONFIGS = {
    "cube": config_cube,
    "cornell": config_cornell,
    "bunny": config_bunny,
    "bunny_fisheye": config_bunny_fisheye,
    "instances": config_instances,
    "instances_flat": config_instances_flat,
    "instances16": config_instances16,
    "colonnade": config_colonnade,
    "colonnade_path": config_colonnade_path,
}


def main():
    if len(sys.argv) > 1:
        CONFIGS[sys.argv[1]]()
        return
    # subprocess per config: order-independent readings
    for name in CONFIGS:
        r = subprocess.run(
            [sys.executable, __file__, name],
            capture_output=True, text=True, timeout=1800,
        )
        emitted = [ln for ln in r.stdout.splitlines()
                   if ln.startswith("{")]
        for ln in emitted:
            print(ln, flush=True)
        if r.returncode != 0 or not emitted:
            print(json.dumps({
                "config": name,
                "error": (r.stderr.strip().splitlines()[-1][:160]
                          if r.stderr.strip() else f"exit {r.returncode}"),
            }), flush=True)


if __name__ == "__main__":
    main()
