#!/usr/bin/env python
"""Device-time op breakdown for one frame (whitted flat / path config):
jax.profiler trace -> parse the perfetto trace.json.gz -> top ops by
summed device duration. The numbers answer 'where does the frame go'
at HLO granularity (the ncu-rep-style drill-down bench_decomp.py's
stage A/Bs can't give).

Usage: python bench_profile.py [whitted|path|primary]
"""

import glob
import gzip
import json
import os
import sys
from collections import defaultdict

import jax
import numpy as np


def capture(fn, tag):
    out = fn()
    jax.block_until_ready(out)  # compile outside the trace
    logdir = f"/tmp/trt_prof_{tag}"
    os.system(f"rm -rf {logdir}")
    with jax.profiler.trace(logdir):
        for _ in range(4):
            out = fn()
        jax.block_until_ready(out)
    return logdir


def summarize(logdir, frames=4):
    paths = glob.glob(f"{logdir}/**/*.trace.json.gz", recursive=True)
    if not paths:
        print("NO TRACE FILES under", logdir)
        return
    with gzip.open(paths[0], "rt") as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    # device-track complete events: pid/tid names identify device tracks
    names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            names[e["pid"]] = e["args"].get("name", "")
    tot = defaultdict(float)
    cnt = defaultdict(int)
    for e in events:
        if e.get("ph") != "X":
            continue
        pname = names.get(e.get("pid"), "")
        if "/device" not in pname.lower():
            continue
        # skip the top-level module event (it spans everything)
        tot[e["name"]] += e.get("dur", 0.0)
        cnt[e["name"]] += 1
    rows = sorted(tot.items(), key=lambda kv: -kv[1])
    print(f"-- device op totals over {frames} frames ({paths[0]}) --")
    for name, us in rows[:40]:
        print(f"{us / frames / 1000.0:9.3f} ms/frame  x{cnt[name] // frames:<4d} {name[:110]}")


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "whitted"
    from tpu_raytracer.app import scenes
    from tpu_raytracer.render import (RenderConfig, render_image,
                                      render_image_whitted,
                                      render_image_path_traced)
    from tpu_raytracer.render.renderer import default_backend

    backend = default_backend()
    if which in ("whitted", "primary"):
        arrays, cam = scenes.scene_instances(512, 512, flatten=True)
        cfg = RenderConfig(cam.width, cam.height, backend=backend)
        p = cam.ray_params()
        args = (cfg, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        fn = (lambda: render_image(*args)) if which == "primary" else (
            lambda: render_image_whitted(*args))
    else:
        os.environ.setdefault("TRT_BVH_OPT", "2")
        arrays, cam = scenes.scene_colonnade(512, 512)
        cfg = RenderConfig(cam.width, cam.height, backend=backend)
        p = cam.ray_params()
        key = jax.random.PRNGKey(0)
        fn = lambda: render_image_path_traced(
            cfg, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
            key, 2, 2)
    logdir = capture(fn, which)
    summarize(logdir)


if __name__ == "__main__":
    main()
