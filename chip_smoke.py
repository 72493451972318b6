#!/usr/bin/env python
"""Quickest proof that the renderer runs on an NVIDIA GPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the multi-device path only

Phases, each printing its own line first; any failure ends the run with
a non-zero exit code and no result line:

1. device  — JAX must find a GPU (no CPU fallback); prints the card,
             JAX version, XLA_FLAGS and nvidia-smi's name/power limit.
2. build   — builds the CUDA traversal library from native/ sources.
3. oracle  — the kernel against the brute-force cast on the card,
             closest-hit, any-hit and carried u/v/n, on every oracle
             scene (tests/test_gpu_oracle.py).
4. driver  — app.driver.run for the demo scene (reference fisheye,
             1920x1088), bunny 1920x1088, instances Whitted 512^2 and
             Cornell path 512^2 with the platform's backend; each image
             against the same run with backend="bvh" on the card.
5. large   — the ~1.04M-triangle colonnade, primary rays, against the
             XLA walk and against brute on sampled rays.
6. timing  — frame ms and Mrays/s of the kernel and the walk at bunny
             1920x1088 primary and instances Whitted 512^2.

Tolerances (tpu_raytracer/oracle.py): hit/miss agrees on >= 99.99% of
rays, t to a relative 1e-5 where both hit, tri/inst on >= 99.9% of joint
hits, images differ in <= 0.05% of pixels; the t error is weighted by
|cos| of the incidence angle, since a grazing hit's t is ill-conditioned.

The last line is {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "smoke")


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    """Median wall time of ``fn()`` in ms, each rep ending in
    block_until_ready (the first call compiles and is not counted)."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


# -- phases -----------------------------------------------------------


def phase_device(ctx):
    import jax

    platform = jax.default_backend()
    if platform != "gpu":
        raise RuntimeError(f"JAX found no GPU (default backend {platform!r})")
    dev = jax.devices()[0]
    ctx["kind"] = dev.device_kind
    ctx["card"] = card_line()
    say(f"  device_kind={dev.device_kind} count={len(jax.devices())} "
        f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    say(f"  card: {ctx['card']}")


def phase_build(ctx):
    from tpu_raytracer.kernels import traverse

    info = traverse.prepare()
    say(f"  {info['library']} built and registered in {info['build_s']:.3f} s")


def phase_oracle(ctx):
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_gpu_oracle

    if not test_gpu_oracle.run_all(log=lambda m: say("  " + m)):
        raise AssertionError("kernel disagrees with the brute oracle")


DRIVER_RUNS = (
    ("demo fisheye 1920x1088", dict(width=1920, height=1088)),
    ("bunny 1920x1088", dict(scene_name="bunny", width=1920, height=1088)),
    ("instances whitted 512^2",
     dict(scene_name="instances", mode="whitted", width=512, height=512)),
    ("cornell path 512^2",
     dict(scene_name="cornell", mode="path", width=512, height=512)),
)


def phase_driver(ctx):
    from tpu_raytracer.app import driver
    from tpu_raytracer.oracle import image_agreement

    os.makedirs(OUT_DIR, exist_ok=True)
    failed = []
    for name, kw in DRIVER_RUNS:
        stem = name.split()[0]
        img = driver.run(frames=3, out=os.path.join(OUT_DIR, f"{stem}.png"),
                         **kw)
        ref = driver.run(frames=3, backend="bvh",
                         out=os.path.join(OUT_DIR, f"{stem}_bvh.png"), **kw)
        agree = image_agreement(img, ref)
        say(f"  {name}: {img.shape} vs bvh {agree}")
        if not agree["ok"]:
            failed.append(name)
    if failed:
        raise AssertionError(f"images differ beyond tolerance: {failed}")


def phase_large(ctx):
    import jax

    from tpu_raytracer.app import scenes
    from tpu_raytracer.oracle import (
        brute_hits, camera_rays, hit_agreement, incidence_cos,
    )
    from tpu_raytracer.render.renderer import get_cast_fn

    t0 = time.perf_counter()
    arrays, cam = scenes.scene_colonnade(1024, 1024, columns=18, segs=40)
    say(f"  colonnade: {arrays.num_triangles} triangles, "
        f"{arrays.node_child_a.shape[0]} nodes, set-up "
        f"{time.perf_counter() - t0:.3f} s")
    o, d = camera_rays(cam)
    kernel = jax.jit(get_cast_fn("cuda"))
    hk = kernel(arrays, o, d)
    jax.block_until_ready(hk)
    ms = median_ms(lambda: kernel(arrays, o, d), 5)
    say(f"  kernel cast {cam.width}x{cam.height}: {ms:.3f} ms "
        f"({cam.width * cam.height / ms / 1e3:.1f} Mrays/s) on {ctx['card']}")
    # brute on sampled rays: random pixels plus the center row and
    # column, where an axis-aligned camera makes direction components
    # exactly 0 and origins sit in box planes
    rng = np.random.default_rng(0)
    h, w = d.shape[:2]
    ys = np.concatenate([rng.integers(0, h, 256), np.full(w // 8, h // 2),
                         np.arange(0, h, 8)])
    xs = np.concatenate([rng.integers(0, w, 256), np.arange(0, w, 8),
                         np.full(h // 8, w // 2)])
    dn = np.asarray(d)[ys, xs]
    want = brute_hits(arrays, o, dn, chunk=64)
    got = jax.tree.map(lambda a: np.asarray(a)[ys, xs], hk)
    sampled = hit_agreement(got, want,
                            cos=incidence_cos(arrays, o, dn, want))
    say(f"  kernel vs brute on {len(ys)} sampled rays: {sampled}")
    try:
        hw = jax.jit(get_cast_fn("bvh"))(arrays, o, d)
        walk = hit_agreement(hk, hw, cos=incidence_cos(arrays, o, d, hw))
        say(f"  kernel vs XLA walk on all rays: {walk}")
    except jax.errors.JaxRuntimeError as e:
        walk = {"ok": True}
        say(f"  XLA walk cannot run at this size on the card: "
            f"{str(e).splitlines()[0][:200]}")
    if not (sampled["ok"] and walk["ok"]):
        raise AssertionError("large scene disagrees beyond tolerance")


def phase_timing(ctx):
    from tpu_raytracer.app import scenes
    from tpu_raytracer.render.pipeline import (
        RenderConfig, render_image, render_image_whitted,
    )

    for name, build, render, reps in (
        ("bunny 1920x1088 primary", lambda: scenes.scene_bunny(1920, 1088),
         render_image, 20),
        ("instances 512^2 whitted", lambda: scenes.scene_instances(512, 512),
         render_image_whitted, 10),
    ):
        arrays, cam = build()
        p = cam.ray_params()
        args = (arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        for backend in ("cuda", "bvh"):
            cfg = RenderConfig(cam.width, cam.height, backend=backend)
            ms = median_ms(lambda: render(cfg, *args), reps)
            say(f"  {name} {backend}: {ms:.3f} ms/frame, "
                f"{cam.width * cam.height / ms / 1e3:.1f} Mrays/s "
                f"(primary rays) on {ctx['card']}")


def phase_four(ctx):
    import jax

    from tpu_raytracer.app import scenes
    from tpu_raytracer.oracle import (
        T_RTOL, camera_rays, hit_agreement, image_agreement, incidence_cos,
    )
    from tpu_raytracer.parallel import (
        make_mesh, render_image_scene_sharded, render_image_sharded,
        render_image_whitted_sharded, shard_compile,
    )
    from tpu_raytracer.parallel.scene_shard import cast_rays_scene_sharded
    from tpu_raytracer.render.pipeline import (
        RenderConfig, render_image, render_image_whitted,
    )
    from tpu_raytracer.render.renderer import get_cast_fn
    from tpu_raytracer.scene import (
        Material, MeshInstance, MeshPrimitive, Scene, procgen,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    devices = jax.devices()
    if len(devices) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(devices)}")

    def memory():
        stats = [(d.id, (d.memory_stats() or {}).get("peak_bytes_in_use"))
                 for d in devices[:4]]
        return ", ".join(
            f"{i}:{'n/a' if b is None else f'{b / 2**20:.0f}MiB'}"
            for i, b in stats)

    def shards(out):
        return ", ".join(f"{sh.device.id}:{sh.data.shape}"
                         for sh in out.addressable_shards)

    failed = []
    arrays, cam = scenes.scene_bunny(1920, 1088)
    p = cam.ray_params()
    args = (arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    cfg = RenderConfig(cam.width, cam.height)
    mesh = make_mesh(4)
    for name, one, four in (
        ("primary", render_image, render_image_sharded),
        ("whitted", render_image_whitted, render_image_whitted_sharded),
    ):
        ref = np.asarray(one(cfg, *args))
        out = four(cfg, mesh, *args)
        jax.block_until_ready(out)
        equal = bool((np.asarray(out) == ref).all())
        say(f"  ray-sharded {name} bunny 1920x1088 on 4 cards: equal to one "
            f"card={equal}; sharding={out.sharding}; shards {shards(out)}; "
            f"peak memory {memory()}")
        if not equal:
            failed.append(f"ray-sharded {name}")

    # scene-sharded: the bunny's triangles split over the 4 cards
    src = Scene()
    src.add_material(Material(albedo=(0.8, 0.3, 0.2)))
    src.add_mesh(MeshPrimitive.from_triangles(*procgen.blob(subdivisions=6)))
    src.add_mesh_instance(MeshInstance(0, 0))
    smesh = make_mesh(4, axis="scene")
    stacked = jax.device_put(shard_compile(src, 4),
                             NamedSharding(smesh, P("scene")))
    flat = src.compile(flatten_static=True)
    img4 = render_image_scene_sharded(cfg, smesh, stacked, *args[1:])
    jax.block_until_ready(img4)
    img1 = render_image(cfg, flat, *args[1:])
    o, d = camera_rays(cam)
    hits4 = cast_rays_scene_sharded(smesh, stacked, o, d)
    hits1 = jax.jit(get_cast_fn(None))(flat, o, d)
    # tri ids are global shard ids on one side: hold hit/miss and t
    agree = hit_agreement(hits4, hits1, any_hit=False,
                          cos=incidence_cos(flat, o, d, hits1))
    agree["ok"] = (agree["hitmiss"] == 1.0
                   and agree["t_err_max"] <= T_RTOL)
    image = image_agreement(img4, img1)
    say(f"  scene-sharded bunny 1920x1088 on 4 cards: hits vs one card "
        f"{ {k: v for k, v in agree.items() if k != 'ids'} }; image {image}; "
        f"sharding={img4.sharding}; peak memory {memory()}")
    say(f"  scene shards per card: {shards(stacked.tri_v0)}")
    if not (agree["ok"] and image["ok"]):
        failed.append("scene-sharded")
    if failed:
        raise AssertionError(f"four-card results differ: {failed}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its one-card "
                         "comparison")
    args = ap.parse_args()

    ctx: dict = {}
    phases = [("device", phase_device)]
    if args.four:
        phases += [("build", phase_build), ("four", phase_four)]
    else:
        phases += [("build", phase_build), ("oracle", phase_oracle),
                   ("driver", phase_driver), ("large", phase_large),
                   ("timing", phase_timing)]
    t_start = time.perf_counter()
    for name, fn in phases:
        say(f"[phase {name}]")
        t0 = time.perf_counter()
        try:
            if name != "device":
                from tpu_raytracer.utils import enable_compilation_cache

                enable_compilation_cache()
            fn(ctx)
        except Exception:
            traceback.print_exc()
            say(f"[phase {name}] FAILED after {time.perf_counter() - t0:.1f} s")
            return 1
        say(f"[phase {name}] ok in {time.perf_counter() - t0:.1f} s")
    import jax

    say(f"all phases ok in {time.perf_counter() - t_start:.1f} s; "
        f"card: {ctx['card']}")
    print(json.dumps({"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
