"""Application driver — render loop with FPS instrumentation, camera
animation, and PNG output (reference: kernel.cu:141-302).

Replicates the reference demo's structure: build a scene, compile
(upload) it, loop N frames timing each, print FPS, optionally animate an
instance pose (the cheap update path, Scene.cpp:67-74) or the camera
(mouse-orbit analog: per-frame yaw/pitch mutation, kernel.cu:131-132),
write out.png with the FPS overlay (kernel.cu:30-43).
"""

from __future__ import annotations

import argparse
import time

import jax
import numpy as np

from ..render import Camera, RenderConfig
from ..render.camera import reference_calibration
from ..render.pipeline import render_image
from ..render.renderer import BACKENDS, resolve_backend
from ..render.shade import DEFAULT_LIGHT_DIRECTION
from ..scene import Material, MeshInstance, MeshPrimitive, Scene, objloader, procgen
from ..utils import overlay_fps, save_png


def build_demo_scene() -> Scene:
    """The demo scene mirrors the reference app: a textured cube and a
    textured board posed in front of a fisheye camera
    (kernel.cu:174-240), with procedural stand-ins for its jpg/obj
    assets."""
    scene = Scene()
    glossy = Material(albedo=(0.1, 0.2, 0.9), roughness=0.01)
    scene.add_material(glossy)
    matte = Material(albedo=(0.9, 0.9, 0.9), roughness=0.3)
    scene.add_material(matte)
    cube_mat = Material()
    cube_mat.set_texture(procgen.checkerboard_texture(256, 16))
    scene.add_material(cube_mat)
    board_mat = Material()
    board_mat.set_texture(procgen.checkerboard_texture(256, 8))
    scene.add_material(board_mat)

    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    scene.add_mesh(objloader.loads(procgen.board_obj()))

    cube_instance = MeshInstance(0, 2)
    scene.add_mesh_instance(cube_instance)
    board_instance = MeshInstance(1, 3)
    board_instance.pose = np.array([-0.6, 1.48, 0.73, 0, 0, 0], np.float32)
    scene.add_mesh_instance(board_instance)
    return scene


def run(
    width: int = 1920,
    height: int = 1088,
    frames: int = 100,
    backend: str | None = None,
    out: str = "out.png",
    animate: bool = True,
    lighting: str = "flat",
    scene_name: str = "demo",
    mode: str = "primary",
    fly: bool = False,
    point_lights: tuple = (),
    no_sun: bool = False,
    texture_filter: str = "nearest",
    ssaa: int = 1,
    aovs: tuple = (),
    sky: str = "flat",
    lens_radius: float = 0.0,
    focus_distance: float = 4.0,
    path_lights: bool = False,
    tonemap: str = "none",
    exposure: float = 1.0,
    denoise: int = 0,
    ao_radius: float = 1.0,
    calib: bool = False,
    normal_mode: str = "reference",
    web: int | None = None,
    web_host: str = "127.0.0.1",
):
    """The render loop (kernel.cu:266-296): N timed frames, FPS printed
    per frame, final frame saved with the FPS overlay.

    ``mode``: primary (reference parity) | whitted (config 4) |
    path (config 5) | ao (ambient-occlusion pass, --ao-radius).
    ``fly`` animates the camera (config 5 fly-through);
    ``animate`` spins instance 0 (the reference's disabled teapot spin,
    kernel.cu:272-273).
    ``web``: serve the LIVE interactive viewer on this port instead of
    the timed loop (browser window + mouse orbit + WASD; app/web.py —
    the reference's disabled cv::imshow surface, kernel.cu:262-263).
    """
    backend = resolve_backend(backend)

    if scene_name == "demo":
        scene = build_demo_scene()
        if sky == "gradient":
            scene.set_sky(procgen.sky_gradient_texture())
        arrays = scene.compile()
        # Real fisheye calibration from the reference (kernel.cu:158-164),
        # exact at the native 1920-wide resolution, K rescaled otherwise.
        if calib or (width, height) == (1920, 1088):
            K, D = reference_calibration(width, height)
            camera = Camera(width, height, K, D)
        else:
            camera = Camera.looking(width, height, fov_deg=60.0)
        camera.pose = np.array([-1.0, -4.0, 2.0, 0, 0, 0], np.float32)
    else:
        from .scenes import SCENES

        arrays, camera = SCENES[scene_name](width, height) \
            if scene_name != "cube" and scene_name != "cornell" \
            else SCENES[scene_name](min(width, height))
        width, height = camera.width, camera.height
        if calib:
            K, D = reference_calibration(width, height)
            camera = Camera(width, height, K, D, pose=camera.pose)
    from ..render.pipeline import render_image_path_traced, render_image_whitted

    from ..render.integrators import PointLight

    plights = tuple(
        PointLight(position=tuple(p[:3]), intensity=p[3] if len(p) > 3 else 100.0)
        for p in point_lights
    )
    config = RenderConfig(
        width=width, height=height, backend=backend, lighting=lighting,
        light_direction=None if no_sun else DEFAULT_LIGHT_DIRECTION,
        point_lights=plights, texture_filter=texture_filter,
        ssaa=ssaa, path_lights=path_lights,
        tonemap=tonemap, exposure=exposure, denoise=denoise,
        normal_mode=normal_mode,
    )
    if web is not None:
        from .web import WebViewer

        WebViewer(
            arrays, camera, config, mode=mode, ao_radius=ao_radius,
        ).serve(host=web_host, port=web)
        return

    key = jax.random.PRNGKey(0)
    fps = 0.0
    angle = 0.0
    img = None
    for frame in range(frames):
        angle += 0.005
        if animate and scene_name == "demo":
            spun = MeshInstance(0, 2)
            spun.pose = np.array([0, 0, 0, angle, 0, 0], np.float32)
            arrays = arrays.update_instance(0, spun)
        if fly:
            from .controls import fly as fly_step

            camera.pose = fly_step(camera.pose, forward=0.03)
            camera.pose[3] += 0.004

        start = time.perf_counter()
        p = camera.ray_params()
        args = (config, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        if mode == "primary":
            img = render_image(*args)
        elif mode == "whitted":
            img = render_image_whitted(*args)
        elif mode == "path":
            key, sub = jax.random.split(key)
            img = render_image_path_traced(
                *args, sub, 3, 4, lens_radius, focus_distance)
        elif mode == "ao":
            from ..render.pipeline import render_image_ao

            key, sub = jax.random.split(key)
            img = render_image_ao(*args, sub, 8, ao_radius)
        else:
            raise ValueError(f"unknown mode {mode}")
        jax.block_until_ready(img)
        elapsed = time.perf_counter() - start
        fps = 1.0 / elapsed
        mrays = width * height * ssaa * ssaa / elapsed / 1e6
        print(f"FPS: {fps:.2f}  ({mrays:.1f} Mrays/s)")

    save_png(overlay_fps(np.asarray(img), fps), out)
    if aovs:
        from ..render.pipeline import render_aovs

        bufs = render_aovs(config, arrays, p["K_inv"], p["D"], p["pose"],
                           p["inv_pose"])
        stem = out[:-4] if out.endswith(".png") else out
        for name in aovs:
            save_png(_aov_to_u8(name, np.asarray(bufs[name])),
                     f"{stem}.{name}.png")
            print(f"AOV {name} -> {stem}.{name}.png")
    return np.asarray(img)


def _aov_to_u8(name: str, a: np.ndarray) -> np.ndarray:
    """Visualize an AOV buffer as u8 RGB: depth -> normalized inverse
    ramp (near = bright), normal -> [-1,1] remapped, uv -> RG, ids ->
    hashed palette, hit -> white on black."""
    if name == "depth":
        finite = np.isfinite(a)
        if finite.any():
            lo, hi = a[finite].min(), a[finite].max()
            g = np.where(finite, 1.0 - (a - lo) / max(hi - lo, 1e-9), 0.0)
        else:
            g = np.zeros_like(a)
        return np.repeat((g * 255).astype(np.uint8)[..., None], 3, -1)
    if name == "normal":
        return ((a * 0.5 + 0.5) * 255).astype(np.uint8)
    if name == "uv":
        img = np.zeros(a.shape[:-1] + (3,), np.uint8)
        img[..., 0] = (np.clip(a[..., 0], 0, 1) * 255).astype(np.uint8)
        img[..., 1] = (np.clip(a[..., 1], 0, 1) * 255).astype(np.uint8)
        return img
    if name in ("instance", "triangle"):
        h = (a.astype(np.int64) * 2654435761) & 0xFFFFFF
        img = np.stack([h & 0xFF, (h >> 8) & 0xFF, (h >> 16) & 0xFF], -1)
        return np.where((a >= 0)[..., None], img, 0).astype(np.uint8)
    return (a.astype(np.uint8) * 255)[..., None].repeat(3, -1)


def main():
    ap = argparse.ArgumentParser(description="tpu_raytracer demo app")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--backend", default=None, choices=list(BACKENDS),
                    help="traversal backend (default: cuda on a GPU, "
                         "bvh elsewhere)")
    ap.add_argument("--lighting", default="flat",
                    choices=["flat", "lambert", "lambert_shadow", "blinn_phong"])
    ap.add_argument("--scene", default="demo",
                    choices=["demo", "cube", "cornell", "bunny",
                             "instances", "colonnade"])
    ap.add_argument("--mode", default="primary",
                    choices=["primary", "whitted", "path", "ao"])
    ap.add_argument("--ao-radius", type=float, default=1.0,
                    help="--mode ao: world-space occlusion query radius")
    ap.add_argument("--web", type=int, default=None, metavar="PORT",
                    help="serve the live browser viewer on PORT "
                         "(mouse orbit + WASD fly; app/web.py) instead "
                         "of running the timed loop; honors --mode")
    ap.add_argument("--web-host", default="127.0.0.1",
                    help="viewer bind address (default loopback; the "
                         "viewer has no auth — 0.0.0.0 exposes camera "
                         "control to the network)")
    ap.add_argument("--fly", action="store_true",
                    help="animated camera fly-through")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--no-animate", action="store_true")
    ap.add_argument("--normal-mode", default="reference",
                    choices=["reference", "inverse_transpose"],
                    help="normal transform under instance scale: "
                         "reference = raycast.cu:115-122 parity (wrong "
                         "for nonuniform scale); inverse_transpose = "
                         "the correct R diag(1/s) transform")
    ap.add_argument("--calib", action="store_true",
                    help="use the reference app's real fisheye K/D "
                         "(kernel.cu:158-164; D != 0 exercises the full "
                         "Kannala-Brandt polynomial, raycast.cu:165-177), "
                         "K rescaled to the requested resolution")
    ap.add_argument(
        "--point-light", action="append", default=[], metavar="X,Y,Z[,I]",
        help="add a point light at X,Y,Z with intensity I (default 100); "
             "repeatable (raycast.cu:286-287 realized)")
    ap.add_argument("--no-sun", action="store_true",
                    help="drop the directional light (point lights only)")
    ap.add_argument("--tonemap", default="none",
                    choices=["none", "reinhard", "aces"],
                    help="HDR display mapping for whitted/path modes "
                         "(none = the reference's raw truncating cast)")
    ap.add_argument("--exposure", type=float, default=1.0,
                    help="linear exposure multiplier ahead of --tonemap")
    ap.add_argument("--denoise", type=int, default=0, metavar="N",
                    help="--mode path: N à-trous denoiser iterations "
                         "(edge-avoiding wavelet guided by first-hit "
                         "normal/depth; ~2^N pixel radius, 0 = off)")
    ap.add_argument("--path-lights", action="store_true",
                    help="--mode path: next-event estimation — sample "
                         "the sun/point lights directly per bounce "
                         "with shadow casts (converges in far fewer "
                         "samples than sky-only bounce lighting)")
    ap.add_argument("--lens-radius", type=float, default=0.0,
                    help="thin-lens aperture radius for --mode path "
                         "(0 = pinhole); blurs off-focal-plane surfaces")
    ap.add_argument("--focus-distance", type=float, default=4.0,
                    help="focal-plane distance for --lens-radius")
    ap.add_argument("--sky", default="flat", choices=["flat", "gradient"],
                    help="miss-ray sky: flat = the reference constant "
                         "(raycast.cu:211-213); gradient = procedural "
                         "equirect environment map (demo scene only)")
    ap.add_argument("--aov", action="append", default=[],
                    choices=["depth", "normal", "uv", "instance",
                             "triangle", "hit"],
                    help="also write this AOV buffer as <out>.<aov>.png; "
                         "repeatable")
    ap.add_argument("--ssaa", type=int, default=1,
                    help="supersampling factor: render at NxN subpixels "
                         "per pixel and box-average (1 = reference "
                         "parity, one ray per pixel)")
    ap.add_argument("--texture-filter", default="nearest",
                    choices=["nearest", "bilinear", "trilinear"],
                    help="nearest = reference-exact sampling "
                         "(raycast.cu:224-240); bilinear = smooth "
                         "framework extension")
    args = ap.parse_args()
    from ..utils import enable_compilation_cache

    enable_compilation_cache()  # repeat app runs skip recompiling
    # (utils/compile_cache.py; TRT_COMPILE_CACHE=0 opts out)
    plights = tuple(
        tuple(float(v) for v in spec.split(","))
        for spec in args.point_light
    )
    run(
        width=args.width, height=args.height, frames=args.frames,
        backend=args.backend, out=args.out, animate=not args.no_animate,
        lighting=args.lighting, scene_name=args.scene, mode=args.mode,
        fly=args.fly, point_lights=plights, no_sun=args.no_sun,
        texture_filter=args.texture_filter, ssaa=args.ssaa,
        aovs=tuple(args.aov), sky=args.sky,
        lens_radius=args.lens_radius, focus_distance=args.focus_distance,
        path_lights=args.path_lights,
        tonemap=args.tonemap, exposure=args.exposure,
        denoise=args.denoise, ao_radius=args.ao_radius, calib=args.calib,
        normal_mode=args.normal_mode, web=args.web,
        web_host=args.web_host,
    )


if __name__ == "__main__":
    main()
