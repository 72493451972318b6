"""Interactive viewer — the event loop the reference wires but leaves
disabled (cv::imshow window + mouse orbit, kernel.cu:262-263/113-139;
WASD fly, kernel.cu:51-104), done terminal-native.

No OpenCV window exists on a headless render host, so the display is
the terminal itself: frames are downsampled and drawn as ANSI truecolor half-blocks
(two pixels per character cell), which works over any ssh session. The
camera pose is a per-frame runtime argument to the jitted renderer
(Camera.cu:29-31 analog), so keystrokes never trigger recompilation —
the event loop's steady-state cost is exactly one render per frame.

Keys: w/a/s/d move, q/e down/up, i/j/k/l orbit (the mouse-drag analog,
kernel.cu:131-132), +/- speed, p save PNG, x or ESC quit.

Headless use: ``run_interactive(keys=iter("wwdx"))`` consumes scripted
keys instead of the TTY (used by the CPU test suite).
"""

from __future__ import annotations

import select
import sys
import time

import jax
import numpy as np

from ..render import RenderConfig
from ..render.pipeline import render_image
from ..utils import save_png
from .controls import fly, orbit

ORBIT_STEP = 40.0  # x ORBIT_SENSITIVITY=0.001 => 0.04 rad per press


class _RawTerminal:
    """cbreak + no-echo stdin for the lifetime of the loop."""

    def __enter__(self):
        import termios
        import tty

        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        import termios

        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    @staticmethod
    def poll_key(timeout: float = 0.0) -> str | None:
        r, _, _ = select.select([sys.stdin], [], [], timeout)
        return sys.stdin.read(1) if r else None


def ansi_preview(img: np.ndarray, cols: int = 80) -> str:
    """Render [H, W, 3] u8 as ANSI truecolor half-blocks, two image
    rows per terminal line (the upper pixel is the glyph foreground,
    the lower the background)."""
    h, w = img.shape[:2]
    cols = max(2, min(cols, w))
    ys = np.linspace(0, h - 1, (cols * h // w) & ~1, dtype=int)
    xs = np.linspace(0, w - 1, cols, dtype=int)
    small = img[np.ix_(ys, xs)]
    lines = []
    for r in range(0, small.shape[0] - 1, 2):
        top, bot = small[r], small[r + 1]
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        ]
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def apply_key(pose: np.ndarray, key: str, speed: float = 0.15) -> tuple:
    """One keystroke -> (new_pose, action). Pure (testable): action is
    None | 'quit' | 'shot' | 'speed+' | 'speed-'."""
    moves = {
        "w": dict(forward=speed), "s": dict(forward=-speed),
        "a": dict(right=-speed), "d": dict(right=speed),
        "e": dict(up=speed), "q": dict(up=-speed),
    }
    if key in moves:
        return fly(pose, **moves[key]), None
    orbits = {"j": (-ORBIT_STEP, 0), "l": (ORBIT_STEP, 0),
              "i": (0, ORBIT_STEP), "k": (0, -ORBIT_STEP)}
    if key in orbits:
        return orbit(pose, *orbits[key]), None
    if key in ("x", "\x1b"):
        return pose, "quit"
    if key == "p":
        return pose, "shot"
    if key == "+":
        return pose, "speed+"
    if key == "-":
        return pose, "speed-"
    return pose, None


def run_interactive(
    scene_name: str = "demo",
    width: int = 256,
    height: int = 256,
    backend: str | None = None,
    keys=None,
    max_frames: int | None = None,
    preview: bool | None = None,
    out: str = "interactive.png",
    mode: str = "primary",
    bounces: int = 2,
    tonemap: str = "reinhard",
    exposure: float = 1.0,
):
    """The interactive render loop. ``keys=None`` reads the TTY;
    otherwise consumes the iterator (headless/scripted mode). Returns
    the last rendered frame as np.uint8 [H, W, 3].

    ``mode='path'`` renders PROGRESSIVELY: each frame adds one
    path-traced sample (render_radiance_path_traced) to a linear-space
    accumulator that resets whenever the camera moves — hold still and
    the image converges, sample count shown in the status line. The
    accumulator lives on device; only the tonemapped u8 preview comes
    back per frame. 'r' forces a reset."""
    from .driver import build_demo_scene
    from .scenes import SCENES
    from ..render import Camera

    from ..render.renderer import resolve_backend

    backend = resolve_backend(backend)
    if scene_name == "demo":
        arrays = build_demo_scene().compile()
        camera = Camera.looking(width, height, fov_deg=60.0,
                                pose=[-1.0, -4.0, 2.0, 0, 0, 0])
    elif scene_name in ("cube", "cornell"):  # square-size constructors
        arrays, camera = SCENES[scene_name](min(width, height))
        width, height = camera.width, camera.height
    else:
        arrays, camera = SCENES[scene_name](width, height)
        width, height = camera.width, camera.height
    config = RenderConfig(width=width, height=height, backend=backend,
                          tonemap=tonemap, exposure=exposure)

    if mode == "path":
        from ..render.integrators import to_u8
        from ..render.integrators import tonemap as tonemap_fn
        from ..render.pipeline import render_radiance_path_traced

        @jax.jit
        def sample(scene, K_inv, D, pose, inv_pose, key):
            return render_radiance_path_traced(
                config, scene, K_inv, D, pose, inv_pose, key,
                max_bounces=bounces, samples=1,
            )

        @jax.jit
        def display(acc, n):
            return to_u8(tonemap_fn(acc / n, config.tonemap, config.exposure))
    else:
        @jax.jit
        def frame(scene, K_inv, D, pose, inv_pose):
            return render_image(config, scene, K_inv, D, pose, inv_pose)

    scripted = keys is not None
    if preview is None:
        preview = not scripted and sys.stdout.isatty()

    speed = 0.15
    n = 0
    img = None
    acc = None  # path mode: on-device radiance sum since last move
    n_acc = 0
    rng = jax.random.PRNGKey(0)
    ctx = _RawTerminal() if not scripted else None
    try:
        if ctx is not None:
            ctx.__enter__()
        while True:
            t0 = time.perf_counter()
            p = camera.ray_params()
            if mode == "path":
                rng, k = jax.random.split(rng)
                rad = sample(arrays, p["K_inv"], p["D"], p["pose"],
                             p["inv_pose"], k)
                acc = rad if acc is None else acc + rad
                n_acc += 1
                img = np.asarray(display(acc, np.float32(n_acc)))
            else:
                img = np.asarray(
                    frame(arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
                )
            dt = time.perf_counter() - t0
            n += 1
            if preview:
                spp = f"  {n_acc} spp" if mode == "path" else ""
                sys.stdout.write("\x1b[H\x1b[2J" + ansi_preview(img))
                sys.stdout.write(
                    f"\n{1/dt:6.1f} fps{spp}  pose={np.round(camera.pose, 2)}  "
                    "[wasdqe move, ijkl orbit, p shot, x quit]\n"
                )
                sys.stdout.flush()
            if max_frames is not None and n >= max_frames:
                break
            key = next(keys, None) if scripted else _RawTerminal.poll_key(0.01)
            if key is None and scripted:
                break
            if key is not None:
                pose0 = camera.pose
                camera.pose, action = apply_key(camera.pose, key, speed)
                if action == "quit":
                    break
                if action == "shot":
                    save_png(img, out)
                if action == "speed+":
                    speed *= 1.5
                if action == "speed-":
                    speed /= 1.5
                # progressive accumulation only holds for a still
                # camera: restart on any pose change (or explicit 'r')
                if key == "r" or not np.array_equal(pose0, camera.pose):
                    acc, n_acc = None, 0
    finally:
        if ctx is not None:
            ctx.__exit__()
    if img is not None:
        save_png(img, out)
    return img


def main():
    import argparse

    ap = argparse.ArgumentParser(description="interactive fly-around viewer")
    ap.add_argument("--scene", default="demo")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--backend", default=None,
                    choices=["brute", "bvh", "cuda"])
    ap.add_argument("--out", default="interactive.png")
    ap.add_argument("--mode", default="primary",
                    choices=["primary", "path"],
                    help="path = progressive path tracing: +1 sample "
                         "per frame while the camera holds still")
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--tonemap", default="reinhard",
                    choices=["none", "reinhard", "aces"])
    ap.add_argument("--exposure", type=float, default=1.0)
    args = ap.parse_args()
    run_interactive(scene_name=args.scene, width=args.width,
                    height=args.height, backend=args.backend, out=args.out,
                    mode=args.mode, bounces=args.bounces,
                    tonemap=args.tonemap, exposure=args.exposure)


if __name__ == "__main__":
    main()
