"""Profiling + metrics instrumentation.

The reference's profiling surface is wall-clock FPS via cv::getTickCount
(kernel.cu:275-293) plus an out-of-band Nsight Compute capture
(.MISSING_LARGE_BLOBS:1). Here that maps to:

  * ``FrameTimer`` — per-frame FPS / Mrays/s counters (the in-loop
    instrumentation);
  * ``trace`` — a jax.profiler capture producing an XProf/Perfetto
    trace directory (the ncu-rep analog, viewable in TensorBoard).
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str = "chiprun_out/trace"):
    """Capture a device trace for the enclosed renders (ncu-rep analog).

    View with: tensorboard --logdir <log_dir>  (Profile tab)
    """
    with jax.profiler.trace(log_dir):
        yield log_dir


class FrameTimer:
    """Rolling FPS / Mrays/s counter (kernel.cu:275-293 analog)."""

    def __init__(self, rays_per_frame: int):
        self.rays_per_frame = rays_per_frame
        self.reset()

    def reset(self):
        self.frames = 0
        self.total_s = 0.0
        self.last_fps = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.frames += 1
        self.total_s += dt
        self.last_fps = 1.0 / dt if dt > 0 else float("inf")
        return False

    @property
    def fps(self) -> float:
        return self.frames / self.total_s if self.total_s else 0.0

    @property
    def mrays_per_s(self) -> float:
        return self.fps * self.rays_per_frame / 1e6

    def summary(self) -> str:
        return (
            f"{self.frames} frames, {self.fps:.2f} FPS, "
            f"{self.mrays_per_s:.1f} Mrays/s"
        )
