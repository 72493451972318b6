"""Builds the native libraries from ``native/`` sources on first use.

Every library comes from one ``make`` target of ``native/Makefile`` and
lands in ``native/build/`` (git-ignored). Builds are serialised by a file
lock, so test workers or processes that start together never race on the
same output; ``make`` skips what is already up to date.
"""

from __future__ import annotations

import fcntl
import pathlib
import subprocess

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "native"
BUILD_DIR = NATIVE_DIR / "build"


def build_library(name: str, timeout: float = 600.0) -> pathlib.Path:
    """Run ``make -C native build/<name>`` and return the library's path.
    Raises RuntimeError with the compiler's output when the build fails."""
    import jax.ffi

    BUILD_DIR.mkdir(exist_ok=True)
    target = BUILD_DIR / name
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            out = subprocess.run(
                ["make", "-C", str(NATIVE_DIR), f"build/{name}",
                 f"JAX_FFI_INCLUDE={jax.ffi.include_dir()}"],
                capture_output=True, text=True, timeout=timeout,
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building {name} failed: {e}") from e
    if out.returncode != 0 or not target.exists():
        raise RuntimeError(
            f"building {name} failed (make exit {out.returncode}):\n"
            f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}"
        )
    return target
