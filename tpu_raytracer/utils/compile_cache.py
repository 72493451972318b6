"""Persistent XLA compilation cache.

A JAX process pays every compile once per run unless the persistent
cache is on; with it, repeat runs of an unchanged jit load the compiled
executable instead. Entries are keyed on the computation, compile
options and backend version, so correctness is unaffected.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR``, when set — JAX reads it itself, and
  no other directory is set in code;
* otherwise ``.cache/xla`` inside the checkout (git-ignored). The path
  is fixed because it is part of the cache key: a directory that moves
  never hits.

Opt out with ``TRT_COMPILE_CACHE=0``. The app driver, the interactive
viewers, the bench entry points and ``chip_smoke.py`` call
:func:`enable`; library users embedding ``tpu_raytracer`` call it
themselves (JAX global config, so the embedding application owns the
decision).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache", "xla",
)

_enabled = False


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the
    checkout's fixed default."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> bool:
    """Turn on JAX's persistent compilation cache (idempotent).

    Returns True if the cache is active after the call."""
    global _enabled
    if os.environ.get("TRT_COMPILE_CACHE", "1") in ("0", ""):
        return False
    if _enabled:
        return True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # cache every computation that takes >=1s to compile; tiny jits stay
    # uncached to keep the cache dir lean
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _enabled = True
    return True
