"""Persistent XLA compilation cache (utils/compile_cache.py).

These tests check the enable() wiring: idempotence, opt-out, where the
cache lives (the environment's directory when JAX_COMPILATION_CACHE_DIR
is set, else the checkout's fixed .cache/xla), and that a compiled
executable actually lands in (and is served from) the cache directory
across processes. The cross-process check reads deterministic signals —
JAX's own cache-hit events and the entry count — never wall-clock time."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
from jax import monitoring
from tpu_raytracer.utils import compile_cache
hits = []
monitoring.register_event_listener(
    lambda name, **kw: hits.append(name)
    if name == "/jax/compilation_cache/cache_hits" else None)
assert compile_cache.enable() is True
print("CACHE_DIR", compile_cache.cache_dir())
# persist every executable, however fast it compiled on this host
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
import jax.numpy as jnp

@jax.jit
def f(x):
    for i in range(8):
        x = jnp.tanh(x @ x.T + float(i)) @ x
    return x.sum()

f(jnp.ones((128, 128))).block_until_ready()
print("CACHE_HITS", len(hits))
"""


def _run_child(env_updates):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_updates)
    out = subprocess.run(
        [sys.executable, "-c", CHILD],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    lines = dict(
        l.split(" ", 1) for l in out.stdout.splitlines()
        if l.startswith(("CACHE_DIR", "CACHE_HITS"))
    )
    return lines["CACHE_DIR"], int(lines["CACHE_HITS"])


def _entries(path):
    return sorted(f for f in os.listdir(path) if not f.startswith("."))


def test_cache_roundtrip_across_processes(tmp_path):
    cache = tmp_path / "xla"
    used, cold_hits = _run_child({"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert used == str(cache)
    assert cold_hits == 0
    files = _entries(cache)
    assert files, "no executable persisted to the cache dir"
    _, warm_hits = _run_child({"JAX_COMPILATION_CACHE_DIR": str(cache)})
    # the warm child loads the executable instead of compiling it, so
    # it reports a cache hit and persists nothing new
    assert warm_hits >= 1
    assert _entries(cache) == files


def test_environment_dir_wins(monkeypatch, tmp_path):
    import jax

    import tpu_raytracer.utils.compile_cache as cc

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setattr(cc, "_enabled", False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cc.cache_dir() == str(tmp_path / "env")
        assert cc.enable() is True
        # no directory is set in code: JAX keeps what it read itself
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_dir_is_fixed_in_checkout(monkeypatch):
    import jax

    import tpu_raytracer.utils.compile_cache as cc

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cc, "_enabled", False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cc.cache_dir() == os.path.join(REPO, ".cache", "xla")
        assert cc.enable() is True
        assert jax.config.jax_compilation_cache_dir == cc.DEFAULT_DIR
        assert os.path.isdir(cc.DEFAULT_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_opt_out_env(monkeypatch):
    import tpu_raytracer.utils.compile_cache as cc

    monkeypatch.setenv("TRT_COMPILE_CACHE", "0")
    monkeypatch.setattr(cc, "_enabled", False)
    assert cc.enable() is False


def test_idempotent(monkeypatch):
    import tpu_raytracer.utils.compile_cache as cc

    monkeypatch.setattr(cc, "_enabled", True)  # pretend a prior enable ran
    assert cc.enable() is True
