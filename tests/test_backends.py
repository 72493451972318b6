"""Backend choice: one function picks the traversal backend from the
platform, removed backend names are errors, and the kernel's tables and
native build behave as the FFI call expects."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from tpu_raytracer.render import renderer
from tpu_raytracer.render.renderer import (
    BACKENDS, default_backend, get_cast_fn, occlusion_cast_fn, resolve_backend,
)


def test_default_backend_on_cpu_is_the_walk():
    assert jax.default_backend() == "cpu"
    assert default_backend() == "bvh"
    assert resolve_backend(None) == "bvh"


def test_default_backend_on_gpu_is_the_kernel(monkeypatch):
    monkeypatch.setattr(renderer.jax, "default_backend", lambda: "gpu")
    assert default_backend() == "cuda"
    assert resolve_backend(None) == "cuda"


@pytest.mark.parametrize("name", BACKENDS)
def test_known_backends_pass_through(name):
    assert resolve_backend(name) == name
    assert callable(get_cast_fn(name))
    assert callable(occlusion_cast_fn(name))


@pytest.mark.parametrize("name", ["pallas", "paged", "paged_major"])
def test_removed_backends_raise(name):
    with pytest.raises(ValueError, match="removed"):
        resolve_backend(name)
    with pytest.raises(ValueError, match="removed"):
        get_cast_fn(name)
    with pytest.raises(ValueError, match="removed"):
        occlusion_cast_fn(name)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        get_cast_fn("optix")


def test_render_config_default_follows_platform():
    from tpu_raytracer.oracle import cube_scene
    from tpu_raytracer.render import render

    arrays, cam = cube_scene(size=16)
    np.testing.assert_array_equal(
        np.asarray(render(cam, arrays)),
        np.asarray(render(cam, arrays, backend="bvh")),
    )


@pytest.mark.parametrize("module", ["tpu_raytracer.app.driver",
                                    "tpu_raytracer.app.interactive"])
@pytest.mark.parametrize("name", ["pallas", "paged"])
def test_cli_rejects_removed_backends(module, name):
    out = subprocess.run(
        [sys.executable, "-m", module, "--backend", name],
        capture_output=True, text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"},
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 2
    assert "invalid choice" in out.stderr


def test_pack_nodes_layout():
    """Internal nodes carry both children's boxes and indices; leaves
    carry -(first triangle) - 1 and their count (native/traverse.h)."""
    from tpu_raytracer.kernels.traverse import pack_nodes
    from tpu_raytracer.oracle import sphere_scene

    arrays, _ = sphere_scene(2)
    rec = np.asarray(pack_nodes(arrays))
    ca = np.asarray(arrays.node_child_a)
    cb = np.asarray(arrays.node_child_b)
    assert rec.shape == (ca.shape[0], 16)
    inner = ca >= 0
    np.testing.assert_array_equal(rec[inner, 3], ca[inner])
    np.testing.assert_array_equal(rec[inner, 7], cb[inner])
    as_f = lambda a: a.view(np.float32)
    np.testing.assert_array_equal(
        as_f(rec[inner, 0:3]), np.asarray(arrays.node_min)[ca[inner]])
    np.testing.assert_array_equal(
        as_f(rec[inner, 12:15]), np.asarray(arrays.node_max)[cb[inner]])
    leaf = ~inner
    np.testing.assert_array_equal(
        -rec[leaf, 3] - 1, np.asarray(arrays.node_leaf_start)[leaf])
    np.testing.assert_array_equal(
        rec[leaf, 7], np.asarray(arrays.node_leaf_count)[leaf])


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """A build that fails raises with the compiler's output; nothing
    falls back to another backend."""
    from tpu_raytracer.utils import native

    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "Makefile").write_text(
        "build/libbroken.so:\n\t@echo compiler says no >&2; exit 1\n")
    with pytest.raises(RuntimeError, match="compiler says no"):
        native.build_library("libbroken.so")
