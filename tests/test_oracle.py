"""Oracle tests on the CPU: the traversal kernel's host build (the same
native/traverse.h code the CUDA kernel runs) and the XLA walk against the
brute-force cast, at the tolerances of tpu_raytracer/oracle.py.

One parametrised test covers every oracle scene, both backends and each
query — closest-hit, any-hit and the kernel's carried u/v/n against
hit_attributes' redo; a second covers ray-batch shapes (an [H, W]
image, a flat batch, a count that fills no whole CUDA block, one ray).
The same checks run on the card in tests/test_gpu_oracle.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_raytracer.oracle import (
    ORACLE_SCENES, attr_agreement, brute_hits, camera_rays, hit_agreement,
    incidence_cos, oracle_scene, two_instance_scene,
)
from tpu_raytracer.render.renderer import get_cast_fn, occlusion_cast_fn

SIZE = 32


@functools.lru_cache(maxsize=None)
def _case(name):
    scene, cam = oracle_scene(name, SIZE)
    origin, directions = camera_rays(cam)
    want = brute_hits(scene, origin, directions)
    cos = incidence_cos(scene, origin, directions, want)
    return scene, origin, directions, want, cos


# the XLA walk carries no attributes, so it has no "attrs" case
QUERIES = [("cuda", "closest"), ("cuda", "any_hit"), ("cuda", "attrs"),
           ("bvh", "closest"), ("bvh", "any_hit")]


@pytest.mark.parametrize("backend,query", QUERIES)
@pytest.mark.parametrize("name", ORACLE_SCENES)
def test_backend_matches_brute(name, backend, query):
    scene, origin, directions, want, cos = _case(name)
    assert int((np.asarray(want.t) < 3e38).sum()) > 0, "scene not in view"
    if query == "any_hit":
        got = jax.jit(occlusion_cast_fn(backend))(scene, origin, directions)
        result = hit_agreement(got, want, any_hit=True)
    else:
        got = jax.jit(get_cast_fn(backend, want_normals=True))(
            scene, origin, directions)
        if query == "closest":
            result = hit_agreement(got, want, cos=cos)
        else:
            assert got.u is not None and got.n is not None
            assert got.n.shape == directions.shape
            result = attr_agreement(scene, origin, directions, got)
    assert result["ok"], result


@pytest.mark.parametrize("backend", ["cuda", "bvh"])
@pytest.mark.parametrize("layout", ["image", "flat", "ragged", "one_ray"])
def test_ray_batch_shapes(backend, layout):
    """Hit records keep the rays' leading shape, and a batch that fills
    no whole 128-ray block (the CUDA launch granularity) or holds one
    ray gives the same hits as the full image."""
    scene, cam = two_instance_scene(24)
    origin, directions = camera_rays(cam)
    full = jax.jit(get_cast_fn(backend, want_normals=True))(
        scene, origin, directions)
    d = np.asarray(directions)
    pick = {
        "image": d,
        "flat": d.reshape(-1, 3),
        "ragged": d.reshape(-1, 3)[:301],
        "one_ray": d[12, 12],
    }[layout]
    got = jax.jit(get_cast_fn(backend, want_normals=True))(
        scene, origin, jnp.asarray(pick))
    assert got.t.shape == pick.shape[:-1]
    assert got.tri.shape == got.inst.shape == pick.shape[:-1]
    if got.n is not None:
        assert got.n.shape == pick.shape
        assert got.u.shape == got.v.shape == pick.shape[:-1]
    ref = {
        "image": lambda a: a,
        "flat": lambda a: a.reshape((-1,) + a.shape[2:]),
        "ragged": lambda a: a.reshape((-1,) + a.shape[2:])[:301],
        "one_ray": lambda a: a[12, 12],
    }[layout]
    for field in ("t", "tri", "inst"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, field)),
            ref(np.asarray(getattr(full, field))))
