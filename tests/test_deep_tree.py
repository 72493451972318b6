"""Traversal stacks hold the deepest tree the builders make.

A hand-built "caterpillar" BVH reaches MAX_BVH_DEPTH: each internal node
has the rest of the chain as its near child and a leaf as its far child,
so a walk descending the chain leaves one pending leaf per level on its
stack — 48 entries at the bottom. The only triangle the rays can hit sits
in the leaf pushed at stack index 45; a stack shorter than the tree
drops that push and loses the hit."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_raytracer.accel.bvh import MAX_BVH_DEPTH, BVHArrays
from tpu_raytracer.render.renderer import cast_rays_brute, get_cast_fn
from tpu_raytracer.scene import Material, MeshInstance, MeshPrimitive, Scene

HIT_LEAF = 45  # far leaf of chain level 46, pushed at stack index 45


def _caterpillar_scene():
    levels = MAX_BVH_DEPTH - 1  # internal nodes at depths 1..47
    nodes = []  # [min, max, child_a, child_b, leaf_start, leaf_count]
    tris = []  # per leaf slot: chain index j of the leaf's triangle

    def leaf(j, lo, hi):
        nodes.append([lo, hi, -1, -1, len(tris), 1])
        tris.append(j)
        return len(nodes) - 1

    chain_box = ([-1.0, 1.0, -1.0], [6.0, 2.0, 1.0])

    def far_box(j):
        y = 10.0 + j
        return [-1.0, y, -1.0], [6.0, y + 0.5, 1.0]

    def build(k):  # internal node at depth k
        nodes.append([*chain_box, -1, -1, 0, 0])
        me = len(nodes) - 1
        if k < levels:
            a = build(k + 1)
        else:
            a = leaf(levels, *chain_box)  # the deepest leaf, depth 48
        b = leaf(k - 1, *far_box(k - 1))
        nodes[me][2], nodes[me][3] = a, b
        return me

    build(1)
    v0, v1, v2 = [], [], []
    for j in tris:
        if j == HIT_LEAF:  # in the rays' path, facing them (-y)
            y, x0 = 10.0 + j + 0.2, -1.0
        else:  # off to the side: every ray misses it
            y, x0 = (10.0 + j + 0.2) if j < levels else 1.5, 4.0
        v0.append([x0, y, -1.0])
        v1.append([x0 + 2.0, y, -1.0])
        v2.append([x0, y, 1.0])
    v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
    n = np.cross(v1 - v0, v2 - v0)
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    uv = np.zeros((len(tris), 2), np.float32)
    bvh = BVHArrays(
        node_min=np.asarray([r[0] for r in nodes], np.float32),
        node_max=np.asarray([r[1] for r in nodes], np.float32),
        child_a=np.asarray([r[2] for r in nodes], np.int32),
        child_b=np.asarray([r[3] for r in nodes], np.int32),
        leaf_start=np.asarray([r[4] for r in nodes], np.int32),
        leaf_count=np.asarray([r[5] for r in nodes], np.int32),
        order=np.arange(len(tris), dtype=np.int32),
    )
    scene = Scene()
    scene.add_material(Material())
    scene.add_mesh(MeshPrimitive(v0, v1, v2, n, uv, uv, uv, bvh))
    scene.add_mesh_instance(MeshInstance(0, 0))
    return scene.compile(box_pad_ulp=0.0), bvh, tris.index(HIT_LEAF)


def test_caterpillar_reaches_max_depth():
    _, bvh, _ = _caterpillar_scene()
    # stats() counts the root as depth 0, the builders as depth 1
    assert bvh.stats()["max_depth"] + 1 == MAX_BVH_DEPTH


@pytest.mark.parametrize("backend", ["bvh", "cuda"])
def test_deep_tree_hit_matches_brute(backend):
    arrays, _, hit_slot = _caterpillar_scene()
    g = np.linspace(-0.6, -0.2, 3, dtype=np.float32)
    d = np.stack(np.meshgrid(g * 0.01, [1.0], g * 0.01), -1).reshape(-1, 3)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    o = np.zeros(3, np.float32) + np.array([-0.3, 0.0, -0.3], np.float32)
    want = cast_rays_brute(arrays, jnp.asarray(o), jnp.asarray(d))
    got = get_cast_fn(backend)(arrays, jnp.asarray(o), jnp.asarray(d))
    assert (np.asarray(want.tri) == hit_slot).all()
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(want.tri))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(want.t),
                               rtol=1e-6)


def test_mesh_rejects_depth_beyond_stack():
    v = np.zeros((1, 3), np.float32)
    with pytest.raises(ValueError, match="max_depth"):
        MeshPrimitive.from_triangles(v, v + [1, 0, 0], v + [0, 0, 1],
                                     max_depth=MAX_BVH_DEPTH + 1)
