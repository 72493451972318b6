"""Triangle pre-splitting (accel/presplit.py): ref invariants, build
integration (order with duplicates), and render equivalence through the
walk and the traversal kernel. Pre-splitting changes node membership only — the triangle
records any backend tests are identical rows, so depth/hit AOVs are
bit-equal to the unsplit tree and the brute oracle matches exactly."""

import os

import numpy as np

from tpu_raytracer.accel.bvh import build_bvh
from tpu_raytracer.accel.presplit import presplit_refs
from tpu_raytracer.scene import procgen


def _colonnade():
    return procgen.colonnade(3, 3, 8, bands=8)


def test_noop_on_uniform_mesh():
    v0, v1, v2 = procgen.blob(subdivisions=3)
    assert presplit_refs(v0, v1, v2) is None


def test_ref_invariants():
    v0, v1, v2 = _colonnade()
    refs = presplit_refs(v0, v1, v2, budget_factor=0.3)
    assert refs is not None
    ref_tri, ref_min, ref_max = refs
    num = len(v0)
    # every triangle keeps at least one ref; split count within budget
    assert set(ref_tri.tolist()) == set(range(num))
    assert len(ref_tri) > num
    assert len(ref_tri) <= num + int(0.3 * num) + 1
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    # each ref box inside its triangle's box (one-ulp conservative)
    eps = 1e-5
    assert (ref_min >= tri_min[ref_tri] - eps).all()
    assert (ref_max <= tri_max[ref_tri] + eps).all()
    # the union of a triangle's ref boxes covers all three vertices
    for t in np.unique(ref_tri[np.bincount(ref_tri, minlength=num)[ref_tri] > 1]):
        sel = ref_tri == t
        for v in (v0[t], v1[t], v2[t]):
            inside = ((ref_min[sel] <= v + eps) & (v - eps <= ref_max[sel])).all(axis=1)
            assert inside.any(), f"vertex of tri {t} not covered by any ref"


def test_build_with_refs_layout_contract():
    v0, v1, v2 = _colonnade()
    refs = presplit_refs(v0, v1, v2, budget_factor=0.3)
    bvh = build_bvh(v0, v1, v2, min_leaf_size=16, mode="sweep", refs=refs)
    R = len(refs[0])
    assert len(bvh.order) == R
    # order maps into the original triangle id space, with duplicates
    assert bvh.order.min() >= 0 and bvh.order.max() < len(v0)
    assert set(bvh.order.tolist()) == set(range(len(v0)))
    # leaf ranges partition [0, R) ascending in DFS leaf order (the
    # wide/paging layout contract, same as test_optimize invariants)
    is_leaf = bvh.child_a < 0
    idx = np.nonzero(is_leaf)[0]
    starts = bvh.leaf_start[idx]
    counts = bvh.leaf_count[idx]
    assert starts[0] == 0
    np.testing.assert_array_equal(starts[1:], starts[:-1] + counts[:-1])
    assert starts[-1] + counts[-1] == R
    internal = np.nonzero(~is_leaf)[0]
    np.testing.assert_array_equal(bvh.child_a[internal], internal + 1)
    for i in internal:
        for c in (bvh.child_a[i], bvh.child_b[i]):
            assert (bvh.node_min[c] >= bvh.node_min[i] - 1e-6).all()
            assert (bvh.node_max[c] <= bvh.node_max[i] + 1e-6).all()


def _compile_scene(presplit: str | None):
    from tpu_raytracer.scene import Material, MeshInstance, MeshPrimitive, Scene

    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.6, 0.3)))
    v0, v1, v2 = _colonnade()
    prev = os.environ.get("TRT_BVH_PRESPLIT")
    if presplit is not None:
        os.environ["TRT_BVH_PRESPLIT"] = presplit
    try:
        scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2))
    finally:
        if prev is None:
            os.environ.pop("TRT_BVH_PRESPLIT", None)
        else:
            os.environ["TRT_BVH_PRESPLIT"] = prev
    scene.add_mesh_instance(MeshInstance(0, 0))
    return scene.compile()


def test_presplit_scene_oracle_and_depth_equality():
    from tpu_raytracer.render import Camera, RenderConfig
    from tpu_raytracer.render.pipeline import render_aovs, render_image

    cam = Camera.looking(64, 64, fov_deg=65.0, pose=[1.0, -1.5, 1.2, 0, 0, 0])
    p = cam.ray_params()
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])

    plain = _compile_scene(None)
    split = _compile_scene("0.3")
    assert split.tri_v0.shape[0] > plain.tri_v0.shape[0]  # refs duplicated

    # BVH walk over the presplit tree == brute oracle over the SAME
    # compiled arrays, bit-for-bit (the kernels' oracle contract)
    cfg_bvh = RenderConfig(cam.width, cam.height, backend="bvh")
    cfg_brute = RenderConfig(cam.width, cam.height, backend="brute")
    img_bvh = np.asarray(render_image(cfg_bvh, split, *args))
    img_brute = np.asarray(render_image(cfg_brute, split, *args))
    np.testing.assert_array_equal(img_bvh, img_brute)

    # vs the UNSPLIT tree: t-ties between distinct triangles may flip
    # identity, but depth and hit coverage are tie-invariant
    a_plain = render_aovs(cfg_bvh, plain, *args)
    a_split = render_aovs(cfg_bvh, split, *args)
    np.testing.assert_array_equal(np.asarray(a_plain["hit"]),
                                  np.asarray(a_split["hit"]))
    np.testing.assert_array_equal(np.asarray(a_plain["depth"]),
                                  np.asarray(a_split["depth"]))


def test_presplit_is_opt_in(monkeypatch):
    """Presplit runs only when TRT_BVH_PRESPLIT asks for it: a default
    build of the colonnade keeps one ref per triangle."""
    monkeypatch.delenv("TRT_BVH_PRESPLIT", raising=False)
    v0, _, _ = _colonnade()
    assert _compile_scene(None).tri_v0.shape[0] == len(v0)


def test_presplit_tree_kernel_matches_brute():
    """The traversal kernel over a tree with duplicated refs agrees with
    the brute oracle on the same compiled arrays."""
    import jax

    from tpu_raytracer.oracle import (
        brute_hits, camera_rays, hit_agreement, incidence_cos,
    )
    from tpu_raytracer.render import Camera
    from tpu_raytracer.render.renderer import get_cast_fn

    split = _compile_scene("0.3")
    cam = Camera.looking(48, 48, fov_deg=65.0, pose=[1.0, -1.5, 1.2, 0, 0, 0])
    o, d = camera_rays(cam)
    want = brute_hits(split, o, d)
    got = jax.jit(get_cast_fn("cuda"))(split, o, d)
    result = hit_agreement(got, want, cos=incidence_cos(split, o, d, want))
    assert result["ok"], result
