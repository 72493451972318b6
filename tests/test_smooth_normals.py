"""Smooth vertex normals — the reference's vn scaffolding realized.

The reference collects `vn` records (OBJLoader.hpp:55-62) and carries a
disabled normal-interpolation fan path (OBJLoader.hpp:119-135); this is
the opt-in realization: objloader parses
per-corner vn triples, Scene.compile packs them as SceneArrays.tri_vnorm
(a static-presence gate like has_sky/has_textures), and hit_attributes
interpolates them at the hit barycentrics before the world transform.
The analytic oracle: a unit sphere's exact normal IS the hit point
direction, so smooth normals on a coarse icosphere must track it far
better than face normals.
"""

import numpy as np

from tpu_raytracer.render import Camera, RenderConfig
from tpu_raytracer.render.pipeline import render_aovs
from tpu_raytracer.scene import (
    Material, MeshInstance, MeshPrimitive, Scene, objloader, procgen,
)

SPHERE_OBJ = """
v 0 0 1
v 1 0 0
v 0 1 0
v -1 0 0
vt 0 0
vt 1 0
vt 0 1
vt 1 1
vn 0 0 1
vn 1 0 0
vn 0 1 0
vn -1 0 0
f 1//1 2//2 3//3
f 1//1 3//3 4//4
f 1/1/1 2/2/2 4/4/4
f 1 2 3
"""


def test_parse_obj_vertex_normals():
    vn0, vn1, vn2, mask = objloader.parse_obj_vertex_normals(SPHERE_OBJ)
    # 4 faces, all triangles (fan of size 1 each)
    assert mask.shape == (4,)
    # faces 1-3 carry complete vn indices (v//vn and v/vt/vn); the bare
    # 'f v v v' face degrades to face normals
    assert mask.tolist() == [True, True, True, False]
    np.testing.assert_array_equal(vn0[0], [0, 0, 1])
    np.testing.assert_array_equal(vn1[0], [1, 0, 0])
    np.testing.assert_array_equal(vn2[1], [-1, 0, 0])
    np.testing.assert_array_equal(vn2[2], [-1, 0, 0])
    np.testing.assert_array_equal(vn0[3], [0, 0, 0])
    # alignment: same triangle count/order as the geometry parser
    v0, *_ = objloader.parse_obj(SPHERE_OBJ)
    assert len(v0) == len(mask)


def test_loads_attaches_vn():
    mesh = objloader.loads(SPHERE_OBJ, vertex_normals=True)
    assert mesh.vn0 is not None and mesh.vn_mask.sum() == 3
    # parity default: vn ignored (the reference's branch is disabled)
    mesh_flat = objloader.loads(SPHERE_OBJ)
    assert mesh_flat.vn0 is None


def _sphere_scene(smooth: bool, subdiv: int = 2):
    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.3, 0.2)))
    v0, v1, v2 = procgen.icosphere(subdiv)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    kw = {}
    if smooth:
        # analytic vertex normals of the unit sphere: the positions
        kw = dict(vn0=unit(v0), vn1=unit(v1), vn2=unit(v2),
                  vn_mask=np.ones(len(v0), bool))
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2, **kw))
    scene.add_mesh_instance(MeshInstance(0, 0))
    cam = Camera.looking(48, 48, fov_deg=40.0, pose=[0, -3.5, 0, 0, 0, 0])
    return scene, cam


def _hit_normals(arrays, cam):
    from tpu_raytracer.render.camera import generate_rays

    cfg = RenderConfig(cam.width, cam.height, backend="bvh")
    p = cam.ray_params()
    aovs = render_aovs(cfg, arrays, p["K_inv"], p["D"], p["pose"],
                       p["inv_pose"])
    hit = np.asarray(aovs["hit"])
    normals = np.asarray(aovs["normal"])
    # exact sphere normal at the hit location (unit sphere at origin,
    # identity instance: normal == hit point direction)
    o, d = generate_rays(cam.width, cam.height, p["K_inv"], p["D"],
                         p["pose"], p["inv_pose"])
    t = np.asarray(aovs["depth"])[..., None]
    loc = (np.asarray(o) + t * np.asarray(d))[hit]
    exact = loc / np.linalg.norm(loc, axis=-1, keepdims=True)
    return normals[hit], exact


def test_smooth_normals_track_the_analytic_sphere():
    scene_s, cam = _sphere_scene(smooth=True)
    arrays_s = scene_s.compile()
    assert arrays_s.tri_vnorm is not None
    got_s, exact_s = _hit_normals(arrays_s, cam)
    err_s = np.linalg.norm(got_s - exact_s, axis=-1)

    scene_f, _ = _sphere_scene(smooth=False)
    arrays_f = scene_f.compile()
    assert arrays_f.tri_vnorm is None
    got_f, exact_f = _hit_normals(arrays_f, cam)
    err_f = np.linalg.norm(got_f - exact_f, axis=-1)

    # faceting error of a subdiv-2 icosphere is degrees; interpolation
    # is orders of magnitude closer (exact at vertices, tiny chord
    # error between)
    assert err_f.max() > 0.05
    assert err_s.max() < err_f.max() / 5
    assert err_s.mean() < err_f.mean() / 10


def test_unsmoothed_mask_keeps_face_normals_exactly():
    """mask=False rows interpolate nothing: bit-identical to the
    vn-free scene."""
    scene_s, cam = _sphere_scene(smooth=True)
    scene_s.meshes[0] = MeshPrimitive.from_triangles(
        scene_s.meshes[0].v0, scene_s.meshes[0].v1, scene_s.meshes[0].v2,
        vn0=scene_s.meshes[0].vn0, vn1=scene_s.meshes[0].vn1,
        vn2=scene_s.meshes[0].vn2,
        vn_mask=np.zeros(scene_s.meshes[0].num_triangles, bool),
    )
    arrays_masked = scene_s.compile()
    scene_f, _ = _sphere_scene(smooth=False)
    arrays_f = scene_f.compile()
    got_m, _ = _hit_normals(arrays_masked, cam)
    got_f, _ = _hit_normals(arrays_f, cam)
    np.testing.assert_array_equal(got_m, got_f)


def test_save_load_roundtrip_preserves_vnorm(tmp_path):
    scene_s, cam = _sphere_scene(smooth=True, subdiv=1)
    arrays = scene_s.compile()
    fp = str(tmp_path / "s.npz")
    arrays.save(fp)
    from tpu_raytracer.scene.scene import SceneArrays

    loaded = SceneArrays.load(fp)
    np.testing.assert_array_equal(
        np.asarray(loaded.tri_vnorm), np.asarray(arrays.tri_vnorm)
    )
