"""OBJ loader + scene compilation tests."""

import numpy as np

from tpu_raytracer.scene import (
    Material,
    MeshInstance,
    MeshPrimitive,
    Scene,
    SceneArrays,
    objloader,
    procgen,
)


def build_two_instance_scene():
    scene = Scene()
    scene.add_material(Material(albedo=(0.1, 0.2, 0.9)))
    tex = Material()
    tex.set_texture(procgen.checkerboard_texture(64, 8))
    scene.add_material(tex)
    cube = objloader.loads(procgen.cube_obj())
    board = objloader.loads(procgen.board_obj())
    scene.add_mesh(cube)
    scene.add_mesh(board)
    scene.add_mesh_instance(MeshInstance(0, 0))
    inst = MeshInstance(1, 1)
    inst.pose = np.array([-0.6, 1.48, 0.73, 0, 0, 0], np.float32)
    scene.add_mesh_instance(inst)
    return scene


def test_cube_obj_parses_to_12_triangles():
    mesh = objloader.loads(procgen.cube_obj())
    assert mesh.num_triangles == 12
    # winding normals are unit and axis-aligned for a cube
    np.testing.assert_allclose(np.linalg.norm(mesh.normal, axis=1), 1.0, atol=1e-5)
    assert (np.abs(np.abs(mesh.normal).max(axis=1) - 1.0) < 1e-5).all()


def test_fan_triangulation_counts():
    # an n-gon face fans into n-2 triangles (OBJLoader.hpp:139)
    obj = "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv -1 0.5 0\nf 1 2 3 4 5\n"
    v0, v1, v2, *_ = objloader.parse_obj(obj)
    assert len(v0) == 3
    np.testing.assert_array_equal(v0[0], v0[1])  # fan root shared


def test_uv_attachment():
    mesh = objloader.loads(procgen.board_obj())
    assert mesh.num_triangles == 2
    uvs = np.stack([mesh.uv0, mesh.uv1, mesh.uv2])
    assert uvs.min() == 0.0 and uvs.max() == 1.0


def test_scene_compiles_with_offsets():
    scene = build_two_instance_scene()
    arrays = scene.compile()
    # 12-tri cube + 2-tri board, concatenated without padding
    assert arrays.num_triangles == 14
    assert arrays.num_instances == 2
    # every triangle is a real one (unit normal -> hittable)
    normals = np.asarray(arrays.tri_normal)
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0,
                               rtol=1e-6)
    # mesh 1's root node references offset nodes/triangles
    assert int(arrays.mesh_root[1]) == len(scene.meshes[0].bvh.child_a)
    tri_mesh = np.asarray(arrays.tri_mesh)
    assert (tri_mesh[:12] == 0).all() and (tri_mesh[12:] == 1).all()
    # mesh 1's leaves start past mesh 0's triangles
    leaf = np.asarray(arrays.node_child_a) < 0
    starts = np.asarray(arrays.node_leaf_start)
    root1 = int(arrays.mesh_root[1])
    assert (starts[root1:][leaf[root1:]] >= 12).all()
    # texture atlas packed
    assert int(arrays.mat_tex_start[1]) == 0
    assert int(arrays.mat_tex_w[1]) == 64
    # atlas holds the full mip chain: 64^2 + 32^2 + ... + 1 = 5461
    chain = sum(max(64 >> l, 1) ** 2 for l in range(7))
    assert arrays.tex_atlas.shape[0] == chain
    assert int(arrays.mat_tex_start[0]) == -1
    # mip table: level starts are cumulative; untextured rows are -1
    mips = np.asarray(arrays.mat_tex_mip_start)
    assert mips.shape == (2, 7)
    assert (mips[0] == -1).all()
    assert mips[1][0] == 0 and mips[1][1] == 64 * 64
    assert mips[1][-1] == chain - 1


def test_scene_roundtrips_through_save_load(tmp_path):
    arrays = build_two_instance_scene().compile()
    fp = str(tmp_path / "scene.npz")
    arrays.save(fp)
    loaded = SceneArrays.load(fp)
    np.testing.assert_array_equal(loaded.tri_v0, arrays.tri_v0)
    np.testing.assert_array_equal(loaded.node_child_a, arrays.node_child_a)
    np.testing.assert_array_equal(loaded.tex_atlas, arrays.tex_atlas)
    # static trace-time flags are rebuilt from the traced fields on
    # load (they are excluded from the save file)
    assert loaded.has_sky == arrays.has_sky
    assert loaded.has_textures == arrays.has_textures


def test_static_flags_survive_save_load(tmp_path):
    """has_sky/has_textures gate real work at trace time (shade.py) —
    a load that lost them would silently render the flat sky / albedo
    instead of the env map / texture."""
    scene = build_two_instance_scene()
    sky = np.zeros((8, 16, 3), np.uint8)
    sky[:] = (10, 200, 30)
    scene.set_sky(sky)
    arrays = scene.compile()
    assert arrays.has_sky and arrays.has_textures
    fp = str(tmp_path / "sky_scene.npz")
    arrays.save(fp)
    loaded = SceneArrays.load(fp)
    assert loaded.has_sky and loaded.has_textures
    from tpu_raytracer.render.shade import sky_radiance

    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    np.testing.assert_allclose(
        np.asarray(sky_radiance(loaded, d)),
        np.asarray(sky_radiance(arrays, d)),
    )


def test_update_instance_matches_recompile():
    scene = build_two_instance_scene()
    arrays = scene.compile()
    moved = MeshInstance(0, 0)
    moved.pose = np.array([1.0, 2.0, 3.0, 0.1, 0.2, 0.3], np.float32)
    updated = arrays.update_instance(0, moved)
    scene.update_mesh_instance(0, moved)
    recompiled = scene.compile()
    np.testing.assert_allclose(updated.inst_pose, recompiled.inst_pose, atol=1e-6)
    np.testing.assert_allclose(
        updated.inst_inv_pose, recompiled.inst_inv_pose, atol=1e-6
    )


def test_mesh_from_triangles_without_uv():
    v0, v1, v2 = procgen.icosphere(1)
    mesh = MeshPrimitive.from_triangles(v0, v1, v2)
    assert mesh.num_triangles == 80
    assert mesh.uv0.shape == (80, 2)


def test_objloader_load_from_file(tmp_path):
    """The load()-from-disk path (OBJLoader.hpp:15-27 analog)."""
    fp = tmp_path / "cube.obj"
    fp.write_text(procgen.cube_obj())
    mesh = objloader.load(str(fp))
    assert mesh.num_triangles == 12


def test_objloader_missing_file_raises():
    """Reference exit(1)s on a missing file (OBJLoader.hpp:23-27);
    here it raises a clean FileNotFoundError."""
    import pytest

    with pytest.raises(FileNotFoundError):
        objloader.load("/nonexistent/definitely_missing.obj")


def test_objloader_mixed_face_tokens_degrade_untextured():
    """A face mixing 'v/t' and bare 'v' tokens must parse as an
    un-textured face instead of mis-indexing the fan."""
    text = "\n".join([
        "v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0",
        "vt 0 0", "vt 1 0", "vt 1 1",
        "f 1/1 2/2 3/3 4",  # quad: three tokens textured, one bare
    ])
    v0, v1, v2, uv0, uv1, uv2, has_uv = objloader.parse_obj(text)
    assert len(v0) == 2  # fan-triangulated quad
    assert not has_uv.any()


def test_flatten_static_instances_matches_render():
    """Flattening (world-space bake into one mesh + identity instance)
    preserves the rendered image up to transform fp noise; per-triangle
    materials must resolve to the source instances' materials."""
    from tpu_raytracer.render import Camera, render

    scene = build_two_instance_scene()
    cam = Camera.looking(64, 64, fov_deg=55.0, pose=[0.0, -4.0, 0.0, 0, 0, 0])
    a = np.asarray(render(cam, scene.compile(), backend="bvh",
                          lighting="lambert"))
    flat_arrays = scene.compile(flatten_static=True)
    assert int(flat_arrays.mesh_root.shape[0]) == 1
    assert int(flat_arrays.num_instances) == 1
    assert (np.asarray(flat_arrays.tri_mat).max()) == 1  # texture material
    b = np.asarray(render(cam, flat_arrays, backend="bvh",
                          lighting="lambert"))
    same = float((a == b).all(-1).mean())
    assert same > 0.97, f"only {same:.3f} of pixels identical"
