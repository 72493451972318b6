"""The five staged benchmark scenes from BASELINE.md, as builders.

| # | config | builder |
|---|--------|---------|
| 1 | cube, pinhole, 256^2, flat Lambert | scene_cube |
| 2 | Cornell box, Lambert + hard shadows, 512^2 | scene_cornell |
| 3 | bunny-class 82k tris, full BVH, 1080p | scene_bunny |
| 4 | multi-instance + Whitted reflective bounces | scene_instances |
| 5 | Sponza-class 250k+ tris, path tracing, fly-through | scene_colonnade |
"""

from __future__ import annotations

import numpy as np

from ..render import Camera
from ..scene import (
    Material,
    MeshInstance,
    MeshPrimitive,
    Scene,
    objloader,
    procgen,
)


def scene_cube(size: int = 256):
    scene = Scene()
    mat = Material()
    mat.set_texture(procgen.checkerboard_texture(128, 8))
    scene.add_material(mat)
    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    scene.add_mesh_instance(MeshInstance(0, 0))
    cam = Camera.looking(size, size, fov_deg=45.0, pose=[0, -4, 0, 0, 0, 0])
    return scene.compile(), cam


def scene_cornell(size: int = 512, mirror: bool = False):
    scene = Scene()
    white = scene.add_material(Material(albedo=(0.9, 0.9, 0.9)))
    red = scene.add_material(Material(albedo=(0.1, 0.1, 0.9)))
    green = scene.add_material(Material(albedo=(0.1, 0.9, 0.1)))
    box_mat = scene.add_material(
        Material(albedo=(0.95, 0.95, 0.95), reflectivity=0.7 if mirror else 0.0)
    )
    mats = {"floor": white, "ceiling": white, "back": white,
            "left": red, "right": green}
    for name, tris in procgen.cornell_box().items():
        mid = scene.add_mesh(
            MeshPrimitive.from_triangles(tris[:, 0], tris[:, 1], tris[:, 2])
        )
        scene.add_mesh_instance(MeshInstance(mid, mats[name]))
    cube = scene.add_mesh(objloader.loads(procgen.cube_obj(0.6)))
    inst = MeshInstance(cube, box_mat)
    inst.pose = np.array([1.0, 1.2, 0.3, 0.4, 0, 0], np.float32)
    scene.add_mesh_instance(inst)
    cam = Camera.looking(size, size, fov_deg=70.0, pose=[1.0, -0.8, 1.0, 0, 0, 0])
    return scene.compile(), cam


def scene_bunny(width: int = 1920, height: int = 1088, subdivisions: int = 6):
    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.3, 0.2)))
    v0, v1, v2 = procgen.blob(subdivisions=subdivisions)
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2))
    scene.add_mesh_instance(MeshInstance(0, 0))
    # camera z offset 0.13: the icosphere-derived blob has an edge ring
    # exactly in the z=0 plane; a z=0 camera shoots center-row rays with
    # d_z == 0 exactly along that seam, where per-triangle barycentric
    # tests (same math as the reference) are not watertight.
    cam = Camera.looking(width, height, fov_deg=50.0, pose=[0.0, -3.2, 0.13, 0, 0, 0])
    return scene.compile(), cam


def scene_instances(width: int = 512, height: int = 512,
                    flatten: bool = False):
    """Config 4: several posed/scaled instances, one mirror.
    ``flatten`` bakes the static instances into one world-space mesh
    (Scene.flattened — one traversal per cast instead of four)."""
    scene = Scene()
    matte = scene.add_material(Material(albedo=(0.9, 0.9, 0.9)))
    blue = scene.add_material(Material(albedo=(0.9, 0.2, 0.1)))
    mirror = scene.add_material(Material(albedo=(0.95, 0.95, 0.95), reflectivity=0.8))
    tex = Material()
    tex.set_texture(procgen.checkerboard_texture(128, 8))
    texid = scene.add_material(tex)

    sphere = scene.add_mesh(
        MeshPrimitive.from_triangles(*procgen.icosphere(4))
    )
    cube = scene.add_mesh(objloader.loads(procgen.cube_obj()))
    board = scene.add_mesh(objloader.loads(procgen.board_obj(8, 8)))

    floor = MeshInstance(board, texid)
    floor.pose = np.array([0, 2, -1.2, 0, 0, np.pi], np.float32)  # face up
    scene.add_mesh_instance(floor)
    a = MeshInstance(sphere, mirror)
    a.pose = np.array([-1.2, 2.5, 0.0, 0, 0, 0], np.float32)
    scene.add_mesh_instance(a)
    b = MeshInstance(cube, blue)
    b.pose = np.array([1.1, 2.0, -0.6, 0.5, 0, 0], np.float32)
    b.scale = np.array([0.8, 0.8, 1.4], np.float32)
    scene.add_mesh_instance(b)
    c = MeshInstance(sphere, matte)
    c.pose = np.array([0.3, 3.5, -0.7, 0, 0, 0], np.float32)
    c.scale = np.array([0.5, 0.5, 0.5], np.float32)
    scene.add_mesh_instance(c)
    cam = Camera.looking(width, height, fov_deg=60.0, pose=[0, -1.5, 0.3, 0, 0, 0])
    return scene.compile(flatten_static=flatten), cam


def scene_instances16(width: int = 512, height: int = 512, n: int = 16,
                      flatten: bool = False):
    """16 posed/scaled instances in a grid — the many-instances scene,
    measured beside its flattened-static bake (``flatten``). Instances are
    'dynamic' in the sense that per-frame pose updates (update_instance)
    keep working — unlike ``flatten``, which bakes them."""
    scene = Scene()
    matte = scene.add_material(Material(albedo=(0.9, 0.9, 0.9)))
    red = scene.add_material(Material(albedo=(0.9, 0.2, 0.1)))
    sphere = scene.add_mesh(
        MeshPrimitive.from_triangles(*procgen.icosphere(4))
    )
    cube = scene.add_mesh(objloader.loads(procgen.cube_obj()))
    rng = np.random.default_rng(11)
    side = int(np.ceil(np.sqrt(n)))
    for k in range(n):
        inst = MeshInstance(sphere if k % 2 else cube,
                            matte if k % 2 else red)
        gx, gz = k % side, k // side
        inst.pose = np.array(
            [(gx - (side - 1) / 2) * 2.4, 4.0 + rng.uniform(-0.8, 0.8),
             (gz - (side - 1) / 2) * 2.4,
             rng.uniform(0, 3), rng.uniform(0, 1), 0.0],
            np.float32,
        )
        inst.scale = np.full(3, rng.uniform(0.7, 1.1), np.float32)
        scene.add_mesh_instance(inst)
    cam = Camera.looking(width, height, fov_deg=75.0,
                         pose=[0, -8.0, 0.0, 0, 0, 0])
    return scene.compile(flatten_static=flatten), cam


def scene_colonnade(width: int = 1024, height: int = 1024,
                    columns: int = 10, segs: int = 32):
    """Config 5: Sponza-class triangle count (10x10x40x32 -> ~256k)."""
    scene = Scene()
    scene.add_material(Material(albedo=(0.85, 0.8, 0.75)))
    v0, v1, v2 = procgen.colonnade(columns, columns, segs)
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2))
    scene.add_mesh_instance(MeshInstance(0, 0))
    cam = Camera.looking(
        width, height, fov_deg=65.0,
        pose=[1.0, -2.0, 1.6, 0, 0, 0],
    )
    return scene.compile(), cam


SCENES = {
    "cube": scene_cube,
    "cornell": scene_cornell,
    "bunny": scene_bunny,
    "instances": scene_instances,
    "instances16": scene_instances16,
    "colonnade": scene_colonnade,
}
