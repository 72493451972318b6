"""Lighting features the reference sketched but never enabled
(raycast.cu:263-287), realized: cosine shading, hard shadow rays, point
lights, and Whitted mirror reflections.

Run: env -u PYTHONPATH JAX_PLATFORMS=cpu python examples/03_lights_shadows_reflections.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo root
import numpy as np

from tpu_raytracer.render import Camera, RenderConfig
from tpu_raytracer.render.integrators import PointLight
from tpu_raytracer.render.pipeline import render_image_whitted
from tpu_raytracer.scene import (
    Material, MeshInstance, MeshPrimitive, Scene, objloader, procgen,
)
from tpu_raytracer.utils import save_png

scene = Scene()
scene.add_material(Material(albedo=(0.9, 0.3, 0.2)))
scene.add_material(Material(albedo=(0.9, 0.9, 0.9), reflectivity=0.6))  # mirror floor
v0, v1, v2 = procgen.icosphere(3)
scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2))
scene.add_mesh(objloader.loads(procgen.board_obj(12.0, 12.0)))

ball = MeshInstance(0, 0)
scene.add_mesh_instance(ball)
# board_obj faces -y; pitch it flat so it faces +z (up), 1.2 below the ball
floor = MeshInstance(1, 1)
floor.pose = np.array([0, 0, -1.2, 0, -np.pi / 2, 0], np.float32)
scene.add_mesh_instance(floor)
arrays = scene.compile()

S = int(os.environ.get("TRT_EXAMPLE_SIZE", "192"))  # CI shrinks to 64
camera = Camera.looking(S, S, fov_deg=55.0, pose=[0, -5, 1.0, 0, -0.15, 0])
config = RenderConfig(
    width=S, height=S, lighting="lambert_shadow",
    point_lights=(PointLight(position=(2.0, -2.0, 4.0), intensity=40.0),),
)
p = camera.ray_params()
img = np.asarray(render_image_whitted(
    config, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
    max_bounces=2,
))
save_png(img, "/tmp/example_lights.png")
print("wrote /tmp/example_lights.png")
