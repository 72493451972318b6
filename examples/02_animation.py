"""Animation via the cheap instance-update path: pose changes never
recompile (the reference's Scene::update_mesh_instance, Scene.cpp:67-74,
and its disabled teapot spin, kernel.cu:272-273).

Run: env -u PYTHONPATH JAX_PLATFORMS=cpu python examples/02_animation.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo root
import time

import numpy as np

from tpu_raytracer.render import Camera, RenderConfig, render_image
from tpu_raytracer.scene import Material, MeshInstance, Scene, objloader, procgen
from tpu_raytracer.utils import save_png

scene = Scene()
mat = Material()
mat.set_texture(procgen.checkerboard_texture(64, 8))
scene.add_material(mat)
scene.add_mesh(objloader.loads(procgen.cube_obj()))
scene.add_mesh_instance(MeshInstance(0, 0))
arrays = scene.compile()

S = int(os.environ.get("TRT_EXAMPLE_SIZE", "128"))  # CI shrinks to 64
camera = Camera.looking(S, S, fov_deg=50.0, pose=[0, -4, 0, 0, 0, 0])
config = RenderConfig(width=S, height=S)
p = camera.ray_params()

for frame in range(5):
    spun = MeshInstance(0, 0)
    spun.pose = np.array([0, 0, 0, 0.3 * frame, 0.1 * frame, 0], np.float32)
    arrays = arrays.update_instance(0, spun)  # functional, no recompile
    t0 = time.perf_counter()
    img = render_image(config, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    img.block_until_ready()
    dt = time.perf_counter() - t0
    print(f"frame {frame}: {dt * 1e3:.1f} ms" + ("  (compile)" if frame == 0 else ""))

save_png(np.asarray(img), "/tmp/example_animation.png")
print("wrote /tmp/example_animation.png")
