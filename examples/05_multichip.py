"""Multi-chip rendering: shard the image rows over a device mesh via
shard_map, scene replicated (SURVEY.md §2 parallelism table). Runs on 8
virtual CPU devices here; the same code drives several GPUs
(chip_smoke.py --four runs it on four).

Run: python examples/05_multichip.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo root
import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np

from tpu_raytracer.app.scenes import scene_cube
from tpu_raytracer.parallel import make_mesh, render_image_sharded
from tpu_raytracer.render import RenderConfig
from tpu_raytracer.utils import save_png

arrays, camera = scene_cube(int(os.environ.get("TRT_EXAMPLE_SIZE", "128")))
mesh = make_mesh(8)  # 1-D mesh over all devices; image rows = DP axis
config = RenderConfig(width=camera.width, height=camera.height)
p = camera.ray_params()
img = np.asarray(render_image_sharded(
    config, mesh, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
))
save_png(img, "/tmp/example_multichip.png")
print(f"rendered on {len(jax.devices())} devices -> /tmp/example_multichip.png")
