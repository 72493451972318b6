"""Monte-Carlo path tracing with emissive materials — the stochastic
bounce design the reference's curand setup anticipated
(raycast.cu:190-193) but never ran.

Run: env -u PYTHONPATH JAX_PLATFORMS=cpu python examples/04_path_tracing.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo root
import jax
import numpy as np

from tpu_raytracer.app.scenes import scene_cornell
from tpu_raytracer.render import RenderConfig
from tpu_raytracer.render.pipeline import render_image_path_traced
from tpu_raytracer.utils import save_png

arrays, camera = scene_cornell(int(os.environ.get("TRT_EXAMPLE_SIZE", "128")))
config = RenderConfig(width=camera.width, height=camera.height)
p = camera.ray_params()
img = np.asarray(render_image_path_traced(
    config, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
    jax.random.PRNGKey(0), max_bounces=3, samples=4,
))
save_png(img, "/tmp/example_path.png")
print("wrote /tmp/example_path.png")
