"""Framework extensions: AOV buffers (depth/normal/instance), bilinear
texture filtering, and supersampled anti-aliasing.

Run: env -u PYTHONPATH JAX_PLATFORMS=cpu python examples/06_aovs_and_extras.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo root
import numpy as np

from tpu_raytracer.app.scenes import scene_cube
from tpu_raytracer.render import RenderConfig, render_aovs, render_image
from tpu_raytracer.utils import save_png

arrays, camera = scene_cube(96)
p = camera.ray_params()

config = RenderConfig(
    width=96, height=96,
    texture_filter="bilinear",  # smooth texture lookup (4-tap lerp)
    ssaa=2,                     # 4 rays/pixel, box-averaged
)
img = np.asarray(render_image(
    config, arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"]
))
save_png(img, "/tmp/example_extras.png")

aovs = render_aovs(
    RenderConfig(width=96, height=96),
    arrays, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
)
depth = np.asarray(aovs["depth"])
hit = np.asarray(aovs["hit"])
print("wrote /tmp/example_extras.png;",
      f"depth range on hits: {depth[hit].min():.2f}..{depth[hit].max():.2f}")
