"""tpu_raytracer — a ray tracing framework in JAX for NVIDIA GPUs.

Built from scratch with the capabilities of the reference CUDA raytracer
(AFIDclan/cuda-raytracing): OBJ scenes, SAH BVH, instanced meshes,
fisheye pinhole camera, textured materials, directional lighting — as
SoA scene arrays compiled once, a per-ray CUDA traversal kernel called
through jax.ffi (the reference's own design), XLA stages for raygen and
shading, and multi-device image tiling via shard_map.
"""

__version__ = "0.1.0"
