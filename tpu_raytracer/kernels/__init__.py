from .traverse import cast_rays_kernel

__all__ = ["cast_rays_kernel"]
