"""Edge-avoiding à-trous wavelet denoiser for path-traced radiance.

Framework extension: the reference has no denoiser (its path-tracing
scaffolding — per-pixel curand state, raycast.cu:190-193 — was never
even enabled), but a Monte-Carlo mode without one needs many times the
samples for the same visual quality. This is the classic single-frame
à-trous filter (Dammertz et al., "Edge-Avoiding À-Trous Wavelet
Transform for fast Global Illumination Filtering", HPG 2010): a 5x5
B3-spline kernel applied ``iterations`` times with dilation 1, 2, 4,
..., each tap down-weighted by color, normal, and depth differences so
smoothing never crosses geometric edges.

Device mapping: every tap is a statically-shifted slice of an
edge-replicated pad — 25 static slices + elementwise weight math per
iteration, no gathers, no data-dependent control flow. XLA fuses the
whole iteration into a handful of elementwise loops.
"""

from __future__ import annotations

import jax.numpy as jnp

# 5-tap B3-spline, outer-producted into the 5x5 kernel per-axis.
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)

# Miss pixels carry +inf depth (render_aovs); replace with one large
# finite sentinel so sky<->sky taps weigh 1 (0 difference) and
# sky<->surface taps weigh ~0 (huge difference) instead of producing
# inf - inf = NaN inside the weight exponent.
_MISS_DEPTH = 1e8


def atrous_denoise(
    radiance: jnp.ndarray,
    normal: jnp.ndarray,
    depth: jnp.ndarray,
    iterations: int = 3,
    sigma_color: float = 0.25,
    sigma_normal: float = 0.35,
    sigma_depth: float = 0.5,
) -> jnp.ndarray:
    """Filter HDR ``radiance`` [H, W, 3] guided by first-hit ``normal``
    [H, W, 3] and ``depth`` [H, W] (render_aovs buffers; +inf depth =
    miss). Returns filtered [H, W, 3] f32.

    ``iterations`` doubles the filter footprint each pass (effective
    radius ~2^iterations); 0 is the identity. Color weights are
    recomputed against the CURRENT estimate each iteration (the
    standard à-trous progression); normal/depth guides stay fixed.
    Sigmas are in natural units: relative radiance difference, normal
    cosine half-angle scale, world depth units.
    """
    if iterations <= 0:
        return jnp.asarray(radiance, jnp.float32)
    img = jnp.asarray(radiance, jnp.float32)
    n = jnp.asarray(normal, jnp.float32)
    z = jnp.asarray(depth, jnp.float32)
    z = jnp.where(jnp.isfinite(z), z, _MISS_DEPTH)

    inv_sc = 1.0 / (2.0 * sigma_color * sigma_color)
    inv_sn = 1.0 / (2.0 * sigma_normal * sigma_normal)
    inv_sz = 1.0 / (2.0 * sigma_depth * sigma_depth)

    H, W = img.shape[0], img.shape[1]
    offs = (-2, -1, 0, 1, 2)

    for it in range(iterations):
        step = 1 << it
        r = 2 * step
        # edge-replicated pad once per iteration; every tap is a
        # STATIC slice of it (base + off*step is a Python int)
        pimg = jnp.pad(img, ((r, r), (r, r), (0, 0)), mode="edge")
        pn = jnp.pad(n, ((r, r), (r, r), (0, 0)), mode="edge")
        pz = jnp.pad(z, ((r, r), (r, r)), mode="edge")

        acc = jnp.zeros_like(img)
        wsum = jnp.zeros(img.shape[:2], jnp.float32)
        for iy, dy in enumerate(offs):
            for ix, dx in enumerate(offs):
                ky = _B3[iy] * _B3[ix]
                y0 = r + dy * step
                x0 = r + dx * step
                c_q = pimg[y0:y0 + H, x0:x0 + W]
                n_q = pn[y0:y0 + H, x0:x0 + W]
                z_q = pz[y0:y0 + H, x0:x0 + W]
                dc = c_q - img
                dn = n_q - n
                dz = z_q - z
                w = ky * jnp.exp(
                    -(dc * dc).sum(-1) * inv_sc
                    - (dn * dn).sum(-1) * inv_sn
                    - dz * dz * inv_sz
                )
                acc = acc + c_q * w[..., None]
                wsum = wsum + w
        img = acc / jnp.maximum(wsum, 1e-12)[..., None]
    return img
