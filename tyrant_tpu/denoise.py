"""Edge-aware à-trous wavelet denoiser (beyond-reference).

An SVGF-style reconstruction filter for interactive preview: the noisy
per-pixel radiance mean is smoothed by iterated 5x5 cross-bilateral
passes with exponentially growing footprint (à trous — "with holes"),
edge-stopped by the NOISE-FREE feature buffers from
:func:`render.render_aovs` (albedo, shading normal, depth).  Radiance is
demodulated by albedo first so texture detail is preserved exactly and
only irradiance is smoothed, then remodulated.

Every tap is a static shift of the whole image (25 taps x N iterations of
pure elementwise work, no gathers — `jnp.pad` 'edge' + static slices).  A 1080p 5-iteration filter is a few ms of dense math,
fully fused by XLA.

Reference technique: Dammertz et al., "Edge-Avoiding À-Trous Wavelet
Transform for Fast Global Illumination Filtering" (HPG 2010); the
demodulation + feature-guide structure follows SVGF (Schied et al. 2017).
The CUDA reference has no denoiser of any kind.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# B3-spline 5-tap kernel (Dammertz et al. §3)
_H = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _shift(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Static whole-image shift with edge-clamped borders."""
    h, w = img.shape[0], img.shape[1]
    pad = [(max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0))]
    if img.ndim == 3:
        pad.append((0, 0))
    padded = jnp.pad(img, pad, mode="edge")
    return jax.lax.slice_in_dim(
        jax.lax.slice_in_dim(padded, max(-dy, 0), max(-dy, 0) + h, axis=0),
        max(-dx, 0), max(-dx, 0) + w, axis=1)


@partial(jax.jit, static_argnames=("iterations",))
def atrous_denoise(radiance: jnp.ndarray, albedo: jnp.ndarray,
                   normal: jnp.ndarray, depth: jnp.ndarray,
                   iterations: int = 4,
                   sigma_color: float = 0.45,
                   sigma_normal: float = 32.0,
                   sigma_depth: float = 0.02) -> jnp.ndarray:
    """radiance [H,W,3] (linear per-pixel mean) -> denoised [H,W,3].

    albedo/normal [H,W,3] and depth [H,W] are the noise-free guides from
    render_aovs.  sigma_color bounds the RELATIVE irradiance difference
    a tap may bridge; sigma_depth is relative to the local depth
    magnitude (both edge stops are scale-free)."""
    irr = radiance / jnp.maximum(albedo, 1e-3)
    finite_depth = jnp.minimum(depth, 1e19)

    for it in range(iterations):
        step = 1 << it
        acc = jnp.zeros_like(irr)
        wsum = jnp.zeros(irr.shape[:2] + (1,), irr.dtype)
        for ky in range(5):
            for kx in range(5):
                dy, dx = (ky - 2) * step, (kx - 2) * step
                s_irr = _shift(irr, dy, dx)
                s_n = _shift(normal, dy, dx)
                s_d = _shift(finite_depth, dy, dx)
                w = _H[ky] * _H[kx]
                # normal edge stop: cos^sigma (flat surfaces pass,
                # creases block).  Miss pixels carry normal == 0: two
                # sky pixels must see each other with full weight (else
                # even the CENTER tap zeroes and the sky resolves
                # black), while sky<->surface stays blocked by the
                # natural dot == 0.
                ndot = jnp.maximum(jnp.sum(normal * s_n, axis=-1), 0.0)
                both_sky = (jnp.sum(normal * normal, axis=-1) < 0.25) \
                    & (jnp.sum(s_n * s_n, axis=-1) < 0.25)
                w = w * jnp.where(both_sky, 1.0,
                                  jnp.power(ndot, sigma_normal))
                # depth edge stop, relative to local depth
                dz = jnp.abs(finite_depth - s_d) \
                    / (jnp.abs(finite_depth) * sigma_depth + 1e-3)
                w = w * jnp.exp(-dz)
                # colour edge stop on the running irradiance, RELATIVE
                # difference: an absolute stop collapses all weights at
                # low sample counts (NEE spikes) and nothing smooths
                dc = jnp.sum(jnp.abs(irr - s_irr), axis=-1) \
                    / (jnp.sum(jnp.abs(irr) + jnp.abs(s_irr), axis=-1)
                       + 1e-3)
                w = w * jnp.exp(-dc / sigma_color)
                w = w[..., None]
                acc = acc + s_irr * w
                wsum = wsum + w
        irr = acc / jnp.maximum(wsum, 1e-8)

    return irr * jnp.maximum(albedo, 1e-3)
