"""Tone mapping / framebuffer resolve.

Reference: kernel.cu:648-662 ``blit_onto_framebuffer`` — per pixel:
``cl = rgb / a`` (a = completed-path count), Reinhard ``cl / (cl + 1)``,
gamma 1/2.2, written to the GL surface.  Here the resolve is a pure
function from the accumulation buffer to a display/PNG image.
"""

from __future__ import annotations

import jax.numpy as jnp


def resolve(accum: jnp.ndarray, width: int, height: int,
            operator: str = "reinhard",
            exposure: float = 1.0) -> jnp.ndarray:
    """accum: [H*W, 4] (rgb = radiance sum, a = completed path count).
    Returns [H, W, 3] float32 in [0, 1].

    operator: "reinhard" (the reference's cl/(cl+1), kernel.cu:655) or
    "aces" (Narkowicz's ACES filmic fit — beyond-reference production
    option).  ``exposure`` scales radiance before the curve."""
    counts = jnp.maximum(accum[:, 3:4], 1e-8)
    cl = accum[:, :3] / counts
    return tonemap_image(cl, operator, exposure).reshape(height, width, 3)


def tonemap_image(cl: jnp.ndarray, operator: str = "reinhard",
                  exposure: float = 1.0) -> jnp.ndarray:
    """Linear radiance [..., 3] -> display [0, 1] (curve + gamma 1/2.2)."""
    cl = cl * exposure
    if operator == "aces":
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        cl = (cl * (a * cl + b)) / (cl * (c * cl + d) + e)
    else:
        cl = cl / (cl + 1.0)
    return jnp.power(jnp.clip(cl, 0.0, 1.0), 1.0 / 2.2)


def to_uint8(img: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(img * 255.0 + 0.5, 0, 255).astype(jnp.uint8)


def bloom(cl: jnp.ndarray, strength: float = 0.08,
          threshold: float = 1.0, radius: int = 8) -> jnp.ndarray:
    """Lens-glare bloom on LINEAR radiance [H, W, 3] (beyond-reference
    display post-process; applied before the tone curve so highlights
    spill proportionally to their energy).

    Bright pass (radiance above ``threshold``) -> separable gaussian of
    sigma = radius/2 -> added back scaled by ``strength``.  Pure jnp
    (two 1-D convolutions as static shift-sums), so it runs on any
    backend inside the display resolve; strength 0 is the caller-side
    no-op gate."""
    bright = jnp.maximum(cl - threshold, 0.0)
    # reflect-pad requires pad < axis size: clamp the radius to the image
    radius = max(1, min(int(radius), cl.shape[0] - 1, cl.shape[1] - 1))
    sigma = radius / 2.0
    xs = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (xs / sigma) ** 2)
    k = k / jnp.sum(k)

    def blur_axis(img, axis):
        pad = [(0, 0)] * img.ndim
        pad[axis] = (radius, radius)
        p = jnp.pad(img, pad, mode="reflect")
        out = jnp.zeros_like(img)
        for i in range(2 * radius + 1):
            sl = [slice(None)] * img.ndim
            sl[axis] = slice(i, i + img.shape[axis])
            out = out + k[i] * p[tuple(sl)]
        return out

    halo = blur_axis(blur_axis(bright, 0), 1)
    return cl + strength * halo


def auto_exposure(radiance, key: float = 0.18, eps: float = 1e-6,
                  max_gain: float = 1e4) -> float:
    """Photographic auto-exposure (Reinhard 2002 'key of the scene'):
    the scale that maps the log-average luminance of the linear radiance
    image to ``key`` (middle grey).  CLI: ``--exposure auto``.

    A near-black buffer (log-average luminance below ``key/max_gain``)
    returns 1.0 instead of the astronomical key/eps gain that would
    amplify residual noise to full brightness — black frames stay
    black."""
    r = jnp.asarray(radiance, jnp.float32)
    lum = (0.2126 * r[..., 0] + 0.7152 * r[..., 1] + 0.0722 * r[..., 2])
    log_avg = float(jnp.exp(jnp.mean(jnp.log(lum + eps))))
    if log_avg < key / max_gain:
        return 1.0
    return float(key / log_avg)
