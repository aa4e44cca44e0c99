"""Environment-light importance sampling tables (beyond-reference).

With an environment map, the miss path is the dominant light source, and
BSDF-only sampling of a map with small bright regions (a sun in an HDRI)
is noise city.  The classic fix is texel importance sampling, spelled
here as an **alias table** — O(1) draws, exactly ONE row gather per NEE
sample (a CDF binary search would pay a gather log(N) times).

Host build (this module):
  * per-texel probability  p ∝ luminance × sin(θ_row)  (solid-angle
    weighted, so rows near the poles are not over-sampled);
  * per-texel SOLID-ANGLE pdf  p / Ω_texel, stored in the env radiance
    row's spare lane (env_data[:, 3]) so the miss path can evaluate the
    MIS balance weight with the SAME nearest-texel pdf the sampler uses
    (a bilinear pdf there would break the weights-sum-to-1 identity);
  * Vose alias rows [N, 12]: keep-probability, alias index, and the
    (rgb, pdf) of BOTH outcomes — the draw resolves coin → texel →
    radiance/pdf from one gathered row, no second fetch.

Consumed by render._shade when ``cfg.mis == "on"`` and the scene has an
envmap: the sun-NEE strategy slot becomes env-NEE (one alias draw per
shaded ray), balance-weighted against BSDF sampling both ways.
"""

from __future__ import annotations

import numpy as np

# BT.709 luminance weights — the ONE copy every power/importance weight in
# the framework derives from (env texel weights here, per-light powers in
# scene.py, the MIS hit-side pdf recompute in render.py).  The MIS
# weights-sum-to-1 identity depends on all sites using the same values.
LUM_RGB = np.array([0.2126, 0.7152, 0.0722], np.float32)


def build_alias(p: np.ndarray):
    """Vose's O(N) alias method.  ``p`` sums to 1.  Returns (prob, alias):
    draw i ~ U{0..N-1}, u ~ U[0,1); the sample is i if u < prob[i] else
    alias[i]."""
    n = p.shape[0]
    prob = np.zeros(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    scaled = p.astype(np.float64) * n
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    for i in large:
        prob[i] = 1.0
    for i in small:
        prob[i] = 1.0  # numerical leftovers
    return prob.astype(np.float32), alias


def env_tables(em: np.ndarray):
    """Build (pdf_sa [H*W] f32, alias_rows [H*W, 12] f32) for an
    equirectangular radiance map [H, W, 3] (z-up, v=0 at the zenith —
    the render._sample_envmap convention)."""
    eh, ew = em.shape[0], em.shape[1]
    n = eh * ew
    if n > (1 << 24):
        raise ValueError(
            f"envmap of {n} texels exceeds the f32-exact alias-index "
            "limit (2^24); downsample the environment map")
    rgb = np.asarray(em[:, :, :3], np.float64).reshape(n, 3)
    lum = rgb @ LUM_RGB.astype(np.float64)
    sin_t = np.sin((np.arange(eh) + 0.5) * np.pi / eh)
    w = (lum.reshape(eh, ew) * sin_t[:, None]).reshape(n)
    w = np.maximum(w, 0.0)
    tot = w.sum()
    if tot <= 0.0:
        w = np.repeat(sin_t, ew)  # black map: uniform over solid angle
        tot = w.sum()
    p = w / tot
    omega = (2.0 * np.pi / ew) * (np.pi / eh) * np.repeat(sin_t, ew)
    pdf_sa = np.where(p > 0, p / np.maximum(omega, 1e-12), 0.0)

    prob, alias = build_alias(p)
    rows = np.zeros((n, 12), np.float32)
    rows[:, 0] = prob
    rows[:, 1] = alias.astype(np.float32)  # exact below 2^24
    rows[:, 2:5] = rgb.astype(np.float32)
    rows[:, 5] = pdf_sa.astype(np.float32)
    rows[:, 6:9] = rgb[alias].astype(np.float32)
    rows[:, 9] = pdf_sa[alias].astype(np.float32)
    return pdf_sa.astype(np.float32), rows
