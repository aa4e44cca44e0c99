"""Adaptive sampling: priority-ordered raygen allocation (beyond-reference).

The reference samples every pixel uniformly forever (kernel.cu:263 scans
rows linearly).  A production progressive renderer converges faster by
directing the ray budget at the pixels that still carry Monte-Carlo error.
The wavefront-native spelling here keeps everything dense and fixed-shape:

  * the accumulation pass already tracks per-pixel completed-path counts in
    ``accum[:, 3]``; with ``RenderConfig.adaptive_sampling="on"`` the same
    pixel-sorted flush also accumulates per-channel SQUARED radiance into a
    second buffer ``moment2`` (one extra accumulate_sorted call — the sort
    keys are shared, render.py step 7);
  * every ``adaptive_interval`` steps the host rebuilds a pixel-visit
    permutation from the running relative-error estimate (one P-element
    sort, amortised to ~2-3 ms/step at 1080p);
  * raygen walks that permutation instead of the raster scan, so the
    wavefront machinery (top-off, carry, compaction) is untouched.

Allocation follows the variance-optimal rule: pixel ``i`` receives visit
slots in proportion to ``w_i = (err_i + floor)**gamma`` (for minimising
the summed per-pixel variance under a fixed ray budget the optimum is
``n_i proportional to sigma_i``, i.e. gamma=1 over the standard-error
estimate).  The permutation is the inverse CDF of the weights sampled at
P equispaced points — which also makes it MONOTONIC in pixel id, so
raygen's visit order stays raster-coherent (the coherence property the
uniform scan had).  A golden-ratio phase jitter per rebuild rotates
which fractional slots round up, so low-weight pixels cycle rather than
starve.  The per-pixel estimator (radiance sum / path count, resolved in
ops/tonemap.py) is unbiased under ANY visit schedule, so adaptive
sampling changes variance distribution, never the converged image.

An earlier power-law-over-error-RANK allocation measured 0.98x (no win):
it over-concentrated on the top ranks (1124 visits on one pixel buys
1/sqrt(n) almost nothing) while starving the bulk — allocation must track
the error MAGNITUDES, not their order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# error floor added to the mean luminance: avoids near-black pixels with
# tiny absolute noise dominating the relative-error ranking
_LUM_FLOOR = 0.05
# minimum weight, as a fraction of the mean error: every pixel keeps
# receiving at least ~20% of a uniform share, so coverage never collapses
_WEIGHT_FLOOR = 0.25


@partial(jax.jit, static_argnames=("gamma",))
def build_perm(accum: jnp.ndarray, moment2: jnp.ndarray, phase: jnp.ndarray,
               gamma: float = 1.0) -> jnp.ndarray:
    """accum/moment2 [P, 4] -> visit schedule [P] i32 (with repetition,
    monotonic in pixel id).

    Weight = relative standard error of the per-pixel mean, from the
    running first/second moments (per-channel variances summed — a ranking
    heuristic, not an exact luminance variance), to the power ``gamma``.
    Unsampled pixels take the maximum observed error.  ``phase`` in [0, 1)
    shifts the CDF sample points between rebuilds.
    """
    p = accum.shape[0]
    cnt = accum[:, 3]
    n = jnp.maximum(cnt, 1.0)
    mean = accum[:, :3] / n[:, None]
    m2 = moment2[:, :3] / n[:, None]
    var = jnp.maximum(m2 - mean * mean, 0.0).sum(axis=1)
    lum = mean @ jnp.asarray([0.299, 0.587, 0.114], jnp.float32)
    err = jnp.sqrt(var / n) / (lum + _LUM_FLOOR)

    emax = jnp.max(jnp.where(cnt >= 1.0, err, 0.0))
    err = jnp.where(cnt < 1.0, jnp.maximum(emax, 1e-6), err)
    # exploration term (upper-confidence style): sigma-hat from a handful
    # of samples is itself noisy — a pixel that happened to draw similar
    # values would be starved and never self-correct.  Inflate low-count
    # pixels by the population mean error scaled by 1/sqrt(n); decays as
    # evidence accumulates.
    ebar = jnp.mean(err) + 1e-12
    err = err + ebar * jax.lax.rsqrt(n)
    w = jnp.power(err + _WEIGHT_FLOOR * ebar, gamma)

    # INTEGER CDF: a float32 cumsum over ~2M pixels has an ulp of ~0.25
    # near the tail — floor-level weights would quantise to zero and
    # late-raster pixels would starve (a spatially-biased failure of the
    # minimum-share guarantee).  Quantise weights to ~16x-average int32
    # counts (min 1) instead; the cumsum is then exact (< 2^31).
    wq = jnp.maximum(
        (w * (16.0 * p / (jnp.sum(w) + 1e-30))).astype(jnp.int32), 1)
    cdf = jnp.cumsum(wq)
    stride = cdf[-1].astype(jnp.float32) / p
    targets = ((jnp.arange(p, dtype=jnp.float32)
                + phase.astype(jnp.float32)) * stride).astype(jnp.int32)
    perm = jnp.searchsorted(cdf, targets, side="right")
    return jnp.clip(perm, 0, p - 1).astype(jnp.int32)


def mean_relative_error(accum: jnp.ndarray,
                        moment2: jnp.ndarray) -> jnp.ndarray:
    """Image-level convergence metric: mean over sampled pixels of the
    stabilized relative standard error of the per-pixel mean (same
    moments and luminance floor as build_perm).  Drives the CLI's
    ``--until-noise`` stop; needs cfg.track_variance or adaptive
    sampling (moment2 is a [1, 4] dummy otherwise)."""
    cnt = accum[:, 3]
    n = jnp.maximum(cnt, 1.0)
    mean = accum[:, :3] / n[:, None]
    m2 = moment2[:, :3] / n[:, None]
    var = jnp.maximum(m2 - mean * mean, 0.0).sum(axis=1)
    lum = mean @ jnp.asarray([0.299, 0.587, 0.114], jnp.float32)
    err = jnp.sqrt(var / n) / (lum + _LUM_FLOOR)
    sampled = (cnt >= 2.0).astype(jnp.float32)
    return jnp.sum(err * sampled) / jnp.maximum(jnp.sum(sampled), 1.0)


def identity_perm(p: int) -> jnp.ndarray:
    return jnp.arange(p, dtype=jnp.int32)


class PermScheduler:
    """Host-side rebuild bookkeeping shared by Renderer and
    ShardedRenderer: after every ``interval`` rendered steps, emit the
    golden-ratio phase for the next build_perm call (the phase rotates
    which fractional CDF slots round up between rebuilds)."""

    def __init__(self, interval: int):
        self.interval = interval
        self.steps = 0
        self.rebuilds = 0

    def tick(self, n_steps: int):
        """Advance by n_steps; returns the rebuild phase, or None."""
        self.steps += n_steps
        if self.steps < self.interval:
            return None
        self.steps = 0
        self.rebuilds += 1
        return (self.rebuilds * 0.6180339887) % 1.0
