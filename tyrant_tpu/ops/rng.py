"""Vectorised, stateless xorshift RNG.

The reference threads a mutable ``unsigned int& seed`` through every device
function (kernel.cu:23-65, "Xorshift RNGs" by Marsaglia).  This rebuild
keeps the same generator *distributions* but makes the state explicit and
batched: every function takes a ``uint32`` seed array and returns
``(new_seed, value)`` — the functional-carry equivalent of the reference's
by-reference mutation.  All ops are element-wise over arbitrary batch shapes,
so they vectorise.

Seed initialisation intentionally does NOT copy the reference's
``(frame * 147565741) * 720898027 * index`` (kernel.cu:258) because that
formula yields seed == 0 for index == 0 (xorshift fixes 0 forever) and is
strongly correlated across rays.  We use a Wang-style integer hash instead;
golden tests therefore compare within Monte-Carlo tolerance, never
stream-for-stream (SURVEY.md §7 "hard parts" item 3).
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def seed_from(*parts) -> jnp.ndarray:
    """Build a well-mixed uint32 seed from integer components (e.g. frame,
    ray index).  Replaces kernel.cu:258 / kernel.cu:363 seeding."""
    h = jnp.asarray(0x9E3779B9, dtype=_U32)
    for p in parts:
        p = jnp.asarray(p).astype(_U32)
        h = h ^ (p + jnp.asarray(0x9E3779B9, _U32) + (h << 6) + (h >> 2))
        # wang hash round
        h = (h ^ jnp.asarray(61, _U32)) ^ (h >> 16)
        h = h * jnp.asarray(9, _U32)
        h = h ^ (h >> 4)
        h = h * jnp.asarray(0x27D4EB2D, _U32)
        h = h ^ (h >> 15)
    # xorshift has a fixed point at 0; nudge.
    return jnp.where(h == 0, jnp.asarray(0x1337C0DE, _U32), h)


def xorshift(seed: jnp.ndarray) -> jnp.ndarray:
    """One Marsaglia xorshift32 step.  Reference: kernel.cu:23-28."""
    seed = seed.astype(_U32)
    seed = seed ^ (seed << 13)
    seed = seed ^ (seed >> 17)
    seed = seed ^ (seed << 5)
    return seed


def random_float(seed: jnp.ndarray):
    """Uniform float in [0, 1).  Reference: kernel.cu:31-33
    (``RandomInt(seed) * 2.3283064365387e-10f``)."""
    seed = xorshift(seed)
    return seed, seed.astype(jnp.float32) * jnp.float32(2.3283064365387e-10)


def random_float2(seed: jnp.ndarray):
    """Uniform float in [0, 1] with 16-bit granularity.
    Reference: kernel.cu:35-37 (``(RandomInt(seed) >> 16) / 65535.0f``)."""
    seed = xorshift(seed)
    return seed, (seed >> 16).astype(jnp.float32) / jnp.float32(65535.0)


def random_int_between_0_and_max(seed: jnp.ndarray, max_value: int):
    """Integer in [0, max_value] (inclusive — the reference's +0.99999 trick).
    Reference: kernel.cu:39-41."""
    seed, f = random_float(seed)
    return seed, (f * (max_value + 0.99999)).astype(jnp.int32)


def random_2d_stratified(seed: jnp.ndarray):
    """Stratified 2-D sample in [0,1]^2 over a 4x4 grid with a randomly chosen
    stratum.  Reference: kernel.cu:44-65 (``Random2DStratifiedSample``).

    Unlike the reference we clamp the stratum index to 15 (the reference's
    RandomIntBetween0AndMax can return 16, aliasing back onto stratum (0,0)
    with a tiny bias — SURVEY.md §7 lists this among quirks not to copy).
    """
    width2d = 4
    height2d = 4
    inv_w = 1.0 / width2d
    inv_h = 1.0 / height2d
    seed, stratum = random_int_between_0_and_max(seed, width2d * height2d - 1)
    sx = (stratum % width2d).astype(jnp.float32)
    sy = ((stratum // width2d) % height2d).astype(jnp.float32)
    seed, jx = random_float(seed)
    seed, jy = random_float(seed)
    u = sx * inv_w + jx * inv_w
    v = sy * inv_h + jy * inv_h
    return seed, jnp.stack([u, v], axis=-1)
