"""Framebuffer accumulation (render.accumulate_terminated) vs a per-update
numpy oracle.

The step's compaction sort emits terminated rays keyed by pixel (< P) and
survivors keyed at or past ``sentinel(P)``; the accumulation adds each
terminated ray's row into its pixel and drops the survivors — the
reference's atomicAdd framebuffer update (kernel.cu:622-625, 641-644)."""

import jax.numpy as jnp
import numpy as np

from tyrant_tpu.render import accumulate_terminated, sentinel

BLOCK = 2048   # pixel-block edge used by the boundary cases below


def _oracle(accum, keys, vals, p):
    out = np.asarray(accum, np.float64).copy()
    for k, v in zip(np.asarray(keys), np.asarray(vals, np.float64)):
        if k < p:
            out[k] += v
    return out.astype(np.float32)


def _run(accum, keys, vals, p):
    keys = np.sort(np.asarray(keys, np.int32))
    got = accumulate_terminated(jnp.asarray(accum), jnp.asarray(keys),
                                sentinel(p), jnp.asarray(vals))
    return np.asarray(got), _oracle(accum, keys, vals, p)


def _case(p, n, rng, frac_survivors=0.3, span=None):
    accum = rng.normal(size=(p, 4)).astype(np.float32)
    keys = rng.integers(0, span or p, size=n)
    # survivors sit past the sentinel, spread like octant/cell keys
    surv = rng.random(n) < frac_survivors
    keys = np.where(surv, sentinel(p) + rng.integers(0, 8 * 512, n), keys)
    vals = rng.normal(size=(n, 4)).astype(np.float32)
    return accum, keys, vals


def test_matches_scatter_oracle_uniform():
    rng = np.random.default_rng(0)
    got, want = _run(*_case(4 * BLOCK, 4096, rng), p=4 * BLOCK)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_block_straddling_and_hot_pixels():
    """Many updates collapsing onto few pixels at block boundaries and at
    both ends of the framebuffer."""
    rng = np.random.default_rng(1)
    p, n = 2 * BLOCK, 2048
    edges = np.array([BLOCK - 1, BLOCK, BLOCK + 1, 0, p - 1])
    keys = np.concatenate([np.repeat(edges, n // 10),
                           rng.integers(0, p, n - (n // 10) * 5)])
    vals = rng.normal(size=(n, 4)).astype(np.float32)
    got, want = _run(np.zeros((p, 4), np.float32), keys, vals, p)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_all_survivors_is_identity():
    rng = np.random.default_rng(2)
    p = BLOCK
    accum = rng.normal(size=(p, 4)).astype(np.float32)
    keys = sentinel(p) + rng.integers(0, 8 * 512, 1024)
    vals = rng.normal(size=(1024, 4)).astype(np.float32)
    got, _ = _run(accum, keys, vals, p)
    np.testing.assert_array_equal(got, accum)


def test_alpha_path_counts_exact():
    """The alpha column counts completed paths: integers, summed exactly."""
    rng = np.random.default_rng(3)
    p, n = 2 * BLOCK, 4096
    keys = rng.integers(0, p, n)
    vals = np.zeros((n, 4), np.float32)
    vals[:, 3] = 1.0
    got, _ = _run(np.zeros((p, 4), np.float32), keys, vals, p)
    assert float(got[:, 3].sum()) == n
    np.testing.assert_array_equal(got[:, 3], np.bincount(keys, minlength=p))


def test_ragged_framebuffer():
    """P not a multiple of any block size (1080p: 2,073,600 pixels)."""
    rng = np.random.default_rng(4)
    p = BLOCK + 777
    got, want = _run(*_case(p, 2048, rng), p=p)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
