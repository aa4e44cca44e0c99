"""Spectral glass dispersion (cfg.dispersion; render._shade REFR block).

The estimator stochastically collapses a polychromatic path to one
wavelength channel at its first glass event (direct *= 3 * onehot(c),
unbiased) and refracts with the per-channel IOR
eta_c = eta * (1 + dispersion * (c - 1)).  Covers: config validation,
unbiasedness (tiny-dispersion image expectation matches the baseline),
a visible-effect check, composition smoke, and an independent
numpy-oracle golden of the dispersed image.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from tyrant_tpu.config import small_config
from tyrant_tpu.ops.tonemap import resolve
from tyrant_tpu.render import Renderer
from tyrant_tpu.scene.scene import Scene

from .test_render_golden import (H, SUN_POS, W, cluster_camera, compare,
                                 default_oracle_scene, run_oracle, run_jax)


def test_config_validation():
    with pytest.raises(ValueError):
        dataclasses.replace(small_config(), dispersion=-0.1)
    with pytest.raises(ValueError):
        dataclasses.replace(small_config(), dispersion=0.9)


def _render(cfg, steps, cam=None):
    r = Renderer(Scene.load(None), cfg, sun_position=SUN_POS, donate=False)
    r.step(cam or cluster_camera(), steps)
    return np.asarray(r.state.accum)


def test_tiny_dispersion_preserves_mean_radiance():
    """The wavelength collapse is unbiased: with a vanishing IOR spread
    the image EXPECTATION matches the non-dispersed render (the collapse
    machinery runs, only the estimator variance changes)."""
    base = small_config(width=W, height=H, num_rays=1 << 14)
    a = _render(base, steps=40)
    b = _render(dataclasses.replace(base, dispersion=1e-6), steps=40)
    compare(a, b)


def test_dispersion_changes_glass_pixels_only():
    """dispersion=0.15 visibly moves radiance around the glass sphere's
    refraction paths while leaving the rest of the frame at MC noise."""
    base = small_config(width=W, height=H, num_rays=1 << 14)
    cam = cluster_camera()
    a = _render(base, steps=40, cam=cam)
    b = _render(dataclasses.replace(base, dispersion=0.15), steps=40,
                cam=cam)
    img_a = np.asarray(resolve(jnp.asarray(a), W, H))
    img_b = np.asarray(resolve(jnp.asarray(b), W, H))
    diff = np.abs(img_a - img_b).max(-1)
    # some pixels change substantially (the fringes)...
    assert diff.max() > 0.04, diff.max()
    # ...but the bulk of the frame is untouched beyond noise
    assert np.median(diff) < 0.02, np.median(diff)


def test_dispersion_composes_with_mis_and_sobol():
    cfg = dataclasses.replace(
        small_config(width=W, height=H, num_rays=1 << 12),
        dispersion=0.1, mis="on", sampler="sobol")
    acc = _render(cfg, steps=6)
    assert np.isfinite(acc).all() and acc[:, 3].sum() > 0


def test_dispersion_sharded_step_runs():
    import jax
    from tyrant_tpu import sky as skymod
    from tyrant_tpu.parallel.sharded import (init_sharded_state, make_mesh,
                                             make_sharded_step)
    mesh = make_mesh(jax.devices()[:8])
    cfg = dataclasses.replace(
        small_config(width=16, height=16, num_rays=1 << 9), dispersion=0.1)
    st = init_sharded_state(cfg, mesh)
    step = make_sharded_step(cfg, mesh)
    cam = cluster_camera()
    sun = skymod.sun_direction_from_position(jnp.asarray(SUN_POS))
    st = step(st, Scene.load(None).to_device(), cam.to_device(cfg), sun)
    acc = np.asarray(st.accum)
    assert np.isfinite(acc).all() and acc[:, 3].sum() > 0


def test_dispersion_composes_with_height_fog():
    """Every round-3 estimator feature at once: height-falloff fog,
    dispersion, MIS, Sobol — finite accumulation, paths terminate."""
    cfg = dataclasses.replace(
        small_config(width=W, height=H, num_rays=1 << 12),
        dispersion=0.1, fog="on", fog_sigma_s=0.004, fog_g=0.3,
        fog_z_min=0.0, fog_z_max=80.0, fog_falloff=0.03,
        mis="on", sampler="sobol")
    acc = _render(cfg, steps=6)
    assert np.isfinite(acc).all() and acc[:, 3].sum() > 0


@pytest.mark.slow
def test_dispersion_matches_oracle():
    """Dispersed render vs the oracle's independent implementation of the
    same wavelength-collapse estimator (dispersion strong enough that a
    non-dispersed implementation would fail the comparison)."""
    disp = 0.15
    cam = cluster_camera()
    cfg = dataclasses.replace(
        small_config(width=W, height=H, num_rays=1 << 14), dispersion=disp)
    r = Renderer(Scene.load(None), cfg, sun_position=SUN_POS, donate=False)
    r.step(cam, 60)
    acc_or = run_oracle(default_oracle_scene(), cam, 1500, cfg,
                        dispersion=disp)
    compare(np.asarray(r.state.accum), acc_or)
