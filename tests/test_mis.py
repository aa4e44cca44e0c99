"""Multiple importance sampling tests (beyond-reference estimator mode).

Covers: state/config plumbing, estimator consistency (MIS and the
reference estimator converge to the same mean on area-light transport),
parity with the oracle's independent MIS implementation, and the variance
reduction MIS exists for (glossy reflections of emitters).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from tyrant_tpu.camera import Camera
from tyrant_tpu.config import small_config
from tyrant_tpu.ops.tonemap import resolve
from tyrant_tpu.render import Renderer, init_state
from tyrant_tpu.scene.scene import GGX, Scene, Spheres

from . import oracle
from .test_render_golden import SUN_POS, W, H, cluster_camera, compare, \
    run_oracle

# a sun position low under the horizon: sun()/sunsky() radiance goes
# through the SunIntensity cutoff, so area-light transport dominates and
# the MIS-vs-reference comparison is exact (the two estimators share the
# same ground truth for area lights; the sun disc's NEE radiance model
# differs from the BSDF-side sunsky by construction — reference quirk)
LOW_SUN = (0.05, -0.35)


def _mis_cfg(num_rays=1 << 14, mis="on"):
    return dataclasses.replace(
        small_config(width=W, height=H, num_rays=num_rays), mis=mis)


def _ggx_light_spheres(rough=0.12):
    """Default seven, SPEC -> low-roughness GGX (glossy reflections of the
    green light sphere are the MIS-sensitive transport)."""
    s = Spheres.default_seven()
    refl = s.refl.copy()
    refl[3] = GGX
    return Spheres(center=s.center, radius=s.radius, color=s.color,
                   emission=s.emission, refl=refl,
                   roughness=np.full(s.count, rough, np.float32))


def _run(scene, cam, steps, cfg, sun=SUN_POS):
    r = Renderer(scene, cfg, sun_position=sun, donate=False)
    r.step(cam, steps)
    return np.asarray(r.state.accum)


def test_state_and_config_plumbing():
    cfg_off = _mis_cfg(mis="off")
    assert init_state(cfg_off).bsdf_pdf.shape == (1,)
    cfg_on = _mis_cfg(mis="on")
    st = init_state(cfg_on)
    assert st.bsdf_pdf.shape == (cfg_on.num_rays,)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg_off, mis="maybe")


def test_checkpoint_roundtrip_with_mis(tmp_path):
    from tyrant_tpu.checkpoint import load_state, save_state
    cfg = _mis_cfg(num_rays=1 << 10)
    cam = cluster_camera()
    r = Renderer(Scene.load(None), cfg, sun_position=SUN_POS, donate=False)
    r.step(cam, 3)
    p = str(tmp_path / "st.npz")
    save_state(p, r.state)
    st2, _ = load_state(p)
    assert np.array_equal(np.asarray(st2.bsdf_pdf),
                          np.asarray(r.state.bsdf_pdf))


@pytest.mark.slow
def test_mis_consistent_with_reference_estimator():
    """Both estimators are unbiased for area-light transport: under a
    below-horizon sun the images must agree within MC tolerance."""
    sp = _ggx_light_spheres(rough=0.3)
    cam = cluster_camera()
    acc_off = _run(Scene.load(None, spheres=sp), cam, 60,
                   _mis_cfg(mis="off"), sun=LOW_SUN)
    acc_on = _run(Scene.load(None, spheres=sp), cam, 60,
                  _mis_cfg(mis="on"), sun=LOW_SUN)
    compare(acc_off, acc_on)


@pytest.mark.slow
def test_mis_matches_oracle_mis():
    sp = _ggx_light_spheres(rough=0.25)
    cam = cluster_camera()
    cfg = _mis_cfg(mis="on")
    acc_jax = _run(Scene.load(None, spheres=sp), cam, 60, cfg)
    rows = [(sp.radius[i], sp.center[i], sp.color[i], sp.emission[i],
             sp.refl[i]) for i in range(sp.count)]
    osc = oracle.OracleScene(rows, light_index=6, roughness=sp.roughness)
    # run_oracle has no mis kwarg passthrough; call render_oracle directly
    import tyrant_tpu.sky as skymod
    right, up = cam.basis(cfg)
    sun_dir = np.asarray(
        skymod.sun_direction_from_position(jnp.asarray(SUN_POS)))
    acc_or = oracle.render_oracle(
        osc, cam.position.astype(float), cam.direction.astype(float),
        right.astype(float), up.astype(float), W, H, 1500,
        sun_dir.astype(float), seed=1, mis=True)
    compare(acc_jax, acc_or)



@pytest.mark.slow
def test_mis_reduces_glossy_emitter_variance():
    """The point of MIS: a low-roughness GGX surface reflecting an area
    light.  NEE area-samples the emitter, so only the tiny lobe-overlap
    sliver of its samples carries energy (rare, huge weights); BSDF
    samples hit the emitter directly but the reference estimator zeroes
    them.  A minimal GGX-sphere + light scene isolates that transport
    (measured ~150x lower per-pixel variance; assert 5x for headroom).
    On a full multi-BSDF scene this comparison is swamped by OTHER rare
    events that resolve differently in each mode, which is why the test
    does not use the default seven spheres."""
    from tyrant_tpu.scene.scene import LIGHT
    sp = Spheres(
        center=np.array([[-40, -50, 16.5], [0, -80, 120]], np.float32),
        radius=np.array([16.5, 9.0], np.float32),
        color=np.array([[1, 1, 1], [0, 1, 0]], np.float32),
        emission=np.array([[0, 0, 0], [3, 3, 3]], np.float32),
        refl=np.array([GGX, LIGHT], np.int32),
        roughness=np.array([0.08, 0.3], np.float32))
    cam = Camera()
    cam.position = np.array([-40.0, -100.0, 25.0], np.float32)
    cam.vertical_angle = -0.12
    reps = 6
    steps = 6

    def imgs(mode):
        out = []
        for k in range(reps):
            cfg = _mis_cfg(num_rays=1 << 13, mis=mode)
            r = Renderer(Scene.load(None, spheres=sp), cfg,
                         sun_position=LOW_SUN, donate=False)
            # decorrelate runs: advance the frame counter before rendering
            r.state = dataclasses.replace(
                r.state, frame=r.state.frame + 1000 * k)
            r.step(cam, steps)
            acc = np.asarray(r.state.accum)
            out.append(acc[:, :3] / np.maximum(acc[:, 3:4], 1))
        return np.stack(out)

    i_off = imgs("off")
    i_on = imgs("on")
    v_off = i_off.var(axis=0).mean(-1).mean()
    v_on = i_on.var(axis=0).mean(-1).mean()
    assert v_on < v_off / 5.0, (v_on, v_off)


def test_mis_sharded_step_runs():
    """MIS state (the extra bsdf_pdf leaf) through the 8-device mesh."""
    import jax
    from tyrant_tpu.parallel.sharded import (init_sharded_state, make_mesh,
                                             make_sharded_step)
    mesh = make_mesh(jax.devices()[:8])
    cfg = dataclasses.replace(
        small_config(width=16, height=16, num_rays=1 << 9), mis="on")
    st = init_sharded_state(cfg, mesh)
    assert st.bsdf_pdf.shape == (8 * cfg.num_rays,)
    step = make_sharded_step(cfg, mesh)
    from tyrant_tpu.camera import Camera as Cam
    import tyrant_tpu.sky as skymod
    cam = cluster_camera()
    sun = skymod.sun_direction_from_position(jnp.asarray(SUN_POS))
    sc = Scene.load(None).to_device()
    st = step(st, sc, cam.to_device(cfg), sun)
    acc = np.asarray(st.accum)
    assert np.isfinite(acc).all()
