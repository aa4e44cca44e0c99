"""Volumetric fog tests (cfg.fog="on"; render._shade medium events).

Covers: config validation, the HG phase/sampler pair, the slab-overlap
geometry, the zero-sigma no-op gate, analytic pure-absorption attenuation,
a golden comparison against the numpy oracle's independent fog
implementation, and feature-composition smoke (MIS, Sobol, sharded).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest

from tyrant_tpu.config import small_config
from tyrant_tpu.ops.sampling import hg_phase, hg_sample_from_uniforms
from tyrant_tpu.ops.tonemap import resolve
from tyrant_tpu.render import (Renderer, _fog_density_coeffs,
                               _fog_free_flight, _fog_optical_depth,
                               _fog_overlap)
from tyrant_tpu.scene.scene import Scene

from . import oracle
from .test_render_golden import (H, SUN_POS, W, cluster_camera, compare,
                                 default_oracle_scene)

PI = math.pi


# ------------------------------------------------------------------ config

def test_config_validation():
    with pytest.raises(ValueError):
        dataclasses.replace(small_config(), fog="dense")
    with pytest.raises(ValueError):
        dataclasses.replace(small_config(), fog_sigma_s=-0.1)
    with pytest.raises(ValueError):
        dataclasses.replace(small_config(), fog_g=1.0)
    with pytest.raises(ValueError):
        dataclasses.replace(small_config(), fog_z_min=5.0, fog_z_max=1.0)
    with pytest.raises(ValueError):
        dataclasses.replace(small_config(), fog_falloff=math.inf)
    # falloff over an unbounded-below slab: infinitely dense at depth
    with pytest.raises(ValueError):
        dataclasses.replace(small_config(), fog="on", fog_falloff=0.05)
    # fine once the slab floor is set
    dataclasses.replace(small_config(), fog="on", fog_falloff=0.05,
                        fog_z_min=0.0)


# ------------------------------------------------- height-falloff profile

def test_fog_optical_depth_matches_quadrature():
    """Closed-form optical depth of the exponential-height medium vs
    numeric integration of sigma_t * exp(-falloff * z(t)) along random
    rays (up, down, and near-horizontal)."""
    rng = np.random.default_rng(3)
    n, lam, sigma_t = 64, 0.13, 0.7
    o = jnp.asarray(rng.uniform(-10, 10, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d[:5, 2] = 0.0  # exercise the k -> 0 limit
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True),
                    jnp.float32)
    ta = jnp.asarray(rng.uniform(0, 4, n), jnp.float32)
    s = jnp.asarray(rng.uniform(0.1, 12, n), jnp.float32)
    rho0, k = _fog_density_coeffs(o, d, ta, lam)
    tau = np.asarray(_fog_optical_depth(sigma_t, rho0, k, s))
    t_grid = np.linspace(0, 1, 4001)
    for i in range(n):
        tt = float(ta[i]) + t_grid * float(s[i])
        z = float(o[i, 2]) + float(d[i, 2]) * tt
        ref = sigma_t * np.trapezoid(np.exp(-lam * z), tt)
        assert abs(tau[i] - ref) < 2e-3 * max(ref, 1.0), (i, tau[i], ref)


def test_fog_free_flight_inverts_optical_depth():
    """The sampled collision distance satisfies tau(s) == -log(1-u)
    exactly (the defining CDF property), and rays climbing out of the
    fog escape (VERY_FAR) precisely when their total optical depth to
    infinity is below the target."""
    rng = np.random.default_rng(5)
    n, lam, sigma_t = 512, 0.21, 0.35
    o = jnp.asarray(rng.uniform(-8, 8, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d[:8, 2] = 0.0
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True),
                    jnp.float32)
    ta = jnp.zeros((n,), jnp.float32)
    u = jnp.asarray(rng.uniform(1e-4, 1 - 1e-4, n), jnp.float32)
    rho0, k = _fog_density_coeffs(o, d, ta, lam)
    s = np.asarray(_fog_free_flight(u, sigma_t, rho0, k))
    e = -np.log1p(-np.asarray(u))
    # escape: k > 0 and total depth sigma*rho0/k below the target
    total = np.where(np.asarray(k) > 1e-12,
                     sigma_t * np.asarray(rho0) / np.maximum(
                         np.asarray(k), 1e-12), np.inf)
    esc = s >= 1e19
    np.testing.assert_array_equal(esc, total < e)
    tau_s = np.asarray(_fog_optical_depth(sigma_t, rho0, k,
                                          jnp.asarray(s)))[~esc]
    np.testing.assert_allclose(tau_s, e[~esc], rtol=2e-3, atol=1e-5)


def test_fog_tiny_falloff_matches_homogeneous():
    """falloff ~ 0 through the heterogeneous branch reproduces the
    homogeneous render (same RNG draws -> per-path float-level match)."""
    base = small_config(width=W, height=H, num_rays=1 << 12)
    fog = dict(fog="on", fog_sigma_s=0.01, fog_sigma_a=0.002,
               fog_g=0.2, fog_z_min=0.0, fog_z_max=80.0)
    a = _render(dataclasses.replace(base, **fog), steps=6)
    b = _render(dataclasses.replace(base, **fog, fog_falloff=1e-9), steps=6)
    # a handful of paths flip their fog event at the float-rounding edge
    # of the collision distance; everything else matches to float noise
    np.testing.assert_allclose(a, b, rtol=0.01, atol=0.02)


def test_height_fog_absorption_matches_analytic():
    """Camera inside an absorbing height-falloff slab looking up at open
    sky: per-pixel transmittance is exp(-tau) with the closed-form tau of
    the exponential profile (mirrors test_pure_absorption_attenuates_sky
    but with falloff on)."""
    sigma, lam, z_top, z_cam = 0.05, 0.06, 90.0, 40.0
    cam = cluster_camera()          # position z = 40, inside the slab
    cam.vertical_angle = 1.2
    cam.horizontal_angle = math.pi
    base = small_config(width=W, height=H, num_rays=1 << 13)
    acc_clear = _render(dataclasses.replace(base, fog="off"),
                        steps=30, cam=cam)
    acc_fog = _render(
        dataclasses.replace(base, fog="on", fog_sigma_s=0.0,
                            fog_sigma_a=sigma, fog_z_min=0.0,
                            fog_z_max=z_top, fog_falloff=lam),
        steps=30, cam=cam)
    right, up = cam.basis(base)
    pix = np.arange(W * H)
    ni = ((pix % W) + 0.5) / W - 0.5
    nj = (H - ((pix // W) + 0.5)) / H - 0.5
    dirs = cam.direction[None] + ni[:, None] * right[None] \
        + nj[:, None] * up[None]
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    length = (z_top - z_cam) / dirs[:, 2]
    k = lam * dirs[:, 2]
    tau = sigma * np.exp(-lam * z_cam) * -np.expm1(-k * length) / k
    expect = np.exp(-tau)
    lum_clear = acc_clear[:, :3].mean(1) / acc_clear[:, 3]
    lum_fog = acc_fog[:, :3].mean(1) / np.maximum(acc_fog[:, 3], 1)
    ratio = (lum_fog / np.maximum(lum_clear, 1e-12)).mean()
    assert abs(ratio - expect.mean()) < 0.05 * expect.mean(), \
        (ratio, expect.mean())


# ------------------------------------------------------------- phase model

@pytest.mark.parametrize("g", [0.0, 0.4, -0.7])
def test_hg_phase_normalized(g):
    """The solid-angle integral of the phase function must be 1:
    2*pi * int phase(cos) d(cos) over [-1, 1]."""
    c = jnp.linspace(-1.0, 1.0, 20001)
    vals = np.asarray(hg_phase(c, g))
    integral = 2.0 * PI * np.trapezoid(vals, np.asarray(c))
    assert abs(integral - 1.0) < 1e-3, (g, integral)


@pytest.mark.parametrize("g", [0.0, 0.5, -0.4])
def test_hg_sample_matches_phase(g):
    """Mean scattering cosine of HG samples equals g (the defining
    property), and samples are unit length around the input direction."""
    n = 200_000
    rng = np.random.default_rng(7)
    d = jnp.asarray(np.tile([[0.26726124, 0.53452248, 0.80178373]], (n, 1)),
                    jnp.float32)
    out = np.asarray(hg_sample_from_uniforms(
        d, g, jnp.asarray(rng.random(n), jnp.float32),
        jnp.asarray(rng.random(n), jnp.float32)))
    assert np.allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-4)
    mean_cos = float((out @ np.asarray(d[0])).mean())
    assert abs(mean_cos - g) < 0.01, (g, mean_cos)


def test_slab_overlap_cases():
    o = jnp.asarray([[0, 0, 5], [0, 0, 5], [0, 0, 50], [0, 0, 5],
                     [0, 0, -5], [0, 0, 5]], jnp.float32)
    d = jnp.asarray([[0, 0, 1], [0, 0, 1], [1, 0, 0], [1, 0, 0],
                     [1, 0, 0], [0, 0, -1]], jnp.float32)
    t_lim = jnp.asarray([1e20, 2.0, 1e20, 7.0, 1e20, 1e20], jnp.float32)
    ta, ln = map(np.asarray, _fog_overlap(o, d, t_lim, 0.0, 10.0))
    # ta is only meaningful where the overlap is non-empty
    np.testing.assert_allclose(ta[ln > 0], 0.0, atol=1e-5)
    # up-and-out: 5 to the top; clipped by t_lim=2; horizontal above slab:
    # empty; horizontal inside clipped at 7; below slab parallel: empty;
    # downward: 5 to the bottom
    np.testing.assert_allclose(ln, [5, 2, 0, 7, 0, 5], rtol=1e-5)
    # entering from above
    ta2, ln2 = map(np.asarray, _fog_overlap(
        jnp.asarray([[0, 0, 20.0]]), jnp.asarray([[0, 0, -1.0]]),
        jnp.asarray([1e20], jnp.float32), 0.0, 10.0))
    np.testing.assert_allclose(ta2, [10.0], rtol=1e-5)
    np.testing.assert_allclose(ln2, [10.0], rtol=1e-5)


# --------------------------------------------------------------- renderer

def _render(cfg, steps=8, cam=None):
    r = Renderer(Scene.load(None), cfg, sun_position=SUN_POS, donate=False)
    r.step(cam or cluster_camera(), steps)
    return np.asarray(r.state.accum)


def test_zero_sigma_is_noop():
    """fog="on" with both coefficients 0 must compile the identical
    program (the static gate) — bitwise-equal accumulation."""
    base = small_config(width=W, height=H, num_rays=1 << 12)
    a = _render(dataclasses.replace(base, fog="off"))
    b = _render(dataclasses.replace(base, fog="on", fog_sigma_s=0.0,
                                    fog_sigma_a=0.0))
    assert np.array_equal(a, b)


def test_pure_absorption_attenuates_sky():
    """Camera inside an absorbing slab looking up at open sky: each path
    reaches the sky with probability exp(-sigma_a * L), so the per-pixel
    mean radiance is the clear-sky value times that transmittance."""
    sigma = 0.03
    z_top = 90.0
    cam = cluster_camera()          # position z = 40, inside the slab
    cam.vertical_angle = 1.2        # look up...
    cam.horizontal_angle = math.pi  # ...and away from the light sphere
    base = small_config(width=W, height=H, num_rays=1 << 13)
    acc_clear = _render(dataclasses.replace(base, fog="off"),
                        steps=30, cam=cam)
    acc_fog = _render(
        dataclasses.replace(base, fog="on", fog_sigma_s=0.0,
                            fog_sigma_a=sigma, fog_z_min=0.0,
                            fog_z_max=z_top), steps=30, cam=cam)
    # per-pixel expected transmittance from the pixel-centre directions
    right, up = cam.basis(base)
    pix = np.arange(W * H)
    ni = ((pix % W) + 0.5) / W - 0.5
    nj = (H - ((pix // W) + 0.5)) / H - 0.5
    dirs = cam.direction[None] + ni[:, None] * right[None] \
        + nj[:, None] * up[None]
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    expect = np.exp(-sigma * (z_top - 40.0) / dirs[:, 2])
    lum_clear = acc_clear[:, :3].mean(1) / acc_clear[:, 3]
    lum_fog = acc_fog[:, :3].mean(1) / np.maximum(acc_fog[:, 3], 1)
    ratio = (lum_fog / np.maximum(lum_clear, 1e-12)).mean()
    assert abs(ratio - expect.mean()) < 0.05 * expect.mean(), \
        (ratio, expect.mean())


@pytest.mark.slow
@pytest.mark.parametrize("falloff", [0.0, 0.03])
def test_fog_scene_matches_oracle(falloff):
    """Scattering + absorbing fog over the default spheres scene vs the
    oracle's independent numpy implementation of the same estimator
    (uniform slab and exponential height profile)."""
    fog = dict(fog="on", fog_sigma_s=0.003, fog_sigma_a=0.0005,
               fog_g=0.3, fog_z_min=0.0, fog_z_max=80.0,
               fog_falloff=falloff)
    cam = cluster_camera()
    cfg = dataclasses.replace(
        small_config(width=W, height=H, num_rays=1 << 14), **fog)
    r = Renderer(Scene.load(None), cfg, sun_position=SUN_POS, donate=False)
    r.step(cam, 60)
    acc_jax = np.asarray(r.state.accum)
    acc_or = oracle.render_oracle(
        default_oracle_scene(), cam.position.astype(float),
        cam.direction.astype(float),
        *(b.astype(float) for b in cam.basis(cfg)), W, H, 1500,
        _sun_dir(), seed=1,
        fog=(fog["fog_sigma_s"], fog["fog_sigma_a"], fog["fog_g"],
             fog["fog_z_min"], fog["fog_z_max"], fog["fog_falloff"]))
    compare(acc_jax, acc_or)


def _sun_dir():
    import tyrant_tpu.sky as skymod
    return np.asarray(
        skymod.sun_direction_from_position(jnp.asarray(SUN_POS))).astype(float)


def test_fog_composes_with_mis_and_sobol():
    cfg = dataclasses.replace(
        small_config(width=W, height=H, num_rays=1 << 12),
        fog="on", fog_sigma_s=0.005, fog_g=0.2, fog_z_max=80.0,
        mis="on", sampler="sobol")
    acc = _render(cfg, steps=6)
    assert np.isfinite(acc).all() and acc[:, 3].sum() > 0
    img = np.asarray(resolve(jnp.asarray(acc), W, H))
    assert img.max() > 0.05


def test_fog_sharded_step_runs():
    import jax
    import tyrant_tpu.sky as skymod
    from tyrant_tpu.parallel.sharded import (init_sharded_state, make_mesh,
                                             make_sharded_step)
    mesh = make_mesh(jax.devices()[:8])
    cfg = dataclasses.replace(
        small_config(width=16, height=16, num_rays=1 << 9),
        fog="on", fog_sigma_s=0.01, fog_z_max=80.0)
    st = init_sharded_state(cfg, mesh)
    step = make_sharded_step(cfg, mesh)
    cam = cluster_camera()
    sun = skymod.sun_direction_from_position(jnp.asarray(SUN_POS))
    sc = Scene.load(None).to_device()
    st = step(st, sc, cam.to_device(cfg), sun)
    acc = np.asarray(st.accum)
    assert np.isfinite(acc).all() and acc[:, 3].sum() > 0
