"""GGX rough-conductor BSDF tests (beyond-reference material).

Covers: the VNDF sampler's estimator identity (E[F*G1(l)] == directional
albedo, the separable-Smith closed form), numpy-mirror equivalence, energy
conservation, scene plumbing of the roughness channel / static has_ggx
flag, and a full render vs the independent oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tyrant_tpu.camera import Camera
from tyrant_tpu.ops.sampling import (ggx_d, ggx_g1,
                                     ggx_vndf_sample_from_uniforms, reflect)
from tyrant_tpu.scene.scene import GGX, LIGHT, SPEC, Scene, Spheres

from . import oracle
from .test_render_golden import (SUN_POS, cluster_camera, compare,
                                 default_oracle_scene, run_oracle, run_jax)


def _albedo_mc(rough, cos_v, n=1 << 17, seed=0):
    """MC directional albedo with the VNDF sampler: E[F(=1) * G1(l)]."""
    alpha = rough * rough
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, (2, n))
    normal = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    sin_v = float(np.sqrt(max(1.0 - cos_v * cos_v, 0.0)))
    view = jnp.broadcast_to(jnp.asarray([sin_v, 0.0, cos_v]), (n, 3))
    h = ggx_vndf_sample_from_uniforms(view, normal,
                                      jnp.full(n, alpha), u[0], u[1])
    ldir = reflect(-view, h)
    nl = ldir[:, 2]
    w = jnp.where(nl > 0, ggx_g1(nl, alpha), 0.0)
    return float(jnp.mean(w))


def _albedo_quad(rough, cos_v, n_theta=400, n_phi=400):
    """Numerical hemisphere integral of f(v, l) * cos(l) (f0 = 1)."""
    alpha = rough * rough
    sin_v = np.sqrt(max(1.0 - cos_v * cos_v, 0.0))
    view = np.array([sin_v, 0.0, cos_v])
    th = (np.arange(n_theta) + 0.5) / n_theta * (np.pi / 2)
    ph = (np.arange(n_phi) + 0.5) / n_phi * (2 * np.pi)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    l = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                  np.cos(tt)], -1).reshape(-1, 3)
    normal = np.broadcast_to([0.0, 0.0, 1.0], l.shape)
    v = np.broadcast_to(view, l.shape)
    f = oracle.ggx_eval_np(normal, v, l, np.full(l.shape[0], alpha),
                           np.ones_like(l))[:, 0]
    w = f * np.cos(tt).ravel() * np.sin(tt).ravel()
    return float(w.sum() * (np.pi / 2 / n_theta) * (2 * np.pi / n_phi))


@pytest.mark.parametrize("rough", [0.2, 0.5, 0.9])
@pytest.mark.parametrize("cos_v", [0.95, 0.7, 0.3])
def test_vndf_estimator_matches_brdf_integral(rough, cos_v):
    mc = _albedo_mc(rough, cos_v)
    quad = _albedo_quad(rough, cos_v)
    assert abs(mc - quad) < 0.02 * max(quad, 0.1), (mc, quad)


@pytest.mark.parametrize("rough", [0.1, 0.4, 1.0])
def test_ggx_energy_bounded(rough):
    # single-scatter GGX must not gain energy at any view angle
    for cos_v in (0.98, 0.6, 0.2):
        assert _albedo_mc(rough, cos_v) <= 1.0 + 1e-3


def test_vndf_numpy_mirror_matches_jax():
    rng = np.random.default_rng(3)
    n = 4096
    view = rng.normal(size=(n, 3))
    view[:, 2] = np.abs(view[:, 2]) + 0.05
    view /= np.linalg.norm(view, axis=1, keepdims=True)
    normal = np.broadcast_to([0.0, 0.0, 1.0], (n, 3)).copy()
    alpha = rng.uniform(0.01, 1.0, n)
    u1 = rng.uniform(size=n)
    u2 = rng.uniform(size=n)
    h_np = oracle.ggx_vndf_sample_np(view, normal, alpha, u1, u2)
    h_jx = np.asarray(ggx_vndf_sample_from_uniforms(
        jnp.asarray(view, jnp.float32), jnp.asarray(normal, jnp.float32),
        jnp.asarray(alpha, jnp.float32), jnp.asarray(u1, jnp.float32),
        jnp.asarray(u2, jnp.float32)))
    assert np.abs(h_np - h_jx).max() < 1e-4
    # sampled half-vectors face the viewer (VNDF property)
    assert (np.sum(h_np * view, -1) > 0).all()


def test_ggx_d_normalisation():
    # integral of D(h) cos(h) over the hemisphere == 1
    for alpha in (0.04, 0.25, 1.0):
        n_t = 2048
        th = (np.arange(n_t) + 0.5) / n_t * (np.pi / 2)
        d = np.asarray(ggx_d(jnp.asarray(np.cos(th)), alpha))
        val = (d * np.cos(th) * np.sin(th)).sum() * (np.pi / 2 / n_t) \
            * 2 * np.pi
        assert abs(val - 1.0) < 2e-3, (alpha, val)


def _ggx_spheres(rough=0.4):
    """Default seven with the SPEC sphere swapped to a gold-ish GGX."""
    s = Spheres.default_seven()
    refl = s.refl.copy()
    refl[3] = GGX
    color = s.color.copy()
    color[3] = (1.0, 0.77, 0.34)
    roughness = np.full(s.count, rough, np.float32)
    return Spheres(center=s.center, radius=s.radius, color=color,
                   emission=s.emission, refl=refl, roughness=roughness)


def test_scene_plumbing_and_static_flag():
    dev = Scene.load(None).to_device()
    assert dev.has_ggx is False
    sp = _ggx_spheres(rough=0.4)
    dev2 = Scene.load(None, spheres=sp).to_device()
    assert dev2.has_ggx is True
    tbl = np.asarray(dev2.sphere_table)
    assert np.allclose(tbl[:, 11], 0.4, atol=1e-6)
    assert tbl[3, 10] == GGX
    # roughness clamp
    sp3 = _ggx_spheres(rough=0.0)
    assert np.asarray(Scene.load(None, spheres=sp3).to_device()
                      .sphere_table)[:, 11].min() >= 0.03


def test_ggx_triangles_render_finite():
    # a GGX quad above the ground; exercises the tri_shade roughness lane
    v0 = np.array([[-30, -90, 60], [30, -70, 60]], np.float32)
    v1 = np.array([[30, -90, 60], [-30, -90, 60]], np.float32)
    v2 = np.array([[30, -70, 60], [-30, -70, 60]], np.float32)
    sc = Scene.from_triangles(
        v0, v1, v2, builder="numpy",
        tri_refl=np.full(2, GGX, np.int32),
        tri_color=np.full((2, 3), (0.9, 0.9, 0.9), np.float32),
        tri_rough=np.full(2, 0.25, np.float32))
    dev = sc.to_device()
    assert dev.has_ggx is True
    cam = cluster_camera()
    cam.vertical_angle = 0.15
    acc, _ = run_jax(sc, cam, steps=6, num_rays=1 << 12)
    assert np.isfinite(acc).all()
    assert (acc[:, 3] > 0).all()


def test_obj_mtl_metallic_loads_ggx(tmp_path):
    (tmp_path / "m.mtl").write_text(
        "newmtl gold\nKd 1.0 0.77 0.34\nPr 0.22\nPm 1.0\n"
        "newmtl matte\nKd 0.5 0.5 0.5\n")
    (tmp_path / "s.obj").write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "usemtl gold\nf 1 2 3\n"
        "usemtl matte\nf 2 4 3\n")
    sc = Scene.load(str(tmp_path / "s.obj"), builder="numpy")
    assert sc.tri_refl is not None and sc.tri_rough is not None
    assert sc.tri_refl[0] == GGX and sc.tri_refl[1] == 0
    assert abs(sc.tri_rough[0] - 0.22) < 1e-6
    dev = sc.to_device()
    assert dev.has_ggx is True
    # roughness rides tri_shade lane 7 in BVH leaf order
    ts = np.asarray(dev.tri_shade)
    refl_col = np.asarray(dev.tri_refl)
    assert (ts[refl_col == GGX, 7] > 0.2).all()


def test_instancing_carries_roughness(tmp_path):
    from tyrant_tpu.scene.instancing import MeshAsset, translate
    quad = MeshAsset(
        v0=np.array([[0, 0, 0]], np.float32),
        v1=np.array([[1, 0, 0]], np.float32),
        v2=np.array([[0, 1, 0]], np.float32),
        tri_refl=np.array([GGX], np.int32),
        tri_rough=np.array([0.15], np.float32))
    sc = Scene.from_instances([quad], [(0, translate((0, 0, 0))),
                                       (0, translate((5, 0, 0)))],
                              builder="numpy")
    assert sc.tri_rough.shape == (2,)
    assert np.allclose(sc.tri_rough, 0.15)
    assert sc.to_device().has_ggx is True


@pytest.mark.slow
def test_ggx_sphere_scene_matches_oracle():
    sp = _ggx_spheres(rough=0.4)
    scene = Scene.load(None, spheres=sp)
    cam = cluster_camera()
    acc_jax, cfg = run_jax(scene, cam, steps=60)
    rows = [(sp.radius[i], sp.center[i], sp.color[i], sp.emission[i],
             sp.refl[i]) for i in range(sp.count)]
    osc = oracle.OracleScene(rows, light_index=6, roughness=sp.roughness)
    acc_or = run_oracle(osc, cam, 1500, cfg)
    compare(acc_jax, acc_or)
