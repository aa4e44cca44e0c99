"""Emissive-triangle area lights (beyond-reference: the reference's only
NEE target is a hard-coded sphere, kernel.cu:421/561)."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from tyrant_tpu import sky as skymod
from tyrant_tpu.camera import Camera
from tyrant_tpu.config import INV_PI, small_config
from tyrant_tpu.render import (Renderer, _connect, _intersect_scene, _raygen,
                               _shade)
from tyrant_tpu.scene.scene import DIFF, LIGHT, Scene, Spheres

CFG = small_config(width=16, height=16, num_rays=1 << 10)
SUN = skymod.sun_direction_from_position(jnp.asarray([0.05, 0.3]))


def _dummy_spheres():
    """One faraway dark sphere (the select chains need >= 1 row), no
    sphere lights."""
    return Spheres(center=np.array([[0, 0, -5e4]], np.float32),
                   radius=np.array([1.0], np.float32),
                   color=np.zeros((1, 3), np.float32),
                   emission=np.zeros((1, 3), np.float32),
                   refl=np.array([DIFF], np.int32))


def _floor_and_quad_light(light_z=60.0, half_l=20.0, emission=(4, 4, 4)):
    """Diffuse floor at z=0 + emissive quad (2 tris) at z=light_z."""
    hf = 300.0
    v0 = np.array([[-hf, -hf, 0], [hf, hf, 0],
                   [-half_l, -half_l, light_z], [half_l, half_l, light_z]],
                  np.float32)
    v1 = np.array([[hf, -hf, 0], [-hf, hf, 0],
                   [half_l, -half_l, light_z], [-half_l, half_l, light_z]],
                  np.float32)
    v2 = np.array([[-hf, hf, 0], [hf, -hf, 0],
                   [-half_l, half_l, light_z], [half_l, -half_l, light_z]],
                  np.float32)
    n = np.cross(v1 - v0, v2 - v0)
    flip = n[:, 2] < 0
    v1[flip], v2[flip] = v2[flip].copy(), v1[flip].copy()
    refl = np.array([DIFF, DIFF, LIGHT, LIGHT], np.int32)
    color = np.ones((4, 3), np.float32)
    color[2:] = emission
    # black envmap: no sun/sky -> the quad is the only illuminant and
    # the whole NEE budget goes to the light strategy (render.py)
    return Scene.from_triangles(
        v0, v1, v2, builder="numpy", spheres=_dummy_spheres(),
        tri_refl=refl, tri_color=color,
        envmap=np.zeros((4, 8, 3), np.float32))


def test_tri_light_table():
    sd = _floor_and_quad_light(half_l=20.0).to_device()
    assert sd.n_tri_lights == 2
    tl = np.asarray(sd.tri_lights)
    assert tl.shape == (2, 13)
    # each tri covers half the 40x40 quad
    np.testing.assert_allclose(tl[:, 12], 800.0, rtol=1e-5)
    np.testing.assert_allclose(tl[:, 9:12], 4.0)


def test_direct_hit_emission():
    """A primary ray hitting the emissive quad shows its emission
    (primaries carry lastSpecular=True)."""
    scene = _floor_and_quad_light().to_device()
    cam = Camera()
    cam.position = np.array([0.0, 0.0, 120.0], np.float32)
    cam.vertical_angle = -1.2  # look straight down at the quad
    camd = cam.to_device(CFG)
    gen = _raygen(CFG, camd, jnp.asarray(0), jnp.asarray(1, jnp.uint32),
                  CFG.height, 0)
    t, ident, is_tri = _intersect_scene(gen["origin"],
                                        gen["direction"], scene)
    color, term, _s, _n, _sh = _shade(
        CFG, scene, skymod.SkyParams(CFG.sky), SUN, gen, t, ident, is_tri,
        jnp.asarray(1, jnp.uint32))
    col = np.asarray(color)
    lit = col.max(axis=1) > 3.9
    assert lit.mean() > 0.1  # the quad covers part of the view
    np.testing.assert_allclose(col[lit], 4.0, rtol=1e-5)


def test_nee_matches_quadrature():
    """NEE direct lighting from the quad onto FIXED floor points matches
    a numpy area-integral quadrature of L * cos_s * cos_l / (pi r^2) dA
    (camera jitter would smear the hit points, so the shading points are
    pinned with straight-down rays)."""
    import jax

    scene = _floor_and_quad_light(light_z=60.0, half_l=20.0).to_device()
    n = CFG.num_rays
    rng = np.random.default_rng(1)
    xy = rng.uniform(-80, 80, (n, 2)).astype(np.float32)
    origin = np.concatenate([xy, np.full((n, 1), 50.0, np.float32)], axis=1)
    direction = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    rays = dict(origin=jnp.asarray(origin), direction=jnp.asarray(direction),
                direct=jnp.ones((n, 3)), pending=jnp.zeros((n, 3)),
                pixel=jnp.arange(n, dtype=jnp.int32)
                % (CFG.width * CFG.height),
                bounces=jnp.zeros((n,), jnp.int32),
                last_specular=jnp.zeros((n,), bool))

    @jax.jit
    def direct_once(f):
        t, ident, is_tri = _intersect_scene(rays["origin"],
                                            rays["direction"], scene)
        _c, _t, _s, _n, shadow = _shade(
            CFG, scene, skymod.SkyParams(CFG.sky), SUN, rays, t, ident,
            is_tri, f)
        return _connect(scene, shadow), t

    frames = 200
    acc = np.zeros((n, 3))
    for f in range(1, frames + 1):
        c, t = direct_once(jnp.asarray(f, jnp.uint32))
        acc += np.asarray(c)
    mean_contrib = acc / frames
    hp = origin + direction * np.asarray(t)[:, None]

    m = 50000
    qr = np.random.default_rng(0)
    u, v = qr.random(m), qr.random(m)
    su = np.sqrt(u)
    tl = np.asarray(scene.tri_lights)
    L = 4.0
    sel = [0, 5, 17, 100, 500, 900]
    want = []
    for i in sel:
        p = hp[i]
        e = 0.0
        for k in range(2):
            v0, e1, e2 = tl[k, 0:3], tl[k, 3:6], tl[k, 6:9]
            pts = v0 + (1 - su)[:, None] * e1 + (v * su)[:, None] * e2
            d = pts - p
            r2 = (d * d).sum(1)
            dn = d / np.sqrt(r2)[:, None]
            cos_s = dn[:, 2]               # floor normal +z
            cos_l = np.abs(dn[:, 2])       # quad normal ±z, two-sided
            e += (np.where(cos_s > 0, cos_s * cos_l / r2, 0.0)).mean() \
                * tl[k, 12]
        want.append(L * e * INV_PI)
    got = mean_contrib[sel].mean(axis=1)
    # 200 one-sample frames: a few % MC noise
    np.testing.assert_allclose(got, np.asarray(want), rtol=0.10, atol=2e-3)


def test_renderer_end_to_end_tri_light():
    r = Renderer(_floor_and_quad_light(),
                 small_config(width=32, height=32, num_rays=1 << 12))
    cam = Camera()
    cam.position = np.array([0.0, -120.0, 45.0], np.float32)
    cam.vertical_angle = -0.3
    r.step(cam, 4)
    img = np.asarray(r.image())
    assert np.isfinite(img).all()
    assert img.max() > 0.05  # the quad lights the floor


def test_sphere_only_scenes_unchanged():
    """Scenes without LIGHT triangles take the original sphere-light
    code path bit for bit (n_tri_lights == 0)."""
    sd = Scene.load(None).to_device()
    assert sd.n_tri_lights == 0
    assert sd.tri_lights.shape == (1, 13)


def test_obj_ke_emissive_material(tmp_path):
    """MTL Ke makes the material's triangles LIGHT emitters: NEE targets
    + direct-hit emission, straight from the OBJ file."""
    import numpy as np
    from tyrant_tpu.scene.scene import Scene
    (tmp_path / "m.mtl").write_text(
        "newmtl lamp\nKd 1 1 1\nKe 4 3 2\n"
        "newmtl wall\nKd 0.8 0.8 0.8\nKe 0 0 0\n")
    (tmp_path / "q.obj").write_text(
        "mtllib m.mtl\n"
        "v -5 0 30\nv 5 0 30\nv 0 5 30\n"
        "v -50 -50 0\nv 50 -50 0\nv 0 50 0\n"
        "usemtl lamp\nf 1 2 3\nusemtl wall\nf 4 5 6\n")
    scene = Scene.load(str(tmp_path / "q.obj"), builder="numpy")
    assert scene.tri_refl is not None
    assert (scene.tri_refl == 4).sum() == 1  # LIGHT
    np.testing.assert_allclose(scene.tri_color[scene.tri_refl == 4][0],
                               [4, 3, 2])
    sd = scene.to_device()
    assert sd.n_tri_lights == 1
    lrow = np.asarray(sd.tri_lights)[0]
    np.testing.assert_allclose(lrow[9:12], [4, 3, 2], rtol=1e-6)
