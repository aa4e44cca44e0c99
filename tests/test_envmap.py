"""Environment-map lighting (beyond-reference: the reference's only
environment is the analytic sun/sky atmosphere, sunsky.cu)."""

import jax.numpy as jnp
import numpy as np

from tyrant_tpu import sky as skymod
from tyrant_tpu.camera import Camera
from tyrant_tpu.config import VERY_FAR, small_config
from tyrant_tpu.render import Renderer, _raygen, _sample_envmap, _shade
from tyrant_tpu.scene.scene import Scene

CFG = small_config(width=16, height=16, num_rays=1 << 10)
SUN = skymod.sun_direction_from_position(jnp.asarray([0.05, 0.3]))


def _env_scene(envmap):
    return Scene.load(None, envmap=np.asarray(envmap, np.float32))


def test_equirect_mapping():
    # top half red, bottom half blue; nearest filtering for exactness
    em = np.zeros((8, 16, 3), np.float32)
    em[:4, :, 0] = 1.0
    em[4:, :, 2] = 1.0
    scene = _env_scene(em).to_device()
    d = jnp.asarray(np.array([
        [0.0, 0.0, 1.0],    # zenith -> red
        [0.0, 0.0, -1.0],   # nadir -> blue
        [1.0, 0.0, 0.2],    # above equator -> red
        [1.0, 0.0, -0.2],   # below equator -> blue
    ], np.float32))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    c = np.asarray(_sample_envmap(scene, d, "nearest"))
    np.testing.assert_array_equal(c[0], [1, 0, 0])
    np.testing.assert_array_equal(c[1], [0, 0, 1])
    np.testing.assert_array_equal(c[2], [1, 0, 0])
    np.testing.assert_array_equal(c[3], [0, 0, 1])


def test_constant_envmap_is_constant_everywhere():
    em = np.full((6, 12, 3), 0.37, np.float32)
    scene = _env_scene(em).to_device()
    rng = np.random.default_rng(3)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for mode in ("nearest", "bilinear"):
        c = np.asarray(_sample_envmap(scene, jnp.asarray(d), mode))
        np.testing.assert_allclose(c, 0.37, rtol=1e-6)


def test_miss_radiance_is_env_sample():
    em = np.zeros((8, 16, 3), np.float32)
    em[:4] = (0.2, 0.9, 0.4)
    em[4:] = (0.8, 0.1, 0.6)
    scene = _env_scene(em).to_device()
    assert scene.has_envmap
    cam = Camera()
    camd = cam.to_device(CFG)
    gen = _raygen(CFG, camd, jnp.asarray(0), jnp.asarray(1, jnp.uint32),
                  CFG.height, 0)
    n = CFG.num_rays
    t = jnp.full((n,), VERY_FAR)         # force every ray to miss
    ident = jnp.full((n,), -1, jnp.int32)
    is_tri = jnp.zeros((n,), bool)
    color, term, _s, _n, _sh = _shade(
        CFG, scene, skymod.SkyParams(CFG.sky), SUN, gen, t, ident, is_tri,
        jnp.asarray(1, jnp.uint32))
    # primary throughput is 1, so the flushed colour IS the env radiance
    want = np.asarray(_sample_envmap(scene, gen["direction"],
                                     CFG.texture_filter))
    np.testing.assert_allclose(np.asarray(color), want, rtol=1e-6)
    assert np.asarray(term).all()


def test_envmap_disables_sun_nee():
    """With an envmap, every valid shadow ray targets an area light
    (finite max distance), never the sun (VERY_FAR)."""
    em = np.full((4, 8, 3), 0.5, np.float32)
    v0 = np.array([[-200, -200, 0], [200, 200, 0]], np.float32)
    v1 = np.array([[200, -200, 0], [-200, 200, 0]], np.float32)
    v2 = np.array([[-200, 200, 0], [200, -200, 0]], np.float32)
    nn = np.cross(v1 - v0, v2 - v0)
    flip = nn[:, 2] < 0
    v1[flip], v2[flip] = v2[flip].copy(), v1[flip].copy()
    sc = Scene.from_triangles(v0, v1, v2, builder="numpy",
                              envmap=em)
    scene = sc.to_device()
    from tyrant_tpu.render import _intersect_scene
    cam = Camera()
    cam.position = np.array([0.0, 0.0, 50.0], np.float32)
    cam.vertical_angle = -1.2
    camd = cam.to_device(CFG)
    gen = _raygen(CFG, camd, jnp.asarray(0), jnp.asarray(1, jnp.uint32),
                  CFG.height, 0)
    tt, ident, is_tri = _intersect_scene(gen["origin"],
                                         gen["direction"], scene)
    _c, _t, _s, _n, shadow = _shade(
        CFG, scene, skymod.SkyParams(CFG.sky), SUN, gen, tt, ident, is_tri,
        jnp.asarray(1, jnp.uint32))
    valid = np.asarray(shadow["valid"])
    assert valid.any()
    maxd = np.asarray(shadow["max_dist"])[valid]
    assert (maxd < VERY_FAR).all()


def test_renderer_end_to_end_envmap():
    em = np.full((8, 16, 3), 0.3, np.float32)
    r = Renderer(_env_scene(em), small_config(width=32, height=32,
                                              num_rays=1 << 12))
    cam = Camera()
    r.step(cam, 3)
    img = np.asarray(r.image())
    assert np.isfinite(img).all()
    assert img.max() > 0
