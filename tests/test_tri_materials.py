"""Per-triangle materials (a parameterisation of the reference's unused
Triangle::materialType, SURVEY.md C7)."""

import jax.numpy as jnp
import numpy as np

from tyrant_tpu import sky as skymod
from tyrant_tpu.camera import Camera
from tyrant_tpu.config import small_config
from tyrant_tpu.render import _intersect_scene, _raygen, _shade
from tyrant_tpu.scene.scene import DIFF, SPEC, Scene

CFG = small_config(width=16, height=16, num_rays=1 << 10)
SUN = skymod.sun_direction_from_position(jnp.asarray([0.05, 0.3]))


def _quad(z=0.0, half=200.0):
    # floor facing +z (front for downward rays)
    v0 = np.array([[-half, -half, z], [half, half, z]], np.float32)
    v1 = np.array([[half, -half, z], [-half, half, z]], np.float32)
    v2 = np.array([[-half, half, z], [half, -half, z]], np.float32)
    # ensure e1 x e2 points +z for both
    n = np.cross(v1 - v0, v2 - v0)
    flip = n[:, 2] < 0
    v1[flip], v2[flip] = v2[flip].copy(), v1[flip].copy()
    return v0, v1, v2


def _run_shade(refl_type, color):
    v0, v1, v2 = _quad()
    t = v0.shape[0]
    sc = Scene.from_triangles(
        v0, v1, v2, builder="numpy",
        tri_refl=np.full(t, refl_type, np.int32),
        tri_color=np.tile(np.asarray(color, np.float32), (t, 1)))
    scene = sc.to_device()
    cam = Camera()
    cam.position = np.array([0.0, 0.0, 50.0], np.float32)
    cam.vertical_angle = -1.2  # look down at the floor
    camd = cam.to_device(CFG)
    gen = _raygen(CFG, camd, jnp.asarray(0), jnp.asarray(1, jnp.uint32),
                  CFG.height, 0)
    tt, ident, is_tri = _intersect_scene(gen["origin"], gen["direction"], scene)
    color_out, terminated, survive, next_rays, shadow = _shade(
        CFG, scene, skymod.SkyParams(CFG.sky), SUN, gen, tt, ident, is_tri,
        jnp.asarray(1, jnp.uint32))
    return (np.asarray(is_tri), np.asarray(next_rays["last_specular"]),
            np.asarray(next_rays["direct"]), np.asarray(gen["direction"]),
            np.asarray(next_rays["direction"]))


def test_spec_triangle_sets_last_specular_and_mirrors():
    is_tri, last_spec, direct, d_in, d_out = _run_shade(SPEC, (1.0, 1.0, 1.0))
    hits = is_tri
    assert hits.mean() > 0.5
    assert last_spec[hits].all()  # SPEC sets lastSpecular (kernel.cu:472)
    # mirror across z-plane: z component flips, xy preserved
    np.testing.assert_allclose(d_out[hits][:, 2], -d_in[hits][:, 2], atol=1e-5)
    np.testing.assert_allclose(d_out[hits][:, :2], d_in[hits][:, :2], atol=1e-5)


def test_diffuse_triangle_color_multiplies_throughput():
    is_tri, last_spec, direct, _, _ = _run_shade(DIFF, (0.25, 0.5, 1.0))
    hits = is_tri
    assert not last_spec[hits].any()
    # primary throughput 1 -> after albedo multiply (and possibly RR
    # division), ratio of channels must match the albedo ratio
    dsel = direct[hits]
    ratio_rg = dsel[:, 0] / np.maximum(dsel[:, 1], 1e-9)
    np.testing.assert_allclose(ratio_rg, 0.5, atol=1e-5)


def test_default_triangles_are_white_diffuse():
    v0, v1, v2 = _quad()
    sc = Scene.from_triangles(v0, v1, v2, builder="numpy")
    scene = sc.to_device()
    assert (np.asarray(scene.tri_refl)[:2] == DIFF).all()
    np.testing.assert_array_equal(np.asarray(scene.tri_color)[:2], 1.0)
