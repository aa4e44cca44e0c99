"""Texture/UV support (beyond-reference: the reference loads but never
reads texcoords/materials, loader.h:16, kernel.cu:380-384).

Covers: OBJ vt/mtllib parsing, atlas packing, the device sampler vs the
numpy reference, constant-texture == tri_color equivalence through the
full render step, and a spatial checkerboard assertion."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tyrant_tpu import sky as skymod
from tyrant_tpu.camera import Camera
from tyrant_tpu.config import RenderConfig, small_config
from tyrant_tpu.render import (Renderer, _intersect_scene, _raygen,
                               _sample_texture, _shade)
from tyrant_tpu.scene.obj import load_obj_scene
from tyrant_tpu.scene.scene import Scene
from tyrant_tpu.scene.texture import (TextureAtlas, sample_bilinear_np,
                                      sample_nearest_np)

SUN = skymod.sun_direction_from_position(jnp.asarray([0.05, 0.3]))


def _checker(n=8, scale=4):
    """[n*scale, n*scale, 3] checkerboard, white/black squares."""
    yy, xx = np.mgrid[0:n * scale, 0:n * scale]
    c = (((yy // scale) + (xx // scale)) % 2).astype(np.float32)
    return np.repeat(c[:, :, None], 3, axis=2)


def _textured_quad_scene(images, tri_tex=(0, 0), builder="numpy",
                         tri_color=None):
    # floor at z=0 facing +z, unit UV square over [-half, half]^2
    half = 200.0
    v0 = np.array([[-half, -half, 0], [half, half, 0]], np.float32)
    v1 = np.array([[half, -half, 0], [-half, half, 0]], np.float32)
    v2 = np.array([[-half, half, 0], [half, -half, 0]], np.float32)
    n = np.cross(v1 - v0, v2 - v0)
    flip = n[:, 2] < 0
    v1[flip], v2[flip] = v2[flip].copy(), v1[flip].copy()

    def uv_of(p):
        return (p[:, :2] + half) / (2 * half)

    uvs = np.stack([uv_of(v0), uv_of(v1), uv_of(v2)], axis=1)  # [2, 3, 2]
    return Scene.from_triangles(
        v0, v1, v2, builder=builder,
        tri_color=tri_color,
        tri_uv=uvs, tri_tex=np.asarray(tri_tex, np.int32),
        textures=list(images))


# --------------------------------------------------------------------------
# loaders
# --------------------------------------------------------------------------

def test_obj_vt_mtl_parsing(tmp_path):
    from PIL import Image
    img = (np.arange(16 * 16 * 3, dtype=np.uint8).reshape(16, 16, 3) % 255)
    Image.fromarray(img).save(tmp_path / "tex.png")
    (tmp_path / "m.mtl").write_text(
        "newmtl painted\nKd 0.5 0.25 1.0\nmap_Kd tex.png\n"
        "newmtl plain\nKd 0.1 0.2 0.3\n")
    (tmp_path / "quad.obj").write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl painted\nf 1/1 2/2 3/3\n"
        "usemtl plain\nf 1/1 3/3 4/4\n")
    m = load_obj_scene(str(tmp_path / "quad.obj"))
    assert m.faces.shape == (2, 3)
    assert m.uvs is not None and m.uvs.shape == (2, 3, 2)
    np.testing.assert_allclose(m.uvs[0], [[0, 0], [1, 0], [1, 1]])
    np.testing.assert_allclose(m.tri_color[0], [0.5, 0.25, 1.0])
    np.testing.assert_allclose(m.tri_color[1], [0.1, 0.2, 0.3])
    assert m.tri_tex.tolist() == [0, -1]
    assert len(m.textures) == 1 and m.textures[0].shape == (16, 16, 3)
    # Scene.load consumes the full record
    sc = Scene.load(str(tmp_path / "quad.obj"), builder="numpy")
    sd = sc.to_device()
    assert sd.has_textures and len(sd.tex_meta) == 1


def test_obj_without_mtl_still_loads(tmp_path):
    (tmp_path / "t.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    m = load_obj_scene(str(tmp_path / "t.obj"))
    assert m.faces.shape == (1, 3)
    assert m.textures is None and m.tri_tex is None


# --------------------------------------------------------------------------
# atlas + samplers
# --------------------------------------------------------------------------

def test_atlas_pack_layout():
    a = _checker(4, 2)      # 8x8
    b = np.full((2, 3, 3), 0.5, np.float32)
    atlas = TextureAtlas.pack([a, b])
    assert atlas.data.shape[0] == 1 + 64 + 6
    np.testing.assert_array_equal(atlas.meta[0], (1, 8, 8))
    np.testing.assert_array_equal(atlas.meta[1], (65, 2, 3))
    # row 0 is the white fallback
    np.testing.assert_array_equal(atlas.data[0, :3], 1.0)
    # nearest tap at the centre of texel (0, bottom row) of texture 1
    c = sample_nearest_np(atlas, np.array([1]), np.array([1 / 6]),
                          np.array([0.25]))
    np.testing.assert_allclose(c[0], 0.5)


def test_device_sampler_matches_numpy():
    rng = np.random.default_rng(7)
    imgs = [rng.random((13, 9, 3)).astype(np.float32),
            rng.random((6, 17, 3)).astype(np.float32)]
    atlas = TextureAtlas.pack(imgs)
    scene = _textured_quad_scene(imgs, tri_tex=(0, 1)).to_device()
    n = 512
    texid = rng.integers(-1, 2, n).astype(np.int32)
    u = (rng.random(n) * 4 - 2).astype(np.float32)
    v = (rng.random(n) * 4 - 2).astype(np.float32)
    for mode, ref_fn in (("nearest", sample_nearest_np),
                         ("bilinear", sample_bilinear_np)):
        got = np.asarray(jax.jit(
            lambda t, uu, vv: _sample_texture(scene, t, uu, vv, mode))(
                jnp.asarray(texid), jnp.asarray(u), jnp.asarray(v)))
        want = ref_fn(atlas, texid, u, v)
        want = np.where((texid >= 0)[:, None], want, got)  # untextured: any
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------
# shade integration
# --------------------------------------------------------------------------

CFG = small_config(width=16, height=16, num_rays=1 << 10)


def _shade_direct(scene):
    cam = Camera()
    cam.position = np.array([0.0, 0.0, 50.0], np.float32)
    cam.vertical_angle = -1.2
    camd = cam.to_device(CFG)
    gen = _raygen(CFG, camd, jnp.asarray(0), jnp.asarray(1, jnp.uint32),
                  CFG.height, 0)
    tt, ident, is_tri = _intersect_scene(gen["origin"],
                                         gen["direction"], scene)
    _c, _t, _s, next_rays, _sh = _shade(
        CFG, scene, skymod.SkyParams(CFG.sky), SUN, gen, tt, ident, is_tri,
        jnp.asarray(1, jnp.uint32))
    return np.asarray(is_tri), np.asarray(next_rays["direct"])


def test_constant_texture_equals_tri_color():
    """A constant-colour texture must shade exactly like the same tri_color
    (nearest filter: the tap returns the texel verbatim)."""
    col = np.asarray([0.25, 0.5, 1.0], np.float32)
    const = np.tile(col, (4, 4, 1)).astype(np.float32)
    sc_tex = _textured_quad_scene([const]).to_device()
    sc_col = _textured_quad_scene(
        [np.ones((4, 4, 3), np.float32)],
        tri_color=np.tile(col, (2, 1))).to_device()
    import dataclasses
    cfg_n = dataclasses.replace(
        small_config(width=16, height=16, num_rays=1 << 10),
        texture_filter="nearest")
    cam = Camera()
    cam.position = np.array([0.0, 0.0, 50.0], np.float32)
    cam.vertical_angle = -1.2
    camd = cam.to_device(cfg_n)
    gen = _raygen(cfg_n, camd, jnp.asarray(0), jnp.asarray(1, jnp.uint32),
                  cfg_n.height, 0)

    def run(scene):
        tt, ident, is_tri = _intersect_scene(gen["origin"],
                                             gen["direction"], scene)
        _c, _t, _s, nxt, _sh = _shade(
            cfg_n, scene, skymod.SkyParams(cfg_n.sky), SUN, gen, tt, ident,
            is_tri, jnp.asarray(1, jnp.uint32))
        return np.asarray(nxt["direct"])

    np.testing.assert_array_equal(run(sc_tex), run(sc_col))


def test_checkerboard_modulates_throughput():
    """Hits over white squares keep throughput; black squares zero it."""
    sc = _textured_quad_scene([_checker(8, 4)]).to_device()
    is_tri, direct = _shade_direct(sc)
    hits = is_tri
    assert hits.mean() > 0.5
    d = direct[hits].max(axis=1)
    frac_dark = (d < 0.05).mean()
    frac_lit = (d > 0.5).mean()
    # roughly half the board is black, half white
    assert 0.2 < frac_dark < 0.8
    assert 0.1 < frac_lit <= 0.8


def test_renderer_end_to_end_textured():
    """Full Renderer steps on a textured scene stay finite and accumulate."""
    sc = _textured_quad_scene([_checker(8, 4)])
    cfg = small_config(width=32, height=32, num_rays=1 << 12)
    r = Renderer(sc, cfg)
    cam = Camera()
    cam.position = np.array([0.0, 0.0, 50.0], np.float32)
    cam.vertical_angle = -1.2
    r.step(cam, 3)
    img = np.asarray(r.image())
    assert np.isfinite(img).all()
    assert img.max() > 0


def test_untextured_scene_has_dummy_leaves():
    """Untextured scenes carry tiny dummy texture leaves (no memory/step
    cost) and the shade branch is compile-time dead."""
    v0 = np.array([[0, 0, 0]], np.float32)
    v1 = np.array([[1, 0, 0]], np.float32)
    v2 = np.array([[0, 1, 0]], np.float32)
    sd = Scene.from_triangles(v0, v1, v2, builder="numpy").to_device()
    assert not sd.has_textures
    assert sd.tri_attr.shape == (4, 32)
    assert sd.tex_data.shape == (1, 4)
