"""Mip pyramid layout + trilinear sampler: the pyramid bookkeeping and
the trilinear sampler itself."""

import numpy as np
import pytest

import jax.numpy as jnp

from tyrant_tpu.scene.texture import (TextureAtlas, downsample_2x,
                                      sample_bilinear_np,
                                      sample_trilinear_np)


def _ramp(h, w, seed=0):
    r = np.random.RandomState(seed)
    return r.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)


# ------------------------------------------------------------- layout pins

def test_downsample_2x_odd_dimension_clamps():
    im = np.arange(3 * 5 * 3, dtype=np.float32).reshape(3, 5, 3)
    d = downsample_2x(im)
    assert d.shape == (2, 3, 3)
    # the padded row/column duplicates the last row/column (edge clamp):
    # bottom-right output = mean of the 2x2 block built from [row2, row2]
    # x [col4, col4] = exactly im[2, 4]
    np.testing.assert_allclose(d[1, 2], im[2, 4])
    # interior block is the plain 2x2 box average
    np.testing.assert_allclose(d[0, 0], im[0:2, 0:2].reshape(4, 3).mean(0))


def test_mip_pack_layout():
    ims = [_ramp(8, 8, 1), _ramp(5, 7, 2)]
    base = TextureAtlas.pack(ims, mips=False)
    at = TextureAtlas.pack(ims, mips=True)

    # base offsets and texels are untouched by enabling mips (goldens for
    # nearest/bilinear programs stay bitwise)
    np.testing.assert_array_equal(at.meta, base.meta)
    np.testing.assert_array_equal(at.data[:base.data.shape[0]], base.data)

    assert len(at.mip_meta) == 2
    # per-texture chain: level 0 == the meta row; dims halve (ceil) down
    # to a 1x1 terminal level
    for k, chain in enumerate(at.mip_meta):
        o0, h0, w0 = chain[0]
        assert (o0, h0, w0) == tuple(at.meta[k])
        h, w = h0, w0
        for (oj, hj, wj) in chain[1:]:
            h, w = max((h + 1) // 2, 1), max((w + 1) // 2, 1)
            assert (hj, wj) == (h, w)
        assert chain[-1][1:] == (1, 1)
    # 8x8 -> 4 levels (8,4,2,1); 5x7 -> ceil chain (5,7)(3,4)(2,2)(1,1)
    assert len(at.mip_meta[0]) == 4
    assert [c[1:] for c in at.mip_meta[1]] == [(5, 7), (3, 4), (2, 2),
                                               (1, 1)]
    # pyramid levels are appended contiguously after every base image and
    # never overlap: walk all (offset, size) spans
    spans = sorted((int(o), int(o) + int(h) * int(w))
                   for chain in at.mip_meta for (o, h, w) in chain)
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        assert a1 <= b0
    assert spans[-1][1] == at.data.shape[0]
    # level-1 texels are the box average of level 0
    o1, h1, w1 = at.mip_meta[0][1]
    lvl1 = at.data[o1:o1 + h1 * w1, :3].reshape(h1, w1, 3)
    np.testing.assert_allclose(lvl1, downsample_2x(ims[0]), rtol=1e-6)
    # terminal 1x1 level is the global mean (box filter telescopes)
    oT = at.mip_meta[0][-1][0]
    np.testing.assert_allclose(at.data[oT, :3], ims[0].reshape(-1, 3).mean(0),
                               rtol=1e-5)


# ------------------------------------------------- device trilinear sampler

def _fake_scene(at: TextureAtlas):
    import types
    meta = tuple((int(o), int(h), int(w), 0, 0,
                  tuple((int(a), int(b), int(c)) for (a, b, c) in chain))
                 for (o, h, w), chain in zip(at.meta, at.mip_meta))
    return types.SimpleNamespace(tex_meta=meta,
                                 tex_data=jnp.asarray(at.data))


def test_trilinear_matches_numpy_oracle():
    from tyrant_tpu.render import _sample_texture
    ims = [_ramp(16, 16, 3), _ramp(8, 4, 4)]
    at = TextureAtlas.pack(ims, mips=True)
    sc = _fake_scene(at)
    r = np.random.RandomState(5)
    n = 256
    texid = r.randint(0, 2, n).astype(np.int32)
    u = r.uniform(-0.2, 1.2, n).astype(np.float32)
    v = r.uniform(-0.2, 1.2, n).astype(np.float32)
    # uv-space footprints spanning lod 0 .. past the last level
    fpu = (2.0 ** r.uniform(-6, 3, n) / 16).astype(np.float32)
    fpv = (2.0 ** r.uniform(-6, 3, n) / 16).astype(np.float32)

    got = np.asarray(_sample_texture(
        sc, jnp.asarray(texid), jnp.asarray(u), jnp.asarray(v),
        "trilinear", uv_fp=(jnp.asarray(fpu), jnp.asarray(fpv))))

    # expected lod: per-texture texel density (the sampler's own rule)
    w = np.asarray([at.meta[k][2] for k in texid])
    h = np.asarray([at.meta[k][1] for k in texid])
    lod = np.log2(np.maximum(np.maximum(fpu * w, fpv * h), 1.0))
    want = sample_trilinear_np(at, texid, u, v, lod)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_trilinear_zero_footprint_is_bilinear():
    from tyrant_tpu.render import _sample_texture
    ims = [_ramp(16, 16, 7)]
    at = TextureAtlas.pack(ims, mips=True)
    sc = _fake_scene(at)
    r = np.random.RandomState(9)
    n = 128
    texid = np.zeros(n, np.int32)
    u = r.uniform(0, 1, n).astype(np.float32)
    v = r.uniform(0, 1, n).astype(np.float32)
    z = jnp.zeros(n, jnp.float32)
    tri = np.asarray(_sample_texture(sc, jnp.asarray(texid), jnp.asarray(u),
                                     jnp.asarray(v), "trilinear",
                                     uv_fp=(z, z)))
    bil = sample_bilinear_np(at, texid, u, v)
    np.testing.assert_allclose(tri, bil, rtol=2e-6, atol=1e-7)


def test_trilinear_distance_lod_smooths():
    """Far hits read coarser levels: with a checkerboard texture the
    level-0 tap has full contrast while a deep-lod tap converges to the
    0.5 mean."""
    from tyrant_tpu.render import _sample_texture
    cb = np.indices((16, 16)).sum(0) % 2
    im = np.repeat(cb[:, :, None], 3, 2).astype(np.float32)
    at = TextureAtlas.pack([im], mips=True)
    sc = _fake_scene(at)
    n = 64
    u = jnp.linspace(0.01, 0.99, n)
    v = jnp.full((n,), 7.5 / 16.0)  # texel-centre row: no cross-row blend
    tex = jnp.zeros((n,), jnp.int32)
    near = np.asarray(_sample_texture(
        sc, tex, u, v, "trilinear",
        uv_fp=(jnp.zeros(n), jnp.zeros(n))))
    far = np.asarray(_sample_texture(
        sc, tex, u, v, "trilinear",
        uv_fp=(jnp.full((n,), 2.0), jnp.full((n,), 2.0))))
    assert near[:, 0].std() > 0.25           # strong checker contrast
    np.testing.assert_allclose(far[:, 0], 0.5, atol=1e-3)  # 1x1 mean


def test_render_step_trilinear_runs():
    """End-to-end static gate: a textured scene renders under
    texture_filter='trilinear' (finite image, close-range ~ bilinear)."""
    import dataclasses
    from tyrant_tpu.camera import Camera
    from tyrant_tpu.config import small_config
    from tyrant_tpu.render import Renderer
    from tyrant_tpu.scene.scene import Scene

    im = _ramp(8, 8, 11)
    v0 = np.array([[-5, 2, -1], [-5, 2, -1]], np.float32)
    v1 = np.array([[5, 2, -1], [5, 12, -1]], np.float32)
    v2 = np.array([[-5, 12, -1], [-5, 12, -1]], np.float32)
    sc = Scene.from_triangles(v0, v1, v2)
    sc.textures = [im]
    sc.tri_tex = np.array([0, 0], np.int32)
    sc.tri_uv = np.asarray([[[0, 0], [1, 0], [0, 1]],
                            [[0, 0], [1, 1], [0, 1]]], np.float32)
    cfg = dataclasses.replace(small_config(width=24, height=24,
                                           num_rays=1 << 9),
                              texture_filter="trilinear")
    r = Renderer(sc, cfg, donate=False)
    cam = Camera()
    cam.position = np.array([0.0, -3.0, 1.0], np.float32)
    r.step(cam, 2)
    img = np.asarray(r.image())
    assert np.isfinite(img).all()
    assert img.max() > 0
