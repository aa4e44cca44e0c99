"""Texture images and the flat device atlas.

The reference has no texture support at all (every triangle shades as white
diffuse, kernel.cu:380-384); this is a beyond-reference production feature.
The design keeps the gathers per shaded ray few, so

  * all textures are packed into ONE flat texel buffer ``data [N+1, 4]``
    (rgb + pad) addressed by a single linear index — one gather per tap;
  * per-texture metadata (offset/height/width) lives in a tiny host-side
    table folded into the shade-time select chain (like sphere_table), never
    gathered;
  * bilinear filtering = 4 taps (4 gathers), nearest = 1 tap — selected by
    ``RenderConfig.texture_filter``.

8-bit images are decoded sRGB->linear (pow 2.2, the reference renderer's
implied working space is linear radiance); float inputs are taken as-is.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def load_texture(path: str, srgb: bool = True) -> np.ndarray:
    """Decode an image file to a float32 [H, W, 3] array.

    PNG/JPEG/BMP/... via PIL; .npy files (already-linear float arrays),
    .pfm (utils/pfm.py) and uncompressed .exr (utils/exr.py) HDR images
    are loaded directly.  Rows run top-to-bottom in file order; OBJ vt
    coordinates put v=0 at the BOTTOM, which :func:`TextureAtlas.sample`
    accounts for (v flip at sample time, not load time).

    ``srgb=True`` (albedo images) gamma-decodes 8-bit inputs to linear
    light; ``srgb=False`` keeps raw [0,1] values — required for DATA
    textures like tangent-space normal maps, whose channels encode vector
    components, not radiance.
    """
    if path.endswith(".npy"):
        arr = np.load(path)
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2)
        return np.ascontiguousarray(arr[:, :, :3])
    if path.endswith(".pfm"):
        # HDR input (already linear) — the natural envmap container
        from ..utils.pfm import read_pfm
        return read_pfm(path)
    if path.lower().endswith(".exr"):
        # HDR input (already linear); uncompressed scanline subset
        from ..utils.exr import read_exr
        return np.ascontiguousarray(read_exr(path)[:, :, :3])
    from PIL import Image
    img = Image.open(path).convert("RGB")
    arr = np.asarray(img, np.uint8).astype(np.float32) / 255.0
    if not srgb:
        return arr
    # sRGB -> linear (gamma 2.2 approximation; the tonemap resolve applies
    # the matching 1/2.2 on output, ops/tonemap.py)
    return arr ** 2.2


def downsample_2x(im: np.ndarray) -> np.ndarray:
    """One mip step: 2x2 box average (odd dimensions edge-clamp the last
    row/column so every level is ceil(prev/2))."""
    h, w, c = im.shape
    if h > 1 and h % 2:
        im = np.concatenate([im, im[-1:]], axis=0)
        h += 1
    if w > 1 and w % 2:
        im = np.concatenate([im, im[:, -1:]], axis=1)
        w += 1
    if h > 1:
        im = 0.5 * (im[0::2] + im[1::2])
    if w > 1:
        im = 0.5 * (im[:, 0::2] + im[:, 1::2])
    return np.asarray(im, np.float32)


@dataclasses.dataclass
class TextureAtlas:
    """All scene textures packed into one flat texel buffer.

    data  [N+1, 4] f32 — texel rgb + pad; row 0 is a white fallback so
          untextured/degenerate taps read neutral albedo
    meta  [K, 3] i64 — (offset, height, width) per texture, offsets into
          ``data`` starting at 1.  Integer dtype: offsets beyond 2^24
          would silently round in f32 and shift every tap of later
          textures; the device sampler folds these in as exact Python
          ints (compile-time constants).
    mip_meta  per-texture tuple of per-LEVEL (offset, height, width),
          level 0 first (== the ``meta`` row).  Mip levels are appended
          AFTER every base image, so enabling mips moves no base offset —
          nearest/bilinear programs and their goldens are bitwise
          unaffected.  () when packed without mips.
    """

    data: np.ndarray
    meta: np.ndarray
    mip_meta: tuple = ()

    @classmethod
    def pack(cls, images: list, mips: bool = False) -> "TextureAtlas":
        total = 1 + sum(int(im.shape[0] * im.shape[1]) for im in images)
        if total > (1 << 31) - 2:
            # the device tap index is i32
            raise ValueError(
                f"texture atlas of {total} texels exceeds the int32 "
                "addressing limit; reduce texture resolutions")
        data = np.ones((total, 4), np.float32)
        meta = np.zeros((max(len(images), 1), 3), np.int64)
        off = 1

        def put(im, off):
            h, w = im.shape[0], im.shape[1]
            flat = np.asarray(im[:, :, :3], np.float32).reshape(h * w, 3)
            data[off:off + h * w, :3] = flat
            if im.shape[2] >= 4:
                # texel lane 3 carries cutout alpha (MTL map_d); rows
                # default to 1.0 (opaque), incl. the row-0 fallback
                data[off:off + h * w, 3] = np.asarray(
                    im[:, :, 3], np.float32).reshape(h * w)
            return off + h * w

        for k, im in enumerate(images):
            meta[k] = (off, im.shape[0], im.shape[1])
            off = put(im, off)
        if not mips:
            return cls(data=data, meta=meta)
        # box-filtered pyramids, appended after every base image (base
        # offsets untouched); each level is the linear-light average of
        # the previous, down to 1x1
        chains = []
        tails = []
        for k, im in enumerate(images):
            levels = [(int(meta[k][0]), im.shape[0], im.shape[1])]
            cur = np.asarray(im, np.float32)
            while cur.shape[0] > 1 or cur.shape[1] > 1:
                cur = downsample_2x(cur)
                levels.append((None, cur.shape[0], cur.shape[1]))
                tails.append(cur)
            chains.append(levels)
        extra = sum(int(t.shape[0] * t.shape[1]) for t in tails)
        data = np.concatenate(
            [data, np.ones((extra, 4), np.float32)], axis=0)
        ti = 0
        mip_meta = []
        for k, levels in enumerate(chains):
            filled = [levels[0]]
            for (_, h, w) in levels[1:]:
                data_off = off
                off = put(tails[ti], off)
                ti += 1
                filled.append((data_off, h, w))
            mip_meta.append(tuple(filled))
        return cls(data=data, meta=meta, mip_meta=tuple(mip_meta))

    @property
    def count(self) -> int:
        return 0 if self.meta.shape[0] == 1 and self.meta[0, 2] == 0 \
            else self.meta.shape[0]


def sample_nearest_np(atlas: TextureAtlas, tex_id, u, v):
    """Numpy reference for the shade-time sampler (used by tests/oracle).

    OBJ convention: v=0 is the image bottom; data rows are stored
    top-to-bottom, hence the (h-1 - y) flip.  Wrap mode: repeat.
    """
    tex_id = np.asarray(tex_id)
    u = np.asarray(u) - np.floor(u)
    v = np.asarray(v) - np.floor(v)
    k = np.clip(tex_id, 0, atlas.meta.shape[0] - 1)
    off = atlas.meta[k, 0].astype(np.int64)
    h = atlas.meta[k, 1].astype(np.int64)
    w = atlas.meta[k, 2].astype(np.int64)
    x = np.minimum((u * w).astype(np.int64), np.maximum(w - 1, 0))
    y = np.minimum((v * h).astype(np.int64), np.maximum(h - 1, 0))
    idx = np.where(tex_id >= 0, off + (h - 1 - y) * w + x, 0)
    return atlas.data[idx, :3]


def sample_bilinear_at_np(atlas: TextureAtlas, tex_id, u, v, level):
    """Bilinear tap against one mip LEVEL per sample (numpy reference for
    the trilinear sampler's per-level taps).  ``level`` is an int array;
    clamped per texture to its chain length."""
    tex_id = np.asarray(tex_id)
    u = np.asarray(u, np.float64) - np.floor(u)
    v = np.asarray(v, np.float64) - np.floor(v)
    k = np.clip(tex_id, 0, len(atlas.mip_meta) - 1)
    nlev = np.asarray([len(c) for c in atlas.mip_meta])[k]
    level = np.minimum(np.asarray(level), nlev - 1)
    ohw = np.asarray([[c[min(j, len(c) - 1)] for j in range(
        max(len(cc) for cc in atlas.mip_meta))] for c in atlas.mip_meta])
    off = ohw[k, level, 0]
    h = ohw[k, level, 1]
    w = ohw[k, level, 2]
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]

    def tap(xi, yi):
        xi = np.mod(xi, np.maximum(w, 1))
        yi = np.mod(yi, np.maximum(h, 1))
        idx = off + (h - 1 - yi) * w + xi
        return atlas.data[np.where(tex_id >= 0, idx, 0), :3]

    c = (tap(x0, y0) * (1 - ax) * (1 - ay) + tap(x0 + 1, y0) * ax * (1 - ay)
         + tap(x0, y0 + 1) * (1 - ax) * ay + tap(x0 + 1, y0 + 1) * ax * ay)
    return c.astype(np.float32)


def sample_trilinear_np(atlas: TextureAtlas, tex_id, u, v, lod):
    """Numpy reference for the device trilinear sampler: two per-level
    bilinear taps blended by the fractional LOD (lod pre-clamped >= 0)."""
    lod = np.asarray(lod, np.float64)
    nlev = np.asarray([len(c) for c in atlas.mip_meta])[
        np.clip(np.asarray(tex_id), 0, len(atlas.mip_meta) - 1)]
    lod = np.clip(lod, 0.0, nlev - 1)
    l0 = lod.astype(np.int64)
    frac = (lod - l0)[..., None]
    c0 = sample_bilinear_at_np(atlas, tex_id, u, v, l0)
    c1 = sample_bilinear_at_np(atlas, tex_id, u, v, np.minimum(l0 + 1,
                                                               nlev - 1))
    return (c0 * (1 - frac) + c1 * frac).astype(np.float32)


def sample_bilinear_np(atlas: TextureAtlas, tex_id, u, v):
    """Numpy reference for bilinear taps (half-texel centred, repeat wrap)."""
    tex_id = np.asarray(tex_id)
    u = np.asarray(u, np.float64) - np.floor(u)
    v = np.asarray(v, np.float64) - np.floor(v)
    k = np.clip(tex_id, 0, atlas.meta.shape[0] - 1)
    off = atlas.meta[k, 0].astype(np.int64)
    h = atlas.meta[k, 1].astype(np.int64)
    w = atlas.meta[k, 2].astype(np.int64)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]

    def tap(xi, yi):
        xi = np.mod(xi, np.maximum(w, 1))
        yi = np.mod(yi, np.maximum(h, 1))
        idx = off + (h - 1 - yi) * w + xi
        return atlas.data[np.where(tex_id >= 0, idx, 0), :3]

    c = (tap(x0, y0) * (1 - ax) * (1 - ay) + tap(x0 + 1, y0) * ax * (1 - ay)
         + tap(x0, y0 + 1) * (1 - ax) * ay + tap(x0 + 1, y0 + 1) * ax * ay)
    return c.astype(np.float32)
