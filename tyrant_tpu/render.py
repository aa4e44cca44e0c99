"""The wavefront render pipeline (pure jnp, one bounce per step).

The JAX equivalent of the reference's six-kernel wavefront
(kernel.cu:227-662) and frame orchestrator (kernel.cu:664-748).  The
reference's persistent threads claiming work via global atomic counters
(kernel.cu:211-224) become dense fixed-shape SoA ray batches: one
:func:`render_step` call performs raygen top-off, extend (scene
intersection), shade (all five BSDFs + NEE), connect (shadow occlusion),
scatter-add accumulation, and survivor compaction.  Surviving
path segments are carried to the next step exactly like the reference's
cross-frame continuation (kernel.cu:607-608, 227-244).

Pipeline map (reference -> here):
  primary_rays (kernel.cu:247-297)        -> _raygen
  set_wavefront_globals (kernel.cu:227)   -> start_position arithmetic
  extend (kernel.cu:331-343)              -> _intersect_scene
  shade (kernel.cu:347-627)               -> _shade
  connect (kernel.cu:630-646)             -> _connect
  blit accumulation (kernel.cu:622-625)   -> one .at[pixel].add scatter
  queue double-buffer swap (main.cpp:169) -> survivor compaction (sort)

Extend and connect traverse the BVH with the CUDA kernels of ops/cuda on
NVIDIA GPUs and with the XLA cascade of ops/traverse.py elsewhere
(ops.traverse.traversal_for).
"""

from __future__ import annotations

import dataclasses
import math
import types
from functools import partial

import jax
import jax.numpy as jnp

from . import sky as skymod
from .adaptive import identity_perm
from .camera import CameraParams
from .config import EPSILON, INV_PI, PI, VERY_FAR, RenderConfig
from .ops import cuda as cuda_traverse
from .ops import rng
from .ops.intersect import intersect_spheres, ray_sphere
from .ops.sampling import (concentric_sample_disk, cone_sample,
                           cone_sample_from_uniforms,
                           cosine_hemisphere_from_uniforms,
                           cosine_hemisphere_sample, dot, ggx_d_vec, ggx_g1,
                           ggx_vndf_sample_from_uniforms, hg_phase,
                           hg_sample_from_uniforms, normalize,
                           phong_lobe_sample, reflect,
                           sphere_surface_from_uniforms,
                           sphere_surface_sample,
                           triangle_sample_from_uniforms)
from .ops.traverse import any_hit, closest_hit, traversal_for
from .scene.envlight import LUM_RGB
from .scene.scene import (DIFF, GGX, LIGHT, PHONG, REFR, RREFR, SPEC,
                          SceneData)

PHONG_EXPONENT = 40.0  # kernel.cu:520

# shade-only pseudo-materials (beyond-reference; never stored in scene
# tables — see _shade): FOG = volumetric-fog medium event, PASS =
# alpha-cutout pass-through (MTL map_d, sub-threshold texel alpha)
FOG = 6
PASS = 7


def _fog_overlap(origin, direction, t_limit, z_min: float, z_max: float):
    """Parametric overlap of rays with the fog slab z in [z_min, z_max],
    clipped to [0, t_limit].  Returns (t_enter, length); length is 0 for
    rays that never cross the slab.  Two plane tests + selects — the slab
    is convex, so every ray crosses it at most once."""
    oz, dz = origin[:, 2], direction[:, 2]
    tiny = 1e-12
    safe_dz = jnp.where(jnp.abs(dz) < tiny, tiny, dz)
    t0 = (z_min - oz) / safe_dz
    t1 = (z_max - oz) / safe_dz
    ta = jnp.minimum(t0, t1)
    tb = jnp.maximum(t0, t1)
    parallel = jnp.abs(dz) < tiny
    inside = (oz >= z_min) & (oz <= z_max)
    ta = jnp.where(parallel, jnp.where(inside, 0.0, VERY_FAR), ta)
    tb = jnp.where(parallel, jnp.where(inside, VERY_FAR, 0.0), tb)
    ta = jnp.maximum(ta, 0.0)
    tb = jnp.minimum(tb, t_limit)
    return ta, jnp.maximum(tb - ta, 0.0)


def _fog_density_coeffs(origin, direction, t_start, falloff: float):
    """Per-ray coefficients of the exponential-height fog density along a
    segment starting at parameter ``t_start``: with world altitude
    z(s) = z_start + dz*s, density(s) = rho0 * exp(-k s) where
    rho0 = exp(-falloff * z_start) and k = falloff * dz.  The exponent is
    clamped to +-60 (exp(60) ~ 1e26 stays finite in f32), which bounds the
    estimator's validity range: RenderConfig.__post_init__ rejects fog
    configs whose dense slab end exceeds the clamp, so inside accepted
    configs the closed form is exact."""
    z_start = origin[:, 2] + direction[:, 2] * t_start
    rho0 = jnp.exp(jnp.clip(-falloff * z_start, -60.0, 60.0))
    return rho0, falloff * direction[:, 2]


def _fog_optical_depth(sigma_t, rho0, k, s):
    """Closed-form optical depth of the exponential-height medium over a
    segment of length ``s``:  sigma_t * rho0 * (1 - exp(-k s)) / k,
    with the k -> 0 limit sigma_t * rho0 * s."""
    tiny = jnp.abs(k) < 1e-12
    k_safe = jnp.where(tiny, 1.0, k)
    ratio = jnp.where(tiny, s, -jnp.expm1(-k_safe * s) / k_safe)
    return sigma_t * rho0 * ratio


def _fog_free_flight(u, sigma_t, rho0, k):
    """Inverse free-flight CDF of the exponential-height medium: the
    collision distance s whose optical depth equals -log(1-u).  Closed
    form: exp(-k s) = 1 - e*k/(sigma_t*rho0); when that bound is <= 0
    (ray climbing out of the fog faster than the target depth accrues)
    there is no collision at any distance -> VERY_FAR.  Sampling the TRUE
    heterogeneous free-flight distribution keeps the event/no-event
    conditioning exactly transmittance-cancelling, the same unbiased
    structure as the homogeneous slab."""
    e = -jnp.log1p(-jnp.minimum(u, 1.0 - 1e-7))
    tiny = jnp.abs(k) < 1e-12
    k_safe = jnp.where(tiny, 1.0, k)
    g = e * k_safe / (sigma_t * rho0)
    s_het = -jnp.log1p(-jnp.minimum(g, 1.0 - 1e-12)) / k_safe
    s = jnp.where(tiny, e / (sigma_t * rho0), s_het)
    return jnp.where(~tiny & (g >= 1.0), VERY_FAR, s)


def _ggx_eval(normal, view, light_dir, alpha, f0):
    """Single-scatter GGX BRDF value f(v, l), [n, 3] (beyond-reference).

    ``view`` and ``light_dir`` point away from the surface; ``f0`` is the
    conductor reflectance at normal incidence (the surface colour).
    Separable Smith G2 = G1(v) * G1(l), Schlick Fresnel."""
    h = normalize(view + light_dir)
    nv = dot(normal, view)
    nl = dot(normal, light_dir)
    hv = jnp.maximum(dot(h, view), 0.0)
    d_term = ggx_d_vec(normal, h, alpha)
    g_term = ggx_g1(nv, alpha) * ggx_g1(nl, alpha)
    fres = f0 + (1.0 - f0) * jnp.power(1.0 - hv, 5.0)[:, None]
    denom = jnp.maximum(
        4.0 * jnp.maximum(nv, 0.0) * jnp.maximum(nl, 0.0), 1e-8)
    return fres * (d_term * g_term / denom)[:, None]

# survivor-ordering spatial grid resolution (see render_step compaction)
_KEY_GRID = 8


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class RenderState:
    """Explicit render state pytree (SURVEY.md §5 checkpoint/resume: the
    reference's implicit cross-frame state — blit_buffer, carried ray queue,
    frame counter — made serialisable)."""

    accum: jnp.ndarray        # [P, 4] rgb = radiance sum, a = completed paths
    origin: jnp.ndarray       # [N, 3]
    direction: jnp.ndarray    # [N, 3]
    direct: jnp.ndarray       # [N, 3] path throughput ("direct" in RayQueue)
    # [N, 3] radiance this path has already earned (NEE/emission) but not
    # yet flushed to accum; flushed in one pixel-sorted pass at termination.
    # The reference scatters these immediately via atomicAdd
    # (kernel.cu:622-625); deferring them makes the framebuffer write a
    # sorted dense accumulation instead of a random scatter.
    pending: jnp.ndarray
    pixel: jnp.ndarray        # [N] i32 local linear pixel index
    bounces: jnp.ndarray      # [N] i32
    last_specular: jnp.ndarray  # [N] bool
    n_carried: jnp.ndarray    # scalar i32 — reference primary_ray_cnt
    start_position: jnp.ndarray  # scalar i32 — reference start_position
    frame: jnp.ndarray        # scalar u32
    # monotonic count of valid NEE shadow rays traced (scalar u32, wraps);
    # the bench diffs it across the timed window instead of extrapolating
    # from a primary-wavefront probe (reference: shadow queue fill,
    # kernel.cu:416-446)
    shadow_rays: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.asarray(0, jnp.uint32))
    # adaptive sampling (cfg.adaptive_sampling="on"; adaptive.py): per-pixel
    # per-channel SQUARED radiance sums [P, 4] and the raygen visit
    # permutation [P].  Tiny dummies ([1,4] / [1]) when the feature is off —
    # zero step cost, uniform pytree structure.
    moment2: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.zeros((1, 4), jnp.float32))
    pixel_perm: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.zeros((1,), jnp.int32))
    # MIS (cfg.mis="on"): solid-angle pdf of the BSDF sample that produced
    # each carried ray, consumed by the balance heuristic when the ray hits
    # an emitter / the sun disc.  [1]-dummy when the feature is off.
    bsdf_pdf: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.ones((1,), jnp.float32))
    # Sobol sampling (cfg.sampler="sobol", ops/sobol.py): number of full
    # round-robin passes the raygen counter has completed (per-pixel sample
    # index = sample_base + scan wrap count — derived arithmetically, zero
    # gathers), plus each carried ray's own sample index for the bounce
    # dimensions.  [1]-dummy when the sampler is "xorshift".
    sample_base: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.uint32))
    sample_idx: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.zeros((1,), jnp.uint32))

    def tree_flatten(self):
        return ((self.accum, self.origin, self.direction, self.direct,
                 self.pending, self.pixel, self.bounces, self.last_specular,
                 self.n_carried, self.start_position, self.frame,
                 self.shadow_rays, self.moment2, self.pixel_perm,
                 self.bsdf_pdf, self.sample_base, self.sample_idx), None)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)


def init_state(cfg: RenderConfig, local_height: int | None = None) -> RenderState:
    h = cfg.height if local_height is None else local_height
    n, p = cfg.num_rays, cfg.width * h
    return RenderState(
        accum=jnp.zeros((p, 4), jnp.float32),
        origin=jnp.zeros((n, 3), jnp.float32),
        direction=jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32), (n, 1)),
        direct=jnp.zeros((n, 3), jnp.float32),
        pending=jnp.zeros((n, 3), jnp.float32),
        pixel=jnp.zeros((n,), jnp.int32),
        bounces=jnp.zeros((n,), jnp.int32),
        last_specular=jnp.zeros((n,), bool),
        n_carried=jnp.asarray(0, jnp.int32),
        start_position=jnp.asarray(0, jnp.int32),
        frame=jnp.asarray(1, jnp.uint32),  # kernel.cu:667 (never 0: RNG seed)
        shadow_rays=jnp.asarray(0, jnp.uint32),
        moment2=jnp.zeros((p if (cfg.adaptive_sampling == "on"
                               or cfg.track_variance == "on") else 1, 4),
                          jnp.float32),
        pixel_perm=(identity_perm(p) if cfg.adaptive_sampling == "on"
                    else jnp.zeros((1,), jnp.int32)),
        bsdf_pdf=jnp.ones((n if cfg.mis == "on" else 1,), jnp.float32),
        sample_base=jnp.zeros((), jnp.uint32),
        sample_idx=jnp.zeros((n if cfg.sampler == "sobol" else 1,),
                             jnp.uint32),
    )


def reset_accumulation(state: RenderState) -> RenderState:
    """Camera/sun moved: zero the accumulation buffer and drop carried rays
    (kernel.cu:712-718)."""
    return dataclasses.replace(
        state,
        accum=jnp.zeros_like(state.accum),
        moment2=jnp.zeros_like(state.moment2),
        # adaptive perm (if any) back to identity — the old pose's
        # priorities are meaningless for the new view
        pixel_perm=(identity_perm(state.pixel_perm.shape[0])
                    if state.pixel_perm.shape[0] > 1 else state.pixel_perm),
        # sobol: restart every pixel's sample sequence for the new pose
        sample_base=jnp.zeros_like(state.sample_base),
        n_carried=jnp.asarray(0, jnp.int32))


# --------------------------------------------------------------------------
# raygen — kernel.cu:247-297
# --------------------------------------------------------------------------

def _primary_dirs(cfg: RenderConfig, camera: CameraParams, ni, nj):
    """Image-plane coords -> primary directions for ``cfg.projection``.

    ``ni`` in [-0.5, 0.5) runs left->right, ``nj`` bottom->top (the
    reference's normalized coords, kernel.cu:271-274).  Returns
    ``(dir [n,3], origin_offset [n,3] | None, live [n] bool | None)``:
    ``origin_offset`` shifts the ray start off the pinhole (orthographic),
    ``live`` marks rays inside the image footprint (fisheye circle —
    outside rays render black, the conventional fisheye frame).

    "perspective" reproduces the reference basis exactly (kernel.cu:
    699-700 scale is baked into camera.right/up); the other modes are
    beyond-reference production projections and use the unit basis.

    Camera fields may be [3] (one pose) or [n, 3] (per-ray poses — the
    motion-blur shutter interpolation feeds a basis per ray).
    """
    def _b(v):  # [3] -> [1,3]; [n,3] unchanged
        return v if v.ndim == 2 else v[None]

    cdir, cright, cup = _b(camera.direction), _b(camera.right), _b(camera.up)
    if cfg.projection == "perspective":
        d = normalize(cdir + ni[:, None] * cright + nj[:, None] * cup)
        return d, None, None
    # camera.right/up carry the perspective 1.5*aspect scale — reduce to
    # the orthonormal frame (fwd, ru, uu)
    ru = normalize(cright)
    uu = normalize(cup)
    fwd = cdir
    aspect = cfg.width / cfg.height
    if cfg.projection == "fisheye":
        # equidistant fisheye: angle from the view axis is linear in the
        # image-circle radius; the circle is inscribed in the image height
        u = 2.0 * ni * aspect
        v = 2.0 * nj
        r = jnp.sqrt(u * u + v * v)
        half_fov = 0.5 * cfg.fisheye_fov_degrees * (PI / 180.0)
        theta = r * half_fov
        phi = jnp.arctan2(v, jnp.where(r > 0.0, u, 1.0))
        st, ct = jnp.sin(theta), jnp.cos(theta)
        d = (ct[:, None] * fwd
             + (st * jnp.cos(phi))[:, None] * ru
             + (st * jnp.sin(phi))[:, None] * uu)
        return normalize(d), None, r <= 1.0
    if cfg.projection == "equirect":
        # 360x180 lat-long panorama centred on the view direction
        lon = (2.0 * PI) * ni
        lat = PI * nj
        cl = jnp.cos(lat)
        d = ((cl * jnp.cos(lon))[:, None] * fwd
             + (cl * jnp.sin(lon))[:, None] * ru
             + jnp.sin(lat)[:, None] * uu)
        return normalize(d), None, None
    # "ortho": parallel rays along the view axis from a shifted origin
    off = ((ni * (cfg.ortho_height * aspect))[:, None] * ru
           + (nj * cfg.ortho_height)[:, None] * uu)
    d = jnp.broadcast_to(fwd, (off.shape[0], 3)) if fwd.shape[0] == 1 \
        else normalize(fwd)
    return d, off, None


def _scan_total(cfg: RenderConfig, local_height: int) -> int:
    """Pixels one round-robin raygen pass covers: the crop-window area
    when cfg.crop is set, else the (strip-local) full frame."""
    if cfg.crop is not None:
        return int(cfg.crop[2]) * int(cfg.crop[3])
    return cfg.width * local_height


def _raygen(cfg: RenderConfig, camera: CameraParams, start_position, frame,
            local_height: int, row_offset, perm=None, sample_base=None,
            cam_prev=None):
    n = cfg.num_rays
    w, h_global = cfg.width, cfg.height
    total_local = _scan_total(cfg, local_height)

    gen_index = jnp.arange(n, dtype=jnp.int32)
    # Fresh rays occupy the FRONT slots [0, generated); carried survivors
    # live at the tail, so gen_index IS the fresh-ray counter (reference:
    # x/y from start_position + index over primary rays, kernel.cu:263).
    # Tail slots compute a dummy pixel discarded by the merge.
    scan = (start_position + gen_index) % total_local
    # Pixel-visit order: the reference scans rows linearly (kernel.cu:263).
    # With 8x8-tile ordering consecutive rays share a screen tile, so
    # neighbouring threads traverse similar paths.  Any bijection
    # preserves the progressive-accumulation estimator.
    if cfg.crop is not None:
        # crop window (beyond-reference): the round-robin scan covers
        # only the (x0, y0, cw, ch) rectangle; 8x8 tiling inside it when
        # it divides evenly (same coherence rationale as below)
        cx0, cy0, cw, ch = (int(v) for v in cfg.crop)
        if cfg.raygen_order == "tiled8" and cw % 8 == 0 and ch % 8 == 0:
            tiles_x = cw // 8
            tile = scan // 64
            within = scan % 64
            cx = (tile % tiles_x) * 8 + within % 8
            cy = (tile // tiles_x) * 8 + within // 8
        else:
            cx = scan % cw
            cy = scan // cw
        x_i = cx0 + cx
        y_i = cy0 + cy
        pixel = y_i * w + x_i
    elif perm is not None:
        # adaptive sampling (adaptive.py): the priority permutation defines
        # the visit order outright (with repetition — the per-pixel mean
        # estimator is schedule-independent); equal-priority pixels are
        # raster-ordered inside the perm for coherence
        pixel = perm[scan]
        x_i = pixel % w
        y_i = pixel // w
    elif cfg.raygen_order == "tiled8" and w % 8 == 0 and local_height % 8 == 0:
        tiles_x = w // 8
        tile = scan // 64
        within = scan % 64
        x_i = (tile % tiles_x) * 8 + within % 8
        y_i = (tile // tiles_x) * 8 + within // 8
        pixel = y_i * w + x_i
    else:
        pixel = scan
        x_i = pixel % w
        y_i = pixel // w
    x = x_i.astype(jnp.float32)
    y = (y_i + row_offset).astype(jnp.float32)

    sample_idx = None
    if cfg.sampler == "sobol":
        # per-pixel sample index, arithmetically: the round-robin scan
        # visits every pixel once per pass, so pixel p's k-th path is the
        # one generated on wrap k of the counter (any visit-order bijection
        # — raster or tiled8 — preserves this)
        sample_idx = (sample_base
                      + ((start_position + gen_index)
                         // total_local).astype(jnp.uint32))
        from .ops import sobol
        ju, jv = sobol.sample_2d(
            sample_idx, rng.seed_from(pixel, row_offset,
                                      *((cfg.seed,) if cfg.seed else ()),
                                      0x50B01))
        px = x - ju
        py = y - jv
    else:
        # row_offset enters the seed so every shard of the multi-chip path
        # draws an independent stream (identical seeds would correlate
        # jitter/lens/NEE noise across image strips)
        seed = rng.seed_from(frame, gen_index, row_offset, 0x5EED)
        seed, uv = rng.random_2d_stratified(seed)
        # NB the reference subtracts the jitter (kernel.cu:268-269)
        px = x - uv[..., 0]
        py = y - uv[..., 1]
    ni = px / w - 0.5
    nj = (h_global - py) / h_global - 0.5

    cam_i = camera
    if cfg.motion_blur > 0.0 and cam_prev is not None:
        # Motion blur (beyond-reference): each ray samples a shutter time
        # and sees the camera pose lerped between the PREVIOUS distinct
        # pose and the current one — s in (1-shutter, 1], so shutter=1
        # sweeps the whole inter-frame motion and shutter->0 degenerates
        # to the static camera.  A SIDE RNG stream keeps every other
        # sampling stream bit-identical to the unblurred render.
        _, ut = rng.random_float(
            rng.seed_from(frame, gen_index, row_offset, 0x7131))
        s = (1.0 - cfg.motion_blur * ut)[:, None]

        def _lerp(cur, prev):
            return prev[None] + s * (cur - prev)[None]

        cam_i = types.SimpleNamespace(
            position=_lerp(camera.position, cam_prev.position),
            direction=normalize(_lerp(camera.direction,
                                      cam_prev.direction)),
            right=_lerp(camera.right, cam_prev.right),
            up=_lerp(camera.up, cam_prev.up),
            focal_distance=camera.focal_distance,
            lens_radius=camera.lens_radius)

    def _b(v):  # [3] -> [1,3]; [n,3] unchanged
        return v if v.ndim == 2 else v[None]

    dir_fp, o_off, live = _primary_dirs(cfg, cam_i, ni, nj)
    base = _b(cam_i.position) if o_off is None \
        else _b(cam_i.position) + o_off
    # DoF (kernel.cu:283-293), incl. the x3 slider scale (kernel.cu:286)
    conv = base + (cam_i.focal_distance
                   * cfg.focal_distance_scale) * dir_fp
    if cfg.sampler == "sobol":
        from .ops import sobol
        l0, l1 = sobol.sample_2d(
            sample_idx, rng.seed_from(pixel, row_offset,
                                      *((cfg.seed,) if cfg.seed else ()),
                                      0x50B02))
    else:
        seed, l0 = rng.random_float(seed)
        seed, l1 = rng.random_float(seed)
    if cfg.bokeh_blades:
        # polygonal aperture (beyond-reference): out-of-focus highlights
        # take the iris shape.  Static gate — blades=0 keeps the
        # reference's concentric disk and the identical program.
        from .ops.sampling import polygon_sample_disk
        p_lens = cam_i.lens_radius * polygon_sample_disk(
            jnp.stack([l0, l1], axis=-1), cfg.bokeh_blades,
            math.radians(cfg.bokeh_rotation))
    else:
        p_lens = cam_i.lens_radius * concentric_sample_disk(
            jnp.stack([l0, l1], axis=-1))
    origin = base \
        + p_lens[:, 0:1] * _b(cam_i.right) \
        + p_lens[:, 1:2] * _b(cam_i.up)
    direction = normalize(conv - origin)
    direct0 = jnp.ones((n, 3), jnp.float32)
    if live is not None:
        # outside-the-image-circle fisheye rays render black: zero
        # throughput, but they still terminate normally so the per-pixel
        # path count (accum alpha) stays exact
        direct0 = direct0 * live[:, None].astype(jnp.float32)
    out = dict(origin=origin, direction=direction,
               direct=direct0,
               pending=jnp.zeros((n, 3), jnp.float32),
               pixel=pixel.astype(jnp.int32),
               bounces=jnp.zeros((n,), jnp.int32),
               # RayQueue default: lastSpecular = true (variables.h:33)
               last_specular=jnp.ones((n,), bool))
    if sample_idx is not None:
        out["sample_idx"] = sample_idx
    return out


# --------------------------------------------------------------------------
# extend — kernel.cu:331-343 / intersect_scene kernel.cu:125-142
# --------------------------------------------------------------------------

def _intersect_scene(origin, direction, scene: SceneData,
                     traversal: str = "xla"):
    """Spheres first, then BVH seeded with the sphere distance (the BVH only
    wins if strictly closer by > epsilon, bvh.h:134).  Returns
    (t, identifier, is_triangle).  ``traversal`` is what
    :func:`tyrant_tpu.ops.traverse.traversal_for` chose for the devices
    the step runs on.

    The cascade traverses rays in direction-octant order: bounce rays are
    incoherent, and grouping by octant shortens each chunk's worst-ray
    while_loop."""
    if scene.sphere_center.shape[0] == 0:
        # zero-sphere scene (e.g. glTF, scene/gltf.py): the sphere pass is
        # statically absent — shapes are compile-time, so this branch costs
        # nothing and sphere-ful scenes compile the identical program
        t_sph = jnp.full(origin.shape[0], VERY_FAR, origin.dtype)
        sph_id = jnp.full(origin.shape[0], -1, jnp.int32)
    else:
        t_sph, sph_id = intersect_spheres(
            origin, direction, scene.sphere_center, scene.sphere_radius)
    if traversal == "cuda":
        t, tri_id = cuda_traverse.closest_hit(origin, direction, scene.bvh,
                                              t_init=t_sph)
    else:
        neg = direction < 0
        key = (neg[:, 0].astype(jnp.int32) + 2 * neg[:, 1].astype(jnp.int32)
               + 4 * neg[:, 2].astype(jnp.int32))
        order = jnp.argsort(key)
        t_o, tri_id_o = closest_hit(origin[order], direction[order],
                                    scene.bvh, t_init=t_sph[order])
        inv = jnp.argsort(order)
        t, tri_id = t_o[inv], tri_id_o[inv]
    is_tri = tri_id >= 0
    ident = jnp.where(is_tri, tri_id, sph_id)
    return t, ident, is_tri


# --------------------------------------------------------------------------
# textures (beyond-reference; scene/texture.py for the design rationale)
# --------------------------------------------------------------------------

def _sample_texture(scene: SceneData, texid, u, v, filter_mode: str,
                    channels: int = 3, uv_fp=None):
    """Sample the flat texel atlas (v=0 at image bottom; per-texture
    repeat / clamp / mirror wrap from the static meta tuple).

    Per-texture (offset, height, width) come from the STATIC ``tex_meta``
    tuple via a select chain (K is small; a gathered meta row would pay the
    ~12 ms/2M gather wall).  Each tap is one row gather of ``tex_data``:
    1 tap nearest, 4 taps bilinear.  ``channels=4`` also returns the
    cutout-alpha lane (same gathers — rows are fetched whole)."""
    meta = scene.tex_meta
    off = jnp.full_like(texid, int(meta[0][0]))
    th = jnp.full_like(texid, int(meta[0][1]))
    tw = jnp.full_like(texid, int(meta[0][2]))
    for k in range(1, len(meta)):
        sel = texid == k
        off = jnp.where(sel, int(meta[k][0]), off)
        th = jnp.where(sel, int(meta[k][1]), th)
        tw = jnp.where(sel, int(meta[k][2]), tw)
    # wrap modes (glTF samplers): 0 repeat, 1 clamp-to-edge, 2 mirrored
    # repeat.  STATIC over the meta tuple — repeat-only scenes compile
    # the identical (wrap-free) program.
    any_wrap = any(len(m) > 3 and (m[3] or m[4]) for m in meta)
    if any_wrap:
        ws = jnp.full_like(texid, int(meta[0][3]))
        wt = jnp.full_like(texid, int(meta[0][4]))
        for k in range(1, len(meta)):
            sel = texid == k
            ws = jnp.where(sel, int(meta[k][3]), ws)
            wt = jnp.where(sel, int(meta[k][4]), wt)

        def wrap_coord(c, mode):
            rep = c - jnp.floor(c)
            t2 = c - 2.0 * jnp.floor(c * 0.5)
            mir = jnp.where(t2 > 1.0, 2.0 - t2, t2)
            cl = jnp.clip(c, 0.0, 1.0)
            return jnp.where(mode == 1, cl,
                             jnp.where(mode == 2, mir, rep))

        u = wrap_coord(u, ws)
        v = wrap_coord(v, wt)
    else:
        u = u - jnp.floor(u)
        v = v - jnp.floor(v)
    n_rows = scene.tex_data.shape[0]

    def tap(xi, yi):
        idx = off + (th - 1 - yi) * tw + xi
        idx = jnp.clip(jnp.where(texid >= 0, idx, 0), 0, n_rows - 1)
        return jnp.take(scene.tex_data, idx, axis=0)[:, :channels]

    if filter_mode == "nearest":
        x = jnp.minimum((u * tw).astype(jnp.int32), tw - 1)
        y = jnp.minimum((v * th).astype(jnp.int32), th - 1)
        return tap(x, y)

    def bilin(off_l, th_l, tw_l):
        """Bilinear: half-texel centred taps, repeat wrap (per level in
        trilinear mode — taps address ``off_l`` with ``th_l x tw_l``)."""
        fx = u * tw_l - 0.5
        fy = v * th_l - 0.5
        x0f = jnp.floor(fx)
        y0f = jnp.floor(fy)
        ax = (fx - x0f)[:, None]
        ay = (fy - y0f)[:, None]
        x0 = jnp.mod(x0f.astype(jnp.int32), tw_l)
        y0 = jnp.mod(y0f.astype(jnp.int32), th_l)
        x1 = jnp.mod(x0 + 1, tw_l)
        y1 = jnp.mod(y0 + 1, th_l)
        if any_wrap:
            # non-repeat borders do not wrap to the opposite edge: clamp
            # the neighbour texel instead (the half-texel seam
            # approximation for mirrored mode)
            x0c = jnp.clip(x0f.astype(jnp.int32), 0, tw_l - 1)
            y0c = jnp.clip(y0f.astype(jnp.int32), 0, th_l - 1)
            x0 = jnp.where(ws == 0, x0, x0c)
            y0 = jnp.where(wt == 0, y0, y0c)
            x1 = jnp.where(ws == 0, x1, jnp.minimum(x0c + 1, tw_l - 1))
            y1 = jnp.where(wt == 0, y1, jnp.minimum(y0c + 1, th_l - 1))

        def tap_l(xi, yi):
            idx = off_l + (th_l - 1 - yi) * tw_l + xi
            idx = jnp.clip(jnp.where(texid >= 0, idx, 0), 0, n_rows - 1)
            return jnp.take(scene.tex_data, idx, axis=0)[:, :channels]

        return (tap_l(x0, y0) * (1 - ax) * (1 - ay)
                + tap_l(x1, y0) * ax * (1 - ay)
                + tap_l(x0, y1) * (1 - ax) * ay
                + tap_l(x1, y1) * ax * ay)

    if filter_mode == "trilinear" and uv_fp is not None \
            and len(meta) > 0 and len(meta[0]) > 5:
        # Mip-mapped trilinear (beyond-reference):
        # per-ray LOD from the ray-cone footprint (uv_fp = world-space
        # footprint mapped through the triangle's uv gradients, computed
        # in _shade), resolved per texture against its OWN texel density.
        # Two bilinear level taps (8 gathers) blended by the lod
        # fraction; the per-(texture, level) offsets/dims are STATIC
        # (TextureAtlas.pack(mips=True) chains in tex_meta[k][5]) so the
        # whole pyramid walk is a trace-time select chain — no meta
        # gathers, matching the base sampler's design.
        fpu, fpv = uv_fp
        fp_texels = jnp.maximum(fpu * tw.astype(jnp.float32),
                                fpv * th.astype(jnp.float32))
        nlev = jnp.full_like(texid, len(meta[0][5]))
        for k in range(1, len(meta)):
            nlev = jnp.where(texid == k, len(meta[k][5]), nlev)
        lod = jnp.log2(jnp.maximum(fp_texels, 1.0))
        lod = jnp.clip(lod, 0.0, (nlev - 1).astype(jnp.float32))
        l0 = lod.astype(jnp.int32)
        frac = (lod - l0.astype(jnp.float32))[:, None]

        def level_meta(lsel):
            o = jnp.full_like(texid, int(meta[0][5][0][0]))
            hh = jnp.full_like(texid, int(meta[0][5][0][1]))
            ww = jnp.full_like(texid, int(meta[0][5][0][2]))
            for k in range(len(meta)):
                for j, (oj, hj, wj) in enumerate(meta[k][5]):
                    if k == 0 and j == 0:
                        continue
                    sel = (texid == k) & (lsel == j)
                    o = jnp.where(sel, int(oj), o)
                    hh = jnp.where(sel, int(hj), hh)
                    ww = jnp.where(sel, int(wj), ww)
            return o, hh, ww

        c0 = bilin(*level_meta(l0))
        c1 = bilin(*level_meta(jnp.minimum(l0 + 1, nlev - 1)))
        return c0 * (1 - frac) + c1 * frac

    return bilin(off, th, tw)


def _sample_envmap(scene: SceneData, d, filter_mode: str):
    """Equirectangular environment radiance for directions ``d`` [N, 3]
    (beyond-reference; z-up like the atmosphere model, sky.py).  u wraps in
    azimuth; v clamps at the poles.  1 tap nearest / 4 taps bilinear into
    the flat env_data rows (offset 1; row 0 is a neutral fallback)."""
    eh, ew = int(scene.env_meta[0]), int(scene.env_meta[1])
    u = jnp.arctan2(d[:, 1], d[:, 0]) * (0.5 * INV_PI) + 0.5
    v = jnp.arccos(jnp.clip(d[:, 2], -1.0, 1.0)) * INV_PI  # 0 = zenith
    n_rows = scene.env_data.shape[0]

    def tap(xi, yi):
        yi = jnp.clip(yi, 0, eh - 1)  # clamp at poles
        idx = jnp.clip(1 + yi * ew + xi, 0, n_rows - 1)
        return jnp.take(scene.env_data, idx, axis=0)[:, :3]

    if filter_mode == "nearest":
        x = jnp.minimum((u * ew).astype(jnp.int32), ew - 1)
        y = jnp.minimum((v * eh).astype(jnp.int32), eh - 1)
        return tap(x, y)
    fx = u * ew - 0.5
    fy = v * eh - 0.5
    x0f = jnp.floor(fx)
    y0f = jnp.floor(fy)
    ax = (fx - x0f)[:, None]
    ay = (fy - y0f)[:, None]
    x0 = jnp.mod(x0f.astype(jnp.int32), ew)
    y0 = y0f.astype(jnp.int32)
    x1 = jnp.mod(x0 + 1, ew)
    return (tap(x0, y0) * (1 - ax) * (1 - ay) + tap(x1, y0) * ax * (1 - ay)
            + tap(x0, y0 + 1) * (1 - ax) * ay
            + tap(x1, y0 + 1) * ax * ay)


def _env_pdf_nearest(scene: SceneData, d):
    """Nearest-texel solid-angle pdf of the env importance sampler
    (env_data lane 3, scene/envlight.py) for directions ``d``.  MUST be
    a nearest tap: the MIS balance weights only telescope to 1 when the
    miss path evaluates exactly the pdf the alias sampler drew from."""
    eh, ew = int(scene.env_meta[0]), int(scene.env_meta[1])
    u = jnp.arctan2(d[:, 1], d[:, 0]) * (0.5 * INV_PI) + 0.5
    v = jnp.arccos(jnp.clip(d[:, 2], -1.0, 1.0)) * INV_PI
    x = jnp.minimum((u * ew).astype(jnp.int32), ew - 1)
    y = jnp.minimum((v * eh).astype(jnp.int32), eh - 1)
    idx = jnp.clip(1 + y * ew + x, 0, scene.env_data.shape[0] - 1)
    return jnp.take(scene.env_data, idx, axis=0)[:, 3]


# --------------------------------------------------------------------------
# shade — kernel.cu:347-627
# --------------------------------------------------------------------------

def _light_power_mode(cfg: RenderConfig, scene: SceneData,
                      n_total: int) -> bool:
    """The ONE spelling of the power-selection eligibility gate, shared by
    the NEE pick and the MIS emitter-hit pdf in _shade — the two must
    agree or MIS weights stop summing to 1 (the bug class the round-3
    delta-light fix closed).  Static only (cfg + light count); the
    zero-total-power fallback is traced at both sites identically."""
    pw = getattr(scene, "light_powers", None)
    return (cfg.light_sampling == "power" and n_total > 1
            and pw is not None and pw.shape[0] == n_total)


def _shade_fog_sample(cfg: RenderConfig, rays, t, frame, slot, row_offset):
    """Volumetric fog free-flight distance sampling (beyond-reference).
    One exponential draw per segment against the slab overlap [ta, ta+L]:
    a collision before the surface turns this segment's interaction into
    a MEDIUM event (is_fog) at t = ta + s.  Conditioning on "no collision"
    cancels the transmittance exactly (unbiased), so surface/sky branches
    need no extra weight; the albedo sigma_s/sigma_t is applied at scatter
    events through the ordinary obj_color throughput multiply in
    :func:`_shade_surface_fetch`'s caller.  Returns (t, is_fog)."""
    d = rays["direction"]
    f_sigma_t = cfg.fog_sigma_s + cfg.fog_sigma_a
    f_ta, f_len = _fog_overlap(rays["origin"], d, t,
                               cfg.fog_z_min, cfg.fog_z_max)
    if cfg.sampler == "sobol":
        from .ops import sobol as _sbf
        u_f = _sbf.sample_1d(rays["sample_idx"], rng.seed_from(
            rays["pixel"], row_offset, rays["bounces"] * 16 + 9,
            *((cfg.seed,) if cfg.seed else ()), 0x50B0))
    else:
        # side stream: fog-off RNG chains are untouched (goldens stable)
        _, u_f = rng.random_float(
            rng.seed_from(frame, rays["pixel"], slot, row_offset, 0xF06))
    if cfg.fog_falloff:
        # exponential height profile: invert the true free-flight CDF
        # of density(z) = sigma * exp(-fog_falloff * z)
        f_rho0, f_k = _fog_density_coeffs(rays["origin"], d, f_ta,
                                          cfg.fog_falloff)
        f_s = _fog_free_flight(u_f, f_sigma_t, f_rho0, f_k)
    else:
        f_s = -jnp.log1p(-jnp.minimum(u_f, 1.0 - 1e-7)) / f_sigma_t
    is_fog = f_s < f_len
    t = jnp.where(is_fog, f_ta + f_s, t)
    return t, is_fog


def _shade_surface_fetch(cfg: RenderConfig, scene: SceneData, rays, o,
                         t_safe, ident, is_tri, hit, frame, slot,
                         row_offset):
    """Surface data fetch (kernel.cu:366-390) plus the beyond-reference
    texture stack (albedo/normal/rough/metal maps, smooth normals).

    One [T+pad, 8] gather covers the whole triangle side (normal, refl,
    color); the sphere side is a select chain over the tiny sphere_table.
    Returns (is_sphere, srow, normal, refl_tri, color_tri, rough_tri,
    trow, cut_alpha, blend_tri); cut_alpha/blend_tri are None unless the
    scene's static alpha/blend gates are set."""
    d = rays["direction"]
    cut_alpha = None
    blend_tri = None
    sid = jnp.clip(ident, 0, scene.sphere_center.shape[0] - 1)
    is_sphere = hit & ~is_tri
    stbl = scene.sphere_table  # [S, 12]
    srow = jnp.broadcast_to(stbl[0][None], (ident.shape[0], stbl.shape[1]))
    for s in range(1, stbl.shape[0]):
        srow = jnp.where((sid == s)[:, None], stbl[s][None], srow)
    sph_c = srow[:, 0:3]
    sph_r = srow[:, 3]
    normal_sphere = (o - sph_c) / sph_r[:, None]

    tid = jnp.clip(ident, 0, scene.tri_shade.shape[0] - 1)
    trow = scene.tri_shade[tid]  # [N, 8]
    normal_tri = trow[:, 0:3]
    refl_tri = trow[:, 3].astype(jnp.int32)
    if scene.has_metal_maps:
        # per-texel-metalness flag rides the refl lane as +32
        # (scene.py to_device); the stochastic lobe pick happens
        # after the rough-map tap below (metalness = texel ch 1)
        metal_tri = refl_tri >= 32
        refl_tri = refl_tri - jnp.where(metal_tri, 32, 0)
    if scene.has_blend:
        # stochastic-BLEND flag rides the refl lane as +16
        # (scene.py to_device; zero extra gathers)
        blend_tri = refl_tri >= 16
        refl_tri = refl_tri - jnp.where(blend_tri, 16, 0)
    color_tri = trow[:, 4:7]
    rough_tri = trow[:, 7]
    if scene.has_textures or scene.smooth_normals \
            or scene.has_normal_maps or scene.has_rough_maps:
        # per-triangle attribute row (beyond-reference): barycentrics
        # recovered from the pre-offset hit point ``o`` via the
        # precomputed dual basis (two dots), then textures and/or
        # interpolated vertex normals from the same gathered row
        arow = scene.tri_attr[tid]  # [N, 32]
        p_rel = o - arow[:, 0:3]
        bu = dot(p_rel, arow[:, 3:6])
        bv = dot(p_rel, arow[:, 6:9])
    if scene.has_textures or scene.has_normal_maps \
            or scene.has_rough_maps:
        uv_t = arow[:, 9:11] + bu[:, None] * arow[:, 11:13] \
            + bv[:, None] * arow[:, 13:15]
        uv_fp = None
        if cfg.texture_filter == "trilinear" \
                and len(scene.tex_meta) > 0 \
                and len(scene.tex_meta[0]) > 5:
            # ray-cone footprint for the mip LOD: one pixel subtends
            # ~1.5/H world units per unit distance (the camera basis
            # spans 1.5 vertically, kernel.cu:699-700), so the hit's
            # world footprint is ~t * 1.5/H; mapped through the
            # triangle's uv gradients (dual basis s1/s2 against the
            # uv edge deltas) it becomes a per-axis uv footprint the
            # sampler scales by each texture's own texel density.
            # Bounce rays reuse the last segment's t (a ray-cone
            # without the accumulated-distance/roughness growth
            # terms — the standard real-time approximation).
            grad_u = arow[:, 3:6] * arow[:, 11:12] \
                + arow[:, 6:9] * arow[:, 13:14]
            grad_v = arow[:, 3:6] * arow[:, 12:13] \
                + arow[:, 6:9] * arow[:, 14:15]
            fp_world = t_safe * (1.5 / cfg.height)
            uv_fp = (fp_world * jnp.sqrt(jnp.maximum(
                         dot(grad_u, grad_u), 1e-20)),
                     fp_world * jnp.sqrt(jnp.maximum(
                         dot(grad_v, grad_v), 1e-20)))
    if scene.has_textures:
        # albedo texture: 1 or 4 atlas taps (cfg.texture_filter);
        # with cutout maps in the scene the SAME taps also return the
        # alpha lane (rows gather whole — no extra cost)
        texid = arow[:, 15].astype(jnp.int32)
        nch = 4 if scene.has_alpha_tex else 3
        albedo4 = _sample_texture(scene, texid, uv_t[:, 0], uv_t[:, 1],
                                  cfg.texture_filter, channels=nch,
                                  uv_fp=uv_fp)
        color_tri = color_tri * jnp.where((texid >= 0)[:, None],
                                          albedo4[:, :3], 1.0)
        if scene.has_alpha_tex:
            cut_alpha = jnp.where(texid >= 0, albedo4[:, 3], 1.0)
    if scene.smooth_normals:
        # smooth shading: normal interpolated across the triangle
        # (the reference requests Assimp GenSmoothNormals then never
        # reads the result, Scene.cpp:5 / static_mesh.cpp:18)
        ns = arow[:, 16:19] + bu[:, None] * arow[:, 19:22] \
            + bv[:, None] * arow[:, 22:25]
        nlen = jnp.sqrt(jnp.maximum(dot(ns, ns), 1e-20))
        ns = ns / nlen[:, None]
        normal_tri = jnp.where((arow[:, 25] > 0.5)[:, None],
                               ns, normal_tri)
    if scene.has_normal_maps:
        # tangent-space normal map (beyond-reference): the UV-derived
        # per-triangle tangent (attr lanes 27:30, scene.py to_device)
        # is orthonormalised against the CURRENT shading normal (so it
        # composes with smooth shading); B = cross(N, T) * handedness
        ntexid = arow[:, 26].astype(jnp.int32)
        nm = _sample_texture(scene, ntexid, uv_t[:, 0], uv_t[:, 1],
                             cfg.texture_filter, uv_fp=uv_fp)
        n_ts = nm * 2.0 - 1.0
        tang = arow[:, 27:30]
        t_o = tang - normal_tri * dot(normal_tri, tang)[:, None]
        t_len = jnp.sqrt(jnp.maximum(dot(t_o, t_o), 1e-20))
        t_o = t_o / t_len[:, None]
        b_o = jnp.cross(normal_tri, t_o) * arow[:, 30:31]
        n_p = t_o * n_ts[:, 0:1] + b_o * n_ts[:, 1:2] \
            + normal_tri * jnp.maximum(n_ts[:, 2:3], 0.0)
        n_p = n_p / jnp.sqrt(jnp.maximum(dot(n_p, n_p), 1e-20))[:, None]
        apply_nm = (ntexid >= 0) & (t_len > 1e-6)
        normal_tri = jnp.where(apply_nm[:, None], n_p, normal_tri)
    if scene.has_rough_maps:
        # per-texel GGX roughness (MTL map_Pr, beyond-reference): the
        # red channel overrides the material's scalar Pr, same clamp
        # as the host path (alpha -> 0 degenerates D(h))
        rtexid = arow[:, 31].astype(jnp.int32)
        rrow = _sample_texture(scene, rtexid, uv_t[:, 0], uv_t[:, 1],
                               cfg.texture_filter, uv_fp=uv_fp)
        rough_tri = jnp.where(rtexid >= 0,
                              jnp.clip(rrow[:, 0], 0.03, 1.0),
                              rough_tri)
        if scene.has_metal_maps:
            # per-texel metalness (glTF appendix B:
            # mix(dielectric_brdf, metal_brdf, metalness)): shade the
            # GGX conductor with probability metalness (channel 1 of
            # the SAME texel row — zero extra gathers), DIFF
            # otherwise — an unbiased stochastic evaluation of the
            # spec's linear lobe mix.  Side RNG stream like fog/
            # blend: metal-free scenes compile identically.
            _, u_m = rng.random_float(
                rng.seed_from(frame, rays["pixel"], slot, row_offset,
                              0x4E7A1))
            m_tex = jnp.where(rtexid >= 0, rrow[:, 1], 1.0)
            pick_ggx = metal_tri & (u_m < m_tex)
            refl_tri = jnp.where(metal_tri,
                                 jnp.where(pick_ggx, GGX, DIFF),
                                 refl_tri)

    normal = jnp.where(is_sphere[:, None], normal_sphere, normal_tri)
    return (is_sphere, srow, normal, refl_tri, color_tri, rough_tri,
            trow, cut_alpha, blend_tri)


def _shade_emitter_hit(cfg: RenderConfig, scene: SceneData, rays, d,
                       normal, t_safe, hit, refl, refl_tri, color_tri,
                       rough_tri, is_sphere, srow, trow, direct):
    """Emitter-hit accounting (kernel.cu:393-401): collect emission into
    the path radiance and zero the throughput of terminating LIGHT hits.
    With MIS on, BSDF-sampled emitter hits are balance-weighted against
    the NEE pdf of the same emitter point instead of the reference's
    lastSpecular double-count guard.  Returns (color, direct)."""
    # --- LIGHT (kernel.cu:393-401) ---
    emission = srow[:, 7:10]
    if scene.n_tri_lights:
        # emissive TRIANGLES (beyond-reference): a LIGHT-typed triangle
        # emits its (texture-modulated) colour, two-sided
        emission = jnp.where(is_sphere[:, None], emission,
                             jnp.where((refl_tri == LIGHT)[:, None],
                                       color_tri, 0.0))
    is_light = hit & (refl == LIGHT)
    last_spec_in = rays["last_specular"]
    mis = cfg.mis == "on"
    if mis:
        # MIS emitter-hit weighting (beyond-reference): instead of the
        # reference's lastSpecular double-count guard (kernel.cu:393-401),
        # weight BSDF-sampled emitter hits by the balance heuristic between
        # the pdf that produced this ray and the NEE pdf of sampling this
        # emitter point from the previous vertex.  Glossy reflections of
        # emitters (which NEE under-samples at low roughness) come back at
        # far lower variance; paths terminate at emitters.
        lights_t = getattr(scene, "light_indices", ())
        n_delta_t = getattr(scene, "n_delta_lights", 0)
        # delta lights can't be hit, but they DO take pick probability
        # away from the area lights — the hit-side pdf must divide by the
        # same light count the NEE pick used (they were missing here
        # before round 3: MIS weights didn't sum to 1 in delta+area
        # scenes)
        multi_l = len(lights_t) > 1 or scene.n_tri_lights or n_delta_t
        total_l = (float(len(lights_t) + scene.n_tri_lights + n_delta_t)
                   if multi_l else 1.0)
        # the NEE strategy coin is ALWAYS the 50/50 sun/light split inside
        # MIS (env-NEE takes the sun slot, the light slot keeps 0.5 —
        # render.py env_nee block; the 1.0 reweight only exists on the
        # non-MIS envmap path, which never reaches this block)
        p_strat_light = 0.5
        pdf_in = rays["bsdf_pdf"]
        # normal is face-forwarded, so -dot(normal, d) is the emitter-side
        # cosine the NEE pdf uses (two-sided tri emitters sample the same
        # sgn-oriented normal)
        cos_l_hit = jnp.maximum(-dot(normal, d), 1e-6)
        sph_area = 4.0 * PI * srow[:, 3] * srow[:, 3]
        # rough_tri is tri_shade lane 7, which LIGHT triangles reuse for
        # their surface area (scene.py to_device)
        area_hit = jnp.where(is_sphere, sph_area, rough_tri)
        if _light_power_mode(cfg, scene, int(total_l)):
            # power selection: pick pdf of the HIT light, recomputed from
            # the hit row with the same f32 luminance x area formula the
            # host-side power table used (scene.py to_device; LUM_RGB is
            # the one shared copy).  Zero total power falls back to the
            # uniform pdf — mirroring the NEE pick's traced fallback.
            em_base = srow[:, 7:10]
            if scene.n_tri_lights:
                em_base = jnp.where(is_sphere[:, None], em_base,
                                    trow[:, 4:7])
            lum_hit = (float(LUM_RGB[0]) * em_base[:, 0]
                       + float(LUM_RGB[1]) * em_base[:, 1]
                       + float(LUM_RGB[2]) * em_base[:, 2])
            total_power = jnp.sum(scene.light_powers)
            pick_p_hit = jnp.where(
                total_power > 0,
                0.75 * lum_hit * area_hit
                / jnp.maximum(total_power, 1e-30) + 0.25 / total_l,
                1.0 / total_l)
        else:
            pick_p_hit = 1.0 / total_l
        p_hit_sa = (p_strat_light * pick_p_hit) * (t_safe * t_safe) \
            / jnp.maximum(cos_l_hit * area_hit, 1e-12)
        w_hit = jnp.where(last_spec_in | (pdf_in <= 0.0), 1.0,
                          pdf_in / jnp.maximum(pdf_in + p_hit_sa, 1e-12))
        color = jnp.where(is_light[:, None],
                          direct * emission * w_hit[:, None], 0.0)
        direct = jnp.where(is_light[:, None], 0.0, direct)
    else:
        color = jnp.where((is_light & last_spec_in)[:, None],
                          direct * emission, 0.0)
        direct = jnp.where((is_light & ~last_spec_in)[:, None], 0.0, direct)
    return color, direct


def _shade_nee_samples(cfg: RenderConfig, scene: SceneData,
                       sky_params: skymod.SkyParams, sun_dir, rays, o,
                       normal, frame, slot, row_offset, seed, use_sobol,
                       sob1, sob2, mis):
    """Shared NEE sample generation: the sun-cone (or env alias-table)
    sample, the 50/50 strategy coin, the area/tri/delta light pick and
    its surface sample (kernel.cu:414/550, beyond-reference multi-light
    + power selection + delta lights).  Returns the strategy samples and
    geometry factors the per-BSDF estimators consume."""
    n = cfg.num_rays
    sun_radiance_env = None   # set on the env-NEE path only
    e_pdf = None
    # --- shared NEE samples ---
    sun_extent = 1.0 - sky_params.sun_angular_diameter_cos
    # env-NEE (beyond-reference, scene/envlight.py): with MIS on, the
    # sun-strategy slot becomes environment-light NEE — one alias-row
    # gather per ray turns two uniforms into a texel whose radiance and
    # solid-angle pdf ride the same row; two more uniforms jitter the
    # direction inside the texel (the pdf is texel-constant, so the
    # nearest-texel pdf the miss path uses for the reverse MIS weight
    # matches exactly).  Without MIS the env stays BSDF-sampled only
    # (NEE-only env would double-count against the unweighted miss path).
    env_nee = mis and scene.has_envmap
    if scene.has_envmap:
        if env_nee:
            eh_e, ew_e = int(scene.env_meta[0]), int(scene.env_meta[1])
            n_tx = eh_e * ew_e
            if use_sobol:
                eu1, eu2 = sob2(11)
                ej1, ej2 = sob2(12)
            else:
                es = rng.seed_from(frame, rays["pixel"], slot, row_offset,
                                   0xE571)
                es, eu1 = rng.random_float(es)
                es, eu2 = rng.random_float(es)
                es, ej1 = rng.random_float(es)
                _, ej2 = rng.random_float(es)
            ei = jnp.minimum((eu1 * n_tx).astype(jnp.int32), n_tx - 1)
            erow = scene.env_alias[ei]
            ekeep = eu2 < erow[:, 0]
            ek = jnp.where(ekeep, ei, erow[:, 1].astype(jnp.int32))
            e_rgb = jnp.where(ekeep[:, None], erow[:, 2:5], erow[:, 6:9])
            e_pdf = jnp.where(ekeep, erow[:, 5], erow[:, 9])
            er = (ek // ew_e).astype(jnp.float32)
            ec = (ek % ew_e).astype(jnp.float32)
            eth = (er + ej1) * (PI / eh_e)
            eph = ((ec + ej2) / ew_e - 0.5) * (2.0 * PI)
            sin_th = jnp.sin(eth)
            sun_sample = jnp.stack([sin_th * jnp.cos(eph),
                                    sin_th * jnp.sin(eph),
                                    jnp.cos(eth)], axis=-1)
            # the "sun radiance" slot carries L/pdf; the strategy colour
            # factors below drop the sun's 1e-5 magic scale in env mode
            sun_radiance_env = e_rgb / jnp.maximum(e_pdf, 1e-12)[:, None]
        else:
            # STATIC skip: no analytic sun under an envmap (the sun
            # colour terms constant-fold away against the zero radiance)
            sun_sample = jnp.broadcast_to(sun_dir, (n, 3))
    elif use_sobol:
        c_u, c_v = sob2(2)
        sun_sample = cone_sample_from_uniforms(
            jnp.broadcast_to(sun_dir, (n, 3)), sun_extent, c_u, c_v)
    else:
        seed, sun_sample = cone_sample(jnp.broadcast_to(sun_dir, (n, 3)),
                                       sun_extent, seed)
    sun_cos = dot(normal, sun_sample)
    # 50/50 sun vs area-light NEE, a coin per ray (kernel.cu:414/550).
    # A block-constant choice would make the sun/light pick spatially
    # correlated, which renders as coherent variance stripes at low sample
    # counts; the per-ray coin has the same per-pixel variance but
    # decorrelates it across pixels — uniform noise, no stripes.
    # (side seed stream: an equally independent coin that leaves the main
    # shade stream untouched, so the cross-round golden snapshot only moves
    # when shading itself changes)
    if use_sobol:
        cs_u = sob1(3)
    else:
        _, cs_u = rng.random_float(
            rng.seed_from(frame, rays["pixel"], slot, row_offset, 0xC0F1))
    choose_sun = cs_u < 0.5
    # NEE strategy weights = 1 / strategy probability.  With an
    # environment map (beyond-reference) there is no analytic sun to
    # next-event-sample: the whole NEE budget goes to the area lights
    # (probability 1 -> weight 1) and env light arrives via BSDF rays.
    inv_p_sun, inv_p_light = 2.0, 2.0
    if scene.has_envmap and not env_nee:
        choose_sun = jnp.zeros_like(choose_sun)
        inv_p_light = 1.0

    lights = getattr(scene, "light_indices", ())
    n_tri_l = scene.n_tri_lights
    n_delta = getattr(scene, "n_delta_lights", 0)
    has_light = (jnp.asarray(True) if (n_tri_l or n_delta)
                 else scene.light_index >= 0)
    delta_pick = None
    if len(lights) > 1 or n_tri_l or n_delta:
        # Multiple lights — emissive spheres AND emissive triangles
        # (beyond-reference; the reference's own TODO at kernel.cu:560:
        # "Hardcoded spheres[6] as only light source. Use light array."):
        # pick one uniformly per ray and weight the estimator by the
        # light count.  A SIDE seed stream keeps the main shade RNG
        # untouched so single-light scenes stay bit-identical, and ONE
        # uniform pair feeds whichever shape was picked (the sphere
        # mapping matches sphere_surface_sample exactly).
        total_lights = len(lights) + n_tri_l + n_delta
        if use_sobol:
            lu = sob1(4)
        else:
            _, lu = rng.random_float(
                rng.seed_from(frame, rays["pixel"], slot, row_offset, 0x11F7))
        # power-proportional selection (cfg.light_sampling == "power"):
        # pick ~ light_powers/total — an unrolled CDF compare chain up to
        # 64 lights (free), one Vose alias-row gather beyond that.  The
        # pdfs are TRACED from the scene.light_powers leaf (emission edits
        # reuse the compiled step; zero total power degrades to uniform in
        # trace).  The estimator divides by the ACTUAL pick pdf either
        # way, so both modes are unbiased; "uniform" keeps the exact
        # reference ops.
        power_mode = _light_power_mode(cfg, scene, total_lights)
        if power_mode and total_lights > 64:
            # many lights: ONE Vose alias-row gather resolves
            # coin -> light -> 1/pdf (scene.light_alias; the fractional
            # part of the scaled uniform is the coin — standard alias
            # trick, no extra stream)
            i0 = jnp.minimum((lu * total_lights).astype(jnp.int32),
                             total_lights - 1)
            frac = lu * total_lights - i0.astype(jnp.float32)
            arow = jnp.take(scene.light_alias, i0, axis=0)  # [n, 4]
            take_self = frac < arow[:, 0]
            pick = jnp.where(take_self, i0, arow[:, 1].astype(jnp.int32))
            inv_pick = jnp.where(take_self, arow[:, 2], arow[:, 3])
        elif power_mode:
            pw = scene.light_powers  # [total_lights] leaf
            tp = jnp.sum(pw)
            # defensive mixture (0.75 power + 0.25 uniform, matching the
            # alias rows and the MIS hit side): bounds every 1/pdf at 4L,
            # so a light whose power HEURISTIC underestimates its real
            # contribution (classic case: a faint directional that lights
            # the whole floor) cannot spray unbounded-weight fireflies
            pdfs = jnp.where(
                tp > 0,
                0.75 * pw / jnp.maximum(tp, 1e-30) + 0.25 / total_lights,
                jnp.full_like(pw, 1.0 / total_lights))
            cdf = jnp.cumsum(pdfs)
            pick = jnp.zeros_like(lu, jnp.int32)
            for k in range(total_lights - 1):
                pick = pick + (lu >= cdf[k]).astype(jnp.int32)
            # per-ray inverse pick pdf (replaces the uniform factor
            # n_lights = total).  A zero-power light's cdf step is flat,
            # so the chain skips its index and its garbage 1/0 is never
            # selected.
            inv_pick = jnp.full_like(lu, 1.0)
            for k in range(total_lights):
                inv_pick = jnp.where(pick == k,
                                     1.0 / jnp.maximum(pdfs[k], 1e-30),
                                     inv_pick)
        else:
            pick = jnp.minimum((lu * total_lights).astype(jnp.int32),
                               total_lights - 1)
        delta_pick = pick
        if scene.sphere_center.shape[0] == 0:
            # zero-sphere scene: only tri/delta lights exist (multi_l
            # guarantees one of them is non-empty); seed the selects with
            # inert values — every sphere-pick lane is masked off below
            # (pick < len(lights) is never true), radius 1 avoids /0
            light_c = jnp.zeros((n, 3))
            light_r = jnp.ones((n,))
            light_e = jnp.zeros((n, 3))
        else:
            base = lights[0] if lights else 0
            light_c = jnp.broadcast_to(scene.sphere_center[base], (n, 3))
            light_r = jnp.broadcast_to(scene.sphere_radius[base], (n,))
            light_e = jnp.broadcast_to(scene.sphere_emission[base], (n, 3))
        for k in range(1, len(lights)):
            sel = pick == k
            light_c = jnp.where(sel[:, None],
                                scene.sphere_center[lights[k]], light_c)
            light_r = jnp.where(sel, scene.sphere_radius[lights[k]], light_r)
            light_e = jnp.where(sel[:, None],
                                scene.sphere_emission[lights[k]], light_e)
        # 1/pick-pdf: the uniform count, or the per-ray power weight
        n_lights = inv_pick if power_mode else float(total_lights)
        if use_sobol:
            lu1, lu2 = sob2(5)
        else:
            seed, lu1 = rng.random_float(seed)
            seed, lu2 = rng.random_float(seed)
        lp = sphere_surface_from_uniforms(light_c, light_r[:, None],
                                          lu1, lu2)
        n_l = normalize(lp - light_c)
        area = 4.0 * PI * light_r * light_r
        if n_tri_l:
            tl = scene.tri_lights
            idx = jnp.clip(pick - len(lights), 0, tl.shape[0] - 1)
            row = jnp.take(tl, idx, axis=0)  # [n, 13]
            lp_tri = triangle_sample_from_uniforms(
                row[:, 0:3], row[:, 3:6], row[:, 6:9], lu1, lu2)
            tn = jnp.cross(row[:, 3:6], row[:, 6:9])
            tn = tn / jnp.maximum(
                jnp.sqrt(jnp.maximum(dot(tn, tn), 1e-30)), 1e-30)[:, None]
            is_tl = (pick >= len(lights)) & (pick < len(lights) + n_tri_l)
            lp = jnp.where(is_tl[:, None], lp_tri, lp)
            light_e = jnp.where(is_tl[:, None], row[:, 9:12], light_e)
            area = jnp.where(is_tl, row[:, 12], area)
            # two-sided emitter: orient the light normal toward the
            # shading point so cos_light >= 0 from either side (matches
            # the direct-hit emission, which the normal flip at the top
            # of shade already makes two-sided)
            to_surf = o - lp
            sgn = jnp.sign(dot(tn, to_surf) + 1e-30)
            n_l = jnp.where(is_tl[:, None], tn * sgn[:, None], n_l)
    else:
        if scene.sphere_center.shape[0] == 0:
            # zero-sphere, zero-light scene (e.g. a bare glTF mesh under
            # the atmosphere): has_light is False, so the whole light
            # strategy contributes zero — inert stand-ins keep the shapes
            # (radius 1 avoids a masked /0)
            light_c = jnp.zeros(3)
            light_r = jnp.asarray(1.0)
            light_e = jnp.zeros(3)
        else:
            li = jnp.maximum(scene.light_index, 0)
            light_c = scene.sphere_center[li]
            light_r = scene.sphere_radius[li]
            light_e = scene.sphere_emission[li]
        n_lights = 1.0
        if use_sobol:
            lu1, lu2 = sob2(5)
            lp = sphere_surface_from_uniforms(
                jnp.broadcast_to(light_c, (n, 3)), light_r, lu1, lu2)
        else:
            seed, lp = sphere_surface_sample(
                jnp.broadcast_to(light_c, (n, 3)), light_r, seed)
        n_l = normalize(lp - light_c)
        area = 4.0 * PI * light_r * light_r
    lvec = lp - o
    ldist2 = dot(lvec, lvec)
    ldist = jnp.sqrt(jnp.maximum(ldist2, 1e-20))
    ldir = lvec / ldist[:, None]
    cos_surf = dot(normal, ldir)
    cos_light = dot(n_l, -ldir)
    solid_angle = cos_light * area / jnp.maximum(ldist2, 1e-20)
    if n_delta:
        # Delta lights (beyond-reference; scene.DeltaLights): a picked
        # point/spot/directional light replaces the area-light sample.
        # The downstream BSDF estimators read (light_e, solid_angle) as
        # "radiance x subtended solid angle / pdf", so a delta light
        # substitutes light_e = radiant intensity and solid_angle = 1/d^2
        # (directional: irradiance and 1 — no falloff), with cos_light
        # pinned to 1 (a measure-zero emitter has no facing test).
        drow = jnp.take(scene.delta_lights,
                        jnp.clip(delta_pick - (len(lights) + n_tri_l),
                                 0, n_delta - 1), axis=0)  # [n, 12]
        d_kind = drow[:, 0]
        d_axis = drow[:, 4:7]  # unit, light -> scene (normalised at build)
        is_dl = delta_pick >= len(lights) + n_tri_l
        is_ddir = is_dl & (d_kind >= 2.0)
        dl_vec = drow[:, 1:4] - o
        dl_d2 = jnp.maximum(dot(dl_vec, dl_vec), 1e-12)
        dl_dist = jnp.sqrt(dl_d2)
        dl_ldir = jnp.where(is_ddir[:, None], -d_axis,
                            dl_vec / dl_dist[:, None])
        # spot cone: smooth Hermite falloff between cos_outer..cos_inner
        # of the angle between the axis and the light->surface direction
        cd = dot(d_axis, -dl_ldir)
        tt = jnp.clip((cd - drow[:, 11])
                      / jnp.maximum(drow[:, 10] - drow[:, 11], 1e-6),
                      0.0, 1.0)
        fall = jnp.where(d_kind == 1.0, tt * tt * (3.0 - 2.0 * tt), 1.0)
        ldir = jnp.where(is_dl[:, None], dl_ldir, ldir)
        ldist = jnp.where(is_dl, jnp.where(is_ddir, VERY_FAR, dl_dist),
                          ldist)
        cos_surf = jnp.where(is_dl, dot(normal, dl_ldir), cos_surf)
        cos_light = jnp.where(is_dl, 1.0, cos_light)
        solid_angle = jnp.where(
            is_dl, jnp.where(is_ddir, fall, fall / dl_d2), solid_angle)
        light_e = jnp.where(is_dl[:, None], drow[:, 7:10], light_e)
    return (seed, sun_sample, sun_radiance_env, e_pdf, sun_cos,
            choose_sun, inv_p_sun, inv_p_light, has_light, delta_pick,
            n_lights, light_e, area, ldir, ldist, ldist2, cos_surf,
            cos_light, solid_angle)


def _shade_nee_weights(cfg: RenderConfig, scene: SceneData,
                       sky_params: skymod.SkyParams, rays, d, o, normal,
                       direct, hit, refl, is_sphere, is_fog, obj_color,
                       is_ggx, ggx_alpha, sun_dir, sun_sample,
                       sun_radiance_env, e_pdf, sun_cos, choose_sun,
                       inv_p_sun, inv_p_light, has_light, delta_pick,
                       n_lights, light_e, area, ldir, ldist, ldist2,
                       cos_surf, cos_light, solid_angle, mis):
    """Per-BSDF NEE estimator weights (kernel.cu:410-447 DIFF,
    kernel.cu:546-591 PHONG; beyond-reference GGX and fog-phase lanes),
    the MIS NEE-side balance weights, and the fog shadow transmittance.
    Returns the shadow-queue fields plus the shared lobe quantities the
    bounce sampler reuses (w_refl, pe, is_diff/is_phong, the
    _bsdf_pdf_toward closure, and p_sun_sa for the miss path)."""
    n = cfg.num_rays
    eps = cfg.epsilon
    fog_on = is_fog is not None
    f_sigma_t = cfg.fog_sigma_s + cfg.fog_sigma_a
    env_nee = mis and scene.has_envmap
    sun_extent = 1.0 - sky_params.sun_angular_diameter_cos
    lights = getattr(scene, "light_indices", ())
    n_tri_l = scene.n_tri_lights
    n_delta = getattr(scene, "n_delta_lights", 0)
    p_sun_sa = None
    sun_radiance = (jnp.zeros((n, 3), jnp.float32) if scene.has_envmap
                    else skymod.sun(sun_sample, sun_dir, sky_params))
    if env_nee:
        sun_radiance = sun_radiance_env
    # sun-strategy colour scales: the reference bakes the cone solid
    # angle and brightness into 1e-5 (kernel.cu:416); the env sampler is
    # already radiance-over-pdf, so env mode uses the true BRDF factors
    c_diff = INV_PI if env_nee else 1e-5
    c_spec = 1.0 if env_nee else 1e-5

    # DIFF NEE weights (kernel.cu:410-447)
    diff_sun_color = inv_p_sun * direct * sun_radiance \
        * (sun_cos * c_diff)[:, None]
    diff_sun_ok = choose_sun & (sun_cos > 0)
    light_e2 = light_e if light_e.ndim == 2 else light_e[None]
    # 1/(strategy pdf x pick pdf): a float under uniform selection (exact
    # reference ops), a per-ray column under power selection
    nl_col = (inv_p_light * n_lights if isinstance(n_lights, float)
              else (inv_p_light * n_lights)[:, None])
    diff_light_color = light_e2 * nl_col * direct \
        * (solid_angle * INV_PI * cos_surf)[:, None]
    diff_light_ok = ~choose_sun & (cos_surf > 0) & (cos_light > 0) & has_light

    # PHONG NEE weights (kernel.cu:546-591)
    pe = PHONG_EXPONENT
    w_refl = normalize(d - normal * (2.0 * dot(normal, d))[:, None])
    phong_cos_sun = dot(sun_sample, w_refl)
    phong_sun_color = inv_p_sun * direct * ((pe + 2.0) * 0.5 * INV_PI) \
        * sun_radiance * (sun_cos * jnp.power(jnp.maximum(phong_cos_sun, 0.0), pe)
                          * c_spec)[:, None]
    phong_sun_ok = choose_sun & (sun_cos > 0) & (phong_cos_sun > eps)
    phong_cos_l = dot(ldir, w_refl)
    phong_light_color = light_e2 * nl_col * direct \
        * (solid_angle * (pe + 2.0) * 0.5 * INV_PI
           * jnp.power(jnp.maximum(phong_cos_l, 0.0), pe) * cos_surf)[:, None]
    phong_light_ok = ~choose_sun & (cos_surf > 0) & (cos_light > 0) \
        & (phong_cos_l > eps) & has_light

    is_diff = hit & (refl == DIFF)
    is_phong = hit & (refl == PHONG)

    shadow_ok = (is_diff & (diff_sun_ok | diff_light_ok)) \
        | (is_phong & (phong_sun_ok | phong_light_ok))
    shadow_dir = jnp.where(choose_sun[:, None], sun_sample, ldir)
    shadow_color = jnp.where(
        is_diff[:, None],
        jnp.where(choose_sun[:, None], diff_sun_color, diff_light_color),
        jnp.where(choose_sun[:, None], phong_sun_color, phong_light_color))
    if scene.has_ggx:
        # GGX NEE (beyond-reference): same sun/light estimator shape as
        # DIFF/PHONG with the microfacet BRDF evaluated toward the sample
        view = -d
        f_ggx_sun = _ggx_eval(normal, view, sun_sample, ggx_alpha, obj_color)
        ggx_sun_color = inv_p_sun * direct * sun_radiance * f_ggx_sun \
            * (sun_cos * c_spec)[:, None]
        ggx_sun_ok = choose_sun & (sun_cos > 0)
        f_ggx_l = _ggx_eval(normal, view, ldir, ggx_alpha, obj_color)
        ggx_light_color = light_e2 * nl_col * direct \
            * f_ggx_l * (solid_angle * cos_surf)[:, None]
        ggx_light_ok = ~choose_sun & (cos_surf > 0) & (cos_light > 0) \
            & has_light
        shadow_ok = shadow_ok | (is_ggx & (ggx_sun_ok | ggx_light_ok))
        shadow_color = jnp.where(
            is_ggx[:, None],
            jnp.where(choose_sun[:, None], ggx_sun_color, ggx_light_color),
            shadow_color)
    if fog_on:
        # medium-event NEE: the phase function replaces the surface
        # BRDF-times-cosine kernel (an HG event has no cosine term).  The
        # sun strategy keeps the reference's magic radiance scale: DIFF
        # writes sun_cos * 1e-5 for INV_PI * cos * C, so C = pi * 1e-5 and
        # the fog analogue is phase * pi * 1e-5 — fog brightness stays
        # consistent with how surfaces respond to the same sun.
        fog_sun_color = inv_p_sun * direct * sun_radiance \
            * (hg_phase(dot(d, sun_sample), cfg.fog_g)
               * (1.0 if env_nee else PI * 1e-5))[:, None]
        fog_light_color = light_e2 * nl_col * direct \
            * (solid_angle * hg_phase(dot(d, ldir), cfg.fog_g))[:, None]
        fog_light_ok = ~choose_sun & (cos_light > 0) & has_light
        shadow_ok = jnp.where(is_fog, choose_sun | fog_light_ok, shadow_ok)
        shadow_color = jnp.where(
            is_fog[:, None],
            jnp.where(choose_sun[:, None], fog_sun_color, fog_light_color),
            shadow_color)

    def _bsdf_pdf_toward(ddir):
        """Solid-angle pdf of this vertex's BSDF sampler producing ``ddir``
        (MIS balance heuristic; 0 for delta BSDFs — their paths carry
        last_specular instead)."""
        c = dot(normal, ddir)
        p = jnp.where(is_diff, jnp.maximum(c, 0.0) * INV_PI, 0.0)
        pc = jnp.maximum(dot(ddir, w_refl), 0.0)
        p = jnp.where(is_phong,
                      (pe + 1.0) * 0.5 * INV_PI * jnp.power(pc, pe), p)
        if scene.has_ggx:
            view_l = -d
            h_l = normalize(view_l + ddir)
            nv_l = jnp.maximum(dot(normal, view_l), 1e-6)
            p_ggx = ggx_g1(nv_l, ggx_alpha) \
                * ggx_d_vec(normal, h_l, ggx_alpha) / (4.0 * nv_l)
            p = jnp.where(is_ggx, p_ggx, p)
        if fog_on:
            # the HG phase is its own solid-angle pdf (normalised over the
            # sphere), so medium events MIS-combine like any other lobe
            p = jnp.where(is_fog, hg_phase(dot(d, ddir), cfg.fog_g), p)
        return p

    if mis:
        # NEE-side balance weights: each strategy's contribution is scaled
        # by p_strategy / (p_strategy + p_bsdf(direction)); the emitter-hit
        # side above applies the complementary weight, so the pair sums
        # to 1 per (vertex, emitter) and the combination stays unbiased.
        if env_nee:
            p_sun_sa = e_pdf * (1.0 / inv_p_sun)
        elif scene.has_envmap:
            p_sun_sa = 0.0
        else:
            p_sun_sa = (1.0 / inv_p_sun) / (2.0 * PI * sun_extent)
        w_nee_sun = p_sun_sa / jnp.maximum(
            p_sun_sa + _bsdf_pdf_toward(sun_sample), 1e-12)
        p_l_sa = (1.0 / inv_p_light) / n_lights * ldist2 \
            / jnp.maximum(cos_light * area, 1e-12)
        w_nee_light = p_l_sa / jnp.maximum(
            p_l_sa + _bsdf_pdf_toward(ldir), 1e-12)
        if n_delta:
            # a BSDF ray can never hit a measure-zero emitter, so NEE is
            # the only strategy for a delta pick: balance weight 1
            w_nee_light = jnp.where(
                delta_pick >= len(lights) + n_tri_l, 1.0, w_nee_light)
        w_nee = jnp.where(choose_sun, w_nee_sun, w_nee_light)
        shadow_color = shadow_color * w_nee[:, None]
    # sun shadows use the ShadowQueue default max distance (variables.h:41)
    # tri lights live IN the BVH: shrink the shadow range a hair so the
    # occlusion test cannot hit the sampled emitter itself at t == ldist
    # (sphere lights are not BVH geometry, so the sphere-only path keeps
    # the exact reference semantics — static gate, goldens unchanged)
    ldist_occ = ldist * (1.0 - 1e-3) if n_tri_l else ldist
    shadow_maxd = jnp.where(choose_sun, VERY_FAR, ldist_occ)
    if fog_on:
        # every NEE connection pays the slab transmittance along its
        # shadow segment (sun rays: to the slab exit; light rays: to the
        # sampled emitter point) — this is what casts the god rays
        sh_ta, sh_len = _fog_overlap(o, shadow_dir,
                                     jnp.where(choose_sun, VERY_FAR, ldist),
                                     cfg.fog_z_min, cfg.fog_z_max)
        if cfg.fog_falloff:
            s_rho0, s_k = _fog_density_coeffs(o, shadow_dir, sh_ta,
                                              cfg.fog_falloff)
            sh_tau = _fog_optical_depth(f_sigma_t, s_rho0, s_k, sh_len)
        else:
            sh_tau = f_sigma_t * sh_len
        shadow_color = shadow_color * jnp.exp(-sh_tau)[:, None]
    return (shadow_ok, shadow_dir, shadow_color, shadow_maxd, w_refl,
            pe, is_diff, is_phong, _bsdf_pdf_toward, p_sun_sa)


def _shade_bounce(cfg: RenderConfig, scene: SceneData, rays, d, o,
                  normal, direct, hit, refl, is_tri, is_sphere, srow,
                  rough_tri, outside, is_diff, is_phong, w_refl, pe,
                  is_ggx, ggx_alpha, obj_color, is_fog, is_pass, t_safe,
                  seed, use_sobol, sob1, sob2, frame, slot, row_offset,
                  mis, last_spec_in, pdf_in, _bsdf_pdf_toward):
    """Per-BSDF bounce sampling and bookkeeping: DIFF cosine hemisphere
    (kernel.cu:450-467), SPEC mirror (kernel.cu:473), REFR
    fresnel/TIR/Beer-Lambert (kernel.cu:476-514) incl. optional spectral
    dispersion, the PHONG rejection lobe (kernel.cu:521-544), the
    beyond-reference GGX / rough-glass / fog-phase lobes, the
    lastSpecular + MIS-pdf carry, and the per-material origin offsets
    (kernel.cu:505/592).  Returns (seed, new_dir, direct, new_last_spec,
    next_bsdf_pdf, origin_out)."""
    n = cfg.num_rays
    eps = cfg.epsilon
    fog_on = is_fog is not None
    next_bsdf_pdf = None
    # --- bounce directions ---
    # DIFF cosine hemisphere (kernel.cu:450-467); only resampled when
    # bounces < MAX (the ray dies in RR otherwise)
    if use_sobol:
        b_u, b_v = sob2(6)  # shared bounce-direction pair (diff | GGX)
        diff_dir = cosine_hemisphere_from_uniforms(normal, b_u, b_v)
    else:
        seed, diff_dir = cosine_hemisphere_sample(normal, seed)
    diff_new_dir = jnp.where((rays["bounces"] < cfg.max_bounces)[:, None],
                             diff_dir, d)

    spec_dir = reflect(d, normal)  # kernel.cu:473

    # REFR (kernel.cu:476-514): Schlick fresnel + TIR, reversed-IoR
    # convention kept verbatim from the reference
    if scene.has_var_ior:
        # per-triangle glass IOR (KHR_materials_ior / JSON "ior"): REFR
        # triangles carry eta on the tri_shade lane 7 (rough_tri here);
        # spheres and RREFR keep the reference's 1.2
        eta = jnp.where(is_tri & (refl == REFR), rough_tri, 1.2)
    else:
        eta = 1.2
    if cfg.dispersion:
        # Spectral dispersion (beyond-reference): per-channel glass IOR
        # eta_c = eta * (1 + dispersion * (c - 1)), c in {0:R, 1:G, 2:B}
        # (blue bends more).  A polychromatic path meeting glass collapses
        # to ONE stochastic wavelength channel BEFORE the Fresnel test so
        # the reflect/refract decision, TIR and the refraction angle are
        # all consistent for that wavelength; direct *= 3 * onehot(c)
        # keeps the estimator exactly unbiased (E[3*onehot] = 1 per
        # channel).  Monochromatic paths keep their channel through later
        # glass events (derived from the throughput's surviving channel —
        # no new ray state).  Side RNG stream / static gate: dispersion=0
        # compiles the identical program.  RREFR rough glass stays
        # undispersed (its microfacet blur dominates any fringe).
        if use_sobol:
            u_w = sob1(13)
        else:
            _, u_w = rng.random_float(
                rng.seed_from(frame, rays["pixel"], slot, row_offset,
                              0xD15B))
        pick = jnp.minimum((u_w * 3.0).astype(jnp.int32), 2)
        poly = ((direct[:, 0] > 0).astype(jnp.int32)
                + (direct[:, 1] > 0) + (direct[:, 2] > 0)) > 1
        chan = jnp.where(poly, pick,
                         jnp.argmax(direct, axis=1).astype(jnp.int32))
        at_glass = hit & (refl == REFR)
        eta = jnp.where(at_glass,
                        eta * (1.0 + cfg.dispersion
                               * (chan.astype(jnp.float32) - 1.0)), eta)
        onehot = (jnp.arange(3, dtype=jnp.int32)[None, :]
                  == chan[:, None]).astype(direct.dtype)
        direct = jnp.where((at_glass & poly)[:, None],
                           direct * 3.0 * onehot, direct)
    n1 = jnp.where(outside, eta, 1.0)
    n2 = jnp.where(outside, 1.0, eta)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    cos_i = -dot(normal, d)
    nr = n2 / n1
    sin_t2 = nr * nr * (1.0 - cos_i * cos_i)
    tir = sin_t2 > 1.0
    fresnel = jnp.where(tir, 1.0,
                        r0 + (1.0 - r0) * jnp.power(jnp.maximum(1.0 - cos_i, 0.0), 5.0))
    if use_sobol:
        fr = sob1(7)
    else:
        seed, fr = rng.random_float(seed)
    refr_reflects = fr < fresnel
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin_t2, 0.0))
    refr_dir = nr[:, None] * d + (nr * cos_i - cos_t)[:, None] * normal
    refr_new_dir = jnp.where(refr_reflects[:, None], spec_dir, refr_dir)
    is_refr = hit & (refl == REFR)
    # Beer-Lambert inside the medium (kernel.cu:511-513)
    beer = jnp.exp(-obj_color * t_safe[:, None])
    direct = direct * jnp.where((is_refr & ~outside)[:, None], beer, 1.0)

    # PHONG lobe with rejection resampling (do/while kernel.cu:521-544);
    # bounded to 8 masked retries, falling back to the ideal reflection
    def phong_iter(_, carry):
        s, cur, ok = carry
        s, cand = phong_lobe_sample(w_refl, pe, s)
        take = ~ok & (dot(cand, normal) > eps)
        cur = jnp.where(take[:, None], cand, cur)
        return s, cur, ok | take

    seed, cand0 = phong_lobe_sample(w_refl, pe, seed)
    ok0 = dot(cand0, normal) > eps
    seed, phong_dir, phong_ok = jax.lax.fori_loop(
        0, 8, phong_iter, (seed, cand0, ok0))
    phong_dir = jnp.where(phong_ok[:, None], phong_dir, w_refl)

    # --- combine by material ---
    new_dir = jnp.where(is_diff[:, None], diff_new_dir, d)
    new_dir = jnp.where((hit & (refl == SPEC))[:, None], spec_dir, new_dir)
    new_dir = jnp.where(is_refr[:, None], refr_new_dir, new_dir)
    new_dir = jnp.where(is_phong[:, None], phong_dir, new_dir)
    # LIGHT keeps its direction (kernel.cu:405 falls through)

    if scene.has_ggx:
        # GGX bounce (beyond-reference): VNDF-sampled half-vector; the
        # estimator weight for the reflected direction is F(h.v) * G1(n.l)
        # (ops/sampling.py ggx_vndf_sample_from_uniforms).  A SIDE seed
        # stream keeps the main shade RNG chain untouched, so non-GGX
        # materials in the same scene shade identically.
        if use_sobol:
            gu1, gu2 = b_u, b_v  # same purpose (bounce dir), same pair
        else:
            gseed = rng.seed_from(frame, rays["pixel"], slot, row_offset,
                                  0x66C5)
            gseed, gu1 = rng.random_float(gseed)
            _, gu2 = rng.random_float(gseed)
        view = -d
        ggx_h = ggx_vndf_sample_from_uniforms(view, normal, ggx_alpha,
                                              gu1, gu2)
        ggx_dir = reflect(d, ggx_h)
        ggx_nl = dot(normal, ggx_dir)
        ggx_hv = jnp.maximum(dot(ggx_h, view), 0.0)
        ggx_f = obj_color \
            + (1.0 - obj_color) * jnp.power(1.0 - ggx_hv, 5.0)[:, None]
        # below-horizon samples get weight 0: throughput dies, RR terminates
        ggx_w = jnp.where((ggx_nl > eps)[:, None],
                          ggx_f * ggx_g1(ggx_nl, ggx_alpha)[:, None], 0.0)
        new_dir = jnp.where(is_ggx[:, None], ggx_dir, new_dir)
        direct = direct * jnp.where(is_ggx[:, None], ggx_w, 1.0)

    rr_transmit = None
    if scene.has_rrefr:
        # RREFR (beyond-reference): rough dielectric — "frosted glass".
        # The REFR Fresnel/TIR/refraction math above, evaluated through a
        # VNDF-sampled GGX microfacet h instead of the geometric normal.
        # The VNDF estimator weight for either lobe is G2/G1 = G1(n.out)
        # (separable Smith, ops/sampling.py).  Like smooth glass, rough
        # glass takes no NEE: both lobes shade as delta-born (lastSpecular
        # on, MIS pdf 0), so emitters/env arrive through BSDF hits at
        # weight 1 — unbiased, just noisier than a true transmission pdf.
        is_rrefr = hit & (refl == RREFR)
        rr_rough = jnp.where(is_sphere, srow[:, 11], rough_tri)
        rr_alpha = jnp.clip(rr_rough * rr_rough, 1e-4, 1.0)
        if use_sobol:
            ru1, ru2 = b_u, b_v  # same purpose (bounce dir), same pair
        else:
            rsd = rng.seed_from(frame, rays["pixel"], slot, row_offset,
                                0x4F61)
            rsd, ru1 = rng.random_float(rsd)
            _, ru2 = rng.random_float(rsd)
        rr_h = ggx_vndf_sample_from_uniforms(-d, normal, rr_alpha, ru1, ru2)
        cos_im = -dot(rr_h, d)
        sin_t2m = nr * nr * (1.0 - cos_im * cos_im)
        fres_m = jnp.where(
            sin_t2m > 1.0, 1.0,
            r0 + (1.0 - r0) * jnp.power(jnp.maximum(1.0 - cos_im, 0.0), 5.0))
        rr_reflects = fr < fres_m  # the REFR coin (same purpose, same draw)
        cos_tm = jnp.sqrt(jnp.maximum(1.0 - sin_t2m, 0.0))
        rr_dir = jnp.where(
            rr_reflects[:, None], reflect(d, rr_h),
            nr[:, None] * d + (nr * cos_im - cos_tm)[:, None] * rr_h)
        out_cos = dot(normal, rr_dir)
        # reflected lobes must leave above the surface, transmitted below;
        # sideways microfacet samples get weight 0 (path dies in RR)
        rr_valid = (cos_im > 0.0) & jnp.where(rr_reflects, out_cos > eps,
                                              out_cos < -eps)
        rr_w = jnp.where(rr_valid,
                         ggx_g1(jnp.abs(out_cos), rr_alpha), 0.0)
        new_dir = jnp.where(is_rrefr[:, None], rr_dir, new_dir)
        direct = direct * jnp.where(is_rrefr[:, None], rr_w[:, None], 1.0)
        # Beer-Lambert inside the medium, exactly like REFR
        direct = direct * jnp.where((is_rrefr & ~outside)[:, None],
                                    beer, 1.0)
        rr_transmit = is_rrefr & ~rr_reflects

    if fog_on:
        # medium-event bounce: exact HG inverse-CDF sample around the
        # incoming direction; pdf == phase, so the estimator weight is 1
        # (the albedo was applied through obj_color above)
        if cfg.sampler == "sobol":
            fu1, fu2 = sob2(10)
        else:
            fs = rng.seed_from(frame, rays["pixel"], slot, row_offset, 0xF09)
            fs, fu1 = rng.random_float(fs)
            _, fu2 = rng.random_float(fs)
        fog_dir = hg_sample_from_uniforms(d, cfg.fog_g, fu1, fu2)
        new_dir = jnp.where(is_fog[:, None], fog_dir, new_dir)

    new_last_spec = (hit & (refl == SPEC)) | (is_refr & refr_reflects)
    if scene.has_rrefr:
        # both rough-glass lobes skip NEE, so emitter hits must count
        # (and MIS marks them delta-born through new_last_spec below)
        new_last_spec = new_last_spec | is_rrefr
    if scene.has_alpha_tex:
        # a pass-through does not change the path's BSDF history: a
        # specular-born ray seen through a leaf hole must still collect
        # the sun disc on its next miss
        new_last_spec = jnp.where(is_pass, last_spec_in, new_last_spec)
    if mis:
        # pdf of the direction we just sampled, carried into the next
        # vertex for the emitter-hit side of the balance heuristic.
        # Delta-born rays (mirror reflect AND both refraction branches —
        # the reference marks only the reflect side lastSpecular,
        # kernel.cu:500) carry pdf 0, which every weight treats as
        # "delta: weight 1" — a transmitted-glass path that hits an
        # emitter or the env would otherwise be near-zeroed.
        is_delta_born = new_last_spec | (is_refr & ~refr_reflects)
        next_bsdf_pdf = jnp.where(
            is_delta_born, 0.0,
            jnp.maximum(_bsdf_pdf_toward(new_dir), 1e-8))
        if scene.has_alpha_tex:
            # pass-throughs keep the pdf of the sample that created them
            next_bsdf_pdf = jnp.where(is_pass, pdf_in, next_bsdf_pdf)

    origin_out = o \
        + jnp.where((is_refr & ~refr_reflects)[:, None],
                    -2.0 * eps * normal, 0.0) \
        + jnp.where(is_phong[:, None], eps * w_refl, 0.0)  # kernel.cu:505,592
    if rr_transmit is not None:
        # transmitted rough-glass rays start behind the surface, like REFR
        origin_out = origin_out + jnp.where(rr_transmit[:, None],
                                            -2.0 * eps * normal, 0.0)
    if scene.has_alpha_tex:
        # step through the cutout surface (the +eps face-forward offset
        # above would re-hit it)
        origin_out = origin_out + jnp.where(is_pass[:, None],
                                            -2.0 * eps * normal, 0.0)
    return (seed, new_dir, direct, new_last_spec, next_bsdf_pdf,
            origin_out)


def _shade(cfg: RenderConfig, scene: SceneData, sky_params: skymod.SkyParams,
           sun_dir, rays, t, ident, is_tri, frame, row_offset=0):
    n = cfg.num_rays
    eps = cfg.epsilon
    d = rays["direction"]
    slot = jnp.arange(n, dtype=jnp.int32)

    fog_on = cfg.fog == "on" and (cfg.fog_sigma_s + cfg.fog_sigma_a) > 0.0
    if fog_on:
        f_sigma_t = cfg.fog_sigma_s + cfg.fog_sigma_a
        f_albedo = cfg.fog_sigma_s / f_sigma_t
        t, is_fog = _shade_fog_sample(cfg, rays, t, frame, slot, row_offset)

    hit = t < VERY_FAR
    t_safe = jnp.where(hit, t, 0.0)
    o = rays["origin"] + d * t_safe[:, None]

    (is_sphere, srow, normal, refl_tri, color_tri, rough_tri, trow,
     cut_alpha, blend_tri) = _shade_surface_fetch(
        cfg, scene, rays, o, t_safe, ident, is_tri, hit, frame, slot,
        row_offset)
    # triangles honour per-triangle materials (defaults: white DIFF, the
    # reference's hard-wired behaviour kernel.cu:380-384 / unused
    # Triangle::materialType loader.h:16)
    refl = jnp.where(is_sphere, srow[:, 10].astype(jnp.int32), refl_tri)
    refl = jnp.where(hit, refl, DIFF)
    obj_color = jnp.where(is_sphere[:, None], srow[:, 4:7], color_tri)

    if fog_on:
        # medium events override the surface interaction: no surface
        # normal exists (use -d so the face-forward below is a no-op and
        # the eps offset backs off along the ray), the pseudo-material is
        # FOG, and the throughput multiplier is the single-scatter albedo
        is_sphere = is_sphere & ~is_fog
        normal = jnp.where(is_fog[:, None], -d, normal)
        refl = jnp.where(is_fog, FOG, refl)
        obj_color = jnp.where(is_fog[:, None], f_albedo, obj_color)

    if scene.has_alpha_tex:
        # alpha cutout (MTL map_d): sub-threshold hits become PASS-through
        # pseudo-material — no shading, no NEE, no colour multiply; the
        # ray continues BEHIND the surface next step (one wavefront step
        # per transparent layer, like a REFR transmission with no bend).
        # Shadow rays stay alpha-blind (see SceneData.has_alpha_tex).
        thresh = 0.5
        if scene.has_blend:
            # stochastic transparency (glTF alphaMode BLEND / MTL d<1):
            # a BLEND hit shades with probability alpha and passes
            # through with probability 1-alpha — unbiased linear
            # over-compositing at one wavefront step per layer.  Side
            # RNG stream (like fog): blend-free scenes compile the
            # identical program and their goldens stay bitwise stable.
            _, u_b = rng.random_float(
                rng.seed_from(frame, rays["pixel"], slot, row_offset,
                              0xB1E2D))
            thresh = jnp.where(blend_tri,
                               jnp.clip(u_b, 1e-6, 1.0 - 1e-6), 0.5)
        is_pass = hit & is_tri & (cut_alpha < thresh)
        if fog_on:
            is_pass = is_pass & ~is_fog
        refl = jnp.where(is_pass, PASS, refl)

    # throughput *= color for materials except REFR/LIGHT (kernel.cu:375-377)
    mul_mask = hit & (refl != REFR) & (refl != LIGHT)
    if scene.has_rrefr:
        # rough glass colours through Beer-Lambert absorption like REFR
        mul_mask = mul_mask & (refl != RREFR)
    if scene.has_alpha_tex:
        mul_mask = mul_mask & (refl != PASS)
    if scene.has_ggx:
        # GGX (beyond-reference): obj_color is the conductor F0, applied
        # through the Fresnel term — not premultiplied into throughput
        mul_mask = mul_mask & (refl != GGX)
        is_ggx = hit & (refl == GGX)
        ggx_rough = jnp.where(is_sphere, srow[:, 11], rough_tri)
        ggx_alpha = ggx_rough * ggx_rough  # perceptual -> distribution
    direct = rays["direct"] * jnp.where(mul_mask[:, None], obj_color, 1.0)

    outside = dot(normal, d) < 0
    normal = jnp.where(outside[:, None], normal, -normal)  # kernel.cu:387
    o = o + normal * eps                                   # kernel.cu:390

    last_spec_in = rays["last_specular"]
    mis = cfg.mis == "on"
    pdf_in = rays["bsdf_pdf"] if mis else None
    color, direct = _shade_emitter_hit(
        cfg, scene, rays, d, normal, t_safe, hit, refl, refl_tri,
        color_tri, rough_tri, is_sphere, srow, trow, direct)

    # row_offset: per-shard stream decorrelation (see _raygen)
    seed = rng.seed_from(frame, rays["pixel"], slot, row_offset, 0x5ADE)

    use_sobol = cfg.sampler == "sobol"
    if use_sobol:
        # Low-discrepancy bounce dimensions (ops/sobol.py): each draw is
        # keyed by (pixel, bounce depth, purpose) and indexed by the ray's
        # per-pixel sample index, so path sample k of pixel p consumes
        # point k of one fixed Sobol sequence per integration dimension.
        # The phong rejection loop keeps the xorshift chain (a variable-
        # count rejection loop has no per-sample dimension assignment).
        from .ops import sobol as sobolmod
        s_idx = rays["sample_idx"]

        _salt = (cfg.seed,) if cfg.seed else ()

        def sob2(purpose):
            return sobolmod.sample_2d(s_idx, rng.seed_from(
                rays["pixel"], row_offset, rays["bounces"] * 16 + purpose,
                *_salt, 0x50B0))

        def sob1(purpose):
            return sobolmod.sample_1d(s_idx, rng.seed_from(
                rays["pixel"], row_offset, rays["bounces"] * 16 + purpose,
                *_salt, 0x50B0))
    else:
        sob1 = sob2 = None

    # env-NEE (see _shade_nee_samples): with MIS on, the sun-strategy
    # slot becomes environment-light NEE
    env_nee = mis and scene.has_envmap
    lights = getattr(scene, "light_indices", ())
    n_tri_l = scene.n_tri_lights
    n_delta = getattr(scene, "n_delta_lights", 0)
    (seed, sun_sample, sun_radiance_env, e_pdf, sun_cos, choose_sun,
     inv_p_sun, inv_p_light, has_light, delta_pick, n_lights, light_e,
     area, ldir, ldist, ldist2, cos_surf, cos_light, solid_angle) = \
        _shade_nee_samples(cfg, scene, sky_params, sun_dir, rays, o,
                           normal, frame, slot, row_offset, seed,
                           use_sobol, sob1, sob2, mis)

    (shadow_ok, shadow_dir, shadow_color, shadow_maxd, w_refl, pe,
     is_diff, is_phong, _bsdf_pdf_toward, p_sun_sa) = _shade_nee_weights(
        cfg, scene, sky_params, rays, d, o, normal, direct, hit, refl,
        is_sphere, is_fog if fog_on else None, obj_color,
        is_ggx if scene.has_ggx else None,
        ggx_alpha if scene.has_ggx else None, sun_dir, sun_sample,
        sun_radiance_env, e_pdf, sun_cos, choose_sun, inv_p_sun,
        inv_p_light, has_light, delta_pick, n_lights, light_e, area,
        ldir, ldist, ldist2, cos_surf, cos_light, solid_angle, mis)

    (seed, new_dir, direct, new_last_spec, next_bsdf_pdf, origin_out) = \
        _shade_bounce(cfg, scene, rays, d, o, normal, direct, hit, refl,
                      is_tri, is_sphere, srow, rough_tri, outside,
                      is_diff, is_phong, w_refl, pe,
                      is_ggx if scene.has_ggx else None,
                      ggx_alpha if scene.has_ggx else None, obj_color,
                      is_fog if fog_on else None,
                      is_pass if scene.has_alpha_tex else None, t_safe,
                      seed, use_sobol, sob1, sob2, frame, slot,
                      row_offset, mis, last_spec_in, pdf_in,
                      _bsdf_pdf_toward)

    # --- Russian roulette (kernel.cu:599-611) ---
    p = jnp.minimum(1.0, jnp.max(direct, axis=-1))
    if use_sobol:
        rr = sob1(8)
    else:
        seed, rr = rng.random_float(seed)
    survive = hit & (rays["bounces"] < cfg.max_bounces) & (p > eps) & (rr <= p)
    direct_out = jnp.where(survive[:, None],
                           direct / jnp.maximum(p, 1e-20)[:, None], direct)

    # --- miss: sky radiance (kernel.cu:613-617) ---
    if scene.has_envmap:
        # environment map replaces the analytic atmosphere on the miss
        # path (beyond-reference; 1 or 4 flat-row taps per ray).  With
        # env-NEE active, BSDF-sampled env hits get the reverse balance
        # weight (nearest-texel pdf, matching the alias sampler exactly);
        # delta-born rays (pdf 0) and specular history keep weight 1.
        miss_col = _sample_envmap(scene, d, cfg.texture_filter)
        if env_nee:
            pdf_env_dir = _env_pdf_nearest(scene, d)
            w_env = jnp.where(
                last_spec_in | (pdf_in <= 0.0), 1.0,
                pdf_in / jnp.maximum(
                    pdf_in + pdf_env_dir * (1.0 / inv_p_sun), 1e-12))
            miss_col = miss_col * w_env[:, None]
    else:
        sky_v, sunsky_v = skymod.sky_and_sunsky(d, sun_dir, sky_params)
        if mis:
            # sun-disc MIS: the NEE sun strategy cone-samples the disc, so
            # a BSDF ray that lands inside the cone gets the balance
            # weight; the sky dome outside the cone is BSDF-only (w = 1).
            in_cone = dot(d, sun_dir) > sky_params.sun_angular_diameter_cos
            w_sun = jnp.where(
                last_spec_in | ~in_cone | (pdf_in <= 0.0), 1.0,
                pdf_in / jnp.maximum(pdf_in + p_sun_sa, 1e-12))
            miss_col = sky_v + w_sun[:, None] * (sunsky_v - sky_v)
        else:
            miss_col = jnp.where(last_spec_in[:, None], sunsky_v, sky_v)
    color = color + jnp.where(hit[:, None], 0.0, rays["direct"] * miss_col)

    terminated = (~hit) | (hit & ~survive)

    next_rays = dict(origin=origin_out, direction=new_dir, direct=direct_out,
                     pixel=rays["pixel"], bounces=rays["bounces"] + 1,
                     last_specular=new_last_spec)
    if mis:
        next_rays["bsdf_pdf"] = next_bsdf_pdf
    if use_sobol:
        # a ray keeps its sample index for its whole path (dimensions are
        # distinguished by bounce depth, not by re-indexing)
        next_rays["sample_idx"] = rays["sample_idx"]
    shadow = dict(origin=o, direction=shadow_dir, color=shadow_color,
                  max_dist=shadow_maxd, valid=shadow_ok,
                  pixel=rays["pixel"])
    return color, terminated.astype(jnp.float32), survive, next_rays, shadow


# --------------------------------------------------------------------------
# connect — kernel.cu:630-646 / intersect_scene_simple kernel.cu:162-174
# --------------------------------------------------------------------------

def _connect(scene: SceneData, shadow, traversal: str = "xla"):
    o, sdir = shadow["origin"], shadow["direction"]
    maxd = jnp.where(shadow["valid"], shadow["max_dist"], 0.0)
    hit_fn = cuda_traverse.any_hit if traversal == "cuda" else any_hit
    occluded = hit_fn(o, sdir, maxd, scene.bvh, active=shadow["valid"])
    # sphere any-hit: (t + eps) < closestAllowed (kernel.cu:168-172)
    t_all = ray_sphere(o[:, None, :], sdir[:, None, :],
                       scene.sphere_center[None], scene.sphere_radius[None])
    sph_occ = jnp.any((t_all > 0.0) & ((t_all + EPSILON) < maxd[:, None]),
                      axis=1)
    occluded = occluded | sph_occ
    contrib = jnp.where((shadow["valid"] & ~occluded)[:, None],
                        shadow["color"], 0.0)
    return contrib


# --------------------------------------------------------------------------
# AOV pass (beyond-reference): noise-free feature buffers for denoising
# --------------------------------------------------------------------------

def render_aovs(scene: SceneData, camera: CameraParams, cfg: RenderConfig,
                traversal: str = "xla"):
    """One deterministic primary-ray pass -> {albedo, normal, depth}.

    Pixel-CENTER rays (no stratified jitter, no lens sampling), so the
    feature buffers are noise-free — exactly what an edge-stopping
    denoiser wants as guides (denoise.py).  Costs one extend pass per
    pose.  Returns [H, W, 3] albedo/normal and [H, W] depth (misses:
    sky albedo 1, normal 0, depth VERY_FAR)."""
    w, h = cfg.width, cfg.height
    p = w * h
    pix = jnp.arange(p, dtype=jnp.int32)
    x = (pix % w).astype(jnp.float32)
    y = (pix // w).astype(jnp.float32)
    # raygen subtracts the sub-pixel jitter from the integer coordinate
    # (px = x - u, the reference convention, kernel.cu:268-269), so pixel
    # (x, y)'s sample footprint is centred at (x-0.5, y-0.5) — the AOV
    # pass must sample THAT point or every guide buffer lands one pixel
    # diagonally off the accumulated image
    ni = (x - 0.5) / w - 0.5
    nj = (h - (y - 0.5)) / h - 0.5
    d, o_off, _live = _primary_dirs(cfg, camera, ni, nj)
    o = jnp.broadcast_to(camera.position[None], (p, 3)) if o_off is None \
        else camera.position[None] + o_off

    t, ident, is_tri = _intersect_scene(o, d, scene, traversal)
    hit = t < VERY_FAR
    t_safe = jnp.where(hit, t, 0.0)
    hp = o + d * t_safe[:, None]

    sid = jnp.clip(ident, 0, scene.sphere_center.shape[0] - 1)
    is_sphere = hit & ~is_tri
    stbl = scene.sphere_table
    srow = jnp.broadcast_to(stbl[0][None], (p, stbl.shape[1]))
    for s in range(1, stbl.shape[0]):
        srow = jnp.where((sid == s)[:, None], stbl[s][None], srow)
    normal_sphere = (hp - srow[:, 0:3]) / srow[:, 3][:, None]

    tid = jnp.clip(ident, 0, scene.tri_shade.shape[0] - 1)
    trow = scene.tri_shade[tid]
    normal_tri = trow[:, 0:3]
    color_tri = trow[:, 4:7]  # white for default-material scenes
    if scene.has_textures or scene.smooth_normals or scene.has_normal_maps:
        arow = scene.tri_attr[tid]
        p_rel = hp - arow[:, 0:3]
        bu = dot(p_rel, arow[:, 3:6])
        bv = dot(p_rel, arow[:, 6:9])
        if scene.has_textures or scene.has_normal_maps:
            uv_t = arow[:, 9:11] + bu[:, None] * arow[:, 11:13] \
                + bv[:, None] * arow[:, 13:15]
        if scene.has_textures:
            texid = arow[:, 15].astype(jnp.int32)
            alb = _sample_texture(
                scene, texid, uv_t[:, 0], uv_t[:, 1],
                "bilinear" if cfg.texture_filter == "trilinear"
                else cfg.texture_filter)
            color_tri = color_tri * jnp.where((texid >= 0)[:, None],
                                              alb, 1.0)
        if scene.smooth_normals:
            ns = arow[:, 16:19] + bu[:, None] * arow[:, 19:22] \
                + bv[:, None] * arow[:, 22:25]
            nlen = jnp.sqrt(jnp.maximum(dot(ns, ns), 1e-20))
            normal_tri = jnp.where((arow[:, 25] > 0.5)[:, None],
                                   ns / nlen[:, None], normal_tri)
        if scene.has_normal_maps:
            # mirror of the shade-time perturbation (so the denoiser's
            # normal AOV sees the mapped detail it should preserve)
            ntexid = arow[:, 26].astype(jnp.int32)
            nm = _sample_texture(
                scene, ntexid, uv_t[:, 0], uv_t[:, 1],
                "bilinear" if cfg.texture_filter == "trilinear"
                else cfg.texture_filter)
            n_ts = nm * 2.0 - 1.0
            tang = arow[:, 27:30]
            t_o = tang - normal_tri * dot(normal_tri, tang)[:, None]
            t_len = jnp.sqrt(jnp.maximum(dot(t_o, t_o), 1e-20))
            t_o = t_o / t_len[:, None]
            b_o = jnp.cross(normal_tri, t_o) * arow[:, 30:31]
            n_p = t_o * n_ts[:, 0:1] + b_o * n_ts[:, 1:2] \
                + normal_tri * jnp.maximum(n_ts[:, 2:3], 0.0)
            n_p = n_p / jnp.sqrt(jnp.maximum(dot(n_p, n_p), 1e-20))[:, None]
            apply_nm = (ntexid >= 0) & (t_len > 1e-6)
            normal_tri = jnp.where(apply_nm[:, None], n_p, normal_tri)

    normal = jnp.where(is_sphere[:, None], normal_sphere, normal_tri)
    outward = dot(normal, d) < 0
    normal = jnp.where(outward[:, None], normal, -normal)
    normal = jnp.where(hit[:, None], normal, 0.0)
    albedo = jnp.where(is_sphere[:, None], srow[:, 4:7], color_tri)
    albedo = jnp.where(hit[:, None], albedo, 1.0)
    return dict(albedo=albedo.reshape(h, w, 3),
                normal=normal.reshape(h, w, 3),
                depth=jnp.where(hit, t, VERY_FAR).reshape(h, w))


# --------------------------------------------------------------------------
# the full step
# --------------------------------------------------------------------------

def sentinel(p: int) -> int:
    """The first compaction sort key past every pixel of a [p, ·]
    framebuffer: terminated rays are keyed by their pixel (< p), survivors
    from here up."""
    return p


def accumulate_terminated(accum, key_s, sent, vals):
    """Add each terminated ray's update row (``vals`` [N, C]) into its
    pixel of ``accum`` [P, C]; rows keyed at or past ``sent`` (survivors)
    are dropped.  A plain XLA scatter-add: on the GPU it lowers to atomic
    adds, the reference's own mechanism (kernel.cu:622-625, 641-644), and
    in another order from run to run there."""
    idx = jnp.where(key_s < sent, key_s, accum.shape[0])
    return accum.at[idx].add(vals, mode="drop", indices_are_sorted=True)


def compaction_sort_key(next_rays, survive, node_packed, sent):
    """The one sort key that does queue compaction AND accumulation
    ordering: terminated rays sort first by pixel; survivors sort past the
    sentinel in octant-MAJOR order (all rays of one direction octant group
    together, sub-ordered by the 8^3 grid cell of the bounce origin), so
    neighbouring carried rays agree in direction and origin."""
    root_lo = node_packed[0, 0:3]
    root_hi = node_packed[0, 3:6]
    span = jnp.maximum(root_hi - root_lo, 1e-3)
    g = _KEY_GRID
    q = jnp.clip(((next_rays["origin"] - root_lo) / span * float(g))
                 .astype(jnp.int32), 0, g - 1)
    cell = (q[:, 0] * g + q[:, 1]) * g + q[:, 2]
    nneg = next_rays["direction"] < 0
    octant = (nneg[:, 0].astype(jnp.int32) + 2 * nneg[:, 1].astype(jnp.int32)
              + 4 * nneg[:, 2].astype(jnp.int32))
    return jnp.where(survive, sent + octant * (g ** 3) + cell,
                     next_rays["pixel"])


def render_step(state: RenderState, scene: SceneData, camera: CameraParams,
                sun_dir, *, cfg: RenderConfig,
                sky_params: skymod.SkyParams | None = None,
                local_height: int | None = None,
                row_offset=0, traversal: str = "xla",
                cam_prev: CameraParams | None = None) -> RenderState:
    """One wavefront iteration == one displayed frame of the reference
    (one bounce for every ray in flight + top-off raygen).  Pure function;
    jit with static cfg/local_height/traversal (see :class:`Renderer`).

    ``cam_prev``: previous-frame camera pose for motion blur
    (cfg.motion_blur > 0): each fresh ray samples a shutter time and sees
    a pose lerped between cam_prev and camera (beyond-reference)."""
    sky_params = sky_params or skymod.SkyParams(cfg.sky)
    local_height = cfg.height if local_height is None else local_height
    n = cfg.num_rays

    # 1. raygen top-off (kernel.cu:250-296): the TAIL slots
    # [n - n_carried, n) keep the carried survivors (the compaction sort
    # below naturally leaves them there), the front slots are fresh
    # primaries
    adaptive = cfg.adaptive_sampling == "on"
    if cfg.crop is not None:
        cx0, cy0, cw, ch = (int(v) for v in cfg.crop)
        if adaptive:
            raise ValueError("cfg.crop is incompatible with "
                             "adaptive_sampling='on'")
        if local_height != cfg.height:
            raise ValueError("cfg.crop is incompatible with the sharded "
                             "row-strip path")
        if not (0 <= cx0 and 0 <= cy0 and cw > 0 and ch > 0
                and cx0 + cw <= cfg.width and cy0 + ch <= cfg.height):
            raise ValueError(f"crop {cfg.crop} outside the "
                             f"{cfg.width}x{cfg.height} frame")
    if adaptive and state.pixel_perm.shape[0] != cfg.width * local_height:
        # fail fast at trace time (C12 policy): a [1]-dummy perm here means
        # the state predates adaptive mode (e.g. an old checkpoint loaded
        # into an adaptive-on renderer) — raygen would clamp every fresh
        # ray to pixel 0 and silently render black
        raise ValueError(
            f"adaptive_sampling='on' but state.pixel_perm has "
            f"{state.pixel_perm.shape[0]} entries (expected "
            f"{cfg.width * local_height}); re-init with init_state(cfg) or "
            "load the checkpoint with adaptive off")
    # cfg.seed decorrelates independent runs: every xorshift stream is
    # keyed by the frame counter, so a seed-salted frame re-keys them all
    # at once (seed=0 compiles the identical program — reference parity
    # and golden stability)
    frame_s = (state.frame if not cfg.seed
               else state.frame + jnp.uint32((cfg.seed * 2654435761)
                                             & 0xFFFFFFFF))
    gen = _raygen(cfg, camera, state.start_position, frame_s,
                  local_height, row_offset,
                  perm=state.pixel_perm if adaptive else None,
                  sample_base=state.sample_base, cam_prev=cam_prev)
    slot = jnp.arange(n, dtype=jnp.int32)
    keep = slot >= (n - state.n_carried)

    def merge(car, new):
        m = keep[:, None] if new.ndim == 2 else keep
        return jnp.where(m, car, new)

    rays = dict(
        origin=merge(state.origin, gen["origin"]),
        direction=merge(state.direction, gen["direction"]),
        direct=merge(state.direct, gen["direct"]),
        pending=merge(state.pending, gen["pending"]),
        pixel=merge(state.pixel, gen["pixel"]),
        bounces=merge(state.bounces, gen["bounces"]),
        last_specular=merge(state.last_specular, gen["last_specular"]),
    )
    if cfg.mis == "on":
        # fresh primaries are specular-born (pdf unused); carried rays
        # keep the pdf of the BSDF sample that produced them
        rays["bsdf_pdf"] = merge(state.bsdf_pdf,
                                 jnp.ones((n,), jnp.float32))
    if cfg.sampler == "sobol":
        rays["sample_idx"] = merge(state.sample_idx, gen["sample_idx"])
    # the generation index only advanced by the top-off amount
    # (set_wavefront_globals, kernel.cu:230-236)
    generated = n - state.n_carried
    total_local = _scan_total(cfg, local_height)
    start_next = (state.start_position + generated) % total_local
    # sobol sample-index bookkeeping: count completed round-robin passes
    sample_base_next = state.sample_base + (
        (state.start_position + generated) // total_local).astype(jnp.uint32)

    # 2. extend
    t, ident, is_tri = _intersect_scene(rays["origin"], rays["direction"],
                                        scene, traversal)

    # 3. shade
    color, terminated, survive, next_rays, shadow = _shade(
        cfg, scene, sky_params, sun_dir, rays, t, ident, is_tri, frame_s,
        row_offset=row_offset)

    # 4. connect
    shadow_contrib = _connect(scene, shadow, traversal)

    # 5+6. ONE sort does both queue-compaction and accumulation ordering
    # (replaces the reference's atomic write into ray_buffer_next +
    # atomicAdd accumulation, kernel.cu:607-608 / 622-625 / 641-644):
    #   * terminated rays sort FIRST, keyed by pixel -> their flushed
    #     radiance comes out pixel-sorted for the scatter-add below;
    #   * survivors sort LAST, keyed by (spatial cell of the bounce origin,
    #     direction octant) past the sentinel -> next step's carried rays
    #     stay position- AND direction-coherent (the dense analog of the
    #     reference's divergence-hiding work regrouping) and sit in the
    #     tail slots the next top-off expects.
    # A multi-operand lax.sort carries the payloads through the sort
    # instead of an argsort followed by one gather per array.
    contrib = color + shadow_contrib
    if cfg.radiance_clamp > 0.0:
        # firefly clamp: bound each bounce's contribution per channel
        # (biased-but-bounded; default off keeps reference semantics)
        contrib = jnp.minimum(contrib, cfg.radiance_clamp)
    pend = rays["pending"] + contrib

    p_local = cfg.width * local_height
    sent = sentinel(p_local)
    key = compaction_sort_key(next_rays, survive, scene.bvh.node_packed,
                              sent)
    # pixel (< 2^21) | bounces (<= 15) | lastSpecular packed in one column
    packed = (next_rays["pixel"] << 5) | (next_rays["bounces"] << 1) \
        | next_rays["last_specular"].astype(jnp.int32)
    o, d, dr = next_rays["origin"], next_rays["direction"], next_rays["direct"]
    sort_ops = [key, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                dr[:, 0], dr[:, 1], dr[:, 2], pend[:, 0], pend[:, 1],
                pend[:, 2], packed]
    if cfg.mis == "on":
        sort_ops.append(next_rays["bsdf_pdf"])
    if cfg.sampler == "sobol":
        sort_ops.append(next_rays["sample_idx"])
    sorted_ops = jax.lax.sort(tuple(sort_ops), num_keys=1)
    (key_s, ox, oy, oz, dx, dy, dz, r0, r1, r2, p0, p1, p2,
     packed_s) = sorted_ops[:14]
    extra = 14
    bsdf_pdf_s = state.bsdf_pdf
    if cfg.mis == "on":
        bsdf_pdf_s = sorted_ops[extra]
        extra += 1
    sample_idx_s = state.sample_idx
    if cfg.sampler == "sobol":
        sample_idx_s = sorted_ops[extra]
        extra += 1
    n_carried = jnp.sum(survive).astype(jnp.int32)

    # 7. flush terminated rays' pending radiance (+1 completed-path count)
    ones = jnp.ones_like(p0)
    accum = accumulate_terminated(state.accum, key_s, sent,
                                  jnp.stack([p0, p1, p2, ones], axis=1))
    if adaptive or cfg.track_variance == "on":
        # second-moment flush for the error estimate (adaptive.py and the
        # CLI's --until-noise convergence stop) — same sorted keys
        moment2 = accumulate_terminated(
            state.moment2, key_s, sent,
            jnp.stack([p0 * p0, p1 * p1, p2 * p2, ones], axis=1))
    else:
        moment2 = state.moment2

    return RenderState(
        accum=accum,
        origin=jnp.stack([ox, oy, oz], axis=1),
        direction=jnp.stack([dx, dy, dz], axis=1),
        direct=jnp.stack([r0, r1, r2], axis=1),
        pending=jnp.stack([p0, p1, p2], axis=1),
        pixel=packed_s >> 5,
        bounces=(packed_s >> 1) & 15,
        last_specular=(packed_s & 1).astype(bool),
        n_carried=n_carried,
        start_position=start_next.astype(jnp.int32),
        frame=state.frame + 1,
        shadow_rays=state.shadow_rays
        + jnp.sum(shadow["valid"]).astype(jnp.uint32),
        moment2=moment2,
        pixel_perm=state.pixel_perm,
        bsdf_pdf=bsdf_pdf_s,
        sample_base=sample_base_next,
        sample_idx=sample_idx_s,
    )


# canonical fused-chain length (Renderer.step): every multi-step request is
# decomposed into chains of this size + single steps, so the session only
# ever compiles TWO step programs regardless of the step counts callers ask
# for (a full render-step compile takes tens of seconds)
_CHAIN_LEN = 4


class Renderer:
    """Host-side convenience wrapper: jit cache, accumulation-reset on
    camera/sun movement (kernel.cu:688-718), framebuffer resolve."""

    def __init__(self, scene, cfg: RenderConfig = RenderConfig(),
                 sun_position=(0.05, 0.3), donate: bool = True):
        from .scene.scene import Scene
        self.cfg = cfg
        self.scene_host = scene if isinstance(scene, Scene) else None
        self.scene = scene.to_device() if isinstance(scene, Scene) else scene
        self.sky_params = skymod.SkyParams(cfg.sky)
        self.sun_position = tuple(sun_position)
        self.sun_dir = skymod.sun_direction_from_position(
            jnp.asarray(self.sun_position))
        self._last_pose = None
        self.traversal = traversal_for(jax.devices())
        base_step = partial(render_step, cfg=cfg, sky_params=self.sky_params,
                            traversal=self.traversal)
        if cfg.motion_blur > 0.0:
            # 5-arg convention: the previous-pose params ride along as a
            # traced argument (shutter interpolation in _raygen)
            def step(state, scene, cam, sun_dir, cam_prev):
                return base_step(state, scene, cam, sun_dir,
                                 cam_prev=cam_prev)
        else:
            def step(state, scene, cam, sun_dir):
                return base_step(state, scene, cam, sun_dir)
        self._step_fn = step
        self._donate = donate
        self._prev_cam = None
        self._step = jax.jit(step, donate_argnums=(0,) if donate else ())
        self._chain_cache = {}
        self._fuse = cfg.fuse_step_chains == "on" or (
            cfg.fuse_step_chains == "auto"
            and jax.default_backend() not in ("cpu",))
        self._adaptive = cfg.adaptive_sampling == "on"
        if self._adaptive:
            from .adaptive import PermScheduler
            self._sched = PermScheduler(cfg.adaptive_interval)
        self.state = init_state(cfg)

    def set_sun(self, sun_position):
        if tuple(sun_position) != self.sun_position:
            self.sun_position = tuple(sun_position)
            self.sun_dir = skymod.sun_direction_from_position(
                jnp.asarray(self.sun_position))
            self.state = reset_accumulation(self.state)

    def step(self, camera, n_steps: int = 1):
        pose = camera.pose_key()
        if self._last_pose is not None and pose != self._last_pose:
            self.state = reset_accumulation(self.state)
            # motion blur: the pose we just left becomes the shutter-open
            # pose for the new frame's interpolation
            self._prev_cam = self._last_cam
        self._last_pose = pose
        cam = camera.to_device(self.cfg)
        self._last_cam = cam  # for the denoiser's per-pose AOV pass
        mb = self.cfg.motion_blur > 0.0
        if mb and self._prev_cam is None:
            self._prev_cam = cam  # first frame: no motion yet
        extra = (self._prev_cam,) if mb else ()
        if self._fuse and n_steps >= _CHAIN_LEN:
            # Decompose into repeats of ONE canonical chain length plus
            # single-step remainder: at most two compiled programs ever.
            # A distinct lax.scan length is a distinct jit, so
            # step(cam, 25) then step(cam, 15) would otherwise compile
            # twice; longer chains only save already-pipelined dispatches.
            full, rem = divmod(n_steps, _CHAIN_LEN)
            for _ in range(full):
                self.state = self._chain(_CHAIN_LEN)(
                    self.state, self.scene, cam, self.sun_dir, *extra)
            n_steps_left = rem
        else:
            n_steps_left = n_steps
        for _ in range(n_steps_left):
            self.state = self._step(self.state, self.scene, cam,
                                    self.sun_dir, *extra)
        if self._adaptive:
            phase = self._sched.tick(n_steps)
            if phase is not None:
                from .adaptive import build_perm
                self.state = dataclasses.replace(
                    self.state,
                    pixel_perm=build_perm(self.state.accum,
                                          self.state.moment2,
                                          jnp.asarray(phase, jnp.float32),
                                          gamma=self.cfg.adaptive_gamma))
        return self.state

    def _chain(self, k: int):
        """One jitted lax.scan over k wavefront steps (cached per k;
        ``step`` only ever requests k == _CHAIN_LEN).  Removes k-1
        per-step dispatches and matches the k dispatched steps numerically
        (tests/test_render_state.py::test_fused_chain_matches_loop)."""
        fn = self._chain_cache.get(k)
        if fn is None:
            step = self._step_fn

            def chain(state, scene, cam, sun_dir, *extra):
                def body(s, _):
                    return step(s, scene, cam, sun_dir, *extra), None
                return jax.lax.scan(body, state, None, length=k)[0]

            fn = jax.jit(chain, donate_argnums=(0,) if self._donate else ())
            self._chain_cache[k] = fn
        return fn

    def radiance(self):
        """Linear HDR radiance mean [H, W, 3] f32 — no tonemap, no
        denoise.  The archival quantity for PFM/EXR export
        (utils/pfm.py); ``image()`` is the display resolve."""
        counts = jnp.maximum(self.state.accum[:, 3:4], 1e-8)
        return (self.state.accum[:, :3] / counts).reshape(
            self.cfg.height, self.cfg.width, 3)

    def image(self, denoise: bool | None = None):
        """Resolve the accumulation buffer to a display image.  With
        cfg.denoise="on" (or denoise=True) the radiance mean is filtered
        by the AOV-guided à-trous denoiser first (denoise.py); the
        accumulation buffer itself is untouched."""
        from .ops.tonemap import bloom, tonemap_image
        use_dn = (self.cfg.denoise == "on") if denoise is None else denoise
        use_dn = use_dn and getattr(self, "_last_cam", None) is not None
        mean = self.radiance()
        if use_dn:
            aovs = self._pose_aovs()
            from .denoise import atrous_denoise
            mean = atrous_denoise(mean, aovs["albedo"], aovs["normal"],
                                  aovs["depth"],
                                  iterations=self.cfg.denoise_iterations)
        if self.cfg.bloom_strength > 0.0:
            # display-only lens glare (linear-radiance bright pass);
            # the accumulation buffer / radiance() stay bloom-free
            mean = bloom(mean, self.cfg.bloom_strength,
                         self.cfg.bloom_threshold, self.cfg.bloom_radius)
        return tonemap_image(mean, self.cfg.tonemap, self.cfg.exposure)

    def noise_estimate(self) -> float:
        """Image-level convergence estimate: mean stabilized relative
        standard error of the per-pixel radiance means
        (adaptive.mean_relative_error).  Needs cfg.track_variance="on"
        or adaptive sampling; the CLI's --until-noise stop."""
        if self.state.moment2.shape[0] == 1:
            raise RuntimeError(
                "noise_estimate() needs per-pixel second moments: set "
                "track_variance='on' (or adaptive_sampling='on')")
        from .adaptive import mean_relative_error
        return float(mean_relative_error(self.state.accum,
                                         self.state.moment2))

    def aovs(self):
        """Deterministic primary-pass feature buffers for the last stepped
        pose: {albedo [H,W,3], normal [H,W,3], depth [H,W]} — the
        denoiser's guides (render_aovs), exposed for compositing/ML
        pipelines (CLI: ``render --aovs``)."""
        if getattr(self, "_last_cam", None) is None:
            raise RuntimeError("step() once before requesting AOVs "
                               "(they are rendered for the last pose)")
        return self._pose_aovs()

    def _pose_aovs(self):
        """Noise-free feature buffers, cached per camera pose."""
        cache = getattr(self, "_aov_cache", None)
        if cache is not None and cache[0] == self._last_pose:
            return cache[1]
        aovs = render_aovs(self.scene, self._last_cam, self.cfg,
                           self.traversal)
        self._aov_cache = (self._last_pose, aovs)
        return aovs
