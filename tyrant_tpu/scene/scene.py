"""Scene container: analytic spheres + triangle mesh + BVH, host and device.

Mirrors the reference split:
  * ``Scene::Load`` (Scene.cpp:3-68) — mesh import, Triangle{vert,e1,e2}
    edge form (Scene.cpp:39-45), per-tri AABBs (Scene.cpp:29-35), SAH BVH
    (Scene.cpp:53), device upload (Scene.cpp:55-65).
  * The 7 hard-coded ``__constant__`` spheres (kernel.cu:674-680) become a
    parameterised sphere list; the hard-coded light ``spheres[6]``
    (kernel.cu:421/561) becomes an explicit ``light_index`` — SURVEY.md §7
    flags the hard-coding as a quirk to parameterise.

The reference swaps y/z twice (Scene.cpp:9-12 after static_mesh.cpp:17),
a net identity — we perform no swap (SURVEY.md C4).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BVHConfig
from ..ops.traverse import BVHDevice
from . import ply
from .bvh import BVHArrays, build_bvh, bvh_stats

# Reflection types, kernel.cu:67-71.  GGX is beyond-reference: an
# importance-sampled rough-conductor microfacet BSDF (VNDF sampling,
# separable Smith; ops/sampling.py ggx_*) with per-surface roughness.
DIFF, SPEC, REFR, PHONG, LIGHT, GGX = 0, 1, 2, 3, 4, 5
# RREFR (beyond-reference): rough dielectric — "frosted glass".  The REFR
# Fresnel/TIR/Beer-Lambert math evaluated through a VNDF-sampled GGX
# microfacet instead of the geometric normal (render.py).  Ids 6/7 are
# reserved by the shade-level FOG/PASS pseudo-materials (render.py).
RREFR = 8


@dataclasses.dataclass
class Spheres:
    """Host-side analytic sphere list (kernel.cu:77-123)."""

    center: np.ndarray    # [S, 3] f32
    radius: np.ndarray    # [S] f32
    color: np.ndarray     # [S, 3] f32
    emission: np.ndarray  # [S, 3] f32
    refl: np.ndarray      # [S] i32 (DIFF/SPEC/REFR/PHONG/LIGHT/GGX)
    # perceptual roughness for GGX spheres (alpha = roughness^2);
    # ignored by the other material types.  None -> 0.3 everywhere.
    roughness: Optional[np.ndarray] = None  # [S] f32

    @classmethod
    def default_seven(cls) -> "Spheres":
        """The reference's Cornell-style arrangement, kernel.cu:674-680."""
        rows = [
            # radius, position,            color,            emission,  refl
            (16.5, (0, 40, 16.5), (1, 1, 1), (0, 0, 0), DIFF),
            (16.5, (40, 0, 16.5), (0.5, 0.5, 0.06), (0, 0, 0), REFR),
            (16.5, (-40, -50, 36.5), (0.6, 0.5, 0.4), (0, 0, 0), PHONG),
            (16.5, (-40, -50, 16.5), (0.6, 0.5, 0.4), (0, 0, 0), SPEC),
            (1e4, (0, 0, -1e4 - 20), (1, 1, 1), (0, 0, 0), DIFF),
            (20.0, (0, -80, 20), (1.0, 0.0, 0.0), (0, 0, 0), DIFF),
            (9.0, (0, -80, 120.0), (0.0, 1.0, 0.0), (3, 3, 3), LIGHT),
        ]
        return cls(
            center=np.array([r[1] for r in rows], np.float32),
            radius=np.array([r[0] for r in rows], np.float32),
            color=np.array([r[2] for r in rows], np.float32),
            emission=np.array([r[3] for r in rows], np.float32),
            refl=np.array([r[4] for r in rows], np.int32),
        )

    @property
    def count(self):
        return self.center.shape[0]


# Delta-light kinds (beyond-reference; the reference's only lights are the
# sun cone and emissive geometry, kernel.cu:410-448)
DL_POINT, DL_SPOT, DL_DIRECTIONAL = 0, 1, 2


@dataclasses.dataclass
class DeltaLights:
    """Zero-area analytic lights: point / spot / directional.

    Beyond-reference production light types.  Delta lights are reachable
    only through next-event estimation (a BSDF ray can never hit a
    measure-zero emitter), so they join the NEE light pick alongside the
    area lights with an MIS weight of 1.

    Units: ``intensity`` is radiant intensity (W/sr — radiance arrives as
    I/d^2) for point/spot lights, and plain irradiance on a perpendicular
    surface for directional lights.  ``direction`` points FROM the light
    INTO the scene (spot axis / directional travel direction).
    """

    kind: np.ndarray       # [L] i32 (DL_POINT/DL_SPOT/DL_DIRECTIONAL)
    position: np.ndarray   # [L, 3] f32 (unused for directional)
    direction: np.ndarray  # [L, 3] f32 (unused for point)
    intensity: np.ndarray  # [L, 3] f32
    cos_inner: np.ndarray  # [L] f32 (spot cone; 1.0 elsewhere)
    cos_outer: np.ndarray  # [L] f32

    @property
    def count(self):
        return int(self.kind.shape[0])

    @classmethod
    def from_specs(cls, specs) -> "DeltaLights":
        """Build from a list of dicts (the JSON scene-description form).

        Each spec: ``{"type": "point"|"spot"|"directional",
        "position": [x,y,z], "direction": [x,y,z], "intensity": [r,g,b],
        "inner_deg": a, "outer_deg": b}`` — position required for
        point/spot, direction for spot/directional, cone angles for spot
        (inner defaults to outer).
        """
        kinds, pos, dirs, inten, ci, co = [], [], [], [], [], []
        names = {"point": DL_POINT, "spot": DL_SPOT,
                 "directional": DL_DIRECTIONAL}
        for s in specs:
            t = s["type"]
            if t not in names:
                raise ValueError(f"unknown delta light type {t!r}")
            k = names[t]
            kinds.append(k)
            if k != DL_DIRECTIONAL and "position" not in s:
                raise ValueError(f"{t} light requires a position")
            if k != DL_POINT and "direction" not in s:
                raise ValueError(f"{t} light requires a direction")
            pos.append(s.get("position", (0.0, 0.0, 0.0)))
            d = np.asarray(s.get("direction", (0.0, 0.0, -1.0)), np.float64)
            n = np.linalg.norm(d)
            if k != DL_POINT and n < 1e-12:
                raise ValueError(f"{t} light direction must be non-zero")
            dirs.append(d / max(n, 1e-12))
            inten.append(s.get("intensity", (1.0, 1.0, 1.0)))
            if k == DL_SPOT:
                outer = float(s.get("outer_deg", 30.0))
                inner = float(s.get("inner_deg", outer))
                if not 0.0 < outer <= 90.0 or inner > outer:
                    raise ValueError(
                        "spot cone needs 0 < inner_deg <= outer_deg <= 90")
                ci.append(np.cos(np.radians(inner)))
                co.append(np.cos(np.radians(outer)))
            else:
                ci.append(1.0)
                co.append(1.0)
        return cls(kind=np.asarray(kinds, np.int32),
                   position=np.asarray(pos, np.float32).reshape(-1, 3),
                   direction=np.asarray(dirs, np.float32).reshape(-1, 3),
                   intensity=np.asarray(inten, np.float32).reshape(-1, 3),
                   cos_inner=np.asarray(ci, np.float32),
                   cos_outer=np.asarray(co, np.float32))

    def pack(self) -> np.ndarray:
        """[L, 12] device rows: kind, pos.xyz, dir.xyz, intensity.rgb,
        cos_inner, cos_outer (consumed by shade's NEE pick)."""
        out = np.zeros((self.count, 12), np.float32)
        out[:, 0] = self.kind.astype(np.float32)
        out[:, 1:4] = self.position
        out[:, 4:7] = self.direction
        out[:, 7:10] = self.intensity
        out[:, 10] = self.cos_inner
        out[:, 11] = self.cos_outer
        return out


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SceneData:
    """Device-resident scene pytree passed into jitted render steps.

    The reference passes ``Scene::GPUScene`` by value into kernels
    (Scene.h:5-7) and keeps spheres in ``__constant__`` memory
    (kernel.cu:123); here everything is a jnp leaf closed over by jit.

    Per-triangle materials: the reference stores ``Triangle::materialType``
    but never reads it — every triangle shades as white diffuse
    (loader.h:16, kernel.cu:380-384; SURVEY.md C7).  Here ``tri_refl`` /
    ``tri_color`` are honoured (defaults reproduce the reference).
    """

    bvh: BVHDevice
    sphere_center: jnp.ndarray
    sphere_radius: jnp.ndarray
    sphere_color: jnp.ndarray
    sphere_emission: jnp.ndarray
    sphere_refl: jnp.ndarray
    light_index: jnp.ndarray  # scalar i32: NEE area light (spheres[6] analog)
    tri_refl: jnp.ndarray     # [T+pad] i32 (leaf order)
    tri_color: jnp.ndarray    # [T+pad, 3] f32 (leaf order)
    # Shade-time fetch tables: everything shade needs per hit is packed
    # into ONE row per geometry kind, so a hit costs one gather:
    #   tri_shade  [T+pad, 8]: geometric normal.xyz (pre-normalised
    #       cross(e1,e2), kernel.cu:380-383), refl, color.rgb, roughness
    #   sphere_table [S, 12]: center.xyz, radius, color.rgb, emission.rgb,
    #       refl, roughness — fetched by a select chain, not a gather (XLA
    #       lowers tiny-table gathers at full gather cost)
    tri_shade: jnp.ndarray
    sphere_table: jnp.ndarray
    # Per-triangle attribute rows (beyond-reference: textures +
    # smooth vertex normals; scene/texture.py for the atlas design):
    #   tri_attr [T+pad, 32]: v0.xyz, s1.xyz, s2.xyz (dual basis of
    #       (e1, e2) — shade recovers barycentrics from the hit POINT with
    #       two dots instead of threading u/v through the traversal),
    #       uv0.uv, du1.uv, du2.uv, tex_id | n0.xyz, dn1.xyz, dn2.xyz,
    #       smooth-flag, pad.  ONE gather row per hit covers BOTH features.
    #   tex_data [N+1, 4]: the flat texel atlas (row 0 = white fallback)
    tri_attr: jnp.ndarray = None
    tex_data: jnp.ndarray = None
    # STATIC (pytree aux): indices of ALL emissive spheres.  The reference
    # hard-codes ``spheres[6]`` as the only NEE target (kernel.cu:421/561 —
    # its own TODO asks for a light array); shade samples one of these
    # uniformly per ray and weights by len(light_indices).  ``light_index``
    # above stays as the first entry (or -1) for the single-light fast path.
    light_indices: tuple = ()
    # STATIC (pytree aux): per-texture (offset, height, width) rows of the
    # atlas — a handful of compile-time constants folded into shade's select
    # chain (a gathered meta row would pay the full gather wall)
    tex_meta: tuple = ()
    # STATIC (pytree aux): tri_attr carries interpolated vertex normals
    smooth_normals: bool = False
    # STATIC (pytree aux): any triangle has an albedo texture / a
    # tangent-space normal map (beyond-reference).  Normal maps ride the
    # same atlas and attribute row: lane 26 = map id, 27:30 = the
    # UV-derived tangent, 30 = bitangent handedness.
    has_albedo_tex: bool = False
    has_normal_maps: bool = False
    # STATIC (pytree aux): any GGX triangle has a roughness texture
    # (MTL map_Pr; attr lane 31 = map id, red channel = perceptual
    # roughness, clamped like the scalar path)
    has_rough_maps: bool = False
    # STATIC (pytree aux): any albedo texture carries cutout alpha
    # (MTL map_d; atlas texel lane 3).  Shade treats alpha < 0.5 hits
    # as pass-through (the ray continues behind the surface next
    # step).  LIMITATION: shadow rays treat cutout geometry as opaque
    # (the any-hit kernel is alpha-blind) — the standard real-time
    # trade; documented in README
    has_alpha_tex: bool = False
    # STATIC (pytree aux): any triangle uses stochastic alpha BLEND
    # (glTF alphaMode BLEND / MTL constant d < 1): shade thresholds its
    # coverage alpha against a per-ray uniform instead of 0.5 — unbiased
    # over-compositing, one wavefront step per transparent layer.  Blend
    # triangles carry +16 on the tri_shade refl lane (zero extra gathers).
    has_blend: bool = False
    # STATIC (pytree aux): any triangle carries per-texel metalness
    # (glTF metallicRoughness B channel x metallicFactor, repacked into
    # channel 1 of the rough-map texel row): shade stochastically picks
    # the GGX conductor lobe with probability metalness, DIFF otherwise
    # (glTF appendix B mix(dielectric, metal, metalness)).  Flag rides
    # the tri_shade refl lane as +32.
    has_metal_maps: bool = False
    # STATIC (pytree aux): any REFR triangle carries a non-default glass
    # IOR (KHR_materials_ior / JSON "ior"): the tri_shade lane 7 — unused
    # by REFR (GGX reads it as roughness, LIGHT as area) — doubles as the
    # per-triangle eta; shade substitutes it for the reference's 1.2.
    has_var_ior: bool = False
    # Environment-map lighting (beyond-reference): equirectangular radiance
    # map replacing the analytic atmosphere on the miss path.  env_data is
    # the same flat-row layout as tex_data; env_meta = (height, width)
    # static aux ((): no envmap).  Env light reaches the image through BSDF
    # rays (unbiased); NEE keeps targeting the analytic lights.
    env_data: jnp.ndarray = None
    env_meta: tuple = ()
    # Env importance sampling (beyond-reference; scene/envlight.py): Vose
    # alias rows [H*W, 12] for one-gather NEE draws; env_data lane 3
    # carries the matching nearest-texel solid-angle pdf.  [1,12] dummy
    # without an envmap.  Consumed only when cfg.mis == "on".
    env_alias: jnp.ndarray = None
    # Emissive-triangle lights (beyond-reference: the reference's only NEE
    # target is a sphere, kernel.cu:421/561): per-light rows
    # [K_pad, 13] = v0.xyz, e1.xyz, e2.xyz, emission.rgb, area.  Dummy
    # [1, 13] zeros when none; count is STATIC aux.
    tri_lights: jnp.ndarray = None
    n_tri_lights: int = 0
    # STATIC flag: any GGX-typed surface in the scene.  Gates the GGX
    # shade terms at trace time so non-GGX scenes compile the identical
    # program as before (zero cost, goldens bitwise stable).
    has_ggx: bool = False
    # STATIC flag: any RREFR (rough-dielectric) surface — same static-gate
    # policy as has_ggx.
    has_rrefr: bool = False
    # Delta lights (beyond-reference; DeltaLights.pack rows [L_pad, 12]):
    # point / spot / directional emitters reachable only through NEE.
    # Dummy [1, 12] zeros when none; count is STATIC aux (zero count
    # compiles the identical program).
    delta_lights: jnp.ndarray = None
    n_delta_lights: int = 0
    # Per-light scalar power [n_lights] f32 (LEAF, not aux — an
    # emission-only scene edit must stay a leaf change so the compiled
    # step is reused) in shade's
    # pick order — sphere lights, emissive triangles, delta lights.
    # Drives cfg.light_sampling == "power": NEE picks a light
    # proportionally to these (pdfs traced from this array) and the MIS
    # emitter-hit side recomputes the same pick pdf from the hit row.
    # [1] zeros when the scene has no lights.
    light_powers: jnp.ndarray = None
    # Vose alias rows for the > 64-light power pick (one gather instead of
    # an unrolled CDF chain); [1, 4] dummy otherwise.  Host-built from the
    # power values (same shape for any emission set, so edits stay
    # recompile-free).
    light_alias: jnp.ndarray = None

    @property
    def has_envmap(self) -> bool:
        return len(self.env_meta) > 0

    @property
    def has_textures(self) -> bool:
        """Albedo textures present (gates the shade-time colour taps;
        normal maps are gated separately by ``has_normal_maps``)."""
        return self.has_albedo_tex

    def tree_flatten(self):
        return ((self.bvh, self.sphere_center, self.sphere_radius,
                 self.sphere_color, self.sphere_emission, self.sphere_refl,
                 self.light_index, self.tri_refl, self.tri_color,
                 self.tri_shade, self.sphere_table, self.tri_attr,
                 self.tex_data, self.env_data, self.tri_lights,
                 self.env_alias, self.delta_lights, self.light_alias,
                 self.light_powers),
                (self.light_indices, self.tex_meta,
                 self.smooth_normals, self.env_meta, self.n_tri_lights,
                 self.has_ggx, self.has_albedo_tex, self.has_normal_maps,
                 self.has_rough_maps, self.has_alpha_tex,
                 self.n_delta_lights, self.has_rrefr, self.has_blend,
                 self.has_metal_maps, self.has_var_ior))

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves[:11],
                   light_indices=aux[0], tex_meta=aux[1],
                   smooth_normals=aux[2], env_meta=aux[3],
                   n_tri_lights=aux[4], has_ggx=aux[5],
                   has_albedo_tex=aux[6], has_normal_maps=aux[7],
                   has_rough_maps=aux[8], has_alpha_tex=aux[9],
                   tri_attr=leaves[11], tex_data=leaves[12],
                   env_data=leaves[13], tri_lights=leaves[14],
                   env_alias=leaves[15], delta_lights=leaves[16],
                   n_delta_lights=aux[10], light_alias=leaves[17],
                   light_powers=leaves[18], has_rrefr=aux[11],
                   has_blend=aux[12], has_metal_maps=aux[13],
                   has_var_ior=aux[14])


@dataclasses.dataclass
class Scene:
    """Host-side scene: load, build, upload."""

    spheres: Spheres
    tri_vert: np.ndarray  # [T, 3] (original order)
    tri_e1: np.ndarray
    tri_e2: np.ndarray
    bvh: Optional[BVHArrays]
    stats: dict
    tri_refl: Optional[np.ndarray] = None   # [T] i32, default DIFF
    tri_color: Optional[np.ndarray] = None  # [T, 3] f32, default white
    tri_uv: Optional[np.ndarray] = None     # [T, 3, 2] per-corner texcoords
    tri_tex: Optional[np.ndarray] = None    # [T] i32 texture id, -1 = none
    textures: Optional[list] = None         # list of [H, W, 3] f32 linear
    tri_vn: Optional[np.ndarray] = None     # [T, 3, 3] per-corner normals
    envmap: Optional[np.ndarray] = None     # [H, W, 3] equirect radiance
    tri_rough: Optional[np.ndarray] = None  # [T] f32 GGX roughness
    tri_ntex: Optional[np.ndarray] = None   # [T] i32 normal-map id, -1=none
    tri_rtex: Optional[np.ndarray] = None   # [T] i32 rough-map id, -1=none
    tri_blend: Optional[np.ndarray] = None  # [T] bool stochastic alpha BLEND
    tri_metal: Optional[np.ndarray] = None  # [T] bool per-texel metalness
    tri_ior: Optional[np.ndarray] = None    # [T] f32 glass IOR (REFR tris)
    # per-texture (wrap_s, wrap_t) parallel to ``textures``: 0 repeat,
    # 1 clamp-to-edge, 2 mirrored repeat (glTF sampler modes).  None =
    # repeat everywhere (OBJ/MTL has no wrap concept).
    texture_wraps: Optional[list] = None
    delta_lights: Optional[DeltaLights] = None  # point/spot/directional

    @classmethod
    def load(cls, path: Optional[str] = None,
             spheres: Optional[Spheres] = None,
             bvh_cfg: BVHConfig = BVHConfig(),
             scale: float = 1.0,
             builder: str = "auto",
             envmap=None,
             delta_lights: Optional[DeltaLights] = None) -> "Scene":
        """Load a mesh (PLY) + spheres and build the BVH.

        ``path=None`` gives a spheres-only scene (the reference warns and
        continues without primitives, Scene.cpp:49-52).
        builder: "auto" (native C++ if available), "numpy", or "native".
        envmap: equirectangular radiance map — an image/.npy path (decoded
        via scene.texture.load_texture) or an [H, W, 3] array; replaces
        the analytic atmosphere on the miss path (beyond-reference).
        """
        if path is not None and path.endswith((".glb", ".gltf")):
            # glTF carries its own scene graph / materials / lights
            # (scene/gltf.py, beyond-reference); delegate and honour the
            # caller's envmap/spheres/delta-light overrides
            from .gltf import load_gltf_bundle
            sc = load_gltf_bundle(path, builder=builder, scale=scale,
                                  bvh_cfg=bvh_cfg).scene
            if isinstance(envmap, str):
                from .texture import load_texture
                envmap = load_texture(envmap)
            if envmap is not None:
                sc.envmap = envmap
            if spheres is not None:
                sc.spheres = spheres
            if delta_lights is not None:
                sc.delta_lights = delta_lights
            return sc
        spheres = spheres or Spheres.default_seven()
        if isinstance(envmap, str):
            from .texture import load_texture
            envmap = load_texture(envmap)
        if path is None:
            z = np.zeros((0, 3), np.float32)
            return cls(spheres, z, z, z, None, {"nodes": 0}, envmap=envmap,
                       delta_lights=delta_lights)
        if not os.path.exists(path):
            # degrade to a primitive-less scene with a warning, like the
            # reference (Scene.cpp:49-52 "No primitives found in scene")
            import sys
            print(f"warning: scene file {path!r} not found; "
                  "loading scene without mesh primitives", file=sys.stderr)
            z = np.zeros((0, 3), np.float32)
            return cls(spheres, z, z, z, None, {"nodes": 0}, envmap=envmap,
                       delta_lights=delta_lights)

        tri_uv = tri_tex = textures = tri_color = tri_vn = None
        tri_refl = tri_rough = tri_ntex = tri_rtex = tri_blend = None
        tri_metal = None
        if path.endswith(".obj"):
            # full OBJ record: UVs + MTL Kd/map_Kd/Pr/Pm/map_Kn + vn
            # (beyond-reference)
            from .obj import load_obj_scene
            m = load_obj_scene(path)
            vertices, faces = m.vertices, m.faces
            tri_uv, tri_tex, textures = m.uvs, m.tri_tex, m.textures
            tri_color = m.tri_color
            tri_vn = m.normals
            tri_refl, tri_rough = m.tri_refl, m.tri_rough
            tri_ntex = m.tri_ntex
            tri_rtex = m.tri_rtex
            tri_blend = m.tri_blend
            tri_metal = m.tri_metal
        elif path.endswith(".ply") and _ply_has_attrs(path):
            # vertex normals and/or colors present: the python loader
            # extracts them (the native fast path returns positions only).
            # Vertex colors — the standard scanned-mesh attribute — shade
            # as per-triangle mean albedo (flat: the 32-lane attr row has
            # no room for 9 more floats; at scan densities the difference
            # is sub-pixel)
            from .ply import load_ply_attrs
            vertices, faces, vnorm, vcol = load_ply_attrs(path)
            if vnorm is not None:
                tri_vn = vnorm[faces]  # [F, 3, 3]
            if vcol is not None:
                tri_color = vcol[faces].mean(axis=1).astype(np.float32)
        else:
            vertices, faces = load_mesh(path)
        vertices = vertices * np.float32(scale)  # Scene.cpp:14-16 unit-scale hook
        v0 = vertices[faces[:, 0]]
        v1 = vertices[faces[:, 1]]
        v2 = vertices[faces[:, 2]]
        # edge form, Scene.cpp:39-45
        tri_vert = v0
        tri_e1 = v1 - v0
        tri_e2 = v2 - v0
        tri_lo = np.minimum(np.minimum(v0, v1), v2)
        tri_hi = np.maximum(np.maximum(v0, v1), v2)

        bvh = _build(tri_lo, tri_hi, bvh_cfg, builder)
        stats = bvh_stats(bvh)
        stats["triangles"] = int(tri_vert.shape[0])
        return cls(spheres, tri_vert, tri_e1, tri_e2, bvh, stats,
                   tri_color=tri_color, tri_uv=tri_uv, tri_tex=tri_tex,
                   textures=textures, tri_vn=tri_vn, envmap=envmap,
                   tri_refl=tri_refl, tri_rough=tri_rough,
                   tri_ntex=tri_ntex, tri_rtex=tri_rtex,
                   tri_blend=tri_blend,
                   tri_metal=tri_metal,
                   delta_lights=delta_lights)

    @classmethod
    def from_triangles(cls, v0, v1, v2, spheres: Optional[Spheres] = None,
                       bvh_cfg: BVHConfig = BVHConfig(),
                       builder: str = "auto",
                       tri_refl=None, tri_color=None,
                       tri_uv=None, tri_tex=None, textures=None,
                       tri_vn=None, envmap=None, tri_rough=None,
                       tri_ntex=None, tri_rtex=None, tri_blend=None,
                       tri_metal=None, tri_ior=None, texture_wraps=None,
                       delta_lights: Optional[DeltaLights] = None) -> "Scene":
        """Build directly from triangle vertices [T,3] each.

        tri_refl [T] (DIFF/SPEC/REFR/PHONG) and tri_color [T,3] are optional
        per-triangle materials (default: white diffuse, the reference's
        hard-wired behaviour, kernel.cu:380-384).  tri_uv [T,3,2] +
        tri_tex [T] + textures (list of [H,W,3] f32) attach albedo
        textures (beyond-reference, scene/texture.py)."""
        spheres = spheres or Spheres.default_seven()
        v0 = np.asarray(v0, np.float32)
        v1 = np.asarray(v1, np.float32)
        v2 = np.asarray(v2, np.float32)
        tri_lo = np.minimum(np.minimum(v0, v1), v2)
        tri_hi = np.maximum(np.maximum(v0, v1), v2)
        bvh = _build(tri_lo, tri_hi, bvh_cfg, builder)
        stats = bvh_stats(bvh)
        stats["triangles"] = int(v0.shape[0])
        return cls(spheres, v0, v1 - v0, v2 - v0, bvh, stats,
                   tri_refl=None if tri_refl is None
                   else np.asarray(tri_refl, np.int32),
                   tri_color=None if tri_color is None
                   else np.asarray(tri_color, np.float32),
                   tri_uv=None if tri_uv is None
                   else np.asarray(tri_uv, np.float32),
                   tri_tex=None if tri_tex is None
                   else np.asarray(tri_tex, np.int32),
                   textures=textures,
                   tri_vn=None if tri_vn is None
                   else np.asarray(tri_vn, np.float32),
                   envmap=envmap,
                   tri_rough=None if tri_rough is None
                   else np.asarray(tri_rough, np.float32),
                   tri_blend=None if tri_blend is None
                   else np.asarray(tri_blend, bool),
                   tri_metal=None if tri_metal is None
                   else np.asarray(tri_metal, bool),
                   tri_ior=None if tri_ior is None
                   else np.asarray(tri_ior, np.float32),
                   texture_wraps=texture_wraps,
                   tri_ntex=None if tri_ntex is None
                   else np.asarray(tri_ntex, np.int32),
                   tri_rtex=None if tri_rtex is None
                   else np.asarray(tri_rtex, np.int32),
                   delta_lights=delta_lights)

    @classmethod
    def from_instances(cls, meshes, instances,
                       spheres: Optional[Spheres] = None,
                       bvh_cfg: BVHConfig = BVHConfig(),
                       builder: str = "auto", envmap=None,
                       delta_lights: Optional[DeltaLights] = None) -> "Scene":
        """Instanced scene (beyond-reference; the reference loads exactly
        one mesh, static_mesh.cpp:6).

        meshes: list of ``instancing.MeshAsset`` (or path strings, loaded
        via ``MeshAsset.load``).  instances: list of ``(mesh_id, transform)``
        with a [4,4] or [3,4] affine transform.  Instances are FLATTENED
        into world space and one BVH is built over the union (rationale
        in scene/instancing.py)."""
        from .instancing import MeshAsset, flatten_instances
        meshes = [MeshAsset.load(m) if isinstance(m, str) else m
                  for m in meshes]
        flat = flatten_instances(meshes, instances)
        s = cls.from_triangles(
            flat.v0, flat.v1, flat.v2, spheres=spheres, bvh_cfg=bvh_cfg,
            builder=builder, tri_refl=flat.tri_refl,
            tri_color=flat.tri_color, tri_uv=flat.tri_uv,
            tri_tex=flat.tri_tex, textures=flat.textures,
            tri_vn=flat.tri_vn, envmap=envmap, tri_rough=flat.tri_rough,
            tri_ntex=flat.tri_ntex, tri_rtex=flat.tri_rtex,
            tri_blend=flat.tri_blend,
            tri_metal=flat.tri_metal,
            tri_ior=flat.tri_ior,
            texture_wraps=flat.tex_wraps,
            delta_lights=delta_lights)
        s.stats["instances"] = len(instances)
        s.stats["unique_meshes"] = len(meshes)
        return s

    def to_device(self) -> SceneData:
        """Upload to device arrays (the Scene.cpp:55-65 analog)."""
        if self.bvh is None:
            # spheres-only: single degenerate leaf so traversal is a no-op
            from .bvh import pack_meta
            meta = pack_meta(np.zeros(1, np.int64), np.ones(1, np.int64),
                             np.zeros(1, np.int64))
            node = np.zeros((1, 8), np.float32)
            node[:, 0:3] = 1e10   # inverted bounds -> slab test always fails
            node[:, 3:6] = -1e10
            node[:, 6] = meta.view(np.float32)
            node[:, 7] = np.full(1, -1, np.int32).view(np.float32)
            bvh_dev = BVHDevice(
                node_packed=jnp.asarray(node),
                miss_flat=jnp.full((8,), -1, jnp.int32),
                tri_packed=jnp.zeros((4, 12), jnp.float32),
                leaf_packed=jnp.zeros((1, 9 * 6), jnp.float32))
            tri_refl = np.zeros(4, np.int32)
            tri_color = np.ones((4, 3), np.float32)
            tri_rough = np.full(4, 0.3, np.float32)
        else:
            bvh_dev = BVHDevice.from_host(self.bvh, self.tri_vert,
                                          self.tri_e1, self.tri_e2)
            t = self.tri_vert.shape[0]
            perm = self.bvh.perm
            refl = (np.zeros(t, np.int32) if self.tri_refl is None
                    else self.tri_refl)[perm]
            color = (np.ones((t, 3), np.float32) if self.tri_color is None
                     else self.tri_color)[perm]
            rough = (np.full(t, 0.3, np.float32) if self.tri_rough is None
                     else np.asarray(self.tri_rough, np.float32))[perm]
            pad = bvh_dev.tri_packed.shape[0] - t
            tri_refl = np.concatenate([refl, np.zeros(pad, np.int32)])
            tri_color = np.concatenate([color, np.ones((pad, 3), np.float32)])
            tri_rough = np.concatenate([rough, np.full(pad, 0.3, np.float32)])
        light_list = tuple(int(i)
                           for i in np.nonzero(self.spheres.refl == LIGHT)[0])
        light_idx = light_list[0] if light_list else -1

        tp = np.asarray(bvh_dev.tri_packed)
        cross = np.cross(tp[:, 3:6], tp[:, 6:9])
        norm = np.linalg.norm(cross, axis=1, keepdims=True)
        normal = np.where(norm > 0, cross / np.maximum(norm, 1e-30),
                          np.asarray([0.0, 0.0, 1.0], np.float32))
        tri_shade = np.zeros((tp.shape[0], 8), np.float32)
        tri_shade[:, 0:3] = normal
        tri_shade[:, 3] = tri_refl.astype(np.float32)
        blend = np.zeros(tp.shape[0], bool)
        if self.tri_blend is not None and self.bvh is not None \
                and np.asarray(self.tri_blend).any():
            tb = np.asarray(self.tri_blend, bool)[self.bvh.perm]
            blend[:tb.shape[0]] = tb
        metal = np.zeros(tp.shape[0], bool)
        if self.tri_metal is not None and self.bvh is not None \
                and np.asarray(self.tri_metal).any():
            tm = np.asarray(self.tri_metal, bool)[self.bvh.perm]
            metal[:tm.shape[0]] = tm
        tri_shade[:, 4:7] = tri_color
        # GGX perceptual roughness (clamped: alpha -> 0 degenerates D(h)
        # to a delta the estimator can't importance-sample stably)
        tri_shade[:, 7] = np.clip(tri_rough, 0.03, 1.0)
        # LIGHT triangles reuse lane 7 for their surface area (the MIS
        # emitter-hit pdf needs it; a triangle is never both LIGHT and GGX)
        is_lt = tri_refl == LIGHT
        if is_lt.any():
            tri_shade[is_lt, 7] = 0.5 * norm[is_lt, 0]
        # REFR triangles reuse lane 7 for their glass IOR (unused as
        # roughness there); read only under has_var_ior
        has_var_ior = False
        if self.tri_ior is not None and self.bvh is not None:
            ior_p = np.full(tp.shape[0], 1.2, np.float32)
            ti = np.asarray(self.tri_ior, np.float32)[self.bvh.perm]
            ior_p[:ti.shape[0]] = ti
            is_rf = tri_refl == REFR
            tri_shade[is_rf, 7] = ior_p[is_rf]
            has_var_ior = bool((is_rf & (np.abs(ior_p - 1.2) > 1e-6)).any())

        # texture atlas + per-triangle attribute rows (beyond-reference:
        # textures AND smooth vertex normals share one [T+pad, 32] gather
        # row; see texture.py for the one-gather-per-tap atlas design)
        has_atlas = (self.textures is not None and len(self.textures) > 0
                     and self.tri_uv is not None and self.bvh is not None)
        has_tex = has_atlas and self.tri_tex is not None \
            and (np.asarray(self.tri_tex) >= 0).any()
        has_nmap = has_atlas and self.tri_ntex is not None \
            and (np.asarray(self.tri_ntex) >= 0).any()
        has_rmap = has_atlas and self.tri_rtex is not None \
            and (np.asarray(self.tri_rtex) >= 0).any()
        has_smooth = self.tri_vn is not None and self.bvh is not None
        has_alpha = has_tex and any(
            im.shape[2] >= 4 and (np.asarray(im[:, :, 3]) < 1.0).any()
            for im in self.textures)
        # stochastic BLEND needs the cutout machinery (coverage alpha
        # taps); the +16 refl-lane flag (decoded in render._shade) is
        # written ONLY when the gate is on — a blend flag without alpha
        # textures must not corrupt the refl codes
        has_blend = bool(has_alpha and blend.any())
        if has_blend:
            tri_shade[:, 3] += 16.0 * blend
        # per-texel metalness needs the rough-map taps (metalness rides
        # channel 1 of the same texel row) AND the GGX shading branch —
        # a flag on a non-GGX triangle (e.g. a JSON material override)
        # drops per triangle, not scene-wide
        metal = metal & (tri_refl == GGX)
        has_metal = bool(has_rmap and metal.any())
        if has_metal:
            tri_shade[:, 3] += 32.0 * metal
        if has_tex or has_smooth or has_nmap or has_rmap:
            perm = self.bvh.perm
            e1 = self.tri_e1[perm].astype(np.float64)
            e2 = self.tri_e2[perm].astype(np.float64)
            d11 = np.sum(e1 * e1, axis=1)
            d22 = np.sum(e2 * e2, axis=1)
            d12 = np.sum(e1 * e2, axis=1)
            det = np.maximum(d11 * d22 - d12 * d12, 1e-30)
            s1 = (d22[:, None] * e1 - d12[:, None] * e2) / det[:, None]
            s2 = (d11[:, None] * e2 - d12[:, None] * e1) / det[:, None]
            t = self.tri_vert.shape[0]
            pad_n = bvh_dev.tri_packed.shape[0] - t
            attr = np.zeros((t + pad_n, 32), np.float32)
            attr[:t, 0:3] = self.tri_vert[perm]
            attr[:t, 3:6] = s1
            attr[:t, 6:9] = s2
            attr[:, 15] = -1.0
            attr[:, 26] = -1.0
            attr[:, 31] = -1.0
            if has_tex or has_nmap or has_rmap:
                from .texture import TextureAtlas
                # mips=True: the box pyramid rides after every base image
                # (base offsets untouched — nearest/bilinear programs and
                # goldens are bitwise unaffected; texture.py).  It funds
                # cfg.texture_filter="trilinear" without a scene reload,
                # at +1/3 atlas memory.
                atlas = TextureAtlas.pack(self.textures, mips=True)
                uv = np.asarray(self.tri_uv, np.float32)[perm]  # [T, 3, 2]
                attr[:t, 9:11] = uv[:, 0]
                attr[:t, 11:13] = uv[:, 1] - uv[:, 0]
                attr[:t, 13:15] = uv[:, 2] - uv[:, 0]
                if has_tex:
                    attr[:t, 15] = np.asarray(self.tri_tex, np.int32)[perm]
                tex_data = jnp.asarray(atlas.data)
                wraps = (self.texture_wraps
                         if self.texture_wraps is not None
                         else [(0, 0)] * len(atlas.meta))
                # entry layout: (off, h, w, wrap_s, wrap_t, mip_chain) —
                # mip_chain = per-LEVEL (off, h, w), level 0 first
                tex_meta = tuple(
                    (int(o), int(h), int(w),
                     int(wraps[k][0]), int(wraps[k][1]),
                     tuple((int(mo), int(mh), int(mw))
                           for (mo, mh, mw) in atlas.mip_meta[k]))
                    for k, (o, h, w) in enumerate(atlas.meta))
            else:
                tex_data = jnp.ones((1, 4), jnp.float32)
                tex_meta = ()
            if has_nmap:
                # tangent-space normal maps (beyond-reference): the
                # UV-derived tangent T = (dv2*e1 - dv1*e2)/det and the
                # bitangent handedness are packed per triangle; shade
                # orthonormalises T against the (possibly smooth) shading
                # normal and builds B = cross(N, T) * handedness.
                # Degenerate UV parameterisations disable the map (-1).
                du1 = (uv[:, 1] - uv[:, 0]).astype(np.float64)
                du2 = (uv[:, 2] - uv[:, 0]).astype(np.float64)
                det_uv = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
                ok_uv = np.abs(det_uv) > 1e-12
                inv = 1.0 / np.where(ok_uv, det_uv, 1.0)
                tang = (du2[:, 1:2] * e1 - du1[:, 1:2] * e2) * inv[:, None]
                bitan = (du1[:, 0:1] * e2 - du2[:, 0:1] * e1) * inv[:, None]
                tlen = np.linalg.norm(tang, axis=1)
                ok_uv &= tlen > 1e-12
                tang = tang / np.maximum(tlen, 1e-30)[:, None]
                geo_n = np.cross(e1, e2)
                handed = np.where(
                    np.sum(np.cross(geo_n, tang) * bitan, axis=1) >= 0.0,
                    1.0, -1.0)
                ntex = np.asarray(self.tri_ntex, np.int32)[perm]
                attr[:t, 26] = np.where(ok_uv, ntex, -1)
                attr[:t, 27:30] = tang.astype(np.float32)
                attr[:t, 30] = handed.astype(np.float32)
            if has_rmap:
                attr[:t, 31] = np.asarray(self.tri_rtex, np.int32)[perm]
            if has_smooth:
                vn = np.asarray(self.tri_vn, np.float32)[perm]  # [T, 3, 3]
                ok = (np.linalg.norm(vn, axis=2) > 1e-8).all(axis=1)
                attr[:t, 16:19] = vn[:, 0]
                attr[:t, 19:22] = vn[:, 1] - vn[:, 0]
                attr[:t, 22:25] = vn[:, 2] - vn[:, 0]
                attr[:t, 25] = ok.astype(np.float32)
            tri_attr = jnp.asarray(attr)
        else:
            tri_attr = jnp.zeros((4, 32), jnp.float32)
            tex_data = jnp.ones((1, 4), jnp.float32)
            tex_meta = ()

        # emissive-triangle light table (beyond-reference): LIGHT-typed
        # triangles become NEE targets; they emit their tri_color
        if self.tri_refl is not None and self.bvh is not None \
                and (np.asarray(self.tri_refl) == LIGHT).any():
            lm = np.asarray(self.tri_refl) == LIGHT
            lv0 = self.tri_vert[lm]
            le1 = self.tri_e1[lm]
            le2 = self.tri_e2[lm]
            lem = (np.ones((lm.sum(), 3), np.float32)
                   if self.tri_color is None else
                   np.asarray(self.tri_color, np.float32)[lm])
            if self.textures is not None and self.tri_tex is not None:
                # texture-modulated emitters (emissiveTexture / Ke +
                # map_Kd): NEE and the power table integrate the
                # texture's MEAN so both MIS strategies agree on total
                # emitted power; direct hits show the per-texel detail.
                # (Exact per-point NEE would need UVs in the light rows
                # — documented approximation.)
                tt = np.asarray(self.tri_tex)[lm]
                means = np.asarray(
                    [t[:, :, :3].reshape(-1, 3).mean(0)
                     for t in self.textures], np.float32)
                lem = lem * np.where((tt >= 0)[:, None],
                                     means[np.clip(tt, 0, len(means) - 1)],
                                     1.0)
            larea = 0.5 * np.linalg.norm(np.cross(le1, le2), axis=1)
            tl = np.concatenate(
                [lv0, le1, le2, lem, larea[:, None]], axis=1)
            tri_lights = jnp.asarray(tl.astype(np.float32))
            n_tri_lights = int(lm.sum())
        else:
            tri_lights = jnp.zeros((1, 13), jnp.float32)
            n_tri_lights = 0

        if self.envmap is not None:
            from .envlight import env_tables
            em = np.asarray(self.envmap, np.float32)
            eh, ew = em.shape[0], em.shape[1]
            env_rows = np.ones((eh * ew + 1, 4), np.float32)
            env_rows[1:, :3] = em[:, :, :3].reshape(eh * ew, 3)
            # importance-sampling tables (envlight.py): lane 3 = the
            # nearest-texel solid-angle pdf; alias rows for NEE draws
            pdf_sa, alias_rows = env_tables(em)
            env_rows[0, 3] = 0.0
            env_rows[1:, 3] = pdf_sa
            env_data = jnp.asarray(env_rows)
            env_alias = jnp.asarray(alias_rows)
            env_meta = (float(eh), float(ew))
        else:
            env_data = jnp.ones((1, 4), jnp.float32)
            env_alias = jnp.zeros((1, 12), jnp.float32)
            env_meta = ()

        if self.delta_lights is not None and self.delta_lights.count:
            delta_rows = jnp.asarray(self.delta_lights.pack())
            n_delta = self.delta_lights.count
        else:
            delta_rows = jnp.zeros((1, 12), jnp.float32)
            n_delta = 0

        # Per-light scalar powers, in shade's pick order (sphere lights,
        # emissive triangles, delta lights) — the CDF behind
        # cfg.light_sampling == "power" (beyond-reference: the reference
        # has exactly one hard-coded light, kernel.cu:421).  All terms in
        # f32 so shade's hit-side MIS pdf (recomputed from the same device
        # rows) matches the NEE-side values.  Delta-light powers use a
        # solid-angle heuristic (point 4pi, spot = cone solid angle,
        # directional 1): any positive weight keeps the estimator unbiased,
        # the heuristic only steers variance.
        from .envlight import LUM_RGB
        _lum = LUM_RGB
        powers = []
        for li in light_list:
            em32 = np.asarray(self.spheres.emission[li], np.float32)
            r32 = np.float32(self.spheres.radius[li])
            powers.append(float(np.float32(em32 @ _lum)
                                * np.float32(4.0 * np.pi) * r32 * r32))
        if n_tri_lights:
            tl32 = tl.astype(np.float32)
            for k in range(n_tri_lights):
                powers.append(float(np.float32(tl32[k, 9:12] @ _lum)
                                    * tl32[k, 12]))
        if n_delta:
            dl = np.asarray(self.delta_lights.pack(), np.float32)
            for k in range(n_delta):
                lum = float(dl[k, 7:10] @ _lum)
                kind = dl[k, 0]
                if kind == 0.0:                    # point
                    sa = 4.0 * np.pi
                elif kind == 1.0:                  # spot: cone solid angle
                    sa = 2.0 * np.pi * (1.0 - 0.5 * (dl[k, 10] + dl[k, 11]))
                else:                              # directional
                    sa = 1.0
                powers.append(lum * sa)
        light_powers = jnp.asarray(
            np.asarray(powers if powers else [0.0], np.float32))
        # Many-light power selection (> 64 lights): the unrolled CDF
        # compare chain in shade stops scaling, so the pick becomes ONE
        # Vose alias-row gather (same machinery as env importance
        # sampling, scene/envlight.py).  Row = [keep-prob, alias index,
        # 1/pdf(self), 1/pdf(alias)] so the draw resolves coin -> light ->
        # estimator weight from a single fetched row.  Shape depends only
        # on the light COUNT (zero total power degrades to uniform rows),
        # so emission edits never change the pytree structure.
        total_p = float(np.sum(np.asarray(powers, np.float64)))
        if len(powers) > 64:
            from .envlight import build_alias
            L = len(powers)
            if total_p > 0.0:
                # defensive mixture (must match render._shade's CDF and
                # MIS hit-side formulas exactly): a pure power pdf gives
                # a light whose heuristic underestimates its real
                # contribution (e.g. a dim-looking directional that lights
                # the whole floor) a near-zero pick probability and hence
                # unbounded 1/pdf spikes — fireflies.  25% uniform bounds
                # every weight at 4L.
                p = (0.75 * np.asarray(powers, np.float64) / total_p
                     + 0.25 / L)
            else:
                p = np.full(L, 1.0 / L)
            prob, alias = build_alias(p)
            inv = np.where(p > 0, 1.0 / np.maximum(p, 1e-300), 0.0)
            la = np.zeros((len(powers), 4), np.float32)
            la[:, 0] = prob
            la[:, 1] = alias
            la[:, 2] = inv
            la[:, 3] = inv[alias]
            light_alias = jnp.asarray(la)
        else:
            light_alias = jnp.zeros((1, 4), jnp.float32)

        s = self.spheres
        sphere_table = np.zeros((s.count, 12), np.float32)
        sphere_table[:, 0:3] = s.center
        sphere_table[:, 3] = s.radius
        sphere_table[:, 4:7] = s.color
        sphere_table[:, 7:10] = s.emission
        sphere_table[:, 10] = s.refl.astype(np.float32)
        sphere_table[:, 11] = np.clip(
            np.full(s.count, 0.3, np.float32) if s.roughness is None
            else np.asarray(s.roughness, np.float32), 0.03, 1.0)
        if s.count == 0:
            # zero-sphere scene (e.g. glTF, scene/gltf.py): shade's select
            # chain broadcasts row 0, so keep ONE inert row (radius 1
            # avoids a masked /0 in normal_sphere); extend and NEE
            # statically skip the sphere pass on the 0-length leaves
            sphere_table = np.zeros((1, 12), np.float32)
            sphere_table[0, 3] = 1.0
            sphere_table[0, 11] = 0.3
        has_ggx = bool((s.refl == GGX).any() or (tri_refl == GGX).any())
        has_rrefr = bool((s.refl == RREFR).any()
                         or (tri_refl == RREFR).any())

        return SceneData(
            bvh=bvh_dev,
            sphere_center=jnp.asarray(self.spheres.center),
            sphere_radius=jnp.asarray(self.spheres.radius),
            sphere_color=jnp.asarray(self.spheres.color),
            sphere_emission=jnp.asarray(self.spheres.emission),
            sphere_refl=jnp.asarray(self.spheres.refl),
            light_index=jnp.asarray(light_idx, jnp.int32),
            tri_refl=jnp.asarray(tri_refl),
            tri_color=jnp.asarray(tri_color),
            tri_shade=jnp.asarray(tri_shade),
            sphere_table=jnp.asarray(sphere_table),
            tri_attr=tri_attr,
            tex_data=tex_data,
            light_indices=light_list,
            tex_meta=tex_meta,
            smooth_normals=has_smooth,
            has_albedo_tex=has_tex,
            has_normal_maps=has_nmap,
            has_rough_maps=has_rmap,
            has_alpha_tex=has_alpha,
            has_blend=has_blend,
            has_metal_maps=has_metal,
            has_var_ior=has_var_ior,
            env_data=env_data,
            env_alias=env_alias,
            env_meta=env_meta,
            tri_lights=tri_lights,
            n_tri_lights=n_tri_lights,
            has_ggx=has_ggx,
            has_rrefr=has_rrefr,
            delta_lights=delta_rows,
            n_delta_lights=n_delta,
            light_powers=light_powers,
            light_alias=light_alias,
        )


def _ply_has_attrs(path: str) -> bool:
    """Header sniff: vertex normals OR colors (either routes the load
    through the python attribute loader instead of the native fast path)."""
    try:
        with open(path, "rb") as f:
            head = f.read(4096)
        head = head[:head.find(b"end_header") + 1 or None]
        return b" nx" in head or b" red" in head
    except OSError:
        return False


def load_mesh(path: str):
    """Dispatch on extension; PLY covers the bundled assets."""
    if path.endswith(".ply"):
        try:
            from ..native import ply_native
            return ply_native.load_ply(path)
        except Exception:
            return ply.load_ply(path)
    if path.endswith(".obj"):
        from .obj import load_obj
        return load_obj(path)
    if path.endswith(".stl"):
        from .stl import load_stl
        return load_stl(path)
    raise ValueError(f"unsupported mesh format: {path}")


def _build(tri_lo, tri_hi, cfg: BVHConfig, builder: str) -> BVHArrays:
    if builder in ("auto", "native"):
        try:
            from ..native import bvh_native
            return bvh_native.build_bvh(tri_lo, tri_hi, cfg)
        except Exception:
            if builder == "native":
                raise
    return build_bvh(tri_lo, tri_hi, cfg)
