"""Render configuration.

The reference keeps all of this as compile-time constants scattered across
translation units (variables.h:3-44, kernel.cu:14-16, sunsky.cuh:26-43,
bvh.h:76-84).  Here they live in one dataclass consumed by the CLI, the
Python API and the benchmark harness.  Fields that feed jitted
code are static Python values (they become compile-time constants under
``jax.jit`` exactly like the reference's ``constexpr``).
"""

from __future__ import annotations

import dataclasses
import math

PI = 3.1415926535897932
INV_PI = 1.0 / PI

# Reference: variables.h:14
EPSILON = 1e-3
# Reference: kernel.cu:15
VERY_FAR = 1e20


@dataclasses.dataclass(frozen=True)
class SkyConfig:
    """Atmosphere tunables.  Reference: sunsky.cuh:26-43."""

    sun_size_degrees: float = 1.5          # sunsky.cuh:26 (physical sun is 0.53)
    cutoff_angle: float = PI / 1.95        # sunsky.cuh:28
    steepness: float = 1.5                 # sunsky.cuh:29
    sky_factor: float = 1.0                # sunsky.cuh:30
    turbidity: float = 1.0                 # sunsky.cuh:31
    mie_coefficient: float = 0.005         # sunsky.cuh:32
    mie_directional_g: float = 0.80        # sunsky.cuh:33
    v: float = 4.0                         # sunsky.cuh:35 (Junge exponent)
    rayleigh_zenith_length: float = 8.4e3  # sunsky.cuh:38
    mie_zenith_length: float = 1.25e3      # sunsky.cuh:39
    sun_intensity: float = 1000.0          # sunsky.cuh:41
    primary_wavelengths: tuple = (680e-9, 550e-9, 450e-9)  # sunsky.cuh:43


@dataclasses.dataclass(frozen=True)
class BVHConfig:
    """SAH builder knobs.  Reference: bvh.h:76-84.

    Deviation: the reference uses traversal_cost = 1.0 (bvh.h:81).  4.0
    makes the builder prefer fatter leaves, which halves the node count:
    a node visit in the cascade (ops/traverse.py) costs a gathered row,
    the same as a packed leaf test.  Not re-measured for the CUDA
    kernels."""

    bucket_number: int = 14       # bvh.h:76
    # reference: 4 (bvh.h:78).  6 (== ops/traverse.LEAF_WIDTH) cuts the
    # node count ~30%
    max_prims_per_leaf: int = 6
    traversal_cost: float = 4.0   # reference: 1.0 (bvh.h:81)
    intersection_cost: float = 1.0  # bvh.h:84


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level render settings.

    Reference equivalents: resolution variables.h:6-10; queue size
    variables.h:44; bounce limit kernel.cu:16; epsilon variables.h:14.
    """

    width: int = 1920
    height: int = 1080
    # Number of path segments processed per wavefront step ("ray queue size").
    # The reference uses 2 * 1,048,576 (variables.h:44).
    num_rays: int = 2 * 1_048_576
    max_bounces: int = 5
    epsilon: float = EPSILON
    sky: SkyConfig = dataclasses.field(default_factory=SkyConfig)
    bvh: BVHConfig = dataclasses.field(default_factory=BVHConfig)
    # How the ImGui focal-distance slider is scaled (kernel.cu:286).
    focal_distance_scale: float = 3.0
    # pixel-visit order for raygen: "scan" (reference, kernel.cu:263) or
    # "tiled8" (8x8 screen tiles -> neighbouring rays traverse alike)
    raygen_order: str = "tiled8"
    # Fuse multi-step calls (Renderer.step(cam, k>1)) into one jitted
    # lax.scan over the RenderState carry: removes k-1 host->device
    # dispatches per chain.  "auto" = on for non-CPU backends, "on", "off".
    fuse_step_chains: str = "auto"
    # Adaptive sampling (beyond-reference): allocate raygen budget to
    # high-variance pixels.  "on" adds a per-pixel second-moment buffer
    # (flushed in the same pixel-sorted accumulation pass) and redirects
    # raygen through a priority permutation rebuilt every
    # ``adaptive_interval`` steps (adaptive.py).  Cost at 2M: one extra
    # accumulation (~15-25 ms/step) + a P-sort every interval.
    adaptive_sampling: str = "off"
    # steps between priority-permutation rebuilds
    adaptive_interval: int = 16
    # visit-allocation exponent: pixel i gets slots proportional to
    # (relative standard error)^gamma — 1.0 is the variance-optimal
    # n_i ∝ σ_i rule, 0.0 degenerates to uniform (adaptive.py)
    adaptive_gamma: float = 1.0
    # Tone-mapping operator for the framebuffer resolve: "reinhard" (the
    # reference's cl/(cl+1), kernel.cu:655) or "aces" (filmic fit —
    # beyond-reference production option); ``exposure`` pre-scales
    # radiance before the curve.
    tonemap: str = "reinhard"
    exposure: float = 1.0
    # Lens-glare bloom on the displayed image (beyond-reference;
    # ops/tonemap.bloom): bright-pass above ``bloom_threshold`` (linear
    # radiance), separable gaussian of pixel ``bloom_radius``, added back
    # x strength.  0.0 = off (the resolve is untouched); display-only —
    # the accumulation buffer and HDR export never include it.
    bloom_strength: float = 0.0
    bloom_threshold: float = 1.0
    bloom_radius: int = 12
    # Crop window (beyond-reference): raygen visits ONLY the
    # (x0, y0, w, h) pixel rectangle — region re-renders, and tiled
    # ultra-high-resolution renders (one crop pass per tile; pixels
    # outside stay at zero paths and resolve black).  None = full frame.
    # STATIC: changing the crop recompiles the step.  Incompatible with
    # adaptive_sampling and the sharded row-strip path (render.py raises).
    crop: tuple | None = None
    # Edge-aware à-trous denoiser for the displayed image
    # (beyond-reference; denoise.py): "on" runs one deterministic AOV
    # pass per pose (render.render_aovs) and filters the radiance mean
    # with albedo/normal/depth edge stops before tonemapping.  The
    # accumulation buffer itself is never touched — converged renders are
    # unaffected by toggling this.
    denoise: str = "off"
    denoise_iterations: int = 4
    # Texture filtering for scenes with albedo textures (beyond-reference,
    # scene/texture.py): "bilinear" = 4 atlas taps (4 row gathers/2M),
    # "nearest" = 1 tap, "trilinear" = mip-mapped 8 taps (two bilinear
    # levels blended by a ray-cone hit-distance LOD — kills distant-
    # texture shimmer at 2x the tap gather cost; opt-in).  No cost for
    # untextured scenes (the branch is compile-time dead).
    texture_filter: str = "bilinear"
    # Firefly suppression (production knob the reference lacks): clamp each
    # per-bounce radiance contribution (emission / sky / NEE, per channel)
    # to this value before accumulation.  0.0 = off (exact reference
    # semantics — the default; clamping introduces bounded bias in exchange
    # for bounded per-sample variance).
    radiance_clamp: float = 0.0
    # Multiple importance sampling (beyond-reference): balance-heuristic
    # weighting between NEE and BSDF sampling for area lights and the sun
    # disc, instead of the reference's lastSpecular double-count guard
    # (kernel.cu:393-401).  Same expected image for area lights, far lower
    # variance on glossy (PHONG/GGX) surfaces near emitters, and
    # BSDF-sampled paths recover emitter highlights NEE under-samples.
    # "off" keeps the reference estimator (golden-stable default).
    mis: str = "off"
    # Sample generator (beyond-reference).  "xorshift" = the reference's
    # per-ray Marsaglia stream (kernel.cu:23-65 semantics; golden-stable
    # default).  "sobol" = shuffled Owen-scrambled 2-D Sobol (ops/sobol.py):
    # pixel jitter, lens, NEE and bounce dimensions become low-discrepancy
    # per pixel, cutting low-sample-count noise at equal ray budget.  The
    # per-pixel sample index is derived from the round-robin raygen counter,
    # which the adaptive allocator's priority permutation repeats pixels
    # within — the two features are mutually exclusive by validation.
    sampler: str = "xorshift"
    # NEE light selection across multiple emitters (beyond-reference; the
    # reference has one hard-coded light, kernel.cu:421).  "uniform" picks
    # each sphere/triangle/delta light with equal probability (golden-stable
    # default, exact reference estimator for one light).  "power" picks
    # proportionally to per-light radiant power (SceneData.light_powers —
    # luminance x area, delta lights via a solid-angle heuristic): scenes
    # whose emitters differ by orders of magnitude stop spending half the
    # NEE budget on lights that contribute nothing.  The actual pick pdf
    # is a DEFENSIVE MIXTURE, 0.75 power + 0.25 uniform, so a light whose
    # power heuristic underestimates its real contribution (e.g. a faint
    # directional lighting a whole floor) keeps a bounded 1/pdf (max 4L)
    # instead of spraying fireflies.  Unbiased either way (the estimator
    # divides by the pick pdf); composes with cfg.mis.
    # Up to 64 lights the pick is an unrolled CDF compare chain (free);
    # above that it becomes one Vose alias-row gather per shaded ray
    # (SceneData.light_alias — the env-IS machinery, scene/envlight.py).
    light_sampling: str = "uniform"
    # Run decorrelation seed (beyond-reference; the reference's streams are
    # fixed functions of (frame, index), kernel.cu:258).  Non-zero values
    # salt every xorshift stream (via a frame offset) and every Sobol
    # scramble key, giving statistically independent renders for
    # variance studies / ensemble averaging.  0 (default) compiles the
    # identical program — goldens bitwise stable.
    seed: int = 0
    # Per-pixel variance tracking without adaptive raygen (beyond-
    # reference): "on" accumulates per-pixel second moments (one extra
    # dense accumulation pass, same keys) so callers can estimate
    # convergence — the CLI's ``--until-noise`` stop and
    # ``render_stats``-style dashboards.  Implied by adaptive_sampling.
    track_variance: str = "off"
    # Volumetric fog (beyond-reference): a homogeneous participating-medium
    # slab z in [fog_z_min, fog_z_max] (world z-up, like the atmosphere
    # model).  "on" adds unbiased free-flight distance sampling to every
    # path segment: a ray that collides inside the slab scatters at a
    # Henyey-Greenstein medium event (NEE to sun/lights from the scatter
    # point -> crepuscular "god rays" through BVH occluders) or is absorbed;
    # all NEE shadow rays pick up the slab transmittance.  sigma_s/sigma_a
    # are the scattering/absorption coefficients (1/world-unit); fog_g the
    # HG anisotropy.  Static gate: "off" compiles the identical program.
    fog: str = "off"
    fog_sigma_s: float = 0.02
    # Camera projection (beyond-reference; the reference is perspective-only,
    # kernel.cu:271-293): "perspective" (default, exact reference basis),
    # "fisheye" (equidistant fisheye, image circle inscribed in the image
    # height, ``fisheye_fov_degrees`` across the circle), "equirect"
    # (360x180 latitude-longitude panorama centred on the view direction),
    # "ortho" (parallel projection, ``ortho_height`` world units tall).
    # Depth of field composes with every mode: the focal point sits
    # focal_distance along each ray, lens offsets span the camera plane.
    projection: str = "perspective"
    fisheye_fov_degrees: float = 180.0
    ortho_height: float = 10.0
    # Motion blur (beyond-reference): shutter fraction of the inter-frame
    # camera motion each ray's shutter-time sample sweeps (0 = off — the
    # identical program compiles; 1 = full-frame blur).  The previous
    # distinct camera pose is the shutter-open pose (Renderer tracks it;
    # render_step takes it as ``cam_prev``).
    motion_blur: float = 0.0
    fog_sigma_a: float = 0.0
    fog_g: float = 0.0
    fog_z_min: float = -1e8
    fog_z_max: float = 1e8
    # Polygonal bokeh (beyond-reference): number of aperture blades for
    # depth of field (>= 3; 0 = the reference's circular concentric-disk
    # lens).  bokeh_rotation spins the iris (degrees).  Static gate.
    bokeh_blades: int = 0
    bokeh_rotation: float = 0.0
    # Spectral dispersion (beyond-reference): fractional per-channel glass
    # IOR spread eta_c = eta * (1 + dispersion * (c - 1)) for c = 0/1/2 =
    # R/G/B (blue bends more — normal dispersion).  A polychromatic path
    # hitting REFR glass stochastically collapses to one wavelength
    # channel (unbiased 3x one-hot), giving rainbow caustics and fringes.
    # 0 = off (static gate, identical program).  ~0.01-0.03 matches real
    # glasses; larger values exaggerate for effect.
    dispersion: float = 0.0
    # Exponential height falloff (1/world-unit): density(z) = sigma *
    # exp(-fog_falloff * z), so sigma_s/sigma_a are the coefficients at
    # z = 0 and density halves every ln(2)/fog_falloff units of altitude —
    # the standard "height fog" / aerial-haze profile.  Free-flight
    # sampling and NEE transmittance both use the closed-form optical
    # depth of the exponential profile (no ratio tracking needed), so the
    # estimator stays exactly unbiased.  0 keeps the homogeneous slab and
    # compiles the identical program (static gate).
    fog_falloff: float = 0.0

    def __post_init__(self):
        for field, allowed in (
                ("fuse_step_chains", ("auto", "on", "off")),
                ("texture_filter", ("bilinear", "nearest", "trilinear")),
                ("tonemap", ("reinhard", "aces")),
                ("denoise", ("on", "off")),
                ("adaptive_sampling", ("on", "off")),
                ("mis", ("on", "off")),
                ("sampler", ("xorshift", "sobol")),
                ("light_sampling", ("uniform", "power")),
                ("track_variance", ("on", "off")),
                ("projection", ("perspective", "fisheye", "equirect",
                                "ortho")),
                ("fog", ("on", "off"))):
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(f"unknown {field} {v!r}; expected one of "
                                 f"{allowed}")
        if self.sampler == "sobol" and self.adaptive_sampling == "on":
            raise ValueError(
                "sampler='sobol' requires adaptive_sampling='off': the "
                "low-discrepancy sample index assumes round-robin pixel "
                "visits, which the adaptive priority permutation repeats")
        if not 0 <= int(self.seed) < (1 << 31):
            raise ValueError("seed must be a non-negative 31-bit int")
        if self.fog_sigma_s < 0.0 or self.fog_sigma_a < 0.0:
            raise ValueError("fog coefficients must be >= 0")
        if not -0.999 <= self.fog_g <= 0.999:
            raise ValueError("fog_g must be in [-0.999, 0.999]")
        if self.fog_z_min >= self.fog_z_max:
            raise ValueError("fog_z_min must be < fog_z_max")
        if not math.isfinite(self.fog_falloff):
            raise ValueError("fog_falloff must be finite")
        # The closed-form exponential-height fog clamps its density
        # exponent to +-60 (render._fog_density_coeffs: exp(60) ~ 1e26 is
        # the f32 edge), so the advertised exact/unbiased estimator only
        # holds while |falloff * z| stays inside that range over the whole
        # slab.  Reject configs whose DENSE end exceeds the clamp instead
        # of silently saturating: the dense end is z_min for
        # falloff > 0 (density grows with depth), z_max for falloff < 0.
        if self.fog == "on" and self.fog_falloff > 0 \
                and self.fog_falloff * max(0.0, -self.fog_z_min) > 60.0:
            raise ValueError(
                f"fog_falloff * |fog_z_min| = "
                f"{self.fog_falloff * -self.fog_z_min:.0f} exceeds the "
                f"exponent clamp (60): density exp(-falloff*z) at the slab "
                f"floor is outside f32 range and the closed-form optical "
                f"depth would silently saturate — raise fog_z_min (e.g. "
                f"ground level) or lower fog_falloff")
        if self.fog == "on" and self.fog_falloff < 0 \
                and -self.fog_falloff * max(0.0, self.fog_z_max) > 60.0:
            raise ValueError(
                f"|fog_falloff| * fog_z_max = "
                f"{-self.fog_falloff * self.fog_z_max:.0f} exceeds the "
                f"exponent clamp (60): density at the slab ceiling is "
                f"outside f32 range — lower fog_z_max or |fog_falloff|")
        if self.bokeh_blades != 0 and self.bokeh_blades < 3:
            raise ValueError("bokeh_blades must be 0 (disk) or >= 3")
        if not 0.0 <= self.dispersion <= 0.5:
            raise ValueError("dispersion must be in [0, 0.5] (fractional "
                             "per-channel IOR spread)")
        if not 0.0 < self.fisheye_fov_degrees <= 360.0:
            raise ValueError("fisheye_fov_degrees must be in (0, 360]")
        if self.ortho_height <= 0.0:
            raise ValueError("ortho_height must be > 0")
        if not 0.0 <= self.motion_blur <= 1.0:
            raise ValueError("motion_blur must be in [0, 1]")
        if self.adaptive_interval < 1:
            raise ValueError("adaptive_interval must be >= 1")
        if self.adaptive_gamma < 0.0:
            raise ValueError("adaptive_gamma must be >= 0.0 "
                             "(0 = uniform allocation)")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def small_config(width: int = 512, height: int = 512, num_rays: int = 1 << 16,
                 max_bounces: int = 5, **kw) -> RenderConfig:
    """A CPU-test-sized config (the reference has no such thing; its
    resolution is a compile-time constant, variables.h:6-10).  Extra
    keyword arguments pass through to :class:`RenderConfig`."""
    return RenderConfig(width=width, height=height, num_rays=num_rays,
                        max_bounces=max_bounces, **kw)


def interactive_config(width: int = 1920, height: int = 1080,
                       num_rays: int = 1 << 17, **kw) -> RenderConfig:
    """The interactive fly-through preset: a progressive render loop whose
    camera moves every frame (accumulation resets -> every frame is
    coherent fresh primaries), so a small 128k wavefront keeps the frame
    time low.  Convergence-focused offline renders should keep
    ``RenderConfig``'s 2M default instead (bigger wavefronts amortise fixed
    step costs).  Extra keyword arguments pass through to
    :class:`RenderConfig`."""
    kw.setdefault("fuse_step_chains", "auto")
    kw.setdefault("max_bounces", 5)
    return RenderConfig(width=width, height=height, num_rays=num_rays,
                        **kw)
