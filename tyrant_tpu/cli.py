"""Headless CLI: render to PNG, benchmark, BVH debug heatmap.

The reference has no headless mode — its only run mode is the interactive
GLFW window (main.cpp) with compile-time switches PERFORMANCE_TEST
(main.cpp:7) and BVH_DEBUG (kernel.cu:12).  Here those become subcommands.

Usage:
  python -m tyrant_tpu.cli render  --scene dragon.ply --steps 200 --out x.png
  python -m tyrant_tpu.cli bench   --scene dragon.ply --json
  python -m tyrant_tpu.cli bvh-debug --scene dragon.ply --out heat.png
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np


def _add_common(p):
    p.add_argument("--scene", default=None,
                   help="mesh path (.ply/.obj/.stl) or a .json scene "
                        "description (meshes+instances+spheres+camera+fog, "
                        "scene/description.py); omit for spheres-only")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--rays", type=int, default=2 * 1_048_576,
                   help="wavefront size (reference: variables.h:44)")
    p.add_argument("--bounces", type=int, default=5)
    p.add_argument("--no-spheres", action="store_true",
                   help="drop the 7 default spheres")
    p.add_argument("--sun", type=float, nargs=2, default=(0.05, 0.3))
    p.add_argument("--camera", type=float, nargs=5, metavar=("X", "Y", "Z", "H", "V"),
                   default=None, help="position + horizontal/vertical angles")
    p.add_argument("--scale", type=float, default=1.0, help="mesh unit scale")
    p.add_argument("--lens-radius", type=float, default=0.0,
                   help="DoF aperture radius, world units (0 = pinhole; "
                        "the reference's LensRadius slider)")
    p.add_argument("--focal-distance", type=float, default=None,
                   help="world distance to the focus plane (the "
                        "reference's FocalDistance slider carries a 3x "
                        "scale, kernel.cu:286 — this flag is the real "
                        "distance)")
    p.add_argument("--focus-at", type=float, nargs=2, default=None,
                   metavar=("FX", "FY"),
                   help="autofocus: image-fraction point (0-1 from the "
                        "top-left) whose primary-hit depth sets the focus "
                        "plane (overrides --focal-distance; pair with "
                        "--lens-radius)")
    p.add_argument("--bokeh-blades", type=int, default=0,
                   help="polygonal aperture blade count for DoF bokeh "
                        "(>= 3; 0 = circular lens)")
    p.add_argument("--bokeh-rotation", type=float, default=0.0,
                   help="aperture rotation in degrees")
    p.add_argument("--clamp", type=float, default=0.0,
                   help="firefly clamp: per-bounce radiance bound (0 = off)")
    p.add_argument("--denoise", action="store_true",
                   help="edge-aware a-trous denoise of the displayed "
                        "image (AOV-guided, denoise.py)")
    p.add_argument("--tonemap", default="reinhard",
                   choices=["reinhard", "aces"])
    p.add_argument("--exposure", default="1.0",
                   help="radiance scale before the tonemap curve, or "
                        "'auto' (photographic key: log-average luminance "
                        "-> middle grey)")
    p.add_argument("--bloom", type=float, default=0.0,
                   help="lens-glare bloom strength on the displayed "
                        "image (0 = off; display-only, HDR export is "
                        "untouched)")
    p.add_argument("--bloom-threshold", type=float, default=1.0,
                   help="linear-radiance bright-pass threshold")
    p.add_argument("--bloom-radius", type=int, default=12,
                   help="bloom gaussian radius in pixels (sigma = r/2)")
    p.add_argument("--envmap", default=None,
                   help="equirect environment map (png/jpg/npy) replacing "
                        "the analytic sun/sky on the miss path")
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive sampling: direct the ray budget at "
                        "high-variance pixels (adaptive.py)")
    p.add_argument("--mis", action="store_true",
                   help="multiple importance sampling: balance-heuristic "
                        "NEE/BSDF weighting (lower variance on glossy "
                        "surfaces near emitters)")
    p.add_argument("--sampler", default="xorshift",
                   choices=["xorshift", "sobol"],
                   help="sample generator: reference-style xorshift "
                        "streams, or shuffled Owen-scrambled Sobol "
                        "(lower noise at equal ray budget)")
    p.add_argument("--seed", type=int, default=0,
                   help="run-decorrelation seed: non-zero salts every "
                        "sample stream (independent renders for variance "
                        "studies); 0 keeps the reference streams")
    p.add_argument("--light-sampling", default="uniform",
                   choices=["uniform", "power"],
                   help="NEE light selection across multiple emitters: "
                        "equal probability, or proportional to per-light "
                        "radiant power (helps scenes whose lights differ "
                        "by orders of magnitude)")
    p.add_argument("--dispersion", type=float, default=0.0,
                   help="spectral glass dispersion: fractional per-channel "
                        "IOR spread (rainbow caustics; ~0.01-0.03 real, "
                        "0 = off)")
    p.add_argument("--fog", action="store_true",
                   help="volumetric fog: homogeneous scattering slab with "
                        "free-flight sampling + HG phase (god rays)")
    p.add_argument("--fog-scatter", type=float, default=0.02,
                   help="fog scattering coefficient sigma_s (1/world-unit)")
    p.add_argument("--fog-absorb", type=float, default=0.0,
                   help="fog absorption coefficient sigma_a")
    p.add_argument("--fog-g", type=float, default=0.0,
                   help="HG phase anisotropy in (-1, 1); >0 forward-scatters")
    p.add_argument("--fog-falloff", type=float, default=0.0,
                   help="exponential height falloff (1/world-unit): "
                        "density = sigma * exp(-falloff * z); 0 = uniform")
    p.add_argument("--fog-z", type=float, nargs=2, default=(-1e8, 1e8),
                   metavar=("ZMIN", "ZMAX"),
                   help="fog slab height bounds (world z-up)")
    p.add_argument("--projection", default="perspective",
                   choices=["perspective", "fisheye", "equirect", "ortho"],
                   help="camera projection: reference perspective, "
                        "equidistant fisheye, 360 lat-long panorama, or "
                        "orthographic")
    p.add_argument("--fisheye-fov", type=float, default=180.0,
                   help="fisheye field of view across the image circle "
                        "(degrees)")
    p.add_argument("--ortho-height", type=float, default=10.0,
                   help="orthographic frame height (world units)")
    p.add_argument("--shutter", type=float, default=0.0,
                   help="motion-blur shutter fraction of the inter-frame "
                        "camera motion (0 = off, 1 = full-frame blur; "
                        "pairs with 'anim')")
    p.add_argument("--texture-filter", default="bilinear",
                   choices=["bilinear", "nearest", "trilinear"],
                   help="albedo texture filtering (textured OBJ scenes); "
                        "trilinear adds mip-mapped distance LOD")
    p.add_argument("--crop", type=int, nargs=4, default=None,
                   metavar=("X0", "Y0", "CW", "CH"),
                   help="render only this pixel rectangle (region "
                        "re-renders / tiled high-res; the rest of the "
                        "frame stays black)")
    p.add_argument("--builder", default="auto",
                   choices=["auto", "numpy", "native"])


def _build(args):
    from .camera import Camera
    from .config import RenderConfig
    from .scene.scene import Scene, Spheres

    bundle = None
    if args.scene and args.scene.endswith(".json"):
        from .scene.description import load_description
        bundle = load_description(args.scene, builder=args.builder)
    elif args.scene and args.scene.endswith((".glb", ".gltf")):
        # glTF 2.0 (scene/gltf.py): full graph — instances, PBR materials,
        # punctual lights, and the file's camera (overridden by --camera)
        from .scene.gltf import load_gltf_bundle
        bundle = load_gltf_bundle(args.scene, builder=args.builder,
                                  scale=args.scale)
    if bundle is not None and getattr(args, "envmap", None):
        # bundle scenes (JSON/glTF) can't thread --envmap through
        # Scene.load; apply the override directly
        from .scene.texture import load_texture
        bundle.scene.envmap = load_texture(args.envmap)

    cfg = RenderConfig(width=args.width, height=args.height,
                       num_rays=args.rays, max_bounces=args.bounces,
                       radiance_clamp=getattr(args, "clamp", 0.0),
                       adaptive_sampling="on" if getattr(args, "adaptive",
                                                         False) else "off",
                       texture_filter=getattr(args, "texture_filter",
                                              "bilinear"),
                       tonemap=getattr(args, "tonemap", "reinhard"),
                       exposure=(1.0 if str(getattr(args, "exposure", 1.0))
                                 == "auto"
                                 else float(getattr(args, "exposure", 1.0))),
                       crop=(tuple(args.crop)
                             if getattr(args, "crop", None) else None),
                       bloom_strength=getattr(args, "bloom", 0.0),
                       bloom_threshold=getattr(args, "bloom_threshold", 1.0),
                       bloom_radius=getattr(args, "bloom_radius", 12),
                       denoise="on" if getattr(args, "denoise", False)
                       else "off",
                       mis="on" if getattr(args, "mis", False) else "off",
                       sampler=getattr(args, "sampler", "xorshift"),
                       light_sampling=getattr(args, "light_sampling",
                                              "uniform"),
                       seed=getattr(args, "seed", 0),
                       track_variance="on"
                       if getattr(args, "until_noise", None) is not None
                       else "off",
                       projection=getattr(args, "projection", "perspective"),
                       fisheye_fov_degrees=getattr(args, "fisheye_fov",
                                                   180.0),
                       ortho_height=getattr(args, "ortho_height", 10.0),
                       motion_blur=getattr(args, "shutter", 0.0),
                       dispersion=getattr(args, "dispersion", 0.0),
                       bokeh_blades=getattr(args, "bokeh_blades", 0),
                       bokeh_rotation=getattr(args, "bokeh_rotation", 0.0),
                       fog="on" if getattr(args, "fog", False) else "off",
                       fog_sigma_s=getattr(args, "fog_scatter", 0.02),
                       fog_sigma_a=getattr(args, "fog_absorb", 0.0),
                       fog_g=getattr(args, "fog_g", 0.0),
                       fog_falloff=getattr(args, "fog_falloff", 0.0),
                       fog_z_min=getattr(args, "fog_z", (-1e8, 1e8))[0],
                       fog_z_max=getattr(args, "fog_z", (-1e8, 1e8))[1])
    if bundle is not None:
        # JSON render/fog settings apply wherever the CLI left a flag at
        # its default; explicitly-passed (non-default) flags win
        import dataclasses as _dc
        ref = RenderConfig(width=cfg.width, height=cfg.height,
                           num_rays=cfg.num_rays)
        cfg = _dc.replace(cfg, **{
            f: v for f, v in bundle.config.items()
            if getattr(cfg, f) == getattr(ref, f)})
        scene = bundle.scene
    else:
        spheres = None
        if args.no_spheres:
            s = Spheres.default_seven()
            # keep only the light so NEE still has a target
            keep = s.refl == 4
            spheres = Spheres(center=s.center[keep], radius=s.radius[keep],
                              color=s.color[keep], emission=s.emission[keep],
                              refl=s.refl[keep])
        scene = Scene.load(args.scene, spheres=spheres, scale=args.scale,
                           builder=args.builder,
                           envmap=getattr(args, "envmap", None))
    print(f"scene: {scene.stats}", file=sys.stderr)
    cam = (bundle.camera if bundle is not None
           and bundle.camera is not None else Camera())
    if args.camera:
        cam.position = np.asarray(args.camera[:3], np.float32)
        cam.horizontal_angle, cam.vertical_angle = args.camera[3:]
    if bundle is not None and bundle.sun is not None \
            and tuple(args.sun) == (0.05, 0.3):
        args.sun = bundle.sun
    if getattr(args, "lens_radius", 0.0):
        cam.lens_radius = float(args.lens_radius)
    if getattr(args, "focal_distance", None):
        # the flag is the world distance; the camera field is the
        # reference's slider value (x cfg.focal_distance_scale at raygen)
        cam.focal_distance = float(args.focal_distance) \
            / cfg.focal_distance_scale
    return cfg, scene, cam


def _autofocus(renderer, cam, cfg, fx: float, fy: float) -> None:
    """Set cam.focal_distance from the primary-hit depth at image
    fraction (fx, fy) — one deterministic AOV pass (render.render_aovs).
    A sky pixel leaves the focal distance unchanged (warning)."""
    from .render import VERY_FAR, render_aovs

    aovs = render_aovs(renderer.scene, cam.to_device(cfg), cfg,
                       renderer.traversal)
    px = min(max(int(fx * cfg.width), 0), cfg.width - 1)
    py = min(max(int(fy * cfg.height), 0), cfg.height - 1)
    d = float(aovs["depth"][py, px])
    if d >= VERY_FAR:
        print(f"warning: --focus-at ({fx}, {fy}) hits the sky; "
              "focal distance unchanged", file=sys.stderr)
        return
    cam.focal_distance = d / cfg.focal_distance_scale
    print(f"autofocus: depth {d:.3f} at pixel ({px}, {py})",
          file=sys.stderr)


def cmd_render(args):
    from .ops.tonemap import to_uint8
    from .render import Renderer

    import jax.numpy as jnp

    cfg, scene, cam = _build(args)
    if getattr(args, "look_at", None) is not None:
        cam.look_at(args.look_at)
    r = Renderer(scene, cfg, sun_position=tuple(args.sun))
    if getattr(args, "focus_at", None) is not None:
        _autofocus(r, cam, cfg, *args.focus_at)

    # checkpoint/resume (long renders; SURVEY.md §5 — the reference loses
    # its accumulation on exit).  Resume is EXACT: the carried rays, RNG
    # counters and accumulation come back bit-for-bit.
    ck = getattr(args, "checkpoint", None)
    done = 0
    if ck and os.path.exists(ck):
        from .checkpoint import load_state
        st, meta = load_state(ck)
        if int(st.accum.shape[0]) != cfg.num_pixels \
                or int(st.origin.shape[0]) != cfg.num_rays:
            raise SystemExit(
                f"checkpoint {ck!r} was written at "
                f"{meta.get('width')}x{meta.get('height')} / "
                f"{meta.get('rays')} rays; pass the same --width/--height/"
                f"--rays to resume")
        if meta.get("pose") is not None:
            if args.camera is None:
                # adopt the checkpointed camera
                cam.position = np.asarray(meta["pose"][:3], np.float32)
                cam.horizontal_angle, cam.vertical_angle = meta["pose"][3:5]
            elif [round(float(v), 5) for v in meta["pose"]] != \
                    [round(float(v), 5) for v in
                     (*cam.position, cam.horizontal_angle,
                      cam.vertical_angle)]:
                raise SystemExit(
                    f"checkpoint {ck!r} holds pose {meta['pose']}; "
                    "resuming with a different --camera would mix "
                    "accumulations (omit --camera to adopt the saved pose)")
        r.state = st
        done = int(meta.get("steps", 0))
        print(f"resumed {ck} at step {done}", file=sys.stderr)

    def save_ck():
        from .checkpoint import save_state
        save_state(ck, r.state, metadata=dict(
            steps=done, width=cfg.width, height=cfg.height,
            rays=cfg.num_rays, sun=list(args.sun),
            pose=[float(v) for v in (*cam.position, cam.horizontal_angle,
                                     cam.vertical_angle)]))
        print(f"  checkpoint -> {ck} (step {done})", file=sys.stderr)

    every = getattr(args, "checkpoint_every", 0)
    t0 = time.time()
    while done < args.steps:
        chunk = min(args.steps - done, 25)
        if ck and every > 0:
            chunk = min(chunk, every - done % every or every)
        r.step(cam, chunk)
        done += chunk
        float(jnp.sum(r.state.accum[:, 3]))  # hard sync (see bench harness)
        el = time.time() - t0
        noise = ""
        if args.until_noise is not None:
            nz = r.noise_estimate()
            noise = f"  noise {nz:.4f}"
        print(f"  step {done}/{args.steps}  {el:.1f}s "
              f"({done * cfg.num_rays / el / 1e6:.1f} Mseg/s){noise}",
              file=sys.stderr)
        if ck and every > 0 and done % every == 0 and done < args.steps:
            save_ck()
        if args.until_noise is not None and noise \
                and nz <= args.until_noise:
            print(f"  converged: noise {nz:.4f} <= {args.until_noise}",
                  file=sys.stderr)
            break
    if ck:
        save_ck()
    if str(getattr(args, "exposure", 1.0)) == "auto":
        import dataclasses as _dc

        from .ops.tonemap import auto_exposure
        ex = auto_exposure(r.radiance())
        r.cfg = _dc.replace(r.cfg, exposure=ex)
        print(f"  auto exposure: {ex:.3f}", file=sys.stderr)
    img = np.asarray(to_uint8(r.image()))
    _write_png(args.out, img)
    print(f"wrote {args.out}", file=sys.stderr)
    if args.hdr:
        _write_hdr(args.hdr, np.asarray(r.radiance()))
        print(f"wrote {args.hdr} (linear radiance)", file=sys.stderr)
    if getattr(args, "aovs", None):
        # deterministic feature buffers (denoiser guides) for
        # compositing/ML: albedo + normal as PNG, exact depth as .npy
        aovs = r.aovs()
        base = args.aovs
        if getattr(args, "aov_format", "png") == "exr":
            # production compositing path: float AOVs (normals keep their
            # sign, depth keeps exact f32)
            from .utils.exr import write_exr
            write_exr(base + "_albedo.exr", np.asarray(aovs["albedo"]))
            write_exr(base + "_normal.exr", np.asarray(aovs["normal"]))
            dep = np.asarray(aovs["depth"], np.float32)
            write_exr(base + "_depth.exr",
                      np.repeat(dep[:, :, None], 3, axis=2), half=False)
            print(f"wrote {base}_albedo.exr/_normal.exr/_depth.exr",
                  file=sys.stderr)
        else:
            alb = np.asarray(jnp.clip(aovs["albedo"], 0.0, 1.0))
            _write_png(base + "_albedo.png", (alb * 255).astype(np.uint8))
            nrm = np.asarray(aovs["normal"]) * 0.5 + 0.5
            _write_png(base + "_normal.png",
                       (np.clip(nrm, 0.0, 1.0) * 255).astype(np.uint8))
            np.save(base + "_depth.npy", np.asarray(aovs["depth"]))
            print(f"wrote {base}_albedo.png/_normal.png/_depth.npy",
                  file=sys.stderr)


def cmd_anim(args):
    """Render a camera-path animation to a PNG frame sequence
    (beyond-reference; pairs with --shutter for motion blur — each
    frame's blur sweeps the pose segment it just traversed)."""
    from .ops.tonemap import to_uint8
    from .render import Renderer

    import jax.numpy as jnp

    cfg, scene, cam = _build(args)
    r = Renderer(scene, cfg, sun_position=tuple(args.sun))
    if getattr(args, "focus_at", None) is not None:
        # autofocus once, at the path's start pose (a per-frame re-focus
        # would pump the focus plane through the sweep)
        _autofocus(r, cam, cfg, *args.focus_at)
    os.makedirs(args.out, exist_ok=True)
    n = max(args.frames, 1)
    base_pos = cam.position.copy()
    base_h = cam.horizontal_angle
    center = np.asarray(args.orbit_center, np.float32)
    move = np.asarray(args.move, np.float32)
    t0 = time.time()
    for f in range(n):
        u = f / max(n - 1, 1)
        if args.orbit != 0.0:
            # orbit about the world z axis through --orbit-center; the
            # camera keeps its bearing relative to the center (position
            # rotated CCW by a <=> horizontal_angle -= a, camera.py
            # spherical convention d=(cv*sh, cv*ch, sv))
            a = math.radians(args.orbit) * u
            c, s = math.cos(a), math.sin(a)
            rel = base_pos - center
            cam.position = np.array(
                [c * rel[0] - s * rel[1] + center[0],
                 s * rel[0] + c * rel[1] + center[1],
                 rel[2] + center[2]], np.float32) + move * u
            cam.horizontal_angle = base_h - a
        else:
            cam.position = base_pos + move * u
        if args.look_at is not None:
            cam.look_at(args.look_at)
        if args.sun_to is not None:
            # animated sun: linear sweep of the (azimuth-ish, elevation)
            # sun_position pair across the animation (a timelapse; each
            # change resets the accumulation, like the reference's -/+
            # sun keys, main.cpp:143-151)
            s0, s1 = np.asarray(args.sun, np.float64), \
                np.asarray(args.sun_to, np.float64)
            r.set_sun(tuple(s0 + (s1 - s0) * u))
        r.step(cam, args.steps)
        float(jnp.sum(r.state.accum[:, 3]))  # sync (bench-harness pattern)
        if f == 0 and str(getattr(args, "exposure", 1.0)) == "auto":
            # key the photographic exposure off the FIRST frame only and
            # hold it for the whole sequence — a per-frame key would pump
            # brightness as the camera sweeps (flicker)
            import dataclasses as _dc
            from .ops.tonemap import auto_exposure
            ex = auto_exposure(r.radiance())
            r.cfg = _dc.replace(r.cfg, exposure=ex)
            print(f"  auto exposure (frame 0, held): {ex:.3f}",
                  file=sys.stderr)
        img = np.asarray(to_uint8(r.image()))
        path = os.path.join(args.out, f"frame_{f:04d}.png")
        _write_png(path, img)
        el = time.time() - t0
        print(f"  frame {f + 1}/{n}  {el:.1f}s", file=sys.stderr)
    print(f"wrote {n} frames to {args.out}/", file=sys.stderr)


def cmd_bench(args):
    from .bench import results_to_dict, run_benchmark
    from .bench.harness import write_performance_txt

    if str(getattr(args, "exposure", 1.0)) == "auto":
        # bench never resolves an image, so an exposure key would be
        # computed from nothing — refuse instead of silently rendering
        # the shared flag meaningless
        sys.exit("--exposure auto is not meaningful for 'bench' "
                 "(no image is resolved); pass a numeric exposure")
    cfg, scene, _ = _build(args)
    results = run_benchmark(scene, cfg, seconds_per_pose=args.seconds)
    d = results_to_dict(results)
    if args.txt:
        write_performance_txt(results, args.txt)
    if args.json:
        print(json.dumps(d))
    else:
        for r in d["poses"]:
            print(f"pose {r['pose']}: {r['avg_ms']:.2f} ms avg "
                  f"({r['fps']:.1f} FPS), {r['total_mrays_per_s']:.1f} Mrays/s")
        print(f"overall: {d['avg_frame_ms']:.2f} ms, "
              f"{d['total_mrays_per_s']:.1f} Mrays/s")


def cmd_info(args):
    """Scene inspection without rendering: geometry, BVH quality, lights,
    materials, memory footprint (the reference prints a subset of this at
    load, bvh.cpp:27-42 + Scene.cpp:7)."""
    cfg, scene, cam = _build(args)
    sd = scene.to_device()
    print(f"scene:      {args.scene or 'spheres-only (default seven)'}")
    for k, v in scene.stats.items():
        print(f"  bvh.{k}: {v}")
    s = scene.spheres
    print(f"  spheres: {s.count}")
    mats = {0: "DIFF", 1: "SPEC", 2: "REFR", 3: "PHONG", 4: "LIGHT",
            5: "GGX", 8: "RREFR"}
    if scene.tri_refl is not None:
        refl = np.asarray(scene.tri_refl)
        counts = {mats[k]: int((refl == k).sum())
                  for k in np.unique(refl)}
        print(f"  tri materials: {counts}")
    else:
        print("  tri materials: default (white DIFF)")
    n_lights = (len(sd.light_indices) + sd.n_tri_lights
                + sd.n_delta_lights)
    print(f"  lights: {len(sd.light_indices)} sphere"
          f" + {sd.n_tri_lights} tri + {sd.n_delta_lights} delta"
          f" = {n_lights}")
    if n_lights > 1:
        pw = np.asarray(sd.light_powers)
        print(f"  light powers: min {pw.min():.3g} max {pw.max():.3g} "
              f"(power-selection spread {pw.max() / max(pw.min(), 1e-30):.3g}x)")
    feats = [n for n, on in (
        ("textures", sd.has_albedo_tex), ("normal-maps", sd.has_normal_maps),
        ("rough-maps", sd.has_rough_maps), ("alpha-cutout", sd.has_alpha_tex),
        ("smooth-normals", sd.smooth_normals), ("envmap", sd.has_envmap),
        ("ggx", sd.has_ggx)) if on]
    print(f"  features: {', '.join(feats) if feats else 'none'}")
    import jax
    dev_bytes = sum(x.size * x.dtype.itemsize
                    for x in jax.tree.leaves(sd)
                    if hasattr(x, "size"))
    print(f"  device memory (scene tables): {dev_bytes / 1e6:.1f} MB")
    from .ops.traverse import traversal_for
    print(f"  traversal: {traversal_for(jax.devices())} "
          f"on {jax.devices()[0].platform}")
    st_bytes = (cfg.num_rays * (13 * 4) + cfg.num_pixels * 16)
    print(f"render config: {cfg.width}x{cfg.height}, {cfg.num_rays} rays, "
          f"{cfg.max_bounces} bounces (~{st_bytes / 1e6:.0f} MB state)")


def cmd_bvh_debug(args):
    import jax.numpy as jnp

    from .ops.traverse import traversal_depth_map
    from .render import _raygen
    from .camera import Camera

    cfg, scene, cam = _build(args)
    dev = scene.to_device()
    camp = cam.to_device(cfg)
    gen = _raygen(cfg, camp, jnp.asarray(0), jnp.asarray(1, jnp.uint32),
                  cfg.height, 0)
    n_pix = cfg.width * cfg.height
    t, hid, visits = traversal_depth_map(gen["origin"][:n_pix],
                                         gen["direction"][:n_pix], dev.bvh)
    v = np.zeros(n_pix, np.int32)
    v[np.asarray(gen["pixel"][:n_pix])] = np.asarray(visits)
    # reference colouring: kernel.cu:317-326
    img = np.zeros((n_pix, 3), np.uint8)
    g = np.clip(0.0002 * v * 255.99, 0, 255).astype(np.uint8)
    img[:, 1] = g
    costly = v >= 70
    img[costly, 0] = g[costly]
    img[costly, 1] = 0
    _write_png(args.out, img.reshape(cfg.height, cfg.width, 3))
    print(f"visits: mean {v.mean():.1f} max {v.max()}; wrote {args.out}",
          file=sys.stderr)


def _write_hdr(path, img):
    """Linear-radiance HDR export, dispatched on extension: .exr writes
    OpenEXR (half floats, the compositor norm), anything else PFM."""
    if path.lower().endswith(".exr"):
        from .utils.exr import write_exr
        write_exr(path, img)
    else:
        from .utils.pfm import write_pfm
        write_pfm(path, img)


def _write_png(path, img):
    from .utils.png import write_png
    write_png(path, img)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tyrant_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="progressive render to PNG")
    _add_common(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--out", default="out.png")
    p.add_argument("--hdr", default=None, metavar="OUT.{exr,pfm}",
                   help="also write the linear radiance as HDR: OpenEXR "
                        "(half floats) for .exr, PFM otherwise")
    p.add_argument("--until-noise", type=float, default=None,
                   metavar="REL_ERR",
                   help="stop early once the mean relative standard error "
                        "of the image drops below this (e.g. 0.02); "
                        "--steps becomes the upper bound")
    p.add_argument("--aov-format", default="png", choices=["png", "exr"],
                   help="AOV output format: 8-bit PNGs (+depth .npy) or "
                        "float EXRs (albedo/normal half, depth float32)")
    p.add_argument("--aovs", default=None, metavar="PREFIX",
                   help="also write deterministic feature buffers: "
                        "PREFIX_albedo.png, PREFIX_normal.png, "
                        "PREFIX_depth.npy (denoiser guides / compositing)")
    p.add_argument("--checkpoint", default=None, metavar="STATE.npz",
                   help="save the render state here (and resume from it "
                        "if it exists — exact: rays/RNG/accumulation come "
                        "back bit-for-bit)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also checkpoint every N steps (0 = only at end)")
    p.add_argument("--look-at", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"),
                   help="aim the camera at this world point (applied "
                        "after --camera; camera.look_at)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("anim", help="camera-path animation to PNG frames")
    _add_common(p)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--steps", type=int, default=25,
                   help="wavefront steps accumulated per frame")
    p.add_argument("--out", default="anim",
                   help="output directory (frame_%%04d.png)")
    p.add_argument("--orbit", type=float, default=0.0,
                   help="total orbit sweep in degrees about --orbit-center "
                        "(world z axis)")
    p.add_argument("--orbit-center", type=float, nargs=3,
                   default=(0.0, 0.0, 0.0), metavar=("X", "Y", "Z"))
    p.add_argument("--move", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   metavar=("DX", "DY", "DZ"),
                   help="total linear camera translation across the "
                        "animation (composes with --orbit)")
    p.add_argument("--look-at", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"),
                   help="re-aim the camera at this world point every frame")
    p.add_argument("--sun-to", type=float, nargs=2, default=None,
                   metavar=("SX", "SY"),
                   help="animate the sun: sweep sun position linearly from "
                        "--sun to this pair across the frames (timelapse)")
    p.set_defaults(fn=cmd_anim)

    p = sub.add_parser("bench", help="3-pose benchmark (PERFORMANCE_TEST)")
    _add_common(p)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--json", action="store_true")
    p.add_argument("--txt", default=None, help="also write reference-style Performance.txt")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("info", help="scene inspection: BVH stats, lights, "
                       "materials, memory (no render)")
    _add_common(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("bvh-debug", help="traversal-cost heatmap (BVH_DEBUG)")
    _add_common(p)
    p.add_argument("--out", default="bvh_debug.png")
    p.set_defaults(fn=cmd_bvh_debug)

    args = ap.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
