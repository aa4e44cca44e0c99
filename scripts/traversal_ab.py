"""Traversal A/B on one NVIDIA GPU at the benchmark setting.

Times one render step (ms, steady state, three harness poses) on the
1M-triangle terrain at 1920x1080 with a 2,097,152-ray wavefront and five
bounces, for each traversal variant:

  cuda             the CUDA kernels (ops/cuda), one thread per ray
  cuda_octant      the CUDA kernels with rays sorted by direction octant
  xla_chunk16k     the XLA cascade (ops/traverse.py) in 16k-ray chunks
  xla_whole        the cascade as one while_loop over the whole batch

then times each traversal alone on a captured extend and connect wavefront,
and traces two steps of the kernel path to read the device time of the
framebuffer scatter-add and of the other top operations.

Usage: python scripts/traversal_ab.py [--variants a,b,...] [--steps W,T]
                                      [--no-xla-alone] [--out DIR]
A variant may repeat (a,b,a,b) to see the run-to-run spread.  Writes
nothing but DIR (default chiprun_out/traversal_ab).
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

VARIANTS = ("cuda", "cuda_octant", "xla_chunk16k", "xla_whole")


def _arg(name, default):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else default


def _octant_sorted(fn):
    """Wrap a traversal so that rays run grouped by direction octant."""
    import jax.numpy as jnp

    def wrapped(origin, direction, *args, **kw):
        neg = direction < 0
        key = (neg[:, 0].astype(jnp.int32) + 2 * neg[:, 1].astype(jnp.int32)
               + 4 * neg[:, 2].astype(jnp.int32))
        order = jnp.argsort(key)
        inv = jnp.argsort(order)
        args = [a[order] if hasattr(a, "shape") and a.ndim >= 1
                and a.shape[0] == origin.shape[0] else a for a in args]
        kw = {k: (v[order] if v is not None else v) for k, v in kw.items()}
        out = fn(origin[order], direction[order], *args, **kw)
        return (tuple(o[inv] for o in out) if isinstance(out, tuple)
                else out[inv])
    return wrapped


class Variant:
    """Applies one variant's switches while its programs are traced."""

    def __init__(self, name):
        self.name = name
        self.traversal = "cuda" if name.startswith("cuda") else "xla"

    def __enter__(self):
        import jax

        from tyrant_tpu.ops import cuda, traverse
        jax.clear_caches()   # the switches are read while tracing
        self._saved = (traverse.CHUNK, cuda.closest_hit, cuda.any_hit)
        if self.name == "xla_whole":
            traverse.CHUNK = 1 << 30
        if self.name == "cuda_octant":
            cuda.closest_hit = _octant_sorted(self._saved[1])
            cuda.any_hit = _octant_sorted(self._saved[2])
        return self

    def __exit__(self, *exc):
        import jax

        from tyrant_tpu.ops import cuda, traverse
        jax.clear_caches()
        traverse.CHUNK, cuda.closest_hit, cuda.any_hit = self._saved


def step_times(variant, scene, cfg, poses, warm, timed):
    """ms per render step for each pose, and the first call's seconds."""
    import jax

    from tyrant_tpu import render
    from tyrant_tpu.bench.harness import _camera_for_pose
    from tyrant_tpu.sky import SkyParams, sun_direction_from_position

    sun = sun_direction_from_position(jax.numpy.asarray((0.05, 0.3)))
    with Variant(variant) as v:
        step = jax.jit(partial(render.render_step, cfg=cfg,
                               sky_params=SkyParams(cfg.sky),
                               traversal=v.traversal), donate_argnums=(0,))
        state = render.init_state(cfg)
        out, first = {}, None
        for p in poses:
            cam = _camera_for_pose(p).to_device(cfg)
            state = render.reset_accumulation(state)
            for i in range(warm):
                t0 = time.perf_counter()
                state = step(state, scene, cam, sun)
                jax.block_until_ready(state)
                if first is None:
                    first = time.perf_counter() - t0
            ts = []
            for _ in range(timed):
                t0 = time.perf_counter()
                state = step(state, scene, cam, sun)
                jax.block_until_ready(state)
                ts.append((time.perf_counter() - t0) * 1e3)
            out[p] = ts
    return out, first, state


def wavefronts(scene, cfg, state, cam, sun):
    """The extend rays and the shadow rays of the next step of ``state``."""
    import jax

    from tyrant_tpu import render
    from tyrant_tpu.sky import SkyParams

    @jax.jit
    def capture(state):
        gen = render._raygen(cfg, cam, state.start_position, state.frame,
                             cfg.height, 0)
        keep = (jax.numpy.arange(cfg.num_rays)
                >= cfg.num_rays - state.n_carried)
        o = jax.numpy.where(keep[:, None], state.origin, gen["origin"])
        d = jax.numpy.where(keep[:, None], state.direction, gen["direction"])
        t, ident, is_tri = render._intersect_scene(o, d, scene, "cuda")
        rays = {k: jax.numpy.where(keep[:, None] if gen[k].ndim == 2
                                   else keep, getattr(state, k), gen[k])
                for k in ("origin", "direction", "direct", "pending",
                          "pixel", "bounces", "last_specular")}
        *_, shadow = render._shade(cfg, scene, SkyParams(cfg.sky), sun, rays,
                                   t, ident, is_tri, state.frame)
        maxd = jax.numpy.where(shadow["valid"], shadow["max_dist"], 0.0)
        return o, d, shadow["origin"], shadow["direction"], maxd, \
            shadow["valid"]
    return capture(state)


def time_fn(fn, *args, reps=5):
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def device_op_times(trace_dir):
    """Device time (ms) per (trace line, event name) over a profiler trace,
    and per line."""
    import glob

    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    totals = collections.Counter()
    lines = collections.Counter()
    for plane in prof.planes:
        if "GPU" not in plane.name:
            continue
        for line in plane.lines:
            for ev in line.events:
                totals[(line.name, ev.name)] += ev.duration_ns / 1e6
                lines[(plane.name, line.name)] += ev.duration_ns / 1e6
    return totals, lines


def main():
    import jax
    import jax.numpy as jnp

    from tyrant_tpu.bench.equivalence import check_kernels
    from tyrant_tpu.bench.harness import _camera_for_pose, device_info
    from tyrant_tpu.config import RenderConfig
    from tyrant_tpu.ops import cuda, traverse
    from tyrant_tpu.scene.procgen import benchmark_scene
    from tyrant_tpu.scene.scene import Scene
    from tyrant_tpu.sky import sun_direction_from_position
    from tyrant_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    out_dir = _arg("--out", os.path.join("chiprun_out", "traversal_ab"))
    os.makedirs(out_dir, exist_ok=True)
    info = device_info()
    print("device", json.dumps(info), flush=True)
    # --tiny: a CPU rehearsal of the script's control flow at toy sizes
    tiny = "--tiny" in sys.argv
    if info["platform"] != "gpu" and not tiny:
        sys.exit("needs an NVIDIA GPU")
    variants = _arg("--variants", ",".join(VARIANTS)).split(",")
    warm, timed = (int(x) for x in _arg("--steps", "3,4").split(","))

    t0 = time.perf_counter()
    v0, v1, v2 = benchmark_scene(16_384 if tiny else 1_048_576)
    scene = Scene.from_triangles(v0, v1, v2, builder="native").to_device()
    print(f"scene {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    cuda.build_library(info["platform"])
    print(f"kernel build {time.perf_counter() - t0:.1f}s", flush=True)

    res = check_kernels(scene.bvh, 65_536)
    print(f"equivalence {json.dumps(res)}", flush=True)

    cfg = (RenderConfig(width=64, height=64, num_rays=4096) if tiny else
           RenderConfig(width=1920, height=1080, num_rays=2 * 1_048_576,
                        max_bounces=5))
    results = {"device": info, "variants": []}
    state = None
    for name in variants:
        t0 = time.perf_counter()
        times, first, st = step_times(name, scene, cfg, range(3), warm,
                                      timed)
        means = {p: sum(v) / len(v) for p, v in times.items()}
        rec = {"variant": name, "first_call_s": first, "pose_ms": times,
               "pose_mean_ms": means,
               "mean_ms": sum(means.values()) / len(means)}
        results["variants"].append(rec)
        print(f"variant {name}: mean {rec['mean_ms']:.2f} ms/step "
              f"poses {[round(m, 2) for m in means.values()]} first call "
              f"{first:.1f}s (phase {time.perf_counter() - t0:.0f}s)",
              flush=True)
        if name == "cuda":
            state = st
        else:
            del st

    if state is not None:
        sun = sun_direction_from_position(jnp.asarray((0.05, 0.3)))
        cam = _camera_for_pose(2).to_device(cfg)
        o, d, so, sd, maxd, valid = wavefronts(scene, cfg, state, cam, sun)
        alone = {}
        kernels = [
            ("closest_cuda", lambda: cuda.closest_hit(o, d, scene.bvh)),
            ("any_cuda", lambda: cuda.any_hit(so, sd, maxd, scene.bvh,
                                              active=valid))]
        if "--no-xla-alone" not in sys.argv:
            kernels += [
                ("closest_xla", lambda: traverse.closest_hit(o, d,
                                                             scene.bvh)),
                ("any_xla", lambda: traverse.any_hit(
                    so, sd, maxd, scene.bvh, active=valid))]
        for rnd in range(2):
            for name, fn in kernels:
                ms = time_fn(jax.jit(fn), reps=5)
                alone.setdefault(name, []).append(ms)
                print(f"alone {name} (round {rnd}): {ms:.3f} ms",
                      flush=True)
            if "--no-xla-alone" not in sys.argv:
                break

        results["alone_ms"] = alone
        results["shadow_valid"] = int(valid.sum())

        from tyrant_tpu import render
        from tyrant_tpu.sky import SkyParams
        step = jax.jit(partial(render.render_step, cfg=cfg,
                               sky_params=SkyParams(cfg.sky),
                               traversal="cuda"), donate_argnums=(0,))
        state = jax.block_until_ready(step(state, scene, cam, sun))
        trace_dir = os.path.join(out_dir, "trace")
        t0 = time.perf_counter()
        with jax.profiler.trace(trace_dir):
            for _ in range(2):
                state = step(state, scene, cam, sun)
            jax.block_until_ready(state)
        window = (time.perf_counter() - t0) * 1e3
        totals, lines = device_op_times(trace_dir)
        shutil.rmtree(trace_dir)   # large; the reduction below is kept
        # group an op's launches: "sort_56_1__85" -> "sort_56_1"
        grouped = collections.Counter()
        for (line, name), v in totals.items():
            grouped[(line, re.sub(r"__\d+$", "", name))] += v
        top = grouped.most_common(30)
        results["trace"] = {"window_ms": window, "steps": 2,
                            "lines_ms": [[list(k), v] for k, v in
                                         lines.items()],
                            "top_ops_ms": [[list(k), v] for k, v in top]}
        print(f"trace: 2 steps, window {window:.1f} ms", flush=True)
        for k, v in lines.items():
            print(f"  line {v:9.3f} ms  {k}")
        for (line, name), v in top:
            print(f"  {v:9.3f} ms  [{line[:24]}] {name[:100]}")
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=1, default=str)


if __name__ == "__main__":
    main()
