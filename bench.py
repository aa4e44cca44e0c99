"""Benchmark entry point: runs on an NVIDIA GPU and refuses anything else.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mrays/s", "vs_baseline": N/BASELINE,
   "device": {...}, "equivalence": ..., "detail": {...}}

Config matches the reference's PERFORMANCE_TEST (performance_measure.cpp,
BASELINE.md): 1920x1080, 2,097,152-entry wavefront, MAX_BOUNCES=5, three
fixed camera poses.  Two scenes are measured:

  * the ~1M-triangle procgen terrain (native BVH builder) — the BASELINE.md
    target is defined at ~1M tris / 1080p, so this is the METRIC OF RECORD
    ("value");
  * a "dragon" scene kept for continuity ("dragon_mrays_per_s"): the mesh
    given with ``--dragon PATH`` (the reference's dragon.ply, 38k tris), or
    else a 65k-triangle procgen terrain ("dragon_source" says which).

Before timing, an EQUIVALENCE GATE compares the CUDA traversal kernels with
the XLA cascade on the same random rays (tyrant_tpu/bench/equivalence.py
states the limits); its verdict ships in the JSON.  Every line printed
names the device: JAX's platform, device kind and count, and the cards'
name and power limit.

Baseline: the reference's derived total-ray throughput ~100 Mrays/s
(80-120 incl. NEE shadow rays, BASELINE.md) on its unspecified GPU.

Usage: python bench.py [--dragon PATH] [--scene dragon|terrain]
"""

from __future__ import annotations

import json
import sys
import time

BASELINE_MRAYS = 100.0


def _arg(name: str, default=None):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else default


def check_equivalence(scene, n_rays: int = 65_536) -> str:
    """"ok", or the disagreement counts of the CUDA kernels vs the
    cascade on the gate rays."""
    from tyrant_tpu.bench.equivalence import check_kernels

    res = check_kernels(scene.to_device().bvh, n_rays)
    return "ok" if res["ok"] else json.dumps(res)


def bench_scene(scene, seconds_per_pose: float):
    from tyrant_tpu.bench import results_to_dict, run_benchmark
    from tyrant_tpu.config import RenderConfig

    # 1080p, 2M-ray wavefront, MAX_BOUNCES=5 — the reference harness's
    # exact configuration (variables.h:44, kernel.cu:16)
    cfg = RenderConfig(width=1920, height=1080, num_rays=2 * 1_048_576,
                       max_bounces=5)
    # warmup_steps=4 matches steps_per_sample so the fused step chain
    # compiles exactly once
    results = run_benchmark(scene, cfg, seconds_per_pose=seconds_per_pose,
                            warmup_steps=4)
    d = results_to_dict(results)
    for r in d["poses"]:
        flap = (f" [dropped {r['outliers_dropped']} outlier samples,"
                f" {r['retries']} retries]"
                if r["outliers_dropped"] or r["retries"] else "")
        print(f"#   pose {r['pose']}: {r['avg_ms']:.2f} ms "
              f"({r['fps']:.1f} FPS) {r['total_mrays_per_s']:.1f} Mrays/s "
              f"spread {r['spread_pct']}%{flap}",
              file=sys.stderr)
    return d, cfg


def _load_dragon(path):
    from tyrant_tpu.scene.scene import Scene

    if path:
        return Scene.load(path), "dragon.ply"
    from tyrant_tpu.scene.procgen import benchmark_scene
    v0, v1, v2 = benchmark_scene(65_536)
    return Scene.from_triangles(v0, v1, v2), "procgen_fallback_65k"


def _terrain_scene():
    """The 1M-triangle terrain; the native builder is required (the numpy
    builder would take minutes at this size)."""
    from tyrant_tpu.scene.procgen import benchmark_scene
    from tyrant_tpu.scene.scene import Scene

    v0, v1, v2 = benchmark_scene(1_048_576)
    return Scene.from_triangles(v0, v1, v2, builder="native")


def main():
    from tyrant_tpu.bench.harness import device_info
    from tyrant_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = device_info()
    print(f"# device: {json.dumps(device)}", file=sys.stderr)
    if device["platform"] != "gpu":
        sys.exit(f"bench.py measures an NVIDIA GPU; JAX found "
                 f"{device['platform']!r}")

    if "--scene" in sys.argv:
        which = _arg("--scene")
        scene = (_load_dragon(_arg("--dragon"))[0] if which == "dragon"
                 else _terrain_scene())
        print(f"# {which} scene: {scene.stats}", file=sys.stderr)
        d, cfg = bench_scene(scene, seconds_per_pose=6.0)
        print(json.dumps({"scene": which, **{k: v for k, v in d.items()
                                             if k != "poses"}}))
        return

    t0 = time.time()
    dragon, dragon_source = _load_dragon(_arg("--dragon"))
    print(f"# dragon scene ({dragon_source}): {dragon.stats} "
          f"({time.time() - t0:.1f}s)", file=sys.stderr)

    print("# equivalence gate (CUDA kernels vs XLA cascade)...",
          file=sys.stderr)
    equivalence = check_equivalence(dragon)
    print(f"# equivalence: {equivalence}", file=sys.stderr)

    d_dragon, _ = bench_scene(dragon, seconds_per_pose=6.0)
    del dragon

    t0 = time.time()
    terrain = _terrain_scene()
    print(f"# terrain scene: {terrain.stats} ({time.time() - t0:.1f}s build)",
          file=sys.stderr)
    d_terr, cfg = bench_scene(terrain, seconds_per_pose=6.0)

    value = d_terr["total_mrays_per_s"]
    print(json.dumps({
        "metric": "total_ray_throughput_1080p_1m_tri",
        "value": round(value, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(value / BASELINE_MRAYS, 3),
        "device": device,
        "equivalence": equivalence,
        "detail": {
            "avg_frame_ms": round(d_terr["avg_frame_ms"], 2),
            "avg_fps": round(d_terr["avg_fps"], 2),
            "segments_per_s": round(d_terr["segments_per_s"] / 1e6, 2),
            "triangles": terrain.stats.get("triangles", 0),
            "wavefront": cfg.num_rays,
            "dragon_mrays_per_s": round(d_dragon["total_mrays_per_s"], 2),
            "dragon_avg_frame_ms": round(d_dragon["avg_frame_ms"], 2),
            "dragon_source": dragon_source,
            "pose_ms": [round(r["avg_ms"], 1) for r in d_terr["poses"]],
            "pose_spread_pct": [r["spread_pct"] for r in d_terr["poses"]],
            "flap_samples_dropped": sum(r["outliers_dropped"]
                                        for r in d_terr["poses"]
                                        + d_dragon["poses"]),
        },
    }))


if __name__ == "__main__":
    main()
