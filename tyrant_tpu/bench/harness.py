"""Fixed-pose benchmark harness.

Port of the reference's PERFORMANCE_TEST mode (performance_measure.cpp:7-45,
main.cpp:153-158): pin the camera to three poses, time frames for a fixed
budget per pose, report avg/min/max frame time and FPS — plus the throughput
numbers the reference never reported (SURVEY.md §6): path segments/s and
total rays/s including NEE shadow rays.

The reference's seconds-vs-ms logging bug (performance_measure.cpp:30-31)
is not carried over.  Every result names the device it ran on
(:func:`device_info`).
"""

from __future__ import annotations

import dataclasses
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import Camera
from ..config import RenderConfig
from ..render import Renderer, render_step

# Reference poses: performance_measure.h:4-5
TEST_POSITIONS = [(-0.119, -26.116, 32.537),
                  (-52.741, -44.67, 109.04),
                  (74.65, 2.77, 17.336)]
TEST_ANGLES = [(12.576, -0.518204),
               (-6470.568, -0.818204),
               (-10218.468, 0.081796)]


@dataclasses.dataclass
class PoseResult:
    pose: int
    frames: int
    avg_ms: float
    min_ms: float
    max_ms: float
    fps: float
    segments_per_s: float
    shadow_rays_per_s: float
    total_mrays_per_s: float
    # reproducibility bookkeeping: how many timed samples were discarded
    # as outliers (> outlier_x the pose median), and how many whole-pose
    # re-measurements the stability gate requested before the spread fell
    # under stability_pct
    outliers_dropped: int = 0
    retries: int = 0
    spread_pct: float = 0.0


def _camera_for_pose(i: int) -> Camera:
    cam = Camera()
    cam.position = np.asarray(TEST_POSITIONS[i], np.float32)
    cam.horizontal_angle, cam.vertical_angle = TEST_ANGLES[i]
    return cam


def _shadow_count(renderer: Renderer) -> int:
    """The monotonic valid-NEE-shadow-ray counter maintained by render_step
    (RenderState.shadow_rays, u32 wraparound).  Reading it forces a sync."""
    return int(jnp.asarray(renderer.state.shadow_rays))


def run_benchmark(scene, cfg: RenderConfig, seconds_per_pose: float = 3.0,
                  warmup_steps: int = 3, sun_position=(0.05, 0.3),
                  poses=None, steps_per_sample: int = 4,
                  stability_pct: float = 10.0, max_retries: int = 2,
                  outlier_x: float = 1.5) -> list[PoseResult]:
    """steps_per_sample: wavefront steps timed per sync.  Chaining a few
    steps per sample measures the device pipeline the way a progressive
    renderer actually runs it, not the per-sync display latency.

    Reproducibility:

      * samples > ``outlier_x`` x the pose median are discarded before
        averaging (a stall of the host, not ray throughput);
      * if the surviving samples still spread more than ``stability_pct``
        (max-min over median) the whole pose is re-measured, up to
        ``max_retries`` times;
      * the dropped/retry counts and the final spread ship in PoseResult
        so a contaminated number can never look like a clean one.
    """
    renderer = Renderer(scene, cfg, sun_position=sun_position)
    results = []
    poses = poses if poses is not None else range(len(TEST_POSITIONS))

    def hard_sync():
        jax.block_until_ready(renderer.state)

    def measure_pose(cam):
        """One timed window; returns (all samples ms, shadow count delta,
        frames timed)."""
        count0 = _shadow_count(renderer)
        times = []
        t_end = time.perf_counter() + seconds_per_pose
        while time.perf_counter() < t_end:
            t0 = time.perf_counter()
            renderer.step(cam, steps_per_sample)
            hard_sync()
            times.append((time.perf_counter() - t0) / steps_per_sample)
        shadow_n = (_shadow_count(renderer) - count0) % (1 << 32)
        return np.asarray(times) * 1e3, shadow_n, len(times) * steps_per_sample

    for pi in poses:
        cam = _camera_for_pose(pi)
        renderer.step(cam, warmup_steps)
        hard_sync()

        retries = 0
        dropped = 0   # accumulated across ALL windows incl. retried ones
        while True:
            times_ms, shadow_n, n_frames = measure_pose(cam)
            med = float(np.median(times_ms))
            keep = times_ms <= outlier_x * med
            kept = times_ms[keep]
            # drops observed in retried (discarded) windows still count:
            # the shipped number must reflect every contamination event
            # the pose saw, not just the final window's
            dropped += int((~keep).sum())
            spread = (float(kept.max() - kept.min()) / med * 100.0
                      if kept.size > 1 else 0.0)
            stable = kept.size >= 2 and spread <= stability_pct
            if stable or retries >= max_retries:
                break
            retries += 1

        avg = float(kept.mean())
        # shadow ratio from the whole window (outlier samples only slow
        # the clock, they do not change the per-step shadow-ray count)
        segs = cfg.num_rays / (avg * 1e-3)
        shadow = segs * (shadow_n / (n_frames * cfg.num_rays))
        results.append(PoseResult(
            pose=pi, frames=n_frames, avg_ms=avg,
            min_ms=float(kept.min()), max_ms=float(kept.max()),
            fps=1e3 / avg,
            segments_per_s=segs, shadow_rays_per_s=shadow,
            total_mrays_per_s=(segs + shadow) / 1e6,
            outliers_dropped=dropped, retries=retries,
            spread_pct=round(spread, 1)))
    return results


def card_name_and_power() -> str:
    """The cards as ``nvidia-smi --query-gpu=name,power.limit`` reports
    them ("; "-joined), or "not available" where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return "; ".join(lines) if out.returncode == 0 and lines \
        else "not available"


def device_info() -> dict:
    """What a result was measured on: JAX's platform, device kind and
    device count, and the cards' name and power limit."""
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
            "card": card_name_and_power()}


def write_performance_txt(results: list[PoseResult], path: str):
    """Write the reference-style Performance.txt (performance_measure.cpp:
    24-42 — with its ms/seconds mislabeling fixed)."""
    with open(path, "w") as f:
        for r in results:
            f.write(f"Scene {r.pose}\n")
            f.write(f"Average frame time: {r.avg_ms:.4f} ms "
                    f"({r.fps:.2f} FPS)\n")
            f.write(f"Min frame time: {r.min_ms:.4f} ms\n")
            f.write(f"Max frame time: {r.max_ms:.4f} ms\n")
            f.write(f"Throughput: {r.total_mrays_per_s:.2f} Mrays/s\n\n")


def results_to_dict(results: list[PoseResult]) -> dict:
    return {
        "device": device_info(),
        "poses": [dataclasses.asdict(r) for r in results],
        "avg_frame_ms": float(np.mean([r.avg_ms for r in results])),
        "avg_fps": float(np.mean([r.fps for r in results])),
        "total_mrays_per_s": float(np.mean([r.total_mrays_per_s for r in results])),
        "segments_per_s": float(np.mean([r.segments_per_s for r in results])),
    }
