"""Smoke test of the path tracer's main path on NVIDIA GPUs.

    python chip_smoke.py          # one card: the phases below
    python chip_smoke.py --four   # four cards: the sharded path only

One card:
  1. print the cards (nvidia-smi name and power limit) and JAX's device;
     anything but a GPU exits non-zero before any work;
  2. build the 1,048,576-triangle procgen terrain (native BVH builder);
  3. compare the CUDA closest-hit and any-hit kernels with the XLA cascade
     on 65,536 rays of that scene (tyrant_tpu/bench/equivalence.py: ids
     exact except ties within EPSILON, t within rtol 1e-4, occlusion exact;
     the slack is for floating-point contraction, which nvcc and XLA
     apply each in their own places);
  4. drive a ``Renderer`` at the reference's PERFORMANCE_TEST setting
     (1920x1080, 2,097,152 rays, 5 bounces) for a few steps at each of the
     three harness poses: compile time, ms per step, the step's
     ``memory_analysis()`` and ``peak_bytes_in_use``; the accumulation must
     be finite and conserve completed paths; the image must match a render
     of the same seed and steps whose traversal is the cascade, in the mean
     and in every 64x64 tile, within the Monte-Carlo bound stated at
     ``image_agrees``;
  5. run the tests marked ``gpu`` in this process.

Four cards (``--four``): a ``ShardedRenderer`` over four cards at 1920x1080
(270 rows a card, 2,097,152 rays a card) on the terrain, against the same
configuration on one card — each strip's step (the program every card runs
inside ``shard_map``) run alone on one card — through each strip's
path-weighted mean radiance (``strip_agrees``); prints the step times.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
any failed phase raises and exits non-zero without it.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
POSE_STEPS = 4
TILE = 64
# Monte-Carlo bound: |difference of two means| <= Z * sqrt(se_a^2 + se_b^2)
# with se the standard error of each mean over its pixels, as if the two
# estimates were independent (renders of one seed are strongly correlated,
# so this is loose), plus REL of the mean for float summation order.
Z = 5.0
REL = 1e-3


def log(*a):
    print(*a, flush=True)


def _terrain():
    from tyrant_tpu.scene.procgen import benchmark_scene
    from tyrant_tpu.scene.scene import Scene

    t0 = time.perf_counter()
    v0, v1, v2 = benchmark_scene(1_048_576)
    scene = Scene.from_triangles(v0, v1, v2, builder="native")
    log(f"scene: {scene.stats} ({time.perf_counter() - t0:.1f} s)")
    return scene


def _full_config():
    from tyrant_tpu.config import RenderConfig
    return RenderConfig(width=1920, height=1080, num_rays=2 * 1_048_576,
                        max_bounces=5)


def radiance(accum, width):
    """[P, 4] accumulation -> [H, W, 3] per-pixel mean radiance (numpy)."""
    import numpy as np
    a = np.asarray(accum, np.float64)
    rad = a[:, :3] / np.maximum(a[:, 3:4], 1.0)
    return rad.reshape(-1, width, 3)


def _mean_and_se(x):
    import numpy as np
    x = x.reshape(-1, 3)
    return x.mean(0), x.std(0) / np.sqrt(max(x.shape[0], 1))


def image_agrees(rad_a, rad_b, what: str, tile: int = TILE) -> float:
    """Check the mean radiance and each tile x tile mean of two images
    (per channel) against the Monte-Carlo bound above; returns the worst
    |difference| / bound (must be <= 1)."""
    import numpy as np

    worst = 0.0
    h, w, _ = rad_a.shape
    regions = [("image", slice(0, h), slice(0, w))]
    regions += [(f"tile({y},{x})", slice(y, y + tile), slice(x, x + tile))
                for y in range(0, h, tile) for x in range(0, w, tile)]
    for name, ys, xs in regions:
        ma, sa = _mean_and_se(rad_a[ys, xs])
        mb, sb = _mean_and_se(rad_b[ys, xs])
        bound = Z * np.sqrt(sa * sa + sb * sb) + REL * np.abs(ma) + 1e-6
        ratio = float(np.max(np.abs(ma - mb) / bound))
        if ratio > 1.0:
            raise AssertionError(
                f"{what}: {name} mean {ma} vs {mb} exceeds the bound {bound}")
        worst = max(worst, ratio)
    return worst


def _strips(accum, width):
    """[P, 4] accumulation -> [H, W, 4] (numpy f64)."""
    import numpy as np
    return np.asarray(accum, np.float64).reshape(-1, width, 4)


def strip_agrees(acc_a, acc_b, what: str) -> float:
    """Compare two renders of one strip that took different numbers of
    samples per pixel (four cards give each strip a whole wavefront, one
    card a quarter of one) through the path-weighted mean radiance,
    sum(rgb) / sum(paths): a per-pixel mean would count the pixels that
    have no completed path yet as black, and the render with fewer
    samples has more of them.  The bound is the Monte-Carlo one above,
    with the standard error of each mean taken over its sampled pixels;
    returns the worst |difference| / bound."""
    import numpy as np

    means, ses = [], []
    for acc in (acc_a, acc_b):
        a = acc.reshape(-1, 4)
        seen = a[:, 3] > 0
        means.append(a[:, :3].sum(0) / a[:, 3].sum())
        ses.append((a[seen, :3] / a[seen, 3:4]).std(0)
                   / np.sqrt(max(int(seen.sum()), 1)))
        log(f"{what}: {int((~seen).sum())} of {seen.size} pixels without "
            f"a completed path")
    bound = Z * np.sqrt(ses[0] ** 2 + ses[1] ** 2) \
        + REL * np.abs(means[0]) + 1e-6
    ratio = float(np.max(np.abs(means[0] - means[1]) / bound))
    if ratio > 1.0:
        raise AssertionError(f"{what}: mean {means[0]} vs {means[1]} "
                             f"exceeds the bound {bound}")
    return ratio


def phase_kernels(scene_dev):
    from tyrant_tpu.bench.equivalence import check_kernels

    t0 = time.perf_counter()
    res = check_kernels(scene_dev.bvh, 65_536)
    log(f"kernels vs cascade (65,536 rays): {json.dumps(res)} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not res["ok"]:
        raise AssertionError("CUDA kernels disagree with the cascade")


def _completed(accum) -> int:
    import jax.numpy as jnp
    return int(jnp.sum(accum[:, 3].astype(jnp.int32)))


def phase_render(scene_dev, cfg, poses=(0, 1, 2), steps=POSE_STEPS):
    """Renderer at cfg for ``steps`` steps per pose; returns the per-pose
    radiance images."""
    import jax

    from tyrant_tpu.bench.harness import _camera_for_pose
    from tyrant_tpu.render import Renderer

    r = Renderer(scene_dev, cfg)
    if r.traversal != "cuda":
        raise AssertionError(f"Renderer chose {r.traversal!r} on a GPU")
    cam0 = _camera_for_pose(poses[0]).to_device(cfg)
    t0 = time.perf_counter()
    compiled = r._step.lower(r.state, r.scene, cam0, r.sun_dir).compile()
    log(f"render step compile: {time.perf_counter() - t0:.1f} s")
    log(f"memory_analysis: {compiled.memory_analysis()}")
    images = {}
    for p in poses:
        cam = _camera_for_pose(p)
        generated, times = 0, []
        for i in range(steps):
            carried = int(r.state.n_carried) if i else 0
            generated += cfg.num_rays - carried
            t0 = time.perf_counter()
            r.step(cam, 1)
            jax.block_until_ready(r.state)
            times.append((time.perf_counter() - t0) * 1e3)
        accum = r.state.accum
        if not bool(jax.numpy.isfinite(accum).all()):
            raise AssertionError(f"pose {p}: non-finite accumulation")
        done = _completed(accum)
        left = int(r.state.n_carried)
        if done + left != generated:
            raise AssertionError(
                f"pose {p}: {done} completed + {left} carried != "
                f"{generated} generated paths")
        log(f"pose {p}: ms/step {[round(t, 2) for t in times]} "
            f"(first includes compile); paths {done} done + {left} carried "
            f"= {generated} generated")
        images[p] = radiance(accum, cfg.width)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    return images


def phase_cascade_image(scene_dev, cfg, images, poses=(0, 1, 2),
                        steps=POSE_STEPS):
    """The same renders with the cascade as the traversal, compared."""
    from functools import partial

    import jax

    from tyrant_tpu import sky
    from tyrant_tpu.bench.harness import _camera_for_pose
    from tyrant_tpu.render import init_state, render_step, reset_accumulation

    step = jax.jit(partial(render_step, cfg=cfg,
                           sky_params=sky.SkyParams(cfg.sky),
                           traversal="xla"), donate_argnums=(0,))
    sun = sky.sun_direction_from_position(jax.numpy.asarray((0.05, 0.3)))
    state = init_state(cfg)
    for p in poses:
        cam = _camera_for_pose(p).to_device(cfg)
        if p != poses[0]:
            state = reset_accumulation(state)
        t0 = time.perf_counter()
        for _ in range(steps):
            state = step(state, scene_dev, cam, sun)
        jax.block_until_ready(state)
        worst = image_agrees(images[p], radiance(state.accum, cfg.width),
                             f"pose {p} kernel vs cascade")
        log(f"pose {p}: image agrees with the cascade render (worst "
            f"|diff|/bound {worst:.3f}; cascade {steps} steps "
            f"{time.perf_counter() - t0:.1f} s)")


def phase_gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "--card", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(ROOT, "tests")])
    if rc != 0:
        raise AssertionError(f"gpu tests failed (pytest exit {rc})")


def phase_four(scene_dev, cfg, steps=2 * POSE_STEPS, pose=0):
    """ShardedRenderer over the first four devices, then each strip's step
    on one device alone (render_step at the strip's height and row offset,
    the program every card runs inside shard_map)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from tyrant_tpu import sky
    from tyrant_tpu.bench.harness import _camera_for_pose
    from tyrant_tpu.parallel.sharded import ShardedRenderer, make_mesh
    from tyrant_tpu.render import init_state, render_step

    devices = jax.devices()[:4]
    if len(devices) < 4:
        raise AssertionError(f"--four needs 4 devices, found {len(devices)}")
    cam = _camera_for_pose(pose)
    rows = cfg.height // 4

    def timed(advance):
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            jax.block_until_ready(advance())
            times.append((time.perf_counter() - t0) * 1e3)
        return [round(t, 2) for t in times]

    sharded = ShardedRenderer(scene_dev, cfg, mesh=make_mesh(devices))
    t_four = timed(lambda: sharded.step(cam, 1))
    if not bool(jnp.isfinite(sharded.state.accum).all()):
        raise AssertionError("four cards: non-finite accumulation")
    acc_four = _strips(sharded.state.accum, cfg.width)
    log(f"four cards: ms/step {t_four} (first includes compile); {rows} "
        f"rows and {cfg.num_rays} rays a card")
    step = jax.jit(partial(render_step, cfg=cfg,
                           sky_params=sky.SkyParams(cfg.sky),
                           local_height=rows, traversal=sharded.traversal),
                   donate_argnums=(0,))
    cam_dev, sun = cam.to_device(cfg), sharded.sun_dir
    del sharded
    for k in range(4):
        state = [init_state(cfg, local_height=rows)]

        def advance():
            state[0] = step(state[0], scene_dev, cam_dev, sun,
                            row_offset=jnp.int32(k * rows))
            return state[0]
        t_one = timed(advance)
        worst = strip_agrees(acc_four[k * rows:(k + 1) * rows],
                             _strips(state[0].accum, cfg.width),
                             f"strip {k}")
        log(f"strip {k} on one card: ms/step {t_one}; mean radiance agrees "
            f"with the four-card strip (|diff|/bound {worst:.3f})")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    sys.path.insert(0, ROOT)
    from tyrant_tpu.bench.harness import card_name_and_power
    from tyrant_tpu.utils.compile_cache import enable_compile_cache

    import jax

    enable_compile_cache()
    devices = jax.devices()
    dev = devices[0]
    log(f"jax: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devices)}")
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found "
              f"{dev.platform!r}", file=sys.stderr)
        return 1
    log(f"card: {card_name_and_power()}")

    cfg = _full_config()
    scene_dev = _terrain().to_device()
    if four:
        phase_four(scene_dev, cfg)
    else:
        phase_kernels(scene_dev)
        images = phase_render(scene_dev, cfg)
        phase_cascade_image(scene_dev, cfg, images)
        del images
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
