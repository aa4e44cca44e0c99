"""Profiling helpers: JAX profiler traces + per-stage timing.

The reference times whole frames with one cudaDeviceSynchronize per frame
(kernel.cu:733, SURVEY.md §5).  Here the equivalents are JAX profiler
traces and block_until_ready-bracketed stage timing.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a jax profiler trace viewable in TensorBoard / Perfetto."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "tyrant_trace")
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def time_blocked(fn, *args, reps: int = 3, warmup: int = 1, **kw):
    """Median wall time of fn(*args) with device sync (the reference's
    sync-then-time, performance_measure.cpp:24-31)."""
    for _ in range(warmup):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out


def stage_profile(renderer, camera, n_steps: int = 5) -> dict:
    """Per-stage timings of one wavefront step (raygen/extend/shade/connect),
    plus a full-step measurement.

    Uses a non-donating jit of render_step for the full-step number:
    renderer._step donates its input buffers, so calling it repeatedly with
    the same state would fail with 'array has been deleted' and
    invalidate renderer.state."""
    from functools import partial

    from ..render import (_connect, _intersect_scene, _raygen, _shade,
                          render_step)

    cfg = renderer.cfg
    cam = camera.to_device(cfg)
    state = renderer.state
    scene = renderer.scene
    traversal = renderer.traversal

    raygen = jax.jit(lambda: _raygen(cfg, cam, state.start_position,
                                     state.frame, cfg.height, 0))
    t_raygen, gen = time_blocked(raygen, reps=n_steps)

    extend = jax.jit(lambda o, d: _intersect_scene(o, d, scene, traversal))
    t_extend, ext = time_blocked(extend, gen["origin"], gen["direction"],
                                 reps=n_steps)

    shade = jax.jit(lambda rays, t, i, tri: _shade(
        cfg, scene, renderer.sky_params, renderer.sun_dir, rays, t, i, tri,
        state.frame))
    t_shade, sh = time_blocked(shade, gen, *ext, reps=n_steps)

    connect = jax.jit(lambda s: _connect(scene, s, traversal))
    t_connect, _ = time_blocked(connect, sh[4], reps=n_steps)

    full = jax.jit(partial(render_step, cfg=cfg,
                           sky_params=renderer.sky_params,
                           traversal=traversal))
    step = lambda: full(state, scene, cam, renderer.sun_dir)
    t_full, _ = time_blocked(step, reps=n_steps)

    total = t_raygen + t_extend + t_shade + t_connect
    return {
        "raygen_ms": t_raygen * 1e3,
        "extend_ms": t_extend * 1e3,
        "shade_ms": t_shade * 1e3,
        "connect_ms": t_connect * 1e3,
        "stage_sum_ms": total * 1e3,
        "full_step_ms": t_full * 1e3,
        "mrays_per_s_segments": cfg.num_rays / t_full / 1e6,
    }
