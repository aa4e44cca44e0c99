"""Multi-chip data-parallel rendering via shard_map over a device mesh.

The reference is single-GPU (main.cpp:89-101 detects a second device but
only prints).  The scale-out here (SURVEY.md §2.3/§5): shard the *image*
into per-device row strips; each device runs the full wavefront on its own
strip with its own carried rays, start position and accumulation buffer —
the scene (triangles + BVH, read-only after load) is replicated.  There are
NO collectives in the hot loop; the only cross-device operation is the
framebuffer gather at display time (an all-gather, or simply a host fetch
of the sharded array).  On GPUs each shard runs the CUDA traversal kernels
on its own card.

State layout: every per-ray / per-pixel leaf gets a leading global axis
sharded over the ``"shards"`` mesh axis; per-shard scalars (frame counter,
carried-ray count, scan position) become length-``n_devices`` vectors
sharded the same way.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import sky as skymod
from ..camera import CameraParams
from ..config import RenderConfig
from ..ops.traverse import traversal_for
from ..render import RenderState, render_step
from ..scene.scene import SceneData

AXIS = "shards"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np
    return Mesh(np.asarray(devices), (AXIS,))


def init_sharded_state(cfg: RenderConfig, mesh: Mesh) -> RenderState:
    """Global-view state: [D * local] leading axes, sharded over the mesh."""
    n_dev = mesh.devices.size
    assert cfg.height % n_dev == 0, \
        f"height {cfg.height} must divide across {n_dev} devices"
    local_h = cfg.height // n_dev
    p_local = cfg.width * local_h
    n = cfg.num_rays  # per-device ray budget

    def sharded(x):
        return jax.device_put(x, NamedSharding(mesh, P(AXIS)))

    return RenderState(
        accum=sharded(jnp.zeros((n_dev * p_local, 4), jnp.float32)),
        origin=sharded(jnp.zeros((n_dev * n, 3), jnp.float32)),
        direction=sharded(jnp.tile(jnp.asarray([[1.0, 0, 0]], jnp.float32),
                                   (n_dev * n, 1))),
        direct=sharded(jnp.zeros((n_dev * n, 3), jnp.float32)),
        pending=sharded(jnp.zeros((n_dev * n, 3), jnp.float32)),
        pixel=sharded(jnp.zeros((n_dev * n,), jnp.int32)),
        bounces=sharded(jnp.zeros((n_dev * n,), jnp.int32)),
        last_specular=sharded(jnp.zeros((n_dev * n,), bool)),
        n_carried=sharded(jnp.zeros((n_dev,), jnp.int32)),
        start_position=sharded(jnp.zeros((n_dev,), jnp.int32)),
        frame=sharded(jnp.ones((n_dev,), jnp.uint32)),
        shadow_rays=sharded(jnp.zeros((n_dev,), jnp.uint32)),
        # adaptive sampling: per-STRIP moment buffer and visit permutation
        # (local pixel ids, so each shard prioritises within its own strip)
        moment2=sharded(jnp.zeros(
            (n_dev * (p_local if cfg.adaptive_sampling == "on" else 1), 4),
            jnp.float32)),
        pixel_perm=sharded(
            jnp.tile(jnp.arange(p_local, dtype=jnp.int32), n_dev)
            if cfg.adaptive_sampling == "on"
            else jnp.zeros((n_dev,), jnp.int32)),
        bsdf_pdf=sharded(jnp.ones(
            (n_dev * (n if cfg.mis == "on" else 1),), jnp.float32)),
        sample_base=sharded(jnp.zeros((n_dev,), jnp.uint32)),
        sample_idx=sharded(jnp.zeros(
            (n_dev * (n if cfg.sampler == "sobol" else 1),), jnp.uint32)),
    )


def make_sharded_step(cfg: RenderConfig, mesh: Mesh,
                      sky_params: skymod.SkyParams | None = None):
    """Returns jitted step(state, scene, camera, sun_dir) -> state operating
    on the sharded global state.  The traversal follows the platform of the
    mesh's devices (ops.traverse.traversal_for)."""
    n_dev = mesh.devices.size
    local_h = cfg.height // n_dev
    sky_params = sky_params or skymod.SkyParams(cfg.sky)
    traversal = traversal_for(list(mesh.devices.flat))

    def local_step(state: RenderState, scene: SceneData, camera: CameraParams,
                   sun_dir):
        # leaves arrive with local shapes; scalars are length-1 slices
        st = RenderState(
            accum=state.accum, origin=state.origin, direction=state.direction,
            direct=state.direct, pending=state.pending,
            pixel=state.pixel, bounces=state.bounces,
            last_specular=state.last_specular,
            n_carried=state.n_carried[0],
            start_position=state.start_position[0],
            frame=state.frame[0],
            shadow_rays=state.shadow_rays[0],
            moment2=state.moment2, pixel_perm=state.pixel_perm,
            bsdf_pdf=state.bsdf_pdf,
            sample_base=state.sample_base[0],
            sample_idx=state.sample_idx)
        row_offset = jax.lax.axis_index(AXIS).astype(jnp.int32) * local_h
        out = render_step(st, scene, camera, sun_dir, cfg=cfg,
                          sky_params=sky_params, local_height=local_h,
                          row_offset=row_offset, traversal=traversal)
        return RenderState(
            accum=out.accum, origin=out.origin, direction=out.direction,
            direct=out.direct, pending=out.pending,
            pixel=out.pixel, bounces=out.bounces,
            last_specular=out.last_specular,
            n_carried=out.n_carried[None],
            start_position=out.start_position[None],
            frame=out.frame[None],
            shadow_rays=out.shadow_rays[None],
            moment2=out.moment2, pixel_perm=out.pixel_perm,
            bsdf_pdf=out.bsdf_pdf,
            sample_base=out.sample_base[None],
            sample_idx=out.sample_idx)

    # spec prefixes: every state leaf sharded on its leading axis; scene,
    # camera and sun direction fully replicated
    sharded = jax.shard_map(local_step, mesh=mesh,
                            in_specs=(P(AXIS), P(), P(), P()),
                            out_specs=P(AXIS))
    return jax.jit(sharded, donate_argnums=(0,))


def assemble_image(state: RenderState, cfg: RenderConfig):
    """Framebuffer gather — the one cross-device operation (SURVEY.md §2.3).
    The accum array is already the full image in row-strip order."""
    from ..ops.tonemap import resolve
    return resolve(state.accum, cfg.width, cfg.height,
                   operator=cfg.tonemap, exposure=cfg.exposure)


class ShardedRenderer:
    """Host wrapper mirroring render.Renderer for a device mesh."""

    def __init__(self, scene, cfg: RenderConfig, mesh: Mesh | None = None,
                 sun_position=(0.05, 0.3)):
        from ..scene.scene import Scene
        self.cfg = cfg
        self.mesh = mesh or make_mesh()
        self.scene = scene.to_device() if isinstance(scene, Scene) else scene
        self.sun_dir = skymod.sun_direction_from_position(
            jnp.asarray(sun_position, jnp.float32))
        self.traversal = traversal_for(list(self.mesh.devices.flat))
        self._step = make_sharded_step(cfg, self.mesh)
        self.state = init_sharded_state(cfg, self.mesh)
        self._last_pose = None
        self._adaptive = cfg.adaptive_sampling == "on"
        if self._adaptive:
            from ..adaptive import PermScheduler
            self._sched = PermScheduler(cfg.adaptive_interval)
            # per-strip priority rebuild: each shard ranks its own pixels
            # (local ids), so no cross-device data moves
            from ..adaptive import build_perm
            self._build_perm = jax.jit(jax.shard_map(
                partial(build_perm, gamma=cfg.adaptive_gamma),
                mesh=self.mesh, in_specs=(P(AXIS), P(AXIS), P()),
                out_specs=P(AXIS)))

    def step(self, camera, n_steps: int = 1):
        pose = camera.pose_key()
        if self._last_pose is not None and pose != self._last_pose:
            self.state = init_sharded_state(self.cfg, self.mesh)
        self._last_pose = pose
        cam = camera.to_device(self.cfg)
        for _ in range(n_steps):
            self.state = self._step(self.state, self.scene, cam, self.sun_dir)
        if self._adaptive:
            phase = self._sched.tick(n_steps)
            if phase is not None:
                self.state = dataclasses.replace(
                    self.state,
                    pixel_perm=self._build_perm(
                        self.state.accum, self.state.moment2,
                        jnp.asarray(phase, jnp.float32)))
        return self.state

    def image(self):
        return assemble_image(self.state, self.cfg)
