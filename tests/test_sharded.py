"""Multi-device sharding tests on the 8-virtual-CPU mesh (SURVEY.md §4
item 4: the mesh-without-a-cluster strategy)."""

import jax
import jax.numpy as jnp
import numpy as np

from tyrant_tpu.camera import Camera
from tyrant_tpu.config import small_config
from tyrant_tpu.parallel import sharded
from tyrant_tpu.render import Renderer
from tyrant_tpu.scene.scene import Scene


def _cam():
    cam = Camera()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.10
    return cam


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_step_runs_and_is_finite():
    cfg = small_config(width=16, height=16, num_rays=1 << 9)
    r = sharded.ShardedRenderer(Scene.load(None), cfg)
    r.step(_cam(), 3)
    acc = np.asarray(r.state.accum)
    assert acc.shape == (16 * 16, 4)
    assert np.isfinite(acc).all()
    assert (acc[:, 3] > 0).all()
    img = np.asarray(r.image())
    assert img.shape == (16, 16, 3)


def test_sharded_matches_single_device_statistically():
    """Each shard renders its own pixel strip; per-strip estimates must agree
    with a single-device render of the same scene within MC tolerance."""
    cfg = small_config(width=16, height=16, num_rays=1 << 11)
    cam = _cam()
    scene = Scene.load(None)

    rs = sharded.ShardedRenderer(scene, cfg)
    rs.step(cam, 40)
    img_s = np.asarray(rs.image())

    r1 = Renderer(scene, cfg, donate=False)
    r1.step(cam, 40)
    img_1 = np.asarray(r1.image())

    diff = np.abs(img_s - img_1)
    assert diff.mean() < 0.04, diff.mean()


def test_sharded_kernel_path_runs_with_host_build(monkeypatch):
    """The kernel path INSIDE shard_map: with the traversal forced to the
    kernels, the CPU mesh runs their host build (ops/cuda/traverse_cpu.cc)
    through the same FFI wrapper the GPU path calls, per shard with the
    scene replicated and shard_map's varying-axes check on — and renders
    what the cascade renders."""
    v0 = np.array([[-30, -90, 60], [30, -70, 60]], np.float32)
    v1 = np.array([[30, -90, 60], [-30, -90, 60]], np.float32)
    v2 = np.array([[30, -70, 60], [-30, -70, 60]], np.float32)
    scene = Scene.from_triangles(v0, v1, v2, builder="numpy")
    cfg = small_config(width=16, height=16, num_rays=1 << 11)
    ref = sharded.ShardedRenderer(scene, cfg)
    ref.step(_cam(), 2)
    monkeypatch.setattr(sharded, "traversal_for", lambda devices: "cuda")
    r = sharded.ShardedRenderer(scene, cfg)
    r.step(_cam(), 2)
    acc = np.asarray(r.state.accum)
    assert acc.shape == (16 * 16, 4)
    assert np.isfinite(acc).all()
    assert (acc[:, 3] > 0).all()
    np.testing.assert_allclose(acc, np.asarray(ref.state.accum),
                               rtol=1e-4, atol=1e-4)


def test_sharded_strips_cover_whole_image():
    # with a top-lit scene each strip must accumulate samples — catches
    # row-offset mistakes that would leave strips black or duplicated
    cfg = small_config(width=8, height=32, num_rays=1 << 9)
    r = sharded.ShardedRenderer(Scene.load(None), cfg)
    r.step(_cam(), 4)
    acc = np.asarray(r.state.accum).reshape(32, 8, 4)
    assert (acc[:, :, 3] > 0).all()
    # strips see different scene content (sky gradient): not all equal
    means = acc[:, :, :3].reshape(8, 4, 8, 3).mean((1, 2, 3))
    assert np.unique(np.round(means, 6)).size > 1


def test_sharded_blend_metal_flags_flow():
    """The round-3 SceneData aux flags (has_blend / has_metal_maps /
    has_var_ior) ride through shard_map: a blend+metal scene steps on the
    8-device mesh and stays finite (aux is static — a per-shard mismatch
    would fail at trace time)."""
    from tyrant_tpu.scene.scene import GGX, Scene

    v0 = np.array([[-20, -20, 0], [-20, -20, 0]], np.float32)
    v1 = np.array([[20, -20, 0], [20, 20, 0]], np.float32)
    v2 = np.array([[20, 20, 0], [-20, 20, 0]], np.float32)
    uv = np.tile(np.array([[[0, 0], [1, 0], [0, 1]]], np.float32),
                 (2, 1, 1))
    alpha_tex = np.ones((1, 1, 4), np.float32)
    alpha_tex[..., 3] = 0.5
    mr_tex = np.zeros((1, 1, 3), np.float32)
    mr_tex[..., :] = [0.3, 0.7, 0.3]
    scene = Scene.from_triangles(
        v0, v1, v2, builder="numpy", tri_uv=uv,
        tri_tex=np.array([0, -1], np.int32),
        tri_rtex=np.array([-1, 1], np.int32),
        textures=[alpha_tex, mr_tex],
        tri_refl=np.array([0, GGX], np.int32),
        tri_blend=np.array([True, False]),
        tri_metal=np.array([False, True]),
        tri_ior=np.array([1.2, 1.2], np.float32))
    sd = scene.to_device()
    assert sd.has_blend and sd.has_metal_maps
    cfg = small_config(width=16, height=16, num_rays=1 << 9)
    r = sharded.ShardedRenderer(scene, cfg)
    r.step(_cam(), 2)
    acc = np.asarray(r.state.accum)
    assert np.isfinite(acc).all()
    assert (acc[:, 3] > 0).all()
