"""The CUDA traversal kernels (tyrant_tpu/ops/cuda) against the XLA cascade.

On the CPU the kernels' traversal header (traverse.h) runs as its host
build, through the same FFI wrapper the GPU path calls; the tests marked
``gpu`` run the compiled CUDA kernels on the card (``python chip_smoke.py``).
The limits are those of tyrant_tpu/bench/equivalence.py: ids exact except
ties within EPSILON, t within rtol 1e-4, occlusion exact.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tyrant_tpu.bench.equivalence import compare_any, compare_closest, gate_rays
from tyrant_tpu.config import BVHConfig, RenderConfig
from tyrant_tpu.ops import cuda, traverse
from tyrant_tpu.scene.procgen import terrain
from tyrant_tpu.scene.scene import Scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _soup():
    r = np.random.default_rng(5)
    c = r.uniform(-20, 20, (300, 1, 3))
    v = (c + r.normal(scale=2.0, size=(300, 3, 3))).astype(np.float32)
    return Scene.from_triangles(v[:, 0], v[:, 1], v[:, 2], builder="numpy")


def _terrain():
    return Scene.from_triangles(*terrain(n_quads=16, towers=2),
                                builder="numpy")


def _single():
    v0 = np.array([[-5.0, -5.0, 0.0]], np.float32)
    v1 = np.array([[5.0, -5.0, 0.0]], np.float32)
    v2 = np.array([[0.0, 5.0, 0.0]], np.float32)
    return Scene.from_triangles(v0, v1, v2, builder="numpy")


def _empty_leaf_heavy():
    """One triangle per leaf: five of every leaf row's six slots are empty
    padding the traversal must skip."""
    r = np.random.default_rng(6)
    c = r.uniform(-30, 30, (200, 1, 3))
    v = (c + r.normal(scale=1.0, size=(200, 3, 3))).astype(np.float32)
    return Scene.from_triangles(v[:, 0], v[:, 1], v[:, 2], builder="numpy",
                                bvh_cfg=BVHConfig(max_prims_per_leaf=1))


SCENES = {"soup": _soup, "terrain": _terrain, "single": _single,
          "empty_leaf_heavy": _empty_leaf_heavy}


@functools.lru_cache(maxsize=None)
def _bvh(name):
    return SCENES[name]().to_device().bvh


@functools.lru_cache(maxsize=None)
def _rays(name, n):
    bvh = _bvh(name)
    o, d = gate_rays(bvh, n, seed=n)
    if name == "single":
        # aim most rays at the lone triangle from above
        r = np.random.default_rng(n)
        o = np.stack([r.uniform(-8, 8, n), r.uniform(-8, 8, n),
                      np.full(n, 10.0)], 1).astype(np.float32)
        tgt = np.stack([r.uniform(-6, 6, n), r.uniform(-6, 6, n),
                        np.zeros(n)], 1)
        d = (tgt - o).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    t, ids = traverse.closest_hit(o, d, bvh)
    return o, d, np.asarray(t), np.asarray(ids)


def _limits(n, t, ids, bvh):
    """Per-ray seeds/limits: just past or short of the closest hit."""
    scale = np.where(np.arange(n) % 3 == 0, 0.99, 1.01)
    node = np.asarray(bvh.node_packed)
    extent = float((node[0, 3:6] - node[0, 0:3]).max()) + 1.0
    return np.where(ids >= 0, t * scale, extent).astype(np.float32)


@pytest.mark.parametrize("n", [1, 1000, 4099])
@pytest.mark.parametrize("kind", ["closest", "closest_t_init",
                                  "any_max_dist", "any_active"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_host_build_matches_cascade(scene, kind, n):
    bvh = _bvh(scene)
    o, d, t, ids = _rays(scene, n)
    if kind == "closest":
        res = compare_closest(t, ids, *cuda.closest_hit(o, d, bvh))
        assert res["id_bad"] == 0 and res["t_bad"] == 0, res
    elif kind == "closest_t_init":
        seed = _limits(n, t, ids, bvh)
        seed = jnp.asarray(np.where(np.arange(n) % 2 == 0, seed, 1e20)
                           .astype(np.float32))
        res = compare_closest(*traverse.closest_hit(o, d, bvh, t_init=seed),
                              *cuda.closest_hit(o, d, bvh, t_init=seed))
        assert res["id_bad"] == 0 and res["t_bad"] == 0, res
    else:
        maxd = jnp.asarray(_limits(n, t, ids, bvh))
        active = (None if kind == "any_max_dist"
                  else jnp.asarray(np.arange(n) % 4 != 3))
        res = compare_any(traverse.any_hit(o, d, maxd, bvh, active=active),
                          cuda.any_hit(o, d, maxd, bvh, active=active))
        assert res["occ_bad"] == 0, res
        if active is not None:
            occ = np.asarray(cuda.any_hit(o, d, maxd, bvh, active=active))
            assert not occ[np.arange(n) % 4 == 3].any()
    if n == 4099 and scene != "single":
        assert (ids >= 0).any() and (ids < 0).any()  # both hits and misses


@pytest.mark.parametrize("n", [0, 1, 4099])
def test_wrapper_shapes_and_dtypes(n):
    bvh = _bvh("soup")
    o = jax.ShapeDtypeStruct((n, 3), jnp.float32)
    t, ids = jax.eval_shape(lambda o, d: cuda.closest_hit(o, d, bvh), o, o)
    assert (t.shape, t.dtype) == ((n,), jnp.float32)
    assert (ids.shape, ids.dtype) == ((n,), jnp.int32)
    m = jax.ShapeDtypeStruct((n,), jnp.float32)
    occ = jax.eval_shape(lambda o, d, m: cuda.any_hit(o, d, m, bvh), o, o, m)
    assert (occ.shape, occ.dtype) == ((n,), jnp.bool_)


def test_wrapper_needs_no_padding():
    """A ragged batch (not a multiple of the 128-thread block) gives each
    ray the answer it gets inside a padded batch, and an empty batch
    returns empty arrays."""
    bvh = _bvh("terrain")
    o, d, t, ids = _rays("terrain", 4099)
    pad = 4224 - 4099
    o_p = jnp.concatenate([o, jnp.zeros((pad, 3), jnp.float32)])
    d_p = jnp.concatenate([d, jnp.ones((pad, 3), jnp.float32)])
    t_r, id_r = cuda.closest_hit(o, d, bvh)
    t_p, id_p = cuda.closest_hit(o_p, d_p, bvh)
    np.testing.assert_array_equal(np.asarray(t_p)[:4099], np.asarray(t_r))
    np.testing.assert_array_equal(np.asarray(id_p)[:4099], np.asarray(id_r))
    e = jnp.zeros((0, 3), jnp.float32)
    t_e, id_e = cuda.closest_hit(e, e, bvh)
    assert t_e.shape == (0,) and id_e.shape == (0,)
    assert cuda.any_hit(e, e, jnp.zeros((0,), jnp.float32), bvh).shape \
        == (0,)


class _Dev:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("platform,expected", [
    ("cpu", "xla"), ("gpu", "cuda"), ("rocm", "xla"), ("metal", "xla")])
def test_platform_rule(platform, expected):
    assert traverse.traversal_for([_Dev(platform)]) == expected


def test_renderer_uses_the_cascade_on_cpu():
    from tyrant_tpu.render import Renderer
    r = Renderer(_single(), RenderConfig(width=8, height=8, num_rays=64))
    assert r.traversal == "xla"


def test_compile_cache_rule(monkeypatch, tmp_path):
    from tyrant_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", None)
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir is None  # JAX reads env
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("scene", list(SCENES))
def test_cuda_kernels_match_cascade_on_card(gpu, scene):
    bvh = _bvh(scene)
    o, d, t, ids = _rays(scene, 4099)
    res = compare_closest(t, ids, *cuda.closest_hit(o, d, bvh))
    assert res["id_bad"] == 0 and res["t_bad"] == 0, res
    maxd = jnp.asarray(_limits(4099, t, ids, bvh))
    active = jnp.asarray(np.arange(4099) % 4 != 3)
    res = compare_any(traverse.any_hit(o, d, maxd, bvh, active=active),
                      cuda.any_hit(o, d, maxd, bvh, active=active))
    assert res["occ_bad"] == 0, res


@pytest.mark.gpu
def test_renderer_uses_the_kernels_on_card(gpu):
    from tyrant_tpu.render import Renderer
    from tyrant_tpu.camera import Camera

    r = Renderer(_terrain(), RenderConfig(width=64, height=48,
                                          num_rays=1 << 14))
    assert r.traversal == "cuda"
    cam = Camera()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    r.step(cam, 2)
    acc = np.asarray(r.state.accum)
    assert np.isfinite(acc).all() and acc[:, 3].sum() > 0


@pytest.mark.gpu
def test_sharded_renderer_on_one_card(gpu):
    from tyrant_tpu.camera import Camera
    from tyrant_tpu.parallel.sharded import ShardedRenderer, make_mesh

    r = ShardedRenderer(_terrain(), RenderConfig(width=64, height=48,
                                                 num_rays=1 << 14),
                        mesh=make_mesh(jax.devices()[:1]))
    cam = Camera()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    r.step(cam, 2)
    acc = np.asarray(r.state.accum)
    assert np.isfinite(acc).all() and acc[:, 3].sum() > 0
