"""CUDA BVH traversal kernels, called as JAX operations through ``jax.ffi``.

One thread per ray, as in the reference renderer (bvh.h:118-161 closest
hit, bvh.h:213-256 any hit).  The traversal lives in ``traverse.h`` as
``__host__ __device__`` functions; ``traverse_gpu.cu`` wraps it in CUDA
kernels for Hopper (sm_90a) and ``traverse_cpu.cc`` in a host loop, so the
CPU tests run the same traversal code through the same wrappers.  Both read
the tables of :class:`tyrant_tpu.ops.traverse.BVHDevice` as they are and
register under the same target names, one per platform.

Each library is compiled from the sources here on first use (``nvcc`` for the
GPU, ``g++`` for the CPU) into ``build/`` beside them; a source newer than
its library triggers a rebuild.  Which implementation a render uses is
decided in one place, :func:`tyrant_tpu.ops.traverse.traversal_for`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp

from ...config import VERY_FAR

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "build")
_SOURCES = {"gpu": "traverse_gpu.cu", "cpu": "traverse_cpu.cc"}
_FFI_PLATFORM = {"gpu": "CUDA", "cpu": "cpu"}
_TARGETS = (("tyrant_closest_hit", "TyrantClosestHit"),
            ("tyrant_any_hit", "TyrantAnyHit"))
_lock = threading.Lock()
_registered: set[str] = set()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")


def _compile_command(platform: str, src: str, out: str) -> list[str]:
    inc = f"-I{jax.ffi.include_dir()}"
    if platform == "gpu":
        return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", inc,
                "-o", out, src]
    return ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", inc, "-o", out,
            src]


def build_library(platform: str) -> str:
    """Compile the traversal library for ``platform`` ("gpu" or "cpu") if
    it is missing or older than its sources; returns its path."""
    src = os.path.join(_DIR, _SOURCES[platform])
    out = os.path.join(_BUILD, f"libtyrant_traverse_{platform}.so")
    newest = max(os.path.getmtime(p)
                 for p in (src, os.path.join(_DIR, "traverse.h")))
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return out
    os.makedirs(_BUILD, exist_ok=True)
    # concurrent builders (test workers) each write their own file and
    # rename it into place, so a reader never loads a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(_compile_command(platform, src, tmp),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {os.path.basename(src)} failed:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def register(platform: str) -> None:
    """Load the library for ``platform`` and register its FFI targets."""
    with _lock:
        if platform in _registered:
            return
        if platform not in _SOURCES:
            raise ValueError(f"no traversal kernel for platform {platform!r}")
        lib = ctypes.cdll.LoadLibrary(build_library(platform))
        for name, symbol in _TARGETS:
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, symbol)),
                platform=_FFI_PLATFORM[platform])
        _registered.add(platform)


def _f32(x):
    return jnp.asarray(x, jnp.float32)


@jax.jit
def closest_hit(origin, direction, bvh, t_init=None):
    """Closest hit, same contract as :func:`tyrant_tpu.ops.traverse.closest_hit`:
    origin/direction [N, 3], optional t_init [N]; returns (t [N] f32,
    prim_id [N] i32) with t == t_init (or VERY_FAR) and id -1 on a miss.
    Any N works: the kernel guards its last block, so rays need no padding."""
    n = origin.shape[0]
    t_init = (jnp.full((n,), VERY_FAR, jnp.float32) if t_init is None
              else _f32(t_init))
    register(jax.default_backend())
    return jax.ffi.ffi_call(
        "tyrant_closest_hit",
        (jax.ShapeDtypeStruct((n,), jnp.float32),
         jax.ShapeDtypeStruct((n,), jnp.int32)))(
        _f32(origin), _f32(direction), t_init, bvh.node_packed,
        bvh.miss_flat, bvh.leaf_packed)


@jax.jit
def any_hit(origin, direction, max_dist, bvh, active=None):
    """Shadow-ray occlusion, same contract as
    :func:`tyrant_tpu.ops.traverse.any_hit`: occluded [N] bool; an inactive
    ray is never occluded."""
    n = origin.shape[0]
    active = (jnp.ones((n,), bool) if active is None
              else jnp.asarray(active, bool))
    register(jax.default_backend())
    return jax.ffi.ffi_call(
        "tyrant_any_hit", jax.ShapeDtypeStruct((n,), jnp.bool_))(
        _f32(origin), _f32(direction), _f32(max_dist), active,
        bvh.node_packed, bvh.miss_flat, bvh.leaf_packed)
