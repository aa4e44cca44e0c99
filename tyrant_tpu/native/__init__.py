"""Native (C++) host components: BVH builder, PLY loader.

The reference's host layer is all C++ (SURVEY.md §2.2); here the serial,
pointer-heavy, per-scene-load work (SAH build bvh.cpp:61-212, mesh import
Scene.cpp/static_mesh.cpp) stays native while the compute path is
JAX/XLA (plus the CUDA traversal kernels of ops/cuda).  Bindings are ctypes over a plain C ABI (no pybind11 in this
image); the shared library is compiled on first use with g++ and cached next
to the sources.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libtyrant_native.so")
_SOURCES = ["bvh_builder.cpp", "ply_loader.cpp"]
_lock = threading.Lock()
_lib = None


def _needs_rebuild() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    return any(
        os.path.getmtime(os.path.join(_DIR, s)) > lib_mtime
        for s in _SOURCES if os.path.exists(os.path.join(_DIR, s)))


def build_library() -> str:
    srcs = [os.path.join(_DIR, s) for s in _SOURCES
            if os.path.exists(os.path.join(_DIR, s))]
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
           "-o", _LIB_PATH] + srcs
    # -march=native when the toolchain supports it
    probe = subprocess.run(["g++", "-march=native", "-E", "-x", "c++",
                            "/dev/null"], capture_output=True)
    if probe.returncode == 0:
        cmd.insert(1, "-march=native")
    subprocess.run(cmd, check=True, capture_output=True)
    return _LIB_PATH


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            if _needs_rebuild():
                build_library()
            _lib = ctypes.CDLL(_LIB_PATH)
        return _lib
