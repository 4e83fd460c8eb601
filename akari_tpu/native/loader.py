"""Build + load the native BVH builder (ctypes; no pybind11 needed).

The library is compiled from ``bvh_builder.cpp`` at first use into
``build/`` beside it (git-ignored); nothing binary is committed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
_LIB = os.path.join(_DIR, "build", "libakr_bvh.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _compile():
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    # build under a per-process name, then rename: concurrent first uses
    # (test workers) never load a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        "-o", tmp, _SRC, "-lpthread",
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, _LIB)


def get_bvh_lib():
    """Returns the loaded ctypes library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
            ):
                _compile()
            lib = ctypes.CDLL(_LIB)
            lib.akr_bvh_build.restype = ctypes.c_int
            lib.akr_bvh_build.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # p0
                ctypes.POINTER(ctypes.c_float),  # p1
                ctypes.POINTER(ctypes.c_float),  # p2
                ctypes.c_int64,                  # n_tris
                ctypes.c_int,                    # max_leaf
                ctypes.POINTER(ctypes.c_float),  # node_lo
                ctypes.POINTER(ctypes.c_float),  # node_hi
                ctypes.POINTER(ctypes.c_int32),  # first
                ctypes.POINTER(ctypes.c_int32),  # count
                ctypes.POINTER(ctypes.c_int32),  # miss
                ctypes.POINTER(ctypes.c_int32),  # order
                ctypes.c_int64,                  # max_nodes
                ctypes.POINTER(ctypes.c_int64),  # out_n_nodes
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            from ..utils.logger import get_logger

            detail = getattr(e, "stderr", None) or str(e)
            get_logger().warning(
                f"native BVH builder unavailable, using the Python "
                f"builder: {detail.strip()[-500:]}"
            )
            _lib = None
        return _lib


def native_available():
    return get_bvh_lib() is not None
