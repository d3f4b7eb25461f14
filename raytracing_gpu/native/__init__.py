"""Native (C++) runtime components, bound via ctypes.

The reference's runtime around the GPU compute path is C++ (host-side scene
prep, Assimp, stb); this package's native layer lives here: a binned-SAH
BVH builder compiled to a shared library.  The library is built on first use
(g++ is part of the image); every native entry point has a pure-numpy
fallback, so the package works without a compiler.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger("raytracing_gpu")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
_LIB = os.path.join(_DIR, "libnative_rt.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _compile() -> bool:
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", _LIB]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:  # no compiler / failed build -> numpy fallback
        logger.warning("native build failed (%s); using numpy fallback", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(_LIB) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        ):
            if not _compile():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
            lib.rt_build_bvh.restype = ctypes.c_int
            lib.rt_build_bvh.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # bounds_min
                ctypes.POINTER(ctypes.c_float),  # bounds_max
                ctypes.c_int,                    # n_prims
                ctypes.c_int,                    # leaf_size
                ctypes.POINTER(ctypes.c_float),  # node_min
                ctypes.POINTER(ctypes.c_float),  # node_max
                ctypes.POINTER(ctypes.c_int32),  # hit_link
                ctypes.POINTER(ctypes.c_int32),  # miss_link
                ctypes.POINTER(ctypes.c_int32),  # leaf_prims
                ctypes.c_int,                    # cap_nodes
            ]
            _lib = lib
        except OSError as e:
            logger.warning("native library load failed (%s)", e)
            _load_failed = True
    return _lib


def build_bvh_native(bounds_min: np.ndarray, bounds_max: np.ndarray,
                     leaf_size: int = 4):
    """Binned-SAH BVH build via the C++ library.

    Returns (node_min, node_max, hit_link, miss_link, leaf_prims) numpy arrays
    trimmed to the node count, or None if the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(bounds_min)
    cap = max(2 * n, 4)
    bmin = np.ascontiguousarray(bounds_min, np.float32)
    bmax = np.ascontiguousarray(bounds_max, np.float32)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    hit_link = np.empty(cap, np.int32)
    miss_link = np.empty(cap, np.int32)
    leaf_prims = np.empty((cap, leaf_size), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    count = lib.rt_build_bvh(
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp), n, leaf_size,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        hit_link.ctypes.data_as(ip), miss_link.ctypes.data_as(ip),
        leaf_prims.ctypes.data_as(ip), cap,
    )
    if count < 0:
        logger.warning("native BVH build overflowed; using numpy fallback")
        return None
    return (node_min[:count], node_max[:count], hit_link[:count],
            miss_link[:count], leaf_prims[:count])
