"""The one place that looks at the device.

It picks the BVH traversal the renderers compile in (the traversal kernel of
`ops/bvh_kernel.py` on an NVIDIA GPU, the XLA form of `accel/traverse.py`
elsewhere) and places JAX's persistent compile cache.  Entry points call
`setup_compile_cache()` before their first compile.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


class Traversal(NamedTuple):
    """Closest-hit search through each BVH type.

    triangles(scene, o, d, t_min, t_max) -> (t, idx)
    spheres(scene, o, d, tm, t_min, t_max) -> (t, idx)
    """

    name: str
    triangles: Callable
    spheres: Callable


def xla_traversal() -> Traversal:
    from .accel import traverse

    return Traversal("xla", traverse.traverse_triangles,
                     traverse.traverse_spheres)


def kernel_traversal() -> Traversal:
    from .ops import bvh_kernel

    return Traversal("kernel", bvh_kernel.closest_triangles,
                     bvh_kernel.closest_spheres)


def platform() -> str:
    """Platform the next computation runs on: the default device's, when one
    is set (`jax.default_device`), else the default backend's."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def traversal() -> Traversal:
    """The traversal for the current platform."""
    return kernel_traversal() if platform() == "gpu" else xla_traversal()


def setup_compile_cache() -> str:
    """Keep compiled programs across processes; returns the cache directory.

    With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and nothing is
    set here.  Otherwise the cache is the fixed `.jax_cache/` at the
    repository root (a fixed path, because the path is part of the key).
    """
    path = os.environ.get(CACHE_ENV)
    if path:
        return path
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
