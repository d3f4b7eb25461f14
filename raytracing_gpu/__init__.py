"""raytracing_gpu — a differentiable path tracer in JAX.

A JAX/XLA re-design (not a port) of the capability set of the reference CUDA
renderer daRoyalCacti/Raytracing_GPU: scenes are packed SoA pytrees, the
per-thread bounce loop is a wavefront `lax.scan`, BVHs are host-built and
traversed stacklessly on device (a Pallas kernel on NVIDIA GPUs), shading is
differentiable, and ray batches shard across device meshes with
`shard_map`/`psum`.
"""

from .core.camera import Camera
from .core.config import RenderSettings
from .engine.render import render, render_linear
from .scene.builder import BLACK, SKY, SceneBuilder

__all__ = [
    "Camera",
    "RenderSettings",
    "SceneBuilder",
    "SKY",
    "BLACK",
    "render",
    "render_linear",
]

__version__ = "0.2.0"
