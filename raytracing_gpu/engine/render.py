"""Render driver: sample chunks, wavefront batches, checkpoint/resume.

Replaces the reference `draw` host loop (`render.h:118-174`).  The reference
launches `no_fb` sequential whole-render kernel passes, dumping each frame buffer as an
8-bit PPM and averaging at the end.  Here each *chunk* (= frame buffer) is one
jitted XLA program that accumulates `spp_per_chunk` jittered samples for every
pixel; chunks accumulate into a float32 partial sum that is checkpointed after
every chunk (exact resume, no precision loss — see SURVEY §5 checkpoint notes).

Within a chunk, pixels are processed in `ray_batch`-sized waves via `lax.map`
(the wavefront analogue of the reference's 8x8 CUDA grid, `render.h:129-130`).

`compile_renderer` bakes the scene into the compiled program as XLA
constants, so the small primitive/material tables constant-fold into the
fused intersection expressions.  The differentiable path
(`compile_param_renderer`) keeps only the parameter pytree as traced
arguments and bakes the geometry.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from ..backend import Traversal
from ..core import rng
from ..core.camera import Camera
from ..core.config import RenderSettings
from ..scene.types import Scene
from . import film
from .integrator import trace, trace_diff


def _grid_geometry(settings: RenderSettings):
    h, w = settings.image_height, settings.image_width
    npix = h * w
    b = min(settings.ray_batch, _ceil_to(npix, 8))
    npix_pad = _ceil_to(npix, b)
    return h, w, npix, npix_pad, b, npix_pad // b


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def chunk_sums(scene: Scene, camera: Camera, settings: RenderSettings,
               key: jax.Array, trace_fn=trace) -> jax.Array:
    """One sample chunk (traceable body): (npix_pad, 3) float32 radiance sums
    over `spp_per_chunk` samples per pixel (one reference frame buffer,
    `render.h:94-113`)."""
    h, w, npix, npix_pad, b, nb = _grid_geometry(settings)

    flat = jnp.arange(npix_pad, dtype=jnp.int32)
    rows = jnp.minimum(flat // w, h - 1)
    cols = jnp.minimum(flat % w, w - 1)

    inv_w = 1.0 / max(w - 1, 1)
    inv_h = 1.0 / max(h - 1, 1)

    def sample_pass(s, acc):
        ks = rng.fold(key, s)

        def wave(x):
            r, c, bid = x
            kb = rng.fold(ks, bid)
            k_jit, k_cam, k_trace = jax.random.split(kb, 3)
            jit2 = rng.uniform(k_jit, (b, 2))
            # jittered viewport coords; canonical RTOW divides by (dim - 1)
            # (the reference divides by dim — SURVEY quirk 10, corrected here)
            u = (c.astype(jnp.float32) + jit2[:, 0]) * inv_w
            v = ((h - 1 - r).astype(jnp.float32) + jit2[:, 1]) * inv_h
            o, d, tm = camera.get_rays(k_cam, u, v)
            return trace_fn(scene, o, d, tm, k_trace,
                            max_depth=settings.max_depth, t_min=settings.t_min,
                            rr_start=settings.rr_start)

        out = jax.lax.map(
            wave,
            (rows.reshape(nb, b), cols.reshape(nb, b),
             jnp.arange(nb, dtype=jnp.int32)),
        )
        return acc + out.reshape(npix_pad, 3)

    init = jnp.zeros((npix_pad, 3), jnp.float32)
    return jax.lax.fori_loop(0, settings.spp_per_chunk, sample_pass, init)


# Jitted form with the scene as a traced argument (used by tests and anywhere
# the scene changes per call).  Slower than compile_renderer.
render_chunk = jax.jit(chunk_sums, static_argnames=("settings",))


def compile_renderer(scene: Scene, camera: Camera, settings: RenderSettings,
                     traverse: Optional[Traversal] = None
                     ) -> Callable[[jax.Array], jax.Array]:
    """Scene-specialized forward renderer: key -> (npix_pad, 3) sums.

    The scene/camera are closed over and become XLA constants.  traverse
    (tests only) overrides the BVH traversal `backend.traversal()` picks for
    this platform; the returned callable names it in `.traversal`.
    """
    traverse = traverse or backend.traversal()
    trace_fn = partial(trace, traverse=traverse)

    @jax.jit
    def chunk(key):
        return chunk_sums(scene, camera, settings, key, trace_fn=trace_fn)

    chunk.traversal = traverse.name
    return chunk


def compile_param_renderer(scene: Scene, camera: Camera,
                           settings: RenderSettings,
                           traverse: Optional[Traversal] = None):
    """Differentiable renderer: (params, key) -> (npix_pad, 3) sums.

    Geometry is baked as constants; only the parameter pytree
    (engine.diff.get_params) is traced — so gradients are available w.r.t.
    material/texture/emitter parameters at constant-folded speed.  The path
    walk is detached and only the shading chain is differentiated
    (`integrator.trace_diff`).  traverse: as in `compile_renderer`.
    """
    from . import diff

    traverse = traverse or backend.traversal()
    trace_fn = partial(trace_diff, traverse=traverse)

    @jax.jit
    def chunk(params, key):
        return chunk_sums(diff.set_params(scene, params), camera, settings, key,
                          trace_fn=trace_fn)

    chunk.traversal = traverse.name
    return chunk


def render_linear(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    seed: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    progress: Optional[Callable[[int, int, float], None]] = None,
    chunk_fn=None,
    timer=None,
) -> np.ndarray:
    """Full render -> (H, W, 3) mean linear radiance.

    The chunk loop is the reference's frame-buffer loop (`render.h:152-162`)
    and the checkpoint grain: with `checkpoint_dir`, float32 partial sums and
    the completed-chunk count are persisted after every chunk and the render
    resumes exactly where it stopped.

    timer: optional `utils.profiling.PhaseTimer`; collects the per-phase
    build (scene bake + compile) / trace (chunk dispatch + fetch) / io
    (checkpoint persist) split — the SURVEY §5 observability gauges replacing
    the reference's aggregate wall clock (`main.cu:39-45`).
    """
    from contextlib import nullcontext

    phase = timer.phase if timer is not None else (lambda _name: nullcontext())
    h, w, npix, npix_pad, _, _ = _grid_geometry(settings)
    key = jax.random.PRNGKey(settings.seed if seed is None else seed)

    sums = np.zeros((npix_pad, 3), np.float32)
    start_chunk = 0
    fp = ""
    if checkpoint_dir is not None:
        from ..utils import checkpoint as ckpt

        fp = ckpt.fingerprint(settings, settings.seed if seed is None else seed,
                              scene)
        state = ckpt.load(checkpoint_dir, expected_shape=(npix_pad, 3), fp=fp)
        if state is not None:
            sums, start_chunk = state

    if chunk_fn is None:
        with phase("build"):
            compiled = compile_renderer(scene, camera, settings)
        from ..utils.profiling import logger

        logger.info("BVH traversal: %s", compiled.traversal)
        chunk = lambda _s, _c, _st, k: compiled(k)
    else:
        chunk = chunk_fn
    for c in range(start_chunk, settings.num_chunks):
        t0 = time.perf_counter()
        ck = rng.fold(key, 0x5EED + c)
        with phase("trace"):
            out = chunk(scene, camera, settings, ck)
            sums += np.asarray(jax.block_until_ready(out))
        dt = time.perf_counter() - t0
        if checkpoint_dir is not None:
            with phase("io"):
                ckpt.save(checkpoint_dir, sums, c + 1, fp=fp)
        if progress is not None:
            progress(c + 1, settings.num_chunks, dt)

    return (sums[:npix] / float(settings.rays_per_pixel)).reshape(h, w, 3)


def render(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    seed: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    progress: Optional[Callable[[int, int, float], None]] = None,
) -> np.ndarray:
    """Full render -> (H, W, 3) gamma-2 image in [0, 1) (reference `draw`,
    `render.h:118-174`, minus the PPM/PNG round-trip)."""
    linear = render_linear(scene, camera, settings, seed=seed,
                           checkpoint_dir=checkpoint_dir, progress=progress)
    return film.finalize(linear * settings.rays_per_pixel, settings.rays_per_pixel)
