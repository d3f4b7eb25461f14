"""Sharded rendering: shard_map over the (sp, dp) mesh.

Replaces the reference's single-GPU launch (`render.h:129-158`) with an SPMD
program: every device traces the pixel range it owns (dp) for the sample
subset it owns (sp), partial radiance sums are `psum`-reduced over the sp axis,
and the output stays dp-sharded until the host gathers it.

Sample keys are folded by *global* sample index, so the sharded render is
numerically identical (modulo float add order) to the single-device
`engine.render.render_chunk` at equal settings — this is asserted in
tests/test_parallel.py.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .. import backend
from ..backend import Traversal
from ..core import rng
from ..core.camera import Camera
from ..core.config import RenderSettings
from ..engine.integrator import trace
from ..scene.types import Scene
from .mesh import DP_AXIS, SP_AXIS


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@partial(jax.jit, static_argnames=("settings", "mesh", "trace_fn"))
def render_chunk_sharded(scene: Scene, camera: Camera, settings: RenderSettings,
                         key: jax.Array, mesh, trace_fn=None) -> jax.Array:
    """One sample chunk on the mesh -> (npix_pad, 3) float32 sums.

    Output rows are dp-sharded across devices; convert with np.asarray to
    gather.  spp_per_chunk must be divisible by the sp axis size.
    trace_fn overrides `integrator.trace` (see `compile_sharded_renderer`).
    """
    if trace_fn is None:
        trace_fn = trace
    h, w = settings.image_height, settings.image_width
    npix = h * w
    n_sp = mesh.shape[SP_AXIS]
    n_dp = mesh.shape[DP_AXIS]
    if settings.spp_per_chunk % n_sp:
        raise ValueError(f"spp_per_chunk={settings.spp_per_chunk} not divisible "
                         f"by sp axis size {n_sp}")
    spp_local = settings.spp_per_chunk // n_sp

    b = min(settings.ray_batch, _ceil_to(npix, 8))
    npix_pad = _ceil_to(npix, b * n_dp)
    local_npix = npix_pad // n_dp
    nb = local_npix // b

    inv_w = 1.0 / max(w - 1, 1)
    inv_h = 1.0 / max(h - 1, 1)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P()),   # scene, camera, key replicated
        out_specs=P(DP_AXIS),
        check_vma=False,
    )
    def work(scene, camera, key):
        dp = jax.lax.axis_index(DP_AXIS)
        sp = jax.lax.axis_index(SP_AXIS)
        flat = dp * local_npix + jnp.arange(local_npix, dtype=jnp.int32)
        rows = jnp.minimum(flat // w, h - 1)
        cols = jnp.minimum(flat % w, w - 1)

        def sample_pass(s_local, acc):
            s_global = sp * spp_local + s_local
            ks = rng.fold(key, s_global)

            def wave(x):
                r, c, bid = x
                kb = rng.fold(ks, dp * nb + bid)
                k_jit, k_cam, k_trace = jax.random.split(kb, 3)
                jit2 = rng.uniform(k_jit, (b, 2))
                u = (c.astype(jnp.float32) + jit2[:, 0]) * inv_w
                v = ((h - 1 - r).astype(jnp.float32) + jit2[:, 1]) * inv_h
                o, d, tm = camera.get_rays(k_cam, u, v)
                return trace_fn(scene, o, d, tm, k_trace,
                                max_depth=settings.max_depth,
                                t_min=settings.t_min,
                                rr_start=settings.rr_start)

            out = jax.lax.map(
                wave,
                (rows.reshape(nb, b), cols.reshape(nb, b),
                 jnp.arange(nb, dtype=jnp.int32)),
            )
            return acc + out.reshape(local_npix, 3)

        sums = jax.lax.fori_loop(
            0, spp_local, sample_pass, jnp.zeros((local_npix, 3), jnp.float32)
        )
        # reduce the sample ensemble (reference: image-space averaging of
        # frame buffers, color.h:57-170)
        return jax.lax.psum(sums, SP_AXIS)

    return work(scene, camera, key)


def compile_sharded_renderer(scene: Scene, camera: Camera,
                             settings: RenderSettings, mesh,
                             traverse: Optional[Traversal] = None):
    """Scene-specialized SPMD renderer: key -> dp-sharded (npix_pad, 3) sums.

    The multi-device counterpart of `engine.render.compile_renderer`: the
    scene bakes into the compiled program (replicated per device — it is
    MBs, not GBs, SURVEY §5) and every device runs the bounce loop over the
    rays it owns.  traverse: as in `compile_renderer`.
    """
    traverse = traverse or backend.traversal()
    trace_fn = partial(trace, traverse=traverse)

    @jax.jit
    def chunk(key):
        return render_chunk_sharded(scene, camera, settings, key, mesh,
                                    trace_fn=trace_fn)

    chunk.traversal = traverse.name
    return chunk


def make_sharded_chunk_fn(mesh, scene=None, camera=None, settings=None):
    """Adapter with the `engine.render.render_chunk` signature, for use as
    `render_linear(..., chunk_fn=...)`.

    With (scene, camera, settings) given, the chunk is scene-specialized via
    `compile_sharded_renderer` — geometry baked as constants (the CLI
    `--sharded` path).  Without them, it is the generic traced-scene form
    (tests, changing scenes)."""
    compiled = None
    if scene is not None:
        compiled = compile_sharded_renderer(scene, camera, settings, mesh)

    def chunk(scene, camera, settings, key):
        if compiled is not None:
            out = compiled(key)
        else:
            out = render_chunk_sharded(scene, camera, settings, key, mesh)
        if jax.process_count() > 1:
            # multi-host: dp shards live on remote processes; gather the full
            # framebuffer to every host (it is MBs — the one DCN collective
            # this design needs, SURVEY §5)
            from jax.experimental import multihost_utils

            out = multihost_utils.process_allgather(out, tiled=True)
        h, w = settings.image_height, settings.image_width
        npix = h * w
        b = min(settings.ray_batch, _ceil_to(npix, 8))
        npix_pad_plain = _ceil_to(npix, b)
        out = jnp.asarray(out)[:npix]
        pad = npix_pad_plain - npix
        if pad:
            out = jnp.concatenate([out, jnp.zeros((pad, 3), out.dtype)])
        return out

    return chunk
