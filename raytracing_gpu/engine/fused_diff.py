"""Hand-scheduled VJP for the differentiable render chunk.

`compile_param_renderer` differentiates the shading chain with XLA autodiff
inside the spp x wave loops, which stacks per-bounce residuals and
bookkeeping around the wave loop.  The radiance estimator has a closed-form
adjoint, so this module writes the backward pass by hand instead.

Per lane, the shading chain over the bounces recorded by the detached walk
(`integrator.trace_bounces`, reference `render.h:55-81`) is

    L = sum_b T_b * E_b,   T_0 = 1,   T_{b+1} = T_b * F_b
    E_b = miss_b * background + hit_b * emit_b
    F_b = cont_b * att_b + (1 - cont_b)

whose adjoint is another linear chain: with the suffix sum
S_b = E_b + F_b * S_{b+1} (so L = S_0),

    dL/d att_b  = g * T_b * S_{b+1} * cont_b
    dL/d emit_b = g * T_b * hit_b

Everything parameter-dependent sits behind one flattened `materials.shade`
call per wave, so the whole backward pass is: the recorded bounces through
one shade forward, two tiny scans (prefix product T, suffix sum S), and ONE
shade VJP — no per-bounce residuals, no stacking, no reversed outer scan.
The chunk-level `jax.custom_vjp` below makes this transparent to `jax.grad`.

The primal is compile_param_renderer's (same keys, same walk, same shade
math, since `trace_diff` is `shade_radiance(trace_bounces(...))`) — tests
assert primal equality and gradient allclose.

Reference parity: this subsystem has no reference analogue (the reference is
forward-only); it serves the differentiable requirement (BASELINE.md:
gradients to material/texture/emitter parameters).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import Array

from .. import backend
from ..backend import Traversal
from ..core import rng
from ..core.camera import Camera
from ..core.config import RenderSettings
from ..scene import materials as materials_mod
from ..scene.types import Scene
from . import diff
from .integrator import BounceData, shade_radiance, trace_bounces
from .render import _ceil_to

# keep the recorded bounces as the VJP residual (instead of walking again in
# the backward pass) while they fit in this many bytes
SAVE_BYTES = 1 << 30


def _shade_chain_bwd(scene0: Scene, params, data: BounceData, g):
    """d<g, L(params)> / d params for one wave, by the closed-form adjoint.

    scene0 is the concrete baked scene (params overwrite its differentiable
    leaves); data are the wave's recorded bounces; g is the incoming
    radiance cotangent (N, 3).
    """
    d_, n = data.mat_id.shape
    h = data.hit.astype(jnp.float32)[..., None]    # (D, N, 1)
    m = data.miss.astype(jnp.float32)[..., None]
    c = data.cont.astype(jnp.float32)[..., None]

    # one flattened shade call per wave: the ONLY parameter-dependent code
    def shade_flat(p):
        sc = diff.set_params(scene0, p)
        return materials_mod.shade(
            sc, data.mat_id.reshape(-1), data.u.reshape(-1),
            data.v.reshape(-1), data.p.reshape(-1, 3))

    (att_f, emit_f), shade_vjp = jax.vjp(shade_flat, params)
    att = att_f.reshape(d_, n, 3)
    emit = emit_f.reshape(d_, n, 3)

    bg = jnp.asarray(scene0.background, jnp.float32)
    e_term = m * bg + h * emit                      # E_b
    f_term = c * att + (1.0 - c)                    # F_b

    # T_b: exclusive prefix product of F along the bounce axis
    t_chain = jnp.concatenate(
        [jnp.ones((1, n, 3), jnp.float32), jnp.cumprod(f_term, axis=0)[:-1]],
        axis=0)

    # S_{b+1}: suffix sum S_b = E_b + F_b S_{b+1}, shifted down one bounce
    def rev(s, x):
        e, f = x
        s = e + f * s
        return s, s

    _, s_chain = jax.lax.scan(rev, jnp.zeros((n, 3), jnp.float32),
                              (e_term, f_term), reverse=True)
    s_next = jnp.concatenate(
        [s_chain[1:], jnp.zeros((1, n, 3), jnp.float32)], axis=0)

    g_att = (g[None] * t_chain * s_next * c).reshape(-1, 3)
    g_emit = (g[None] * t_chain * h).reshape(-1, 3)
    (d_params,) = shade_vjp((g_att, g_emit))
    return d_params


def _chunk_vjp(scene: Scene, walk, save: bool, indices, nb_local: int,
               sp_axis: Optional[str] = None):
    """The chunk (params, keyf) -> sums as a custom_vjp over its waves.

    walk(key, s, bid) -> one wave's BounceData; indices() -> (s_idx, b_idx,
    b_local): the global sample and wave index of each wave this device runs
    and its row block in the device's output (called where it is used, since
    under shard_map they depend on the device's mesh position).  With
    sp_axis (under shard_map) the chunk is the psum of the partial sums over
    that sample axis.  The key enters as its raw uint32 key data bitcast to f32, so
    the custom_vjp signature is all-float (integer/key cotangents would need
    float0 plumbing; the bitcast compiles away).
    """
    def key_of(keyf):
        return jax.random.wrap_key_data(
            jax.lax.bitcast_convert_type(keyf, jnp.uint32))

    def forward(params, keyf, keep):
        key = key_of(keyf)
        scene_p = diff.set_params(scene, params)
        s_idx, b_idx, _ = indices()

        def one(x):
            data = walk(key, *x)
            rad = shade_radiance(scene_p, data)
            return (rad, data) if keep else rad

        out = jax.lax.map(one, (s_idx, b_idx))
        rads, datas = out if keep else (out, None)
        b = rads.shape[1]
        sums = rads.reshape(-1, nb_local * b, 3).sum(0)
        if sp_axis is not None:
            sums = jax.lax.psum(sums, sp_axis)
        return sums, datas

    @jax.custom_vjp
    def chunk_cvjp(params, keyf):
        return forward(params, keyf, False)[0]

    def chunk_fwd(params, keyf):
        out, datas = forward(params, keyf, save)
        return out, (params, keyf, datas)

    def chunk_bwd(res, g):
        params, keyf, datas = res
        key = key_of(keyf)
        if sp_axis is not None:
            # the region output is sp-replicated but declared P(dp), so
            # shard_map's transpose hands each device 1/n_sp of the true
            # cotangent; the transpose of the forward psum is itself a psum,
            # which restores it
            g = jax.lax.psum(g, sp_axis)
        b = g.shape[0] // nb_local
        g_waves = g.reshape(nb_local, b, 3)
        s_idx, b_idx, b_local = indices()

        def one(acc, x):
            if datas is None:
                # walk again (deterministic in the key): fwd kept only
                # (params, key)
                s, bid, bl = x
                data = walk(key, s, bid)
            else:
                bl, data = x
            d_p = _shade_chain_bwd(scene, params, data, g_waves[bl])
            return jax.tree.map(jnp.add, acc, d_p), None

        zeros = jax.tree.map(jnp.zeros_like, params)
        xs = (s_idx, b_idx, b_local) if datas is None else (b_local, datas)
        d_params, _ = jax.lax.scan(one, zeros, xs)
        return d_params, jnp.zeros_like(keyf)

    chunk_cvjp.defvjp(chunk_fwd, chunk_bwd)
    return chunk_cvjp


def compile_fused_param_renderer(
    scene: Scene, camera: Camera, settings: RenderSettings,
    save_planes: bool | None = None, mesh=None,
    traverse: Optional[Traversal] = None,
) -> Callable[[dict, Array], Array]:
    """Differentiable chunk renderer (params, key) -> (npix_pad, 3) sums with
    a hand-written custom VJP.

    Drop-in replacement for engine.render.compile_param_renderer: identical
    primal values (same key schedule, same walk), allclose gradients.

    save_planes: keep the recorded bounces as the VJP residual and skip the
    second walk in the backward pass (memory for time).  Default: on when
    they fit in SAVE_BYTES.

    mesh: an (sp, dp) `parallel.mesh.make_mesh` mesh — the whole walk and
    adjoint then run inside shard_map (each device owns an spp slice x pixel
    slice; radiance psum over sp, parameter cotangents psum over the whole
    mesh via the shard_map transpose of the replicated params input).  Wave
    keys fold by GLOBAL sample/wave index, so the sharded render equals the
    single-device one up to float summation order (tests/test_parallel.py).
    The output is dp-sharded (npix_pad rows, padded to b * n_dp).

    traverse: as in `engine.render.compile_renderer`.
    """
    traverse = traverse or backend.traversal()
    h, w = settings.image_height, settings.image_width
    npix = h * w
    spp = settings.spp_per_chunk
    max_depth, t_min = settings.max_depth, settings.t_min
    n_sp, n_dp = 1, 1
    if mesh is not None:
        from ..parallel.mesh import DP_AXIS, SP_AXIS

        n_sp, n_dp = mesh.shape[SP_AXIS], mesh.shape[DP_AXIS]
        if spp % n_sp:
            raise ValueError(f"spp_per_chunk={spp} not divisible by sp={n_sp}")
    spp_local = spp // n_sp
    b = min(settings.ray_batch, _ceil_to(npix, 8))
    npix_pad = _ceil_to(npix, b * n_dp)
    nb_local = npix_pad // n_dp // b
    inv_w = 1.0 / max(w - 1, 1)
    inv_h = 1.0 / max(h - 1, 1)

    # bytes per ray per bounce of BounceData: mat_id, u, v, p, three masks
    record_bytes = spp_local * nb_local * b * max_depth * (4 * 6 + 3)
    save = record_bytes <= SAVE_BYTES if save_planes is None else save_planes

    def walk(key, s, bid):
        """One wave's recorded bounces by GLOBAL sample/wave index — exactly
        `render.chunk_sums`' key schedule."""
        kb = rng.fold(rng.fold(key, s), bid)
        k_jit, k_cam, k_trace = jax.random.split(kb, 3)
        jit2 = rng.uniform(k_jit, (b, 2))
        flat = bid * b + jnp.arange(b, dtype=jnp.int32)
        r = jnp.minimum(flat // w, h - 1)
        c = jnp.minimum(flat % w, w - 1)
        u = (c.astype(jnp.float32) + jit2[:, 0]) * inv_w
        v = ((h - 1 - r).astype(jnp.float32) + jit2[:, 1]) * inv_h
        o, d, tm = camera.get_rays(k_cam, u, v)
        return trace_bounces(scene, o, d, tm, k_trace, max_depth=max_depth,
                             t_min=t_min, traverse=traverse)

    s_l = jnp.repeat(jnp.arange(spp_local, dtype=jnp.int32), nb_local)
    b_l = jnp.tile(jnp.arange(nb_local, dtype=jnp.int32), spp_local)

    if mesh is None:
        chunk_cvjp = _chunk_vjp(scene, walk, save, lambda: (s_l, b_l, b_l),
                                nb_local)

        @jax.jit
        def chunk(params, key):
            return chunk_cvjp(params, _key_bits(key))

        chunk.traversal = traverse.name
        return chunk

    from jax.sharding import PartitionSpec as P

    def indices():
        # global sample / wave indices of the waves this device owns
        s_g = jax.lax.axis_index(SP_AXIS) * spp_local + s_l
        b_g = jax.lax.axis_index(DP_AXIS) * nb_local + b_l
        return s_g, b_g, b_l

    region = _chunk_vjp(scene, walk, save, indices, nb_local, SP_AXIS)
    sharded = jax.shard_map(region, mesh=mesh, in_specs=(P(), P()),
                            out_specs=P(DP_AXIS), check_vma=False)

    @jax.jit
    def chunk(params, key):
        return sharded(params, _key_bits(key))

    chunk.traversal = traverse.name
    return chunk


def _key_bits(key):
    return jax.lax.bitcast_convert_type(jax.random.key_data(key), jnp.float32)
