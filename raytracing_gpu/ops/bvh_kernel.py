"""Closest-hit BVH traversal kernel for NVIDIA GPUs (Pallas, Triton route).

The XLA form (`accel/traverse.py`) advances every ray of a wave by one
threaded link per `while_loop` trip, so the whole wave pays for its slowest
ray, and on a GPU every trip is a round of small kernels plus a predicate
read back by the host.  Here one program takes a block of rays and each lane
keeps its own int32 cursor in the stackless `hit_link` / `miss_link` walk
(`accel/bvh.py`), looping until its own block is done — the reference's
one-thread-per-ray walk (`bvh.h:348-436`).  Node boxes, links, leaf ids and
leaf primitives are gathered per lane from device memory (a 100k-triangle
BVH and its triangles are a few MB, which sit in L2); loads for lanes that
have nothing to test are masked off.

Leaf tests repeat `accel/traverse.py`'s math — Moller-Trumbore with
`_TRI_EPS`, the sphere quadratic with its near/far fallback and the
moving-sphere centre lerp.  The kernel writes the closest primitive's index
per ray; the wrapper evaluates its distance with that module's
`triangle_hits` / `sphere_hits`, so the result keeps its contract — (t, idx)
per ray, BIG / 0 on a miss, detached from autodiff — and the same primitive
gives the same t as the XLA walk.

The wrapper owns what surrounds the kernel: padding N to the block, the
row-packed node, link and primitive tables, and the ray columns.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..accel import traverse
from ..accel.traverse import _EPS_DIV, _TRI_EPS, BIG

BLOCK = 64       # rays per program (a power of two, 32 to 128)
NUM_WARPS = 1    # one warp per program: each thread walks BLOCK / 32 rays


def _safe_inv(d):
    return 1.0 / jnp.where(jnp.abs(d) < _EPS_DIV,
                           jnp.where(d >= 0, _EPS_DIV, -_EPS_DIV), d)


def _gather(ref, row, col, mask, other):
    return plgpu.load(ref.at[row, col], mask=mask, other=other)


def _tri_leaf(prims_ref, q, m, o, d, tm, t_min, t_best):
    """Moller-Trumbore against one gathered triangle per lane
    (`accel.traverse.traverse_triangles`)."""
    del tm
    g = [_gather(prims_ref, q, c, m, 0.0) for c in range(9)]
    v0, e1, e2 = g[0:3], g[3:6], g[6:9]
    h = _cross(d, e2)
    a = _dot(e1, h)
    f = 1.0 / jnp.where(jnp.abs(a) < _TRI_EPS, _TRI_EPS, a)
    s = [o[i] - v0[i] for i in range(3)]
    u = f * _dot(s, h)
    qv = _cross(s, e1)
    v = f * _dot(d, qv)
    t = f * _dot(e2, qv)
    ok = (m & (jnp.abs(a) > _TRI_EPS)
          & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= max(t_min, _TRI_EPS)) & (t <= t_best))
    return jnp.where(ok, t, BIG)


def _sphere_leaf(prims_ref, q, m, o, d, tm, t_min, t_best):
    """Sphere quadratic with the near/far fallback and a per-ray-time centre
    (`accel.traverse.traverse_spheres`).  Rows hold c0, c1 - c0, time0, the
    guarded time span and r^2, each computed as that function computes it."""
    g = [_gather(prims_ref, q, c, m, 1.0) for c in range(9)]
    frac = (tm - g[6]) / g[7]
    oc = [o[i] - (g[i] + frac * g[3 + i]) for i in range(3)]
    a = _dot(d, d)
    half_b = _dot(oc, d)
    c = _dot(oc, oc) - g[8]
    disc = half_b * half_b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / jnp.maximum(a, _EPS_DIV)
    near = (-half_b - sq) * inv_a
    far = (-half_b + sq) * inv_a
    ok = m & (disc > 0)
    ok_near = ok & (near >= t_min) & (near <= t_best)
    ok_far = ok & (far >= t_min) & (far <= t_best)
    return jnp.where(ok_near, near, jnp.where(ok_far, far, BIG))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _walk_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tm_ref,
                 tmax_ref, nodes_ref, links_ref, prims_ref, i_ref, *,
                 leaf, n, block, leaf_k, t_min):
    lane = pl.program_id(0) * block + jax.lax.iota(jnp.int32, block)
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    tm = tm_ref[...]
    inv = tuple(_safe_inv(x) for x in d)

    def cond(state):
        return jnp.max(state[0]) >= 0

    def body(state):
        node, t_best, i_best = state
        live = node >= 0
        nid = jnp.maximum(node, 0)
        tn = tf = None
        for ax in range(3):
            t0 = (_gather(nodes_ref, nid, ax, live, 0.0) - o[ax]) * inv[ax]
            t1 = (_gather(nodes_ref, nid, 3 + ax, live, 0.0) - o[ax]) * inv[ax]
            lo, hi = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
            tn = lo if tn is None else jnp.maximum(tn, lo)
            tf = hi if tf is None else jnp.minimum(tf, hi)
        hit_box = live & (tf >= jnp.maximum(tn, t_min)) & (tn <= t_best)

        # the leaf's <= leaf_k primitives: the first strictly closer one
        # wins ties, as argmin does in the XLA form
        t_new, i_new = t_best, i_best
        for k in range(leaf_k):
            prim = _gather(links_ref, nid, 2 + k, hit_box, -1)
            valid = hit_box & (prim >= 0)
            t_k = leaf(prims_ref, jnp.maximum(prim, 0), valid, o, d, tm,
                       t_min, t_best)
            better = t_k < t_new
            t_new = jnp.where(better, t_k, t_new)
            i_new = jnp.where(better, prim, i_new)

        hit_l = _gather(links_ref, nid, 0, live, -1)
        miss_l = _gather(links_ref, nid, 1, live, -1)
        node = jnp.where(live, jnp.where(hit_box, hit_l, miss_l), -1)
        return node, t_new, i_new

    node0 = jnp.where(lane < n, 0, -1)
    t0 = jnp.minimum(tmax_ref[...], BIG)
    state = (node0, t0, jnp.full((block,), -1, jnp.int32))
    i_ref[...] = jax.lax.while_loop(cond, body, state)[2]


def _closest(leaf, bvh, prims, o, d, tm, t_min, t_max, block, name,
             **pallas_kw):
    """The closest primitive's index per ray, -1 on a miss."""
    n = o.shape[0]
    n_pad = -(-n // block) * block
    rays = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], tm,
            jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))]
    rays = [jnp.pad(r.astype(jnp.float32), (0, n_pad - n)) for r in rays]
    nodes = jnp.concatenate([bvh.node_min, bvh.node_max], axis=1)
    links = jnp.concatenate([bvh.hit_link[:, None], bvh.miss_link[:, None],
                             bvh.leaf_prims], axis=1).astype(jnp.int32)
    tables = jax.lax.stop_gradient((nodes, links, prims))

    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    table_spec = lambda a: pl.BlockSpec(a.shape, lambda i: (0, 0))
    kernel = partial(_walk_kernel, leaf=leaf, n=n, block=block,
                     leaf_k=bvh.leaf_prims.shape[1], t_min=float(t_min))
    idx = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        grid=(n_pad // block,),
        in_specs=[ray_spec] * 8 + [table_spec(a) for a in tables],
        out_specs=ray_spec,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        name=name,
        **pallas_kw,
    )(*rays, *tables)
    return idx[:n]


def closest_triangles(scene, o, d, t_min, t_max=BIG, *, block=BLOCK,
                      **pallas_kw):
    """(t, idx) of the closest triangle through the scene's triangle BVH;
    the kernel form of `accel.traverse.traverse_triangles`."""
    o, d = jax.lax.stop_gradient((o, d))
    tr = scene.triangles
    prims = jnp.concatenate([tr.v0, tr.e1, tr.e2], axis=1)
    tm = jnp.zeros(o.shape[:1], jnp.float32)
    i_best = _closest(_tri_leaf, scene.tri_bvh, prims, o, d, tm, t_min, t_max,
                      block, "bvh_closest_triangles", **pallas_kw)
    return traverse.triangle_hits(scene, i_best, o, d)


def closest_spheres(scene, o, d, tm, t_min, t_max=BIG, *, block=BLOCK,
                    **pallas_kw):
    """(t, idx) of the closest non-medium sphere through the scene's sphere
    BVH; the kernel form of `accel.traverse.traverse_spheres`."""
    o, d, tm = jax.lax.stop_gradient((o, d, tm))
    sp = scene.spheres
    span = sp.time1 - sp.time0
    denom = jnp.where(jnp.abs(span) < 1e-12, 1.0, span)
    prims = jnp.concatenate(
        [sp.center0, sp.center1 - sp.center0, sp.time0[:, None],
         denom[:, None], (sp.radius ** 2)[:, None]], axis=1)
    i_best = _closest(_sphere_leaf, scene.sphere_bvh, prims, o, d, tm, t_min,
                      t_max, block, "bvh_closest_spheres", **pallas_kw)
    return traverse.sphere_hits(scene, i_best, o, d, tm, t_min)
