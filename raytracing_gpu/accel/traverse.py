"""Stackless BVH traversal on device (XLA while-loop form).

Counterpart of the reference's single-ray stackless walk (`bvh.h:348-436`):
here the *whole ray batch* shares one `lax.while_loop`; each step advances
every ray's int32 node cursor by one threaded link (hit_link on AABB hit,
miss_link otherwise) and tests the <=K primitives of leaf nodes as one
vectorized gather+intersect.  The loop runs until every cursor is -1, so the
batch pays for its slowest ray.  This is the plain reference for the GPU
kernel in `ops/bvh_kernel.py`, and what runs on every other platform.
Either search only picks the closest primitive; `triangle_hits` and
`sphere_hits` then evaluate its distance with one shared function, so both
give the same t for the same primitive (near-tangent hits are too
ill-conditioned for two compilations of the leaf math to agree on t).
Traversal outputs are detached from autodiff (geometry gradients are out of
scope; see engine/diff.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from ..core import vec

BIG = 1e30  # plain float: also used as an argument default
_EPS_DIV = 1e-12
_TRI_EPS = 1e-7


def _safe_inv(d: Array) -> Array:
    return 1.0 / jnp.where(jnp.abs(d) < _EPS_DIV,
                           jnp.where(d >= 0, _EPS_DIV, -_EPS_DIV), d)


def _traverse(bvh, leaf_test, o, d, t_min, t_max):
    """Generic threaded-link traversal.

    leaf_test(prim_ids (N, K), t_best (N,)) -> t (N, K) candidate hits
    (BIG = miss; ids < 0 already masked by caller contract).
    Returns the closest primitive's index per ray (N,), -1 on a miss.
    """
    n = o.shape[0]
    inv = _safe_inv(d)  # (N, 3)

    def cond(state):
        node, _, _ = state
        return jnp.any(node >= 0)

    def body(state):
        node, t_best, i_best = state
        nid = jnp.maximum(node, 0)
        nmin = bvh.node_min[nid]  # (N, 3) gather
        nmax = bvh.node_max[nid]
        t0 = (nmin - o) * inv
        t1 = (nmax - o) * inv
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
        live = node >= 0
        hit_box = live & (tf >= jnp.maximum(tn, t_min)) & (tn <= t_best)

        prim_ids = bvh.leaf_prims[nid]  # (N, K) gather
        valid = hit_box[:, None] & (prim_ids >= 0)
        ts = jnp.where(valid, leaf_test(jnp.maximum(prim_ids, 0), t_best), BIG)
        k_best = jnp.argmin(ts, axis=1)
        t_k = jnp.take_along_axis(ts, k_best[:, None], axis=1)[:, 0]
        better = t_k < t_best
        t_best = jnp.where(better, t_k, t_best)
        i_best = jnp.where(
            better, jnp.take_along_axis(prim_ids, k_best[:, None], axis=1)[:, 0],
            i_best,
        )

        nxt = jnp.where(hit_box, bvh.hit_link[nid], bvh.miss_link[nid])
        node = jnp.where(live, nxt, -1)
        return node, t_best, i_best

    node0 = jnp.zeros(n, jnp.int32)
    t_init = jnp.minimum(jnp.full(n, BIG), t_max)
    state = jax.lax.while_loop(cond, body, (node0, t_init, jnp.full(n, -1, jnp.int32)))
    return state[2]


def _hits(i_best, t_of):
    """(t, idx) from the closest primitive's index per ray (-1 = miss):
    t = t_of(idx) on a hit, BIG / index 0 (safe to gather) on a miss."""
    idx = jnp.maximum(i_best, 0)
    t = jnp.where(i_best >= 0, t_of(idx), BIG)
    return jax.lax.stop_gradient(t), idx


def _moller_trumbore(v0, e1, e2, o, d):
    """(a, u, v, t) of rays o + t d against triangles (v0, e1, e2), all
    broadcast over the leading axes (reference `triangle.h:120-160`)."""
    h = vec.cross(d, e2)
    a = jnp.sum(e1 * h, -1)
    f = 1.0 / jnp.where(jnp.abs(a) < _TRI_EPS, _TRI_EPS, a)
    s = o - v0
    u = f * jnp.sum(s * h, -1)
    q = vec.cross(s, e1)
    v = f * jnp.sum(d * q, -1)
    t = f * jnp.sum(e2 * q, -1)
    return a, u, v, t


def triangle_hits(scene, i_best, o, d):
    """(t, idx) for the triangles found by a traversal (index -1 = miss).

    The search (this module's walk, or the GPU kernel) only picks the
    triangle; its distance is evaluated here, by the same code on every
    platform, so the same triangle gives the same t bit for bit.
    """
    tr = scene.triangles
    o, d = jax.lax.stop_gradient((o, d))
    return _hits(i_best, lambda idx: _moller_trumbore(
        tr.v0[idx], tr.e1[idx], tr.e2[idx], o, d)[3])


def traverse_triangles(scene, o, d, t_min, t_max=BIG):
    """(t, idx) closest triangle via the scene's triangle BVH.

    Leaf test = Moller-Trumbore on gathered triangle data
    (reference `triangle.h:120-160`), K triangles per step.
    """
    tr = scene.triangles
    o_sg, d_sg = jax.lax.stop_gradient((o, d))

    def leaf_test(ids, t_best):
        a, u, v, t = _moller_trumbore(tr.v0[ids], tr.e1[ids], tr.e2[ids],
                                      o_sg[:, None, :], d_sg[:, None, :])
        ok = (
            (jnp.abs(a) > _TRI_EPS)
            & (u >= 0.0) & (u <= 1.0)
            & (v >= 0.0) & (u + v <= 1.0)
            & (t >= jnp.maximum(t_min, _TRI_EPS)) & (t <= t_best[:, None])
        )
        return jnp.where(ok, t, BIG)

    i_best = _traverse(scene.tri_bvh, leaf_test, o_sg, d_sg, t_min, t_max)
    return triangle_hits(scene, i_best, o_sg, d_sg)


def _sphere_roots(sp, ids, o, d, tm):
    """(near, far, disc) of rays o + t d at times tm against spheres ids,
    all broadcast over the leading axes: the quadratic of reference
    `sphere.h:35-45` with per-ray-time lerped centres for moving spheres."""
    span = sp.time1[ids] - sp.time0[ids]
    denom = jnp.where(jnp.abs(span) < 1e-12, 1.0, span)
    frac = (tm - sp.time0[ids]) / denom
    center = sp.center0[ids] + frac[..., None] * (sp.center1[ids] - sp.center0[ids])
    oc = o - center
    a = vec.length_squared(d)
    half_b = jnp.sum(oc * d, -1)
    c = vec.length_squared(oc) - sp.radius[ids] ** 2
    disc = half_b * half_b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / jnp.maximum(a, _EPS_DIV)
    return (-half_b - sq) * inv_a, (-half_b + sq) * inv_a, disc


def sphere_hits(scene, i_best, o, d, tm, t_min):
    """(t, idx) for the spheres found by a traversal (index -1 = miss): the
    near root unless it lies before t_min, else the far one, evaluated by
    the same code on every platform (see `triangle_hits`)."""
    sp = scene.spheres
    o, d, tm = jax.lax.stop_gradient((o, d, tm))

    def t_of(idx):
        near, far, _ = _sphere_roots(sp, idx, o, d, tm)
        return jnp.where(near >= t_min, near, far)

    return _hits(i_best, t_of)


def traverse_spheres(scene, o, d, tm, t_min, t_max=BIG):
    """(t, idx) closest non-medium sphere via the scene's sphere BVH.

    Leaf test = the quadratic with correct near/far root fallback
    (reference `sphere.h:35-73`, corrected per SURVEY quirk 1), with
    per-ray-time lerped centers for moving spheres.
    """
    o_sg, d_sg = jax.lax.stop_gradient((o, d))

    def leaf_test(ids, t_best):
        near, far, disc = _sphere_roots(scene.spheres, ids, o_sg[:, None, :],
                                        d_sg[:, None, :], tm[:, None])
        ok_near = (disc > 0) & (near >= t_min) & (near <= t_best[:, None])
        ok_far = (disc > 0) & (far >= t_min) & (far <= t_best[:, None])
        return jnp.where(ok_near, near, jnp.where(ok_far, far, BIG))

    i_best = _traverse(scene.sphere_bvh, leaf_test, o_sg, d_sg, t_min, t_max)
    return sphere_hits(scene, i_best, o_sg, d_sg, tm, t_min)
