"""Closest-hit intersection over packed primitive tables.

The reference finds the closest hit with a virtual-dispatch scan over a
`hittable**` array (`hittable_list.h:23-39`) or a single-threaded stackless BVH
walk (`bvh.h:348-436`), one ray per CUDA thread.  Here, for a whole ray
batch, every primitive of each type is intersected as one dense broadcasted
expression (rays x primitives), reduced with argmin, and
only then compute the full hit record (normal/uv/material) for the single
winning primitive per ray — deferred shading attributes, so the O(N*P) part is
pure fused arithmetic and the gathers happen once per ray.

For large triangle meshes and sphere sets the dense product is replaced by
BVH traversal (`accel.traverse`, or the GPU kernel `ops.bvh_kernel`, as
`backend.traversal` picks) that yields the same (t, index) candidates.

Constant media (`constant_medium.h:34-70`) are resolved after the solid pass:
each medium boundary's entry/exit interval is clipped against the closest solid
hit and an exponential free path is sampled — equivalent to the reference's
sequential scan semantics for non-overlapping media, but order-independent.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from .. import backend
from ..core import rng, vec
from ..scene.types import Scene

# np (not jnp): a module-level device constant would initialize the XLA
# backend at import time, breaking jax.distributed.initialize ordering
BIG = np.float32(1e30)
_EPS_DIV = 1e-12


class HitRecord(NamedTuple):
    """SoA hit record (reference `hit_record`, `hittable.h:8-23`)."""

    hit: Array         # (N,) bool
    t: Array           # (N,)
    p: Array           # (N, 3)
    normal: Array      # (N, 3) faced against the ray
    front_face: Array  # (N,) bool
    u: Array           # (N,)
    v: Array           # (N,)
    mat_id: Array      # (N,) int32


def _safe_div(num: Array, den: Array) -> Array:
    den = jnp.where(jnp.abs(den) < _EPS_DIV, jnp.where(den >= 0, _EPS_DIV, -_EPS_DIV), den)
    return num / den


# --------------------------------------------------------------------------
# Spheres
# --------------------------------------------------------------------------


def _sphere_centers(sp, tm: Array) -> Array:
    """Lerped centers at ray times (reference `moving_sphere.h:20-22`)."""
    denom = jnp.where(jnp.abs(sp.time1 - sp.time0) < 1e-12, 1.0, sp.time1 - sp.time0)
    frac = (tm[:, None] - sp.time0[None, :]) / denom[None, :]
    return sp.center0[None, :, :] + frac[..., None] * (sp.center1 - sp.center0)[None, :, :]


def _sphere_quadratic(sp, o: Array, d: Array, tm: Array):
    """Quadratic coefficients for ray-vs-every-sphere (reference `sphere.h:35-45`).

    Returns (root_near, root_far, has_roots) each (N, S).
    """
    center = _sphere_centers(sp, tm)          # (N, S, 3)
    oc = o[:, None, :] - center               # (N, S, 3)
    a = vec.length_squared(d)[:, None]        # (N, 1)
    half_b = jnp.sum(oc * d[:, None, :], -1)  # (N, S)
    c = vec.length_squared(oc) - (sp.radius * sp.radius)[None, :]
    disc = half_b * half_b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / jnp.maximum(a, _EPS_DIV)
    root_near = (-half_b - sq) * inv_a
    root_far = (-half_b + sq) * inv_a
    return root_near, root_far, disc > 0.0


def _sphere_ts(sp, o, d, tm, t_min, t_max) -> Array:
    """Closest valid t per (ray, sphere), BIG on miss.

    Uses the *correct* second-root fallback — the reference recomputes the near
    root by mistake (`sphere.h:51`, SURVEY quirk 1); we implement the intended
    RTOW semantics so hollow/glass interiors work.
    """
    near, far, has = _sphere_quadratic(sp, o, d, tm)
    ok_near = has & (near >= t_min) & (near <= t_max)
    ok_far = has & (far >= t_min) & (far <= t_max)
    t = jnp.where(ok_near, near, jnp.where(ok_far, far, BIG))
    return jnp.where((sp.active & ~sp.medium)[None, :], t, BIG)


def _sphere_record(sp, idx: Array, o, d, tm, t):
    """Hit attributes for the winning sphere (reference `sphere.h:57-73`)."""
    denom = jnp.where(jnp.abs(sp.time1[idx] - sp.time0[idx]) < 1e-12, 1.0,
                      sp.time1[idx] - sp.time0[idx])
    frac = (tm - sp.time0[idx]) / denom
    center = sp.center0[idx] + frac[..., None] * (sp.center1[idx] - sp.center0[idx])
    p = o + t[..., None] * d
    radius = sp.radius[idx]
    outward = (p - center) / jnp.where(jnp.abs(radius) < _EPS_DIV, 1.0, radius)[..., None]
    # get_sphere_uv (sphere.h:19-32); u_off bakes a rotate_y instance's
    # object-space uv phase (hittable.h:64-143)
    theta = jnp.arccos(jnp.clip(-outward[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(-outward[..., 2], outward[..., 0]) + jnp.pi
    u = (phi / (2.0 * jnp.pi) + sp.u_off[idx]) % 1.0
    v = theta / jnp.pi
    return outward, u, v, sp.mat_id[idx]


# --------------------------------------------------------------------------
# Axis-aligned rects
# --------------------------------------------------------------------------


def _rect_axes(axis: Array):
    """Varying-coordinate axes (a, b) for each rect's constant axis.

    yz (axis 0) -> (y, z); xz (1) -> (x, z); xy (2) -> (x, y) — matching the
    reference's uv order (`aarect.h:63-150`).
    """
    a_ax = jnp.where(axis == 0, 1, 0)
    b_ax = jnp.where(axis == 2, 1, 2)
    return a_ax, b_ax


def _rect_ts(rc, o, d, t_min, t_max) -> Array:
    """Planar hit + range test per (ray, rect) (reference `aarect.h:63-150`)."""
    ax = rc.axis
    a_ax, b_ax = _rect_axes(ax)
    o_k = jnp.take(o, ax, axis=1)      # (N, R) o[constant axis]
    d_k = jnp.take(d, ax, axis=1)
    t = _safe_div(rc.k[None, :] - o_k, d_k)
    pa = jnp.take(o, a_ax, axis=1) + t * jnp.take(d, a_ax, axis=1)
    pb = jnp.take(o, b_ax, axis=1) + t * jnp.take(d, b_ax, axis=1)
    ok = (
        (t >= t_min) & (t <= t_max)
        & (pa >= rc.a0[None]) & (pa <= rc.a1[None])
        & (pb >= rc.b0[None]) & (pb <= rc.b1[None])
        & rc.active[None]
    )
    return jnp.where(ok, t, BIG)


def _rect_record(rc, idx: Array, o, d, t):
    ax = rc.axis[idx]
    a_ax, b_ax = _rect_axes(ax)
    p = o + t[..., None] * d
    pa = jnp.take_along_axis(p, a_ax[..., None], axis=-1)[..., 0]
    pb = jnp.take_along_axis(p, b_ax[..., None], axis=-1)[..., 0]
    u = (pa - rc.a0[idx]) / jnp.maximum(rc.a1[idx] - rc.a0[idx], _EPS_DIV)
    v = (pb - rc.b0[idx]) / jnp.maximum(rc.b1[idx] - rc.b0[idx], _EPS_DIV)
    outward = jax.nn.one_hot(ax, 3, dtype=p.dtype)
    return outward, u, v, rc.mat_id[idx]


# --------------------------------------------------------------------------
# Boxes (slab test with instance transform)
# --------------------------------------------------------------------------


def _box_to_object(bx, o, d):
    """World -> object ray transform per (ray, box): translate then rotate_y,
    exactly `translate::hit` + `rotate_y::hit` (`hittable.h:38,100-123`)."""
    c = bx.cos_t[None, :]
    s = bx.sin_t[None, :]
    ox = o[:, None, 0] - bx.offset[None, :, 0]
    oy = o[:, None, 1] - bx.offset[None, :, 1]
    oz = o[:, None, 2] - bx.offset[None, :, 2]
    dx = jnp.broadcast_to(d[:, None, 0], ox.shape)
    dy = jnp.broadcast_to(d[:, None, 1], ox.shape)
    dz = jnp.broadcast_to(d[:, None, 2], ox.shape)
    o_obj = jnp.stack((c * ox - s * oz, oy, s * ox + c * oz), axis=-1)
    d_obj = jnp.stack((c * dx - s * dz, dy, s * dx + c * dz), axis=-1)
    return o_obj, d_obj


def _box_slabs(bx, o, d):
    """Slab intervals (t_near, t_far) per (ray, box) (reference `aabb.h:19-104`
    applied to a whole box rather than 6 rects)."""
    o_obj, d_obj = _box_to_object(bx, o, d)
    inv = 1.0 / jnp.where(jnp.abs(d_obj) < _EPS_DIV,
                          jnp.where(d_obj >= 0, _EPS_DIV, -_EPS_DIV), d_obj)
    t0 = (bx.bmin[None, :, :] - o_obj) * inv
    t1 = (bx.bmax[None, :, :] - o_obj) * inv
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return tn, tf


def _box_ts(bx, o, d, t_min, t_max) -> Array:
    tn, tf = _box_slabs(bx, o, d)
    hit_interval = tf > jnp.maximum(tn, 0.0)
    # Entering face if in front of t_min, else the exit face (ray starts inside).
    t = jnp.where(tn >= t_min, tn, tf)
    ok = hit_interval & (t >= t_min) & (t <= t_max) & (bx.active & ~bx.medium)[None]
    return jnp.where(ok, t, BIG)


def _box_record(bx, idx: Array, o, d, t):
    """Face/normal/uv for the winning box, computed in object space."""
    b = jax.tree_util.tree_map(lambda a: a[idx], bx)
    c, s = b.cos_t, b.sin_t
    ox = o[..., 0] - b.offset[..., 0]
    oy = o[..., 1] - b.offset[..., 1]
    oz = o[..., 2] - b.offset[..., 2]
    o_obj = jnp.stack((c * ox - s * oz, oy, s * ox + c * oz), axis=-1)
    d_obj = jnp.stack(
        (c * d[..., 0] - s * d[..., 2], d[..., 1], s * d[..., 0] + c * d[..., 2]),
        axis=-1,
    )
    inv = 1.0 / jnp.where(jnp.abs(d_obj) < _EPS_DIV,
                          jnp.where(d_obj >= 0, _EPS_DIV, -_EPS_DIV), d_obj)
    t_lo = (b.bmin - o_obj) * inv  # (N, 3)
    t_hi = (b.bmax - o_obj) * inv
    # Which of the 6 faces produced the hit t
    diffs = jnp.abs(jnp.concatenate((t_lo, t_hi), axis=-1) - t[..., None])  # (N, 6)
    face = jnp.argmin(diffs, axis=-1)
    axis = face % 3
    is_max = face >= 3
    sign = jnp.where(is_max, 1.0, -1.0)
    n_obj = jax.nn.one_hot(axis, 3, dtype=o.dtype) * sign[..., None]
    # object -> world rotation (hittable.h:118-123)
    nx = c * n_obj[..., 0] + s * n_obj[..., 2]
    nz = -s * n_obj[..., 0] + c * n_obj[..., 2]
    outward = jnp.stack((nx, n_obj[..., 1], nz), axis=-1)
    # uv on the hit face, like the reference's per-face rects (box.h:14-27)
    p_obj = o_obj + t[..., None] * d_obj
    a_ax = jnp.where(axis == 0, 1, 0)
    b_ax = jnp.where(axis == 2, 1, 2)
    take = lambda arr, i: jnp.take_along_axis(arr, i[..., None], axis=-1)[..., 0]
    ext = jnp.maximum(b.bmax - b.bmin, _EPS_DIV)
    u = (take(p_obj, a_ax) - take(b.bmin, a_ax)) / take(ext, a_ax)
    v = (take(p_obj, b_ax) - take(b.bmin, b_ax)) / take(ext, b_ax)
    return outward, u, v, b.mat_id


# --------------------------------------------------------------------------
# Triangles (Moller-Trumbore)
# --------------------------------------------------------------------------

_TRI_EPS = 1e-7


def _tri_ts(tr, o, d, t_min, t_max) -> Array:
    """Batched Moller-Trumbore (reference `triangle.h:120-160`)."""
    h = vec.cross(d[:, None, :], tr.e2[None, :, :])     # (N, T, 3)
    a = jnp.sum(tr.e1[None, :, :] * h, -1)              # (N, T)
    f = 1.0 / jnp.where(jnp.abs(a) < _TRI_EPS, _TRI_EPS, a)
    s = o[:, None, :] - tr.v0[None, :, :]
    u = f * jnp.sum(s * h, -1)
    q = vec.cross(s, tr.e1[None, :, :])
    v = f * jnp.sum(d[:, None, :] * q, -1)
    t = f * jnp.sum(tr.e2[None, :, :] * q, -1)
    ok = (
        (jnp.abs(a) > _TRI_EPS)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t >= jnp.maximum(t_min, _TRI_EPS)) & (t <= t_max)
        & tr.active[None]
    )
    return jnp.where(ok, t, BIG)


def tri_record(tr, idx: Array, o, d, t):
    """Barycentric attribute interpolation for the winning triangle
    (reference `triangle.h:101-116,160-174`).  Shared with the BVH path."""
    v0 = tr.v0[idx]
    e1 = tr.e1[idx]
    e2 = tr.e2[idx]
    p = o + t[..., None] * d
    v2p = p - v0
    d00 = vec.dot(e1, e1)
    d01 = vec.dot(e1, e2)
    d11 = vec.dot(e2, e2)
    d20 = vec.dot(v2p, e1)
    d21 = vec.dot(v2p, e2)
    inv = 1.0 / jnp.where(jnp.abs(d00 * d11 - d01 * d01) < _EPS_DIV, _EPS_DIV,
                          d00 * d11 - d01 * d01)
    b0 = (d11 * d20 - d01 * d21) * inv   # weight of vertex1
    b1 = (d00 * d21 - d01 * d20) * inv   # weight of vertex2
    b2 = 1.0 - b0 - b1                   # weight of vertex0
    w = (b2[..., None], b0[..., None], b1[..., None])
    uv = w[0] * tr.uv0[idx] + w[1] * tr.uv1[idx] + w[2] * tr.uv2[idx]
    face_n = vec.cross(e2, e1)  # reference normal order cross(v1, v0)
    vert_n = w[0] * tr.n0[idx] + w[1] * tr.n1[idx] + w[2] * tr.n2[idx]
    outward = vec.where(tr.has_vn[idx], vert_n, face_n)
    return outward, uv[..., 0], uv[..., 1], tr.mat_id[idx]


# --------------------------------------------------------------------------
# Constant media
# --------------------------------------------------------------------------


def _media_candidate(scene: Scene, key: Array, o, d, tm, t_min, t_solid):
    """Sample scattering events inside constant-medium boundaries
    (reference `constant_medium::hit`, `constant_medium.h:34-70`).

    Returns (t (N,), mat_id (N,), valid (N,)).  The boundary interval is
    clipped to [t_min, t_solid]; an exponential free path decides whether the
    ray scatters inside.  Evaluated for sphere and box boundary tables.
    """
    sp, bx = scene.spheres, scene.boxes
    k_sp, k_bx = jax.random.split(key)
    d_len = vec.length(d)[:, None]

    # `has_*_media` are static structure flags: media-free tables compile away
    ts_parts, mats_parts = [], []
    if scene.has_sphere_media:
        near, far, has = _sphere_quadratic(sp, o, d, tm)
        t_sp, _ = _medium_sample(
            near, far, has & (sp.medium & sp.active)[None],
            sp.neg_inv_density[None], d_len, k_sp, t_min, t_solid,
        )
        ts_parts.append(t_sp)
        mats_parts.append(sp.mat_id)
    if scene.has_box_media:
        tn, tf = _box_slabs(bx, o, d)
        t_bx, _ = _medium_sample(
            tn, tf, (tf > tn) & (bx.medium & bx.active)[None],
            bx.neg_inv_density[None], d_len, k_bx, t_min, t_solid,
        )
        ts_parts.append(t_bx)
        mats_parts.append(bx.mat_id)

    if not ts_parts:
        n = o.shape[0]
        return (jnp.full(n, BIG), jnp.zeros(n, jnp.int32), jnp.zeros(n, bool))

    ts = jnp.concatenate(ts_parts, axis=1)
    mats = jnp.concatenate(mats_parts)
    best = jnp.argmin(ts, axis=1)
    t = jnp.take_along_axis(ts, best[:, None], axis=1)[:, 0]
    return t, mats[best], t < BIG * 0.5


def _medium_sample(enter_raw, exit_raw, exists, neg_inv_density, d_len, key,
                   t_min, t_solid):
    enter = jnp.maximum(enter_raw, t_min)
    exit_ = jnp.minimum(exit_raw, t_solid[:, None])
    seg = (exit_ - enter) * d_len
    valid_seg = exists & (exit_ > enter)
    u = jnp.maximum(rng.uniform(key, enter.shape), 1e-12)
    hit_dist = neg_inv_density * jnp.log(u)
    t = enter + hit_dist / d_len
    ok = valid_seg & (hit_dist <= seg)
    return jnp.where(ok, t, BIG), ok


# --------------------------------------------------------------------------
# Closest hit
# --------------------------------------------------------------------------


def _candidate(ts: Array):
    """(N, P) t-matrix -> per-ray best (t, index)."""
    idx = jnp.argmin(ts, axis=1)
    t = jnp.take_along_axis(ts, idx[:, None], axis=1)[:, 0]
    return t, idx


def closest_hit(scene: Scene, o: Array, d: Array, tm: Array, key: Array,
                t_min: float = 0.001, t_max: float = float(BIG),
                traverse: backend.Traversal | None = None) -> HitRecord:
    """Find the closest hit for a batch of rays.

    o, d: (N, 3); tm: (N,) ray times; key drives medium sampling.
    Replaces the reference's per-thread `(*world)->hit(...)` virtual scan
    (`render.h:62`, `hittable_list.h:23-39`).  traverse searches the BVHs;
    None takes `backend.traversal()`.
    """
    if traverse is None:
        traverse = backend.traversal()
    if scene.sphere_bvh is not None:
        t_s, i_s = traverse.spheres(scene, o, d, tm, t_min, t_max)
    else:
        t_s, i_s = _candidate(_sphere_ts(scene.spheres, o, d, tm, t_min, t_max))
    t_r, i_r = _candidate(_rect_ts(scene.rects, o, d, t_min, t_max))
    t_b, i_b = _candidate(_box_ts(scene.boxes, o, d, t_min, t_max))
    if scene.tri_bvh is not None:
        t_t, i_t = traverse.triangles(scene, o, d, t_min, t_max)
    else:
        t_t, i_t = _candidate(_tri_ts(scene.triangles, o, d, t_min, t_max))

    all_t = jnp.stack((t_s, t_r, t_b, t_t), axis=1)  # (N, 4)
    type_best = jnp.argmin(all_t, axis=1)
    t_solid = jnp.take_along_axis(all_t, type_best[:, None], axis=1)[:, 0]

    t_med, med_mat, med_valid = _media_candidate(scene, key, o, d, tm, t_min, t_solid)
    is_medium = med_valid & (t_med < t_solid)
    t_final = jnp.where(is_medium, t_med, t_solid)
    # Geometry is non-differentiable by design (north star differentiates
    # material/texture/emitter params only): detach t so hit points and all
    # downstream ray chains carry no geometry tangents.
    t_final = jax.lax.stop_gradient(t_final)
    hit = t_final < BIG * 0.5

    # Deferred attributes: one gather + attribute evaluation per type for the
    # winning primitive only, then select by the winning type tag.
    # Selection indices are non-differentiable by construction.
    t_sg = jax.lax.stop_gradient(t_final)
    n_s, u_s, v_s, m_s = _sphere_record(scene.spheres, i_s, o, d, tm, t_sg)
    n_r, u_r, v_r, m_r = _rect_record(scene.rects, i_r, o, d, t_sg)
    n_b, u_b, v_b, m_b = _box_record(scene.boxes, i_b, o, d, t_sg)
    n_t, u_t, v_t, m_t = tri_record(scene.triangles, i_t, o, d, t_sg)

    def sel(w, xs, xr, xb, xt):
        out = jnp.where(w(1), xr, xs)
        out = jnp.where(w(2), xb, out)
        return jnp.where(w(3), xt, out)

    wv = lambda k: (type_best == k)[:, None]
    ws = lambda k: type_best == k
    outward = sel(wv, n_s, n_r, n_b, n_t)
    u = sel(ws, u_s, u_r, u_b, u_t)
    v = sel(ws, v_s, v_r, v_b, v_t)
    mat_id = sel(ws, m_s, m_r, m_b, m_t)

    # set_face_normal (hittable.h:15-22)
    front = vec.dot(d, outward) < 0.0
    normal = vec.where(front, outward, -outward)
    normal = vec.unit(normal)

    # medium overrides: arbitrary normal/front (constant_medium.h:63-64)
    med_n = jnp.zeros_like(normal).at[..., 0].set(1.0)
    normal = vec.where(is_medium, med_n, normal)
    front = jnp.where(is_medium, True, front)
    u = jnp.where(is_medium, 0.0, u)
    v = jnp.where(is_medium, 0.0, v)
    mat_id = jnp.where(is_medium, med_mat, mat_id)

    p = o + t_final[..., None] * d
    return HitRecord(hit=hit, t=t_final, p=p, normal=normal, front_face=front,
                     u=u, v=v, mat_id=mat_id)
