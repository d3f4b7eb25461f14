"""Host-side BVH construction -> flat, stackless-traversable arrays.

The reference builds a complete-binary-tree BVH *on device by a single CUDA
thread* (merge sorts + index arithmetic, `bvh.h:163-345`) because its scene
objects live in GPU memory, and traverses it stacklessly with row/column
cursors (`bvh.h:348-436`).  Here the scene is host data, so
the build runs in numpy (median split on the largest-extent axis — a strict
improvement over the reference's random-axis median, `bvh.h:294`) and ships
four flat arrays; traversal is a threaded-link walk (accel/traverse.py):

- nodes in DFS preorder,
- `hit_link[i]`  = next node when node i's AABB is hit  (first child;
  for a leaf: same as miss_link, after its primitives are tested),
- `miss_link[i]` = next node when the AABB is missed (skip the subtree),
- `leaf_prims[i]` = up to K primitive ids (-1 padded; -1 for internal nodes).

A single int32 cursor per ray replaces a stack — the same stackless idea as
the reference's cursor scheme: every ray advances one node per step with
pure gathers + selects (ops/bvh_kernel.py keeps one cursor per GPU lane).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from ..core import struct
from jax import Array

BBOX_PAD = 1e-4  # degenerate-extent padding (reference triangle.h:80-93)


@struct.dataclass
class FlatBVH:
    node_min: Array    # (M, 3) float32
    node_max: Array    # (M, 3) float32
    hit_link: Array    # (M,) int32
    miss_link: Array   # (M,) int32
    leaf_prims: Array  # (M, K) int32, -1 = none


def build(bounds_min: np.ndarray, bounds_max: np.ndarray,
          leaf_size: int = 4, backend: str = "auto") -> FlatBVH:
    """Build a flat BVH over primitives given their AABBs.

    bounds_min/bounds_max: (P, 3).  backend "auto" prefers the native C++
    binned-SAH builder (raytracing_gpu.native) and falls back to this
    module's numpy median-split builder; "numpy"/"native" force one.
    Both emit the identical flat layout (preorder, threaded links).
    """
    p = len(bounds_min)
    assert p > 0

    if backend in ("auto", "native"):
        from .. import native as native_mod

        out = native_mod.build_bvh_native(bounds_min, bounds_max, leaf_size)
        if out is not None:
            nmin, nmax, hit_link, miss_link, leaf_prims = out
            return FlatBVH(
                node_min=np.asarray(nmin), node_max=np.asarray(nmax),
                hit_link=np.asarray(hit_link), miss_link=np.asarray(miss_link),
                leaf_prims=np.asarray(leaf_prims),
            )
        if backend == "native":
            raise RuntimeError("native BVH builder unavailable")
    centroids = 0.5 * (bounds_min + bounds_max)

    node_min: list = []
    node_max: list = []
    leaf: list = []     # list of id-arrays or None
    subtree_end: list = []

    import sys

    # balanced median splits: depth <= ~log2(P) + a few; recursion is fine,
    # but give headroom for skewed geometry
    sys.setrecursionlimit(max(10000, sys.getrecursionlimit()))

    def rec(ids: np.ndarray) -> int:
        i = len(node_min)
        node_min.append(bounds_min[ids].min(axis=0))
        node_max.append(bounds_max[ids].max(axis=0))
        leaf.append(None)
        subtree_end.append(-1)
        if len(ids) <= leaf_size:
            leaf[i] = ids
        else:
            c = centroids[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            order = np.argsort(c[:, axis], kind="stable")
            half = len(ids) // 2
            rec(ids[order[:half]])
            rec(ids[order[half:]])
        subtree_end[i] = len(node_min)
        return i

    rec(np.arange(p, dtype=np.int64))

    m = len(node_min)
    nmin = np.asarray(node_min, np.float32)
    nmax = np.asarray(node_max, np.float32)
    # pad degenerate extents so slab tests stay well-conditioned
    flat = (nmax - nmin) < 1e-6
    nmin = np.where(flat, nmin - BBOX_PAD, nmin)
    nmax = np.where(flat, nmax + BBOX_PAD, nmax)

    hit_link = np.zeros(m, np.int32)
    miss_link = np.zeros(m, np.int32)
    leaf_prims = np.full((m, leaf_size), -1, np.int32)
    for i in range(m):
        end = subtree_end[i]
        miss_link[i] = end if end < m else -1
        if leaf[i] is not None:
            hit_link[i] = miss_link[i]
            ids = leaf[i]
            leaf_prims[i, : len(ids)] = ids
        else:
            hit_link[i] = i + 1

    # numpy leaves: the scene builder uploads the whole pytree in one bulk
    # host->device conversion (SceneBuilder.build) and keeps this host copy
    # in its snapshot for zero-transfer baking/fingerprinting.
    return FlatBVH(
        node_min=nmin, node_max=nmax,
        hit_link=hit_link, miss_link=miss_link,
        leaf_prims=leaf_prims,
    )


def build_triangle_bvh(tri_cols: dict, leaf_size: int = 4) -> FlatBVH:
    """BVH over the builder's triangle columns (SceneBuilder._tri_columns —
    a dict of (P, 3) v0/e1/e2 arrays).

    Triangle AABBs with degenerate-axis padding (reference `triangle.h:80-93`).
    Primitive ids equal row order == packed table order.
    """
    v0 = np.asarray(tri_cols["v0"])
    v1 = v0 + np.asarray(tri_cols["e1"])
    v2 = v0 + np.asarray(tri_cols["e2"])
    bmin = np.minimum(np.minimum(v0, v1), v2)
    bmax = np.maximum(np.maximum(v0, v1), v2)
    flat = (bmax - bmin) < 1e-6
    bmin = np.where(flat, bmin - BBOX_PAD, bmin)
    bmax = np.where(flat, bmax + BBOX_PAD, bmax)
    return build(bmin.astype(np.float32), bmax.astype(np.float32), leaf_size)


def build_sphere_bvh(sphere_rows: Sequence[dict], leaf_size: int = 4):
    """BVH over non-medium sphere rows; moving spheres get the union of their
    t0/t1 boxes (reference `moving_sphere::bounding_box`).

    Returns (FlatBVH, id_map) where id_map maps BVH primitive ids to rows of
    the packed sphere table (media are excluded — they are sampled separately).
    """
    ids = np.array([i for i, s in enumerate(sphere_rows) if not s["medium"]],
                   np.int32)
    if len(ids) == 0:
        return None, None
    c0 = np.stack([sphere_rows[i]["c0"] for i in ids])
    c1 = np.stack([sphere_rows[i]["c1"] for i in ids])
    r = np.abs(np.array([sphere_rows[i]["r"] for i in ids]))[:, None]
    bmin = np.minimum(c0 - r, c1 - r)
    bmax = np.maximum(c0 + r, c1 + r)
    bvh = build(bmin.astype(np.float32), bmax.astype(np.float32), leaf_size)
    # remap leaf ids to packed-table rows
    lp = np.asarray(bvh.leaf_prims)
    remapped = np.where(lp >= 0, ids[np.clip(lp, 0, len(ids) - 1)], -1)
    return bvh.replace(leaf_prims=remapped.astype(np.int32)), ids
