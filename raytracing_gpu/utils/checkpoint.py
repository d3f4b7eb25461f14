"""Checkpoint/resume for chunked renders.

The reference's implicit checkpointing is its per-frame-buffer PPM dump
(`render.h:152-162`) merged by `average_images` (`color.h:57-170`) — 8-bit and
manually resumed.  Here: float32 partial sums + completed-chunk count in one
npz, written atomically (tmp + rename), giving exact automatic resume.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np

_FILE = "render_state.npz"


def fingerprint(settings, seed: int, scene=None) -> str:
    """Identity hash of a render: settings + seed + scene content.

    A checkpoint is only resumable into the *same* render — a matching shape
    from a different seed/spp/depth/scene would silently corrupt the sample
    ensemble.  The scene digest covers every array leaf (shape + bytes), so
    moving a light or editing an albedo invalidates stale partial sums.
    """
    h = hashlib.sha256()
    # num_chunks is excluded: chunks are the checkpoint grain, and resuming a
    # partial render with a higher chunk count is the intended use (the
    # reference's average_images likewise counts whatever PPMs exist,
    # color.h:63-64).  Everything else changes per-chunk sample values.
    h.update(repr(settings.with_(num_chunks=0)).encode())
    h.update(str(int(seed)).encode())
    if scene is not None:
        import jax

        # the builder's numpy snapshot avoids a per-leaf D2H round trip;
        # same bytes either way since the device copy is an exact f32/i32
        # image of it
        host = getattr(scene, "_host_np", None)
        leaves = jax.tree_util.tree_leaves(
            host if host is not None else jax.device_get(scene))
        for leaf in leaves:
            arr = np.asarray(leaf)
            h.update(str(arr.shape).encode())
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def save(directory: str, sums: np.ndarray, chunks_done: int,
         fp: str = "") -> None:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, sums=sums, chunks_done=np.int64(chunks_done),
                 fingerprint=np.bytes_(fp.encode()))
    os.replace(tmp, path)


def load(directory: str, expected_shape=None,
         fp: str = "") -> Optional[Tuple[np.ndarray, int]]:
    path = os.path.join(directory, _FILE)
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        sums = data["sums"]
        chunks_done = int(data["chunks_done"])
        stored_fp = (bytes(data["fingerprint"]).decode()
                     if "fingerprint" in data.files else "")
    if expected_shape is not None and tuple(sums.shape) != tuple(expected_shape):
        return None  # stale checkpoint from different settings
    if fp and stored_fp and stored_fp != fp:
        return None  # checkpoint from a different render (seed/settings/scene)
    if fp and not stored_fp:
        return None  # legacy unfingerprinted checkpoint: refuse rather than risk
    return sums, chunks_done


def clear(directory: str) -> None:
    path = os.path.join(directory, _FILE)
    if os.path.exists(path):
        os.remove(path)
