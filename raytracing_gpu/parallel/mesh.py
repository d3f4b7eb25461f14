"""Device mesh construction for multi-chip / multi-host rendering.

The reference is single-GPU/single-process (SURVEY §2 parallelism table); the
distribution layer is built from scratch: a 2-D logical mesh with

- axis "sp"  — sample (spp) parallelism: devices render disjoint sample
  subsets of every pixel and `psum` their partial sums (the reference's
  frame-buffer ensemble `render.h:152-162` turned into a collective), and
- axis "dp"  — pixel/tile data parallelism: devices own disjoint pixel ranges
  (the reference's CUDA grid `render.h:96-99` spread across chips).

The scene/BVH pytree is replicated (MBs, not GBs); only ray/sample work is
sharded, so the only communications are the sp-axis psum and the final gather.
Every device reaches every other at the same rate on an NVLink-connected
host, so the mesh shape follows the algorithm only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

SP_AXIS = "sp"
DP_AXIS = "dp"


def make_mesh(n_sp: int = 1, n_dp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build an (sp, dp) mesh over the given (default: all) devices."""
    devices = list(jax.devices()) if devices is None else list(devices)
    if n_dp is None:
        if len(devices) % n_sp:
            raise ValueError(f"{len(devices)} devices not divisible by n_sp={n_sp}")
        n_dp = len(devices) // n_sp
    use = np.array(devices[: n_sp * n_dp]).reshape(n_sp, n_dp)
    return Mesh(use, (SP_AXIS, DP_AXIS))


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1)
