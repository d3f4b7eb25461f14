"""Multi-host distributed setup.

The reference is single-process/single-GPU; its only "communication" is
host<->device copies and `cudaDeviceSynchronize` barriers (SURVEY §5).  Here:
`jax.distributed.initialize` for multi-host process groups, then the same
(sp, dp) mesh from `parallel.mesh` spanning all global devices — scene/BVH
replicated per host, ray/sample work sharded, the sample psum running over
every device of the mesh.

Failure semantics: a host failure surfaces as a collective/init error in JAX;
combined with the chunk checkpoint (utils/checkpoint.py) a restarted job
resumes from the last completed chunk — the elastic-recovery story SURVEY §5
calls for (the reference's is `exit(99)`, `common.h:30-38`).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import jax

logger = logging.getLogger("raytracing_gpu")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX.

    With no arguments, uses the cluster autodetection built into
    `jax.distributed.initialize`; explicit args name the coordinator
    (`localhost:<port>` on one machine), the process count and this
    process's id.  Safe to call when single-process (no-op if no
    coordinator and autodetection finds a single process).
    """
    if num_processes is not None and num_processes <= 1:
        logger.info("single process; skipping jax.distributed.initialize")
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    try:
        jax.distributed.initialize(**kwargs)
        logger.info("distributed: process %d/%d, %d local / %d global devices",
                    jax.process_index(), jax.process_count(),
                    jax.local_device_count(), jax.device_count())
    except Exception:  # no cluster detected; stay single-process
        if coordinator_address is not None:
            raise
        logger.info("no distributed environment detected; single process")


def is_coordinator() -> bool:
    """True on process 0 — the host that gathers the framebuffer and writes
    image/checkpoint output (all other hosts render their shards only)."""
    return jax.process_index() == 0


def local_chunk_slice(total: int) -> slice:
    """The [start, stop) range of a length-`total` work axis owned by this
    process when work is split evenly across hosts."""
    n = jax.process_count()
    i = jax.process_index()
    per = (total + n - 1) // n
    return slice(i * per, min((i + 1) * per, total))
