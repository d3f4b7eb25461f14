"""Profiling & observability.

The reference's story is `std::chrono` wall-clock in main (`main.cu:10-13,
39-45`) and makefile nvprof targets (`build/makefile:21-26`).  Here
(SURVEY §5): `jax.profiler` traces + per-phase timing + rays/s gauges.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

logger = logging.getLogger("raytracing_gpu")


@dataclass
class RaysPerSecond:
    """Simple rays/s gauge: wrap a timed region and read `.mrays`."""

    seconds: float = 0.0
    rays: int = 0

    @contextlib.contextmanager
    def measure(self, rays: int):
        t0 = time.perf_counter()
        yield
        self.seconds = time.perf_counter() - t0
        self.rays = rays

    @property
    def mrays(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds else 0.0


@dataclass
class PhaseTimer:
    """Structured per-phase timing (build / trace / shade / io), the gauge set
    SURVEY §5 prescribes in place of the reference's aggregate wall clock."""

    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.phases.values()) or 1.0
        lines = [
            f"{name:>12}: {dt:8.3f}s ({100 * dt / total:5.1f}%) x{self.counts[name]}"
            for name, dt in sorted(self.phases.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """jax.profiler trace context (XProf/Perfetto-compatible); no-op when
    log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax.profiler

    with jax.profiler.trace(log_dir):
        yield


def enable_nan_debugging() -> None:
    """Turn on jax_debug_nans — the replacement for the reference's
    abort-on-error `checkCudaErrors` (`common.h:30-38`) during debugging."""
    import jax

    jax.config.update("jax_debug_nans", True)


def time_call(fn, *args, reps: int = 5) -> dict:
    """Wall time of `fn(*args)` run to completion on the device.

    The first call (compilation, or a compile-cache load) is reported apart
    as `first_s`; then `reps` timed calls, each ending in
    `block_until_ready`, give the median and the spread.
    """
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return dict(first_s=first, median_s=times[len(times) // 2],
                min_s=times[0], max_s=times[-1], reps=reps)


def gpu_card() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (one line per card), or why they could not be read."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.strip()


def device_info() -> dict:
    """What every measurement names: the platform, device kind and count as
    JAX reports them, and the card's name and power limit."""
    import jax

    dev = jax.devices()[0]
    return dict(platform=dev.platform, device_kind=dev.device_kind,
                device_count=len(jax.devices()), card=gpu_card())
