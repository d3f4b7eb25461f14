"""Counter-based RNG helpers for the wavefront path tracer.

The reference keeps a `curandState` per pixel, seeded `curand_init(1984, pixel, 0)`
(reference `render.h:84-92`), re-indexed per frame buffer (`render.h:101`), and
draws rejection-sampled vectors (`vec3.h:129-145`).  This design
replaces all of that with threaded `jax.random` keys — `fold_in(key, bounce)`
etc. gives deterministic, order-independent streams with no mutable state —
and replaces every rejection sampler with an analytic, static-shape equivalent
(rejection loops would be data-dependent control flow under jit).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array


def fold(key: Array, *data: int | Array) -> Array:
    """Fold a sequence of ints into a key — one deterministic substream."""
    for d in data:
        key = jax.random.fold_in(key, d)
    return key


def uniform(key: Array, shape=(), lo: float = 0.0, hi: float = 1.0) -> Array:
    """U[lo, hi) floats (reference `random_float`, `vec3.h:7-13`)."""
    return jax.random.uniform(key, shape, jnp.float32, lo, hi)


def unit_vector(key: Array, shape=()) -> Array:
    """Uniform direction on the unit sphere (reference `random_unit_vector`,
    `vec3.h:143-145`) — analytic cylinder-projection sampling: z ~ U[-1,1],
    phi ~ U[0,2pi).  Two uniforms + sincos, far cheaper than
    normalized Gaussians (which need erfinv) and with no rejection loop."""
    u = jax.random.uniform(key, (*shape, 2), jnp.float32)
    z = 2.0 * u[..., 0] - 1.0
    phi = (2.0 * jnp.pi) * u[..., 1]
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack((r * jnp.cos(phi), r * jnp.sin(phi), z), axis=-1)


def in_unit_sphere(key: Array, shape=()) -> Array:
    """Uniform point in the unit ball (reference `random_in_unit_sphere`,
    `vec3.h:129-136`) — analytic: uniform direction times cbrt(U) radius."""
    kd, kr = jax.random.split(key)
    d = unit_vector(kd, shape)
    r = jnp.cbrt(jax.random.uniform(kr, (*shape, 1), jnp.float32))
    return d * r


def in_unit_disk(key: Array, shape=()) -> Array:
    """Uniform point in the unit disk, z = 0 (reference `random_in_unit_disk`,
    `vec3.h:138-141`) — analytic polar: r = sqrt(U), theta = 2*pi*U."""
    ka, kr = jax.random.split(key)
    theta = jax.random.uniform(ka, shape, jnp.float32, 0.0, 2.0 * jnp.pi)
    r = jnp.sqrt(jax.random.uniform(kr, shape, jnp.float32))
    return jnp.stack(
        (r * jnp.cos(theta), r * jnp.sin(theta), jnp.zeros_like(r)), axis=-1
    )
