"""Vector math on trailing-dimension-3 arrays.

Counterpart of the reference's `vec3` class (reference `vec3.h:16-158`):
instead of a scalar 3-vector type with operator overloads, every op here works on
`(..., 3)` jnp arrays so the whole ray batch is one vectorized expression.  Aliases `point3`/`color` from the reference are just arrays.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array


def dot(a: Array, b: Array) -> Array:
    """Batched dot product over the trailing axis (reference `vec3.h:118-122`)."""
    return jnp.sum(a * b, axis=-1)


def length_squared(a: Array) -> Array:
    return jnp.sum(a * a, axis=-1)


def length(a: Array) -> Array:
    return jnp.sqrt(length_squared(a))


def cross(a: Array, b: Array) -> Array:
    """Cross product over the trailing axis (reference `vec3.h:124-128`)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        (a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0), axis=-1
    )


def unit(a: Array, eps: float = 1e-20) -> Array:
    """Normalize over the trailing axis (reference `unit_vector`, `vec3.h:113`).

    The `eps` floor keeps the op total (no NaN for zero vectors) so it is safe
    inside masked wavefront lanes and differentiable everywhere.
    """
    return a * jnp.reciprocal(jnp.maximum(length(a), eps))[..., None]


def near_zero(a: Array, eps: float = 1e-8) -> Array:
    """True where all components are tiny (reference `vec3.h:84-88`)."""
    return jnp.all(jnp.abs(a) < eps, axis=-1)


def reflect(v: Array, n: Array) -> Array:
    """Mirror reflection about normal n (reference `vec3.h:147-150`)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: Array, n: Array, etai_over_etat: Array) -> Array:
    """Snell refraction (reference `vec3.h:152-158`).

    `uv` must be unit length; `etai_over_etat` broadcasts as `(...,)`.
    Total-internal-reflection lanes produce garbage here and must be masked by
    the caller (the dielectric scatter selects reflection for those lanes).
    """
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    # Clamp keeps sqrt total for TIR lanes (selected away by the caller).
    k = jnp.maximum(1.0 - length_squared(r_out_perp), 0.0)
    r_out_parallel = -jnp.sqrt(k)[..., None] * n
    return r_out_perp + r_out_parallel


def where(mask: Array, a: Array, b: Array) -> Array:
    """Select (..., 3) vectors by a (...,) mask."""
    return jnp.where(mask[..., None], a, b)
