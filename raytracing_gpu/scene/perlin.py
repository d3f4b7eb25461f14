"""Perlin noise: hash-based gradient noise, gather-free by design.

Reference `perlin.h` builds 256-entry random-gradient + permutation tables
on-device with curand (`perlin.h:63-76`) and evaluates hashed trilinear
Hermite-smoothed gradient noise per point (`perlin.h:85-112`) plus an fBm
`turb` sum (`perlin.h:114-126`).  A direct transcription would gather from
those tables per lattice corner, eight gathers per octave per point.

This design replaces the tables with a counter-based hash: each
lattice corner (i, j, k) is mixed by a PCG permutation into 32 bits, and the
low 4 bits select one of Ken Perlin's 12 edge gradients — evaluated
branchlessly as sign/select arithmetic, no memory traffic at all.  This is the
same statistical object as the reference's table noise (isotropic gradient
noise, Hermite-interpolated, same fBm turbulence), with two advantages:

- pure arithmetic, so it evaluates the same way in any kernel, and
- zero gathers -> it fuses into the surrounding elementwise work.

The smoothing kernel is the reference's cubic Hermite 3t^2-2t^3
(`perlin.h:92-94`); `turb` matches `perlin::turb` exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

# 3D gradient noise with the 12-edge-gradient set attains |value| ~ 1.01 over
# 2M samples (sup slightly higher); dividing by 1.15 keeps noise inside the
# reference's (-1, 1) contract (`texture.h:55` relies on 0.5*(1+noise) being a
# valid color) with margin.
_NORM = 1.0 / 1.15


def _hash3(i: Array, j: Array, k: Array) -> Array:
    """Lattice-corner hash: int32 coords -> uint32 (PCG output permutation).

    Replaces the reference's perm_x[i]^perm_y[j]^perm_z[k] table composition
    (`perlin.h:103-105`) with pure integer arithmetic.
    """
    x = (i.astype(jnp.uint32) * jnp.uint32(0x8DA6B343)
         ^ j.astype(jnp.uint32) * jnp.uint32(0xD8163841)
         ^ k.astype(jnp.uint32) * jnp.uint32(0xCB1AB31F))
    x = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    x = ((x >> ((x >> jnp.uint32(28)) + jnp.uint32(4))) ^ x) * jnp.uint32(277803737)
    return (x >> jnp.uint32(22)) ^ x


def _grad_dot(h: Array, x: Array, y: Array, z: Array) -> Array:
    """dot(gradient(h), (x, y, z)) for Perlin's 12 edge gradients, branchless.

    h's low 4 bits pick the gradient ((+-1, +-1, 0) permutations); evaluated
    as two selected components with hashed signs — no table, no gather.
    """
    h = (h & jnp.uint32(15)).astype(jnp.int32)
    u = jnp.where(h < 8, x, y)
    v = jnp.where(h < 4, y, jnp.where((h == 12) | (h == 14), x, z))
    u = jnp.where((h & 1) == 0, u, -u)
    v = jnp.where((h & 2) == 0, v, -v)
    return u + v


def noise(p: Array) -> Array:
    """Gradient noise at points p (..., 3) -> (...,) in (-1, 1).

    Hash-gradient form of reference `perlin::noise` (`perlin.h:85-112`) +
    `perlin_interp` (`perlin.h:36-57`): trilinear Hermite interpolation of the
    8 corner-gradient dot products.
    """
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    fx, fy, fz = jnp.floor(px), jnp.floor(py), jnp.floor(pz)
    u = px - fx
    v = py - fy
    w = pz - fz
    i = fx.astype(jnp.int32)
    j = fy.astype(jnp.int32)
    k = fz.astype(jnp.int32)

    # Hermite cubic smoothing (perlin.h:92-94)
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)

    accum = jnp.zeros_like(u)
    for di in (0, 1):
        wi = uu if di else (1.0 - uu)
        for dj in (0, 1):
            wj = vv if dj else (1.0 - vv)
            for dk in (0, 1):
                wk = ww if dk else (1.0 - ww)
                h = _hash3(i + di, j + dj, k + dk)
                g = _grad_dot(h, u - di, v - dj, w - dk)
                accum = accum + wi * wj * wk * g
    return accum * _NORM


def turb(p: Array, depth: int = 7) -> Array:
    """fBm octave sum with |.| (reference `perlin::turb`, `perlin.h:114-126`).

    depth is static so the octave loop unrolls at trace time.
    """
    accum = jnp.zeros(p.shape[:-1], p.dtype)
    weight = 1.0
    q = p
    for _ in range(depth):
        accum = accum + weight * noise(q)
        weight *= 0.5
        q = q * 2.0
    return jnp.abs(accum)
