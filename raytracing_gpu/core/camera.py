"""Thin-lens camera with defocus and motion blur.

Counterpart of reference `camera.h:18-58`: the camera is a small
pytree of precomputed basis vectors, and `get_rays` produces a whole batch of
rays (origins/directions/times as `(N, 3)` / `(N,)` arrays) in one vectorized
expression rather than one ray per CUDA thread.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from . import struct
from jax import Array

from . import rng, vec


@struct.dataclass
class Camera:
    origin: Array             # (3,)
    lower_left_corner: Array  # (3,)
    horizontal: Array         # (3,)
    vertical: Array           # (3,)
    u: Array                  # (3,) right basis vector
    v: Array                  # (3,) up basis vector
    w: Array                  # (3,) back basis vector
    lens_radius: Array        # ()
    time0: Array              # () shutter open
    time1: Array              # () shutter close

    @staticmethod
    def make(
        lookfrom,
        lookat,
        vup=(0.0, 1.0, 0.0),
        vfov: float = 40.0,
        aspect_ratio: float = 16.0 / 9.0,
        aperture: float = 0.0,
        focus_dist: float = 10.0,
        time0: float = 0.0,
        time1: float = 1.0,
    ) -> "Camera":
        """Build the viewport basis exactly as reference `camera.h:18-47`."""
        lookfrom = jnp.asarray(lookfrom, jnp.float32)
        lookat = jnp.asarray(lookat, jnp.float32)
        vup = jnp.asarray(vup, jnp.float32)

        theta = math.radians(vfov)
        h = math.tan(theta / 2.0)
        viewport_height = 2.0 * h
        viewport_width = aspect_ratio * viewport_height

        w = vec.unit(lookfrom - lookat)
        u = vec.unit(vec.cross(vup, w))
        v = vec.cross(w, u)

        origin = lookfrom
        horizontal = focus_dist * viewport_width * u
        vertical = focus_dist * viewport_height * v
        lower_left_corner = origin - horizontal / 2.0 - vertical / 2.0 - focus_dist * w

        return Camera(
            origin=origin,
            lower_left_corner=lower_left_corner,
            horizontal=horizontal,
            vertical=vertical,
            u=u,
            v=v,
            w=w,
            lens_radius=jnp.float32(aperture / 2.0),
            time0=jnp.float32(time0),
            time1=jnp.float32(time1),
        )

    def get_rays(self, key: Array, s: Array, t: Array):
        """Batched `get_ray` (reference `camera.h:49-58`).

        s, t: (N,) viewport coordinates in [0, 1].
        Returns (origins (N,3), directions (N,3), times (N,)).
        The lens-disk offset gives defocus blur; the random time in
        [time0, time1] gives motion blur.
        """
        kd, kt = jax.random.split(key)
        shape = s.shape
        rd = self.lens_radius * rng.in_unit_disk(kd, shape)
        offset = self.u * rd[..., 0:1] + self.v * rd[..., 1:2]
        origin = self.origin + offset
        direction = (
            self.lower_left_corner
            + s[..., None] * self.horizontal
            + t[..., None] * self.vertical
            - origin
        )
        time = rng.uniform(kt, shape, self.time0, self.time1)
        return origin, direction, time
