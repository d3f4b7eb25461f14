"""Texture evaluation tests (reference `texture.h`, `perlin.h` semantics)."""

import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_gpu.scene import perlin, textures
from raytracing_gpu.scene.builder import SceneBuilder


def _eval(scene, tex_id, u=0.0, v=0.0, p=(0.0, 0.0, 0.0), n=1):
    return np.asarray(
        textures.eval_texture(
            scene,
            jnp.full((n,), tex_id, jnp.int32),
            jnp.full((n,), u, jnp.float32),
            jnp.full((n,), v, jnp.float32),
            jnp.tile(jnp.asarray([p], jnp.float32), (n, 1)),
        )
    )


class TestSolidChecker:
    def test_solid(self):
        b = SceneBuilder()
        t = b.solid((0.1, 0.2, 0.3))
        np.testing.assert_allclose(_eval(b.build(), t)[0], [0.1, 0.2, 0.3], rtol=1e-6)

    def test_checker_alternates(self):
        b = SceneBuilder()
        t = b.checker((1, 1, 1), (0, 0, 0), scale=10.0)
        scene = b.build()
        # sin(10*0.05)^3 > 0 -> even color; flip x sign -> odd color
        even = _eval(scene, t, p=(0.05, 0.05, 0.05))[0]
        odd = _eval(scene, t, p=(-0.05, 0.05, 0.05))[0]
        np.testing.assert_allclose(even, [1, 1, 1])
        np.testing.assert_allclose(odd, [0, 0, 0])


class TestPerlin:
    def test_noise_range_and_smoothness(self, np_rng):
        pts = jnp.asarray(np_rng.uniform(-10, 10, (5000, 3)), jnp.float32)
        vals = np.asarray(perlin.noise(pts))
        assert vals.min() >= -1.0 and vals.max() <= 1.0
        assert vals.std() > 0.05  # non-degenerate
        # smoothness: nearby points give nearby values
        eps_vals = np.asarray(perlin.noise(pts + 1e-4))
        assert np.abs(eps_vals - vals).max() < 1e-2

    def test_noise_deterministic(self):
        pts = jnp.asarray([[0.3, 1.7, -2.2]])
        assert float(perlin.noise(pts)[0]) == float(perlin.noise(pts)[0])

    def test_noise_zero_mean_isotropicish(self, np_rng):
        """Gradient noise must be ~zero-mean and vary along every axis
        (the hash-gradient redesign must not introduce axis bias)."""
        pts = jnp.asarray(np_rng.uniform(-20, 20, (20000, 3)), jnp.float32)
        vals = np.asarray(perlin.noise(pts))
        assert abs(vals.mean()) < 0.01
        for axis in range(3):
            line = np.zeros((64, 3), np.float32)
            line[:, axis] = np.linspace(0.1, 9.9, 64)
            lv = np.asarray(perlin.noise(jnp.asarray(line)))
            assert lv.std() > 0.02, f"flat along axis {axis}"

    def test_noise_vanishes_at_lattice(self):
        """Gradient noise is exactly 0 at integer lattice points (dot of any
        gradient with a zero offset) — same property as the reference's."""
        pts = jnp.asarray([[0, 0, 0], [3, -2, 7], [100, 41, -5]], jnp.float32)
        np.testing.assert_allclose(np.asarray(perlin.noise(pts)), 0.0, atol=1e-6)

    def test_turb_positive(self, np_rng):
        pts = jnp.asarray(np_rng.uniform(-10, 10, (1000, 3)), jnp.float32)
        vals = np.asarray(perlin.turb(pts))
        assert vals.min() >= 0.0

    def test_noise_texture_in_unit_range(self):
        b = SceneBuilder()
        t = b.noise(4.0)
        m = b.marble(4.0)
        scene = b.build()
        for tex in (t, m):
            vals = np.concatenate([
                _eval(scene, tex, p=tuple(p))
                for p in np.random.default_rng(0).uniform(-5, 5, (50, 3))
            ])
            assert vals.min() >= 0.0 and vals.max() <= 1.0


class TestImage:
    def _img_scene(self):
        b = SceneBuilder()
        img = np.zeros((2, 4, 3), np.float32)
        img[0, 0] = (1, 0, 0)   # top-left red
        img[0, 3] = (0, 1, 0)   # top-right green
        img[1, 0] = (0, 0, 1)   # bottom-left blue
        img[1, 3] = (1, 1, 0)   # bottom-right yellow
        t = b.image(img)
        return b.build(), t

    def test_corners(self):
        scene, t = self._img_scene()
        # v=1 is the image top (flip, texture.h:150)
        np.testing.assert_allclose(_eval(scene, t, u=0.0, v=0.99)[0], [1, 0, 0])
        np.testing.assert_allclose(_eval(scene, t, u=0.99, v=0.99)[0], [0, 1, 0])
        np.testing.assert_allclose(_eval(scene, t, u=0.0, v=0.0)[0], [0, 0, 1])
        np.testing.assert_allclose(_eval(scene, t, u=0.99, v=0.0)[0], [1, 1, 0])

    def test_uv_clamped(self):
        scene, t = self._img_scene()
        np.testing.assert_allclose(_eval(scene, t, u=-3.0, v=5.0)[0], [1, 0, 0])

    def test_two_images_atlas_offsets(self):
        b = SceneBuilder()
        red = np.full((2, 2, 3), (1.0, 0.0, 0.0), np.float32)
        green = np.full((3, 5, 3), (0.0, 1.0, 0.0), np.float32)
        t1 = b.image(red)
        t2 = b.image(green)
        scene = b.build()
        np.testing.assert_allclose(_eval(scene, t1, u=0.5, v=0.5)[0], [1, 0, 0])
        np.testing.assert_allclose(_eval(scene, t2, u=0.5, v=0.5)[0], [0, 1, 0])
