"""Unit tests for core math, RNG samplers, and the camera."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_gpu.core import rng, vec
from raytracing_gpu.core.camera import Camera


class TestVec:
    def test_dot_cross_unit(self):
        a = jnp.array([[1.0, 0.0, 0.0], [1.0, 2.0, 3.0]])
        b = jnp.array([[0.0, 1.0, 0.0], [4.0, 5.0, 6.0]])
        np.testing.assert_allclose(vec.dot(a, b), [0.0, 32.0], rtol=1e-6)
        np.testing.assert_allclose(vec.cross(a, b)[0], [0.0, 0.0, 1.0], atol=1e-6)
        u = vec.unit(b)
        np.testing.assert_allclose(vec.length(u), [1.0, 1.0], rtol=1e-6)

    def test_reflect(self):
        # 45-degree incidence onto the y=0 plane (vec3.h:147-150)
        v = jnp.array([[1.0, -1.0, 0.0]])
        n = jnp.array([[0.0, 1.0, 0.0]])
        np.testing.assert_allclose(vec.reflect(v, n)[0], [1.0, 1.0, 0.0], atol=1e-6)

    def test_refract_straight_through(self):
        # normal incidence with matched indices: direction unchanged
        v = jnp.array([[0.0, -1.0, 0.0]])
        n = jnp.array([[0.0, 1.0, 0.0]])
        out = vec.refract(v, n, jnp.array([1.0]))
        np.testing.assert_allclose(out[0], [0.0, -1.0, 0.0], atol=1e-6)

    def test_refract_snell(self):
        # 45 degrees from air into glass (eta ratio 1/1.5): sin(theta_t) = sin(45)/1.5
        s = float(np.sin(np.radians(45)))
        v = jnp.array([[s, -s, 0.0]])
        n = jnp.array([[0.0, 1.0, 0.0]])
        out = vec.refract(v, n, jnp.array([1.0 / 1.5]))
        sin_t = float(out[0, 0] / vec.length(out)[0])
        assert sin_t == pytest.approx(s / 1.5, rel=1e-5)

    def test_near_zero(self):
        a = jnp.array([[1e-9, 1e-9, 1e-9], [1e-3, 0.0, 0.0]])
        np.testing.assert_array_equal(vec.near_zero(a), [True, False])


class TestRng:
    def test_unit_vector_is_unit_and_uniform(self):
        v = rng.unit_vector(jax.random.PRNGKey(0), (20000,))
        np.testing.assert_allclose(vec.length(v), 1.0, atol=1e-5)
        # component means vanish for a uniform sphere distribution
        assert np.abs(np.mean(np.asarray(v), axis=0)).max() < 0.02

    def test_in_unit_sphere(self):
        v = rng.in_unit_sphere(jax.random.PRNGKey(1), (20000,))
        r = np.asarray(vec.length(v))
        assert r.max() <= 1.0 + 1e-6
        # mean radius of uniform ball = 3/4
        assert np.mean(r) == pytest.approx(0.75, abs=0.01)

    def test_in_unit_disk(self):
        v = rng.in_unit_disk(jax.random.PRNGKey(2), (20000,))
        assert np.all(np.asarray(v[:, 2]) == 0.0)
        r = np.asarray(vec.length(v))
        assert r.max() <= 1.0 + 1e-6
        # mean radius of uniform disk = 2/3
        assert np.mean(r) == pytest.approx(2.0 / 3.0, abs=0.01)

    def test_fold_determinism(self):
        k = jax.random.PRNGKey(7)
        a = rng.uniform(rng.fold(k, 1, 2), (4,))
        b = rng.uniform(rng.fold(k, 1, 2), (4,))
        c = rng.uniform(rng.fold(k, 2, 1), (4,))
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)


class TestCamera:
    def test_center_ray_hits_lookat(self):
        cam = Camera.make((0, 0, -3), (0, 0, 0), (0, 1, 0), 40, 16 / 9, 0.0, 10.0)
        o, d, tm = cam.get_rays(jax.random.PRNGKey(0), jnp.array([0.5]), jnp.array([0.5]))
        np.testing.assert_allclose(np.asarray(o[0]), [0, 0, -3], atol=1e-6)
        # center of viewport looks straight at the lookat point
        dir_u = np.asarray(vec.unit(d))[0]
        np.testing.assert_allclose(dir_u, [0, 0, 1], atol=1e-6)
        assert 0.0 <= float(tm[0]) <= 1.0

    def test_fov_geometry(self):
        # vfov 90, aspect 1: the v=1 edge ray should make 45 deg with the axis
        cam = Camera.make((0, 0, 0), (0, 0, -1), (0, 1, 0), 90, 1.0, 0.0, 1.0)
        _, d, _ = cam.get_rays(
            jax.random.PRNGKey(0), jnp.array([0.5]), jnp.array([1.0])
        )
        dn = np.asarray(vec.unit(d))[0]
        assert dn[1] == pytest.approx(np.sin(np.radians(45)), rel=1e-5)

    def test_defocus_spread(self):
        cam = Camera.make((0, 0, 0), (0, 0, -1), (0, 1, 0), 40, 1.0, 0.5, 5.0)
        o, _, _ = cam.get_rays(
            jax.random.PRNGKey(3), jnp.full((1000,), 0.5), jnp.full((1000,), 0.5)
        )
        radii = np.linalg.norm(np.asarray(o), axis=-1)
        assert radii.max() <= 0.25 + 1e-5  # lens_radius = aperture/2
        assert radii.max() > 0.1
