"""Material scatter behavior tests (reference `material.h` semantics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_gpu.core import vec
from raytracing_gpu.scene import materials
from raytracing_gpu.scene.builder import SceneBuilder

KEY = jax.random.PRNGKey(0)


def _scatter(scene, mat_id, n=2000, in_dir=(0, 0, -1), normal=(0, 0, 1),
             front=True):
    in_d = jnp.tile(jnp.asarray([in_dir], jnp.float32), (n, 1))
    nrm = jnp.tile(jnp.asarray([normal], jnp.float32), (n, 1))
    p = jnp.zeros((n, 3))
    return materials.scatter(
        scene, KEY, in_d, p, nrm,
        jnp.full((n,), front), jnp.zeros(n), jnp.zeros(n),
        jnp.full((n,), mat_id, jnp.int32),
    )


class TestLambertian:
    def test_cosine_lobe_and_albedo(self):
        b = SceneBuilder()
        m = b.lambertian((0.5, 0.25, 0.125))
        scene = b.build()
        sc = _scatter(scene, m)
        assert bool(sc.ok.all())
        np.testing.assert_allclose(sc.attenuation[0], [0.5, 0.25, 0.125], rtol=1e-6)
        np.testing.assert_allclose(sc.emitted, 0.0)
        d = np.asarray(vec.unit(sc.direction))
        # normal + unit vector: all directions in the +z hemisphere,
        # mean direction along the normal
        assert d[:, 2].min() > -1e-6
        assert np.mean(d[:, 2]) > 0.5


class TestMetal:
    def test_perfect_mirror(self):
        b = SceneBuilder()
        m = b.metal((0.9, 0.9, 0.9), fuzz=0.0)
        scene = b.build()
        sc = _scatter(scene, m, in_dir=(1, 0, -1), normal=(0, 0, 1))
        d = np.asarray(vec.unit(sc.direction))
        expect = np.array([1.0, 0.0, 1.0]) / np.sqrt(2)
        np.testing.assert_allclose(d, np.tile(expect, (len(d), 1)), atol=1e-5)
        assert bool(sc.ok.all())

    def test_fuzz_spreads_and_absorbs_grazing(self):
        b = SceneBuilder()
        m = b.metal((1, 1, 1), fuzz=1.0)
        scene = b.build()
        # grazing reflection: large fuzz pushes many samples below the surface
        sc = _scatter(scene, m, in_dir=(1, 0, -0.05), normal=(0, 0, 1))
        frac_ok = float(np.mean(np.asarray(sc.ok)))
        assert 0.05 < frac_ok < 0.95


class TestDielectric:
    def test_attenuation_is_white(self):
        b = SceneBuilder()
        m = b.dielectric(1.5)
        scene = b.build()
        sc = _scatter(scene, m, in_dir=(0, 0, -1))
        np.testing.assert_allclose(sc.attenuation, 1.0)
        assert bool(sc.ok.all())

    def test_normal_incidence_mostly_refracts(self):
        b = SceneBuilder()
        m = b.dielectric(1.5)
        scene = b.build()
        sc = _scatter(scene, m, in_dir=(0, 0, -1), normal=(0, 0, 1))
        d = np.asarray(vec.unit(sc.direction))
        # Schlick R0 = ((1-1.5)/(2.5))^2 = 0.04: ~96% refract straight through
        frac_refract = np.mean(d[:, 2] < 0)
        assert frac_refract == pytest.approx(0.96, abs=0.03)

    def test_total_internal_reflection(self):
        b = SceneBuilder()
        m = b.dielectric(1.5)
        scene = b.build()
        # inside glass (front_face False -> ratio = 1.5), 60 deg incidence:
        # sin > 1/1.5 -> TIR, all rays reflect
        s, c = np.sin(np.radians(60)), np.cos(np.radians(60))
        sc = _scatter(scene, m, in_dir=(s, 0, -c), normal=(0, 0, 1), front=False)
        d = np.asarray(vec.unit(sc.direction))
        assert np.all(d[:, 2] > 0)


class TestLightAndIsotropic:
    def test_diffuse_light_emits_and_terminates(self):
        b = SceneBuilder()
        m = b.diffuse_light((15.0, 15.0, 15.0))
        scene = b.build()
        sc = _scatter(scene, m)
        assert not bool(sc.ok.any())
        np.testing.assert_allclose(sc.emitted, 15.0)

    def test_isotropic_scatters_uniformly(self):
        b = SceneBuilder()
        m = b.isotropic((1.0, 1.0, 1.0))
        scene = b.build()
        sc = _scatter(scene, m)
        d = np.asarray(vec.unit(sc.direction))
        # roughly half the directions go into each hemisphere
        assert np.mean(d[:, 2] > 0) == pytest.approx(0.5, abs=0.05)
        assert bool(sc.ok.all())
