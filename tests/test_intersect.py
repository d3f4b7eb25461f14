"""Intersection tests against closed-form expectations.

The reference has no tests (SURVEY §4); these are the unit-level oracle pairs
the SURVEY prescribes: each primitive's hit math vs hand-computed cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_gpu.engine.intersect import closest_hit
from raytracing_gpu.scene.builder import SceneBuilder

KEY = jax.random.PRNGKey(0)


def _hit_one(scene, o, d, tm=0.0):
    rec = closest_hit(
        scene,
        jnp.asarray([o], jnp.float32),
        jnp.asarray([d], jnp.float32),
        jnp.asarray([tm], jnp.float32),
        KEY,
    )
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[0], rec)


class TestSphere:
    def _scene(self):
        b = SceneBuilder()
        b.sphere((0, 0, -2), 1.0, b.lambertian((1, 0, 0)))
        return b.build()

    def test_head_on(self):
        rec = _hit_one(self._scene(), (0, 0, 0), (0, 0, -1))
        assert rec.hit
        assert rec.t == pytest.approx(1.0, rel=1e-5)
        np.testing.assert_allclose(rec.normal, [0, 0, 1], atol=1e-5)
        assert rec.front_face

    def test_miss(self):
        rec = _hit_one(self._scene(), (0, 5, 0), (0, 0, -1))
        assert not rec.hit

    def test_from_inside_uses_far_root(self):
        rec = _hit_one(self._scene(), (0, 0, -2), (0, 0, -1))
        assert rec.hit
        assert rec.t == pytest.approx(1.0, rel=1e-5)
        assert not rec.front_face  # leaving the sphere

    def test_sphere_uv(self):
        # point (1,0,0) on the unit sphere: phi = atan2(0,1)+pi = pi -> u=0.5;
        # theta = acos(0) -> v = 0.5 (sphere.h:19-32)
        rec = _hit_one(self._scene(), (2, 0, -2), (-1, 0, 0))
        assert rec.u == pytest.approx(0.5, abs=1e-5)
        assert rec.v == pytest.approx(0.5, abs=1e-5)

    def test_negative_radius_flips_normal(self):
        b = SceneBuilder()
        b.sphere((0, 0, -2), -1.0, b.dielectric(1.5))
        rec = _hit_one(b.build(), (0, 0, 0), (0, 0, -1))
        assert rec.hit
        # outward normal flipped inward by the negative radius, so the
        # boundary reads as a back face from outside (hollow-sphere trick)
        assert not rec.front_face

    def test_moving_sphere(self):
        b = SceneBuilder()
        b.moving_sphere((0, 0, -2), (2, 0, -2), 0.0, 1.0, 0.5, b.lambertian((1, 0, 0)))
        scene = b.build()
        rec0 = _hit_one(scene, (0, 0, 0), (0, 0, -1), tm=0.0)
        rec1 = _hit_one(scene, (0, 0, 0), (0, 0, -1), tm=1.0)
        rec1b = _hit_one(scene, (2, 0, 0), (0, 0, -1), tm=1.0)
        assert rec0.hit and not rec1.hit and rec1b.hit


class TestRect:
    def test_xy_rect(self):
        b = SceneBuilder()
        b.rect("xy", -1, 1, -2, 2, -3, b.lambertian((1, 1, 1)))
        rec = _hit_one(b.build(), (0.5, 1.0, 0), (0, 0, -1))
        assert rec.hit
        assert rec.t == pytest.approx(3.0, rel=1e-5)
        np.testing.assert_allclose(rec.normal, [0, 0, 1], atol=1e-5)
        # uv per aarect.h:81-82
        assert rec.u == pytest.approx(0.75, abs=1e-5)
        assert rec.v == pytest.approx(0.75, abs=1e-5)

    def test_xz_rect_and_yz_rect(self):
        b = SceneBuilder()
        b.rect("xz", 0, 2, 0, 2, 1.0, b.lambertian((1, 1, 1)))
        b.rect("yz", 0, 2, 0, 2, 5.0, b.lambertian((1, 1, 1)))
        scene = b.build()
        rec = _hit_one(scene, (1, 3, 1), (0, -1, 0))
        assert rec.hit and rec.t == pytest.approx(2.0, rel=1e-5)
        np.testing.assert_allclose(rec.normal, [0, 1, 0], atol=1e-5)
        rec = _hit_one(scene, (0, 1, 1), (1, 0, 0))
        assert rec.hit and rec.t == pytest.approx(5.0, rel=1e-5)
        np.testing.assert_allclose(rec.normal, [-1, 0, 0], atol=1e-5)

    def test_outside_bounds_misses(self):
        b = SceneBuilder()
        b.rect("xy", -1, 1, -1, 1, -3, b.lambertian((1, 1, 1)))
        assert not _hit_one(b.build(), (5, 0, 0), (0, 0, -1)).hit


class TestBox:
    def test_axis_aligned_box(self):
        b = SceneBuilder()
        b.box((-1, -1, -5), (1, 1, -3), b.lambertian((1, 1, 1)))
        rec = _hit_one(b.build(), (0, 0, 0), (0, 0, -1))
        assert rec.hit
        assert rec.t == pytest.approx(3.0, rel=1e-5)
        np.testing.assert_allclose(rec.normal, [0, 0, 1], atol=1e-5)

    def test_inside_box_hits_exit(self):
        b = SceneBuilder()
        b.box((-1, -1, -5), (1, 1, -3), b.lambertian((1, 1, 1)))
        rec = _hit_one(b.build(), (0, 0, -4), (0, 0, -1))
        assert rec.hit
        assert rec.t == pytest.approx(1.0, rel=1e-5)

    def test_rotated_box(self):
        # 45-deg rotated unit box at origin: x extent becomes sqrt(2)/1 wider
        b = SceneBuilder()
        b.box((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5), b.lambertian((1, 1, 1)),
              rotate_y=45.0)
        scene = b.build()
        r2 = float(np.sqrt(2.0) / 2.0)
        rec = _hit_one(scene, (5, 0, 0), (-1, 0, 0))
        assert rec.hit
        assert rec.t == pytest.approx(5 - r2, rel=1e-4)
        # beyond the rotated half-diagonal (sqrt(2)/2) there is no box
        rec_corner = _hit_one(scene, (5, 0, 0.75), (-1, 0, 0))
        assert not rec_corner.hit

    def test_translated_box(self):
        b = SceneBuilder()
        b.box((0, 0, 0), (1, 1, 1), b.lambertian((1, 1, 1)), translate=(10, 0, 0))
        rec = _hit_one(b.build(), (10.5, 0.5, 5), (0, 0, -1))
        assert rec.hit
        assert rec.t == pytest.approx(4.0, rel=1e-5)


class TestTriangle:
    def test_hit_and_barycentric_uv(self):
        b = SceneBuilder()
        b.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), b.lambertian((1, 1, 1)),
                   uv0=(0, 0), uv1=(1, 0), uv2=(0, 1))
        scene = b.build()
        rec = _hit_one(scene, (0.25, 0.25, 5), (0, 0, -1))
        assert rec.hit
        assert rec.t == pytest.approx(5.0, rel=1e-5)
        # at (0.25, 0.25) the barycentric uv equals the point coords
        assert rec.u == pytest.approx(0.25, abs=1e-5)
        assert rec.v == pytest.approx(0.25, abs=1e-5)

    def test_miss_outside(self):
        b = SceneBuilder()
        b.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), b.lambertian((1, 1, 1)))
        assert not _hit_one(b.build(), (0.9, 0.9, 5), (0, 0, -1)).hit

    def test_vertex_normal_interpolation(self):
        b = SceneBuilder()
        n = [(0, 0, 1), (1, 0, 0), (0, 0, 1)]
        b.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), b.lambertian((1, 1, 1)),
                   normals=n)
        rec = _hit_one(b.build(), (0.5, 0.0, 5), (0, 0, -1))
        assert rec.hit
        # midpoint of edge v0-v1: normal blends (0,0,1) and (1,0,0) equally
        expect = np.array([0.5, 0.0, 0.5])
        expect /= np.linalg.norm(expect)
        np.testing.assert_allclose(rec.normal, expect, atol=1e-4)


class TestClosest:
    def test_nearest_of_many_wins(self):
        b = SceneBuilder()
        b.sphere((0, 0, -10), 1, b.lambertian((1, 0, 0)))
        b.sphere((0, 0, -5), 1, b.lambertian((0, 1, 0)))
        b.rect("xy", -9, 9, -9, 9, -20, b.lambertian((0, 0, 1)))
        rec = _hit_one(b.build(), (0, 0, 0), (0, 0, -1))
        assert rec.hit
        assert rec.t == pytest.approx(4.0, rel=1e-5)
        assert rec.mat_id == 1

    def test_t_min_skips_self_hit(self):
        b = SceneBuilder()
        b.sphere((0, 0, -5), 1, b.lambertian((1, 0, 0)))
        # origin exactly on the surface, pointing away: no hit
        rec = _hit_one(b.build(), (0, 0, -4), (0, 0, 1))
        assert not rec.hit


class TestMedium:
    def test_medium_statistics(self):
        # free path through a density-d slab: P(scatter) = 1 - exp(-d * L)
        b = SceneBuilder()
        b.box_medium((-1, -1, -3), (1, 1, -1), 0.5, (1, 1, 1))
        scene = b.build()
        n = 4000
        o = jnp.tile(jnp.array([[0.0, 0.0, 0.0]]), (n, 1))
        d = jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (n, 1))
        rec = closest_hit(scene, o, d, jnp.zeros(n), jax.random.PRNGKey(5))
        frac = float(np.mean(np.asarray(rec.hit)))
        assert frac == pytest.approx(1.0 - np.exp(-0.5 * 2.0), abs=0.03)
        ts = np.asarray(rec.t)[np.asarray(rec.hit)]
        assert ts.min() >= 1.0 - 1e-4 and ts.max() <= 3.0 + 1e-4

    def test_solid_occludes_medium(self):
        b = SceneBuilder()
        b.box_medium((-1, -1, -10), (1, 1, -2), 1000.0, (1, 1, 1))
        b.sphere((0, 0, -1.5), 0.4, b.lambertian((1, 0, 0)))
        rec = _hit_one(b.build(), (0, 0, 0), (0, 0, -1))
        assert rec.hit
        assert rec.t == pytest.approx(1.1, rel=1e-4)  # sphere in front


class TestGeneralInstancing:
    """General rotate_y/translate wrappers on spheres and rects
    (reference `hittable.h:31-143` wraps arbitrary hittables; we bake the
    transform at build time — see SceneBuilder.sphere/rect)."""

    def test_translated_sphere(self):
        b = SceneBuilder()
        b.sphere((0, 0, -2), 1.0, b.lambertian((1, 0, 0)),
                 translate=(3, 1, 0))
        rec = _hit_one(b.build(), (3, 1, 0), (0, 0, -1))
        assert rec.hit
        assert rec.t == pytest.approx(1.0, rel=1e-5)

    def test_rotated_sphere_center(self):
        # center (2,0,0) rotated -90 deg about y -> (0,0,2)
        b = SceneBuilder()
        b.sphere((2, 0, 0), 1.0, b.lambertian((1, 0, 0)), rotate_y=-90.0)
        rec = _hit_one(b.build(), (0, 0, 0), (0, 0, 1))
        assert rec.hit
        assert rec.t == pytest.approx(1.0, rel=1e-5)

    def test_rotated_sphere_uv_phase(self):
        # reference rotate_y computes uv in OBJECT space (hittable.h:124-139):
        # hitting the world +x pole of a sphere rotated +90 deg about y must
        # report the uv the unrotated sphere has at its +z pole.
        def u_at_plus_x(rot):
            b = SceneBuilder()
            b.sphere((0, 0, 0), 1.0, b.lambertian((1, 0, 0)), rotate_y=rot)
            rec = _hit_one(b.build(), (2, 0, 0), (-1, 0, 0))
            assert rec.hit
            return float(rec.u)

        # unrotated +z pole: phi = atan2(-1, 0) + pi = pi/2 -> u = 0.25
        assert u_at_plus_x(90.0) == pytest.approx(0.25, abs=1e-5)
        assert u_at_plus_x(0.0) == pytest.approx(0.5, abs=1e-5)

    def test_translated_rect_stays_axis_aligned(self):
        b = SceneBuilder()
        b.rect("xy", 0, 1, 0, 1, -2.0, b.lambertian((1, 0, 0)),
               translate=(1, 2, -1))
        scene = b.build()
        assert int(np.asarray(scene.rects.active).sum()) == 1
        rec = _hit_one(scene, (1.5, 2.5, 0), (0, 0, -1))
        assert rec.hit
        assert rec.t == pytest.approx(3.0, rel=1e-5)
        assert rec.u == pytest.approx(0.5, abs=1e-5)
        assert rec.v == pytest.approx(0.5, abs=1e-5)

    def test_rotated_rect_matches_axis_aligned_image(self):
        # yz rect at x=k rotated +90 deg about y lands exactly on the plane
        # z = k' — compare t/normal against the directly-built xy rect
        b1 = SceneBuilder()
        b1.rect("yz", 0, 1, 0, 1, 0.5, b1.lambertian((1, 0, 0)),
                rotate_y=90.0)
        b2 = SceneBuilder()
        # rotate_y(90): (0.5, y, z) -> (z, y, -0.5); x spans (0,1), z = -0.5
        b2.rect("xy", 0, 1, 0, 1, -0.5, b2.lambertian((1, 0, 0)))
        for o, d in [((0.25, 0.75, 2.0), (0, 0, -1)),
                     ((0.9, 0.1, 2.0), (0, 0, -1)),
                     ((0.5, 0.5, -2.0), (0, 0, 1))]:
            r1 = _hit_one(b1.build(), o, d)
            r2 = _hit_one(b2.build(), o, d)
            assert bool(r1.hit) == bool(r2.hit)
            if r1.hit:
                assert r1.t == pytest.approx(float(r2.t), rel=1e-4)
                np.testing.assert_allclose(r1.normal, r2.normal, atol=1e-5)
                # uv is OBJECT-space (reference rotate_y keeps the wrapped
                # object's uv, hittable.h:124-139): the yz rect's u runs
                # along y and v along object-z; rotate_y(90) maps object-z
                # onto world-x, which is the xy rect's u.  So the rotated
                # rect must report u = r2.v (world y) and v = r2.u (world x)
                # at every sample point — a swapped uv corner in the
                # triangle lowering would break this.
                assert float(r1.u) == pytest.approx(float(r2.v), abs=1e-5)
                assert float(r1.v) == pytest.approx(float(r2.u), abs=1e-5)

    def test_rotated_rect_misses_outside(self):
        b = SceneBuilder()
        b.rect("yz", 0, 1, 0, 1, 0.5, b.lambertian((1, 0, 0)), rotate_y=90.0)
        rec = _hit_one(b.build(), (1.5, 0.5, 2.0), (0, 0, -1))
        assert not rec.hit
