"""BVH tests: structural invariants + the brute-force oracle.

SURVEY §4: the reference's `hittable_list::hit` / `bvh_node::hit` pair is the
oracle — a linear scan and a BVH walk must agree.  Here the dense (N, P)
intersection IS the linear scan, so a scene built with bvh="never" vs
bvh="always" must produce identical closest hits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_gpu.accel import bvh as bvh_mod
from raytracing_gpu.engine.intersect import BIG, closest_hit
from raytracing_gpu.scene.builder import SceneBuilder

KEY = jax.random.PRNGKey(0)


def _random_tri_builder(n_tris, rng, spread=6.0):
    b = SceneBuilder()
    mats = [b.lambertian(rng.random(3)) for _ in range(5)]
    for i in range(n_tris):
        v0 = rng.uniform(-spread, spread, 3)
        v1 = v0 + rng.uniform(-2.5, 2.5, 3)
        v2 = v0 + rng.uniform(-2.5, 2.5, 3)
        b.triangle(v0, v1, v2, mats[i % 5])
    return b


def _random_rays(n, rng, spread=12.0):
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    # aim at random points inside the geometry cloud so most rays pass through
    target = rng.uniform(-spread * 0.6, spread * 0.6, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d), jnp.zeros(n, jnp.float32)


class TestBuild:
    def test_structure_invariants(self, np_rng):
        p = 100
        bmin = np_rng.uniform(-5, 5, (p, 3)).astype(np.float32)
        bmax = bmin + np_rng.uniform(0.1, 1.0, (p, 3)).astype(np.float32)
        bvh = bvh_mod.build(bmin, bmax, leaf_size=4)
        lp = np.asarray(bvh.leaf_prims)
        # every primitive appears exactly once across leaves
        ids = lp[lp >= 0]
        assert sorted(ids.tolist()) == list(range(p))
        # root bbox contains everything
        np.testing.assert_array_less(np.asarray(bvh.node_min)[0] - 1e-5, bmin.min(0))
        np.testing.assert_array_less(bmax.max(0), np.asarray(bvh.node_max)[0] + 1e-5)
        # links in range
        hl, ml = np.asarray(bvh.hit_link), np.asarray(bvh.miss_link)
        m = len(hl)
        assert np.all((hl >= -1) & (hl <= m)) and np.all((ml >= -1) & (ml < m))

    def test_single_primitive(self):
        bvh = bvh_mod.build(np.zeros((1, 3), np.float32),
                            np.ones((1, 3), np.float32))
        assert np.asarray(bvh.leaf_prims)[0, 0] == 0


class TestTriangleOracle:
    def test_bvh_matches_brute_force(self, np_rng):
        b = _random_tri_builder(200, np_rng)
        dense = b.build(bvh="never")
        accel = b.build(bvh="always")
        assert accel.tri_bvh is not None
        o, d, tm = _random_rays(512, np_rng, spread=8.0)
        r1 = closest_hit(dense, o, d, tm, KEY)
        r2 = closest_hit(accel, o, d, tm, KEY)
        np.testing.assert_array_equal(np.asarray(r1.hit), np.asarray(r2.hit))
        hit = np.asarray(r1.hit)
        assert hit.sum() > 50  # scene dense enough to be a real test
        np.testing.assert_allclose(np.asarray(r1.t)[hit], np.asarray(r2.t)[hit],
                                   rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(r1.mat_id)[hit],
                                      np.asarray(r2.mat_id)[hit])
        np.testing.assert_allclose(np.asarray(r1.normal)[hit],
                                   np.asarray(r2.normal)[hit], atol=1e-5)

    def test_mixed_scene_with_other_prims(self, np_rng):
        b = _random_tri_builder(150, np_rng)
        b.sphere((0, 0, 0), 2.0, b.lambertian((1, 0, 0)))
        b.rect("xz", -20, 20, -20, 20, -10, b.lambertian((0, 1, 0)))
        dense = b.build(bvh="never")
        accel = b.build(bvh="always")
        o, d, tm = _random_rays(512, np_rng, spread=8.0)
        r1 = closest_hit(dense, o, d, tm, KEY)
        r2 = closest_hit(accel, o, d, tm, KEY)
        hit = np.asarray(r1.hit)
        np.testing.assert_array_equal(hit, np.asarray(r2.hit))
        np.testing.assert_allclose(np.asarray(r1.t)[hit], np.asarray(r2.t)[hit],
                                   rtol=1e-5)


class TestSphereOracle:
    def test_sphere_bvh_matches_brute_force(self, np_rng):
        b = SceneBuilder()
        mat = b.lambertian((0.5, 0.5, 0.5))
        for _ in range(300):
            c = np_rng.uniform(-10, 10, 3)
            if np_rng.random() < 0.3:
                c2 = c + np_rng.uniform(-0.5, 0.5, 3)
                b.moving_sphere(c, c2, 0, 1, np_rng.uniform(0.2, 0.8), mat)
            else:
                b.sphere(c, np_rng.uniform(0.2, 0.8), mat)
        dense = b.build(bvh="never")
        accel = b.build(bvh="always")
        assert accel.sphere_bvh is not None
        o, d, _ = _random_rays(512, np_rng)
        tm = jnp.asarray(np_rng.random(512), jnp.float32)
        r1 = closest_hit(dense, o, d, tm, KEY)
        r2 = closest_hit(accel, o, d, tm, KEY)
        hit = np.asarray(r1.hit)
        np.testing.assert_array_equal(hit, np.asarray(r2.hit))
        assert hit.sum() > 100
        np.testing.assert_allclose(np.asarray(r1.t)[hit], np.asarray(r2.t)[hit],
                                   rtol=1e-4)


class TestMeshSceneRenders:
    def test_door_scene_bvh_render(self):
        from raytracing_gpu import RenderSettings, render_linear
        from raytracing_gpu.models import scenes

        sd = scenes.get("door")
        assert sd.scene.tri_bvh is not None
        st = RenderSettings(image_width=32, aspect_ratio=sd.aspect,
                            spp_per_chunk=1, num_chunks=1, max_depth=3,
                            ray_batch=1024)
        img = render_linear(sd.scene, sd.camera, st, seed=1)
        assert np.all(np.isfinite(img))
        assert img.mean() > 0.05  # not black: sky + ground visible


class Test100kTriScale:
    """BASELINE config-5 scale (~100k triangles) exercised in CI.

    The backpack stand-in is 100,352 triangles (models/scenes.py:_add_obj) —
    the same scale as the reference's stripped backpack.obj, so the BVH depth
    (~17 levels) and the traversal paths are tested for real, not just on the
    2,165-tri door mesh.
    """

    def test_100k_bvh_matches_dense(self, np_rng):
        from raytracing_gpu.models.scenes import _uv_sphere

        v, f, uvs, n = _uv_sphere(224, 224)
        assert len(f) == 100352
        b = SceneBuilder()
        b.mesh(v, f, b.lambertian((0.7, 0.3, 0.2)), uvs=uvs, normals=n)
        dense = b.build(bvh="never")
        accel = b.build(bvh="always")
        assert accel.tri_bvh is not None
        # rays from outside aimed through the unit sphere: most must hit, and
        # the BVH walk must agree with the exhaustive candidate scan exactly
        o = np_rng.uniform(-4, 4, (128, 3)).astype(np.float32)
        o /= np.linalg.norm(o, axis=1, keepdims=True) / 3.0
        target = np_rng.uniform(-0.7, 0.7, (128, 3)).astype(np.float32)
        d = target - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = jnp.asarray(o), jnp.asarray(d)
        tm = jnp.zeros(128, jnp.float32)
        r1 = closest_hit(dense, o, d, tm, KEY)
        r2 = closest_hit(accel, o, d, tm, KEY)
        hit = np.asarray(r1.hit)
        np.testing.assert_array_equal(hit, np.asarray(r2.hit))
        assert hit.sum() > 64
        np.testing.assert_allclose(np.asarray(r1.t)[hit], np.asarray(r2.t)[hit],
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(r1.normal)[hit],
                                   np.asarray(r2.normal)[hit], atol=1e-5)

    def test_backpack_scene_renders(self):
        from raytracing_gpu import RenderSettings, render_linear
        from raytracing_gpu.models import scenes

        sd = scenes.get("backpack")
        assert np.asarray(sd.scene.triangles.v0).shape[0] == 100352
        assert sd.scene.tri_bvh is not None
        st = RenderSettings(image_width=32, aspect_ratio=sd.aspect,
                            spp_per_chunk=1, num_chunks=1, max_depth=3,
                            ray_batch=1024)
        img = render_linear(sd.scene, sd.camera, st, seed=1)
        assert np.all(np.isfinite(img))
        assert img.mean() > 0.02
