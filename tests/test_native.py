"""Native C++ runtime components: binned-SAH BVH builder."""

import numpy as np
import pytest

from raytracing_gpu import native
from raytracing_gpu.accel import bvh as bvh_mod


@pytest.fixture(scope="module")
def lib_available():
    if native.get_lib() is None:
        pytest.skip("native library unavailable (no compiler)")
    return True


class TestNativeBVH:
    def test_structure_invariants(self, lib_available, np_rng):
        n = 3000
        bmin = np_rng.uniform(-10, 10, (n, 3)).astype(np.float32)
        bmax = bmin + np_rng.uniform(0.01, 1.0, (n, 3)).astype(np.float32)
        out = native.build_bvh_native(bmin, bmax, 4)
        assert out is not None
        nmin, nmax, hl, ml, lp = out
        ids = lp[lp >= 0]
        assert sorted(ids.tolist()) == list(range(n))
        assert (nmin[0] <= bmin.min(0) + 1e-5).all()
        assert (nmax[0] >= bmax.max(0) - 1e-5).all()
        m = len(nmin)
        assert ((hl >= -1) & (hl <= m)).all() and ((ml >= -1) & (ml < m)).all()
        # preorder threading: internal nodes continue at i+1 on hit
        internal = (lp[:, 0] < 0)
        assert (hl[internal] == np.arange(m)[internal] + 1).all()

    def test_every_leaf_within_node_bounds(self, lib_available, np_rng):
        n = 500
        bmin = np_rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        bmax = bmin + np_rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
        nmin, nmax, hl, ml, lp = native.build_bvh_native(bmin, bmax, 4)
        for node in range(len(nmin)):
            for pid in lp[node]:
                if pid < 0:
                    continue
                assert (bmin[pid] >= nmin[node] - 1e-4).all()
                assert (bmax[pid] <= nmax[node] + 1e-4).all()

    def test_oracle_against_dense_scan(self, lib_available, np_rng):
        """Native-SAH BVH (backend='native') vs brute force on a triangle soup."""
        import jax
        import jax.numpy as jnp

        from raytracing_gpu.engine.intersect import closest_hit
        from raytracing_gpu.scene.builder import SceneBuilder

        b = SceneBuilder()
        mat = b.lambertian((0.5, 0.5, 0.5))
        for _ in range(150):
            v0 = np_rng.uniform(-6, 6, 3)
            b.triangle(v0, v0 + np_rng.uniform(-2, 2, 3),
                       v0 + np_rng.uniform(-2, 2, 3), mat)
        dense = b.build(bvh="never")
        accel = b.build(bvh="always")  # auto backend -> native when available
        nrays = 256
        o = jnp.asarray(np_rng.uniform(-8, 8, (nrays, 3)), jnp.float32)
        tgt = np_rng.uniform(-4, 4, (nrays, 3))
        d = jnp.asarray(tgt - np.asarray(o), jnp.float32)
        tm = jnp.zeros(nrays)
        key = jax.random.PRNGKey(0)
        r1 = closest_hit(dense, o, d, tm, key)
        r2 = closest_hit(accel, o, d, tm, key)
        hit = np.asarray(r1.hit)
        np.testing.assert_array_equal(hit, np.asarray(r2.hit))
        assert hit.sum() > 20
        np.testing.assert_allclose(np.asarray(r1.t)[hit], np.asarray(r2.t)[hit],
                                   rtol=1e-4)
