"""The BVH traversal kernel (ops/bvh_kernel.py), run by the Pallas
interpreter, against its plain reference `accel/traverse.py`.

Same BVH, same rays: the closest primitive must be the same one, and its
distance the same bit for bit, since both searches hand the primitive they
found to one shared evaluation of its distance.  The searches themselves
compare candidate distances computed by two compilations of the leaf math,
which differ in the last bits on ill-conditioned hits (cross products and
b^2 - ac cancel), so a grazing ray may flip between two primitives at one
distance, or between a hit and a miss: at most 0.5% of the rays may do so.
The wrapper's padding of N to the block, the t_max clip and single-leaf
trees are covered too.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_gpu.accel import traverse
from raytracing_gpu.accel.traverse import BIG
from raytracing_gpu.ops import bvh_kernel
from raytracing_gpu.scene.builder import SceneBuilder

kernel_triangles = partial(bvh_kernel.closest_triangles, interpret=True)
kernel_spheres = partial(bvh_kernel.closest_spheres, interpret=True)


def _triangle_scene(n_tris, seed=0, spread=6.0):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mat = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(n_tris):
        v0 = rng.uniform(-spread, spread, 3)
        b.triangle(v0, v0 + rng.uniform(-2.5, 2.5, 3),
                   v0 + rng.uniform(-2.5, 2.5, 3), mat)
    return b.build(bvh="always")


def _sphere_scene(n_spheres, moving, seed=0, spread=6.0):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mat = b.lambertian((0.5, 0.5, 0.5))
    for i in range(n_spheres):
        c = rng.uniform(-spread, spread, 3)
        r = rng.uniform(0.2, 1.0)
        if moving and i % 2:
            b.moving_sphere(c, c + rng.uniform(-1, 1, 3), 0.0, 1.0, r, mat)
        else:
            b.sphere(c, r, mat)
    return b.build(bvh="always")


def _rays(n, seed=1, spread=12.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    target = rng.uniform(-0.6 * spread, 0.6 * spread, (n, 3))
    d = (target - o).astype(np.float32)
    tm = rng.random(n).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)


def _assert_same_hits(ref, got, min_hits=0.05, exact=True):
    """exact=False where the two sides evaluate the distance in different
    compilations (an eager reference against a jitted program), which may
    round it differently: t is then compared to 1e-4 relative."""
    (t_r, i_r), (t_k, i_k) = ref, got
    t_r, i_r, t_k, i_k = map(np.asarray, (t_r, i_r, t_k, i_k))
    assert t_k.shape == t_r.shape and i_k.shape == i_r.shape
    assert i_k.dtype == np.int32
    hit, hit_k = t_r < BIG * 0.5, t_k < BIG * 0.5
    assert hit.mean() >= min_hits, "rays should hit something"
    same = (i_k == i_r) & (hit == hit_k)
    assert (~same).sum() <= 0.005 * same.size, f"{(~same).sum()} rays differ"
    # two primitives at one distance (grazing ties) give the same t
    both = ~same & hit & hit_k
    np.testing.assert_allclose(t_k[both], t_r[both], rtol=1e-4)
    ok = same & hit
    if exact:
        np.testing.assert_array_equal(t_k[ok], t_r[ok])
    else:
        np.testing.assert_allclose(t_k[ok], t_r[ok], rtol=1e-4, atol=1e-6)
    # misses report BIG / index 0, as the reference does
    miss = ~hit_k
    assert np.all(t_k[miss] == np.float32(BIG)) and np.all(i_k[miss] == 0)


@pytest.fixture(scope="module")
def tri_scene():
    return _triangle_scene(1500)


@pytest.fixture(scope="module")
def sphere_scene():
    return _sphere_scene(300, moving=False)


@pytest.fixture(scope="module")
def moving_scene():
    return _sphere_scene(300, moving=True)


@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("n", [1000, 1024])
def test_triangles_match_reference(tri_scene, block, n):
    o, d, _ = _rays(n)
    ref = traverse.traverse_triangles(tri_scene, o, d, 0.001)
    got = kernel_triangles(tri_scene, o, d, 0.001, block=block)
    _assert_same_hits(ref, got)


@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("n", [1000, 1024])
def test_static_spheres_match_reference(sphere_scene, block, n):
    o, d, tm = _rays(n)
    ref = traverse.traverse_spheres(sphere_scene, o, d, tm, 0.001)
    got = kernel_spheres(sphere_scene, o, d, tm, 0.001, block=block)
    _assert_same_hits(ref, got)


@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("n", [1000, 1024])
def test_moving_spheres_match_reference(moving_scene, block, n):
    """Per-ray shutter times move the centres (the leaf lerps them)."""
    o, d, tm = _rays(n, seed=2)
    ref = traverse.traverse_spheres(moving_scene, o, d, tm, 0.001)
    got = kernel_spheres(moving_scene, o, d, tm, 0.001, block=block)
    _assert_same_hits(ref, got)


def test_moving_spheres_depend_on_time(moving_scene):
    o, d, tm = _rays(1000, seed=3)
    t0 = kernel_spheres(moving_scene, o, d, jnp.zeros_like(tm), 0.001)[0]
    t1 = kernel_spheres(moving_scene, o, d, jnp.ones_like(tm), 0.001)[0]
    assert np.any(np.asarray(t0) != np.asarray(t1))


@pytest.mark.parametrize("kind", ["triangles", "spheres"])
def test_t_max_clips(tri_scene, sphere_scene, kind):
    """Per-ray t_max: hits beyond it are misses, closer ones unchanged."""
    o, d, tm = _rays(1000, seed=4)
    t_max = jnp.asarray(np.random.default_rng(5).uniform(2.0, 15.0, 1000),
                        jnp.float32)
    if kind == "triangles":
        ref = traverse.traverse_triangles(tri_scene, o, d, 0.001, t_max)
        got = kernel_triangles(tri_scene, o, d, 0.001, t_max)
        full = kernel_triangles(tri_scene, o, d, 0.001)
    else:
        ref = traverse.traverse_spheres(sphere_scene, o, d, tm, 0.001, t_max)
        got = kernel_spheres(sphere_scene, o, d, tm, 0.001, t_max)
        full = kernel_spheres(sphere_scene, o, d, tm, 0.001)
    _assert_same_hits(ref, got)
    t_got, t_full = np.asarray(got[0]), np.asarray(full[0])
    inside = t_full <= np.asarray(t_max)
    np.testing.assert_array_equal(t_got[inside], t_full[inside])
    assert np.all(t_got[~inside] == np.float32(BIG))


@pytest.mark.parametrize("t_min", [0.001, 0.3])
def test_t_min_skips_near_hits(tri_scene, t_min):
    o, d, _ = _rays(1000, seed=6)
    ref = traverse.traverse_triangles(tri_scene, o, d, t_min)
    got = kernel_triangles(tri_scene, o, d, t_min)
    _assert_same_hits(ref, got)
    t = np.asarray(got[0])
    assert np.all(t[t < BIG * 0.5] >= t_min)


@pytest.mark.parametrize("kind", ["triangles", "spheres"])
def test_single_leaf_bvh(kind):
    """A tree that is one leaf: the root's hit and miss links are both -1."""
    if kind == "triangles":
        scene = _triangle_scene(3, seed=7, spread=1.0)
        fn, ref_fn = kernel_triangles, traverse.traverse_triangles
        o, d, _ = _rays(500, seed=8, spread=3.0)
        args = (scene, o, d, 0.001)
    else:
        scene = _sphere_scene(3, moving=True, seed=7, spread=1.0)
        fn, ref_fn = kernel_spheres, traverse.traverse_spheres
        o, d, tm = _rays(500, seed=8, spread=3.0)
        args = (scene, o, d, tm, 0.001)
    bvh = scene.tri_bvh if kind == "triangles" else scene.sphere_bvh
    assert bvh.node_min.shape[0] == 1
    _assert_same_hits(ref_fn(*args), fn(*args), min_hits=0.01)


@pytest.mark.parametrize("n", [1, 31, 64, 65, 333])
def test_pads_n_to_the_block(tri_scene, n):
    """N not a multiple of the block: padded lanes never leak out."""
    o, d, _ = _rays(n, seed=9)
    t, idx = kernel_triangles(tri_scene, o, d, 0.001, block=64)
    assert t.shape == (n,) and idx.shape == (n,)
    _assert_same_hits(traverse.traverse_triangles(tri_scene, o, d, 0.001),
                      (t, idx), min_hits=0.0)


def test_all_miss(sphere_scene):
    o, d, tm = _rays(200, seed=10)
    d = -jnp.abs(d) * 0 + jnp.asarray([0.0, 1.0, 0.0])
    o = o.at[:, 1].set(100.0)      # above everything, looking up
    t, idx = kernel_spheres(sphere_scene, o, d, tm, 0.001)
    assert np.all(np.asarray(t) == np.float32(BIG))
    assert np.all(np.asarray(idx) == 0)


def test_outputs_are_detached(tri_scene):
    """Geometry is not differentiated: t carries no tangent back to rays."""
    o, d, _ = _rays(128, seed=11)

    def f(o):
        return jnp.sum(jnp.where(kernel_triangles(tri_scene, o, d, 0.001)[0]
                                 < 1e29, kernel_triangles(tri_scene, o, d,
                                                          0.001)[0], 0.0))

    g = jax.grad(f)(o)
    assert np.all(np.asarray(g) == 0.0)


def test_under_jit_and_map(sphere_scene):
    """The kernel composes with jit and lax.map, as the renderers call it."""
    o, d, tm = _rays(512, seed=12)

    @jax.jit
    def waves(o, d, tm):
        return jax.lax.map(
            lambda x: kernel_spheres(sphere_scene, *x, 0.001),
            (o.reshape(4, 128, 3), d.reshape(4, 128, 3), tm.reshape(4, 128)))

    t, idx = waves(o, d, tm)
    _assert_same_hits(traverse.traverse_spheres(sphere_scene, o, d, tm, 0.001),
                      (t.reshape(-1), idx.reshape(-1)), exact=False)


@pytest.mark.parametrize("kind", ["triangles", "spheres"])
def test_same_primitive_same_distance_under_jit(tri_scene, moving_scene, kind):
    """Both searches jitted alike, as `chip_smoke.py` compares them: a ray
    that finds the same primitive gets the same t, bit for bit."""
    o, d, tm = _rays(1000, seed=14)
    if kind == "triangles":
        ref = jax.jit(lambda o, d: traverse.traverse_triangles(
            tri_scene, o, d, 0.001))(o, d)
        got = jax.jit(lambda o, d: kernel_triangles(
            tri_scene, o, d, 0.001))(o, d)
    else:
        ref = jax.jit(lambda o, d, tm: traverse.traverse_spheres(
            moving_scene, o, d, tm, 0.001))(o, d, tm)
        got = jax.jit(lambda o, d, tm: kernel_spheres(
            moving_scene, o, d, tm, 0.001))(o, d, tm)
    _assert_same_hits(ref, got)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["triangles", "spheres"])
def test_compiled_kernel_matches_reference(gpu_device, tri_scene, moving_scene,
                                           kind):
    """The kernel as compiled for the card (no interpreter)."""
    o, d, tm = _rays(4096, seed=13)
    if kind == "triangles":
        ref = traverse.traverse_triangles(tri_scene, o, d, 0.001)
        got = bvh_kernel.closest_triangles(tri_scene, o, d, 0.001)
    else:
        ref = traverse.traverse_spheres(moving_scene, o, d, tm, 0.001)
        got = bvh_kernel.closest_spheres(moving_scene, o, d, tm, 0.001)
    assert got[0].devices() == {gpu_device}
    _assert_same_hits(ref, got)
