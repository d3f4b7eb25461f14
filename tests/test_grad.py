"""Differentiable rendering validation (the BASELINE north star):
pixel gradients w.r.t. material/texture/emitter parameters vs finite
differences, on a miniature Cornell box."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_gpu import RenderSettings
from raytracing_gpu.core.camera import Camera
from raytracing_gpu.engine import diff
from raytracing_gpu.engine.render import compile_param_renderer
from raytracing_gpu.scene.builder import BLACK, SceneBuilder


def _mini_cornell():
    """A 5-wall Cornell box with a bright light and one box, tiny resolution."""
    b = SceneBuilder(background=BLACK)
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light((15.0, 15.0, 15.0))
    b.rect("yz", 0, 555, 0, 555, 555, green)
    b.rect("yz", 0, 555, 0, 555, 0, red)
    b.rect("xz", 213, 343, 227, 332, 554, light)
    b.rect("xz", 0, 555, 0, 555, 0, white)
    b.rect("xz", 0, 555, 0, 555, 555, white)
    b.rect("xy", 0, 555, 0, 555, 555, white)
    b.box((0, 0, 0), (165, 330, 165), white, rotate_y=15, translate=(265, 0, 295))
    cam = Camera.make((278, 278, -800), (278, 278, 0), (0, 1, 0), 40, 1.0, 0.0, 10.0)
    return b.build(), cam


@pytest.fixture(scope="module")
def setup():
    scene, cam = _mini_cornell()
    st = RenderSettings(image_width=24, aspect_ratio=1.0, spp_per_chunk=8,
                        num_chunks=1, max_depth=4, ray_batch=24 * 24)
    chunk = compile_param_renderer(scene, cam, st)
    params = diff.get_params(scene)
    key = jax.random.PRNGKey(42)
    return scene, chunk, params, key


def test_every_param_has_gradient():
    """Every leaf in diff.get_params must receive a nonzero gradient on a
    scene that exercises it — guards against false capabilities like the
    round-1 `fuzz` parameter, whose pathwise gradient under the
    detached-sampling estimator is identically zero (see engine/diff.py)."""
    b = SceneBuilder(background=BLACK)
    # checker floor exercises tex_c1 AND tex_c2; image sphere exercises the
    # atlas; emissive rect exercises tex_c1 via diffuse_light
    checker = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.rect("xz", -10, 10, -10, 10, -1, b.lambertian(checker))
    img = np.full((4, 4, 3), 0.5, np.float32)
    b.sphere((0, 0.5, 0), 0.5, b.lambertian(b.image(img)))
    b.rect("xz", -2, 2, -2, 2, 4, b.diffuse_light((8.0, 8.0, 8.0)))
    scene = b.build()
    cam = Camera.make((0, 1, -5), (0, 0.5, 0), (0, 1, 0), 40, 1.0, 0.0, 10.0)
    st = RenderSettings(image_width=16, aspect_ratio=1.0, spp_per_chunk=8,
                        num_chunks=1, max_depth=4, ray_batch=16 * 16)
    chunk = compile_param_renderer(scene, cam, st)
    params = diff.get_params(scene)
    g = jax.jit(jax.grad(lambda p: chunk(p, jax.random.PRNGKey(7)).sum()))(params)
    for name, grad in g.items():
        assert np.any(np.asarray(grad) != 0.0), f"parameter {name} has zero gradient"


class TestGradients:
    def test_grads_match_finite_differences(self, setup):
        """Central-difference check: the Monte Carlo estimator uses FIXED keys,
        so f(params) is deterministic and the AD gradient of the sampled
        estimator must match its finite difference exactly (same paths)."""
        scene, chunk, params, key = setup

        def f(p):
            return float(chunk(p, key).sum())

        g = jax.jit(jax.grad(lambda p: chunk(p, key).sum()))(params)

        # probe a handful of parameter coordinates with central differences
        eps = 2e-3
        checks = [
            ("tex_c1", (1, 0)),   # white wall red channel (lambertian albedo)
            ("tex_c1", (0, 1)),   # green wall green channel
            ("tex_c1", (3, 2)),   # light blue channel (emitter radiance)
            ("tex_c1", (2, 0)),   # light red channel
        ]
        for name, idx in checks:
            p_plus = dict(params)
            p_plus[name] = params[name].at[idx].add(eps)
            p_minus = dict(params)
            p_minus[name] = params[name].at[idx].add(-eps)
            fd = (f(p_plus) - f(p_minus)) / (2 * eps)
            ad = float(g[name][idx])
            assert ad == pytest.approx(fd, rel=5e-2, abs=2e-2), (name, idx, ad, fd)

    def test_emitter_gradient_positive(self, setup):
        """Brightening the light must brighten the image: d(sum)/d(emit) > 0."""
        scene, chunk, params, key = setup
        g = jax.jit(jax.grad(lambda p: chunk(p, key).sum()))(params)
        emit_grad = np.asarray(g["tex_c1"][3])
        assert np.all(emit_grad > 0.0)

    def test_gradient_descent_recovers_albedo(self, setup):
        """End-to-end inverse rendering: perturb the white walls' albedo and
        recover it by gradient descent against the original render."""
        scene, chunk, params, key = setup
        target = chunk(params, key)

        wrong = dict(params)
        wrong["tex_c1"] = params["tex_c1"].at[1].set(jnp.array([0.3, 0.5, 0.9]))

        import optax

        opt = optax.adam(5e-2)
        state = opt.init(wrong)

        @jax.jit
        def step(p, s):
            loss, grads = jax.value_and_grad(
                lambda p: jnp.mean((chunk(p, key) - target) ** 2)
            )(p)
            updates, s = opt.update(grads, s)
            return optax.apply_updates(p, updates), s, loss

        p, s = wrong, state
        losses = []
        for _ in range(60):
            p, s, loss = step(p, s)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.05
        recovered = np.asarray(p["tex_c1"][1])
        np.testing.assert_allclose(recovered, [0.73, 0.73, 0.73], atol=0.08)
