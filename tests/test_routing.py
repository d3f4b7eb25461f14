"""Which BVH traversal each platform compiles in, and that the choice does
not change the image.

`backend.traversal()` is the only place that looks at the device: the
traversal kernel (ops/bvh_kernel.py) on an NVIDIA GPU, the XLA walk
(accel/traverse.py) elsewhere.  Every compiled chunk names its traversal,
so the routing matrix (scene x compile path x platform) is pinned here.
The kernel, forced through the Pallas interpreter, must render each BVH
scene as the XLA walk does (mesh scenes use their 100k-triangle stand-ins,
at reduced resolution).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_gpu import RenderSettings, backend
from raytracing_gpu.backend import Traversal
from raytracing_gpu.engine.render import (compile_param_renderer,
                                          compile_renderer)
from raytracing_gpu.models import scenes
from raytracing_gpu.ops import bvh_kernel

INTERPRET = Traversal("kernel", partial(bvh_kernel.closest_triangles,
                                        interpret=True),
                      partial(bvh_kernel.closest_spheres, interpret=True))

BVH_SCENES = ["big_scene1", "backpack", "cup", "door"]


def _settings(aspect, width=32, spp=2, depth=3):
    return RenderSettings(image_width=width, aspect_ratio=aspect,
                          spp_per_chunk=spp, num_chunks=1, max_depth=depth,
                          ray_batch=256)


@pytest.mark.parametrize("name", scenes.names())
def test_forward_routing_matrix(monkeypatch, name):
    """Every scene, every single-device compile path: the platform's
    traversal and nothing else (compiling only; nothing is traced)."""
    from raytracing_gpu.engine.fused_diff import compile_fused_param_renderer

    sd = scenes.get(name)
    st = _settings(sd.aspect)
    for platform, expected in (("cpu", "xla"), ("gpu", "kernel")):
        monkeypatch.setattr(backend, "platform", lambda: platform)
        for compile_fn in (compile_renderer, compile_param_renderer,
                           compile_fused_param_renderer):
            c = compile_fn(sd.scene, sd.camera, st)
            assert c.traversal == expected, (compile_fn.__name__, platform)


@pytest.mark.parametrize("platform,expected", [("gpu", "kernel"),
                                               ("cpu", "xla")])
def test_backend_choice_per_platform(monkeypatch, platform, expected):
    monkeypatch.setattr(backend, "platform", lambda: platform)
    tv = backend.traversal()
    assert tv.name == expected
    want = (backend.kernel_traversal() if expected == "kernel"
            else backend.xla_traversal())
    assert tv == want


def test_platform_follows_default_device():
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        assert backend.platform() == "cpu"
    assert backend.platform() == jax.default_backend()


def test_auto_on_cpu_routes_xla():
    sd = scenes.get("cornell_box")
    st = _settings(sd.aspect)
    assert jax.default_backend() == "cpu"
    assert compile_renderer(sd.scene, sd.camera, st).traversal == "xla"
    assert compile_param_renderer(sd.scene, sd.camera, st).traversal == "xla"
    forced = compile_renderer(sd.scene, sd.camera, st, traverse=INTERPRET)
    assert forced.traversal == "kernel"


def test_sharded_routing_wavefront(monkeypatch, eight_devices):
    """The sharded renderers take the platform's traversal as well."""
    from raytracing_gpu.engine.fused_diff import compile_fused_param_renderer
    from raytracing_gpu.parallel.mesh import make_mesh
    from raytracing_gpu.parallel.render import compile_sharded_renderer

    mesh = make_mesh(n_sp=2, n_dp=4, devices=eight_devices)
    sd = scenes.get("backpack")
    st = _settings(sd.aspect)
    for platform, expected in (("cpu", "xla"), ("gpu", "kernel")):
        monkeypatch.setattr(backend, "platform", lambda: platform)
        c = compile_sharded_renderer(sd.scene, sd.camera, st, mesh)
        assert c.traversal == expected
        c = compile_fused_param_renderer(sd.scene, sd.camera, st, mesh=mesh)
        assert c.traversal == expected


@pytest.mark.parametrize("name", BVH_SCENES)
def test_bvh_scene_renders_equal_with_kernel(name, assert_renders_match):
    sd = scenes.get(name)
    assert sd.scene.tri_bvh is not None or sd.scene.sphere_bvh is not None
    st = _settings(sd.aspect)
    key = jax.random.PRNGKey(3)
    xla = compile_renderer(sd.scene, sd.camera, st,
                           traverse=backend.xla_traversal())(key)
    ker = compile_renderer(sd.scene, sd.camera, st, traverse=INTERPRET)(key)
    n = st.num_pixels
    assert_renders_match(xla[:n], ker[:n])


@pytest.mark.parametrize("name", ["big_scene1", "backpack"])
def test_bvh_scene_gradients_equal_with_kernel(name):
    """The differentiable renderer walks through the kernel too; the walk is
    detached, so the gradients agree (up to the rare path that diverges on
    a last-bit hit distance)."""
    from raytracing_gpu.engine import diff

    sd = scenes.get(name)
    st = _settings(sd.aspect, width=16, spp=1)
    key = jax.random.PRNGKey(4)
    params = diff.get_params(sd.scene)
    n = st.num_pixels
    grads = []
    for tv in (backend.xla_traversal(), INTERPRET):
        f = compile_param_renderer(sd.scene, sd.camera, st, traverse=tv)
        grads.append(jax.grad(lambda p: jnp.mean(f(p, key)[:n]))(params))
    for k in grads[0]:
        a, b = np.asarray(grads[0][k]), np.asarray(grads[1][k])
        np.testing.assert_allclose(b, a, rtol=0.05,
                                   atol=0.02 * np.abs(a).max() + 1e-9,
                                   err_msg=k)
