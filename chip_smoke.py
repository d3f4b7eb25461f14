"""Smoke run of the path tracer on one NVIDIA GPU, in one process.

    python chip_smoke.py                 # phases 1-4 on one card
    python chip_smoke.py --four-cards    # phase 5 only, on four cards
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse   # tiny, on the CPU

Phases (each prints its findings; any failed check exits non-zero):

1. Forward render at the reference's shape: big_scene1, 1200 px wide, depth
   50 (`render.h:22-27`), two chunks of 4 spp through `render_linear`.
2. Inverse rendering: Cornell box 512^2, 8 spp, depth 8.  Three Adam steps
   on `diff.get_params` through the fused renderer (the loss must fall), and
   one gradient compared with the XLA-autodiff renderer.
3. The BVH traversal kernel, compiled for the card, against the XLA walk
   (`accel/traverse.py`) on one 65,536-ray wave of camera and first-bounce
   rays, for the 100k-triangle backpack stand-in and big_scene1.
4. The same render on the GPU and on the CPU (Cornell box, big_scene1;
   64x64, 16 spp, depth 8, same keys): image means within 3 standard errors.
5. (--four-cards) The sharded renderer and the sharded fused gradient on a
   (sp=2, dp=2) mesh of four cards, against the single-card results.

The last line of standard output is one JSON object naming the device; it
is printed only when every check passed on a GPU.  --rehearse runs every
phase at a tiny size on whatever JAX finds (XLA traversal on both sides of
phase 3 off the GPU) to check the script itself, and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_gpu import backend
from raytracing_gpu.core.config import RenderSettings
from raytracing_gpu.models import scenes
from raytracing_gpu.utils.profiling import device_info, time_call


class Shapes:
    """The phases' shapes; a rehearsal cuts every one of them down."""

    def __init__(self, rehearse: bool):
        self.rehearse = rehearse

    def width(self, w: int) -> int:
        return max(16, w // 16) if self.rehearse else w

    def depth(self, d: int) -> int:
        return min(d, 3) if self.rehearse else d

    def rays(self, n: int) -> int:
        return n // 64 if self.rehearse else n


def say(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    say(f"  ok: {what}")


def bvh_builder() -> str:
    from raytracing_gpu import native

    return ("native binned SAH" if native.get_lib() is not None
            else "numpy median split")


def memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: unavailable"
    mb = lambda b: f"{b / 2**20:.1f} MiB"
    return (f"memory_analysis: arguments {mb(m.argument_size_in_bytes)}, "
            f"outputs {mb(m.output_size_in_bytes)}, "
            f"temporaries {mb(m.temp_size_in_bytes)}, "
            f"generated code {mb(m.generated_code_size_in_bytes)}")


def phase_forward(sh: Shapes):
    """1. big_scene1 at the reference's default shape, spp cut to 2 x 4."""
    from raytracing_gpu.engine.render import compile_renderer, render_linear

    say("phase 1: forward render, big_scene1 1200 px, depth 50, 2 x 4 spp")
    t0 = time.perf_counter()
    sd = scenes.get("big_scene1")
    say(f"  scene build {time.perf_counter() - t0:.3f} s; BVH builder: "
        f"{bvh_builder()}")
    st = RenderSettings(image_width=sh.width(1200), aspect_ratio=16 / 9,
                        spp_per_chunk=4, num_chunks=2, max_depth=sh.depth(50))
    chunk = compile_renderer(sd.scene, sd.camera, st)
    key = jax.random.PRNGKey(st.seed)
    t0 = time.perf_counter()
    compiled = chunk.lower(key).compile()
    say(f"  traversal: {chunk.traversal}; compile {time.perf_counter() - t0:.3f}"
        f" s; {memory(compiled)}")
    times = []
    t0 = time.perf_counter()
    img = render_linear(sd.scene, sd.camera, st,
                        chunk_fn=lambda _s, _c, _st, k: compiled(k),
                        progress=lambda c, n, dt: times.append(dt))
    total = time.perf_counter() - t0
    rays = st.num_pixels * st.rays_per_pixel
    say(f"  {st.image_width}x{st.image_height}: chunk seconds "
        f"{', '.join(f'{t:.3f}' for t in times)}; total {total:.3f} s "
        f"({rays / total / 1e6:.3f} Mrays/s, first chunk included)")
    check(img.shape == (st.image_height, st.image_width, 3), "image shape")
    check(bool(np.all(np.isfinite(img))), "image finite")
    check(float(img.mean()) > 0.05, f"image not black (mean {img.mean():.4f})")


def phase_inverse(sh: Shapes):
    """2. Cornell 512^2 inverse rendering: fused renderer + optax Adam."""
    import optax

    from raytracing_gpu.engine import diff
    from raytracing_gpu.engine.fused_diff import compile_fused_param_renderer
    from raytracing_gpu.engine.render import compile_param_renderer

    say("phase 2: inverse rendering, Cornell box 512^2, 8 spp, depth 8")
    sd = scenes.get("cornell_box")
    st = RenderSettings(image_width=sh.width(512), aspect_ratio=1.0,
                        spp_per_chunk=8, num_chunks=1, max_depth=sh.depth(8))
    npix = st.num_pixels
    key = jax.random.PRNGKey(1984)
    fused = compile_fused_param_renderer(sd.scene, sd.camera, st)
    xla_ad = compile_param_renderer(sd.scene, sd.camera, st)
    say(f"  traversal: {fused.traversal}")
    params = diff.get_params(sd.scene)
    # the target: the same box with every albedo pulled halfway to grey
    goal = dict(params, tex_c1=0.5 * params["tex_c1"] + 0.25)
    target = fused(goal, key)[:npix]

    def loss_fn(render):
        return lambda p: jnp.mean((render(p, key)[:npix] - target) ** 2)

    grad_fused = jax.jit(jax.value_and_grad(loss_fn(fused)))
    grad_xla = jax.jit(jax.value_and_grad(loss_fn(xla_ad)))
    rays = npix * st.spp_per_chunk
    for name, f in (("fused VJP", grad_fused), ("XLA autodiff", grad_xla)):
        t = time_call(f, params)
        say(f"  fwd+bwd {name}: first call {t['first_s']:.3f} s; median "
            f"{t['median_s'] * 1e3:.3f} ms (min {t['min_s'] * 1e3:.3f}, max "
            f"{t['max_s'] * 1e3:.3f}, {t['reps']} runs); "
            f"{rays / t['median_s'] / 1e6:.3f} Mrays/s")

    (l_f, g_f), (l_x, g_x) = grad_fused(params), grad_xla(params)
    check(abs(float(l_f) - float(l_x)) <= 1e-5 * abs(float(l_x)),
          f"fused loss {float(l_f):.6g} == XLA-autodiff loss {float(l_x):.6g}")
    for k in g_x:
        a, b = np.asarray(g_x[k]), np.asarray(g_f[k])
        scale = float(np.abs(a).max())
        err = float(np.max(np.abs(a - b) - 2e-4 * np.abs(a)))
        # rtol 2e-4 as in tests/test_fused_diff.py; the absolute floor is a
        # float32 rounding of the largest entry (sums over ~2M paths run in
        # another order in the two backward passes)
        check(err <= 1e-6 * scale + 1e-7,
              f"gradient {k}: fused vs XLA-autodiff within rtol 2e-4 "
              f"(max excess {err:.3g}, scale {scale:.3g})")

    opt = optax.adam(0.05)
    state = opt.init(params)
    losses = []
    p = params
    for _ in range(3):
        loss, g = grad_fused(p)
        losses.append(float(loss))
        updates, state = opt.update(g, state, p)
        p = optax.apply_updates(p, updates)
    losses.append(float(grad_fused(p)[0]))
    say(f"  Adam losses: {', '.join(f'{v:.6g}' for v in losses)}")
    check(all(np.isfinite(losses)), "losses finite")
    check(losses[-1] < losses[0], "loss falls over three Adam steps")


def _wave(sd, n, key):
    """n camera rays and the first-bounce rays of another n, for one wave."""
    from raytracing_gpu.backend import xla_traversal
    from raytracing_gpu.engine.intersect import closest_hit
    from raytracing_gpu.scene import materials

    k_uv, k_cam, k_hit, k_sc = jax.random.split(key, 4)
    uv = jax.random.uniform(k_uv, (2 * n, 2))
    o, d, tm = sd.camera.get_rays(k_cam, uv[:, 0], uv[:, 1])
    rec = closest_hit(sd.scene, o[n:], d[n:], tm[n:], k_hit,
                      traverse=xla_traversal())
    d2, _ = materials.scatter_direction(sd.scene, k_sc, d[n:], rec.normal,
                                        rec.front_face, rec.mat_id)
    hit = rec.hit[:, None]
    o2 = jnp.where(hit, rec.p, o[n:])
    d2 = jnp.where(hit, d2, d[n:])
    return (jnp.concatenate([o[:n], o2]), jnp.concatenate([d[:n], d2]), tm)


def phase_traversal(sh: Shapes):
    """3. The traversal kernel against the XLA walk on one wave."""
    from raytracing_gpu.engine.intersect import closest_hit

    n = sh.rays(32768)
    say(f"phase 3: BVH traversal kernel vs XLA walk, {2 * n}-ray wave")
    ref = backend.xla_traversal()
    ker = (backend.kernel_traversal() if backend.platform() == "gpu"
           else ref)
    say(f"  compared: {ref.name} walk vs {ker.name}")
    for name, kind in (("backpack", "triangles"), ("big_scene1", "spheres")):
        t0 = time.perf_counter()
        sd = scenes.get(name)
        sc = sd.scene
        bvh = sc.tri_bvh if kind == "triangles" else sc.sphere_bvh
        say(f"  {name}: {kind} BVH, {bvh.node_min.shape[0]} nodes, built in "
            f"{time.perf_counter() - t0:.3f} s by {bvh_builder()}")
        o, d, tm = jax.jit(lambda k: _wave(sd, n, k))(jax.random.PRNGKey(7))
        if kind == "triangles":
            ref_fn = jax.jit(lambda o, d, tm: ref.triangles(sc, o, d, 0.001))
            ker_fn = jax.jit(lambda o, d, tm: ker.triangles(sc, o, d, 0.001))
        else:
            ref_fn = jax.jit(lambda o, d, tm: ref.spheres(sc, o, d, tm, 0.001))
            ker_fn = jax.jit(lambda o, d, tm: ker.spheres(sc, o, d, tm, 0.001))
        t_r, i_r = map(np.asarray, ref_fn(o, d, tm))
        t_k, i_k = map(np.asarray, ker_fn(o, d, tm))
        hit = t_r < 1e29
        same = (i_r == i_k) & (hit == (t_k < 1e29))
        both = same & hit
        rel = np.abs(t_k - t_r) / np.maximum(1.0, np.abs(t_r))
        worst = float(rel[both].max(initial=0))
        say(f"  hits {hit.mean():.4f}; idx equal {same.mean():.6f}; where "
            f"equal max |dt|/max(1,t) {worst:.3g}")
        check(same.mean() >= 0.999, f"{name}: idx equal on >= 99.9% of rays "
              f"({same.mean():.6f})")
        check(worst <= 1e-5, f"{name}: |dt| <= 1e-5 max(1, t) where idx "
              f"equal (max {worst:.3g}, {int((rel[both] > 1e-5).sum())} rays "
              f"over)")
        diff_ = ~same
        tie = np.abs(t_k[diff_] - t_r[diff_]) <= 1e-4 * np.abs(t_r[diff_])
        check(bool(np.all(tie)), f"{name}: differing idx are ties "
              f"({int(diff_.sum())} rays, {int((~tie).sum())} with t apart by "
              f"more than 1e-4 relative)")
        for label, fn in (("XLA walk", ref_fn), ("kernel", ker_fn)):
            t = time_call(fn, o, d, tm, reps=10)
            say(f"  traversal alone, {label}: first call {t['first_s']:.3f} "
                f"s; median {t['median_s'] * 1e3:.3f} ms (min "
                f"{t['min_s'] * 1e3:.3f}, max {t['max_s'] * 1e3:.3f})")
        key = jax.random.PRNGKey(3)
        for label, tv in (("XLA walk", ref), ("kernel", ker)):
            ch = jax.jit(lambda o, d, tm, tv=tv: closest_hit(
                sc, o, d, tm, key, traverse=tv).t)
            t = time_call(ch, o, d, tm, reps=10)
            say(f"  closest_hit, {label}: median {t['median_s'] * 1e3:.3f} ms"
                f" (min {t['min_s'] * 1e3:.3f}, max {t['max_s'] * 1e3:.3f})")


def _samples(chunk, n_chunks, key):
    from raytracing_gpu.core import rng

    return np.stack([np.asarray(chunk(rng.fold(key, 0x5EED + c)))
                     for c in range(n_chunks)])


def phase_gpu_vs_cpu(sh: Shapes):
    """4. One render on the GPU and on the CPU: means within 3 s.e."""
    from raytracing_gpu.engine.render import compile_renderer

    say("phase 4: same render on GPU and CPU, 64x64, 16 spp, depth 8")
    cpu = jax.devices("cpu")[0]
    for name in ("cornell_box", "big_scene1"):
        sd = scenes.get(name)
        st = RenderSettings(image_width=sh.width(64) if sh.rehearse else 64,
                            aspect_ratio=1.0, spp_per_chunk=1, num_chunks=16,
                            max_depth=sh.depth(8))
        npix = st.num_pixels
        key = jax.random.PRNGKey(5)
        out = {}
        for label in ("gpu", "cpu"):
            if label == "gpu":
                chunk = compile_renderer(sd.scene, sd.camera, st)
                s = _samples(chunk, st.num_chunks, key)
            else:
                scene_c, cam_c = jax.device_put((sd.scene, sd.camera), cpu)
                with jax.default_device(cpu):
                    chunk = compile_renderer(scene_c, cam_c, st)
                    probe = chunk(jax.random.PRNGKey(0))
                    check(probe.devices() == {cpu}, f"{name}: CPU render "
                          f"ran on {probe.devices()}")
                    s = _samples(chunk, st.num_chunks,
                                 jax.device_put(key, cpu))
            s = s[:, :npix]                           # (spp, npix, 3)
            mean = s.mean(axis=(0, 1))
            se = np.sqrt(s.var(axis=0, ddof=1).sum(axis=0) / st.num_chunks)
            out[label] = (mean, se / npix, chunk.traversal)
        (m_g, se_g, tv_g), (m_c, se_c, tv_c) = out["gpu"], out["cpu"]
        bound = 3 * np.sqrt(se_g ** 2 + se_c ** 2)
        say(f"  {name}: traversal gpu={tv_g} cpu={tv_c}; means gpu "
            f"{np.round(m_g, 5)} cpu {np.round(m_c, 5)}; 3 s.e. "
            f"{np.round(bound, 5)}")
        check(bool(np.all(np.abs(m_g - m_c) <= bound)),
              f"{name}: channel means agree within 3 standard errors")


def phase_four_cards(sh: Shapes):
    """5. The sharded paths on a (sp=2, dp=2) mesh of four cards."""
    from raytracing_gpu.engine import diff
    from raytracing_gpu.engine.fused_diff import compile_fused_param_renderer
    from raytracing_gpu.engine.render import render_chunk
    from raytracing_gpu.parallel.mesh import make_mesh
    from raytracing_gpu.parallel.render import compile_sharded_renderer

    say("phase 5: sharded renderer and fused gradient, (sp=2, dp=2), 4 cards")
    devices = jax.devices()[:4]
    check(len(devices) == 4, f"four devices ({len(jax.devices())})")
    mesh = make_mesh(n_sp=2, n_dp=2, devices=devices)
    check(set(mesh.devices.flat) == set(devices),
          "mesh spans all four devices")
    sd = scenes.get("cornell_box")
    st = RenderSettings(image_width=sh.width(512), aspect_ratio=1.0,
                        spp_per_chunk=8, num_chunks=1, max_depth=sh.depth(8))
    npix = st.num_pixels
    key = jax.random.PRNGKey(0)

    sharded = compile_sharded_renderer(sd.scene, sd.camera, st, mesh)
    out = sharded(key)
    check(out.sharding.device_set == set(devices),
          "sharded output lives on all four devices")
    per_dev = [float(jnp.abs(s.data).sum()) for s in out.addressable_shards]
    check(all(v > 0 for v in per_dev),
          f"every device rendered pixels (shard sums {np.round(per_dev, 1)})")
    single = render_chunk(sd.scene, sd.camera, st, key)
    a, b = np.asarray(out)[:npix], np.asarray(single)[:npix]
    check(bool(np.allclose(a, b, rtol=2e-5, atol=1e-5)),
          f"sharded render == single-device render_chunk (max |diff| "
          f"{np.abs(a - b).max():.3g})")
    t = time_call(sharded, key)
    t1 = time_call(jax.jit(lambda k: render_chunk(sd.scene, sd.camera, st,
                                                  k)), key)
    say(f"  forward chunk: 4 cards {t['median_s'] * 1e3:.3f} ms, one card "
        f"{t1['median_s'] * 1e3:.3f} ms (medians)")

    params = diff.get_params(sd.scene)
    target = jnp.zeros((npix, 3), jnp.float32)
    grads = {}
    for label, m in (("sharded", mesh), ("single", None)):
        f = compile_fused_param_renderer(sd.scene, sd.camera, st, mesh=m)
        vg = jax.jit(jax.value_and_grad(
            lambda p, f=f: jnp.mean((f(p, key)[:npix] - target) ** 2)))
        grads[label] = vg(params)
        t = time_call(vg, params)
        say(f"  fused fwd+bwd {label}: median {t['median_s'] * 1e3:.3f} ms")
    (l_s, g_s), (l_1, g_1) = grads["sharded"], grads["single"]
    check(abs(float(l_s) - float(l_1)) <= 1e-5 * max(abs(float(l_1)), 1e-9),
          f"sharded loss {float(l_s):.6g} == single {float(l_1):.6g}")
    for k in g_1:
        err = float(jnp.max(jnp.abs(g_s[k] - g_1[k])))
        scale = float(jnp.max(jnp.abs(g_1[k]))) + 1e-12
        check(err <= 1e-4 * scale + 1e-10,
              f"gradient {k}: sharded == single (max |diff| {err:.3g}, "
              f"scale {scale:.3g})")


PHASES = {"1": phase_forward, "2": phase_inverse, "3": phase_traversal,
          "4": phase_gpu_vs_cpu}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase, on four cards")
    ap.add_argument("--phases", default="1234",
                    help="single-card phases to run (default: all)")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny shapes on any platform; prints no result")
    args = ap.parse_args()

    if backend.platform() != "gpu" and not args.rehearse:
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"{backend.platform()} devices only", file=sys.stderr)
        return 2
    sh = Shapes(args.rehearse)
    cache = backend.setup_compile_cache()
    info = device_info()
    say(f"jax {jax.__version__}; {info['platform']} x{info['device_count']} "
        f"({info['device_kind']}); compile cache {cache}")
    t_all = time.perf_counter()
    phases = ([phase_four_cards] if args.four_cards
              else [PHASES[p] for p in args.phases])
    for run in phases:
        t0 = time.perf_counter()
        run(sh)
        say(f"  phase seconds: {time.perf_counter() - t0:.3f}")
    say(f"all phases passed in {time.perf_counter() - t_all:.3f} s")
    if args.rehearse:
        say("rehearsal: no result")
        return 0
    say(info["card"])
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
