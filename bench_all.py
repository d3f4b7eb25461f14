"""All five BASELINE benchmark configs + the scaling harness, on the GPU.

BASELINE.md declares five workloads (BASELINE.json:6-12).  `bench.py` reports
the headline (config 3, fwd+bwd); this script measures every config, one
JSON line per result:

    python bench_all.py                 # all 5 configs on the GPU
    python bench_all.py --spp-scale 8   # 1/8 spp (rays/s is intensive)
    python bench_all.py --scaling       # dp = 1,2,4,... over local devices
    python bench_all.py --json-out out.json
    python bench_all.py --cpu 8 --spp-scale 64   # rehearsal on 8 CPU devices

Configs (resolution/spp from BASELINE.md; depth documented here since the
baseline leaves it unspecified — the reference default is 50, render.h:27):

  1 first          400x225   16 spp  depth 8   forward
  2 big_scene1     800x450   32 spp  depth 16  forward   (~500 spheres, BVH,
                                                          motion blur+defocus)
  3 cornell_box    512x512   64 spp  depth 8   fwd+bwd   (headline, bench.py)
  4 cornell_smoke  512x512  128 spp  depth 16  forward   (media + perlin set)
  5 backpack       800x600  256 spp  depth 16  forward   (~100k tris, BVH;
                                                          an untextured
                                                          stand-in mesh
                                                          unless the asset
                                                          files are present)

Timing: one run is the whole workload (every chunk dispatched, each with its
own key) ending in `block_until_ready`.  The first run (compilation included)
is reported as `first_run_s`; the median, min and max of REPS (5) further
runs are the measurement.  Every row names the platform, device kind and
count, and the card's name and power limit.  Off the GPU the script refuses
to run unless `--cpu N` asks for a rehearsal on N virtual CPU devices.
"""

from __future__ import annotations

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_gpu.utils.profiling import time_call

REPS = 5


def _rays(settings) -> int:
    return settings.num_pixels * settings.spp_per_chunk * settings.num_chunks


def time_runs(step, key, num_chunks: int, reps: int = REPS) -> dict:
    """Seconds per whole run of `num_chunks` chunk steps (distinct keys):
    the first run (compilation) apart, then the median/min/max of `reps`."""
    keys = [jax.random.fold_in(key, c) for c in range(num_chunks)]
    t = time_call(lambda: [step(k) for k in keys], reps=reps)
    return dict(first_run_s=t["first_s"], seconds=t["median_s"],
                min_s=t["min_s"], max_s=t["max_s"], reps=reps)


def _row(t: dict, rays: int, **fields) -> dict:
    return dict(fields, **t, mrays_per_s=rays / t["seconds"] / 1e6)


def bench_forward(name: str, width: int, aspect: float, spp: int, depth: int,
                  spp_scale: int, rr_start: int = 0) -> dict:
    from raytracing_gpu.core.config import RenderSettings
    from raytracing_gpu.engine.render import compile_renderer
    from raytracing_gpu.models import scenes

    spp_run = max(1, spp // spp_scale)
    chunks = max(1, min(4, spp_run // 16 or spp_run))
    per_chunk = max(1, spp_run // chunks)
    sd = scenes.get(name)
    st = RenderSettings(image_width=width, aspect_ratio=aspect,
                        spp_per_chunk=per_chunk, num_chunks=chunks,
                        max_depth=depth, rr_start=rr_start)
    chunk = compile_renderer(sd.scene, sd.camera, st)
    t = time_runs(chunk, jax.random.PRNGKey(1984), chunks)
    row = _row(t, _rays(st), scene=name, mode="forward",
               shape=f"{st.image_width}x{st.image_height}",
               spp=st.rays_per_pixel, spp_declared=spp, depth=depth,
               traversal=chunk.traversal)
    if rr_start:
        row["rr_start"] = rr_start
    return row


def grad_step(param_chunk, params, target):
    """key -> (loss, grads) of the L2 loss of one chunk, jitted."""
    @jax.jit
    def step(k):
        return jax.value_and_grad(
            lambda p: jnp.mean((param_chunk(p, k) - target) ** 2))(params)
    return step


def bench_fwd_bwd(spp_scale: int) -> dict:
    """Config 3: Cornell box 512^2, 64 spp in chunks of 8, depth 8, the L2
    loss gradient w.r.t. the material/texture parameters of every chunk,
    through the fused closed-form VJP (engine/fused_diff.py)."""
    from raytracing_gpu.core.config import RenderSettings
    from raytracing_gpu.engine import diff
    from raytracing_gpu.engine.fused_diff import compile_fused_param_renderer
    from raytracing_gpu.models import scenes

    spp_run = max(8, 64 // spp_scale)
    sd = scenes.get("cornell_box")
    st = RenderSettings(image_width=512, aspect_ratio=1.0, spp_per_chunk=8,
                        num_chunks=spp_run // 8, max_depth=8)
    param_chunk = compile_fused_param_renderer(sd.scene, sd.camera, st)
    params = diff.get_params(sd.scene)
    key = jax.random.PRNGKey(1984)
    target = jnp.zeros_like(param_chunk(params, key))
    t = time_runs(grad_step(param_chunk, params, target), key, st.num_chunks)
    return _row(t, _rays(st), scene="cornell_box", mode="fwd+bwd",
                shape="512x512", spp=st.rays_per_pixel, spp_declared=64,
                depth=8, traversal=param_chunk.traversal)


def _grad_bench(name, width, aspect, spp, mode, grad_key, why):
    from raytracing_gpu.core.config import RenderSettings
    from raytracing_gpu.engine import diff
    from raytracing_gpu.engine.render import compile_param_renderer
    from raytracing_gpu.models import scenes

    sd = scenes.get(name)
    st = RenderSettings(image_width=width, aspect_ratio=aspect,
                        spp_per_chunk=spp, num_chunks=1, max_depth=8)
    param_chunk = compile_param_renderer(sd.scene, sd.camera, st)
    params = diff.get_params(sd.scene)
    key = jax.random.PRNGKey(1984)
    target = jnp.zeros_like(param_chunk(params, key))
    step = grad_step(param_chunk, params, target)
    grads = step(key)[1]
    assert bool((np.asarray(grads[grad_key]) != 0).any()), why
    t = time_runs(step, key, 1)
    return _row(t, _rays(st), scene=name, mode=mode,
                shape=f"{st.image_width}x{st.image_height}",
                spp=st.rays_per_pixel, depth=8,
                traversal=param_chunk.traversal)


def bench_earth_grad(spp_scale: int) -> dict:
    """Earth inverse-render micro-bench: fwd+bwd with image-atlas gradients
    (256x256, 8 spp, depth 8).  Needs the earth texture file; without it the
    scene is solid-coloured and has no atlas gradient, and the row errors."""
    return _grad_bench("earth", 256, 1.0, 8, "fwd+bwd+atlas-grads",
                       "atlas_data",
                       "atlas gradient must be nonzero on the earth scene")


def bench_mesh_grad(spp_scale: int) -> dict:
    """Backpack inverse-render micro-bench: fwd+bwd through the 100k-triangle
    BVH (800x600, 4 spp, depth 8)."""
    return _grad_bench("backpack", 800, 4 / 3, 4, "fwd+bwd+mesh-grads",
                       "tex_c1",
                       "albedo gradient must be nonzero on the backpack scene")


def bench_scaling(weak: bool = False) -> list:
    """rays/s vs dp-axis size over the local devices.

    strong (default): fixed total work — efficiency = rate_N / (N * rate_1).
    weak: constant per-device work (spp scales with the dp axis) — the
    regime the >=80% BASELINE target describes."""
    from raytracing_gpu.core.config import RenderSettings
    from raytracing_gpu.models import scenes
    from raytracing_gpu.parallel.mesh import make_mesh
    from raytracing_gpu.parallel.render import compile_sharded_renderer

    sd = scenes.get("first")
    n_dev = len(jax.devices())
    out, base = [], None
    dp = 1
    while dp <= n_dev:
        st = RenderSettings(image_width=400, aspect_ratio=16 / 9,
                            spp_per_chunk=8 * dp if weak else 8,
                            num_chunks=1, max_depth=8, ray_batch=8192)
        mesh = make_mesh(n_sp=1, n_dp=dp, devices=jax.devices()[:dp])
        chunk = compile_sharded_renderer(sd.scene, sd.camera, st, mesh)
        t = time_runs(chunk, jax.random.PRNGKey(7), 2)
        rate = _rays(st) / t["seconds"] / 1e6
        base = rate if base is None else base
        out.append(dict(mode="weak-scaling" if weak else "scaling",
                        devices=dp, **t, mrays_per_s=rate,
                        efficiency=rate / (base * dp)))
        dp *= 2
    return out


def device_or_exit(cpu_devices: int) -> dict:
    """Select the platform (CPU rehearsal or the GPU, nothing else), set the
    compile cache, and return what every row names about the device."""
    if cpu_devices:
        import os
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={cpu_devices}")
        jax.config.update("jax_platforms", "cpu")
    from raytracing_gpu import backend
    from raytracing_gpu.utils.profiling import device_info

    if not cpu_devices and backend.platform() != "gpu":
        sys.exit(f"needs an NVIDIA GPU (found {backend.platform()}); "
                 f"--cpu N rehearses on N CPU devices")
    backend.setup_compile_cache()
    return device_info()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="rehearse on the CPU with N virtual devices")
    ap.add_argument("--spp-scale", type=int, default=1,
                    help="divide declared spp by this (rays/s is intensive)")
    ap.add_argument("--scaling", action="store_true",
                    help="also run the dp scaling harness")
    ap.add_argument("--weak", action="store_true",
                    help="scaling harness keeps per-device work constant "
                         "(spp scales with dp)")
    ap.add_argument("--earth-grad", action="store_true",
                    help="also run the earth atlas-gradient micro-bench")
    ap.add_argument("--mesh-grad", action="store_true",
                    help="also run the backpack mesh-gradient micro-bench")
    ap.add_argument("--configs", default="1,2,3,4,5",
                    help="comma-separated subset of configs to run")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    info = device_or_exit(args.cpu)
    run = {c for c in args.configs.split(",") if c}
    results, failed = [], []

    def record(tag, thunk):
        # one failed workload must not lose the others' numbers; the exit
        # code still reports it
        try:
            out = thunk()
        except Exception as e:  # noqa: BLE001 — recorded, not swallowed
            out = dict(error=f"{type(e).__name__}: {e}"[:500])
            failed.append(tag)
        for row in out if isinstance(out, list) else [out]:
            row = dict(config=tag, **row, **info)
            results.append(row)
            print(json.dumps(row), flush=True)

    s = args.spp_scale
    if "1" in run:
        record(1, lambda: bench_forward("first", 400, 16 / 9, 16, 8, s))
    if "2" in run:
        record(2, lambda: bench_forward("big_scene1", 800, 16 / 9, 32, 16, s))
    if "3" in run:
        record(3, lambda: bench_fwd_bwd(s))
    if "4" in run:
        record(4, lambda: bench_forward("cornell_smoke", 512, 1.0, 128, 16,
                                        s))
    if "5" in run:
        record(5, lambda: bench_forward("backpack", 800, 4 / 3, 256, 16, s))
        # estimator variant: the same workload with russian roulette from
        # bounce 2 (unbiased; the reference has no RR, so the row above is
        # the like-for-like one)
        record("5-rr", lambda: bench_forward("backpack", 800, 4 / 3, 256, 16,
                                             s, rr_start=2))
    if args.earth_grad:
        record("earth-grad", lambda: bench_earth_grad(s))
    if args.mesh_grad:
        record("mesh-grad", lambda: bench_mesh_grad(s))
    if args.scaling:
        record("scaling", lambda: bench_scaling(weak=args.weak))

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(dict(spp_scale=args.spp_scale, results=results), f,
                      indent=1)
    if failed:
        print(f"bench_all: {len(failed)} workload(s) errored: {failed}",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
