"""Command-line interface.

The reference has no CLI at all — scene choice is a commented-out code edit in
`main.cu:17-18` and settings are struct-field mutations (`main.cu:24-29`).
This module provides the SURVEY §5 plan: scene registry by name + argparse
flags over RenderSettings, plus checkpoint/resume and profiling switches.

    python -m raytracing_gpu.cli render cornell_box -o out.png \
        --width 512 --spp 64 --chunks 4 --depth 16
    python -m raytracing_gpu.cli list
    python -m raytracing_gpu.cli bench cornell_box --width 256
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracing_gpu",
                                description="differentiable path tracer")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="render a registered scene to PNG/PPM")
    r.add_argument("scene", help="scene name (see `list`)")
    r.add_argument("-o", "--output", default="image.png",
                   help="output path (.png or .ppm)")
    r.add_argument("--width", type=int, default=1200)      # render.h:22
    r.add_argument("--spp", type=int, default=100,         # render.h:26
                   help="samples per pixel per chunk")
    r.add_argument("--chunks", type=int, default=10,       # render.h:37 no_fb
                   help="number of sample chunks (frame buffers)")
    r.add_argument("--depth", type=int, default=50)        # render.h:27
    r.add_argument("--ray-batch", type=int, default=65536)
    r.add_argument("--seed", type=int, default=1984)       # render.h:91
    r.add_argument("--checkpoint-dir", default=None,
                   help="directory for resumable float32 partial sums")
    r.add_argument("--sharded", action="store_true",
                   help="shard over all local devices (sp x dp mesh)")
    r.add_argument("--n-sp", type=int, default=1,
                   help="sample-parallel mesh axis size (with --sharded)")
    r.add_argument("--multihost", action="store_true",
                   help="initialize jax.distributed and mesh over ALL global "
                        "devices (implies --sharded); pass the three "
                        "--coordinator-* flags on every process")
    r.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0 (with --multihost)")
    r.add_argument("--num-processes", type=int, default=None)
    r.add_argument("--process-id", type=int, default=None)
    r.add_argument("--profile-dir", default=None,
                   help="write a jax.profiler trace to this directory")
    r.add_argument("--rr-start", type=int, default=0,
                   help="russian roulette from this bounce (0 = off): paths "
                        "continue w.p. clip(max throughput, .05, 1) and "
                        "survivors are reweighted 1/p — unbiased; at the "
                        "depth-50 default most of each wave's bounce tail "
                        "is dead lanes, which RR cuts short")
    r.add_argument("--debug-nans", action="store_true",
                   help="abort on the first NaN any jit produces "
                        "(jax_debug_nans — the debug-mode analogue of the "
                        "reference's checkCudaErrors abort, common.h:30-38)")
    r.add_argument("--quiet", action="store_true")

    sub.add_parser("list", help="list registered scenes")

    b = sub.add_parser("bench", help="time a forward render and report Mrays/s")
    b.add_argument("scene")
    b.add_argument("--width", type=int, default=512)
    b.add_argument("--spp", type=int, default=16)
    b.add_argument("--depth", type=int, default=8)
    b.add_argument("--ray-batch", type=int, default=65536)
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    from .backend import setup_compile_cache

    setup_compile_cache()

    # multi-host init must happen before any other JAX use creates a backend
    coordinator = getattr(args, "multihost", False)
    is_coord = True
    if coordinator:
        from .parallel import distributed

        distributed.initialize(coordinator_address=args.coordinator_address,
                               num_processes=args.num_processes,
                               process_id=args.process_id)
        is_coord = distributed.is_coordinator()
        args.sharded = True

    if args.command == "list":
        from .models import scenes

        for name in scenes.names():
            print(name)
        return 0

    from .core.config import RenderSettings
    from .models import scenes

    sd = scenes.get(args.scene)

    if args.command == "bench":
        import jax

        from .engine.render import compile_renderer
        from .utils.profiling import RaysPerSecond

        st = RenderSettings(image_width=args.width, aspect_ratio=sd.aspect,
                            spp_per_chunk=args.spp, num_chunks=1,
                            max_depth=args.depth, ray_batch=args.ray_batch)
        chunk = compile_renderer(sd.scene, sd.camera, st)
        key = jax.random.PRNGKey(0)
        jax.block_until_ready(chunk(key))  # compile
        meter = RaysPerSecond()
        with meter.measure(st.num_pixels * st.spp_per_chunk):
            jax.block_until_ready(chunk(jax.random.fold_in(key, 1)))
        print(json.dumps({"scene": args.scene, "mrays_per_s": meter.mrays,
                          "seconds": meter.seconds,
                          "traversal": chunk.traversal,
                          "platform": jax.devices()[0].platform,
                          "device_kind": jax.devices()[0].device_kind}))
        return 0

    # render
    if args.debug_nans:
        from .utils.profiling import enable_nan_debugging

        enable_nan_debugging()
    st = RenderSettings(image_width=args.width, aspect_ratio=sd.aspect,
                        spp_per_chunk=args.spp, num_chunks=args.chunks,
                        max_depth=args.depth, ray_batch=args.ray_batch,
                        seed=args.seed, rr_start=args.rr_start)

    def progress(c, n, dt):
        if not args.quiet:
            # reference progress lines: "Rendering to frame buffer i/N"
            # (render.h:153)
            rays = st.num_pixels * st.spp_per_chunk
            print(f"chunk {c}/{n}: {dt:.2f}s ({rays / dt / 1e6:.2f} Mrays/s)",
                  file=sys.stderr)

    chunk_fn = None
    if args.sharded:
        from .parallel.mesh import make_mesh
        from .parallel.render import make_sharded_chunk_fn

        mesh = make_mesh(n_sp=args.n_sp)
        # scene-specialized: bakes geometry into the sharded program
        chunk_fn = make_sharded_chunk_fn(mesh, sd.scene, sd.camera, st)

    from .engine import film
    from .engine.render import render_linear

    profile_cm = None
    if args.profile_dir:
        import jax.profiler

        profile_cm = jax.profiler.trace(args.profile_dir)
        profile_cm.__enter__()

    from .utils.profiling import PhaseTimer

    timer = PhaseTimer()
    t0 = time.perf_counter()
    # every process renders its shards; only the coordinator persists
    # checkpoints and encodes the image (SURVEY §5 distributed plan)
    linear = render_linear(sd.scene, sd.camera, st, seed=args.seed,
                           checkpoint_dir=args.checkpoint_dir if is_coord else None,
                           progress=progress if is_coord else None,
                           chunk_fn=chunk_fn, timer=timer)
    elapsed = time.perf_counter() - t0

    if profile_cm is not None:
        profile_cm.__exit__(None, None, None)

    if not is_coord:
        return 0
    img = film.finalize(linear * st.rays_per_pixel, st.rays_per_pixel)
    if args.output.endswith(".ppm"):
        film.write_ppm(args.output, img)
    else:
        film.write_png(args.output, img)
    if not args.quiet:
        # reference prints elapsed s/m/h (main.cu:40-45)
        total_rays = st.num_pixels * st.rays_per_pixel
        print(f"rendered {args.scene} {st.image_width}x{st.image_height} "
              f"{st.rays_per_pixel}spp in {elapsed:.1f}s "
              f"({total_rays / elapsed / 1e6:.2f} Mrays/s) -> {args.output}",
              file=sys.stderr)
        # per-phase split (build/trace/io; SURVEY §5 observability)
        print(timer.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
