"""End-to-end A/B of the two BVH traversals on one device.

    python tools/traversal_ab.py                 # both cells, 3 runs each
    python tools/traversal_ab.py --spp 2 --reps 1

Renders the same forward chunks of big_scene1 (800x450, depth 16; a
sphere BVH) and of the backpack's 100k-triangle stand-in (800x600, depth
16; a triangle BVH) once through the XLA walk (`accel/traverse.py`) and once
through the traversal kernel (`ops/bvh_kernel.py`), in the order XLA,
kernel, kernel, XLA, and prints one JSON line per cell with the median
chunk time of each and the card it ran on.  This is a measurement harness:
it forces each traversal explicitly, which the renderers' users never do.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from raytracing_gpu import backend  # noqa: E402
from raytracing_gpu.core.config import RenderSettings  # noqa: E402
from raytracing_gpu.engine.render import compile_renderer  # noqa: E402
from raytracing_gpu.models import scenes  # noqa: E402
from raytracing_gpu.utils.profiling import device_info, time_call  # noqa: E402

CELLS = [("big_scene1", 800, 16 / 9), ("backpack", 800, 4 / 3)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=4, help="samples per chunk")
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearsal off the GPU (XLA on both sides)")
    args = ap.parse_args()
    if backend.platform() != "gpu" and not args.cpu:
        print("traversal_ab: needs an NVIDIA GPU (or --cpu to rehearse)",
              file=sys.stderr)
        return 2
    backend.setup_compile_cache()
    info = device_info()
    kernel = (backend.kernel_traversal() if backend.platform() == "gpu"
              else backend.xla_traversal())
    for name, width, aspect in CELLS:
        sd = scenes.get(name)
        st = RenderSettings(image_width=width, aspect_ratio=aspect,
                            spp_per_chunk=args.spp, num_chunks=1,
                            max_depth=args.depth)
        key = jax.random.PRNGKey(1984)
        chunks = {"xla": compile_renderer(sd.scene, sd.camera, st,
                                          traverse=backend.xla_traversal()),
                  "kernel": compile_renderer(sd.scene, sd.camera, st,
                                             traverse=kernel)}
        runs = {"xla": [], "kernel": []}
        first = {}
        means = {}
        for label in ("xla", "kernel", "kernel", "xla"):
            t = time_call(chunks[label], key, reps=args.reps)
            first.setdefault(label, t["first_s"])
            runs[label].append(t["median_s"])
            means[label] = np.asarray(chunks[label](key))[:st.num_pixels].mean(0)
        rays = st.num_pixels * st.spp_per_chunk
        row = dict(cell=f"{name} {st.image_width}x{st.image_height} "
                        f"spp {st.spp_per_chunk} depth {st.max_depth}",
                   **{f"{k}_chunk_s": sorted(v)[len(v) // 2]
                      for k, v in runs.items()},
                   **{f"{k}_runs_s": v for k, v in runs.items()},
                   **{f"{k}_first_call_s": v for k, v in first.items()},
                   **{f"{k}_mrays_per_s": rays / sorted(v)[len(v) // 2] / 1e6
                      for k, v in runs.items()},
                   **{f"{k}_image_mean": [float(x) for x in v / args.spp]
                      for k, v in means.items()},
                   **info)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
