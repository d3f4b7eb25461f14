"""Headline benchmark: Mrays/s forward+backward on the Cornell box
(BASELINE config 3), on one NVIDIA GPU.

    python bench.py           # on the GPU
    python bench.py --cpu     # rehearsal on the CPU, at 1/8 of the spp

Workload: Cornell box 512x512, 64 spp in chunks of 8, depth 8; every chunk
computes the L2-loss gradient w.r.t. the material/texture parameter pytree
through the fused closed-form VJP (engine/fused_diff.py).  "rays" follows
the reference's counting (rays_per_pixel = spp, `render.h:35-38`): one
camera sample = one ray, so Mrays/s = pixels * spp / seconds / 1e6.

This is `bench_all.py`'s config 3, the same code path and timing: warm-up
run, then the median of `bench_all.REPS` whole runs ending in
`block_until_ready`, with the first run (compilation) reported apart.
Prints ONE JSON line naming the metric, its value and the device.
"""

from __future__ import annotations

import argparse
import json

import bench_all


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (1/8 of the spp)")
    args = ap.parse_args()
    info = bench_all.device_or_exit(1 if args.cpu else 0)
    row = bench_all.bench_fwd_bwd(spp_scale=8 if args.cpu else 1)
    print(json.dumps(dict(
        metric="Mrays/s fwd+bwd (Cornell box 512^2, "
               f"{row['spp']} spp, depth 8)",
        value=row["mrays_per_s"], unit="Mrays/s", **row, **info)))


if __name__ == "__main__":
    main()
