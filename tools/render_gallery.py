"""Render the full scene registry at quality settings -> renders/.

renders/ is not kept in git; the gallery is made on demand.

The reference repo's deliverable is its `images/` gallery
(`/root/reference/images/`, README.md:3).  This script produces the
framework's own gallery: every registered scene at 512-800 px and >=100 spp,
written as PNG plus a README table mapping each render to the published
reference image it reproduces (mapping from tests/test_golden.py's
correlation sweep).

    python tools/render_gallery.py            # all scenes
    python tools/render_gallery.py cornell_box door
    python tools/render_gallery.py --spp 16   # quick pass
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# scene -> (width, spp_per_chunk, chunks, depth, reference image or None)
PLAN = {
    "basic": (800, 25, 4, 50, "image5.75.png"),
    "first": (800, 25, 4, 50, "image6.png"),
    "big_scene1": (800, 25, 4, 50, "image7.png"),
    "two_spheres": (800, 25, 4, 50, "image8.png"),
    "two_perlin_spheres": (800, 25, 4, 50, "image9.png"),
    "earth": (800, 25, 4, 50, "image10.75.png"),
    "cornell_box": (512, 50, 4, 50, "image11.png"),
    "cornell_smoke": (512, 50, 4, 50, "image12.png"),
    "triangle": (800, 25, 4, 50, "image13.png"),
    "triangles": (800, 25, 4, 50, "image14.png"),
    "door": (512, 25, 4, 50, "image16.png"),
    # backpack/cup assets are stripped from the reference checkout
    # (.MISSING_LARGE_BLOBS) — rendered here with the procedural 100k-tri
    # stand-in meshes, so there is no published image to compare against.
    "backpack": (800, 25, 4, 50, None),
    "cup": (800, 25, 4, 50, None),
}

HEADER = """# Rendered gallery

Every registered scene, rendered by this renderer on {device}
(`python tools/render_gallery.py`; russian roulette from bounce 4, full
reference depth 50).  The right column is the reference's published render
of the same scene (`/root/reference/images/`), identified by the
luminance-grid correlation sweep in `tests/test_golden.py`.  backpack/cup
use procedural 100,352-triangle stand-in meshes because the reference
checkout strips those assets (`.MISSING_LARGE_BLOBS`).

| scene | size | spp | render | reference |
|---|---|---|---|---|
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scenes", nargs="*", default=None)
    ap.add_argument("--spp", type=int, default=None,
                    help="override spp_per_chunk (quick pass)")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "renders"))
    args = ap.parse_args()

    import jax

    from raytracing_gpu.backend import setup_compile_cache
    from raytracing_gpu.core.config import RenderSettings
    from raytracing_gpu.engine import film
    from raytracing_gpu.engine.render import render
    from raytracing_gpu.models import scenes

    setup_compile_cache()
    os.makedirs(args.out, exist_ok=True)
    names = args.scenes or list(PLAN)
    rows = []
    for name in names:
        width, spp, chunks, depth, ref = PLAN[name]
        spp = args.spp or spp
        sd = scenes.get(name)
        st = RenderSettings(image_width=width, aspect_ratio=sd.aspect,
                            spp_per_chunk=spp, num_chunks=chunks,
                            max_depth=depth, ray_batch=65536, rr_start=4)
        t0 = time.perf_counter()
        img = render(sd.scene, sd.camera, st)
        dt = time.perf_counter() - t0
        path = os.path.join(args.out, f"{name}.png")
        film.write_png(path, img)
        rays = st.num_pixels * st.rays_per_pixel
        print(f"{name}: {st.image_width}x{st.image_height} "
              f"{st.rays_per_pixel}spp depth{depth} in {dt:.1f}s "
              f"({rays / dt / 1e6:.0f} Mrays/s) -> {path}", flush=True)
        ref_cell = (f"[`{ref}`](/root/reference/images/{ref})" if ref
                    else "stand-in mesh (asset stripped)")
        rows.append(f"| {name} | {st.image_width}x{st.image_height} | "
                    f"{st.rays_per_pixel} | ![{name}]({name}.png) | "
                    f"{ref_cell} |\n")

    if not args.scenes and args.spp is None:
        with open(os.path.join(args.out, "README.md"), "w") as f:
            f.write(HEADER.format(device=jax.devices()[0].device_kind))
            f.writelines(rows)


if __name__ == "__main__":
    main()
