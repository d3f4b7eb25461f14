"""Golden-image regression vs the reference's published renders.

The reference's only regression record is its committed PNGs (SURVEY §4):
`images/image16.png` is the door scene render.  Pixel-exact matching against
the reference binary is impossible (curand streams + reference bugs, SURVEY §4
quirks), so these tests assert *statistical/perceptual* agreement on a
downsampled luminance grid — mean energy and coarse structure — which catches
geometry/camera/material regressions while tolerating MC noise.
"""

import os

import numpy as np
import pytest

from raytracing_gpu import RenderSettings, render
from raytracing_gpu.models import scenes

REF_IMG = "/root/reference/images"


def _load(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def _downsample(img, grid=(6, 10)):
    h, w, _ = img.shape
    gh, gw = grid
    ys = np.linspace(0, h, gh + 1, dtype=int)
    xs = np.linspace(0, w, gw + 1, dtype=int)
    out = np.zeros((gh, gw))
    lum = img @ np.array([0.299, 0.587, 0.114])
    for i in range(gh):
        for j in range(gw):
            out[i, j] = lum[ys[i]:ys[i + 1], xs[j]:xs[j + 1]].mean()
    return out


# scene -> (published PNG, spp_per_chunk, chunks, depth,
#           energy tol, min corr, max per-cell |dev|)
# The image numbers were identified by a luminance-grid correlation sweep over
# /root/reference/images (e.g. basic -> image5.75 at corr 0.997 / energy 0.021
# while the next candidate scores 0.93; triangle -> image13 at 0.997).  The
# enclosed emissive cornell scenes need ~128 spp and depth 16 before the
# gamma-space grid stabilizes (gamma-2 of a noisy estimate is biased low by
# Jensen).  Bounds are calibrated ~1.5x above the measured seed-1 values
# (2026-08: corr 0.816-0.997, max cell dev 0.012-0.222 across the set).
#
# big_scene1's corr CAPS at ~0.82 at any spp (measured: 0.816 at 8 spp,
# 0.815 at 64 spp, depth 10): its 22x22 random sphere field is a different
# curand draw than the published image — layout is statistically identical
# but not replayable (scenes.h:150-186), so only the heroes/ground/sky
# correlate.  The per-cell bound (0.30) still catches shading regressions.
GOLDEN = {
    "basic": ("image5.75.png", 8, 1, 6, 0.10, 0.95, 0.15),
    "first": ("image6.png", 8, 1, 6, 0.12, 0.95, 0.15),
    "big_scene1": ("image7.png", 8, 1, 6, 0.15, 0.80, 0.30),
    "two_spheres": ("image8.png", 8, 1, 6, 0.12, 0.92, 0.15),
    "two_perlin_spheres": ("image9.png", 8, 1, 6, 0.15, 0.85, 0.30),
    "earth": ("image10.75.png", 16, 4, 8, 0.15, 0.95, 0.10),
    "cornell_box": ("image11.png", 32, 4, 16, 0.15, 0.95, 0.12),
    "cornell_smoke": ("image12.png", 32, 2, 16, 0.15, 0.95, 0.13),
    "triangle": ("image13.png", 8, 1, 6, 0.10, 0.95, 0.15),
    "triangles": ("image14.png", 8, 1, 6, 0.12, 0.95, 0.22),
    "door": ("image16.png", 8, 1, 5, 0.15, 0.95, 0.05),
}


@pytest.mark.skipif(not os.path.isdir(REF_IMG), reason="reference images absent")
class TestGolden:
    @pytest.mark.parametrize("name", sorted(GOLDEN))
    def test_matches_published_render(self, name):
        img, spp, chunks, depth, energy_tol, min_corr, max_cell = GOLDEN[name]
        ref = _load(os.path.join(REF_IMG, img))
        sd = scenes.get(name)
        st = RenderSettings(image_width=120, aspect_ratio=sd.aspect,
                            spp_per_chunk=spp, num_chunks=chunks,
                            max_depth=depth, ray_batch=8192)
        ours = render(sd.scene, sd.camera, st, seed=1)

        g_ref = _downsample(ref)
        g_ours = _downsample(ours)
        rel = abs(g_ours.mean() - g_ref.mean()) / max(g_ref.mean(), 1e-6)
        assert rel < energy_tol, f"{name}: energy off by {rel:.3f}"
        corr = np.corrcoef(g_ref.reshape(-1), g_ours.reshape(-1))[0, 1]
        assert corr > min_corr, f"{name}: grid corr {corr:.3f}"
        # per-cell bound: a global correlation can stay high while one region
        # (a wall, a light) renders materially wrong — bound every cell
        cell = np.abs(g_ours - g_ref).max()
        assert cell < max_cell, f"{name}: max cell deviation {cell:.3f}"
