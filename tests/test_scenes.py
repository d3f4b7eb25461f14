"""Scene registry tests: every reference scene builds and renders finite."""

import numpy as np
import pytest

from raytracing_gpu import RenderSettings, render_linear
from raytracing_gpu.models import scenes

ALL = scenes.names()
# mesh scenes are exercised separately (BVH path, test_bvh.py) — keep the
# quick sweep to the analytic-primitive scenes
QUICK = [n for n in ALL if n not in ("door", "backpack", "cup", "big_scene1")]


def test_registry_covers_all_reference_scenes():
    # the 12 reference scene structs (scenes.h:82-621) + none missing
    expected = {
        "basic", "first", "big_scene1", "two_spheres", "two_perlin_spheres",
        "earth", "cornell_box", "cornell_smoke", "triangle", "triangles",
        "door", "backpack", "cup",
    }
    assert expected <= set(ALL)


@pytest.mark.parametrize("name", QUICK)
def test_scene_renders_finite(name):
    sd = scenes.get(name)
    st = RenderSettings(image_width=32, aspect_ratio=sd.aspect,
                        spp_per_chunk=2, num_chunks=1, max_depth=4,
                        ray_batch=1024)
    img = render_linear(sd.scene, sd.camera, st, seed=1)
    assert np.all(np.isfinite(img))
    assert img.shape == (st.image_height, st.image_width, 3)
    assert img.min() >= 0.0


def test_big_scene1_builds():
    sd = scenes.get("big_scene1")
    n_active = int(np.asarray(sd.scene.spheres.active).sum())
    # ground + ~22*22 random + 3 heroes, minus excluded centers
    assert 400 < n_active < 489


def test_cornell_smoke_has_media():
    sd = scenes.get("cornell_smoke")
    assert int(np.asarray(sd.scene.boxes.medium).sum()) == 2
