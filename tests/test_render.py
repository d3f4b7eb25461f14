"""End-to-end render tests: determinism, energy sanity, checkpoint/resume."""

import numpy as np
import pytest

from raytracing_gpu import RenderSettings, render, render_linear
from raytracing_gpu.models import scenes

SMALL = dict(image_width=64, spp_per_chunk=4, num_chunks=2, max_depth=6,
             ray_batch=4096)


@pytest.fixture(scope="module")
def basic():
    return scenes.get("basic")


class TestRender:
    def test_shape_and_range(self, basic):
        st = RenderSettings(aspect_ratio=basic.aspect, **SMALL)
        img = render(basic.scene, basic.camera, st)
        assert img.shape == (st.image_height, st.image_width, 3)
        assert np.all(img >= 0.0) and np.all(img <= 1.0)
        # sky background keeps mean energy well away from 0 and 1
        assert 0.2 < img.mean() < 0.9

    def test_deterministic(self, basic):
        st = RenderSettings(aspect_ratio=basic.aspect, **SMALL)
        a = render(basic.scene, basic.camera, st, seed=7)
        c = render(basic.scene, basic.camera, st, seed=7)
        d = render(basic.scene, basic.camera, st, seed=8)
        np.testing.assert_array_equal(a, c)
        assert not np.array_equal(a, d)

    def test_checkpoint_resume(self, basic, tmp_path):
        st = RenderSettings(aspect_ratio=basic.aspect, **SMALL)
        full = render_linear(basic.scene, basic.camera, st, seed=3)

        # render chunk 0, "crash", resume: must give the identical result
        ck = str(tmp_path / "ckpt")
        st1 = st.with_(num_chunks=1)
        render_linear(basic.scene, basic.camera, st1, seed=3, checkpoint_dir=ck)
        resumed = render_linear(basic.scene, basic.camera, st, seed=3,
                                checkpoint_dir=ck)
        np.testing.assert_allclose(resumed, full, rtol=1e-6)

    def test_checkpoint_rejects_mismatched_render(self, basic, tmp_path):
        """A checkpoint from a different seed/settings/scene must NOT resume
        (shape alone is not identity — VERDICT r1 weak #7)."""
        from raytracing_gpu.utils import checkpoint as ckpt

        st = RenderSettings(aspect_ratio=basic.aspect, **SMALL)
        ck = str(tmp_path / "ckpt")
        st1 = st.with_(num_chunks=1)
        render_linear(basic.scene, basic.camera, st1, seed=3, checkpoint_dir=ck)

        npix_pad = st.image_height * st.image_width  # 64x36 -> fits one batch
        # different seed: refused
        fp_other = ckpt.fingerprint(st, 4, basic.scene)
        assert ckpt.load(ck, fp=fp_other) is None
        # different depth: refused
        fp_depth = ckpt.fingerprint(st.with_(max_depth=2), 3, basic.scene)
        assert ckpt.load(ck, fp=fp_depth) is None
        # same render, more chunks: accepted
        fp_same = ckpt.fingerprint(st, 3, basic.scene)
        state = ckpt.load(ck, fp=fp_same)
        assert state is not None and state[1] == 1
        # different scene: refused
        other = scenes.get("two_spheres")
        fp_scene = ckpt.fingerprint(st, 3, other.scene)
        assert ckpt.load(ck, fp=fp_scene) is None

    def test_render_path_is_nan_free_under_checkify(self, basic):
        """Debug tier (SURVEY §5 sanitizer plan): the render chunk body runs
        clean under checkify's float checks — the runtime analogue of the
        reference's abort-on-error `checkCudaErrors` (`common.h:30-38`).
        The same checks back the CLI `--debug-nans` flag
        (utils.profiling.enable_nan_debugging)."""
        import jax
        from jax.experimental import checkify

        from raytracing_gpu.engine.render import chunk_sums

        st = RenderSettings(aspect_ratio=basic.aspect, image_width=32,
                            spp_per_chunk=2, num_chunks=1, max_depth=4,
                            ray_batch=2048)
        fn = checkify.checkify(
            lambda k: chunk_sums(basic.scene, basic.camera, st, k),
            errors=checkify.float_checks)
        err, out = jax.jit(fn)(jax.random.PRNGKey(2))
        err.throw()  # raises if any NaN/inf was produced anywhere in the chunk
        assert np.all(np.isfinite(np.asarray(out)))

    def test_more_samples_reduces_noise(self, basic):
        st_lo = RenderSettings(aspect_ratio=basic.aspect, image_width=48,
                               spp_per_chunk=2, num_chunks=1, max_depth=4,
                               ray_batch=4096)
        st_hi = st_lo.with_(spp_per_chunk=32)
        ref = render_linear(basic.scene, basic.camera,
                            st_lo.with_(spp_per_chunk=64), seed=11)
        lo = render_linear(basic.scene, basic.camera, st_lo, seed=5)
        hi = render_linear(basic.scene, basic.camera, st_hi, seed=5)
        err_lo = np.abs(lo - ref).mean()
        err_hi = np.abs(hi - ref).mean()
        assert err_hi < err_lo


class TestRussianRoulette:
    """rr_start > 0: unbiased early termination (no reference analogue — the
    reference runs its fixed 50-bounce loop, render.h:27,60)."""

    def test_unbiased_mean_energy(self):
        sd = scenes.get("cornell_box")
        st = RenderSettings(image_width=32, aspect_ratio=1.0, spp_per_chunk=48,
                            num_chunks=1, max_depth=50, ray_batch=1024)
        ref = render_linear(sd.scene, sd.camera, st, seed=9)
        rr = render_linear(sd.scene, sd.camera, st.with_(rr_start=3), seed=9)
        # same estimator mean within MC noise of 48 spp over 1024 pixels
        assert abs(rr.mean() - ref.mean()) / ref.mean() < 0.03
        corr = np.corrcoef(ref.reshape(-1, 3).mean(1), rr.reshape(-1, 3).mean(1))[0, 1]
        assert corr > 0.95

    def test_rr_changes_nothing_before_start(self):
        """Paths shorter than rr_start are untouched: with rr_start >=
        max_depth the image is bit-identical to rr off."""
        sd = scenes.get("basic")
        st = RenderSettings(aspect_ratio=sd.aspect, **SMALL)
        a = render_linear(sd.scene, sd.camera, st, seed=4)
        b = render_linear(sd.scene, sd.camera,
                          st.with_(rr_start=st.max_depth), seed=4)
        np.testing.assert_array_equal(a, b)

    def test_diff_path_rejects_rr(self):
        import jax

        from raytracing_gpu.engine.render import compile_param_renderer
        from raytracing_gpu.engine import diff

        sd = scenes.get("cornell_box")
        st = RenderSettings(image_width=16, aspect_ratio=1.0, spp_per_chunk=1,
                            num_chunks=1, max_depth=4, ray_batch=256,
                            rr_start=4)
        chunk = compile_param_renderer(sd.scene, sd.camera, st)
        with pytest.raises(AssertionError, match="roulette"):
            chunk(diff.get_params(sd.scene), jax.random.PRNGKey(0))
