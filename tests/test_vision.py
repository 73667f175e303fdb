"""Vision-layer tests against literal per-pixel NumPy oracles (oracles.py)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vaudio import vision
from vaudio.config import AuralizerConfig

import oracles


CFG = AuralizerConfig()
SMALL = dataclasses.replace(CFG)  # defaults; frames stay small in tests


def random_frame(rng, h=32, w=48):
    return rng.uniform(0, 1, (h, w, 3)).astype(np.float32)


class TestRgbToHsi:
    def test_against_oracle(self, rng):
        rgb = rng.uniform(0, 1, (64, 3)).astype(np.float32)
        got = np.asarray(vision.rgb_to_hsi(rgb))
        expect = oracles.rgb_to_hsi_np(rgb)
        np.testing.assert_allclose(got, expect, atol=2e-5)

    def test_grey_pixel(self):
        out = np.asarray(vision.rgb_to_hsi(np.array([0.5, 0.5, 0.5],
                                                    np.float32)))
        np.testing.assert_allclose(out, [0.0, 0.0, 0.5], atol=1e-6)

    def test_black_pixel(self):
        out = np.asarray(vision.rgb_to_hsi(np.zeros(3, np.float32)))
        np.testing.assert_allclose(out, [0.0, 0.0, 0.0], atol=1e-7)

    def test_primaries(self):
        # Pure red: hue 0; pure green: 1/3; pure blue: 2/3.
        red = np.asarray(vision.rgb_to_hsi(np.array([1, 0, 0], np.float32)))
        green = np.asarray(vision.rgb_to_hsi(np.array([0, 1, 0], np.float32)))
        blue = np.asarray(vision.rgb_to_hsi(np.array([0, 0, 1], np.float32)))
        assert np.isclose(red[0], 0.0, atol=1e-6)
        assert np.isclose(green[0], 1 / 3, atol=1e-5)
        assert np.isclose(blue[0], 2 / 3, atol=1e-5)
        for px in (red, green, blue):
            assert np.isclose(px[1], 1.0, atol=1e-6)   # full saturation
            assert np.isclose(px[2], 1 / 3, atol=1e-6)  # intensity


class TestAcosPoly:
    def test_accuracy_dense_grid(self):
        """A&S 4.4.46 promises <= 2e-8 rad; in f32 the sqrt/fma rounding
        adds ~1 ulp of pi, so assert 5e-7 over a dense [-1, 1] grid
        including the endpoints."""
        x = np.linspace(-1.0, 1.0, 200_001).astype(np.float32)
        got = np.asarray(vision.acos_poly(jnp.asarray(x)))
        expect = np.arccos(x.astype(np.float64))
        assert np.max(np.abs(got - expect)) < 5e-7

    def test_endpoints(self):
        got = np.asarray(vision.acos_poly(
            jnp.asarray([-1.0, 0.0, 1.0], jnp.float32)))
        np.testing.assert_allclose(got, [np.pi, np.pi / 2, 0.0], atol=3e-7)

    def test_hsi_fast_acos_matches_exact(self, rng):
        """fast_acos hue planes agree with the transcendental path to
        well below a histogram bin (1/360 ~ 2.8e-3)."""
        frame = random_frame(rng, h=64, w=64)
        r, g, b = (jnp.asarray(frame[..., k]) for k in range(3))
        h_exact, s1, i1 = vision.rgb_to_hsi_planes(r, g, b)
        h_fast, s2, i2 = vision.rgb_to_hsi_planes(r, g, b, fast_acos=True)
        np.testing.assert_allclose(np.asarray(h_fast),
                                   np.asarray(h_exact), atol=1e-6)
        np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_pipeline_equivalent_with_flag(self, rng):
        """cfg.fast_hue_acos end-to-end: same histogram totals and
        near-identical per-bin counts on a random frame.  The exact arm
        pins fast_hue_acos=False EXPLICITLY — the flag defaults to True,
        so AuralizerConfig() would make this a vacuous self-comparison."""
        from vaudio.config import AuralizerConfig
        frame = random_frame(rng, h=64, w=64)
        hist_e, grads_e, _ = vision.frame_stats(
            jnp.asarray(frame), AuralizerConfig(fast_hue_acos=False))
        hist_f, grads_f, _ = vision.frame_stats(
            jnp.asarray(frame), AuralizerConfig(fast_hue_acos=True))
        assert float(jnp.sum(hist_e)) == float(jnp.sum(hist_f))
        # A count moves bins only for hues within 2e-8 rad of an edge.
        assert float(jnp.sum(jnp.abs(hist_e - hist_f))) <= 2.0
        np.testing.assert_allclose(np.asarray(grads_f),
                                   np.asarray(grads_e), atol=1e-6)


class TestMipDownsample:
    def test_matches_box_filter(self, rng):
        frame = random_frame(rng, 32, 48)
        got = np.asarray(vision.mip_downsample(frame, 3))
        expect = oracles.mip_np(frame, 3)
        assert got.shape == (4, 6, 3)
        np.testing.assert_allclose(got, expect, atol=1e-6)

    def test_constant_preserved(self):
        frame = np.full((16, 16, 3), 0.25, np.float32)
        out = np.asarray(vision.mip_downsample(frame, 2))
        np.testing.assert_allclose(out, 0.25, atol=1e-7)

    def test_odd_dims_floor_halving(self):
        # Metal mip chains floor-halve odd dims; output dims must be
        # d >> level (270 -> 33 at level 3).
        out = np.asarray(vision.mip_downsample(
            np.full((270, 480, 3), 0.5, np.float32), 3))
        assert out.shape == (33, 60, 3)
        np.testing.assert_allclose(out, 0.5, atol=1e-6)

    def test_rejects_too_small(self):
        with pytest.raises(ValueError):
            vision.mip_downsample(np.zeros((4, 32, 3), np.float32), 3)

    def test_quantize_flag(self, rng):
        frame = (rng.integers(0, 256, (16, 16, 3)) / 255.0).astype(np.float32)
        q = np.asarray(vision.mip_downsample(frame, 2, quantize=True))
        # All values must land on the 8-bit grid.
        np.testing.assert_allclose(q * 255, np.round(q * 255), atol=1e-4)


class TestRotation:
    def test_rotate_cw_layout(self):
        x = np.arange(12).reshape(3, 4).astype(np.float32)
        r = np.asarray(vision.rotate_cw(x))
        assert r.shape == (4, 3)
        h = x.shape[0]
        for i in range(4):
            for j in range(3):
                assert r[i, j] == x[h - 1 - j, i]


class TestFeatureStencil:
    def test_against_oracle(self, rng):
        mip = rng.uniform(0, 1, (6, 8, 3)).astype(np.float32)
        hsi = vision.rgb_to_hsi(mip)
        got = np.asarray(vision.rotate_cw(vision.feature_stencil(hsi)))
        expect = oracles.convolve_features_np(mip)
        assert got.shape == expect.shape == (8, 6, 3, 4)
        np.testing.assert_allclose(got, expect, atol=1e-4)

    def test_zero_sum_masks_kill_constants(self):
        hsi = np.full((5, 7, 3), 0.3, np.float32)
        out = np.asarray(vision.feature_stencil(hsi))
        np.testing.assert_allclose(out, 0.0, atol=1e-6)

    def test_mask_values(self):
        from vaudio.vision.features import MODE_KERNELS
        assert MODE_KERNELS.shape == (4, 3, 3)
        np.testing.assert_allclose(MODE_KERNELS.sum(axis=(1, 2)), 0.0)
        # Center weights: breathing 4, others 0
        np.testing.assert_allclose(MODE_KERNELS[:, 1, 1], [4, 0, 0, 0])


class TestHueHistogram:
    @pytest.mark.parametrize("method", ["tiled", "matmul", "scatter"])
    def test_against_oracle(self, rng, method):
        mip = rng.uniform(0, 1, (16, 24, 3)).astype(np.float32)
        hsi_rot = vision.rotate_cw(vision.rgb_to_hsi(mip))
        got = np.asarray(vision.hue_histogram(hsi_rot, CFG, method=method))
        expect = oracles.hue_histogram_np(mip)
        assert got.shape == (16, 360)
        # f32 hue quantization at bin edges can shift a count by one bin;
        # require exact totals and near-exact per-bin agreement.
        assert got.sum() == expect.sum()
        assert np.abs(got - expect).sum() <= 4

    def test_gating(self):
        # Dark pixels (I <= 0.1) and grey pixels (S == 0) must not count.
        mip = np.zeros((8, 8, 3), np.float32)
        mip[:4] = 0.05   # dark
        mip[4:] = 0.5    # grey: S == 0
        hsi_rot = vision.rotate_cw(vision.rgb_to_hsi(mip))
        hist = np.asarray(vision.hue_histogram(hsi_rot, CFG))
        assert hist.sum() == 0

    def test_solid_color_single_bin(self):
        mip = np.zeros((8, 8, 3), np.float32)
        mip[...] = [0.8, 0.3, 0.2]   # a saturated reddish color
        hsi_rot = vision.rotate_cw(vision.rgb_to_hsi(mip))
        hist = np.asarray(vision.hue_histogram(hsi_rot, CFG))
        assert hist.sum() == 64
        # Every cell sees the same single bin (cells of 2x2=4 px each... the
        # 8x8 rotated image tiles into 16 cells of 4 pixels).
        assert (hist > 0).sum() == 16
        np.testing.assert_array_equal(hist.max(axis=1), 4)


class TestUpdateHues:
    def test_against_oracle(self, rng):
        hist = rng.integers(0, 60, (16, 360)).astype(np.float32)
        prev = rng.integers(0, 360, 16).astype(np.int32)
        got = np.asarray(vision.update_hues(jnp.asarray(hist),
                                            jnp.asarray(prev),
                                            jnp.float32(0.9), CFG))
        expect = oracles.update_hues_np(hist, prev, 0.9)
        np.testing.assert_array_equal(got, expect)

    def test_gate_keeps_previous(self):
        hist = np.full((16, 360), 5.0, np.float32)   # max 5 <= 20
        prev = np.arange(16, dtype=np.int32)
        got = np.asarray(vision.update_hues(jnp.asarray(hist),
                                            jnp.asarray(prev),
                                            jnp.float32(0.5), CFG))
        np.testing.assert_array_equal(got, prev)

    def test_ema_truncation(self):
        hist = np.zeros((16, 360), np.float32)
        hist[:, 100] = 50.0
        prev = np.full(16, 9, np.int32)
        got = np.asarray(vision.update_hues(jnp.asarray(hist),
                                            jnp.asarray(prev),
                                            jnp.float32(0.9), CFG))
        # 9*0.9 + 100*0.1 = 18.1 -> trunc 18
        np.testing.assert_array_equal(got, 18)


class TestCellGradStats:
    def test_against_oracle_linear(self, rng):
        feat = rng.normal(size=(24, 18, 4)).astype(np.float32)
        got = np.asarray(vision.cell_gradient_stats(feat, CFG))
        expect = oracles.cell_grad_stats_np(feat)
        np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)

    def test_remainder_goes_to_last_cell(self, rng):
        # 17x5 = 85 pixels; 85//16 = 5, last cell gets 85-75=10 pixels.
        feat = rng.normal(size=(17, 5, 4)).astype(np.float32)
        got = np.asarray(vision.cell_gradient_stats(feat, CFG))
        expect = oracles.cell_grad_stats_np(feat)
        np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)

    def test_spatial_mode(self, rng):
        cfg = dataclasses.replace(CFG, linear_cell_grads=False)
        feat = rng.normal(size=(16, 16, 4)).astype(np.float32)
        got = np.asarray(vision.cell_gradient_stats(feat, cfg))
        # Oracle: direct block reduction over the 4x4 tiling.
        blocks = feat.reshape(4, 4, 4, 4, 4)  # (cr, by, cc, bx, mode)
        for cr in range(4):
            for cc in range(4):
                sl = feat[cr * 4:(cr + 1) * 4, cc * 4:(cc + 1) * 4]
                sl = sl.reshape(-1, 4)
                cell = cr * 4 + cc
                np.testing.assert_allclose(
                    got[cell],
                    [np.sqrt(np.mean(sl[:, 0] ** 2)),
                     np.mean(np.abs(sl[:, 1])),
                     np.mean(np.abs(sl[:, 2])),
                     np.max(np.abs(sl[:, 3]))],
                    rtol=1e-4, atol=1e-5)


class TestExtractFeatures:
    def test_end_to_end_shapes(self, rng):
        frame = random_frame(rng, 64, 64)
        hues, grads, debug = vision.extract_features(
            jnp.asarray(frame), jnp.zeros(16, jnp.int32), jnp.float32(0.0),
            CFG, compute_debug_maps=True)
        assert hues.shape == (16,) and hues.dtype == jnp.int32
        assert grads.shape == (16, 4)
        assert debug["histogram"].shape == (16, 360)
        assert debug["intensity_map"].shape == (8, 8, 4)

    def test_small_frame_fails_count_gate(self):
        # 64x64 -> 8x8 mip -> 4 px/cell, below the >20 count gate, so hues
        # must keep their previous value (VisionEngine.swift:263).
        frame = np.zeros((64, 64, 3), np.float32)
        frame[..., 0] = 1.0
        hues, _, _ = vision.extract_features(
            jnp.asarray(frame), jnp.full(16, 200, jnp.int32),
            jnp.float32(0.0), CFG)
        np.testing.assert_array_equal(np.asarray(hues), 200)

    def test_solid_red_frame_hue_zero(self):
        # 256x256 -> 32x32 mip -> 64 px/cell, clears the gate.
        frame = np.zeros((256, 256, 3), np.float32)
        frame[..., 0] = 1.0
        hues, grads, _ = vision.extract_features(
            jnp.asarray(frame), jnp.full(16, 200, jnp.int32),
            jnp.float32(0.0), CFG)
        # mixing=0 -> hue snaps straight to the argmax bin (red = bin 0)
        np.testing.assert_array_equal(np.asarray(hues), 0)
        # Uniform frame -> all gradient modes zero
        np.testing.assert_allclose(np.asarray(grads), 0.0, atol=1e-6)


class TestYuvDevicePath:
    def test_matches_host_conversion(self, rng):
        # Device path (pool-then-convert) vs host path (convert-then-pool):
        # box pooling commutes with the affine BT.601 transform up to the
        # host path's uint8 quantization and clipping of out-of-gamut
        # pixels.
        from vaudio.io import yuv420_to_rgb
        from vaudio.vision import yuv420_mip_to_rgb_planes
        h, w = 64, 64
        # Keep YUV in-gamut so clipping doesn't break commutativity.
        y = rng.integers(60, 200, (h, w)).astype(np.uint8)
        u = rng.integers(108, 148, (h // 2, w // 2)).astype(np.uint8)
        v = rng.integers(108, 148, (h // 2, w // 2)).astype(np.uint8)
        dev = np.asarray(yuv420_mip_to_rgb_planes(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), CFG))
        rgb_host = yuv420_to_rgb(y, u, v).astype(np.float32) / 255.0
        host_mip = np.asarray(vision.mip_downsample(rgb_host, CFG.mip_level))
        np.testing.assert_allclose(dev, np.transpose(host_mip, (2, 0, 1)),
                                   atol=0.02)  # u8 quantization of host path

    def test_full_step_with_yuv_dict(self, rng):
        frame = {
            "y": rng.integers(16, 236, (256, 256)).astype(np.uint8),
            "u": rng.integers(16, 240, (128, 128)).astype(np.uint8),
            "v": rng.integers(16, 240, (128, 128)).astype(np.uint8),
        }
        hues, grads, _ = vision.extract_features(
            frame, jnp.zeros(16, jnp.int32), jnp.float32(0.0), CFG)
        assert hues.shape == (16,)
        assert np.all(np.isfinite(np.asarray(grads)))


class TestU8PoolingExactness:
    def test_bf16_u8_path_matches_f32(self, rng):
        # The uint8 bf16 pooling must match converting to f32 first
        # to within a few ULP (it is exact by construction; only the
        # order of the 1/255 application differs).
        from vaudio.vision.features import mip_downsample_planes
        u8 = rng.integers(0, 256, (3, 64, 96)).astype(np.uint8)
        got = np.asarray(mip_downsample_planes(
            jnp.asarray(u8), 3, scale=1.0 / 255.0))
        f32 = u8.astype(np.float32) / 255.0
        expect = np.asarray(mip_downsample_planes(jnp.asarray(f32), 3))
        np.testing.assert_allclose(got, expect, atol=2e-7)


class TestMatmulPrecisionPinned:
    """GPU tensor cores run DEFAULT-precision f32 dots in TF32 (~1e-3
    relative error).  The CPU harness computes full f32 regardless of
    the precision flag, so the only CI-visible guard is the trace: every
    parity-critical f32 contraction must carry Precision.HIGHEST in its
    jaxpr.  The on-device check is chip_smoke.py's parity phase."""

    @staticmethod
    def _f32_dots_all_highest(jaxpr_str):
        bad = []
        start = 0
        while True:
            i = jaxpr_str.find("dot_general[", start)
            if i < 0:
                return bad
            depth, j = 0, i + len("dot_general")
            while True:                      # balanced-bracket param slice
                if jaxpr_str[j] == "[":
                    depth += 1
                elif jaxpr_str[j] == "]":
                    depth -= 1
                    if depth == 0:
                        break
                j += 1
            params = jaxpr_str[i:j]
            start = j
            if "preferred_element_type=int32" in params:
                continue            # integer dots are exact by construction
            if "HIGHEST" not in params:
                bad.append(params)

    def test_mip_u8_path(self):
        from vaudio.vision.features import mip_downsample_planes
        jx = jax.make_jaxpr(
            lambda p: mip_downsample_planes(p, 3, scale=1 / 255.0))(
                jnp.zeros((3, 64, 64), jnp.uint8))
        assert not self._f32_dots_all_highest(str(jx))

    def test_mip_f32_and_quantize_paths(self):
        from vaudio.vision.features import mip_downsample_planes
        x = jnp.zeros((3, 64, 64), jnp.float32)
        for q in (False, True):
            jx = jax.make_jaxpr(
                lambda p: mip_downsample_planes(p, 3, quantize=q))(x)
            assert not self._f32_dots_all_highest(str(jx))

    def test_full_frame_step_chunked_and_scan(self):
        from vaudio.runtime import make_step, init_carry
        from vaudio.runtime.step import default_params
        from vaudio.runtime.chunked import make_chunk_pipeline
        cfg = CFG
        step = make_step(cfg, jit=False)
        carry = init_carry(cfg)
        params = default_params(cfg)
        frame = jnp.zeros((64, 64, 3), jnp.uint8)
        jx = jax.make_jaxpr(lambda c, f, p: step(c, f, p))(
            carry, frame, params)
        assert not self._f32_dots_all_highest(str(jx))
        cstep = make_chunk_pipeline(cfg, jit=False)
        jx = jax.make_jaxpr(lambda c, f, p: cstep(c, f, p))(
            carry, jnp.zeros((4, 64, 64, 3), jnp.uint8), params)
        assert not self._f32_dots_all_highest(str(jx))


class TestPallasPoolWiring:
    def test_fallbacks_stay_on_xla_path(self, rng):
        """f32 input and quantize mode run the XLA pool variants."""
        cfg_on = dataclasses.replace(CFG, mip_level=2, quantize_mips=True)
        frame = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
        h, g, _ = vision.frame_stats(frame, cfg_on)
        assert np.all(np.isfinite(np.asarray(g)))
        cfg_on2 = dataclasses.replace(CFG, mip_level=2)
        h2, g2, _ = vision.frame_stats(frame.astype(np.float32) / 255.0,
                                       cfg_on2)
        assert np.all(np.isfinite(np.asarray(g2)))

    def test_cpu_defaults_to_xla_path(self, rng):
        """frame_stats traces no pallas_call (default config): the pool
        is plain XLA on every backend."""
        import jax
        frame = jnp.zeros((64, 64, 3), jnp.uint8)
        jx = str(jax.make_jaxpr(
            lambda f: vision.frame_stats(
                f, dataclasses.replace(CFG, mip_level=2)))(frame))
        assert "pallas_call" not in jx


class TestPoolOracle:
    """The XLA integer pool (the only pool) against a float64 box mean,
    at the shapes the removed fused-pool kernel was checked at — 1080p,
    4K, odd and small planes."""

    @pytest.mark.parametrize("shape,level", [
        ((1080, 1920), 3), ((256, 256), 3), ((64, 64), 2), ((135, 240), 1),
        ((2160, 3840), 3),
    ])
    def test_u8_matches_f64_box_mean(self, rng, shape, level):
        from vaudio.vision.features import mip_downsample_planes
        h, w = shape
        planes = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
        got = np.asarray(mip_downsample_planes(
            jnp.asarray(planes), level, scale=1 / 255.0))
        k = 1 << level
        ho, wo = h >> level, w >> level
        want = planes[:, :ho * k, :wo * k].astype(np.float64).reshape(
            3, ho, k, wo, k).mean(axis=(2, 4)) / 255.0
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestTiledHistogramIdentity:
    @pytest.mark.parametrize("shape", [(16, 16), (135, 240), (34, 48)])
    def test_tiled_matches_scatter(self, rng, shape):
        """The tiled int8-contraction histogram and the plain scatter-add
        give the same integer counts, including ragged cells."""
        cfg = CFG
        h, s, i = (jnp.asarray(rng.uniform(0, 1, shape).astype(np.float32))
                   for _ in range(3))
        tiled = np.asarray(vision.features.hue_histogram_planes(
            h, s, i, cfg, method="tiled"))
        scatter = np.asarray(vision.features.hue_histogram_planes(
            h, s, i, cfg, method="scatter"))
        np.testing.assert_array_equal(tiled, scatter)
        assert tiled.sum() > 0

    @pytest.mark.parametrize("shape", [(135, 240), (33, 60), (8, 8),
                                       (3, 5)])
    def test_bit_identical_to_matmul(self, rng, shape):
        """The tiled two-level factorization must produce EXACTLY the
        dense one-hot matmul's integer counts, including ragged cell
        rectangles (135 rows -> 33/34/34/34 bands)."""
        hm, wm = shape
        h = rng.uniform(0, 1, (hm, wm)).astype(np.float32)
        s = rng.uniform(0, 1, (hm, wm)).astype(np.float32)
        i = rng.uniform(0, 1, (hm, wm)).astype(np.float32)
        from vaudio.vision.features import hue_histogram_planes
        a = np.asarray(hue_histogram_planes(h, s, i, CFG, method="tiled"))
        b = np.asarray(hue_histogram_planes(h, s, i, CFG, method="matmul"))
        np.testing.assert_array_equal(a, b)


class TestQuantizeInt8Chain:
    """vision.features._quant_pool_level_u8 / quantize_int8: the
    all-integer 8-bit-quantized mip chain (cfg.quantize_mips_int8)."""

    def _oracle_level(self, m):
        """Rational round-half-even of the 2x2 block mean, in exact
        integer arithmetic (numpy)."""
        c, h, w = m.shape
        s = (m[:, 0::2, 0::2].astype(np.int64)
             + m[:, 1::2, 0::2] + m[:, 0::2, 1::2] + m[:, 1::2, 1::2])
        base, rem = s >> 2, s & 3
        bump = (rem == 3) | ((rem == 2) & ((base & 1) == 1))
        return (base + bump).astype(np.uint8)

    def test_level_matches_integer_oracle(self, rng):
        from vaudio.vision.features import _quant_pool_level_u8
        m = rng.integers(0, 256, (3, 32, 48), np.uint8)
        got = np.asarray(_quant_pool_level_u8(jnp.asarray(m)))
        np.testing.assert_array_equal(got, self._oracle_level(m))

    def test_midpoint_rounds_half_even(self):
        from vaudio.vision.features import _quant_pool_level_u8
        # Block [1,1,0,0] -> mean 0.5 -> even 0; [1,1,1,3] -> 1.5 -> 2.
        m = np.zeros((1, 2, 4), np.uint8)
        m[0, :, 0] = [1, 1]                      # with 0,0 below: sum 2
        m[0, 0, 2], m[0, 1, 2], m[0, 0, 3], m[0, 1, 3] = 1, 1, 1, 3
        got = np.asarray(_quant_pool_level_u8(jnp.asarray(m)))
        assert got[0, 0, 0] == 0                 # 0.5 -> even 0
        assert got[0, 0, 1] == 2                 # 1.5 -> even 2

    def test_chain_within_one_step_of_f32_path(self, rng):
        from vaudio.vision.features import mip_downsample_planes
        planes = rng.integers(0, 256, (3, 64, 64), np.uint8)
        f32 = np.asarray(mip_downsample_planes(
            jnp.asarray(planes), 3, quantize=True, scale=1 / 255.0))
        i8 = np.asarray(mip_downsample_planes(
            jnp.asarray(planes), 3, quantize=True, scale=1 / 255.0,
            quantize_int8=True))
        # Both on the 8-bit grid; paths may differ by the documented
        # <= 1 step per level at exact midpoints.
        np.testing.assert_allclose(i8 * 255, np.round(i8 * 255),
                                   atol=1e-4)
        assert np.abs(i8 - f32).max() <= 3.01 / 255

    def test_config_flag_runs_pipeline(self, rng):
        import dataclasses
        from vaudio.runtime import run_offline
        from vaudio.runtime.step import default_params
        cfg = dataclasses.replace(AuralizerConfig(), quantize_mips=True,
                                  quantize_mips_int8=True)
        frames = rng.integers(0, 256, (3, 64, 64, 3), np.uint8)
        audio, carry, _ = run_offline(frames, cfg,
                                      dict(default_params(cfg)))
        assert np.all(np.isfinite(np.asarray(audio)))
