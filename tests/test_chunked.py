"""Chunk-batched pipeline equivalence: run_offline_batched must produce
the same audio and carry as the per-frame scan path (runtime.step), for
every flag that changes the math."""

import numpy as np
import pytest

import jax.numpy as jnp

from vaudio.config import AuralizerConfig, LiveParams
from vaudio.runtime import init_carry, run_offline, run_offline_batched

PARAMS = LiveParams().as_arrays()


def clip(rng, t=9, size=64):
    return rng.uniform(0, 1, (t, size, size, 3)).astype(np.float32)


def assert_equivalent(frames, cfg, params=PARAMS, chunk=4, atol=2e-5):
    """Strict chunked-vs-scan equivalence.

    Pins use_cumsum_phases=False: the serial phase path is the surface
    that carries the bit-for-near guarantee (the round-5 default is the
    prefix-sum path, whose documented ~ulp/frame random walk vs the
    scan path has its own band test below — test_default_config_cumsum_band).
    """
    import dataclasses
    cfg = dataclasses.replace(cfg, use_cumsum_phases=False)
    a_ref, c_ref, d_ref = run_offline(frames, cfg, dict(params),
                                      debug=True)
    a_new, c_new, d_new = run_offline_batched(frames, cfg, dict(params),
                                              chunk=chunk, debug=True)
    np.testing.assert_allclose(np.asarray(a_new), np.asarray(a_ref),
                               atol=atol)
    np.testing.assert_array_equal(np.asarray(c_new.hues),
                                  np.asarray(c_ref.hues))
    np.testing.assert_allclose(np.asarray(c_new.phases),
                               np.asarray(c_ref.phases), atol=1e-6)
    np.testing.assert_allclose(np.asarray(c_new.prev_spectrum),
                               np.asarray(c_ref.prev_spectrum), atol=atol)
    np.testing.assert_allclose(np.asarray(c_new.ola_tail),
                               np.asarray(c_ref.ola_tail), atol=atol)
    np.testing.assert_allclose(np.asarray(d_new["spectrum"]),
                               np.asarray(d_ref["spectrum"]), atol=atol)


class TestChunkedEquivalence:
    def test_default_config(self, rng):
        assert_equivalent(clip(rng), AuralizerConfig())

    def test_uneven_chunks(self, rng):
        # 9 frames / chunk 4 -> pieces of 4, 4, 1 (remainder recompiles).
        assert_equivalent(clip(rng, t=9), AuralizerConfig(), chunk=4)

    def test_single_chunk_covers_all(self, rng):
        assert_equivalent(clip(rng, t=6), AuralizerConfig(), chunk=32)

    def test_stereo(self, rng):
        assert_equivalent(clip(rng), AuralizerConfig(channels=2))

    def test_filters(self, rng):
        params = LiveParams(hp_cutoff=500.0, hp_order=2.0,
                            lp_cutoff=5000.0, lp_order=1.0).as_arrays()
        assert_equivalent(clip(rng), AuralizerConfig(enable_filters=True),
                          params=params)

    def test_clean_mode(self, rng):
        assert_equivalent(clip(rng), AuralizerConfig(quirk_compat=False))

    def test_matmul_irfft(self, rng):
        """cfg.use_matmul_irfft: the dense-matmul IDFT through BOTH runtimes
        (scan uses it in synth_audio, chunked in pass C2) stays
        equivalent, mono and stereo."""
        assert_equivalent(clip(rng), AuralizerConfig(use_matmul_irfft=True))
        assert_equivalent(clip(rng), AuralizerConfig(use_matmul_irfft=True,
                                                     channels=2))

    def test_matmul_irfft_matches_fft_path(self, rng):
        """Audio from the dense-IDFT config matches the FFT config."""
        frames = clip(rng)
        for ch in (1, 2):
            a_fft, _, _ = run_offline_batched(
                frames, AuralizerConfig(channels=ch), dict(PARAMS), chunk=4)
            a_mm, _, _ = run_offline_batched(
                frames, AuralizerConfig(channels=ch, use_matmul_irfft=True),
                dict(PARAMS), chunk=4)
            np.testing.assert_allclose(np.asarray(a_mm), np.asarray(a_fft),
                                       atol=3e-5)

    def test_matmul_ema(self, rng):
        """cfg.use_matmul_ema: pass C1's closed-form triangular-matmul
        EMA stays equivalent to the serial scan (reassociated f32
        accumulation — the 2e-5 default tolerance covers it), mono and
        stereo, including the carry.prev_spectrum chunk handoff."""
        assert_equivalent(clip(rng), AuralizerConfig(use_matmul_ema=True))
        assert_equivalent(clip(rng), AuralizerConfig(use_matmul_ema=True,
                                                     channels=2))

    def test_matmul_ema_strong_mixing(self, rng):
        """High spectrum_mixing exercises the m^t power chain where the
        closed form differs most from sequential fma."""
        params = LiveParams(spectrum_mixing=0.95).as_arrays()
        assert_equivalent(clip(rng, t=12),
                          AuralizerConfig(use_matmul_ema=True),
                          params=params, chunk=12)

    def test_uint8_frames(self, rng):
        frames = rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
        assert_equivalent(frames, AuralizerConfig())

    def test_yuv_dict_frames(self, rng):
        t, h, w = 6, 64, 64
        frames = {
            "y": rng.integers(16, 235, (t, h, w), dtype=np.uint8),
            "u": rng.integers(16, 240, (t, h // 2, w // 2), dtype=np.uint8),
            "v": rng.integers(16, 240, (t, h // 2, w // 2), dtype=np.uint8),
        }
        assert_equivalent(frames, AuralizerConfig())

    def test_carry_threads_across_chunks(self, rng):
        """State crossing chunk boundaries must be identical to an
        unchunked run (the EMA/AGC/OLA carries)."""
        frames = clip(rng, t=12)
        cfg = AuralizerConfig()
        a1, c1, _ = run_offline_batched(frames, cfg, dict(PARAMS), chunk=3)
        a2, c2, _ = run_offline_batched(frames, cfg, dict(PARAMS),
                                        chunk=12)
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a2),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(c1.running_max),
                                   np.asarray(c2.running_max), atol=1e-6)

    def test_cumsum_phases(self, rng):
        """cfg.use_cumsum_phases (the round-5 DEFAULT): the prefix-sum
        phase accumulation matches the serial scan up to the documented
        mod-reduction random walk (~f32 ulp of the raw advance per
        frame — see config.use_cumsum_phases; measured 1.4e-3 rad
        phases / 6e-4 audio abs at T=32), with hues bit-identical (the
        hue scan is untouched)."""
        for t, chunk, ph_tol, au_tol in [(9, 4, 1e-3, 2e-4),
                                         (32, 32, 4e-3, 2e-3)]:
            frames = clip(rng, t=t)
            a_ref, c_ref, _ = run_offline(frames, AuralizerConfig(),
                                          dict(PARAMS))
            a_new, c_new, _ = run_offline_batched(
                frames, AuralizerConfig(use_cumsum_phases=True),
                dict(PARAMS), chunk=chunk)
            np.testing.assert_array_equal(np.asarray(c_new.hues),
                                          np.asarray(c_ref.hues))
            pd = np.abs(np.asarray(c_new.phases) - np.asarray(c_ref.phases))
            pd = np.minimum(pd, 2 * np.pi - pd)        # phases live mod 2pi
            assert pd.max() < ph_tol, pd.max()
            np.testing.assert_allclose(np.asarray(a_new), np.asarray(a_ref),
                                       atol=au_tol)

    def test_cumsum_phases_stereo_carry(self, rng):
        """Stereo + chunk-boundary carry handoff under use_cumsum_phases:
        chunked-vs-chunked at different chunk sizes (same flag both
        sides, so only the boundary handoff is under test)."""
        frames = clip(rng, t=12)
        cfg = AuralizerConfig(channels=2, use_cumsum_phases=True)
        a1, c1, _ = run_offline_batched(frames, cfg, dict(PARAMS), chunk=3)
        a2, c2, _ = run_offline_batched(frames, cfg, dict(PARAMS), chunk=12)
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a2),
                                   atol=2e-4)
        pd = np.abs(np.asarray(c1.phases) - np.asarray(c2.phases))
        pd = np.minimum(pd, 2 * np.pi - pd)
        assert pd.max() < 2e-3, pd.max()

    def test_default_config_cumsum_band(self, rng):
        """A plain AuralizerConfig() through the chunked pipeline (which
        now defaults to the prefix-sum phases) stays within the
        characterized band of the per-frame scan path — the guarantee a
        default-config user actually gets."""
        frames = clip(rng, t=12)
        cfg = AuralizerConfig()
        assert cfg.use_cumsum_phases      # the round-5 default
        a_ref, c_ref, _ = run_offline(frames, cfg, dict(PARAMS))
        a_new, c_new, _ = run_offline_batched(frames, cfg, dict(PARAMS),
                                              chunk=4)
        np.testing.assert_array_equal(np.asarray(c_new.hues),
                                      np.asarray(c_ref.hues))
        pd = np.abs(np.asarray(c_new.phases) - np.asarray(c_ref.phases))
        pd = np.minimum(pd, 2 * np.pi - pd)
        assert pd.max() < 2e-3, pd.max()
        np.testing.assert_allclose(np.asarray(a_new), np.asarray(a_ref),
                                   atol=1e-3)


class TestBlockedPipeline:
    """runtime.chunked.blocked_pipeline: the sequential scan dispatched as
    blocked sub-chunks (one device-side lax.scan of chunk_pipeline
    bodies) must thread carries across block boundaries exactly like a
    host-side loop of chunk_pipeline calls of the same block size."""

    def _run_blocked(self, frames, cfg, block):
        import jax
        from vaudio.dsp import hann_window_norm
        from vaudio.runtime.chunked import blocked_pipeline
        from vaudio.synth import SynthConstants
        consts = SynthConstants.create(cfg)
        window = jnp.asarray(hann_window_norm(cfg.nfft))
        carry, out = jax.jit(
            lambda c, f: blocked_pipeline(c, f, PARAMS, cfg, consts,
                                          window, block=block)
        )(init_carry(cfg), jnp.asarray(frames))
        return out["pcm"], carry

    @pytest.mark.parametrize("channels", [1, 2])
    def test_matches_hostside_chunking(self, rng, channels):
        frames = clip(rng, t=8)
        cfg = AuralizerConfig(channels=channels)
        pcm, carry = self._run_blocked(frames, cfg, block=4)
        a_ref, c_ref, _ = run_offline_batched(frames, cfg, dict(PARAMS),
                                              chunk=4)
        np.testing.assert_allclose(
            np.asarray(pcm).reshape(np.asarray(a_ref).shape),
            np.asarray(a_ref), atol=1e-6)
        np.testing.assert_array_equal(np.asarray(carry.hues),
                                      np.asarray(c_ref.hues))
        np.testing.assert_allclose(np.asarray(carry.running_max),
                                   np.asarray(c_ref.running_max), atol=1e-6)

    def test_within_scan_path_band(self, rng):
        """Against the per-frame scan path: same guarantee band as the
        default-config chunked pipeline (cumsum phases)."""
        frames = clip(rng, t=12)
        cfg = AuralizerConfig()
        pcm, carry = self._run_blocked(frames, cfg, block=4)
        a_ref, c_ref, _ = run_offline(frames, cfg, dict(PARAMS))
        np.testing.assert_array_equal(np.asarray(carry.hues),
                                      np.asarray(c_ref.hues))
        np.testing.assert_allclose(np.asarray(pcm).reshape(-1),
                                   np.asarray(a_ref), atol=1e-3)

    def test_rejects_nonmultiple(self, rng):
        frames = clip(rng, t=6)
        cfg = AuralizerConfig()
        with pytest.raises(ValueError, match="not a multiple"):
            self._run_blocked(frames, cfg, block=4)


class TestRunOfflineBlocked:
    """run_offline(block=N): the blocked-sub-chunk whole-clip dispatch,
    including the non-multiple remainder and per-frame debug outputs."""

    @pytest.mark.parametrize("t", [8, 11])      # exact and remainder
    def test_matches_perframe_scan(self, rng, t):
        frames = clip(rng, t=t)
        cfg = AuralizerConfig()
        a_ref, c_ref, d_ref = run_offline(frames, cfg, dict(PARAMS),
                                          debug=True)
        a_b, c_b, d_b = run_offline(frames, cfg, dict(PARAMS),
                                    debug=True, block=4)
        np.testing.assert_allclose(np.asarray(a_b), np.asarray(a_ref),
                                   atol=1e-3)
        np.testing.assert_array_equal(np.asarray(c_b.hues),
                                      np.asarray(c_ref.hues))
        assert d_b["hues"].shape == d_ref["hues"].shape
        np.testing.assert_array_equal(np.asarray(d_b["hues"]),
                                      np.asarray(d_ref["hues"]))

    def test_block_larger_than_clip_falls_back(self, rng):
        frames = clip(rng, t=3)
        cfg = AuralizerConfig()
        a_ref, _, _ = run_offline(frames, cfg, dict(PARAMS))
        a_b, _, _ = run_offline(frames, cfg, dict(PARAMS), block=8)
        np.testing.assert_allclose(np.asarray(a_b), np.asarray(a_ref),
                                   atol=1e-6)

    def test_block_unroll_exclusive(self, rng):
        with pytest.raises(ValueError, match="mutually exclusive"):
            run_offline(clip(rng, t=4), AuralizerConfig(), dict(PARAMS),
                        block=4, unroll=8)


class TestPhaseLut:
    """cfg.use_phase_lut: the (360, P) advance table gather must be
    BIT-identical to the direct per-frame derivation — same f32 ops per
    hue value (synth.spectrum._phase_advance_table)."""

    def test_table_matches_direct(self):
        import dataclasses
        import jax.numpy as jnp
        from vaudio.synth import SynthConstants
        from vaudio.synth.spectrum import phase_advance
        cfg = AuralizerConfig()
        consts = SynthConstants.create(cfg)
        cfg_lut = dataclasses.replace(cfg, use_phase_lut=True)
        hues = jnp.asarray(np.arange(360) % 360
                           )[:16 * 23:23].astype(jnp.int32)  # spread
        direct = phase_advance(hues, cfg, consts)
        lut = phase_advance(hues, cfg_lut, consts)
        np.testing.assert_array_equal(np.asarray(direct),
                                      np.asarray(lut))

    def test_all_hues_identical(self):
        import dataclasses
        import jax.numpy as jnp
        from vaudio.synth import SynthConstants
        from vaudio.synth.spectrum import phase_advance
        cfg = AuralizerConfig()
        consts = SynthConstants.create(cfg)
        cfg_lut = dataclasses.replace(cfg, use_phase_lut=True)
        for start in range(0, 360, 16):
            hues = jnp.arange(start, start + 16, dtype=jnp.int32) % 360
            np.testing.assert_array_equal(
                np.asarray(phase_advance(hues, cfg, consts)),
                np.asarray(phase_advance(hues, cfg_lut, consts)))

    def test_pipeline_bitident(self, rng):
        """Whole-pipeline audio with the LUT on equals the default
        path exactly (the table is bit-identical per hue)."""
        import dataclasses
        frames = clip(rng, t=6)
        cfg = AuralizerConfig()
        a_ref, c_ref, _ = run_offline_batched(frames, cfg, dict(PARAMS))
        a_lut, c_lut, _ = run_offline_batched(
            frames, dataclasses.replace(cfg, use_phase_lut=True),
            dict(PARAMS))
        np.testing.assert_array_equal(np.asarray(a_lut),
                                      np.asarray(a_ref))
        np.testing.assert_array_equal(np.asarray(c_lut.phases),
                                      np.asarray(c_ref.phases))
