"""Stereo-extension tests (cfg.channels == 2; cells panned by grid column).

The reference is mono (SoundEngine.swift:165); stereo is this framework's
extension toward the BASELINE north star ("48 kHz stereo").  The invariant:
the L+R mid signal follows the same synthesis as mono, and cells on the
left grid column render hard-left.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from vaudio.config import AuralizerConfig, LiveParams
from vaudio.runtime import init_carry, make_step, run_offline
from vaudio.synth import SynthConstants, build_spectrum
from vaudio.synth.spectrum import cell_pan_gains


CFG = AuralizerConfig()
STEREO = dataclasses.replace(CFG, channels=2)
PARAMS = LiveParams().as_arrays()


class TestPanLaw:
    def test_equal_power(self):
        pan = cell_pan_gains(STEREO)
        assert pan.shape == (16, 2)
        np.testing.assert_allclose(pan[:, 0] ** 2 + pan[:, 1] ** 2, 1.0,
                                   atol=1e-6)
        # Column 0 hard left, column 3 hard right.
        assert pan[0, 0] == 1.0 and abs(pan[0, 1]) < 1e-7
        assert abs(pan[3, 0]) < 1e-7 and pan[3, 1] == 1.0
        # Same column -> same pan.
        np.testing.assert_allclose(pan[0], pan[4])


class TestLiveStereoWidth:
    def test_width_gains(self):
        import jax.numpy as jnp

        from vaudio.synth import cell_pan_gains, live_pan_gains
        cfg = AuralizerConfig(channels=2)
        # width 1 == the static column pan law.
        g1 = np.asarray(live_pan_gains(cfg, jnp.float32(1.0)))
        np.testing.assert_allclose(g1, cell_pan_gains(cfg), atol=1e-6)
        # width 0 == dead center, equal power.
        g0 = np.asarray(live_pan_gains(cfg, jnp.float32(0.0)))
        np.testing.assert_allclose(g0, np.sqrt(0.5), atol=1e-6)
        # width > 1 clips to hard L/R at the edges.
        g2 = np.asarray(live_pan_gains(cfg, jnp.float32(3.0)))
        np.testing.assert_allclose(g2[0], [1.0, 0.0], atol=1e-6)

    def test_width_zero_collapses_image(self, rng):
        """An off-center hue field must produce L == R at width 0 and
        L != R at width 1 — same compiled step, different traced param."""
        from vaudio.config import LiveParams
        from vaudio.runtime import run_offline
        frame = np.zeros((64, 64, 3), np.float32)
        frame[:, 48:] = [1.0, 0.1, 0.1]
        frames = np.broadcast_to(frame, (4, 64, 64, 3))
        cfg = AuralizerConfig(channels=2)
        a_w1, _, _ = run_offline(
            frames, cfg, LiveParams(stereo_width=1.0).as_arrays())
        a_w0, _, _ = run_offline(
            frames, cfg, LiveParams(stereo_width=0.0).as_arrays())
        a_w1, a_w0 = np.asarray(a_w1), np.asarray(a_w0)
        np.testing.assert_allclose(a_w0[:, 0], a_w0[:, 1], atol=1e-6)
        assert np.abs(a_w1[:, 0] - a_w1[:, 1]).max() > 1e-3

    def test_width_through_chunked(self, rng):
        from vaudio.config import LiveParams
        from vaudio.runtime import run_offline_batched
        frames = rng.uniform(0, 1, (8, 64, 64, 3)).astype(np.float32)
        cfg = AuralizerConfig(channels=2)
        p = LiveParams(stereo_width=0.0).as_arrays()
        audio, _, _ = run_offline_batched(frames, cfg, p)
        audio = np.asarray(audio)
        np.testing.assert_allclose(audio[:, 0], audio[:, 1], atol=1e-6)


class TestLivePanAngles:
    """Per-cell pan-angle live control (LiveParams.pan_angles): a traced
    (num_cells,) angle vector replacing the static column pan law."""

    def test_angle_override_gains(self):
        from vaudio.synth import live_pan_gains
        cfg = AuralizerConfig(channels=2)
        # All cells hard left.
        g = np.asarray(live_pan_gains(
            cfg, jnp.float32(1.0), angles=np.zeros(16, np.float32)))
        np.testing.assert_allclose(g[:, 0], 1.0, atol=1e-6)
        np.testing.assert_allclose(g[:, 1], 0.0, atol=1e-7)
        # Width 0 collapses any override back to center.
        g0 = np.asarray(live_pan_gains(
            cfg, jnp.float32(0.0), angles=np.zeros(16, np.float32)))
        np.testing.assert_allclose(g0, np.sqrt(0.5), atol=1e-6)

    def test_as_arrays_includes_angles(self):
        p = LiveParams(pan_angles=np.zeros(16))
        arrs = p.as_arrays()
        assert arrs["pan_angles"].shape == (16,)
        assert arrs["pan_angles"].dtype == np.float32
        assert "pan_angles" not in LiveParams().as_arrays()

    def test_hard_left_override_end_to_end(self, rng):
        frames = rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
        cfg = AuralizerConfig(channels=2)
        p = LiveParams(pan_angles=np.zeros(16, np.float32)).as_arrays()
        audio, _, _ = run_offline(frames, cfg, p)
        audio = np.asarray(audio)
        assert np.abs(audio[:, 0]).max() > 1e-4       # left has signal
        np.testing.assert_allclose(audio[:, 1], 0.0, atol=1e-7)

    def test_override_through_chunked_matches_scan(self, rng):
        from vaudio.runtime import run_offline_batched
        frames = rng.uniform(0, 1, (6, 64, 64, 3)).astype(np.float32)
        # Serial phases: this test asserts strict pan-override
        # equivalence between the runtimes, which the prefix-sum phase
        # default trades away (documented band — docs/PARITY.md;
        # default-config band test: test_chunked.py).
        cfg = AuralizerConfig(channels=2, use_cumsum_phases=False)
        angles = rng.uniform(0, np.pi / 2, 16).astype(np.float32)
        p = LiveParams(pan_angles=angles).as_arrays()
        a_scan, _, _ = run_offline(frames, cfg, p)
        a_chunk, _, _ = run_offline_batched(frames, cfg, p, chunk=4)
        np.testing.assert_allclose(np.asarray(a_scan),
                                   np.asarray(a_chunk), atol=2e-5)


class TestStereoSpectrum:
    def make_state(self, rng, cfg):
        hues = rng.integers(0, 361, 16).astype(np.int32)
        grads = np.abs(rng.normal(0, 0.3, (16, 4))).astype(np.float32)
        phases = rng.uniform(0, 2 * np.pi, (16, 32)).astype(np.float32)
        return hues, grads, phases

    def test_mid_matches_mono(self, rng):
        consts = SynthConstants.create(CFG)
        hues, grads, phases = self.make_state(rng, CFG)
        prev_m = np.zeros((CFG.num_bins, 2), np.float32)
        prev_s = np.zeros((2, CFG.num_bins, 2), np.float32)
        mono = np.asarray(build_spectrum(
            jnp.asarray(hues), jnp.asarray(grads), jnp.asarray(phases),
            jnp.asarray(prev_m), jnp.float32(0.0), CFG, consts))
        st = np.asarray(build_spectrum(
            jnp.asarray(hues), jnp.asarray(grads), jnp.asarray(phases),
            jnp.asarray(prev_s), jnp.float32(0.0), STEREO, consts))
        assert st.shape == (2, CFG.num_bins, 2)
        # Equal-power pan: per cell gL+gR != 1 in general, so L+R != mono
        # exactly — but a single-column scene collapses to pure gains.
        # Check instead: total energy is preserved within pan bounds.
        e_mono = np.sum(mono ** 2)
        e_st = np.sum(st ** 2)
        assert 0.5 * e_mono <= e_st <= 2.2 * e_mono

    def test_left_column_cell_is_hard_left(self):
        consts = SynthConstants.create(STEREO)
        hues = np.full(16, -1, np.int32)
        hues[0] = 100          # cell 0 = grid column 0 -> hard left
        grads = np.zeros((16, 4), np.float32)
        grads[0] = [0, 1, 1, 0]
        phases = np.zeros((16, 32), np.float32)
        prev = np.zeros((2, STEREO.num_bins, 2), np.float32)
        st = np.asarray(build_spectrum(
            jnp.asarray(hues), jnp.asarray(grads), jnp.asarray(phases),
            jnp.asarray(prev), jnp.float32(0.0), STEREO, consts))
        assert np.abs(st[0]).max() > 1e-4       # left has signal
        np.testing.assert_allclose(st[1], 0.0, atol=1e-7)  # right silent


class TestStereoEndToEnd:
    def test_offline_shapes(self, rng):
        frames = rng.uniform(0, 1, (3, 128, 128, 3)).astype(np.float32)
        audio, carry, _ = run_offline(frames, STEREO, PARAMS)
        assert np.asarray(audio).shape == (3 * 2048, 2)
        assert carry.prev_spectrum.shape == (2, 2047, 2)
        assert np.all(np.isfinite(np.asarray(audio)))

    def test_wav_roundtrip(self, tmp_path, rng):
        from vaudio.api import Auralizer
        from vaudio.io import read_wav, solid_color_frames
        aur = Auralizer(config=STEREO)
        frames = solid_color_frames([1, 0.1, 0.1], 128, 128, 3)
        path = str(tmp_path / "st.wav")
        aur.sonify_to_wav(frames, path)
        back, sr = read_wav(path)
        assert back.shape == (3 * 2048, 2)

    def test_streaming_stereo(self):
        from vaudio.api import Auralizer
        from vaudio.io import solid_color_frames
        aur = Auralizer(config=STEREO)
        frames = solid_color_frames([0.1, 1, 0.1], 128, 128, 5)
        aur.run_until_exhausted(frames)
        pcm = aur.pull(1024)   # interleaved stereo samples
        assert pcm.shape == (1024,)
        aur.stop()
