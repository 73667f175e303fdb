"""Unit tests for vaudio.dsp against independent NumPy/SciPy oracles.

Covers the oracle list from SURVEY.md §4: Hann-sinc window transform,
mirror+irfft round-trip, sigmoid AGC, nearest-bin snap, hash phases.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

import oracles
from vaudio import dsp
from vaudio.config import AuralizerConfig


CFG = AuralizerConfig()


class TestHannWindow:
    def test_unit_rms(self):
        w = dsp.hann_window_norm(4096)
        assert w.dtype == np.float32
        assert np.isclose(np.sqrt(np.mean(w.astype(np.float64) ** 2)), 1.0,
                          atol=1e-6)

    def test_formula(self):
        n = 16
        w = dsp.hann_window_norm(n)
        k = np.arange(n)
        expect = np.sqrt(2 / 3) * (1 - np.cos(2 * np.pi * k / n))
        np.testing.assert_allclose(w, expect, rtol=1e-6)

    def test_cola_at_half_hop(self):
        # Hann at 50% hop satisfies COLA up to a constant.
        w = dsp.hann_window_norm(4096).astype(np.float64)
        s = w[:2048] + w[2048:]
        np.testing.assert_allclose(s, s[0], rtol=1e-6)


class TestSinc:
    def test_matches_numpy(self, rng):
        x = rng.uniform(-20, 20, 1024).astype(np.float32)
        got = np.asarray(dsp.sinc(x))
        np.testing.assert_allclose(got, np.sinc(x), atol=2e-6)

    def test_zero(self):
        assert float(dsp.sinc(0.0)) == 1.0

    def test_hann_sinc_peak_shape(self):
        # W(0) = 0.5 - 0.25*(sinc(-1)+sinc(1)) = 0.5; zero at integer d >= 2
        assert np.isclose(float(dsp.hann_sinc_peak(0.0)), 0.5)
        assert np.isclose(float(dsp.hann_sinc_peak(1.0)), -0.25)
        for d in (2.0, 3.0, 5.0):
            assert abs(float(dsp.hann_sinc_peak(d))) < 1e-6
        # Even symmetry
        d = np.linspace(-6, 6, 101).astype(np.float32)
        W = np.asarray(dsp.hann_sinc_peak(d))
        np.testing.assert_allclose(W, W[::-1], atol=1e-6)


class TestHashPhase:
    def test_fract_sin_hash(self, rng):
        # The hash multiplies sin(x) by 43758.5453 before taking fract, so a
        # 1-ulp difference in the platform's f32 sin shifts the phase by up
        # to ~0.03 rad (and can wrap).  Compare on the circle with that
        # tolerance — the same caveat applies vs the Metal reference, where
        # these phases are decorrelated pseudo-randomness, not signal.
        x = rng.uniform(0, 400, 512).astype(np.float32)
        got = np.asarray(dsp.hash_phase(x))
        s = np.sin(x.astype(np.float64)) * 43758.5453
        expect = (s - np.floor(s)) * 2 * np.pi
        d = np.abs(got - expect)
        circ = np.minimum(d, 2 * np.pi - d)
        assert np.percentile(circ, 99) < 0.1
        assert np.all(got >= 0) and np.all(got <= 2 * np.pi)


class TestHueToF0:
    def test_endpoints(self):
        assert np.isclose(float(dsp.hue_to_f0(0)), 220.0)
        assert np.isclose(float(dsp.hue_to_f0(360)), 1760.0)
        assert np.isclose(float(dsp.hue_to_f0(120)), 220.0 * 2.0)


class TestFindClosestIndex:
    def setup_method(self):
        self.freqs = CFG.bin_frequencies()

    def _oracle(self, target):
        # Independent oracle: literal binary-search semantics of
        # HelperFunctions.swift:233-261.
        freqs = self.freqs
        lo, hi = 0, len(freqs) - 1
        while lo <= hi:
            mid = lo + (hi - lo) // 2
            if freqs[mid] < target:
                lo = mid + 1
            elif freqs[mid] > target:
                hi = mid - 1
            else:
                return mid
        if lo >= len(freqs):
            return len(freqs) - 1
        if lo <= 0:
            return 0
        return lo if abs(freqs[lo] - target) < abs(freqs[lo - 1] - target) \
            else lo - 1

    def test_against_oracle(self, rng):
        targets = np.concatenate([
            rng.uniform(0, 25000, 500).astype(np.float32),
            self.freqs[:20],                 # exact hits
            np.array([0.0, 1e9], np.float32),  # out of range both sides
        ])
        got = np.asarray(dsp.find_closest_index(self.freqs, targets))
        expect = np.array([self._oracle(t) for t in targets])
        np.testing.assert_array_equal(got, expect)

    def test_f0_range_snap(self):
        # All possible hue f0s land inside the grid.
        hues = np.arange(361, dtype=np.float32)
        f0 = np.asarray(dsp.hue_to_f0(hues))
        idx = np.asarray(dsp.find_closest_index(self.freqs, f0))
        snapped = self.freqs[idx]
        assert np.all(np.abs(snapped - f0) <= CFG.bin_width)


class TestMirrorIrfft:
    def test_mirror_layout(self, rng):
        F = 7
        re = rng.normal(size=F).astype(np.float32)
        im = rng.normal(size=F).astype(np.float32)
        full = np.asarray(dsp.mirror_and_conjugate(re, im))
        assert full.shape == (2 * (F + 1),)
        assert full[0] == 0 and full[F + 1] == 0
        np.testing.assert_allclose(full[1:F + 1].real, re)
        np.testing.assert_allclose(full[1:F + 1].imag, im)
        # Hermitian symmetry
        for k in range(F):
            assert full[2 * (F + 1) - (k + 1)] == np.conj(full[k + 1])

    def test_irfft_matches_full_complex_ifft(self, rng):
        F = CFG.num_bins
        re = rng.normal(size=F).astype(np.float32)
        im = rng.normal(size=F).astype(np.float32)
        sig = np.asarray(dsp.irfft_from_half(re, im))
        assert sig.shape == (CFG.nfft,)
        # Oracle: reference path — mirror to full spectrum, complex ifft,
        # real part (numpy ifft already includes the 1/N factor vDSP's
        # FFT_INVERSE requires manually).
        full = np.asarray(dsp.mirror_and_conjugate(re, im)).astype(np.complex128)
        oracle = np.fft.ifft(full).real
        np.testing.assert_allclose(sig, oracle, atol=1e-4)

    def test_irfft_dense_matches_fft_path(self, rng):
        """The dense IDFT (cfg.use_matmul_irfft) against the FFT path and
        an f64 oracle, at production size and batched stereo shapes."""
        F = CFG.num_bins
        re = rng.normal(size=(3, 2, F)).astype(np.float32) * 0.02
        im = rng.normal(size=(3, 2, F)).astype(np.float32) * 0.02
        dense = np.asarray(dsp.irfft_from_half_dense(re, im))
        assert dense.shape == (3, 2, CFG.nfft)
        full = np.zeros((3, 2, CFG.nfft // 2 + 1), np.complex128)
        full[..., 1:F + 1] = re.astype(np.float64) \
            + 1j * im.astype(np.float64)
        oracle = np.fft.irfft(full, n=CFG.nfft, axis=-1)
        scale = np.abs(oracle).max()
        # Exact-f32 dense IDFT: ~3e-7 of peak on the CPU; 2e-6 leaves
        # room for another backend's summation order.
        assert np.abs(dense - oracle).max() / scale < 2e-6
        fft = np.asarray(dsp.irfft_from_half(re[0, 0], im[0, 0]))
        np.testing.assert_allclose(dense[0, 0], fft,
                                   atol=2e-6 * scale)

    def test_single_bin_is_windowless_cosine(self):
        # A single real bin k produces cos(2*pi*(k+1)*n/NFFT) * 2/NFFT.
        F, k = 63, 5
        re = np.zeros(F, np.float32)
        re[k] = 1.0
        sig = np.asarray(dsp.irfft_from_half(re, np.zeros(F, np.float32)))
        nfft = 2 * (F + 1)
        n = np.arange(nfft)
        expect = 2.0 / nfft * np.cos(2 * np.pi * (k + 1) * n / nfft)
        np.testing.assert_allclose(sig, expect, atol=1e-6)


class TestSigmoidNormalize:
    def _oracle(self, x, M, k=2.0):
        scaled = x / M
        g = 1 / (1 + np.exp(-k * (scaled - 0.5)))
        g0 = 1 / (1 + np.exp(k * 0.5))
        g1 = 1 / (1 + np.exp(-k * 0.5))
        return (g - g0) / (g1 - g0)

    def test_against_oracle(self, rng):
        x = rng.uniform(0, 2, 64).astype(np.float32)
        M = rng.uniform(0.5, 2, 64).astype(np.float32)
        got = np.asarray(dsp.sigmoid_normalize(x, M))
        np.testing.assert_allclose(got, self._oracle(x, M), atol=1e-5)

    def test_endpoints(self):
        assert np.isclose(float(dsp.sigmoid_normalize(0.0, 1.0)), 0.0,
                          atol=1e-6)
        assert np.isclose(float(dsp.sigmoid_normalize(1.0, 1.0)), 1.0,
                          atol=1e-6)


class TestAGC:
    def test_peak_tracks_up_with_attack_one(self, rng):
        sig = rng.normal(size=4096).astype(np.float32)
        out, new_max = dsp.agc_normalize(sig, jnp.float32(0.5),
                                         jnp.float32(1.0), jnp.float32(1.0))
        peak = np.abs(sig).max() + 1e-9
        assert np.isclose(float(new_max), peak, rtol=1e-6)
        # With running_max == framePeak, sigmoid(1) -> 1, so output peak == 1
        assert np.isclose(np.abs(np.asarray(out)).max(), 1.0, rtol=1e-5)

    def test_release_smoothing(self):
        sig = np.ones(16, np.float32) * 0.1
        _, new_max = dsp.agc_normalize(sig, jnp.float32(1.0),
                                       jnp.float32(1.0), jnp.float32(0.25))
        # frame_peak 0.1 < running_max 1.0 -> release EMA
        assert np.isclose(float(new_max), 0.25 * 0.1 + 0.75 * 1.0, rtol=1e-5)

    def test_zero_signal_safe(self):
        sig = np.zeros(64, np.float32)
        out, _ = dsp.agc_normalize(sig, jnp.float32(1.0), jnp.float32(1.0),
                                   jnp.float32(1.0))
        assert np.all(np.isfinite(np.asarray(out)))


class TestOverlapAdd:
    def test_reference_semantics(self, rng):
        nfft = 4096
        w = jnp.asarray(dsp.hann_window_norm(nfft))
        sig = rng.normal(size=nfft).astype(np.float32)
        tail = rng.normal(size=nfft).astype(np.float32)
        out, new_tail = dsp.overlap_add(jnp.asarray(sig), jnp.asarray(tail), w)
        # Oracle per SoundEngine.swift:231-254
        gain = 1.0 / (np.abs(sig).max() + 1e-6)
        windowed = sig * gain * np.asarray(w)
        np.testing.assert_allclose(np.asarray(new_tail), windowed, atol=1e-5)
        np.testing.assert_allclose(np.asarray(out),
                                   tail[2048:] + windowed[:2048], atol=1e-5)

    def test_stream_reconstruction_is_bounded(self, rng):
        # Feeding identical frames, output settles to a periodic signal with
        # peak <= window peak (sanity property, not exactness).
        nfft = 4096
        w = jnp.asarray(dsp.hann_window_norm(nfft))
        sig = jnp.asarray(rng.normal(size=nfft).astype(np.float32))
        tail = jnp.zeros(nfft, jnp.float32)
        for _ in range(4):
            out, tail = dsp.overlap_add(sig, tail, w)
        assert float(jnp.max(jnp.abs(out))) < 2 * float(jnp.max(w))


class TestLinearToLog2:
    def test_anchor_points(self):
        assert np.isclose(float(dsp.linear_to_log2(20.0)), 400.0, atol=1e-3)
        assert np.isclose(float(dsp.linear_to_log2(20000.0)), 790.0,
                          atol=1e-3)


class TestConfig:
    def test_derived_constants_match_reference(self):
        # SoundEngine.swift:129-144
        assert CFG.n == 4094
        assert CFG.num_bins == 2047
        assert CFG.hop_size == 2048
        assert np.isclose(CFG.bin_width, 44100.0 / 4094.0)
        f = CFG.bin_frequencies()
        assert f.shape == (2047,)
        assert np.isclose(f[0], 44100.0 / 2047.0, rtol=1e-6)
        assert np.isclose(f[-1], 22050.0 + 44100.0 / 2047.0, rtol=1e-6)

    def test_phase_strides(self):
        assert CFG.phase_stride == 32
        assert CFG.phase_read_stride == 22
        import dataclasses
        clean = dataclasses.replace(CFG, quirk_compat=False)
        assert clean.phase_read_stride == 32


class TestPeakPolyAccuracy:
    def test_against_f64_closed_form_near_poles(self, rng):
        """The transcendental-free peak must stay within 3e-7 of the f64
        closed form everywhere the synthesis evaluates it — including the
        rational factor's poles (d in {0, +-1}) and the far tail."""
        d = np.concatenate([
            rng.uniform(-2050, 2050, 200_000),
            rng.uniform(-2, 2, 200_000),
            1.0 + rng.uniform(-1e-3, 1e-3, 50_000),
            -1.0 + rng.uniform(-1e-3, 1e-3, 50_000),
            rng.uniform(-1e-3, 1e-3, 50_000),
        ]).astype(np.float32)
        got = np.asarray(dsp.hann_sinc_peak_fast(jnp.asarray(d)))
        dd = d.astype(np.float64)
        def s64(x):
            return np.where(x == 0, 1.0,
                            np.sin(np.pi * x) / np.where(x == 0, 1,
                                                         np.pi * x))
        ref = 0.5 * s64(dd) - 0.25 * (s64(dd - 1) + s64(dd + 1))
        np.testing.assert_allclose(got, ref, atol=3e-7)

    def test_sinpi_reduced(self):
        x = np.linspace(-0.5, 0.5, 200_001).astype(np.float32)
        got = np.asarray(dsp.sinpi_reduced(jnp.asarray(x)))
        ref = np.sin(np.pi * x.astype(np.float64))
        np.testing.assert_allclose(got, ref, atol=3e-7)


class TestFastPeakFormula:
    """dsp.hann_sinc_peak_fast, the peak evaluation the contraction uses,
    against the three-sinc closed form."""

    def test_matches_three_sinc_form(self, rng):
        d = np.concatenate([
            rng.uniform(-50, 50, 2048),
            np.array([0.0, 1.0, -1.0, 2.0, -2.0, 0.5, 1e-7, 1 + 1e-7]),
        ]).astype(np.float32)
        fast = np.asarray(dsp.hann_sinc_peak_fast(jnp.asarray(d)))
        ref = np.asarray(dsp.hann_sinc_peak(d))
        np.testing.assert_allclose(fast, ref, atol=3e-6)

    def test_exact_special_points(self):
        d = jnp.asarray([0.0, 1.0, -1.0], jnp.float32)
        np.testing.assert_allclose(np.asarray(dsp.hann_sinc_peak_fast(d)),
                                   [0.5, -0.25, -0.25], atol=1e-7)


class TestAgcOlaOracle:
    """The XLA audio tail (runtime.step.synth_audio: agc_normalize then
    overlap_add) against the scalar transcription of
    SoundEngine.swift:403-428 in tests/oracles.py."""

    @staticmethod
    def run_tail(spec, tail, rmax, att, rel):
        """spec: f32[F, 2] mono or f32[ch, F, 2] half spectrum."""
        from vaudio.runtime.step import synth_audio
        ch = 1 if spec.ndim == 2 else spec.shape[0]
        cfg = dataclasses.replace(CFG, channels=ch)
        w = jnp.asarray(dsp.hann_window_norm(cfg.nfft))
        halves = spec[None] if ch == 1 else spec
        frame = np.stack([np.asarray(dsp.irfft_from_half(
            jnp.asarray(h[:, 0]), jnp.asarray(h[:, 1]))) for h in halves])
        params = {"attack": np.float32(att), "release": np.float32(rel)}
        pcm, new_tail, new_max = synth_audio(
            jnp.asarray(spec), jnp.asarray(tail), jnp.float32(rmax), params,
            cfg, w)
        want = oracles.agc_ola_np(frame[0] if ch == 1 else frame, tail,
                                  rmax, att, rel, np.asarray(w, np.float64))
        return (np.asarray(pcm), np.asarray(new_tail), float(new_max)), want

    @staticmethod
    def half_spectrum(rng, *lead):
        return rng.normal(0, 0.02, lead + (CFG.num_bins, 2)).astype(
            np.float32)

    @pytest.mark.parametrize("rmax,att,rel", [(1.0, 1.0, 1.0),
                                              (0.3, 0.5, 0.2),
                                              (20.0, 0.0, 0.25)])
    def test_mono(self, rng, rmax, att, rel):
        tail = rng.normal(size=CFG.nfft).astype(np.float32) * 0.1
        (pcm, new_tail, nm), (o_pcm, o_tail, o_max) = self.run_tail(
            self.half_spectrum(rng), tail, rmax, att, rel)
        np.testing.assert_allclose(nm, o_max, rtol=1e-5)
        np.testing.assert_allclose(pcm, o_pcm, atol=1e-5)
        np.testing.assert_allclose(new_tail, o_tail, atol=1e-5)

    def test_stereo_shares_gain(self, rng):
        nfft = CFG.nfft
        spec = self.half_spectrum(rng, 2)
        spec[1] *= 0.25                       # quieter right channel
        tail = rng.normal(size=(2, nfft)).astype(np.float32) * 0.1
        (pcm, new_tail, nm), (o_pcm, o_tail, o_max) = self.run_tail(
            spec, tail, 1.0, 1.0, 1.0)
        assert pcm.shape == (nfft // 2, 2)     # interleaved (hop, ch)
        np.testing.assert_allclose(pcm, o_pcm.T, atol=1e-5)
        np.testing.assert_allclose(new_tail, o_tail, atol=1e-5)
        np.testing.assert_allclose(nm, o_max, rtol=1e-5)

    def test_zero_signal(self):
        z = np.zeros(CFG.nfft, np.float32)
        (pcm, new_tail, nm), (o_pcm, o_tail, o_max) = self.run_tail(
            np.zeros((CFG.num_bins, 2), np.float32), z, 1.0, 1.0, 1.0)
        assert np.all(np.isfinite(pcm))
        np.testing.assert_allclose(pcm, o_pcm, atol=1e-7)
        np.testing.assert_allclose(nm, o_max, rtol=1e-6)
