"""Synthesis tests against the literal per-bin/per-partial oracle."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from vaudio.config import AuralizerConfig
from vaudio.synth import SynthConstants, build_spectrum, phase_accumulate

import oracles


CFG = AuralizerConfig()
# A reduced-F config keeps the python oracle fast: F = (258-2)/2 = 128 bins.
SMALL = dataclasses.replace(CFG, nfft=258)


def make_state(rng, cfg):
    hues = rng.integers(0, 361, 16).astype(np.int32)
    grads = np.abs(rng.normal(0, 0.3, (16, 4))).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, (16, 32)).astype(np.float32)
    prev = rng.normal(0, 0.01, (cfg.num_bins, 2)).astype(np.float32)
    return hues, grads, phases, prev


class TestSynthConstants:
    def test_shapes(self):
        c = SynthConstants.create(CFG)
        assert c.freqs.shape == (2047,)
        assert c.seed_phase.shape == (16, 31)
        assert c.read_idx.shape == (16, 31)
        assert c.num_partials == 31

    def test_quirk_read_indices(self):
        c = SynthConstants.create(CFG)
        # SpectrumCompute.metal:135 — harmonics read at cell*22 + (h-1)
        assert c.read_idx[3, 0] == 3 * 22
        assert c.read_idx[3, 12] == 3 * 22 + 12
        # :179 — bessel modes read at cell*22 + b (no +13 offset!)
        assert c.read_idx[3, 13] == 3 * 22
        assert c.read_idx[3, 30] == 3 * 22 + 17

    def test_clean_read_indices(self):
        c = SynthConstants.create(dataclasses.replace(CFG,
                                                      quirk_compat=False))
        assert c.read_idx[3, 0] == 3 * 32
        assert c.read_idx[3, 13] == 3 * 32 + 13

    def test_static_phase_matches_hash(self):
        c = SynthConstants.create(SMALL)
        expect = oracles.hash01(np.arange(SMALL.num_bins) * 12.9898) \
            * 2 * np.pi
        np.testing.assert_allclose(np.arctan2(c.static_sin, c.static_cos),
                                   np.arctan2(np.sin(expect), np.cos(expect)),
                                   atol=1e-5)


class TestPhaseAccumulate:
    def test_against_oracle(self, rng):
        consts = SynthConstants.create(CFG)
        hues, _, phases, _ = make_state(rng, CFG)
        got = np.asarray(phase_accumulate(jnp.asarray(phases),
                                          jnp.asarray(hues), CFG, consts))
        expect = oracles.phase_accumulate_np(
            phases.reshape(-1).astype(np.float64), hues,
            consts.freqs.astype(np.float64), CFG.hop_size, CFG.sample_rate)
        np.testing.assert_allclose(got.reshape(-1), expect, atol=2e-3)
        assert np.all(got >= 0) and np.all(got < 2 * np.pi)

    def test_advance_rate(self):
        # A cell at hue 0 -> f0 snaps to the bin nearest 220 Hz; the first
        # harmonic's phase must advance by 2*pi*f0*hop/fs each frame.
        consts = SynthConstants.create(CFG)
        hues = jnp.zeros(16, jnp.int32)
        phases = jnp.zeros((16, 32), jnp.float32)
        out = np.asarray(phase_accumulate(phases, hues, CFG, consts))
        f0 = consts.freqs[oracles.find_closest_index_np(consts.freqs, 220.0)]
        expect = (2 * np.pi * f0 * 2048 / 44100) % (2 * np.pi)
        assert np.isclose(out[0, 0], expect, atol=1e-3)


class TestBuildSpectrum:
    @pytest.mark.parametrize("cfg", [SMALL], ids=["F128"])
    def test_against_oracle_small(self, rng, cfg):
        consts = SynthConstants.create(cfg)
        hues, grads, phases, prev = make_state(rng, cfg)
        got = np.asarray(build_spectrum(
            jnp.asarray(hues), jnp.asarray(grads), jnp.asarray(phases),
            jnp.asarray(prev), jnp.float32(0.85), cfg, consts))
        expect_c = oracles.compute_spectrum_np(
            hues, grads.astype(np.float64), consts.freqs.astype(np.float64),
            (prev[:, 0] + 1j * prev[:, 1]).astype(np.complex128),
            phases.reshape(-1).astype(np.float64), 0.85, cfg.bin_width)
        np.testing.assert_allclose(got[:, 0], expect_c.real, atol=2e-4)
        np.testing.assert_allclose(got[:, 1], expect_c.imag, atol=2e-4)

    def test_against_oracle_full_size(self, rng):
        consts = SynthConstants.create(CFG)
        hues, grads, phases, prev = make_state(rng, CFG)
        got = np.asarray(build_spectrum(
            jnp.asarray(hues), jnp.asarray(grads), jnp.asarray(phases),
            jnp.asarray(prev), jnp.float32(0.9), CFG, consts))
        expect_c = oracles.compute_spectrum_np(
            hues, grads.astype(np.float64), consts.freqs.astype(np.float64),
            (prev[:, 0] + 1j * prev[:, 1]).astype(np.complex128),
            phases.reshape(-1).astype(np.float64), 0.9, CFG.bin_width)
        np.testing.assert_allclose(got[:, 0], expect_c.real, atol=2e-4)
        np.testing.assert_allclose(got[:, 1], expect_c.imag, atol=2e-4)

    def test_invalid_hue_cell_contributes_nothing(self, rng):
        consts = SynthConstants.create(SMALL)
        hues, grads, phases, prev = make_state(rng, SMALL)
        prev[:] = 0.0
        out_all = np.asarray(build_spectrum(
            jnp.asarray(hues), jnp.asarray(grads), jnp.asarray(phases),
            jnp.asarray(prev), jnp.float32(0.0), SMALL, consts))
        hues2 = hues.copy()
        hues2[5] = -1          # invalid -> skipped (metal :102-103)
        grads2 = grads.copy()
        grads2[5] = 100.0      # would be loud if not skipped
        out_skip = np.asarray(build_spectrum(
            jnp.asarray(hues2), jnp.asarray(grads2), jnp.asarray(phases),
            jnp.asarray(prev), jnp.float32(0.0), SMALL, consts))
        # Removing one of 16 cells changes the sum but must not explode.
        assert np.all(np.isfinite(out_skip))
        diff = np.abs(out_all - out_skip).max()
        assert diff > 0  # the valid version includes cell 5

        hues3 = np.full(16, -1, np.int32)
        out_none = np.asarray(build_spectrum(
            jnp.asarray(hues3), jnp.asarray(grads), jnp.asarray(phases),
            jnp.asarray(prev), jnp.float32(0.0), SMALL, consts))
        np.testing.assert_allclose(out_none, 0.0, atol=1e-7)

    def test_smoothing_fixpoint(self, rng):
        # With mixing=1.0 the output is exactly the previous spectrum.
        consts = SynthConstants.create(SMALL)
        hues, grads, phases, prev = make_state(rng, SMALL)
        out = np.asarray(build_spectrum(
            jnp.asarray(hues), jnp.asarray(grads), jnp.asarray(phases),
            jnp.asarray(prev), jnp.float32(1.0), SMALL, consts))
        np.testing.assert_allclose(out, prev, atol=1e-6)

    def test_peak_at_fundamental(self):
        # One saturated cell at hue 0 (f0 ~ 220 Hz): the magnitude spectrum
        # must peak at the snapped fundamental bin.
        consts = SynthConstants.create(CFG)
        hues = np.full(16, -1, np.int32)
        hues[0] = 0
        grads = np.zeros((16, 4), np.float32)
        grads[0] = [0.0, 1.0, 1.0, 0.0]   # flat tilts, no bessel
        phases = np.zeros((16, 32), np.float32)
        prev = np.zeros((CFG.num_bins, 2), np.float32)
        out = np.asarray(build_spectrum(
            jnp.asarray(hues), jnp.asarray(grads), jnp.asarray(phases),
            jnp.asarray(prev), jnp.float32(0.0), CFG, consts))
        mag = np.hypot(out[:, 0], out[:, 1])
        f0_idx = oracles.find_closest_index_np(consts.freqs, 220.0)
        assert abs(int(np.argmax(mag)) - f0_idx) <= 1
        # Harmonics show up: local peak near 2*f0 as well.
        h2_idx = oracles.find_closest_index_np(consts.freqs,
                                               2 * consts.freqs[f0_idx])
        window = mag[h2_idx - 3:h2_idx + 4]
        assert window.max() > 10 * np.median(mag)


class TestSpectralFilter:
    def test_filter_gain_shape(self):
        from vaudio.synth.spectrum import spectral_filter_gain
        freqs = jnp.asarray(CFG.bin_frequencies())
        g = np.asarray(spectral_filter_gain(
            freqs, jnp.float32(200.0), jnp.float32(18000.0),
            jnp.float32(2.0), jnp.float32(2.0)))
        # Passband untouched, stop bands attenuated monotonically.
        passband = (CFG.bin_frequencies() > 200) & \
            (CFG.bin_frequencies() < 18000)
        np.testing.assert_allclose(g[passband], 1.0)
        low = g[CFG.bin_frequencies() <= 200]
        assert np.all(np.diff(low) >= 0)       # rises toward the cutoff
        high = g[CFG.bin_frequencies() >= 18000]
        assert np.all(np.diff(high) <= 0)      # falls past the cutoff
        assert g[0] < 0.01 and g[-1] < 0.01

    def test_disabled_by_default_matches_reference(self, rng):
        # Default config: filter params present but NOT applied (the
        # reference's sliders are no-ops, SpectrumCompute.metal:200-209).
        import dataclasses
        from vaudio.runtime import run_offline
        from vaudio.config import LiveParams
        frames = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
        base = LiveParams().as_arrays()
        moved = LiveParams(hp_cutoff=5000.0, lp_cutoff=6000.0,
                           hp_order=4.0, lp_order=4.0).as_arrays()
        a1, _, _ = run_offline(frames, CFG, base)
        a2, _, _ = run_offline(frames, CFG, moved)
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a2))

    def test_enabled_filter_attenuates(self, rng):
        import dataclasses
        from vaudio.runtime import run_offline
        from vaudio.config import LiveParams
        cfg_f = dataclasses.replace(CFG, enable_filters=True)
        frames = np.zeros((6, 256, 256, 3), np.float32)
        frames[..., 0] = 1.0   # red -> f0 ~220, harmonics up to ~2.8k
        wide = LiveParams(hp_cutoff=20.0, lp_cutoff=20000.0,
                          hp_order=8.0, lp_order=8.0,
                          spectrum_mixing=0.0).as_arrays()
        narrow = LiveParams(hp_cutoff=2000.0, lp_cutoff=2500.0,
                            hp_order=8.0, lp_order=8.0,
                            spectrum_mixing=0.0).as_arrays()
        _, _, dw = run_offline(frames, cfg_f, wide, debug=True)
        _, _, dn = run_offline(frames, cfg_f, narrow, debug=True)
        sw = np.asarray(dw["spectrum"][-1])
        sn = np.asarray(dn["spectrum"][-1])
        mag_w = np.hypot(sw[:, 0], sw[:, 1])
        mag_n = np.hypot(sn[:, 0], sn[:, 1])
        freqs = CFG.bin_frequencies()
        low_bins = freqs < 500
        # The narrow band-pass must crush the fundamental region.
        assert mag_n[low_bins].max() < 0.05 * mag_w[low_bins].max()


class TestCleanModeOracle:
    def test_clean_layout_against_oracle(self, rng):
        # quirk_compat=False reads phases at stride 32 with the +13 Bessel
        # offset — the layout the reference *intended* (SoundEngine.swift
        # writes it; the kernel misreads it).  The oracle parameterizes the
        # stride, so clean mode is verifiable too.
        clean = dataclasses.replace(SMALL, quirk_compat=False)
        consts = SynthConstants.create(clean)
        hues, grads, phases, prev = make_state(rng, clean)
        got = np.asarray(build_spectrum(
            jnp.asarray(hues), jnp.asarray(grads), jnp.asarray(phases),
            jnp.asarray(prev), jnp.float32(0.85), clean, consts))
        expect_c = oracles.compute_spectrum_np(
            hues, grads.astype(np.float64), consts.freqs.astype(np.float64),
            (prev[:, 0] + 1j * prev[:, 1]).astype(np.complex128),
            phases.reshape(-1).astype(np.float64), 0.85, clean.bin_width,
            quirk_stride=32, quirk_bessel_offset=13)
        np.testing.assert_allclose(got[:, 0], expect_c.real, atol=2e-4)
        np.testing.assert_allclose(got[:, 1], expect_c.imag, atol=2e-4)


class TestContractionOracle:
    """The spectrum contraction (the single-frame ``contract_spectrum``
    and the chunk pipeline's vmapped ``_batched_contraction``) against
    the same f32 peak matrix contracted in float64 — the plain XLA path
    that replaced the fused spectrum kernel."""

    @staticmethod
    def inputs(rng, *lead, k=2):
        consts = SynthConstants.create(CFG)
        npart = int(consts.seed_phase.size)
        pf = rng.uniform(30.0, 18000.0, lead + (npart,)).astype(np.float32)
        w = rng.normal(0, 1e-2, lead + (npart, k)).astype(np.float32)
        ibw = rng.choice([1.0, 0.2], lead + (npart,)).astype(np.float32)
        return consts, pf, w, ibw

    @staticmethod
    def f64_oracle(consts, pf, w, ibw):
        from vaudio.dsp import hann_sinc_peak_fast
        d = (np.asarray(consts.freqs)[:, None] - pf[None, :]) \
            * (np.float32(1.0 / CFG.bin_width) * ibw)[None, :]
        W = np.asarray(hann_sinc_peak_fast(jnp.asarray(d)), np.float64)
        return W @ w.astype(np.float64)

    def test_single_frame(self, rng):
        from vaudio.synth import contract_spectrum
        consts, pf, w, ibw = self.inputs(rng, k=4)
        got = np.asarray(contract_spectrum(jnp.asarray(pf), jnp.asarray(w),
                                           jnp.asarray(ibw), CFG, consts))
        want = self.f64_oracle(consts, pf, w, ibw)
        assert got.shape == (CFG.num_bins, 4)
        np.testing.assert_allclose(got, want,
                                   atol=2e-6 * np.abs(want).max())

    def test_batched_matches_single(self, rng):
        from vaudio.runtime.chunked import _batched_contraction
        from vaudio.synth import contract_spectrum
        consts, pf, w, ibw = self.inputs(rng, 3)
        got = np.asarray(_batched_contraction(
            jnp.asarray(pf), jnp.asarray(w), jnp.asarray(ibw), CFG, consts))
        assert got.shape == (3, CFG.num_bins, 2)
        for t in range(3):
            one = np.asarray(contract_spectrum(
                jnp.asarray(pf[t]), jnp.asarray(w[t]), jnp.asarray(ibw[t]),
                CFG, consts))
            np.testing.assert_allclose(got[t], one, atol=1e-6)
            want = self.f64_oracle(consts, pf[t], w[t], ibw[t])
            np.testing.assert_allclose(got[t], want,
                                       atol=2e-6 * np.abs(want).max())

    def test_full_spectrum(self, rng):
        """build_spectrum = contraction + static rotation + EMA, against
        the f64 composition of the same stages."""
        from vaudio.synth import (flatten_partials, live_pan_from_params,
                                  partial_weights)
        consts = SynthConstants.create(CFG)
        hues = jnp.asarray(rng.integers(0, 361, 16).astype(np.int32))
        grads = jnp.asarray(np.abs(rng.normal(0, 0.3, (16, 4))
                                   ).astype(np.float32))
        phases = jnp.asarray(rng.uniform(0, 2 * np.pi, (16, 32)
                                         ).astype(np.float32))
        prev = rng.normal(0, 0.01, (CFG.num_bins, 2)).astype(np.float32)
        got = np.asarray(build_spectrum(hues, grads, phases,
                                        jnp.asarray(prev), jnp.float32(0.5),
                                        CFG, consts))
        pf, wr, wi, ibw = partial_weights(hues, grads, phases, CFG, consts)
        fpf, fw, fibw = flatten_partials(pf, wr, wi, ibw, CFG,
                                         pan=live_pan_from_params(CFG, None))
        cur = self.f64_oracle(consts, np.asarray(fpf), np.asarray(fw),
                              np.asarray(fibw))
        c = np.asarray(consts.static_cos, np.float64)
        s = np.asarray(consts.static_sin, np.float64)
        rot = np.stack([cur[:, 0] * c - cur[:, 1] * s,
                        cur[:, 0] * s + cur[:, 1] * c], axis=-1)
        want = prev * 0.5 + rot * 0.5
        np.testing.assert_allclose(got, want,
                                   atol=2e-6 * np.abs(want).max() + 1e-9)

    def test_end_to_end_chunked_vs_scan_contraction(self, rng):
        """The chunk pipeline's batched contraction and the per-frame
        step's contraction give the same audio end to end (serial phases,
        so only the contraction path differs)."""
        from vaudio.runtime import run_offline, run_offline_batched
        from vaudio.config import LiveParams
        cfg = dataclasses.replace(CFG, use_cumsum_phases=False)
        frames = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
        params = LiveParams().as_arrays()
        a_scan, _, _ = run_offline(frames, cfg, params)
        a_chunk, _, _ = run_offline_batched(frames, cfg, params, chunk=4)
        np.testing.assert_allclose(np.asarray(a_chunk), np.asarray(a_scan),
                                   atol=2e-5)
