"""Additive harmonic + Bessel spectrum synthesis.

Structure of the computation (vs. the reference kernel,
SpectrumCompute.metal:82-214, which runs one GPU thread per frequency bin
with a serial 16-cell x 31-partial inner loop):

1. Per-frame scalar stage (16 cells x 31 partials — tiny): fundamental
   snapping, roll-off, gains, phases, per-cell normalization.  Produces one
   complex weight per partial.
2. Peak-stamping stage: W[bin, partial] = hann_sinc_peak(scaled bin
   distance), then ``spectrum = W @ weights`` — one matrix contraction.
   The 1.0M windowed-sinc evaluations per frame are batched elementwise
   instead of looped per-thread.

All index-only quantities (hash phases, static per-bin phase rotation,
phase-accumulator gather indices) are precomputed on the host in float64 and
baked into the jit as constants — they never change between frames.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from vaudio.config import AuralizerConfig
from vaudio.dsp import find_closest_index, hann_sinc_peak_fast, hue_to_f0

_TWO_PI = np.float64(2.0 * np.pi)


def _hash01(x: np.ndarray) -> np.ndarray:
    s = np.sin(x) * 43758.5453
    return s - np.floor(s)


@dataclasses.dataclass(frozen=True)
class SynthConstants:
    """Host-precomputed constants baked into the synthesis jit.

    These reproduce, as compile-time constants, the quantities the Metal
    kernel derives per-thread from indices alone:

    * ``static_cos/sin`` — the per-bin random phase rotation
      ``fract(sin(fIdx*12.9898)*43758.5453)*2pi`` (SpectrumCompute.metal:97).
    * ``seed_phase`` — the per-(cell, partial) deterministic hash phases
      (SpectrumCompute.metal:134-136,178-180; harmonics seed with h=1..13,
      Bessel modes with b=0..17 — both use the same 13.13 multiplier).
    * ``read_idx`` — gather indices into the flat phase-accumulator buffer,
      with the reference's stride-22 read quirk when cfg.quirk_compat
      (SpectrumCompute.metal:135,179; see AuralizerConfig.quirk_compat).
    """

    freqs: np.ndarray          # f32[F] — the original_f bin grid
    static_cos: np.ndarray     # f32[F]
    static_sin: np.ndarray     # f32[F]
    seed_phase: np.ndarray     # f32[16, P] hash phases (harm ++ bessel)
    read_idx: np.ndarray       # i32[16, P] phase-accum gather indices
    bessel_synth: np.ndarray   # f32[num_bessel_synth]
    harmonic_numbers: np.ndarray  # f32[13]

    @classmethod
    def create(cls, cfg: AuralizerConfig) -> "SynthConstants":
        F = cfg.num_bins
        nc = cfg.num_cells
        nh = cfg.num_harmonics
        nb = cfg.num_bessel_synth

        freqs = cfg.bin_frequencies()

        f_idx = np.arange(F, dtype=np.float64)
        static_phase = _hash01(f_idx * 12.9898) * _TWO_PI
        static_cos = np.cos(static_phase).astype(np.float32)
        static_sin = np.sin(static_phase).astype(np.float32)

        cells = np.arange(nc, dtype=np.float64)[:, None]
        h = np.arange(1, nh + 1, dtype=np.float64)[None, :]
        b = np.arange(nb, dtype=np.float64)[None, :]
        seed_h = _hash01(cells * 1.618 + h * 13.13) * _TWO_PI
        seed_b = _hash01(cells * 1.618 + b * 13.13) * _TWO_PI
        seed_phase = np.concatenate([seed_h, seed_b], axis=1)

        rs = cfg.phase_read_stride
        cell_base = np.arange(nc, dtype=np.int64)[:, None] * rs
        idx_h = cell_base + np.arange(nh)[None, :]
        bessel_off = 0 if cfg.quirk_compat else nh
        idx_b = cell_base + bessel_off + np.arange(nb)[None, :]
        read_idx = np.concatenate([idx_h, idx_b], axis=1)
        if read_idx.max() >= cfg.num_phase_slots:
            # Must be a real error, not an assert (stripped under -O):
            # an out-of-bounds index would be silently CLAMPED by jit's
            # gather at spectrum-build time — wrong partials, no
            # diagnostic.
            raise ValueError(
                f"phase read index {int(read_idx.max())} exceeds "
                f"num_phase_slots {cfg.num_phase_slots} — inconsistent "
                "phase_read_stride / num_cells configuration")

        return cls(
            freqs=freqs,
            static_cos=static_cos,
            static_sin=static_sin,
            seed_phase=seed_phase.astype(np.float32),
            read_idx=read_idx.astype(np.int32),
            bessel_synth=cfg.bessel_ratios()[:nb],
            harmonic_numbers=np.arange(1, nh + 1, dtype=np.float32),
        )

    @property
    def num_partials(self) -> int:
        return self.seed_phase.shape[1]


# ---------------------------------------------------------------------------
# Phase accumulation (SoundEngine.swift:257-286)
# ---------------------------------------------------------------------------

_ADV_TABLE_CACHE: dict = {}


def _phase_advance_table(cfg: AuralizerConfig, consts: SynthConstants):
    """(360, P) table of raw per-frame phase advances, one row per hue
    bin — the image of :func:`phase_advance` over its whole (finite)
    domain, computed ONCE per (config, constants) with the identical
    f32 ops (eagerly, outside jit), so a gather through it is
    bit-identical to the direct computation (cfg.use_phase_lut)."""
    key = (id(consts), cfg.f0_base, cfg.f0_octaves, cfg.hop_size,
           cfg.sample_rate)
    table = _ADV_TABLE_CACHE.get(key)
    if table is None:
        # ensure_compile_time_eval: phase_advance is reached inside jit
        # traces, where jnp ops on concrete operands would otherwise
        # become traced (re-running per call instead of once here).
        with jax.ensure_compile_time_eval():
            freqs = jnp.asarray(consts.freqs)
            f0_raw = hue_to_f0(jnp.arange(360, dtype=jnp.float32),
                               cfg.f0_base, cfg.f0_octaves)
            f0 = freqs[find_closest_index(freqs, f0_raw)]    # (360,)
            ratios = jnp.concatenate([
                jnp.asarray(consts.harmonic_numbers),
                jnp.asarray(cfg.bessel_ratios()),
            ])
            scale = np.float32(2.0 * np.pi * cfg.hop_size
                               / cfg.sample_rate)
            table = np.asarray(scale * (f0[:, None] * ratios[None, :]),
                               np.float32)                   # (360, P)
        _ADV_TABLE_CACHE[key] = table
    return table


def phase_advance(hues, cfg: AuralizerConfig, consts: SynthConstants):
    """One frame's raw (pre-mod) phase advance for every partial slot.

    The per-frame increment of applyPhaseAccumulation
    (SoundEngine.swift:257-286): the fundamental is re-derived from the
    hue, snapped to the bin grid, and each partial advances by
    2*pi*f*hop/fs.  Depends only on this frame's hues — which is what
    lets runtime.chunked batch the accumulation as a prefix sum once
    the serial hue EMA has produced the hue sequence
    (config.use_cumsum_phases).

    Args:
      hues: i32[16].
    Returns: f32[16, 32] raw advances (up to ~2*pi*f_max*hop/fs rad,
      NOT yet wrapped).
    """
    if cfg.use_phase_lut:
        # Hue bins are i32 in [0, 360): the advance is a gather into
        # the precomputed table (bit-identical; see _phase_advance_table).
        return jnp.asarray(_phase_advance_table(cfg, consts))[hues]
    freqs = jnp.asarray(consts.freqs)
    f0_raw = hue_to_f0(hues.astype(jnp.float32), cfg.f0_base, cfg.f0_octaves)
    f0 = freqs[find_closest_index(freqs, f0_raw)]           # (16,)

    ratios = jnp.concatenate([
        jnp.asarray(consts.harmonic_numbers),                # 1..13
        jnp.asarray(cfg.bessel_ratios()),                    # all 19
    ])                                                       # (32,)
    pfreq = f0[:, None] * ratios[None, :]                    # (16, 32)
    return np.float32(2.0 * np.pi * cfg.hop_size / cfg.sample_rate) * pfreq


def phase_accumulate(phases, hues, cfg: AuralizerConfig,
                     consts: SynthConstants):
    """Advance every cell's partial phases by one video frame.

    Reproduces applyPhaseAccumulation: for each of the 16 cells, the
    fundamental is re-derived from the (new) hue, snapped to the bin grid,
    and each partial's phase advances by 2*pi*f*hop/fs, wrapped mod 2*pi.
    This runs for *all* cells every frame, including gated-out ones
    (SoundEngine.swift:258 loops unconditionally).

    The write layout is the clean stride-32 one — 13 harmonic slots then 19
    Bessel slots per cell (SoundEngine.swift:269,279).  The *read*-side
    quirk lives in SynthConstants.read_idx.

    Args:
      phases: f32[16, 32] accumulator (cells x (13 harm + 19 bessel)).
      hues:   i32[16].
    Returns: new f32[16, 32].
    """
    adv = phase_advance(hues, cfg, consts)
    return jnp.mod(phases + adv, np.float32(2.0 * np.pi)).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Spectrum builder
# ---------------------------------------------------------------------------

def partial_weights(hues, grads, phases, cfg: AuralizerConfig,
                    consts: SynthConstants, cell_slice=None):
    """Stage 1: per-partial frequencies and complex weights.

    Returns (pfreq f32[C,P], w_re f32[C,P], w_im f32[C,P], inv_bw f32[C])
    where P = 13+18 partials and the weights already include gain, per-cell
    normalization, frequency compensation and validity.

    ``cell_slice=(start, count)`` restricts the computation to ``count``
    cells beginning at (possibly traced) ``start`` — the tensor-parallel
    path, where each device of the 'cell' mesh axis owns a cell range.  The
    full ``phases`` buffer is still required: quirk-compat reads are
    non-local across cells (stride-22 vs stride-32 layout).
    """
    nh = cfg.num_harmonics
    freqs = jnp.asarray(consts.freqs)

    seed_phase = jnp.asarray(consts.seed_phase)
    read_idx = jnp.asarray(consts.read_idx)
    if cell_slice is not None:
        start, count = cell_slice
        hues = jax.lax.dynamic_slice_in_dim(hues, start, count)
        grads = jax.lax.dynamic_slice_in_dim(grads, start, count)
        seed_phase = jax.lax.dynamic_slice_in_dim(seed_phase, start, count)
        read_idx = jax.lax.dynamic_slice_in_dim(read_idx, start, count)

    hues_f = hues.astype(jnp.float32)
    valid = (hues >= 0) & (hues <= 360)                      # metal :102-103

    f0_raw = hue_to_f0(hues_f, cfg.f0_base, cfg.f0_octaves)
    f0 = freqs[find_closest_index(freqs, f0_raw)]            # (16,)
    bw = jnp.where(f0 < np.float32(cfg.narrowband_below),
                   np.float32(cfg.narrow_bandwidth),
                   np.float32(cfg.wide_bandwidth))           # (16,)

    breathing = grads[:, 0]
    vtilt = grads[:, 1]
    htilt = grads[:, 2]
    saddle = grads[:, 3]

    # Roll-off: mix(4.0, 0.5, clamp(5*breathing, 0, 1)); nan-safe -> 2.0
    t = jnp.clip(breathing * 5.0, 0.0, 1.0)
    roll = 4.0 + (0.5 - 4.0) * t
    roll = jnp.where(jnp.isfinite(roll), roll, 2.0)          # (16,)

    hnum = jnp.asarray(consts.harmonic_numbers)              # (13,)
    bratio = jnp.asarray(consts.bessel_synth)                # (18,)
    ratios = jnp.concatenate([hnum, bratio])                 # (P,)
    pfreq = f0[:, None] * ratios[None, :]                    # (16, P)
    audible = pfreq <= np.float32(cfg.max_partial_freq)

    # Base gains: h^-roll for harmonics, clamp(saddle,0,2)*r^-roll for bessel
    base_h = hnum[None, :] ** (-roll[:, None])               # (16, 13)
    base_b = jnp.clip(saddle, 0.0, 2.0)[:, None] * \
        (bratio[None, :] ** (-roll[:, None]))                # (16, 18)
    base = jnp.concatenate([base_h, base_b], axis=1) * audible

    # Total cell gain uses the PRE-tilt harmonic gain (metal :142 adds
    # before the even/odd weighting at :160-161).
    total_gain = jnp.sum(base, axis=1)                       # (16,)

    # Even/odd tilt weighting for harmonics h > 1.
    h_int = hnum.astype(jnp.int32)
    tilt = jnp.where(h_int[None, :] % 2 == 0, vtilt[:, None],
                     htilt[:, None])
    tilt = jnp.where(h_int[None, :] == 1, 1.0, tilt)         # (16, 13)
    gain = jnp.concatenate([base[:, :nh] * tilt, base[:, nh:]], axis=1)

    # Phases: baked hash seed + accumulated velocity (with read quirk).
    vel = phases.reshape(-1)[read_idx]                       # (C, P)
    phase = seed_phase + vel

    # Per-cell normalization (metal :192-195) and validity gating.
    comp = jnp.sqrt(f0 / np.float32(cfg.f0_base))
    norm = (1.0 / jnp.maximum(total_gain, 0.001)) \
        * np.float32(1.0 / cfg.num_cells) * comp \
        * valid.astype(jnp.float32)                          # (16,)

    w = gain * norm[:, None]                                 # (16, P)
    w_re = w * jnp.cos(phase)
    w_im = w * jnp.sin(phase)
    return pfreq, w_re, w_im, 1.0 / bw


def cell_pan_angles(cfg: AuralizerConfig) -> np.ndarray:
    """Per-cell pan angle theta in [0, pi/2] by 4x4 grid column: column 0
    hard left (0), column grid-1 hard right (pi/2)."""
    cols = np.arange(cfg.num_cells) % cfg.grid_size
    return (cols / max(cfg.grid_size - 1, 1) * (np.pi / 2.0)
            ).astype(np.float32)


def cell_pan_gains(cfg: AuralizerConfig) -> np.ndarray:
    """Equal-power stereo pan per cell, by 4x4 grid column (stereo
    extension — the reference output is mono, SoundEngine.swift:165).

    Returns f32[num_cells, 2] (gL, gR); column 0 hard left, column
    grid-1 hard right.
    """
    theta = cell_pan_angles(cfg)
    return np.stack([np.cos(theta), np.sin(theta)], axis=1).astype(np.float32)


def live_pan_gains(cfg: AuralizerConfig, stereo_width, angles=None):
    """Width-scaled equal-power pan gains (live control, traced — changing
    the width or the per-cell angles never recompiles).

    ``stereo_width`` scales every cell's pan angle about center:
    theta' = pi/4 + width * (theta - pi/4).  width 1 = the full column pan
    law (cell_pan_gains), 0 = all cells dead center (dual mono at equal
    power), >1 = widened beyond the column law (clipped to hard L/R).

    ``angles`` (optional, traced f32[num_cells] in [0, pi/2]) replaces the
    static column pan law as the base layout the width scales about — the
    per-cell pan live control (LiveParams.pan_angles).

    Returns f32[num_cells, 2].
    """
    if angles is None:
        theta = jnp.asarray(cell_pan_angles(cfg))
    else:
        theta = jnp.asarray(angles, jnp.float32)
    quarter = np.float32(np.pi / 4.0)
    w = jnp.asarray(stereo_width, jnp.float32)
    eff = jnp.clip(quarter + w * (theta - quarter), 0.0,
                   np.float32(np.pi / 2.0))
    return jnp.stack([jnp.cos(eff), jnp.sin(eff)], axis=1)


def live_pan_from_params(cfg: AuralizerConfig, params):
    """Traced pan gains when the params dict carries a ``stereo_width``
    and/or ``pan_angles`` (LiveParams), else None (use the baked column
    pan law)."""
    if cfg.channels != 2 or params is None:
        return None
    angles = params.get("pan_angles") if hasattr(params, "get") else None
    if "stereo_width" in params or angles is not None:
        width = params["stereo_width"] if "stereo_width" in params else 1.0
        return live_pan_gains(cfg, width, angles=angles)
    return None


def spectral_filter_gain(freqs, hp_cutoff, lp_cutoff, hp_order, lp_order):
    """The reference's (commented-out) HP/LP per-bin gain
    (SpectrumCompute.metal:200-209):

        gain = 1
        if f <= hp: gain /= 1 + max(0, hp - f)^hp_order
        if f >= lp: gain /= 1 + max(0, f - lp)^lp_order

    Note pow(0, 0) == 1 (both Metal and jnp), so order 0 halves the gain
    at and beyond the cutoff — reproduced as written.
    """
    gain = jnp.ones_like(freqs)
    hp_term = 1.0 + jnp.maximum(0.0, hp_cutoff - freqs) ** hp_order
    lp_term = 1.0 + jnp.maximum(0.0, freqs - lp_cutoff) ** lp_order
    gain = jnp.where(freqs <= hp_cutoff, gain / hp_term, gain)
    gain = jnp.where(freqs >= lp_cutoff, gain / lp_term, gain)
    return gain


def flatten_partials(pfreq, w_re, w_im, inv_bw, cfg: AuralizerConfig,
                     cell_slice=None, pan=None):
    """Stage 1.5: flatten per-cell partials into contraction operands.

    Folds the stereo pan split (cfg.channels == 2) into the weight matrix,
    so the heavy (F x partials) contraction is SHARED between channels:
    each partial's complex weight becomes [gL*re, gL*im, gR*re, gR*im].
    ``cell_slice=(start, count)`` slices the pan gains to the local cell
    range (the tensor-parallel path).  ``pan`` overrides the static column
    pan law with traced gains (the live stereo_width control,
    :func:`live_pan_gains`).

    Returns (flat_pf f32[NP], flat_w f32[NP, 2*channels], flat_ibw f32[NP]).
    """
    nc, P = pfreq.shape
    flat_pf = pfreq.reshape(nc * P)
    flat_w = jnp.stack([w_re.reshape(nc * P), w_im.reshape(nc * P)], axis=1)
    flat_ibw = jnp.broadcast_to(inv_bw[:, None], (nc, P)).reshape(nc * P)
    if cfg.channels == 2:
        if pan is None:
            pan = jnp.asarray(cell_pan_gains(cfg))           # (16, 2)
        if cell_slice is not None:
            start, count = cell_slice
            pan = jax.lax.dynamic_slice_in_dim(pan, start, count)
        pan_flat = jnp.repeat(pan, P, axis=0)                # (nc*P, 2)
        flat_w = (pan_flat[:, :, None] * flat_w[:, None, :]).reshape(
            nc * P, cfg.channels * 2)
    return flat_pf, flat_w, flat_ibw


def contract_spectrum(flat_pf, flat_w, flat_ibw, cfg: AuralizerConfig,
                      consts: SynthConstants):
    """Stage 2: stamp every partial's Hann-transform peak onto the F-bin
    grid — W[bin, partial] @ weights, the matrix contraction (the 1.0M
    windowed-sinc evaluations of SpectrumCompute.metal:128-190, batched).

    Returns f32[F, 2*channels] raw (un-rotated, un-smoothed) spectrum.
    """
    freqs = jnp.asarray(consts.freqs)                        # (F,)
    hann_mult = np.float32(1.0 / cfg.bin_width)
    d = (freqs[:, None] - flat_pf[None, :]) * (hann_mult * flat_ibw)
    W = hann_sinc_peak_fast(d)                               # (F, NP)
    # HIGHEST: DEFAULT-precision f32 dots run in TF32 on GPU tensor
    # cores (~1e-3 relative); exact f32 keeps the <=3.4e-5 oracle parity
    # on device (see vision/features._EXACT).  FLOPs here are negligible.
    return jax.lax.dot_general(
        W, flat_w, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)                 # (F, 2 or 4)


def finalize_spectrum(cur, prev_spectrum, spectrum_mixing,
                      cfg: AuralizerConfig, consts: SynthConstants,
                      filter_params=None):
    """Stage 3: static per-bin phase rotation, optional HP/LP filter,
    temporal EMA against the previous frame (SpectrumCompute.metal:198-213).

    Args:
      cur: f32[F, 2*channels] raw contraction output.
    Returns: spectrum shaped like ``prev_spectrum`` — f32[F, 2] mono or
    f32[channels, F, 2] stereo (the next ``prev``).
    """
    if cfg.channels == 2:
        cur = cur.reshape(-1, cfg.channels, 2)
        cur = jnp.transpose(cur, (1, 0, 2))                  # (2, F, 2)

    # Static per-bin phase rotation (complex multiply, metal :198).
    c = jnp.asarray(consts.static_cos)
    s = jnp.asarray(consts.static_sin)
    rot = jnp.stack([cur[..., 0] * c - cur[..., 1] * s,
                     cur[..., 0] * s + cur[..., 1] * c], axis=-1)

    # Optional HP/LP filtering (metal :200-209 — commented out upstream;
    # see AuralizerConfig.enable_filters).
    if cfg.enable_filters and filter_params is not None:
        fg = spectral_filter_gain(
            jnp.asarray(consts.freqs),
            jnp.asarray(filter_params["hp_cutoff"], jnp.float32),
            jnp.asarray(filter_params["lp_cutoff"], jnp.float32),
            jnp.asarray(filter_params["hp_order"], jnp.float32),
            jnp.asarray(filter_params["lp_order"], jnp.float32))
        rot = rot * fg[:, None]

    # Temporal smoothing: mix(prev, cur, 1 - mixing)  (metal :211-213).
    m = spectrum_mixing
    return (prev_spectrum * m + rot * (1.0 - m)).astype(jnp.float32)


def build_spectrum(hues, grads, phases, prev_spectrum, spectrum_mixing,
                   cfg: AuralizerConfig, consts: SynthConstants,
                   filter_params=None):
    """Full spectrum synthesis for one frame.

    Equivalent of one ``computeSpectrum`` dispatch
    (SpectrumCompute.metal:82-214): stamps every audible partial of every
    valid cell onto the F-bin grid with the Hann-transform peak shape,
    applies the static per-bin phase rotation, and EMA-blends with the
    previous frame's spectrum.  Composition of the staged helpers above
    (the tensor-parallel path reuses them with a cell slice + psum —
    vaudio.parallel.sharding).

    Args:
      hues: i32[16]; grads: f32[16,4]; phases: f32[16,32];
      prev_spectrum: f32[F,2] (mono) or f32[2,F,2] (stereo);
      spectrum_mixing: f32 scalar.
    Returns: spectrum shaped like ``prev_spectrum`` (the next ``prev``).

    With cfg.channels == 2 the per-partial complex weights are split into
    L/R by the cell pan law before the SAME peak-matrix contraction — the
    heavy (F x partials) stage is shared between channels.
    """
    pfreq, w_re, w_im, inv_bw = partial_weights(hues, grads, phases, cfg,
                                                consts)
    flat_pf, flat_w, flat_ibw = flatten_partials(
        pfreq, w_re, w_im, inv_bw, cfg,
        pan=live_pan_from_params(cfg, filter_params))
    cur = contract_spectrum(flat_pf, flat_w, flat_ibw, cfg, consts)

    return finalize_spectrum(cur, prev_spectrum, spectrum_mixing, cfg,
                             consts, filter_params=filter_params)
