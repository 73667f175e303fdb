"""Typed configuration for the vaudio framework.

The reference app hardcodes its operating constants across several files
(reference: video-auralizer/SoundEngine.swift:46-48 `sampleRate/videoFs/NFFT`;
video-auralizer/VisionEngine.swift:24 mip level; VisionEngine.swift:194-195
cell grid / hue bins) and exposes a set of live-tunable published parameters
(SoundEngine.swift:66-75).  Here everything is lifted into two dataclasses:

* :class:`AuralizerConfig` — static compile-time configuration.  Changing any
  of these re-traces/re-compiles the jitted step.
* :class:`LiveParams` — the runtime-tunable parameter set (the equivalent of
  the reference's ``@Published`` controls).  These are traced as dynamic
  arguments so they can change every frame without recompilation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Inharmonic Bessel-mode frequency ratios (~ ratios of zeros of Bessel J),
# reference: video-auralizer/SoundEngine.swift:105-126 (Swift copy) and
# Metal Functions/SpectrumCompute.metal:60-80 (MSL copy).  The synthesis
# kernel iterates only the first 18 (SpectrumCompute.metal:172) while the
# phase-accumulation path advances all 19 (SoundEngine.swift:277-283).
BESSEL_RATIOS: Tuple[float, ...] = (
    1.59334, 2.13555, 2.29542, 2.65307, 2.9173,
    3.15546, 3.50015, 3.64745, 4.05893, 4.13174,
    4.60104, 4.61005, 5.08357, 5.13077, 5.55313,
    5.65084, 6.01936, 6.16314, 6.48274,
)


@dataclasses.dataclass(frozen=True)
class AuralizerConfig:
    """Static configuration (shapes + compile-time constants).

    Defaults reproduce the reference app's math and quirks, with one
    documented deviation: the mip pyramid is computed in full f32 by
    default (``quantize_mips=False``) where the reference's bgra8Unorm
    chain quantizes every level to 8 bits — set ``quantize_mips=True``
    for strict 8-bit parity (docs/PARITY.md, "Known deviations").
    """

    # --- audio format (SoundEngine.swift:46-48) ---
    sample_rate: float = 44100.0
    video_fps: float = 30.0
    nfft: int = 4096

    # --- vision (VisionEngine.swift:24,194-195) ---
    mip_level: int = 3
    grid_size: int = 4          # 4x4 = 16 cells
    num_hue_bins: int = 360
    # Histogram gates (convolveFeatures.metal:154, VisionEngine.swift:263)
    saturation_gate: float = 0.0
    intensity_gate: float = 0.1
    hist_count_gate: int = 20

    # --- synthesis (SpectrumCompute.metal:82-214) ---
    num_harmonics: int = 13
    num_bessel_synth: int = 18      # kernel iterates 18 of the 19 ratios
    f0_base: float = 220.0          # f0 = 220 * 2^(3*hue/360)
    f0_octaves: float = 3.0
    max_partial_freq: float = 20000.0
    narrowband_below: float = 200.0  # bandWidth=5 below 200 Hz else 1
    narrow_bandwidth: float = 5.0
    wide_bandwidth: float = 1.0

    # --- streaming runtime (SoundEngine.swift:88,171-175,448) ---
    ring_buffer_frames: int = 16
    warmup_frames: int = 3

    # --- output channels ---
    # 1 = mono (reference parity; SoundEngine.swift:165 is mono 44.1 kHz).
    # 2 = stereo extension: cells are equal-power panned by their 4x4 grid
    #     column (left column hard left, right column hard right).
    channels: int = 1

    # --- fidelity / quirk switches ---
    # The reference writes phase accumulators with stride 32 (13 harmonics +
    # 19 bessel slots, SoundEngine.swift:269,279) but the GPU kernel *reads*
    # them with stride 22 and no +13 bessel offset
    # (SpectrumCompute.metal:135,179).  quirk_compat=True reproduces that
    # mismatch bit-for-bit; False uses the clean (intended) layout.
    quirk_compat: bool = True
    # Metal's generateMipmaps quantizes every mip level to 8-bit bgra8Unorm
    # (VisionEngine.swift:137-147).  True emulates that quantization between
    # pooling rounds; False keeps full f32 precision through the pyramid.
    quantize_mips: bool = False
    # With quantize_mips on and uint8 input, run the quantized chain in
    # ALL-INTEGER arithmetic (vision.features._quant_pool_level_u8):
    # per-level int8 matmuls with an exact round-half-to-even integer
    # epilogue, instead of the f32 emulation (two f32 matmuls +
    # round(x*255)/255 per level).  Deviation: at an EXACT 2x2-mean
    # midpoint the f32 path's rounding is decided by ~1e-4 of
    # accumulated float error while this path rounds half-to-even —
    # <= 1 grid step/level, and both are approximations of Metal's
    # unspecified bgra8Unorm rounding (docs/PARITY.md).  Speed not
    # measured on the H100.
    quantize_mips_int8: bool = False
    # Reference aggregates gradients over contiguous 1/16 slices of the
    # rotated linear pixel array, NOT the 4x4 spatial grid the histogram
    # uses (VisionEngine.swift:278-283; SURVEY §2.2).  True reproduces that
    # asymmetry; False uses the spatial 4x4 tiling.
    linear_cell_grads: bool = True
    # Inverse-FFT the synthesized half-spectrum with two dense f32
    # matmuls (dsp.irfft_from_half_dense) instead of XLA's FFT (cuFFT on
    # the GPU).  Accuracy 2.9e-7 of peak vs an f64 oracle (FFT: 1.6e-7).
    # The (2047, 4096) weight pair costs 33 MB of device-memory reads
    # per chunk, amortized across the frame batch.  Default off; speed
    # not measured on the H100.
    use_matmul_irfft: bool = False
    # Compute the per-chunk spectrum-smoothing EMA (pass C1 of
    # runtime.chunked) as ONE lower-triangular (T, T) matmul instead of
    # a T-step serial lax.scan: spec_t = m^{t+1} prev +
    # (1-m) sum_{k<=t} m^{t-k} rot_k.  Mathematically identical;
    # numerically reassociated (HIGHEST-precision dot accumulation vs
    # sequential fma — observed <= 1e-6 abs at T=64), so the scan-path
    # bit-for-near guarantee of runtime.chunked no longer holds exactly
    # when enabled.  Only affects the chunked pipeline.  Default off;
    # speed not measured on the H100.
    use_matmul_ema: bool = False
    # Accumulate per-frame phase advances (pass A of runtime.chunked)
    # as a BATCHED log-depth associative scan of mod-2pi increments
    # instead of inside the serial hue-EMA lax.scan: the hue recurrence
    # (nonlinear gate + int truncation) is the only genuinely serial
    # piece; the phase advance for frame t depends only on hues_t, so
    # once the hue scan has run, phases_t = (phases_0 +
    # prefix_sum(adv_t)) mod 2pi.  mod-add is exactly associative; the
    # numeric difference vs the serial path comes from WHERE the mod
    # hits the raw advance (up to ~5400 rad for a 20 kHz partial, f32
    # ulp ~5e-4): each path rounds that magnitude once per frame, in
    # different ops, so their phases random-walk apart by ~ulp/frame —
    # measured 1.4e-3 rad / 6e-4 audio abs at T=32 (neither is closer
    # to exact math; the serial path is the reference-faithful one,
    # SoundEngine.swift:267-283 accumulates f32 at the same magnitude;
    # on-device audit: chip_smoke.py's parity phase).
    # Breaks the frame_step bit-for-near guarantee when enabled.  Only
    # affects the chunked pipeline.  Default ON: it shrinks the serial
    # scan to the hue EMA alone.  Set False for bit-for-near agreement
    # with the per-frame scan path (docs/PARITY.md).
    use_cumsum_phases: bool = True
    # Evaluate the hue arccos (vision.rgb_to_hsi_planes) with the
    # degree-7 sqrt-polynomial (Abramowitz & Stegun 4.4.46, <= 2e-8 rad
    # = 3e-9 of a hue turn) instead of the transcendental expansion —
    # one sqrt and 7 fma in place of the libm expansion in the
    # elementwise HSI stage.  On by
    # default: the deviation is two orders below the default peak-math
    # tolerance (dsp.hann_sinc_peak_fast, <= 2e-7) already accepted as
    # exact; a hue can only change histogram bin if it lands within
    # 2e-8 rad of a bin edge.  False restores jnp.arccos.
    fast_hue_acos: bool = True
    # Evaluate the per-frame phase advance (synth.phase_advance) as a
    # gather into a precomputed (360, P) table instead of re-deriving
    # exp2 + nearest-bin-snap + ratio outer product per frame.  A hue
    # bin has only 360 possible values, so the table — built ONCE per
    # (config, constants) with exactly the same f32 ops — is
    # bit-identical per hue; both the chunked prefix-sum path and the
    # per-frame phase_accumulate route through it.  Default off; speed
    # not measured on the H100.
    use_phase_lut: bool = False
    # Apply the spectral HP/LP filter driven by the hp/lp live params.
    # The reference plumbs these parameters all the way into its kernel but
    # the application is commented out (SpectrumCompute.metal:200-209) — the
    # sliders are no-ops there.  False (default) reproduces that; True
    # enables the filter with the commented-out math.
    enable_filters: bool = False

    # ------------------------------------------------------------------
    # Derived quantities (SoundEngine.swift:129-144)
    # ------------------------------------------------------------------
    @property
    def num_cells(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def n(self) -> int:
        """Effective DFT length used for bin width: NFFT - 2 = 4094."""
        return self.nfft - 2

    @property
    def num_bins(self) -> int:
        """F — number of synthesized half-spectrum bins (2047)."""
        return max(2, self.n // 2)

    @property
    def hop_size(self) -> int:
        """Overlap-add hop (SoundEngine.swift:96)."""
        return self.nfft // 2

    @property
    def bin_width(self) -> float:
        """fs / N ≈ 10.772 Hz (SoundEngine.swift:143)."""
        return self.sample_rate / float(self.n)

    @property
    def num_bessel(self) -> int:
        return len(BESSEL_RATIOS)

    @property
    def phase_stride(self) -> int:
        """Stride of the phase-accumulation write layout: 13+19 = 32."""
        return self.num_harmonics + self.num_bessel

    @property
    def phase_read_stride(self) -> int:
        """Stride the synthesis kernel reads with.

        22 (= 13+9) in quirk-compat mode (SpectrumCompute.metal:135,179),
        otherwise the clean write stride.
        """
        return 22 if self.quirk_compat else self.phase_stride

    @property
    def num_phase_slots(self) -> int:
        return self.num_cells * self.phase_stride

    def bin_frequencies(self) -> np.ndarray:
        """The reference's `original_f` bin-frequency grid.

        linspace(fs/F, fs/2 + fs/F, F)  (SoundEngine.swift:141).  Note the
        top bins slightly exceed Nyquist — reproduced on purpose.
        """
        F = self.num_bins
        start = self.sample_rate / F
        end = self.sample_rate / 2 + self.sample_rate / F
        return np.linspace(start, end, F, dtype=np.float32)

    def bessel_ratios(self) -> np.ndarray:
        return np.asarray(BESSEL_RATIOS, dtype=np.float32)


@dataclasses.dataclass
class LiveParams:
    """Runtime-tunable parameters — the `@Published` set of the reference
    (SoundEngine.swift:66-75) plus the vision-side smoothing coefficient
    (VisionEngine.swift:36).  All values are traced dynamically: updating
    them never triggers recompilation.
    """

    attack: float = 1.0
    release: float = 1.0
    spectrum_mixing: float = 0.9
    hp_cutoff: float = 200.0
    lp_cutoff: float = 18000.0
    hp_order: float = 0.0
    lp_order: float = 0.0
    # Stereo extension (no reference equivalent — its output is mono):
    # scales every cell's pan angle about center. 1 = the full column pan
    # law, 0 = dual mono, >1 widened (clipped to hard L/R). Only used when
    # AuralizerConfig.channels == 2 (synth.live_pan_gains).
    stereo_width: float = 1.0
    # Optional per-cell pan-angle override: a (num_cells,) array of angles
    # in [0, pi/2] (0 = hard left, pi/2 = hard right) replacing the static
    # column pan law as the base that stereo_width scales about.  None (the
    # default) keeps the column law.  Like every live param the VALUES are
    # traced (change per frame, no recompile); flipping between None and an
    # array changes the jit signature and re-traces once.
    pan_angles: object = None

    def as_arrays(self):
        """Flatten to a dict of float32 numpy values for feeding a jit.

        Scalar fields become numpy float32 scalars; array-valued fields
        (``pan_angles``) become float32 arrays; fields left at ``None`` are
        omitted so the jit signature only carries what is actually used.
        """
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if value is None:
                continue
            arr = np.asarray(value, dtype=np.float32)
            out[f.name] = arr if arr.ndim else np.float32(arr)
        return out


DEFAULT_CONFIG = AuralizerConfig()
