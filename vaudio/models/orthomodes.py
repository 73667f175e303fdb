"""OrthoModes — the reference's abandoned per-pixel synthesis design,
reconstructed as a working model family.

The reference ships a never-wired kernel, ``computeOrthogonalModesFromTexture``
(Metal Functions/computeOrthogonalModes.metal:14-150), that computes one
oscillator per mip pixel — amplitude from intensity + orthogonal-mode
corrections, resonance Q from saturation, f0 from hue mapped linearly to
400-790 Hz — the design the shipped 16-cell model replaced (SURVEY.md §2.9).
Its intended peak shape is documented by the interactive VisualizePeak tool
(Tools/VisualizePeak.swift:104-109): a normalized Hann-transform lobe
multiplied by a normalized Lorentzian whose width is driven by Q.

This module completes that design: per-pixel (A, Q, f0) extraction with the
kernel's exact math, then spectral synthesis by stamping one Hann x
Lorentzian peak per pixel onto the same F-bin grid the main model uses,
sharing the irfft/AGC/OLA audio tail.  The stamping is the same
(bins x sources) evaluate-then-contract pattern as the main model — just
with thousands of sources instead of 496 partials.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from vaudio.config import AuralizerConfig
from vaudio.dsp import (agc_normalize, hann_sinc_peak_fast, hann_window_norm,
                        irfft_from_half, overlap_add)
from vaudio.vision.features import mip_downsample_planes

_TWO_PI = np.float32(2.0 * np.pi)


@dataclasses.dataclass(frozen=True)
class OrthoModesConfig:
    """Static configuration for the per-pixel model.

    ``mip_level`` controls the oscillator count (one per mip pixel):
    level 5 puts 1080p at 33x60 = 1980 oscillators.
    """

    audio: AuralizerConfig = dataclasses.field(
        default_factory=AuralizerConfig)
    mip_level: int = 5
    # f0 = 390/(2*pi) * hue_radians + 400  (computeOrthogonalModes.metal:81)
    f0_offset: float = 400.0
    f0_span: float = 390.0
    # Lorentzian width mapping: Q in [0,1] -> lambda in [lo, hi]; larger
    # lambda = narrower resonance (VisualizePeak's Q slider direction).
    lorentz_lo: float = 2.0
    lorentz_hi: float = 24.0
    bandwidth: float = 2.0          # Hann lobe width in bins

    @property
    def num_bins(self) -> int:
        return self.audio.num_bins


@dataclasses.dataclass
class ModeMultipliers:
    """The kernel's ``ModeMultipliers`` uniform
    (computeOrthogonalModes.metal:6-11) — live-tunable mode weights."""

    breathing: float = 0.5
    vertical_tilt: float = 0.5
    horizontal_tilt: float = 0.5
    shear: float = 0.5

    def as_arrays(self):
        return {f.name: np.float32(getattr(self, f.name))
                for f in dataclasses.fields(self)}


class OrthoCarry(NamedTuple):
    phases: jax.Array        # f32[P] per-oscillator phase accumulators
    prev_spectrum: jax.Array  # f32[F, 2]
    ola_tail: jax.Array      # f32[nfft]
    running_max: jax.Array   # f32[]


def _hsi_kernel_variant(r, g, b):
    """The dead kernel's HSI variant (computeOrthogonalModes.metal:64-82):
    I = mean; S = (max-min)/max (HSV-style, NOT the shipped 1-min/I);
    f0 = 390/(2*pi)*H_radians + 400."""
    i = (r + g + b) * np.float32(1.0 / 3.0)
    mn = jnp.minimum(r, jnp.minimum(g, b))
    mx = jnp.maximum(r, jnp.maximum(g, b))
    s = jnp.where(i > 1e-6, (mx - mn) / jnp.where(mx > 0, mx, 1.0), 0.0)

    num = 0.5 * ((r - g) + (r - b))
    den = jnp.sqrt((r - g) ** 2 + (r - b) * (g - b))
    theta = jnp.where(den > 1e-6,
                      jnp.arccos(jnp.clip(num / jnp.where(den > 1e-6, den,
                                                          1.0), -1.0, 1.0)),
                      0.0)
    h = jnp.where(b <= g, theta, _TWO_PI - theta)
    return i, s, h


def extract_pixel_modes(frame, multipliers: Dict[str, jax.Array],
                        cfg: OrthoModesConfig):
    """Per-pixel (A, Q, f0) — the kernel body, vectorized.

    Exactly reproduces computeOrthogonalModes.metal:45-149: a 5-point
    clamp-to-edge stencil over the mip image's intensity and saturation,
    combined into four orthogonal modes (breathing / N-S tilt / E-W tilt /
    shear), weighted by the live multipliers:

      A  = max(0, 255*(I_c + sum_i I_Mi * w_i))
      Q  = clamp(S_c + sum_i S_Mi * w_i, 0, 1)
      f0 = 390/(2*pi) * hue + 400        (Hz, from the center pixel)

    Args: frame: f32/u8 [H, W, 3] RGB (or YUV dict is NOT supported here —
      this model predates that path).
    Returns: (amp f32[P], q f32[P], f0 f32[P]) with P = mip pixels.
    """
    frame = jnp.asarray(frame)
    scale = 1.0 / 255.0 if frame.dtype == jnp.uint8 else 1.0
    planes = jnp.transpose(frame, (2, 0, 1))
    mip = mip_downsample_planes(planes, cfg.mip_level, scale=scale)
    i, s, h = _hsi_kernel_variant(mip[0], mip[1], mip[2])
    f0 = np.float32(cfg.f0_span / (2.0 * np.pi)) * h \
        + np.float32(cfg.f0_offset)

    def neighbor(x, dy, dx):
        # clamp-to-edge neighbor (the kernel's sampler semantics)
        hm, wm = x.shape
        ys = jnp.clip(jnp.arange(hm) + dy, 0, hm - 1)
        xs = jnp.clip(jnp.arange(wm) + dx, 0, wm - 1)
        return x[ys][:, xs]

    inv_sqrt2 = np.float32(0.70710678)
    out = {}
    for name, chan in (("i", i), ("s", s)):
        d_n = neighbor(chan, -1, 0) - chan
        d_s = neighbor(chan, 1, 0) - chan
        d_e = neighbor(chan, 0, 1) - chan
        d_w = neighbor(chan, 0, -1) - chan
        out[name] = (
            0.5 * (d_n + d_s + d_e + d_w),          # M1 breathing
            inv_sqrt2 * (d_n - d_s),                 # M2 vertical tilt
            inv_sqrt2 * (d_e - d_w),                 # M3 horizontal tilt
            0.5 * (d_n - d_e + d_s - d_w),           # M4 shear
        )

    wb = jnp.asarray(multipliers["breathing"], jnp.float32)
    wv = jnp.asarray(multipliers["vertical_tilt"], jnp.float32)
    wh = jnp.asarray(multipliers["horizontal_tilt"], jnp.float32)
    ws = jnp.asarray(multipliers["shear"], jnp.float32)

    im1, im2, im3, im4 = out["i"]
    sm1, sm2, sm3, sm4 = out["s"]
    amp = jnp.maximum(
        0.0, 255.0 * (i + im1 * wb + im2 * wv + im3 * wh + im4 * ws))
    q = jnp.clip(s + sm1 * wb + sm2 * wv + sm3 * wh + sm4 * ws, 0.0, 1.0)
    return amp.reshape(-1), q.reshape(-1), f0.reshape(-1)


def synthesize_spectrum(amp, q, f0, phases, prev_spectrum, mixing,
                        cfg: OrthoModesConfig, consts):
    """Stamp one Hann x Lorentzian peak per oscillator onto the bin grid.

    Peak shape per VisualizePeak.swift:104-109: normalized Hann-transform
    lobe times a normalized Lorentzian whose sharpness grows with Q
    (saturated colors ring narrower/longer).  Complex phase = carried
    accumulator + per-oscillator hash (same treatment as the main model).
    """
    freqs = jnp.asarray(consts["freqs"])              # (F,)
    p = amp.shape[0]

    lam = np.float32(cfg.lorentz_lo) + q * np.float32(
        cfg.lorentz_hi - cfg.lorentz_lo)              # (P,)
    inv_bw = np.float32(1.0 / (cfg.audio.bin_width * cfg.bandwidth))
    d = (freqs[:, None] - f0[None, :]) * inv_bw       # (F, P)
    lobe = hann_sinc_peak_fast(d) * np.float32(2.0)   # 1.0 at d = 0
    lor = 1.0 / (1.0 + (lam[None, :] * d) ** 2)
    peak = lobe * lor                                 # (F, P)

    phase = jnp.asarray(consts["seed_phase"]) + phases   # (P,)
    norm = np.float32(1.0 / 255.0) / np.float32(max(p, 1)) * amp
    w = jnp.stack([norm * jnp.cos(phase), norm * jnp.sin(phase)], axis=1)
    cur = jax.lax.dot_general(
        peak, w, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)          # (F, 2); exact f32
    # (DEFAULT would run in TF32 on GPU tensor cores — features._EXACT)

    c = jnp.asarray(consts["static_cos"])
    s = jnp.asarray(consts["static_sin"])
    rot = jnp.stack([cur[:, 0] * c - cur[:, 1] * s,
                     cur[:, 0] * s + cur[:, 1] * c], axis=1)
    return (prev_spectrum * mixing + rot * (1.0 - mixing)).astype(
        jnp.float32)


class OrthoModesModel:
    """The per-pixel A/Q/f0 synthesis model (second model family).

    Usage::

        model = OrthoModesModel(OrthoModesConfig())
        audio = model.sonify(frames)            # f32[T*hop]
    """

    def __init__(self, cfg: OrthoModesConfig = OrthoModesConfig(),
                 multipliers: ModeMultipliers | None = None):
        self.cfg = cfg
        self.multipliers = multipliers or ModeMultipliers()
        self._consts_cache: Dict[int, Dict] = {}

    def _consts(self, p: int) -> Dict:
        if p not in self._consts_cache:
            acfg = self.cfg.audio
            F = acfg.num_bins
            fi = np.arange(F, dtype=np.float64)
            sp = (lambda x: x - np.floor(x))(np.sin(fi * 12.9898)
                                             * 43758.5453) * 2 * np.pi
            pi_ = np.arange(p, dtype=np.float64)
            seed = (lambda x: x - np.floor(x))(np.sin(pi_ * 78.233)
                                               * 43758.5453) * 2 * np.pi
            self._consts_cache[p] = {
                "freqs": acfg.bin_frequencies(),
                "static_cos": np.cos(sp).astype(np.float32),
                "static_sin": np.sin(sp).astype(np.float32),
                "seed_phase": seed.astype(np.float32),
            }
        return self._consts_cache[p]

    def init_carry(self, p: int) -> OrthoCarry:
        acfg = self.cfg.audio
        return OrthoCarry(
            phases=jnp.zeros((p,), jnp.float32),
            prev_spectrum=jnp.zeros((acfg.num_bins, 2), jnp.float32),
            ola_tail=jnp.zeros((acfg.nfft,), jnp.float32),
            running_max=jnp.float32(1.0),
        )

    def num_oscillators(self, h: int, w: int) -> int:
        return (h >> self.cfg.mip_level) * (w >> self.cfg.mip_level)

    def frame_step(self, carry: OrthoCarry, frame, params,
                   window) -> Tuple[OrthoCarry, jax.Array]:
        cfg = self.cfg
        acfg = cfg.audio
        amp, q, f0 = extract_pixel_modes(frame, params, cfg)
        consts = self._consts(amp.shape[0])

        # Phase accumulation per oscillator (f0 is continuous here — the
        # dead design predates bin snapping).
        adv = np.float32(2.0 * np.pi * acfg.hop_size / acfg.sample_rate) * f0
        phases = jnp.mod(carry.phases + adv, _TWO_PI)

        mixing = jnp.asarray(params["spectrum_mixing"], jnp.float32)
        spectrum = synthesize_spectrum(amp, q, f0, phases,
                                       carry.prev_spectrum, mixing, cfg,
                                       consts)
        signal = irfft_from_half(spectrum[:, 0], spectrum[:, 1])
        normalized, running_max = agc_normalize(
            signal, carry.running_max,
            jnp.asarray(params["attack"], jnp.float32),
            jnp.asarray(params["release"], jnp.float32))
        pcm, ola_tail = overlap_add(normalized, carry.ola_tail, window)
        return OrthoCarry(phases, spectrum, ola_tail, running_max), pcm

    def sonify(self, frames, params: Dict | None = None) -> np.ndarray:
        """Offline scan over a clip; returns f32[T*hop] PCM."""
        acfg = self.cfg.audio
        frames = jnp.asarray(frames)
        t, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        p = self.num_oscillators(h, w)
        if params is None:
            params = {**self.multipliers.as_arrays(),
                      "spectrum_mixing": np.float32(0.9),
                      "attack": np.float32(1.0),
                      "release": np.float32(1.0)}
        window = jnp.asarray(hann_window_norm(acfg.nfft))
        carry = self.init_carry(p)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def scan_fn(carry, frames, params):
            def body(c, f):
                return self.frame_step(c, f, params, window)
            return jax.lax.scan(body, carry, frames)

        _, pcm = scan_fn(carry, frames, params)
        return np.asarray(pcm.reshape(-1))
