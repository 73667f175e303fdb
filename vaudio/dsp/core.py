"""Core DSP primitives.

Each function documents the reference behavior it reproduces with a
file:line citation into /root/reference (the upstream iOS app).  These are
*re-implementations from spec*, not translations: they are shaped for XLA
(vectorized, static shapes, no data-dependent control flow).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

_TWO_PI = 2.0 * np.pi


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------

def hann_window_norm(n: int) -> np.ndarray:
    """vDSP_HANN_NORM-equivalent normalized Hann window.

    Reference builds its OLA window with ``vDSP_hann_window(&w, 4096,
    vDSP_HANN_NORM)`` (SoundEngine.swift:97-101).  The normalized variant is
    ``sqrt(2/3) * (1 - cos(2*pi*k/N))`` — unit RMS over a period.
    Returned as a host-side numpy constant (it is baked into the jit).
    """
    k = np.arange(n, dtype=np.float64)
    w = np.sqrt(2.0 / 3.0) * (1.0 - np.cos(_TWO_PI * k / n))
    return w.astype(np.float32)


# ---------------------------------------------------------------------------
# Elementary helpers
# ---------------------------------------------------------------------------

def linspace(start: float, end: float, num: int) -> np.ndarray:
    """`linspace` with the reference's endpoint convention
    (HelperFunctions.swift:148-152): step = (end-start)/(num-1), inclusive.
    """
    if num <= 1:
        return np.asarray([start], dtype=np.float32)
    return np.linspace(start, end, num, dtype=np.float32)


def linear_to_log2(x, x0: float = 20.0, x1: float = 20000.0,
                   y0: float = 400.0, y1: float = 790.0):
    """Display-space log2 mapping (HelperFunctions.swift:53-61).

    Used by the reference's spectrum view; provided for API parity.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    m = (y1 - y0) / np.log2(x1 / x0)
    return m * jnp.log2(x / x0) + y0


def sinc(x):
    """Normalized sinc: sin(pi x)/(pi x), 1 at x=0
    (SpectrumCompute.metal:55-57)."""
    x = jnp.asarray(x, dtype=jnp.float32)
    px = np.float32(np.pi) * x
    # jnp.sinc is sin(pi x)/(pi x) as well but promote/rounding behavior is
    # ours to control; write it out so Pallas can inline identical math.
    return jnp.where(x == 0.0, jnp.float32(1.0), jnp.sin(px) / px)


def hann_sinc_peak(d):
    """Closed-form DFT of a Hann window evaluated at bin distance ``d``.

    W = 0.5*sinc(d) - 0.25*(sinc(d-1) + sinc(d+1))
    (SpectrumCompute.metal:164-167,186-188).  This is the spectral peak
    shape every partial is stamped onto the bin grid with.
    """
    d = jnp.asarray(d, dtype=jnp.float32)
    return 0.5 * sinc(d) - 0.25 * (sinc(d - 1.0) + sinc(d + 1.0))


# Minimax odd polynomial for sin(pi x) on |x| <= 0.5 (degree 9):
# sin(pi x) ~= x*(A1 + x^2*(A3 + x^2*(A5 + x^2*(A7 + x^2*A9)))), fitted to
# <= 2.1e-7 absolute error in f32 (tests/test_dsp.py::TestPeakPolyAccuracy).
_SINPI_A1 = np.float32(3.1415925)
_SINPI_A3 = np.float32(-5.167707)
_SINPI_A5 = np.float32(2.5500314)
_SINPI_A7 = np.float32(-0.5980451)
_SINPI_A9 = np.float32(0.07722007)


def sinpi_reduced(x):
    """sin(pi x) for |x| <= 0.5 as a 5-term odd polynomial (<= 2.1e-7 abs
    error) — ~6 multiply-adds instead of a libm sine."""
    x = jnp.asarray(x, dtype=jnp.float32)
    x2 = x * x
    p = _SINPI_A9
    for c in (_SINPI_A7, _SINPI_A5, _SINPI_A3, _SINPI_A1):
        p = p * x2 + c
    return x * p


def hann_sinc_peak_fast(d):
    """Transcendental-free evaluation of :func:`hann_sinc_peak`
    (<= 2e-7 absolute deviation from the f64 closed form; the previous
    libm-sin variant was ~1e-7 — both orders of magnitude inside the
    3.4e-5 reference-parity budget, benchmarks/parity.py).

    Two reductions of the three-sinc form (the synthesis stage's FLOP
    bottleneck; SpectrumCompute.metal:164-167 evaluates the naive form
    per thread):

    * sin(pi(d+-1)) = -sin(pi d) collapses the three sincs into one sine
      times a rational factor, combined over a common denominator into
      ONE divide:  r = (d^2 - 0.5) / (pi * d * (d-1) * (d+1)), with the
      denominator kept in factored form so the (d-+1) factors stay exact
      near the poles (expanding to d^2-1 would cancel catastrophically);
    * the remaining sine is argument-reduced to |x| <= 0.5 — exactly
      where a 5-term minimax polynomial (:func:`sinpi_reduced`) is cheap
      and accurate — avoiding cancellation near integer d where the
      rational factor has poles.

    ~12 elementwise ops + 1 divide per element, down from 3 divides + a
    libm sin.
    """
    d = jnp.asarray(d, dtype=jnp.float32)
    pi = np.float32(np.pi)
    n = jnp.round(d)
    frac = d - n                                   # exact for |d| < 2^23
    s = sinpi_reduced(frac)
    s = jnp.where(jnp.mod(n, 2.0) == 0.0, s, -s)   # * (-1)^n
    num = d * d - np.float32(0.5)
    den = pi * d * (d - np.float32(1.0)) * (d + np.float32(1.0))
    w = s * (num / den)
    w = jnp.where(d == 0.0, jnp.float32(0.5), w)
    w = jnp.where(jnp.abs(d) == 1.0, jnp.float32(-0.25), w)
    return w


def hash_phase(x):
    """The shader's deterministic hash phase:
    fract(sin(x) * 43758.5453) * 2*pi  (SpectrumCompute.metal:97,136,180).

    Computed in float32 to track the Metal result.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    s = jnp.sin(x) * np.float32(43758.5453)
    frac = s - jnp.floor(s)
    return frac * np.float32(_TWO_PI)


def hue_to_f0(hue_bin, base: float = 220.0, octaves: float = 3.0,
              bins: float = 360.0):
    """Map a hue bin [0..360] to a fundamental frequency.

    f0 = 220 * 2^(3*hue/360) — 220 Hz..1760 Hz over the hue circle
    (SpectrumCompute.metal:108, SoundEngine.swift:261).
    """
    h = jnp.asarray(hue_bin, dtype=jnp.float32)
    return np.float32(base) * jnp.exp2(h / np.float32(bins) * np.float32(octaves))


def find_closest_index(freqs, targets):
    """Vectorized nearest-bin snap replacing the reference's binary search
    (HelperFunctions.swift:233-261, SpectrumCompute.metal:26-42).

    ``freqs`` must be ascending.  Tie-break: on an exact midpoint the lower
    index wins (matches the reference's ``diffCurrent < diffPrevious``
    comparison which prefers ``low-1`` on equality).
    """
    freqs = jnp.asarray(freqs, dtype=jnp.float32)
    targets = jnp.asarray(targets, dtype=jnp.float32)
    n = freqs.shape[0]
    lo = jnp.searchsorted(freqs, targets, side="left")
    lo_c = jnp.clip(lo, 1, n - 1)
    pick_lo = jnp.abs(freqs[lo_c] - targets) < jnp.abs(freqs[lo_c - 1] - targets)
    idx = jnp.where(pick_lo, lo_c, lo_c - 1)
    # Boundary semantics of the reference: low<=0 -> 0, low>=count -> count-1.
    idx = jnp.where(lo <= 0, 0, idx)
    idx = jnp.where(lo >= n, n - 1, idx)
    return idx.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Spectrum <-> signal
# ---------------------------------------------------------------------------

def mirror_and_conjugate(half_re, half_im):
    """Build the full Hermitian spectrum from the F-bin half spectrum.

    Layout (HelperFunctions.swift:110-129): NFFT = 2*(F+1); DC and Nyquist
    are zero; ``full[k+1] = half[k]``; ``full[NFFT-(k+1)] = conj(half[k])``.
    Returns a complex64 array of length NFFT.
    """
    F = half_re.shape[0]
    nfft = 2 * (F + 1)
    half = half_re.astype(jnp.complex64) + 1j * half_im.astype(jnp.complex64)
    zero = jnp.zeros((1,), dtype=jnp.complex64)
    pos = jnp.concatenate([zero, half, zero])           # bins 0..F+1
    neg = jnp.conj(half[::-1])                          # bins F+2..NFFT-1
    full = jnp.concatenate([pos, neg])
    assert full.shape[0] == nfft
    return full


def irfft_from_half(half_re, half_im):
    """Half-spectrum -> real 4096-sample frame.

    Equivalent to the reference's mirrorAndConjugate + complex inverse FFT
    with 1/N scaling taking the real part (HelperFunctions.swift:110-129,
    155-185), expressed as a single `jnp.fft.irfft` — the idiomatic XLA
    path (one real transform instead of a mirrored complex one).
    """
    F = half_re.shape[0]
    nfft = 2 * (F + 1)
    zero = jnp.zeros((1,), dtype=jnp.complex64)
    half = half_re.astype(jnp.complex64) + 1j * half_im.astype(jnp.complex64)
    rspec = jnp.concatenate([zero, half, zero])         # F+2 = nfft/2+1 bins
    return jnp.fft.irfft(rspec, n=nfft).astype(jnp.float32)


@functools.lru_cache(maxsize=4)
def _idft_matrices(F: int, nfft: int):
    """f32 inverse-DFT weight matrices (F, nfft) for the dense path.

    With DC and Nyquist zero (the reference's mirrorAndConjugate layout)
    the real IDFT collapses to x[n] = (2/N) sum_k (re_k cos(2 pi (k+1)
    n / N) - im_k sin(...)); the 2/N scale is folded into the weights.
    Built in f64, cast to f32 once per (F, nfft).  Returned as NumPy
    host constants — caching jnp arrays would capture the first caller's
    trace context and leak tracers into later jits."""
    k = np.arange(1, F + 1, dtype=np.float64)[:, None]
    n = np.arange(nfft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / nfft
    return (((2.0 / nfft) * np.cos(ang)).astype(np.float32),
            ((2.0 / nfft) * np.sin(ang)).astype(np.float32))


def irfft_from_half_dense(half_re, half_im):
    """:func:`irfft_from_half` as two dense f32 matmuls.

    A dense (F, nfft) contraction at ``Precision.HIGHEST`` in place of
    the FFT, whose 33 MB weight read amortizes across the chunk batch;
    accuracy 2.9e-7 of peak vs an f64 oracle (the FFT path is 1.6e-7).
    Speed not measured on the H100.  Batched over any leading dims.
    Selected by ``AuralizerConfig.use_matmul_irfft``.
    """
    F = half_re.shape[-1]
    cos_m, sin_m = _idft_matrices(F, 2 * (F + 1))
    hi = jax.lax.Precision.HIGHEST
    return (jnp.matmul(half_re, cos_m, precision=hi)
            - jnp.matmul(half_im, sin_m, precision=hi))


# ---------------------------------------------------------------------------
# Dynamics
# ---------------------------------------------------------------------------

def sigmoid_normalize(x, M, k: float = 2.0):
    """Soft AGC normalization curve (HelperFunctions.swift:132-138).

    g(t) = 1/(1+exp(-k(t-0.5))) rescaled so g(0)->0, g(1)->1, evaluated at
    t = x/M.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    M = jnp.asarray(M, dtype=jnp.float32)
    kf = np.float32(k)
    scaled = x / M
    g = 1.0 / (1.0 + jnp.exp(-kf * (scaled - 0.5)))
    g0 = 1.0 / (1.0 + np.exp(-k * (0.0 - 0.5)))
    g1 = 1.0 / (1.0 + np.exp(-k * (1.0 - 0.5)))
    return (g - np.float32(g0)) / np.float32(g1 - g0)


def agc_normalize(signal, running_max, attack, release):
    """Attack/release AGC with sigmoid soft normalization.

    Reproduces SoundEngine.swift:412-426: asymmetric EMA of the frame peak
    into ``running_max``, then divide the frame by
    ``framePeak / clamp(sigmoidNormalize(framePeak, runningMax), 0, 1)``.

    Returns (normalized_signal, new_running_max).
    """
    signal = jnp.asarray(signal, dtype=jnp.float32)
    frame_peak = jnp.max(jnp.abs(signal)) + np.float32(1e-9)
    attacked = attack * frame_peak + (1.0 - attack) * running_max
    released = release * frame_peak + (1.0 - release) * running_max
    new_max = jnp.where(frame_peak > running_max, attacked, released)
    norm_factor = jnp.clip(sigmoid_normalize(frame_peak, new_max), 0.0, 1.0)
    norm_value = frame_peak / norm_factor        # may be +inf if factor==0
    out = signal / norm_value                    # x/inf -> 0, like vDSP path
    out = jnp.where(jnp.isfinite(out), out, 0.0)
    return out.astype(jnp.float32), new_max.astype(jnp.float32)


def overlap_add(signal, ola_tail, window):
    """Peak-normalize, window, and overlap-add one synthesis frame.

    Reproduces SoundEngine.swift:231-254: the frame is re-normalized to peak
    1.0 *again* (which largely cancels the AGC — a documented reference
    quirk, SURVEY §2.3), multiplied by the normalized Hann window, and the
    first half is summed with the previous frame's second half.

    Args:
      signal:   f32[..., nfft] frame(s) from the inverse FFT (post-AGC).
                A leading channel axis is supported (stereo extension); the
                peak normalization is then global across channels so the
                stereo image is preserved.
      ola_tail: f32[..., nfft] previous windowed frame.
      window:   f32[nfft] normalized Hann window.
    Returns:
      (out_hop f32[..., nfft//2], new_tail f32[..., nfft])
    """
    signal = jnp.asarray(signal, dtype=jnp.float32)
    nfft = signal.shape[-1]
    hop = nfft // 2
    frame_peak = jnp.max(jnp.abs(signal))
    gain = 1.0 / (frame_peak + np.float32(1e-6))
    windowed = signal * gain * window
    out = ola_tail[..., hop:] + windowed[..., :hop]
    return out.astype(jnp.float32), windowed.astype(jnp.float32)
