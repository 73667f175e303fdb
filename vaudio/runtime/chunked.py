"""Chunk-batched execution: the same frame->audio math as
vaudio.runtime.step, restructured so the heavy synthesis stage runs
BATCHED across frames instead of once per scan iteration.

Batching amortizes per-iteration scheduling overhead and lets every
per-sample stage (contraction, irfft, OLA windowing) run as one large
kernel.  Only the stages with a true serial dependence stay sequential:

  pass A (lax.scan): vision -> hue EMA -> phase accumulation
          (the hue EMA is nonlinear int truncation; phases accumulate);
  pass B (batched):  per-partial weights, ONE batched peak contraction
          for all T frames, static phase rotation, HP/LP filter;
  pass C: spectrum EMA as a cheap elementwise lax.scan, then the audio
          tail with its scalar recurrences (AGC running max, OLA tail)
          factored out of the batched math — per-frame *scalars* scan,
          per-sample work runs batched (one big irfft over all frames).

Numerically this reorders nothing: every op is the same f32 op on the
same values as frame_step, so outputs match the scan path bit-for-near
(contraction kernel difference <= 1e-5; see tests/test_chunked.py).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from vaudio.config import AuralizerConfig
from vaudio.dsp import hann_sinc_peak_fast, hann_window_norm, \
    irfft_from_half, sigmoid_normalize
from vaudio.runtime.step import StepCarry, default_params, init_carry
from vaudio.synth import (SynthConstants, flatten_partials,
                          live_pan_from_params, partial_weights,
                          phase_accumulate, phase_advance,
                          spectral_filter_gain)
from vaudio.vision import frame_stats, hist_max_and_arg, \
    update_hues_from_stats


def _batched_contraction(flat_pf, flat_w, flat_ibw, cfg: AuralizerConfig,
                         consts: SynthConstants):
    """(T, NP) partials -> (T, F, K) raw spectra, one dispatch: the
    transcendental-free peak evaluation (dsp.hann_sinc_peak_fast) feeding
    one f32 dot per frame, vmapped over the chunk."""
    hann_mult = np.float32(1.0 / cfg.bin_width)
    freqs = jnp.asarray(consts.freqs)

    def one(pf, scale, w):
        d = (freqs[:, None] - pf[None, :]) * scale[None, :]
        W = hann_sinc_peak_fast(d)
        return jax.lax.dot_general(
            W, w, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)  # exact f32, not TF32
            # (see features._EXACT)
    return jax.vmap(one)(flat_pf, flat_ibw * hann_mult, flat_w)


def chunk_pipeline(carry: StepCarry, frames, params: Dict[str, Any],
                   cfg: AuralizerConfig, consts: SynthConstants, window,
                   debug: bool = False
                   ) -> Tuple[StepCarry, Dict[str, Any]]:
    """Process T frames; returns (new_carry, out) with out["pcm"] of shape
    (T, hop) mono or (T, hop, channels) stereo — the multi-frame
    equivalent of T frame_step calls."""
    ch = cfg.channels
    mixing = jnp.asarray(params["spectrum_mixing"], jnp.float32)
    T = (frames["y"] if isinstance(frames, dict) else frames).shape[0]

    # ---- pass A: vision stats BATCHED over all frames (per-frame
    # independent: mip/HSI/histogram/grad matmuls get a T-deep batch);
    # only the hue EMA + phase accumulation — 16 ints + a (16, 32) add
    # per frame — stay in a (tiny) serial scan. ----
    def stats_one(frame):
        hist, grads, _ = frame_stats(frame, cfg)
        return hist, grads

    hists, grads_seq = jax.vmap(stats_one)(frames)    # (T,16,360), (T,16,4)
    max_vals, args = hist_max_and_arg(hists)           # (T, 16) each

    if cfg.use_cumsum_phases:
        # Only the hue EMA is genuinely serial (nonlinear gate + int
        # truncation); the phase advance for frame t depends only on
        # hues_t, so phases factor out as a prefix sum once the hue
        # scan has run: phases_t = (phases_0 + sum_{k<=t} adv_k) mod
        # 2pi, evaluated as a log-depth associative scan of mod-2pi
        # increments (mod-add is exactly associative; combine operands
        # stay <= 4pi).  See config.use_cumsum_phases for the numerics.
        def hue_scan(h_prev, x):
            mx, ag = x
            hues = update_hues_from_stats(mx, ag, h_prev, mixing, cfg)
            return hues, hues

        hues_last, hues_seq = jax.lax.scan(
            hue_scan, carry.hues, (max_vals, args), unroll=8)
        two_pi = np.float32(2.0 * np.pi)
        adv = jax.vmap(lambda h: phase_advance(h, cfg, consts))(hues_seq)
        adv = jnp.mod(adv, two_pi)                       # (T, 16, 32)
        prefix = jax.lax.associative_scan(
            lambda a, b: jnp.mod(a + b, two_pi), adv, axis=0)
        phases_seq = jnp.mod(carry.phases[None] + prefix,
                             two_pi).astype(jnp.float32)
        phases_last = phases_seq[-1]
    else:
        def pass_a(c, x):
            hues_prev, phases_prev = c
            mx, ag = x
            hues = update_hues_from_stats(mx, ag, hues_prev, mixing, cfg)
            phases = phase_accumulate(phases_prev, hues, cfg, consts)
            return (hues, phases), (hues, phases)

        # unroll: the per-iteration state is tiny (16 ints + a (16, 32)
        # add), so loop overhead dominates; unrolling batches it without
        # changing the math (bit-identical).
        (hues_last, phases_last), (hues_seq, phases_seq) = \
            jax.lax.scan(pass_a, (carry.hues, carry.phases),
                         (max_vals, args), unroll=8)

    # ---- pass B: weights + ONE batched contraction + rotation ----
    pan = live_pan_from_params(cfg, params)   # shared across frames

    def weights_one(hues, grads, phases):
        pf, w_re, w_im, inv_bw = partial_weights(hues, grads, phases, cfg,
                                                 consts)
        return flatten_partials(pf, w_re, w_im, inv_bw, cfg, pan=pan)

    flat_pf, flat_w, flat_ibw = jax.vmap(weights_one)(
        hues_seq, grads_seq, phases_seq)                 # (T, NP[, K])
    cur = _batched_contraction(flat_pf, flat_w, flat_ibw, cfg,
                               consts)                   # (T, F, K)

    if ch == 2:
        cur = jnp.transpose(cur.reshape(T, -1, ch, 2), (0, 2, 1, 3))

    c = jnp.asarray(consts.static_cos)
    s = jnp.asarray(consts.static_sin)
    rot = jnp.stack([cur[..., 0] * c - cur[..., 1] * s,
                     cur[..., 0] * s + cur[..., 1] * c], axis=-1)

    if cfg.enable_filters:
        fg = spectral_filter_gain(
            jnp.asarray(consts.freqs),
            jnp.asarray(params["hp_cutoff"], jnp.float32),
            jnp.asarray(params["lp_cutoff"], jnp.float32),
            jnp.asarray(params["hp_order"], jnp.float32),
            jnp.asarray(params["lp_order"], jnp.float32))
        rot = rot * fg[:, None]

    # ---- pass C1: spectrum EMA ----
    if cfg.use_matmul_ema:
        # Closed form of the linear recurrence as one lower-triangular
        # (T, T) contraction:
        #   spec_t = m^{t+1} prev + (1-m) * sum_{k<=t} m^{t-k} rot_k.
        # Reassociated accumulation (<= ~1e-6 abs vs the scan at T=64);
        # see config.use_matmul_ema.
        t_idx = jnp.arange(T)
        tk = (t_idx[:, None] - t_idx[None, :]).astype(jnp.float32)
        lower = t_idx[:, None] >= t_idx[None, :]
        L = jnp.where(lower,
                      (1.0 - mixing) * jnp.power(mixing,
                                                 jnp.where(lower, tk, 0.0)),
                      0.0).astype(jnp.float32)               # (T, T)
        pows = jnp.power(mixing,
                         jnp.arange(1, T + 1, dtype=jnp.float32))  # (T,)
        flat = rot.reshape(T, -1)
        spectra = jax.lax.dot_general(
            L, flat, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)   # exact f32, not TF32
        spectra = spectra + pows[:, None] * \
            carry.prev_spectrum.reshape(1, -1)
        spectra = spectra.reshape((T,) + rot.shape[1:]).astype(jnp.float32)
        prev_last = spectra[-1]
    else:
        # Cheap elementwise scan (sequential fma — the parity-exact
        # default: bit-for-near with the frame_step path).
        def ema(prev, r):
            spec = (prev * mixing + r * (1.0 - mixing)).astype(jnp.float32)
            return spec, spec

        prev_last, spectra = jax.lax.scan(ema, carry.prev_spectrum, rot,
                                          unroll=4)

    # ---- pass C2: audio tail, scalars serial / samples batched ----
    # One big batched irfft over all frames (and channels).
    if cfg.use_matmul_irfft:
        # Dense path: one (T[*ch], F) x (F, nfft) contraction pair; the
        # 33 MB weight read amortizes over the whole chunk
        # (dsp.irfft_from_half_dense).
        from vaudio.dsp import irfft_from_half_dense
        signals = irfft_from_half_dense(spectra[..., 0], spectra[..., 1])
    elif ch == 1:
        signals = jax.vmap(
            lambda sp: irfft_from_half(sp[:, 0], sp[:, 1]))(spectra)
    else:
        signals = jax.vmap(jax.vmap(
            lambda sp: irfft_from_half(sp[:, 0], sp[:, 1])))(spectra)

    # AGC (SoundEngine.swift:412-426): the recurrence touches only the
    # per-frame PEAK; run the scalar scan on peaks, apply batched.
    axes = tuple(range(1, signals.ndim))
    peaks = jnp.max(jnp.abs(signals), axis=axes) + np.float32(1e-9)  # (T,)
    attack = jnp.asarray(params["attack"], jnp.float32)
    release = jnp.asarray(params["release"], jnp.float32)

    def agc_scan(rm, p):
        attacked = attack * p + (1.0 - attack) * rm
        released = release * p + (1.0 - release) * rm
        new_max = jnp.where(p > rm, attacked, released)
        return new_max.astype(jnp.float32), new_max

    running_max_last, new_maxes = jax.lax.scan(agc_scan,
                                               carry.running_max, peaks,
                                               unroll=8)
    norm_factor = jnp.clip(sigmoid_normalize(peaks, new_maxes), 0.0, 1.0)
    norm_value = peaks / norm_factor
    scale = jnp.where(jnp.isfinite(1.0 / norm_value), 1.0 / norm_value,
                      0.0)                                      # (T,)
    bshape = (T,) + (1,) * (signals.ndim - 1)
    normalized = signals * scale.reshape(bshape)
    normalized = jnp.where(jnp.isfinite(normalized), normalized, 0.0)

    # OLA (SoundEngine.swift:231-254): the windowed frames are pure
    # per-frame functions of the normalized signal; only the one-frame
    # shift crosses frames.  Fully batched.
    hop = cfg.hop_size
    fpeaks = jnp.max(jnp.abs(normalized), axis=axes)            # (T,)
    gains = 1.0 / (fpeaks + np.float32(1e-6))
    windowed = (normalized * gains.reshape(bshape)
                * window).astype(jnp.float32)                   # (T,.., nfft)
    prev_tails = jnp.concatenate(
        [carry.ola_tail[None], windowed[:-1]], axis=0)
    pcm = (prev_tails[..., hop:] + windowed[..., :hop]).astype(jnp.float32)
    if ch != 1:
        pcm = jnp.swapaxes(pcm, 1, 2)          # (T, hop, channels)

    new_carry = StepCarry(hues=hues_last, phases=phases_last,
                          prev_spectrum=prev_last,
                          ola_tail=windowed[-1],
                          running_max=running_max_last)
    out: Dict[str, Any] = {"pcm": pcm}
    if debug:
        out.update(hues=hues_seq, grads=grads_seq, spectrum=spectra)
    return new_carry, out


def blocked_pipeline(carry: StepCarry, frames, params: Dict[str, Any],
                     cfg: AuralizerConfig, consts: SynthConstants, window,
                     block: int = 8, debug: bool = False
                     ) -> Tuple[StepCarry, Dict[str, Any]]:
    """Sequential scan dispatched as BLOCKED sub-chunks: one device-side
    ``lax.scan`` whose body is ``chunk_pipeline`` over ``block`` frames.

    The per-frame scan path (runtime.step.frame_step under lax.scan) is
    scheduling-gap-bound — every frame's vision/synthesis/audio stages
    sit on one serial dependence chain of many small kernels.  Blocking
    re-uses the chunk pipeline's batched math (one contraction, one
    irfft, batched OLA for the whole block) at a fixed sub-chunk
    granularity while keeping the whole clip in ONE dispatch, so the
    marginal per-frame cost approaches the chunked pipeline's instead of
    the per-frame scan's.

    Semantics are those of T sequential frame_step calls: identical
    per-frame outputs up to the documented chunk-pipeline deviations
    (docs/PARITY.md — contraction reassociation <= 1e-5, cumsum-phase
    random walk when cfg.use_cumsum_phases).  ``T`` must be a multiple
    of ``block`` (callers split remainders; see run_offline_batched).
    """
    T = (frames["y"] if isinstance(frames, dict) else frames).shape[0]
    if T % block:
        raise ValueError(f"blocked_pipeline: T={T} not a multiple of "
                         f"block={block}")
    nb = T // block

    fb = jax.tree.map(
        lambda x: x.reshape((nb, block) + tuple(x.shape[1:])), frames)

    def body(c, fr):
        return chunk_pipeline(c, fr, params, cfg, consts, window,
                              debug=debug)

    carry, outs = jax.lax.scan(body, carry, fb)
    out = {k: v.reshape((T,) + tuple(v.shape[2:])) for k, v in outs.items()}
    return carry, out


def make_chunk_pipeline(cfg: AuralizerConfig, debug: bool = False,
                        jit: bool = True):
    """Build ``chunk_step(carry, frames[T, ...], params)`` with constants
    baked (the chunk-batched counterpart of runtime.make_step)."""
    consts = SynthConstants.create(cfg)
    window = jnp.asarray(hann_window_norm(cfg.nfft))

    def step(carry, frames, params):
        return chunk_pipeline(carry, frames, params, cfg, consts, window,
                              debug=debug)

    if jit:
        step = jax.jit(step, donate_argnums=(0,))
    return step


def run_offline_batched(frames, cfg: AuralizerConfig,
                        params: Dict[str, Any] | None = None,
                        carry: StepCarry | None = None,
                        chunk: int = 64, debug: bool = False):
    """Offline sonification through the chunk-batched pipeline.

    Splits the clip into ``chunk``-frame pieces (last piece runs through a
    separately-compiled remainder pipeline), carrying DSP state across
    pieces.  Same signature/returns as runtime.run_offline.
    """
    if params is None:
        params = default_params(cfg)
    if carry is None:
        carry = init_carry(cfg)
    else:
        # step() donates the carry; copy so the caller's arrays survive
        # (resume/retry/inspection) — see runtime.run_offline.
        carry = jax.tree.map(jnp.array, carry)
    frames = jax.tree.map(jnp.asarray, frames)
    T = (frames["y"] if isinstance(frames, dict) else frames).shape[0]

    consts = SynthConstants.create(cfg)
    window = jnp.asarray(hann_window_norm(cfg.nfft))

    @functools.partial(jax.jit, donate_argnums=(0,),
                       static_argnames=("dbg",))
    def step(carry, fr, params, dbg):
        return chunk_pipeline(carry, fr, params, cfg, consts, window,
                              debug=dbg)

    outs = []
    start = 0
    while start < T:
        end = min(start + chunk, T)
        piece = jax.tree.map(lambda x: x[start:end], frames)
        carry, out = step(carry, piece, params, debug)
        outs.append(out)
        start = end

    pcm = jnp.concatenate([o["pcm"] for o in outs], axis=0)
    if cfg.channels == 1:
        audio = pcm.reshape(-1)
    else:
        audio = pcm.reshape(-1, cfg.channels)
    dbg = {}
    if debug:
        for k in outs[0]:
            if k != "pcm":
                dbg[k] = jnp.concatenate([o[k] for o in outs], axis=0)
    return audio, carry, dbg
