"""The single fused frame->audio device step and the offline scan runner.

Reference behavior being re-expressed (SURVEY.md §3.3): one camera frame
enters, one 2048-sample audio hop leaves, and five pieces of recurrent DSP
state are carried between frames — the 16 smoothed hues, the 16x32 phase
accumulators, the previous complex spectrum, the overlap-add tail and the
AGC running max (SoundEngine.swift:63-103,137).  The reference threads this
state through GPU completion handlers and locks; here it is an explicit
functional carry, so the whole pipeline jits into one XLA program and scans
over frames with zero host round-trips.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from vaudio.config import AuralizerConfig, LiveParams
from vaudio.dsp import agc_normalize, hann_window_norm, irfft_from_half, \
    overlap_add
from vaudio.synth import SynthConstants, build_spectrum, phase_accumulate
from vaudio.vision import extract_features


class StepCarry(NamedTuple):
    """The recurrent DSP state (one audio stream)."""

    hues: jax.Array          # i32[16]   — EMA-smoothed dominant hues
    phases: jax.Array        # f32[16,32] — partial phase accumulators
    prev_spectrum: jax.Array  # f32[F,2]  — last frame's complex spectrum
    ola_tail: jax.Array      # f32[nfft] — previous windowed frame
    running_max: jax.Array   # f32[]     — AGC envelope


def init_carry(cfg: AuralizerConfig) -> StepCarry:
    """Initial state, matching the reference's cold start: hues all 0
    (VisionEngine.swift:33), phases/spectrum/tail zero, running max 1.0
    (SoundEngine.swift:73)."""
    spec_shape = (cfg.num_bins, 2) if cfg.channels == 1 \
        else (cfg.channels, cfg.num_bins, 2)
    tail_shape = (cfg.nfft,) if cfg.channels == 1 \
        else (cfg.channels, cfg.nfft)
    return StepCarry(
        hues=jnp.zeros((cfg.num_cells,), jnp.int32),
        phases=jnp.zeros((cfg.num_cells, cfg.phase_stride), jnp.float32),
        prev_spectrum=jnp.zeros(spec_shape, jnp.float32),
        ola_tail=jnp.zeros(tail_shape, jnp.float32),
        running_max=jnp.float32(1.0),
    )


def default_params(cfg: AuralizerConfig) -> Dict[str, np.float32]:
    return LiveParams().as_arrays()


def synth_audio(spectrum, ola_tail, running_max, params: Dict[str, Any],
                cfg: AuralizerConfig, window):
    """The audio tail of the frame step: irfft -> AGC -> overlap-add
    (SoundEngine.swift:403-428).  Shared by the single-device and
    tensor-parallel steps.

    Stereo (cfg.channels == 2): channel-batched irfft with a SHARED
    AGC/OLA gain so the stereo image is preserved; pcm comes back
    interleaved as (hop, channels).

    Returns (pcm, new_ola_tail, new_running_max).
    """
    if cfg.use_matmul_irfft:
        # Dense path (dsp.irfft_from_half_dense): batched over any leading
        # dims, so mono (F, 2) and stereo (ch, F, 2) need no vmap.
        from vaudio.dsp import irfft_from_half_dense
        signal = irfft_from_half_dense(spectrum[..., 0], spectrum[..., 1])
    elif cfg.channels == 1:
        signal = irfft_from_half(spectrum[:, 0], spectrum[:, 1])
    else:
        signal = jax.vmap(
            lambda sp: irfft_from_half(sp[:, 0], sp[:, 1]))(spectrum)
    attack = jnp.asarray(params["attack"], jnp.float32)
    release = jnp.asarray(params["release"], jnp.float32)
    normalized, new_max = agc_normalize(signal, running_max, attack, release)
    pcm, new_tail = overlap_add(normalized, ola_tail, window)
    if cfg.channels != 1:
        pcm = pcm.T                         # (hop, channels) interleaved
    return pcm, new_tail, new_max


def frame_step(carry: StepCarry, frame, params: Dict[str, Any],
               cfg: AuralizerConfig, consts: SynthConstants, window,
               debug: bool = False) -> Tuple[StepCarry, Dict[str, Any]]:
    """One video frame in, one audio hop out.  Pure; jit/scan/vmap-safe.

    Pipeline (all device-resident):
      1. vision: mip pyramid -> HSI -> histogram/argmax/EMA + grad stats
         (VisionEngine.swift:184-316)
      2. phase accumulation (SoundEngine.swift:257-286)
      3. spectrum synthesis + temporal smoothing
         (SpectrumCompute.metal:82-214)
      4. irfft -> AGC -> overlap-add (SoundEngine.swift:403-428)

    Args:
      frame: f32[H, W, 3] RGB in [0,1], u8[H, W, 3] RGB (normalized on
        device), or a ``{"y", "u", "v"}`` dict of planar uint8 YUV 4:2:0.
      params: dict of f32 scalars (LiveParams.as_arrays()).
    Returns:
      (new_carry, out) with out["pcm"]: f32[hop] audio samples; when
      ``debug`` also hues/grads/spectrum (the reference's published
      debug state: cellMaxHues, cellAvgGrads, previousSpectrum).
    """
    mixing = jnp.asarray(params["spectrum_mixing"], jnp.float32)

    # Camera-native uint8 frames pass through unchanged — ingest ships
    # 1 byte/channel over PCIe instead of 4 (the reference's camera path
    # is 8-bit BGRA too, VisionEngine.swift:62-64) and the vision layer
    # folds the 1/255 normalization into its pooling matmul.

    # 1. Vision
    hues, grads, _vdbg = extract_features(frame, carry.hues, mixing, cfg)

    # 2. Phase accumulation (uses the *new* hues, as the delegate hands the
    #    updated values straight to renderAudioFrame).
    phases = phase_accumulate(carry.phases, hues, cfg, consts)

    # 3. Spectrum
    spectrum = build_spectrum(hues, grads, phases, carry.prev_spectrum,
                              mixing, cfg, consts, filter_params=params)

    # 4. Audio frame
    pcm, ola_tail, running_max = synth_audio(
        spectrum, carry.ola_tail, carry.running_max, params, cfg, window)

    new_carry = StepCarry(hues=hues, phases=phases, prev_spectrum=spectrum,
                          ola_tail=ola_tail, running_max=running_max)
    out: Dict[str, Any] = {"pcm": pcm}
    if debug:
        out.update(hues=hues, grads=grads, spectrum=spectrum)
    return new_carry, out


def make_step(cfg: AuralizerConfig, debug: bool = False,
              jit: bool = True):
    """Build the (optionally jitted) single-frame step closure.

    Returns ``step(carry, frame, params) -> (carry, out)`` with all config
    constants baked.  The carry is donated under jit so state updates reuse
    device buffers (no per-frame reallocation).
    """
    consts = SynthConstants.create(cfg)
    window = jnp.asarray(hann_window_norm(cfg.nfft))

    def step(carry, frame, params):
        return frame_step(carry, frame, params, cfg, consts, window,
                          debug=debug)

    if jit:
        step = jax.jit(step, donate_argnums=(0,))
    return step


def run_offline(frames, cfg: AuralizerConfig,
                params: Dict[str, Any] | None = None,
                carry: StepCarry | None = None, debug: bool = False,
                unroll: int = 1, block: int = 1):
    """Sonify a whole decoded clip with one ``lax.scan``.

    The offline analogue of the 30 Hz streaming loop: every frame emits a
    full ``hop_size`` of samples (the real-time sink's drop-on-full
    behavior is a property of the *sink*, not the synthesis — see
    vaudio.runtime.stream for the live-contract version).

    Args:
      frames: f32[T, H, W, 3] RGB video tensor in [0,1].
      unroll: lax.scan unroll factor; >1 lets XLA overlap kernels across
        frames at the cost of longer compiles (not measured on the
        H100).  Default 1 keeps CPU test compiles cheap; production
        streaming uses the chunked pipeline (runtime.chunked), which
        owns its own unrolling.
      block: >1 dispatches the scan as BLOCKED SUB-CHUNKS — one
        device-side lax.scan whose body is the chunk pipeline over
        ``block`` frames (runtime.chunked.blocked_pipeline; any
        remainder runs through one extra chunk_pipeline call) — the
        whole-clip deployment shape with the fewest per-frame
        scheduling gaps.  Semantics match the per-frame
        scan up to the documented chunk-pipeline band (docs/PARITY.md);
        ``debug`` outputs stay per-frame.  Mutually exclusive with
        ``unroll`` > 1.
    Returns:
      (audio f32[T*hop], final_carry, debug_dict) — debug_dict has stacked
      per-frame hues/grads/spectra when ``debug``.
    """
    if block > 1 and unroll > 1:
        raise ValueError("run_offline: block and unroll are mutually "
                         "exclusive (blocking replaces the unrolled "
                         "per-frame scan)")
    if params is None:
        params = default_params(cfg)
    if carry is None:
        carry = init_carry(cfg)
    else:
        # The scan donates the carry (donate_argnums); copy so the
        # CALLER's arrays are not deleted out from under them (resume
        # from a checkpoint, retry, post-run inspection).
        carry = jax.tree.map(jnp.array, carry)
    if not isinstance(frames, dict):
        # Stack list-of-frames input HERE and keep the stacked array:
        # passing the original list on would make jax.tree.map treat it
        # as a pytree of T leaves and lax.scan would scan each frame's
        # H axis instead of the frame axis.
        frames = (np.asarray(frames) if not hasattr(frames, "shape")
                  else frames)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(
                f"run_offline expects frames [T, H, W, 3] (or a YUV dict); "
                f"got shape {getattr(frames, 'shape', None)}")
    consts = SynthConstants.create(cfg)
    window = jnp.asarray(hann_window_norm(cfg.nfft))

    frames = jax.tree.map(jnp.asarray, frames)
    T = (frames["y"] if isinstance(frames, dict) else frames).shape[0]
    if block > 1 and T >= block:
        from vaudio.runtime.chunked import blocked_pipeline, \
            chunk_pipeline
        main = T - T % block

        @functools.partial(jax.jit, donate_argnums=(0,))
        def blocked_fn(carry, frames, params):
            return blocked_pipeline(carry, frames, params, cfg, consts,
                                    window, block=block, debug=debug)

        head = jax.tree.map(lambda x: x[:main], frames)
        final_carry, outs = blocked_fn(carry, head, params)
        if T > main:                       # remainder: one small chunk
            tail = jax.tree.map(lambda x: x[main:], frames)
            final_carry, touts = jax.jit(
                lambda c, f, p: chunk_pipeline(c, f, p, cfg, consts,
                                               window, debug=debug)
            )(final_carry, tail, params)
            outs = {k: jnp.concatenate([outs[k], touts[k]], axis=0)
                    for k in outs} if debug else \
                {"pcm": jnp.concatenate([outs["pcm"], touts["pcm"]],
                                        axis=0)}
    else:
        @functools.partial(jax.jit, donate_argnums=(0,))
        def scan_fn(carry, frames, params):
            def body(c, frame):
                return frame_step(c, frame, params, cfg, consts, window,
                                  debug=debug)
            return jax.lax.scan(body, carry, frames, unroll=unroll)

        final_carry, outs = scan_fn(carry, frames, params)
    if cfg.channels == 1:
        audio = outs["pcm"].reshape(-1)
    else:
        audio = outs["pcm"].reshape(-1, cfg.channels)
    dbg = {k: v for k, v in outs.items() if k != "pcm"}
    return audio, final_carry, dbg
