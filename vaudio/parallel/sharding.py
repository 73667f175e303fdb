"""SPMD execution of the auralizer over device meshes.

Design (the scaling-book recipe): pick a mesh, annotate shardings, let XLA
insert collectives.

* ``'stream'`` axis — pure data parallelism.  Streams never communicate
  (SURVEY.md §5: the pipeline is embarrassingly parallel per stream), so
  the only traffic on this axis is the initial shard placement.
* ``'cell'`` axis — tensor parallelism inside the synthesis: each device
  computes the spectrum contribution of ``16/n`` synthesis cells and the
  full spectrum is reduced with a ``psum`` across devices.  The vision pass and
  post-psum DSP are replicated on this axis (they are ~1% of the FLOPs).

Note the quirk-compat phase layout makes per-cell phase reads *non-local*
(stride-22 reads cross the stride-32 cell boundaries —
SpectrumCompute.metal:135 vs SoundEngine.swift:269), so the 512-float phase
accumulator is replicated on the 'cell' axis and only the gather indices
are sharded.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vaudio.config import AuralizerConfig
from vaudio.dsp import hann_window_norm
from vaudio.runtime.step import StepCarry, frame_step, init_carry, \
    synth_audio
from vaudio.synth import SynthConstants, contract_spectrum, \
    finalize_spectrum, flatten_partials, live_pan_from_params, \
    partial_weights, phase_accumulate
from vaudio.vision import extract_features


def make_stream_mesh(n_stream: Optional[int] = None,
                     n_cell: int = 1,
                     devices=None) -> Mesh:
    """Build a ('stream', 'cell') mesh over the available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_stream is None:
        n_stream = devices.size // n_cell
    devices = devices.reshape(n_stream, n_cell)
    return Mesh(devices, ("stream", "cell"))


def init_carry_batch(cfg: AuralizerConfig, n_streams: int) -> StepCarry:
    """Batched carry: every leaf gains a leading stream axis."""
    one = init_carry(cfg)
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_streams,) + x.shape), one)


def make_batched_step(cfg: AuralizerConfig, debug: bool = False,
                      jit: bool = True):
    """vmap-across-streams step: (carry[S,...], frames[S,H,W,3], params) ->
    (carry, out).  The single-chip batch path (BASELINE config 5 building
    block)."""
    consts = SynthConstants.create(cfg)
    window = jnp.asarray(hann_window_norm(cfg.nfft))

    def one(carry, frame, params):
        return frame_step(carry, frame, params, cfg, consts, window,
                          debug=debug)

    step = jax.vmap(one, in_axes=(0, 0, None))
    if jit:
        step = jax.jit(step, donate_argnums=(0,))
    return step


# ---------------------------------------------------------------------------
# Tensor-parallel synthesis step
# ---------------------------------------------------------------------------

def _tp_frame_step(carry: StepCarry, frame, params, cfg: AuralizerConfig,
                   consts: SynthConstants, window, n_cell_shards: int,
                   debug: bool):
    """Single-stream frame step with the synthesis contraction sharded over
    the 'cell' mesh axis.  Runs inside shard_map.

    Feature-complete vs. the single-device step: stereo (pan gains are
    sliced per cell shard; the psum sums per-channel partial spectra) and
    enable_filters (applied post-psum in the shared finalize stage) both
    compose with the TP decomposition.
    """
    mixing = jnp.asarray(params["spectrum_mixing"], jnp.float32)

    # Vision + phase accumulation: replicated over 'cell' (~1% of FLOPs).
    hues, grads, _ = extract_features(frame, carry.hues, mixing, cfg)
    phases = phase_accumulate(carry.phases, hues, cfg, consts)

    local_cells = cfg.num_cells // n_cell_shards
    ci = jax.lax.axis_index("cell")
    start = ci * local_cells
    cell_slice = (start, local_cells)

    # Shared synthesis stages (vaudio.synth.spectrum), restricted to the
    # local cell range; the full-spectrum sum is ONE psum.
    pfreq, w_re, w_im, inv_bw = partial_weights(
        hues, grads, phases, cfg, consts, cell_slice=cell_slice)
    flat_pf, flat_w, flat_ibw = flatten_partials(
        pfreq, w_re, w_im, inv_bw, cfg, cell_slice=cell_slice,
        pan=live_pan_from_params(cfg, params))
    local = contract_spectrum(flat_pf, flat_w, flat_ibw, cfg, consts)

    cur = jax.lax.psum(local, "cell")                     # THE collective

    spectrum = finalize_spectrum(cur, carry.prev_spectrum, mixing, cfg,
                                 consts, filter_params=params)
    pcm, ola_tail, running_max = synth_audio(
        spectrum, carry.ola_tail, carry.running_max, params, cfg, window)

    new_carry = StepCarry(hues=hues, phases=phases, prev_spectrum=spectrum,
                          ola_tail=ola_tail, running_max=running_max)
    out = {"pcm": pcm}
    if debug:
        out.update(hues=hues, grads=grads, spectrum=spectrum)
    return new_carry, out


def make_parallel_step(cfg: AuralizerConfig, mesh: Mesh,
                       debug: bool = False, jit: bool = True):
    """Mesh-sharded multi-stream step.

    Layout: carries/frames sharded over 'stream', replicated over 'cell';
    synthesis cells sharded over 'cell' with a psum reduction.

    Returns ``step(carry[S,...], frames[S,H,W,3], params)``; S must be a
    multiple of mesh.shape['stream'].
    """
    n_cell = mesh.shape["cell"]
    if cfg.num_cells % n_cell:
        raise ValueError(
            f"num_cells {cfg.num_cells} not divisible by cell-axis size "
            f"{n_cell}")
    consts = SynthConstants.create(cfg)
    window = jnp.asarray(hann_window_norm(cfg.nfft))

    def one(carry, frame, params):
        return _tp_frame_step(carry, frame, params, cfg, consts, window,
                              n_cell, debug)

    vstep = jax.vmap(one, in_axes=(0, 0, None))

    sharded = jax.shard_map(
        vstep, mesh=mesh,
        in_specs=(P("stream"), P("stream"), P()),
        out_specs=(P("stream"), P("stream")),
        check_vma=False,
    )
    if jit:
        sharded = jax.jit(sharded, donate_argnums=(0,))
    return sharded


def make_parallel_chunk_step(cfg: AuralizerConfig, mesh: Mesh,
                             debug: bool = False, jit: bool = True):
    """DP-sharded chunk-batched step: streams sharded over 'stream', each
    shard running the chunk-batched pipeline (runtime.chunked — ONE
    frame-batched contraction per stream-chunk) on its local
    streams.  The highest-throughput multi-chip shape: embarrassingly
    parallel with zero collectives.

    Requires the mesh's 'cell' axis to be 1 — the batched contraction is
    not cell-sharded (use make_parallel_step for latency-oriented TP).

    Returns ``step(carry[S,...], frames[S, T, ...], params)`` ->
    (carry, out) with out["pcm"] of shape (S, T, hop[, channels]).
    """
    if mesh.shape.get("cell", 1) != 1:
        raise ValueError(
            "the chunk-batched parallel step is DP-only; build the mesh "
            f"with n_cell=1 (got cell={mesh.shape['cell']}) or use "
            "make_parallel_step for tensor parallelism")
    from vaudio.runtime.chunked import chunk_pipeline
    consts = SynthConstants.create(cfg)
    window = jnp.asarray(hann_window_norm(cfg.nfft))

    def one(carry, frames, params):
        return chunk_pipeline(carry, frames, params, cfg, consts, window,
                              debug=debug)

    vstep = jax.vmap(one, in_axes=(0, 0, None))
    sharded = jax.shard_map(
        vstep, mesh=mesh,
        in_specs=(P("stream"), P("stream"), P()),
        out_specs=(P("stream"), P("stream")),
        check_vma=False,
    )
    if jit:
        sharded = jax.jit(sharded, donate_argnums=(0,))
    return sharded


def make_engine_parallel_step(engine, mesh: Mesh, chunk: bool = False,
                              jit: bool = True):
    """DP-sharded mesh step for ANY streaming engine
    (:mod:`vaudio.runtime.engine`): carries/frames/outputs sharded over
    the 'stream' axis, params replicated — the model-agnostic
    counterpart of :func:`make_parallel_chunk_step`, built from the
    engine's raw per-frame (or per-chunk) step.  Embarrassingly
    parallel with zero collectives.

    No TP decomposition is assumed, so a 'cell' axis (if present) must
    be size 1 — cell-sharded synthesis is flagship-specific
    (:func:`make_parallel_step`).

    Returns ``step(carry[S,...], frames[S,...], params) -> (carry,
    out)`` with every out leaf carrying the leading stream axis; S must
    be a multiple of ``mesh.shape['stream']``.
    """
    if mesh.shape.get("cell", 1) != 1:
        raise ValueError(
            "engine mesh pods are DP-only ('stream' axis); a 'cell' "
            f"axis of {mesh.shape['cell']} is flagship-specific tensor "
            "parallelism (make_parallel_step)")
    one = engine.raw_chunk_step() if chunk else engine.raw_step()
    vstep = jax.vmap(one, in_axes=(0, 0, None))
    sharded = jax.shard_map(
        vstep, mesh=mesh,
        in_specs=(P("stream"), P("stream"), P()),
        out_specs=(P("stream"), P("stream")),
        check_vma=False,
    )
    if jit:
        sharded = jax.jit(sharded, donate_argnums=(0,))
    return sharded


def run_offline_parallel(frames, cfg: AuralizerConfig, mesh: Mesh,
                         params=None, debug: bool = False,
                         pipeline: str = "auto"):
    """Sonify a batch of clips over the mesh.

    Args:
      frames: f32[S, T, H, W, 3] — S streams of T frames.
      pipeline: ``"chunked"`` = the DP-only chunk-batched pipeline (one
        frame-batched contraction per stream — the throughput
        shape); ``"scan"`` = per-frame step under the full DP+TP mesh;
        ``"auto"`` picks chunked when the mesh has no cell axis to feed.
    Returns:
      (audio f32[S, T*hop] / f32[S, T*hop, ch], final carry, dbg) —
      matching :func:`vaudio.runtime.run_offline`; ``dbg`` holds the
      per-frame hues/grads/spectrum stacks when ``debug=True`` (leading
      axes (S, T, ...)), else is empty.
    """
    from vaudio.runtime.step import default_params
    if params is None:
        params = default_params(cfg)
    frames = jnp.asarray(frames)
    n_streams = frames.shape[0]
    carry = init_carry_batch(cfg, n_streams)
    if pipeline not in ("auto", "chunked", "scan"):
        raise ValueError(f"unknown pipeline {pipeline!r}")
    if pipeline == "auto":
        pipeline = "chunked" if mesh.shape.get("cell", 1) == 1 else "scan"

    stream_sharding = NamedSharding(mesh, P("stream"))
    frames = jax.device_put(
        frames, NamedSharding(mesh, P("stream", None, None, None, None)))
    carry = jax.device_put(
        carry, jax.tree.map(lambda _: stream_sharding, carry))

    if pipeline == "chunked":
        step = make_parallel_chunk_step(cfg, mesh, debug=debug)
        final, outs = step(carry, frames, params)
    else:
        step = make_parallel_step(cfg, mesh, debug=debug, jit=False)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def scan_fn(carry, frames, params):
            def body(c, fr):   # fr: (S, H, W, 3)
                return step(c, fr, params)
            return jax.lax.scan(body, carry, jnp.swapaxes(frames, 0, 1))

        final, outs = scan_fn(carry, frames, params)
    pcm = outs["pcm"]
    dbg = {k: v for k, v in outs.items() if k != "pcm"}
    if pipeline == "scan":        # (T, S, ...) -> (S, T, ...)
        pcm = jnp.swapaxes(pcm, 0, 1)
        dbg = {k: jnp.swapaxes(v, 0, 1) for k, v in dbg.items()}
    if cfg.channels == 1:
        audio = pcm.reshape(n_streams, -1)
    else:
        audio = pcm.reshape(n_streams, -1, cfg.channels)
    return audio, final, dbg
