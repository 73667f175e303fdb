"""Streaming-engine adapters: pluggable model families at the live
front doors.

:class:`~vaudio.runtime.stream.StreamingAuralizer` owns the host loop
(producer thread, pacing, ring buffer, metrics, control channel, HTTP
panel, checkpoints) — none of which is specific to the flagship model.
An *engine* supplies the parts that are: the jitted per-frame and
per-chunk step functions, carry construction, and the mapping from the
shared :class:`~vaudio.config.LiveParams` to the model's traced
parameter pytree.

Two engines ship:

* :class:`AuralizerEngine` — the flagship 16-cell model (the default;
  the reference's shipped design, VideoToAudio.swift + SoundEngine.swift).
* :class:`OrthoModesEngine` — the per-pixel A/Q/f0 family
  (models/orthomodes.py, the reference's abandoned
  ``computeOrthogonalModesFromTexture`` design completed, SURVEY.md
  §2.9).  Mono, RGB-only, carry sized by the incoming frame; attack /
  release / spectrum_mixing are live, the stereo/filter params have no
  per-pixel equivalent.

The contract (duck-typed):

* ``make_step() -> step(carry, frame, params) -> (carry, out)`` with
  ``out["pcm"]`` one hop of samples; extra ``out`` keys become the
  debug surface.
* ``make_chunk_step() -> step(carry, frames[N], params) -> (carry,
  out)`` with ``out["pcm"]`` shaped ``[N, hop]``.
* ``carry_static`` — True when the carry shape is frame-independent
  (built eagerly); False defers to ``init_carry(frame)`` at the first
  dispatch (and re-initializes on a mid-stream resolution change).
* ``params_arrays(live) -> pytree`` re-read every dispatch (traced
  values: mutations never recompile).
* ``load_carry(path_or_file) -> carry`` for checkpoint resume.
* ``frame_error(frame, cfg) -> Optional[str]`` — the network-ingest
  door's validation (what this engine can actually trace).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from vaudio.config import AuralizerConfig, LiveParams


class AuralizerEngine:
    """The flagship model family (default engine)."""

    name = "auralizer"
    carry_static = True

    def __init__(self, cfg: AuralizerConfig, debug: bool = False):
        self.cfg = cfg
        self.debug = debug

    def make_step(self):
        from vaudio.runtime.step import make_step
        return make_step(self.cfg, debug=self.debug)

    def make_chunk_step(self):
        from vaudio.runtime.chunked import make_chunk_pipeline
        return make_chunk_pipeline(self.cfg, debug=self.debug)

    def raw_step(self):
        """Unjitted ``step(carry, frame, params)`` — what the pod vmaps
        over its stream axis."""
        from vaudio.dsp import hann_window_norm
        from vaudio.runtime.step import frame_step
        from vaudio.synth import SynthConstants
        consts = SynthConstants.create(self.cfg)
        window = jnp.asarray(hann_window_norm(self.cfg.nfft))

        def step(carry, frame, params):
            return frame_step(carry, frame, params, self.cfg, consts,
                              window, debug=self.debug)
        return step

    def raw_chunk_step(self):
        """Unjitted ``step(carry, frames[N], params)`` per stream — the
        chunk-batched pipeline for the flagship."""
        from vaudio.dsp import hann_window_norm
        from vaudio.runtime.chunked import chunk_pipeline
        from vaudio.synth import SynthConstants
        consts = SynthConstants.create(self.cfg)
        window = jnp.asarray(hann_window_norm(self.cfg.nfft))

        def step(carry, frames, params):
            return chunk_pipeline(carry, frames, params, self.cfg,
                                  consts, window)
        return step

    def init_carry(self, frame=None):
        from vaudio.runtime.step import init_carry
        return init_carry(self.cfg)

    def init_carry_batch(self, n: int, frame=None):
        from vaudio.parallel.sharding import init_carry_batch
        return init_carry_batch(self.cfg, n)

    def params_arrays(self, live: LiveParams):
        return live.as_arrays()

    def load_carry(self, path):
        from vaudio.runtime.checkpoint import load_state
        return load_state(path, self.cfg)

    def load_carry_batch(self, path, n: int):
        from vaudio.runtime.checkpoint import load_state
        return load_state(path, self.cfg, n_streams=n)

    def frame_error(self, frame, cfg=None) -> Optional[str]:
        from vaudio.runtime.server import frame_structure_error
        return frame_structure_error(frame, cfg or self.cfg)

    def carry_mismatch(self, carry, frame) -> Optional[str]:
        """The flagship carry is frame-independent — nothing to check."""
        return None


class OrthoModesEngine:
    """The per-pixel OrthoModes family behind the same streaming loop.

    Wraps :class:`vaudio.models.OrthoModesModel` into the engine
    contract: the carry (one phase per mip pixel) is sized by the first
    frame, the chunk step is a ``lax.scan`` over the frame axis (one
    dispatch per chunk), and LiveParams maps to the
    model's ``{mode multipliers, spectrum_mixing, attack, release}``.
    The model is mono and RGB-only (computeOrthogonalModes.metal
    predates the planar-YUV path)."""

    name = "orthomodes"
    carry_static = False

    def __init__(self, cfg: AuralizerConfig, debug: bool = False,
                 model_cfg=None, multipliers=None):
        import dataclasses
        from vaudio.models import OrthoModesConfig, OrthoModesModel
        if cfg.channels != 1:
            cfg = dataclasses.replace(cfg, channels=1)
        if cfg.enable_filters:
            cfg = dataclasses.replace(cfg, enable_filters=False)
        self.cfg = cfg
        self.debug = debug
        if model_cfg is None:
            model_cfg = OrthoModesConfig(audio=cfg)
        self.model = OrthoModesModel(model_cfg, multipliers=multipliers)
        from vaudio.dsp import hann_window_norm
        self._window = jnp.asarray(hann_window_norm(cfg.nfft))

    # -- step functions ------------------------------------------------------

    def _raw_step(self, carry, frame, params):
        carry, pcm = self.model.frame_step(carry, frame, params,
                                           self._window)
        out = {"pcm": pcm}
        if self.debug:
            # The per-pixel family has no cell hues/gradients; the
            # spectrum and waveform views still render live.
            out["spectrum"] = carry.prev_spectrum
        return carry, out

    def make_step(self):
        return jax.jit(self._raw_step, donate_argnums=(0,))

    def raw_step(self):
        return self._raw_step

    def _raw_chunk(self, carry, frames, params):
        def body(c, f):
            return self._raw_step(c, f, params)
        return jax.lax.scan(body, carry, frames)

    def make_chunk_step(self):
        return jax.jit(self._raw_chunk, donate_argnums=(0,))

    def raw_chunk_step(self):
        return self._raw_chunk

    # -- carry ---------------------------------------------------------------

    def init_carry(self, frame):
        if frame is None:
            raise ValueError(
                "the OrthoModes carry is sized by the frame (one "
                "oscillator per mip pixel) — no frames seen yet")
        h, w = (np.asarray(frame).shape[:2] if not isinstance(frame, dict)
                else np.asarray(frame["y"]).shape)
        return self.model.init_carry(self.model.num_oscillators(h, w))

    def init_carry_batch(self, n: int, frame=None):
        from vaudio.models.orthomodes import OrthoCarry
        base = self.init_carry(frame)
        return OrthoCarry(*(jnp.tile(x, (n,) + (1,) * np.ndim(x))
                            if np.ndim(x) else jnp.full((n,), x)
                            for x in base))

    def params_arrays(self, live: LiveParams):
        return {**self.model.multipliers.as_arrays(),
                "spectrum_mixing": np.float32(live.spectrum_mixing),
                "attack": np.float32(live.attack),
                "release": np.float32(live.release)}

    def _load(self, path, expect_spectrum, what):
        from vaudio.models.orthomodes import OrthoCarry
        from vaudio.runtime.checkpoint import carry_type_of
        data = np.load(path)
        kind = carry_type_of(data)
        if kind != "OrthoCarry":
            raise ValueError(
                f"checkpoint holds a {kind or 'flagship StepCarry'} "
                "carry, not the OrthoModes per-pixel carry — saved by "
                "another model family?")
        missing = set(OrthoCarry._fields) - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint is missing OrthoModes carry fields "
                f"{sorted(missing)} — a flagship-model checkpoint?")
        if tuple(data["prev_spectrum"].shape) != expect_spectrum:
            raise ValueError(
                f"checkpoint prev_spectrum shape "
                f"{data['prev_spectrum'].shape}, expected "
                f"{expect_spectrum} — {what}?")
        return OrthoCarry(**{f: jnp.asarray(data[f])
                             for f in OrthoCarry._fields})

    def load_carry(self, path):
        return self._load(path, (self.cfg.num_bins, 2),
                          "wrong AuralizerConfig")

    def load_carry_batch(self, path, n: int):
        return self._load(path, (n, self.cfg.num_bins, 2),
                          "wrong pod size or model config")

    def frame_error(self, frame, cfg=None) -> Optional[str]:
        from vaudio.runtime.server import frame_structure_error
        if isinstance(frame, dict):
            return ("the OrthoModes family is RGB-only (the reference "
                    "kernel predates the planar-YUV path); send "
                    "(H, W, 3) frames")
        err = frame_structure_error(frame, None)
        if err is not None:
            return err
        h, w = np.asanyarray(frame).shape[:2]
        level = self.model.cfg.mip_level
        if (h >> level) < 1 or (w >> level) < 1:
            return (f"frame {h}x{w} is too small for the level-{level} "
                    "per-pixel mip (no oscillators left)")
        return None

    def carry_mismatch(self, carry, frame) -> Optional[str]:
        """Checkpoint shapes are resolution-dependent (one oscillator
        per mip pixel) but a restore happens before any frame is seen —
        so the first dispatch validates the restored carry against the
        actual frame, giving a clear error instead of an opaque
        broadcast failure inside the jitted step."""
        h, w = (np.asanyarray(frame).shape[:2]
                if not isinstance(frame, dict)
                else np.asanyarray(frame["y"]).shape)
        need = self.model.num_oscillators(h, w)
        got = int(np.shape(carry.phases)[-1])
        if got != need:
            return (f"restored OrthoModes carry holds {got} oscillators "
                    f"but {h}x{w} frames at mip level "
                    f"{self.model.cfg.mip_level} need {need} — "
                    "checkpoint from a different input resolution?")
        return None


def make_engine(model: str, cfg: AuralizerConfig, debug: bool = False):
    """Engine factory by family name (the CLI's ``--model`` values)."""
    if model in (None, "auralizer"):
        return AuralizerEngine(cfg, debug=debug)
    if model == "orthomodes":
        return OrthoModesEngine(cfg, debug=debug)
    raise ValueError(f"unknown model family {model!r} "
                     "(auralizer, orthomodes)")
