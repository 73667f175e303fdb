"""Public API — the equivalent of the reference's orchestrator + published
surface (video-auralizer/VideoToAudio.swift:9-127 and the ``@Published``
state of both engines).

Mapping to the Swift surface:

=====================================  ====================================
reference                              vaudio
=====================================  ====================================
``VideoToAudio(source:)``              :class:`Auralizer` (init)
``toggleProcessing()``                 :meth:`Auralizer.toggle`
``visionEngine`` / ``soundEngine``     fused into one device step
AVAudioSourceNode pull callback        :meth:`Auralizer.pull` /
                                       :meth:`Auralizer.audio_stream`
``@Published`` params (attack, ...)    :attr:`Auralizer.params` (live)
``processingLatency``                  :attr:`Auralizer.metrics`
ConvolutionDebugView data feeds        :attr:`Auralizer.debug`
TutorialView synthetic input           :func:`vaudio.io.hsb_frames`
=====================================  ====================================
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Optional, Union

import numpy as np

from vaudio.config import AuralizerConfig, LiveParams
from vaudio.io import ArraySource, write_wav
from vaudio.runtime import run_offline
from vaudio.runtime.stream import StreamingAuralizer

# A source is: a [T,H,W,3] tensor, a bare iterable of frames, or any
# object exposing .frames() (ArraySource, RawVideoSource, VideoFileSource,
# Cv2CameraSource, user-defined).
SourceLike = Union[ArraySource, np.ndarray, Iterable[np.ndarray], None]


class Auralizer:
    """Video -> audio sonification engine (the framework's front door).

    Offline::

        aur = Auralizer()
        audio = aur.sonify(frames)           # f32[T*hop] PCM
        aur.sonify_to_wav(frames, "out.wav")

    Streaming::

        aur = Auralizer(source=my_frames, realtime=True)
        aur.start()
        pcm = aur.pull(512)                  # audio-callback style
        aur.stop()

    ``chunk_frames > 1`` selects the chunk-batched streaming pipeline
    (one device dispatch per N frames — the throughput shape, at the
    cost of N-1 frame times of buffering); ``metrics_log`` appends one
    JSONL record per processed frame for offline analysis.  Both
    forward to :class:`vaudio.runtime.StreamingAuralizer`.
    """

    def __init__(self, source: SourceLike = None,
                 config: AuralizerConfig = AuralizerConfig(),
                 params: Optional[LiveParams] = None,
                 realtime: bool = False,
                 debug: bool = True,
                 prefer_native: bool = True,
                 sink_latency_ms: Optional[float] = None,
                 chunk_frames: int = 1,
                 metrics_log: Optional[str] = None,
                 model: str = "auralizer",
                 pipeline_depth: int = 4):
        from vaudio.runtime.engine import make_engine
        self._engine = make_engine(model, config, debug=debug)
        # The engine owns any config coercion (the per-pixel family is
        # mono and unfiltered); adopt its view so the ring/PCM plumbing
        # agrees (the CLI warns about this, cli._warn_orthomodes).
        config = self._engine.cfg
        self.model = model
        self.config = config
        self.params = params if params is not None else LiveParams()
        self._source = source
        #: The live :class:`vaudio.io.PushSource` when the stream's
        #: source is push-model (set by :meth:`start`); the LiveServer's
        #: ``POST /frames`` network-ingest door routes here.
        self.push_source = None
        self._stream = StreamingAuralizer(
            config, params=self.params, realtime=realtime,
            prefer_native=prefer_native, debug=debug,
            sink_latency_ms=sink_latency_ms,
            chunk_frames=chunk_frames, metrics_log=metrics_log,
            engine=self._engine, pipeline_depth=pipeline_depth)

    # ------------------------------------------------------------------
    # Offline
    # ------------------------------------------------------------------

    def sonify(self, frames: Union[np.ndarray, ArraySource, Dict[str, Any]],
               debug: bool = False, mode: str = "auto"):
        """Sonify a whole decoded clip.  Returns PCM f32[T*hop]; with
        ``debug`` returns (pcm, debug_dict).

        ``frames`` may be a [T,H,W,3] RGB tensor (f32 in [0,1] or uint8),
        an :class:`ArraySource`, or a ``{"y", "u", "v"}`` dict of planar
        uint8 YUV 4:2:0 tensors (each [T, ...]) for the device-side
        conversion path.

        ``mode``: ``"chunked"`` = the chunk-batched pipeline (ONE frame-
        batched XLA contraction for the synthesis stage; audio equal to
        the scan path within the documented band — runtime.chunked);
        ``"scan"`` = the per-frame lax.scan; ``"auto"`` (default) picks
        chunked for clips of >= 8 frames."""
        if isinstance(frames, ArraySource):
            frames = frames.tensor()
        if not isinstance(frames, dict):
            frames = np.asarray(frames)
        if self.model == "orthomodes":
            if debug:
                raise ValueError("the OrthoModes family has no cell "
                                 "debug surface (per-pixel model); "
                                 "sonify with debug=False")
            if isinstance(frames, dict):
                raise ValueError("the OrthoModes family is RGB-only")
            return self._engine.model.sonify(
                frames, self._engine.params_arrays(self.params))
        if mode not in ("auto", "chunked", "scan"):
            raise ValueError(f"unknown sonify mode {mode!r} "
                             f"(expected auto, chunked or scan)")
        n = (frames["y"] if isinstance(frames, dict) else frames).shape[0]
        if mode == "auto":
            mode = "chunked" if n >= 8 else "scan"
        if mode == "chunked":
            from vaudio.runtime import run_offline_batched
            audio, _carry, dbg = run_offline_batched(
                frames, self.config, self.params.as_arrays(), debug=debug)
        else:
            audio, _carry, dbg = run_offline(frames, self.config,
                                             self.params.as_arrays(),
                                             debug=debug)
        audio = np.asarray(audio)
        return (audio, {k: np.asarray(v) for k, v in dbg.items()}) \
            if debug else audio

    def sonify_to_wav(self, frames, path: str) -> np.ndarray:
        audio = self.sonify(frames)
        write_wav(path, audio, self.config.sample_rate,
                  channels=self.config.channels)
        return audio

    # ------------------------------------------------------------------
    # Streaming (toggleProcessing equivalents)
    # ------------------------------------------------------------------

    def _frame_iter(self, source: SourceLike) -> Iterable[np.ndarray]:
        if source is None:
            raise ValueError("no frame source provided")
        from vaudio.io.push import PushSource
        ps = source if isinstance(source, PushSource) else None
        if ps is not None and ps.when_empty != "block":
            # hold/dark yield None idle ticks — a pod concept (the pod
            # advances slots in lockstep); the single-stream producer
            # has its own thread and should simply block on arrival.
            raise ValueError(
                "a single-stream push source must use "
                "when_empty='block' (hold/dark idle ticks are pod "
                "semantics)")
        # Install only a VALIDATED source: a rejected one must not leave
        # the LiveServer's /frames door queueing into a dead queue.
        self.push_source = ps
        # Flush-on-idle: when the push queue is empty the producer is
        # about to block indefinitely in PushSource.frames(), so the
        # depth-1 dispatch pipeline must not withhold the LAST pushed
        # frame's audio until the next push arrives.
        self._stream.idle_probe = (
            (lambda: ps.fill == 0) if ps is not None else None)
        if isinstance(source, np.ndarray):
            return ArraySource(source).frames()
        # Any source object (ArraySource, RawVideoSource, VideoFileSource,
        # Cv2CameraSource, user-defined) exposes .frames(); a bare
        # iterable of frames is accepted as-is.
        frames = getattr(source, "frames", None)
        if callable(frames):
            return frames()
        return source

    def start(self, source: SourceLike = None) -> None:
        if source is None:
            source = self._source
        self._stream.start(self._frame_iter(source))

    def stop(self) -> None:
        if self.push_source is not None:
            # Wake a producer blocked in PushSource.frames()'s
            # condition wait — _stop_event alone is only checked
            # between frames, so stop() would otherwise burn the full
            # join timeout and leave a zombie thread.
            self.push_source.close()
        self._stream.stop()

    def toggle(self, source: SourceLike = None) -> None:
        if self.is_running:
            self.stop()
        else:
            self.start(source)

    def run_until_exhausted(self, source: SourceLike = None,
                            timeout: float = 120.0) -> None:
        if source is None:
            source = self._source
        self._stream.run_until_exhausted(self._frame_iter(source),
                                         timeout=timeout)

    @property
    def is_running(self) -> bool:
        return self._stream.is_running

    def attach_control(self, path_or_file, **kwargs):
        """Attach a JSON-lines live-parameter control channel (FIFO, file,
        or open file object): each line is a JSON object of LiveParams
        updates applied mid-stream without recompilation — the equivalent
        of the reference's control-panel sliders mutating ``@Published``
        params while processing runs (ControlPanelView.swift:11-43,
        ExtraControlView.swift:10-52).  Returns the started
        :class:`~vaudio.runtime.control.ControlChannel` (stopped
        automatically by :meth:`stop`)."""
        return self._stream.attach_control(path_or_file, **kwargs)

    def live_debug(self, out_dir: str, every_frames: int = 30,
                   full_heatmaps: bool = False):
        """Start a live-refreshing debug surface: PNGs + an auto-refresh
        ``index.html`` re-rendered every ``every_frames`` processed frames
        while the stream runs (the TimelineView(.animation) equivalent;
        vaudio.runtime.control.LiveDebugRenderer).  The stream must be
        constructed with ``debug=True``.  Returns the started renderer
        (call ``.stop()`` when done)."""
        from vaudio.runtime.control import LiveDebugRenderer
        if not self._stream.debug:
            raise ValueError("live_debug requires debug=True on this "
                             "Auralizer (the stream publishes no debug "
                             "state otherwise)")
        return LiveDebugRenderer(self, out_dir, every_frames=every_frames,
                                 full_heatmaps=full_heatmaps).start()

    def pull(self, n: int) -> np.ndarray:
        """Pull PCM — the AVAudioSourceNode render-callback equivalent."""
        return self._stream.pull(n)

    def audio_stream(self, quantum: int = 512,
                     pace: Optional[bool] = None) -> Iterator[np.ndarray]:
        return self._stream.audio_stream(quantum, pace=pace)

    def serve(self, port: int = 0, host: str = "127.0.0.1",
              refresh_ms: int = 500, token: Optional[str] = None):
        """Start the live HTTP control panel + observability server — the
        browser equivalent of the reference's SwiftUI surface: sliders
        mutating live params mid-run (ControlPanelView.swift:11-43,
        ExtraControlView.swift:10-52), continuously-refreshing hue/
        spectrum/waveform views (SpectrumView.swift:18,
        DebuggingView.swift:37-93), and a live ``/audio.wav`` stream a
        browser ``<audio>`` element can play (the AVAudioSourceNode pull,
        SoundEngine.swift:156-228).  Non-blocking; returns the started
        :class:`~vaudio.runtime.server.LiveServer` (``.url``, ``.stop()``).
        ``port=0`` binds an ephemeral port.  Views need ``debug=True``."""
        from vaudio.runtime.server import LiveServer
        return LiveServer(self, host=host, port=port,
                          refresh_ms=refresh_ms, token=token).start()

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    @property
    def metrics(self) -> Dict[str, Any]:
        """Latency / throughput / buffer metrics (the processingLatency +
        availableFrames surface, SoundEngine.swift:430-445,477-484)."""
        m = self._stream.metrics
        ring = self._stream.ring
        hw = self._stream.sink_latency_ms
        return {
            "processing_latency_ms": m.processing_latency_ms,
            "latency_p50_ms": m.latency_percentile(50),
            "latency_p99_ms": m.latency_percentile(99),
            # The reference's processingLatency includes the hardware
            # output chain (SoundEngine.swift:477-484); total = the same
            # quantity here.
            "hardware_latency_ms": hw,
            "total_latency_p50_ms": m.latency_percentile(50) + hw,
            "achieved_fps": m.achieved_fps,
            "frames_processed": m.frames_processed,
            "dispatches": m.dispatches,
            "resolution_changes": m.resolution_changes,
            "buffer_fill": ring.available,
            "warmed_up": bool(getattr(ring, "warmed_up", True)),
            "dropped_frames": getattr(ring, "dropped_frames", 0),
            "underrun_samples": getattr(ring, "underrun_samples", 0),
        }

    def frame_error(self, frame) -> Optional[str]:
        """Engine-aware frame validation for the network-ingest door:
        an error message when this stream's model family could not
        trace the frame, else None (runtime.server ``POST /frames``)."""
        return self._engine.frame_error(frame, self.config)

    @property
    def failure(self):
        """The exception the producer thread died with, or ``None`` —
        the non-raising probe behind :meth:`raise_if_failed` (the HTTP
        ingest door answers 409 from it instead of queueing frames
        into a dead stream)."""
        return self._stream._error

    def raise_if_failed(self) -> None:
        """Re-raise any exception the producer thread died with."""
        self._stream.raise_if_failed()

    @property
    def debug(self) -> Dict[str, np.ndarray]:
        """Latest per-frame debug state: hues (cellMaxHues), grads
        (cellAvgGrads), spectrum (previousSpectrum) — the data feeds behind
        the reference's ConvolutionDebugView / SpectrumView."""
        return dict(self._stream.debug_state)

    def inspect_frame(self, frame: np.ndarray) -> Dict[str, np.ndarray]:
        """One-shot full analysis of a single frame — the
        ConvolutionDebugView surface (Views/DebuggingView.swift): per-pixel
        mode heatmaps for all three HSI channels (rotated buffer layout,
        matching the Metal outputs), the per-cell histogram, hues and
        gradient stats.  Uses the *current* stream state for the hue EMA
        but does not advance it."""
        import jax.numpy as jnp

        from vaudio.vision import extract_features
        if self.model != "auralizer":
            raise ValueError(
                f"inspect_frame analyzes the flagship 16-cell model; "
                f"the {self.model!r} family has no cell debug surface "
                "(spectrum/waveform views still work live)")
        # uint8 passes through UNconverted: the vision graph folds the
        # 1/255 scale in and takes the exact int8 pooling path — the
        # same path the live stream uses, so the debug surface can
        # never disagree with the pipeline it inspects (a pre-division
        # to f32 would route through f32 pooling and could flip a hue
        # on a histogram bin edge), and the transfer ships 4x fewer
        # bytes.
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            frame = frame.astype(np.float32, copy=False)
        hues, grads, dbg = extract_features(
            jnp.asarray(frame), jnp.asarray(self._stream.snapshot_carry().hues),
            jnp.float32(self.params.spectrum_mixing), self.config,
            compute_debug_maps=True)
        out = {"hues": np.asarray(hues), "grads": np.asarray(grads)}
        out.update({k: np.asarray(v) for k, v in dbg.items()})
        return out

    # ------------------------------------------------------------------
    # Checkpoint / resume (extension; the reference keeps this state
    # implicit and in-memory only — SURVEY.md §5)
    # ------------------------------------------------------------------

    def save_state(self, path: str) -> None:
        """Serialize the stream's DSP carry (phases, previous spectrum,
        OLA tail, AGC envelope, hues) to ``path`` (.npz).  Safe to call
        while the stream runs: the carry is donated per dispatch, so the
        snapshot materializes under the stream's carry lock."""
        from vaudio.runtime.checkpoint import save_state
        save_state(path, self._stream.snapshot_carry())

    def load_state(self, path: str) -> None:
        """Restore a previously saved DSP carry; the next frame continues
        the stream seamlessly.  Validation is engine-aware (the
        OrthoModes family's carry is per-pixel, not per-cell)."""
        self._stream.set_carry(self._engine.load_carry(path))
