"""Streaming runtime: the live host loop around the jitted frame step.

Re-expresses the reference's concurrency structure (SURVEY.md §1: capture
queue -> GPU completions -> audio render thread) as one producer thread
feeding a ring buffer that a consumer pulls from:

* producer  = frame source -> jitted device step -> ring write
  (the VisionEngine.captureOutput -> renderAudioFrame chain);
* consumer  = :meth:`StreamingAuralizer.pull` — the AVAudioSourceNode
  callback equivalent (zero-fill/warm-up semantics live in the ring
  buffer, vaudio.runtime.ringbuffer);
* the frame->audio latency probe matches the reference's
  (SoundEngine.swift:430-434: wall clock from frame capture to ring write).

Device-step pipelining: JAX dispatch is asynchronous, so the loop dispatches
frame k+1 before blocking on frame k's PCM — the host->device copy and
compute of the next frame overlap the readback of the current one (the
counterpart of the reference's triple command-buffer overlap).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Iterator, Optional

import numpy as np

import jax

from vaudio.config import AuralizerConfig, LiveParams
from vaudio.runtime.ringbuffer import make_ring_buffer
from vaudio.runtime.step import StepCarry


class StreamMetrics:
    """Rolling metrics — the observable equivalent of the reference's
    ``processingLatency`` probe and ``availableFrames`` print
    (SoundEngine.swift:430-445)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._latencies_ms: list[float] = []
        self.frames_processed = 0    # video frames through the device
        self.dispatches = 0          # device calls (chunks count once)
        self.resolution_changes = 0  # mid-stream shape changes (each one
        #                              costs a one-time retrace/compile)
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None

    def record(self, latency_ms: float, n_frames: int = 1):
        with self._lock:
            self.frames_processed += n_frames
            self.dispatches += 1
            self._latencies_ms.append(latency_ms)
            if len(self._latencies_ms) > 1024:
                del self._latencies_ms[:512]

    @property
    def processing_latency_ms(self) -> float:
        """Most recent frame->ring-buffer latency."""
        with self._lock:
            return self._latencies_ms[-1] if self._latencies_ms else 0.0

    def latency_percentile(self, q: float) -> float:
        with self._lock:
            if not self._latencies_ms:
                return 0.0
            return float(np.percentile(self._latencies_ms, q))

    @property
    def achieved_fps(self) -> float:
        with self._lock:
            if self.start_time is None or self.frames_processed == 0:
                return 0.0
            end = self.end_time or time.monotonic()
            dt = end - self.start_time
            return self.frames_processed / dt if dt > 0 else 0.0


class StreamingAuralizer:
    """Live video -> audio streaming engine.

    Args:
      cfg: static configuration.
      params: live parameter object; may be mutated between frames from any
        thread (the ``@Published`` equivalent — values are re-read every
        frame without recompilation).
      realtime: pace the producer at cfg.video_fps (True) or run as fast as
        the device allows (False — benchmark/throughput mode).
      prefer_native: use the C++ ring buffer when buildable.
    """

    def __init__(self, cfg: AuralizerConfig = AuralizerConfig(),
                 params: Optional[LiveParams] = None,
                 realtime: bool = False,
                 prefer_native: bool = True,
                 debug: bool = False,
                 chunk_frames: int = 1,
                 metrics_log: Optional[str] = None,
                 sink_latency_ms: Optional[float] = None,
                 engine=None,
                 pipeline_depth: int = 4):
        """``chunk_frames > 1`` dispatches N frames per device call
        through the chunk-batched pipeline (runtime.chunked): adds N-1
        frame times of buffering latency but amortizes per-dispatch
        overhead N-fold — the right trade when dispatch latency is high
        or throughput matters more than latency.  (The
        former ``scan_unroll`` knob is gone: the chunked pipeline
        replaced the scanned chunk step and owns its own unrolling.)

        ``metrics_log``: path to a JSONL file receiving one record per
        processed frame/chunk (timestamp, latency, buffer fill, drops) —
        the structured replacement for the reference's per-frame
        ``print(availableFrames)`` (SoundEngine.swift:445).

        ``pipeline_depth``: how many dispatched device steps may be
        awaiting PCM readback at once.  The producer thread only ever
        SUBMITS work (JAX dispatch is asynchronous); a dedicated drain
        thread blocks on each result in order and writes the ring, so
        a slow readback overlaps the next frames' H2D + compute instead
        of serializing with them — the counterpart of the reference's
        overlapped command buffers
        (VisionEngine.swift:175-180), but K deep instead of 3.  Depth 1
        still overlaps one readback with one dispatch (the round-3
        behavior); the queue bound provides backpressure so a source
        can never run unboundedly ahead of the device.

        ``sink_latency_ms``: the downstream audio-output latency added to
        the reported total latency, so the metric is the same quantity as
        the reference's ``processingLatency`` = wall clock + hardware
        latency (output latency + IO buffer duration + presentation
        latency, SoundEngine.swift:477-484).  None estimates the IO-buffer
        term as one 512-sample quantum at cfg.sample_rate (the output/
        presentation terms are sink hardware we cannot see); pass your
        sink's measured figure for accuracy, or 0.0 to report pure
        frame->ring time."""
        self.cfg = cfg
        self.params = params if params is not None else LiveParams()
        self.realtime = realtime
        if sink_latency_ms is None:
            sink_latency_ms = 512.0 / cfg.sample_rate * 1000.0
        self.sink_latency_ms = float(sink_latency_ms)
        self.debug = debug
        self.chunk_frames = max(1, int(chunk_frames))
        self.pipeline_depth = max(1, int(pipeline_depth))
        if engine is None:
            # The flagship model family; ``engine`` swaps in another
            # (e.g. runtime.engine.OrthoModesEngine) behind the same
            # host loop — ring, pacing, metrics, control, panel and
            # checkpoints are model-agnostic.
            from vaudio.runtime.engine import AuralizerEngine
            engine = AuralizerEngine(cfg, debug=debug)
        self.engine = engine
        self._step = engine.make_step()
        self._chunk_step = None
        if self.chunk_frames > 1:
            # For the flagship: the chunk-batched pipeline
            # (runtime.chunked) — serial scan only where the math
            # demands it, one frame-batched XLA contraction for the
            # heavy stage.
            self._chunk_step = engine.make_chunk_step()
        # Engines whose carry is sized by the frame (carry_static False)
        # defer construction to the first dispatch.
        self._carry = (engine.init_carry() if engine.carry_static
                       else None)
        # False while a frame-sized carry needs first-frame validation
        # (set False by set_carry restores and resolution changes).
        self._carry_checked = engine.carry_static
        # Guards the carry against the donation race: the step functions
        # donate the carry (donate_argnums=(0,)), so a dispatch DELETES
        # the buffers of the carry it consumed.  Any cross-thread reader
        # (save_state, inspect_frame) that grabs self._carry and converts
        # it later can hit "Array has been deleted".  The producer swaps
        # the carry under this lock; snapshot_carry() materializes under
        # it too, so a snapshot is always of a live, consistent carry.
        self._carry_lock = threading.Lock()
        # Stereo streams store interleaved samples (frame = hop * channels).
        self.ring = make_ring_buffer(cfg.ring_buffer_frames,
                                     cfg.hop_size * cfg.channels,
                                     cfg.warmup_frames,
                                     prefer_native=prefer_native)
        self.metrics = StreamMetrics()
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._running = False
        self._error: Optional[BaseException] = None
        self._metrics_log = metrics_log
        self._metrics_fh = None
        #: Optional callable: True when the frame source is about to
        #: block awaiting external input (e.g. an empty PushSource
        #: queue).  The producer then flushes the in-flight dispatch
        #: and any partial chunk instead of withholding audio until
        #: the next frame arrives.
        self.idle_probe = None
        # Last debug snapshot (hues/grads/spectrum/pcm) — the
        # ConvolutionDebugView data feed equivalent, refreshed per flush.
        self.debug_state: Dict[str, np.ndarray] = {}
        # Most recent host-side frame (reference only, no copy): lets the
        # live debug surface re-run the per-pixel heatmap analysis.
        self.last_frame = None
        # Optional attached live-control channel (stopped with the stream).
        self._control = None

    def _log_metrics(self, latency_ms: float, n_frames: int) -> None:
        if self._metrics_log is None:
            return
        import json
        if self._metrics_fh is None:
            self._metrics_fh = open(self._metrics_log, "a")
        self._metrics_fh.write(json.dumps({
            "t": time.time(),
            "frames": n_frames,
            "latency_ms": round(latency_ms, 3),
            "buffer_fill": self.ring.available,
            "dropped_frames": int(getattr(self.ring, "dropped_frames", 0)),
            "underrun_samples": int(getattr(self.ring, "underrun_samples",
                                            0)),
        }) + "\n")
        self._metrics_fh.flush()

    # -- lifecycle (VideoToAudio.toggleProcessing equivalents) -------------

    @property
    def is_running(self) -> bool:
        return self._running

    def start(self, source: Iterable[np.ndarray]) -> None:
        """Start processing frames from ``source`` on a producer thread."""
        if self._running:
            return
        if self._thread is not None and self._thread.is_alive():
            # A previous producer is still wedged (e.g. run_until_exhausted
            # timed out while the source blocked in next()).  Starting a
            # second producer would interleave carries and ring writes
            # with the zombie if its source ever yields again.
            raise RuntimeError(
                "previous stream producer has not exited (hung source?); "
                "cannot start a new one over it")
        self._stop_event.clear()
        self._running = True
        self._error = None
        # Fresh metrics per run: a restarted stream (toggle semantics,
        # VideoToAudio.toggleProcessing) must not mix runs — a stale
        # end_time would make achieved_fps report 0 while running, and
        # cumulative counters over run 2's wall time would overstate it.
        self.metrics = StreamMetrics()
        self.metrics.start_time = time.monotonic()
        self._thread = threading.Thread(
            target=self._producer_guard, args=(iter(source),), daemon=True)
        self._thread.start()

    def _producer_guard(self, frames) -> None:
        try:
            self._producer_loop(frames)
        except BaseException as e:  # surfaced by raise_if_failed()
            self._error = e
            self._running = False

    def raise_if_failed(self) -> None:
        """Re-raise any exception the producer thread died with.  Producer
        failures must not be silent (the reference degrades with printed
        guard-lets; we degrade loudly)."""
        if self._error is not None:
            raise RuntimeError("stream producer failed") from self._error

    def stop(self) -> None:
        """Stop processing and clear buffered audio (SoundEngine.stop():
        buffers reset, but DSP carries — phases, previous spectrum — are
        retained, matching SoundEngine.swift:459-474)."""
        self._stop_event.set()
        if self._control is not None:
            self._control.stop()
            self._control = None
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            if not self._thread.is_alive():
                self._thread = None
            # else: keep the zombie referenced so start() refuses to
            # overlap a second producer with it.
        self._running = False
        self.metrics.end_time = time.monotonic()
        if self._metrics_fh is not None:      # close the JSONL log fd
            self._metrics_fh.close()
            self._metrics_fh = None
        self.ring.reset()
        # Reference quirk kept: the OLA tail *is* cleared on stop
        # (SoundEngine.swift:470) while phases/previousSpectrum are not.
        with self._carry_lock:
            if self._carry is not None:
                self._carry = self._carry._replace(
                    ola_tail=jax.numpy.zeros_like(self._carry.ola_tail))

    def snapshot_carry(self) -> StepCarry:
        """A consistent host-side (NumPy) snapshot of the DSP carry, safe
        to take while the producer runs.  The step functions donate the
        carry, so a bare ``self._carry`` reference can be deleted by the
        very next dispatch; materializing under the carry lock blocks
        that dispatch until the copy is complete."""
        with self._carry_lock:
            if self._carry is None:
                raise ValueError(
                    "no DSP carry yet: this engine sizes it from the "
                    "first frame and none has been processed")
            return type(self._carry)(*[np.asarray(x)
                                       for x in self._carry])

    def set_carry(self, carry: StepCarry) -> None:
        """Replace the DSP carry (checkpoint resume).  Frame-sized
        carries are re-validated against the next frame dispatched
        (engine.carry_mismatch)."""
        with self._carry_lock:
            self._carry = carry
            self._carry_checked = self.engine.carry_static

    def toggle(self, source: Optional[Iterable[np.ndarray]] = None) -> None:
        if self._running:
            self.stop()
        elif source is not None:
            self.start(source)

    def attach_control(self, path_or_file, **kwargs):
        """Attach a JSON-lines live-parameter control channel (FIFO/file/
        file object) mutating this stream's :class:`LiveParams` mid-run —
        the ControlPanelView slider surface for the streaming front door
        (vaudio.runtime.control.ControlChannel).  Started immediately;
        stopped automatically by :meth:`stop`.  Returns the channel."""
        from vaudio.runtime.control import ControlChannel
        if self._control is not None:
            self._control.stop()
        kwargs.setdefault("num_cells", self.cfg.num_cells)
        self._control = ControlChannel(self.params, path_or_file,
                                       **kwargs).start()
        return self._control

    def run_until_exhausted(self, source: Iterable[np.ndarray],
                            timeout: float = 60.0) -> None:
        """Synchronously process an entire finite source.

        Raises :class:`TimeoutError` if the producer has not finished
        within ``timeout`` seconds — a hung producer must not be
        indistinguishable from completion.  The stream is stopped (and
        the producer thread asked to exit) before raising.
        """
        self.start(source)
        t0 = time.monotonic()
        while self._thread is not None and self._thread.is_alive():
            if time.monotonic() - t0 > timeout:
                self._stop_event.set()
                self._thread.join(timeout=1.0)
                if not self._thread.is_alive():
                    self._thread = None
                # else: leave the wedged thread referenced — start()
                # refuses to run a second producer over a live zombie.
                self._running = False
                self.metrics.end_time = time.monotonic()
                self.raise_if_failed()
                raise TimeoutError(
                    f"stream producer still running after {timeout:.1f}s "
                    f"({self.metrics.frames_processed} frames processed)")
            time.sleep(0.001)
        self._running = False
        self.metrics.end_time = time.monotonic()
        self.raise_if_failed()

    # -- audio consumer (AVAudioSourceNode pull equivalent) ----------------

    def pull(self, n: int) -> np.ndarray:
        """Pull ``n`` PCM samples (zero-filled per the real-time contract)."""
        return self.ring.pull(n)

    def audio_stream(self, quantum: int = 512,
                     pace: Optional[bool] = None) -> Iterator[np.ndarray]:
        """Iterator of audio quanta while the stream runs — mirrors the
        ~86 Hz 512-sample CoreAudio pull cadence (SURVEY.md §3.4).

        ``pace``: sleep each iteration to the quantum's real-time duration
        (the hardware render-thread cadence).  Defaults to the stream's
        ``realtime`` flag.  When free-running (pace=False), a short sleep
        is still inserted while the ring is empty but the producer lives,
        so warm-up does not busy-spin yielding zero-blocks at CPU speed.
        """
        if pace is None:
            pace = self.realtime
        quantum_sec = quantum / (self.cfg.sample_rate * self.cfg.channels)
        # Absolute deadlines, like the producer's frame pacing: relative
        # per-iteration sleeps accumulate OS timer overshoot, making the
        # consumer systematically slower than real time — the ring then
        # creeps to capacity and drop-on-full discards frames.
        next_t = time.monotonic() + quantum_sec
        while self._running or self.ring.available > 0:
            block = self.pull(quantum)
            yield block
            if pace:
                now = time.monotonic()
                if now < next_t:
                    time.sleep(next_t - now)
                next_t = max(next_t + quantum_sec, time.monotonic())
            elif self.ring.available == 0 and self._running:
                time.sleep(0.0005)

    # -- producer ----------------------------------------------------------

    def _producer_loop(self, frames: Iterator[np.ndarray]) -> None:
        import queue as _queue

        from vaudio.io.sources import own_frame
        frame_period = 1.0 / self.cfg.video_fps
        next_deadline = time.monotonic()
        chunk_buf: list = []
        chunk_t0: Optional[float] = None
        last_shape: Optional[tuple] = None

        # The dispatch pipeline: the producer SUBMITS device steps and
        # enqueues their (future) outputs; the drain thread blocks on
        # each result in order and writes the ring.  Depth-K overlap:
        # up to pipeline_depth results may be awaiting readback while
        # the producer keeps dispatching (see __init__ docs).  put()
        # blocking on a full queue is the backpressure.
        pending_q: _queue.Queue = _queue.Queue(maxsize=self.pipeline_depth)
        drop_tail = threading.Event()   # stop(): discard queued results
        drain_error: list = []

        def flush(pending):
            out, t_capture, n_hops = pending
            pcm = np.asarray(out["pcm"])      # blocks until ready
            hop = self.cfg.hop_size * self.cfg.channels
            pcm = pcm.reshape(n_hops, hop)    # stereo: interleaved
            if drop_tail.is_set():
                return                        # stopped mid-fetch
            for row in pcm:
                self.ring.write(row)
            latency_ms = (time.monotonic() - t_capture) * 1000.0
            self.metrics.record(latency_ms, n_hops)
            self._log_metrics(latency_ms, n_hops)
            if self.debug:
                state = {
                    k: np.asarray(v)[-1] if n_hops > 1 else np.asarray(v)
                    for k, v in out.items() if k != "pcm"}
                last = pcm[-1]
                state["pcm"] = (last if self.cfg.channels == 1
                                else last.reshape(-1, self.cfg.channels))
                self.debug_state = state

        def drain_loop():
            while True:
                item = pending_q.get()
                if item is None:
                    return
                if drop_tail.is_set():
                    continue          # discard without fetching
                try:
                    flush(item)
                except BaseException as e:   # surface via the producer
                    drain_error.append(e)
                    drop_tail.set()   # never deadlock the producer's put

        drain_thread = threading.Thread(target=drain_loop, daemon=True)
        drain_thread.start()

        def dispatch(frames_np, t_capture):
            if self._carry is None:
                # Frame-sized carry (engine.carry_static False): built
                # from the first frame, rebuilt after a resolution
                # change (the per-oscillator state has no meaning
                # across a pixel-count change).  Re-checked under the
                # lock: a concurrent restore (POST /state.npz ->
                # set_carry) must not be overwritten by a fresh init.
                with self._carry_lock:
                    if self._carry is None:
                        self._carry = self.engine.init_carry(
                            frames_np[0])
                        self._carry_checked = True
            if not self._carry_checked:
                # An externally restored frame-sized carry: validate
                # against the first actual frame (clear error instead
                # of an opaque broadcast failure inside jit).
                err = self.engine.carry_mismatch(self._carry,
                                                 frames_np[0])
                if err is not None:
                    raise ValueError(err)
                self._carry_checked = True
            if self.debug:
                # Copy: a zero-copy source view's memory is recycled two
                # iterations later, but last_frame outlives that window
                # (dicts too — planar-YUV planes can be pool views).
                last = frames_np[-1]
                self.last_frame = (
                    {k: np.array(v) for k, v in last.items()}
                    if isinstance(last, dict) else np.array(last))
            params_arrays = self.engine.params_arrays(self.params)
            if len(frames_np) == 1:
                # Strip the BorrowedFrame marker down to a base-class
                # VIEW (same memory, no copy) before device_put: jax's
                # ndarray fast path is type-exact, and a subclass could
                # route through a slower/deferred conversion.
                f0 = frames_np[0]
                from vaudio.io.sources import BorrowedFrame
                borrowed = (any(isinstance(v, BorrowedFrame)
                                for v in f0.values())
                            if isinstance(f0, dict)
                            else isinstance(f0, BorrowedFrame))
                if borrowed and jax.default_backend() == "cpu":
                    # On the CPU backend device_put ALIASES host memory
                    # (no transfer happens), so the fence below cannot
                    # consume the pool slot — the async compute would
                    # read it after the source recycles it once the
                    # depth-K producer runs ahead of execution
                    # (caught end-to-end: depth-1's inline flush used
                    # to bound execution inside the lag-2 window).
                    # Copy; zero-copy ingest only pays off on backends
                    # with a real H2D transfer anyway.
                    f0 = ({k: np.array(v) for k, v in f0.items()}
                          if isinstance(f0, dict) else np.array(f0))
                    borrowed = False
                f0 = ({k: np.asarray(v) for k, v in f0.items()}
                      if isinstance(f0, dict) else np.asarray(f0))
                frame_dev = jax.device_put(f0)
                if borrowed:
                    # Bound the pool view's lifetime to THIS call: block
                    # until the H2D transfer has consumed the slot — the
                    # slot is then free to be recycled no matter how far
                    # the depth-K pipeline runs ahead, and the EOF case
                    # (the source generator's finally frees the whole
                    # pool BEFORE the producer sees StopIteration) is
                    # covered too.  (Transfer still overlaps the PREVIOUS
                    # step's device compute; we only stop overlapping it
                    # with our own dispatch bookkeeping.)
                    jax.block_until_ready(frame_dev)
                with self._carry_lock:
                    self._carry, out = self._step(self._carry, frame_dev,
                                                  params_arrays)
            else:
                if isinstance(frames_np[0], dict):   # planar YUV chunks
                    batch = {k: np.stack([f[k] for f in frames_np])
                             for k in frames_np[0]}
                else:
                    batch = np.stack(frames_np)
                batch = jax.device_put(batch)
                with self._carry_lock:
                    self._carry, out = self._chunk_step(self._carry, batch,
                                                        params_arrays)
            # Hand the (asynchronous) result to the drain thread; blocks
            # only when pipeline_depth results are already awaiting
            # readback (backpressure).
            pending_q.put((out, t_capture, len(frames_np)))

        frames_it = iter(frames)
        while True:
            if self._stop_event.is_set() or drain_error:
                break
            if (self.idle_probe is not None and self.idle_probe()
                    and chunk_buf):
                # The source reports it is about to BLOCK (a push-model
                # queue ran empty): release the partial chunk now — it is
                # normally dispatched at the NEXT chunk boundary, which
                # may be a long time coming (an interactive client
                # pushing at 1 fps must not hear its audio one full chunk
                # late).  In-flight results need no forcing: the drain
                # thread is already blocking on them.
                for f in chunk_buf:
                    dispatch([f], chunk_t0 or time.monotonic())
                chunk_buf = []
            try:
                frame = next(frames_it)
            except StopIteration:
                break
            if self.realtime:
                now = time.monotonic()
                if now < next_deadline:
                    time.sleep(next_deadline - now)
                next_deadline = max(next_deadline + frame_period,
                                    time.monotonic())
            if isinstance(frame, dict):       # planar YUV 4:2:0
                # asanyarray, not asarray: the BorrowedFrame marker of a
                # zero-copy source must survive to the chunk-buffer copy.
                frame_np = {k: np.asanyarray(v) for k, v in frame.items()}
                shape = tuple(frame_np["y"].shape)
            else:
                frame_np = np.asanyarray(frame)
                if frame_np.dtype != np.uint8:  # uint8 ships 4x fewer bytes
                    frame_np = frame_np.astype(np.float32, copy=False)
                shape = tuple(frame_np.shape)
            if last_shape is not None and shape != last_shape:
                # Managed mid-stream resolution change: flush the partial
                # chunk at the old shape as single steps (a mixed-shape
                # np.stack would fail), count the change, and let jit's
                # per-shape cache retrace the new resolution once.
                self.metrics.resolution_changes += 1
                for f in chunk_buf:
                    dispatch([f], chunk_t0 or time.monotonic())
                chunk_buf = []
                if not self.engine.carry_static:
                    # Frame-sized carry: the old-shape state cannot
                    # carry across (different oscillator count).  The
                    # in-flight dispatches hold their own (donated)
                    # carry references and the FIFO drain preserves
                    # ring order, so dropping ours here is safe.
                    with self._carry_lock:
                        self._carry = None
                        self._carry_checked = False
            last_shape = shape
            if self.chunk_frames == 1:
                dispatch([frame_np], time.monotonic())
            else:
                if not chunk_buf:
                    chunk_t0 = time.monotonic()
                # Zero-copy sources yield BorrowedFrame views whose pool
                # memory is recycled two source iterations later; a
                # chunk buffer holds frames for up to chunk_frames
                # iterations, so borrowed frames MUST be copied here
                # (owned frames pass through untouched).
                chunk_buf.append(own_frame(frame_np))
                if len(chunk_buf) >= self.chunk_frames:
                    dispatch(chunk_buf, chunk_t0)
                    chunk_buf = []
        # Trailing partial chunk: single-step the remainder.
        if (chunk_buf and not self._stop_event.is_set()
                and not drain_error):
            for f in chunk_buf:
                dispatch([f], chunk_t0 or time.monotonic())
        # Retire the pipeline: sentinel, then wait for the drain thread
        # to finish writing (all audio is in the ring when the producer
        # exits — run_until_exhausted relies on this).  A stop() request
        # arriving meanwhile discards the queued tail, matching the old
        # drop-on-stop semantics; a fetch wedged on a dead device leaves
        # a daemon zombie exactly as the old inline flush would have.
        if self._stop_event.is_set():
            drop_tail.set()
        pending_q.put(None)
        while drain_thread.is_alive():
            drain_thread.join(timeout=0.1)
            if self._stop_event.is_set():
                drop_tail.set()
        if drain_error:
            raise drain_error[0]
        self._running = False
