"""Live runtime control + live observability for a running stream.

The reference's whole interaction model is sliders mutating ``@Published``
parameters while processing runs (SoundEngine.swift:66-75 published
attack/release/spectrumMixing/filters; Views/ControlPanelView.swift:11-43
and Views/ExtraControlView.swift:10-52 are the slider surfaces), and debug
views that redraw continuously during processing
(Views/SpectrumView.swift:18 ``TimelineView(.animation)``,
Views/DebuggingView.swift:72-81 auto start/stop).  This module gives the
streaming front door both capabilities:

* :class:`ControlChannel` — a JSON-lines control feed (FIFO/file/socket
  file-object) mutating a :class:`~vaudio.config.LiveParams` mid-stream.
  Values are traced by the jitted step, so updates apply on the next
  frame with no recompilation.
* :class:`LiveDebugRenderer` — re-renders the debug surface (hue matrix,
  spectrum, waveform, heatmaps, index.html with a meta-refresh) every N
  processed frames while a stream runs.
"""

from __future__ import annotations

import json
import os
import stat
import sys
import threading
from typing import Callable, Dict, Optional

import numpy as np

from vaudio.config import LiveParams

#: Parameter keys a control message may set (the slider surface).
CONTROLLABLE = ("attack", "release", "spectrum_mixing", "hp_cutoff",
                "lp_cutoff", "hp_order", "lp_order", "stereo_width",
                "pan_angles")


def apply_control_message(params: LiveParams, msg: Dict,
                          warn=None, num_cells: Optional[int] = None) -> int:
    """Apply one parsed control message to ``params``; returns the number
    of fields updated.  Unknown keys and malformed values are reported
    via ``warn`` (a callable taking a string) and skipped — a typo must
    not kill a live stream.  ``num_cells`` (when known) validates the
    ``pan_angles`` length: a wrong-length array would otherwise be
    accepted here and crash the producer thread at the next trace."""
    applied = 0
    for key, value in msg.items():
        if key not in CONTROLLABLE:
            if warn is not None:
                warn(f"control: unknown parameter {key!r} ignored "
                     f"(known: {', '.join(CONTROLLABLE)})")
            continue
        if key == "pan_angles":
            # None clears the override (back to the column pan law);
            # flipping None <-> array re-traces the jit once (config.py).
            if value is not None:
                value = np.asarray(value, np.float32)
                bad = (value.ndim != 1
                       or not np.all(np.isfinite(value))
                       or (num_cells is not None
                           and value.shape[0] != num_cells))
                if bad:
                    if warn is not None:
                        warn(f"control: pan_angles must be a flat list "
                             f"of {num_cells or 'num_cells'} finite "
                             f"floats; got shape {value.shape} — ignored")
                    continue
        else:
            value = float(value)
            if not np.isfinite(value):
                if warn is not None:
                    warn(f"control: non-finite value for {key!r} ignored")
                continue
        setattr(params, key, value)
        applied += 1
    return applied


class ControlChannel:
    """JSON-lines live-parameter control channel.

    Each line of the feed is one JSON object of parameter updates::

        {"attack": 0.2, "release": 2.0}
        {"stereo_width": 0.0}
        {"pan_angles": [0.0, 0.1, ...]}       # num_cells values
        {"pan_angles": null}                  # clear the override

    ``path`` may be a FIFO (the live front door: writers connect, write
    lines, disconnect — the channel reopens and keeps listening), a
    regular file (read once to EOF — a scripted parameter schedule), or
    an open file object.  Updates mutate ``params`` in place; the
    producer re-reads the values every frame (LiveParams is the traced
    ``@Published`` equivalent) so no recompilation happens.

    Reference: ControlPanelView.swift:11-43 / ExtraControlView.swift:10-52
    sliders writing straight into SoundEngine's published params.
    """

    def __init__(self, params: LiveParams, path_or_file,
                 on_update: Optional[Callable[[Dict], None]] = None,
                 warn: Callable[[str], None] = lambda m: print(
                     m, file=sys.stderr),
                 num_cells: Optional[int] = None):
        self.params = params
        self.num_cells = num_cells
        self._path: Optional[str] = None
        self._file = None
        if isinstance(path_or_file, (str, os.PathLike)):
            self._path = os.fspath(path_or_file)
        else:
            self._file = path_or_file
        self.on_update = on_update
        self.warn = warn
        self.applied = 0          # fields successfully applied
        self.messages = 0         # lines parsed
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ControlChannel":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._reader_loop,
                                        daemon=True, name="vaudio-control")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # A FIFO reader blocks in open() until a writer connects; connect
        # as a writer ourselves to release it so the thread can observe
        # the stop flag.
        if self._path is not None and self._is_fifo():
            try:
                fd = os.open(self._path, os.O_WRONLY | os.O_NONBLOCK)
                os.close(fd)
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _is_fifo(self) -> bool:
        try:
            return stat.S_ISFIFO(os.stat(self._path).st_mode)
        except OSError:
            return False

    # -- reader ------------------------------------------------------------

    def _handle_line(self, line: str) -> None:
        line = line.strip()
        if not line:
            return
        try:
            msg = json.loads(line)
        except json.JSONDecodeError as e:
            self.warn(f"control: bad JSON line ignored ({e})")
            return
        if not isinstance(msg, dict):
            self.warn("control: expected a JSON object per line")
            return
        self.messages += 1
        try:
            self.applied += apply_control_message(self.params, msg,
                                                  warn=self.warn,
                                                  num_cells=self.num_cells)
        except (TypeError, ValueError) as e:
            self.warn(f"control: bad value ignored ({e})")
            return
        if self.on_update is not None:
            self.on_update(msg)

    def _reader_loop(self) -> None:
        if self._file is not None:
            for line in self._file:
                if self._stop.is_set():
                    return
                self._handle_line(line)
            return
        fifo = self._is_fifo()
        while not self._stop.is_set():
            try:
                f = open(self._path, "r")    # FIFO: blocks for a writer
            except OSError as e:
                self.warn(f"control: cannot open {self._path!r}: {e}")
                return
            with f:
                for line in f:
                    if self._stop.is_set():
                        return
                    self._handle_line(line)
            if not fifo:
                return                        # regular file: one pass
            # FIFO writer disconnected (EOF): reopen and keep listening.


class LiveDebugRenderer:
    """Continuously re-render the debug surface while a stream runs.

    The framework's equivalent of the reference's live views: the
    spectrum/waveform redraw every animation tick during processing
    (Views/SpectrumView.swift:18, Views/TimeDomainFrameView.swift:15) and
    the debug screen shows the per-cell state live
    (Views/DebuggingView.swift:37-93).  Here a watcher thread re-renders
    PNGs + an auto-refreshing ``index.html`` every ``every_frames``
    processed frames from the stream's published debug state
    (``Auralizer.debug``: hues/grads/spectrum/pcm — refreshed every frame
    by the producer when the stream runs with ``debug=True``).

    ``full_heatmaps``: also re-run the per-pixel mode-map analysis on the
    most recent frame (one extra device dispatch per render —
    :meth:`Auralizer.inspect_frame`); off by default so the live surface
    costs nothing on the device hot path.
    """

    def __init__(self, aur, out_dir: str, every_frames: int = 30,
                 full_heatmaps: bool = False,
                 refresh_seconds: float = 1.0):
        self.aur = aur
        self.out_dir = out_dir
        self.every_frames = max(1, int(every_frames))
        self.full_heatmaps = full_heatmaps
        self.refresh_seconds = refresh_seconds
        self.renders = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "LiveDebugRenderer":
        if self._thread is not None:
            return self
        os.makedirs(self.out_dir, exist_ok=True)
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="vaudio-live-debug")
        self._thread.start()
        return self

    def stop(self, final_render: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if final_render and self.aur.debug:
            self._render()   # leave the last state on disk, no refresh tag

    def _loop(self) -> None:
        last_rendered = -self.every_frames
        seen_running = False
        while not self._stop.is_set():
            m = self.aur.metrics
            done = m["frames_processed"]
            if done - last_rendered >= self.every_frames and self.aur.debug:
                try:
                    self._render(live=True)
                    last_rendered = done
                except Exception as e:   # rendering must not kill a stream
                    print(f"live-debug: render failed: {e}",
                          file=sys.stderr)
            seen_running = seen_running or self.aur.is_running
            if (seen_running and not self.aur.is_running
                    and self.aur.metrics["frames_processed"] == done):
                # seen_running guards the attach-before-start race: the
                # renderer is typically attached BEFORE aur.start(), and
                # exiting on the first tick (stream not yet running, no
                # frames) would silently kill the live surface — the
                # cause of a long-misdiagnosed "renderer stuck at 0"
                # flake.  Until the stream has been observed running,
                # idle; .stop() always ends the thread.
                # Stream ended and no frame arrived since the snapshot
                # above (metrics must be RE-READ: ``m`` is the same dict
                # ``done`` came from, so comparing against it is always
                # true and frames landing between render and check would
                # exit with a stale surface).
                if done > last_rendered and self.aur.debug:
                    try:
                        self._render()   # catch-up final surface
                    except Exception:
                        pass
                return
            self._stop.wait(0.05)

    def _render(self, live: bool = False) -> None:
        from vaudio.utils.render import render_debug_surface
        dbg = self.aur.debug
        if "hues" not in dbg:
            return
        info = {"hues": dbg["hues"],
                "grads": dbg.get("grads", np.zeros(
                    (self.aur.config.num_cells, 4), np.float32))}
        frame = getattr(self.aur._stream, "last_frame", None)
        if self.full_heatmaps and frame is not None \
                and not isinstance(frame, dict):
            full = self.aur.inspect_frame(frame)
            full["hues"] = dbg["hues"]   # stream-smoothed, not re-run
            info = full
        render_debug_surface(
            info, self.aur.config, self.out_dir,
            spectrum=dbg.get("spectrum"), pcm=dbg.get("pcm"),
            refresh_seconds=self.refresh_seconds if live else None,
            input_frame=frame)
        self.renders += 1
