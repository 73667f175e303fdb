"""Profiling / tracing.

The equivalent of the reference's latency instrumentation
(SoundEngine.swift:430-434,477-484: wall clock around the frame pipeline,
published per frame): a host-side frame timer with percentile summaries,
plus a thin wrapper over ``jax.profiler`` for device-level traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np


@contextlib.contextmanager
def trace_context(log_dir: Optional[str] = None):
    """Capture a jax.profiler device trace around a code block.

    Usage::

        with trace_context("/tmp/vaudio-trace"):
            step(carry, frame, params)
    """
    if log_dir is None:
        yield
        return
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class FrameTimer:
    """Per-frame host-time probe with rolling percentile stats."""

    def __init__(self, capacity: int = 4096):
        self._samples_ms: list[float] = []
        self._capacity = capacity
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None, "start() not called"
        dt_ms = (time.perf_counter() - self._t0) * 1000.0
        self._t0 = None
        self._samples_ms.append(dt_ms)
        if len(self._samples_ms) > self._capacity:
            del self._samples_ms[:self._capacity // 2]
        return dt_ms

    @contextlib.contextmanager
    def frame(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> Dict[str, float]:
        if not self._samples_ms:
            return {"count": 0}
        a = np.asarray(self._samples_ms)
        return {
            "count": len(a),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(a.max()),
        }
