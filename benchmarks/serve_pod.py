#!/usr/bin/env python
"""End-to-end serving throughput of the multi-stream pod
(runtime.multistream.MultiStreamAuralizer) at 8x1080p30 u8, chunk 16.

benchmarks/throughput_batch.py measures the raw batched DEVICE shape with
device-resident frames; this harness measures the same shape through the
pod's production host path — source iteration, per-tick batching,
host->device transfer, ring-buffer writes, and a draining consumer.  The
gap between the two is host frame marshalling + transport, i.e. the
ingest problem benchmarks/ingest.py quantifies per frame, not device
compute.  The serving question this answers:
does the pod sustain >= 30 fps per stream for 8 concurrent 1080p
clients end to end?  (Needs only 240 frames/s aggregate.)

Methodology: throughput is frames/wall-second over a steady-state window
AFTER the compile + first dispatches (not per-call timing).  Run with no
other process using the card.

Writes a JSON record to $VAUDIO_BENCH_JSON if set.
"""

import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np



def main():
    import _common
    _common.enable_compile_cache()

    from vaudio.config import AuralizerConfig
    from vaudio.runtime import MultiStreamAuralizer

    res = os.environ.get("VAUDIO_BENCH_RES", "1080x1920")
    h, w = (int(x) for x in res.split("x"))
    n_streams = int(os.environ.get("VAUDIO_BENCH_STREAMS", "8"))
    chunk = int(os.environ.get("VAUDIO_BENCH_CHUNK", "16"))
    warm_frames = int(os.environ.get("VAUDIO_BENCH_WARM", "512"))
    measure_frames = int(os.environ.get("VAUDIO_BENCH_MEASURE", "4096"))

    cfg = AuralizerConfig(sample_rate=48000.0)

    # Salted frame bank: K distinct u8 frames shared by all streams with
    # per-stream phase offsets.  Dispatch content repeats across ticks,
    # but every dispatch chains the previous carry, so no two dispatches
    # in the run (or across runs) are byte-identical.
    K = 24
    rng = np.random.default_rng(0)
    bank = rng.integers(0, 256, (K, h, w, 3), np.uint8)

    per_stream = (warm_frames + measure_frames) // n_streams + 2 * chunk

    def source(i):
        for t in range(per_stream):
            yield bank[(i * 7 + t) % K]

    pod = MultiStreamAuralizer(cfg, n_streams=n_streams,
                               chunk_frames=chunk)

    # Draining consumers: serving includes readers; also keeps the
    # 16-hop rings from sitting at drop-on-full.
    stop = threading.Event()

    def drain():
        while not stop.is_set():
            for i in range(n_streams):
                fill = pod.rings[i].available
                if fill:
                    pod.pull(i, fill * cfg.hop_size * cfg.channels)
            stop.wait(0.05)

    consumer = threading.Thread(target=drain, daemon=True)
    consumer.start()

    t_start = time.perf_counter()
    pod.start([source(i) for i in range(n_streams)])

    def wait_frames(n, timeout=1800.0):
        t0 = time.monotonic()
        while pod.metrics.frames_processed < n:
            pod.raise_if_failed()
            if not pod.is_running:
                break
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"stuck at {pod.metrics.frames_processed}/{n} frames")
            time.sleep(0.01)
        return time.perf_counter()

    t_warm = wait_frames(warm_frames)
    print(f"warm after {t_warm - t_start:.1f}s "
          f"({pod.metrics.frames_processed} frames incl. compile)",
          flush=True)
    f0 = pod.metrics.frames_processed
    t0 = time.perf_counter()
    t1 = wait_frames(f0 + measure_frames)
    f1 = pod.metrics.frames_processed
    pod.stop()
    stop.set()
    consumer.join(timeout=5)

    agg_fps = (f1 - f0) / (t1 - t0)
    per_stream_fps = agg_fps / n_streams
    rtf = per_stream_fps / cfg.video_fps
    dropped = sum(pod.stream_metrics(i)["dropped_frames"]
                  for i in range(n_streams))
    print(f"pod serving {n_streams}x{h}x{w} u8 chunk{chunk}: "
          f"{agg_fps:.0f} frames/s aggregate, {per_stream_fps:.1f} "
          f"fps/stream = {rtf:.1f}x realtime per stream "
          f"({f1 - f0} frames in {t1 - t0:.2f}s, dropped={dropped})",
          flush=True)

    record = {
        "harness": "serve_pod",
        "streams": n_streams, "resolution": f"{h}x{w}",
        "chunk_frames": chunk, "dtype": "uint8",
        "measure_frames": int(f1 - f0),
        "aggregate_fps": round(agg_fps, 1),
        "per_stream_fps": round(per_stream_fps, 2),
        "per_stream_x_realtime": round(rtf, 2),
        "dropped_frames_total": int(dropped),
        "note": ("end-to-end pod host path (source iteration + batching "
                 "+ host->device transfer + rings + consumer); the raw "
                 "device-resident shape is benchmarks/throughput_batch.py"),
    }
    out = os.environ.get("VAUDIO_BENCH_JSON")
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
