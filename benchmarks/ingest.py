#!/usr/bin/env python
"""Host ingest-path micro-benchmark: copying vs zero-copy frame reads.

Measures the three RawVideoSource ingest paths at 1080p rgb24 (6.2 MB/
frame) from a warm page-cache file:

* python     — blocking exact-read loop (no read-ahead thread);
* native     — C++ read-ahead reader, one memcpy per frame out of the
               pool (frames_bytes);
* zero_copy  — C++ read-ahead reader, NumPy views over the pool slots
               (frames_view, no consumer-side copy).

Also times each path feeding a simulated consumer that touches one byte
per 4 KiB page (the cheapest realistic "consume" — a device transfer
would read every page), to show the overlap benefit rather than raw
iterator overhead alone.  Pure host measurement: no accelerator involved.

Usage: python benchmarks/ingest.py
  VAUDIO_INGEST_FRAMES=N   frames per run (default 120)
  VAUDIO_INGEST_RES=HxW    frame size (default 1080x1920)
  VAUDIO_INGEST_OUT=path   write the JSON artifact
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from vaudio.io import RawVideoSource


def run_path(path, h, w, n, mode, work_ms=0.0):
    """``work_ms``: per-frame consumer dwell (GIL-releasing sleep) that
    models the host-idle device-dispatch wait of the real pipeline; the
    read-ahead thread can only show its overlap benefit against it."""
    kwargs = dict(width=w, height=h, pix_fmt="rgb24", max_frames=n)
    if mode == "python":
        src = RawVideoSource(path, native=False, **kwargs)
    elif mode == "native":
        src = RawVideoSource(path, native=True, **kwargs)
    else:
        src = RawVideoSource(path, native=True, zero_copy=True, **kwargs)
    # Touch one byte per page: forces the pages resident without a full
    # second read, approximating a DMA engine's access pattern cost on
    # the consumer thread.
    t0 = time.perf_counter()
    acc = 0
    for frame in src.frames():
        acc += int(frame[::137, ::137, 0].sum())
        if work_ms:
            time.sleep(work_ms * 1e-3)
    dt = time.perf_counter() - t0
    return dt, acc


def main():
    h, w = (int(x) for x in os.environ.get(
        "VAUDIO_INGEST_RES", "1080x1920").split("x"))
    n = int(os.environ.get("VAUDIO_INGEST_FRAMES", "120"))
    frame_bytes = h * w * 3
    path = f"/tmp/vaudio_ingest_{h}x{w}.rgb"
    rng = np.random.default_rng(int.from_bytes(os.urandom(4), "little"))
    data = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    data.tofile(path)
    # Warm the page cache so reads measure memory, not disk.
    with open(path, "rb") as f:
        while f.read(1 << 24):
            pass

    results = {}
    # work=0: raw iterator cost (single-thread python wins here — no
    # consumer work to overlap, and the pool adds synchronization).
    # work=2ms: the realistic regime — consumer dwells in a device
    # dispatch; the read-ahead thread overlaps the next frame's I/O and
    # zero_copy removes the remaining per-frame memcpy.
    for work_ms, label in ((0.0, "iterator_only"), (2.0, "with_2ms_work")):
        sub = {}
        for mode in ("python", "native", "zero_copy"):
            best = min(run_path(path, h, w, n, mode, work_ms)[0]
                       for _ in range(3))
            sub[mode] = {
                "ms_per_frame": round(best / n * 1e3, 3),
                "GBps": round(frame_bytes * n / best / 1e9, 2),
            }
        results[label] = sub
    os.unlink(path)
    overl = results["with_2ms_work"]
    out = {
        "config": {"frame": f"{h}x{w}", "frames": n,
                   "frame_mb": round(frame_bytes / 1e6, 2)},
        "results": results,
        "overlap_benefit_ms_per_frame": round(
            overl["python"]["ms_per_frame"]
            - overl["native"]["ms_per_frame"], 3),
        "zero_copy_saving_ms_per_frame": round(
            overl["native"]["ms_per_frame"]
            - overl["zero_copy"]["ms_per_frame"], 3),
    }
    print(json.dumps(out))
    out_path = os.environ.get("VAUDIO_INGEST_OUT", "")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
