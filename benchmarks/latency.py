#!/usr/bin/env python
"""Frame->audio latency benchmark (north star: p50 < 33 ms on one chip).

Writes a JSON artifact (VAUDIO_LAT_OUT) with the quantities the budget
question needs:

1. ``steady_state``: the reference's probe semantics through the live
   host loop — wall clock from frame capture to PCM landing in the ring
   buffer (SoundEngine.swift:430-434) — measured the way a latency
   number must be: input paced at a rate the transport sustains and a
   CONSUMER thread draining the ring at the audio cadence (the
   AVAudioSourceNode pull, SoundEngine.swift:167-217), so p50/p99 are
   steady-state figures, not a growing-backlog artifact.  Also a
   ``chunked`` variant (chunk_frames > 1: adds buffering latency,
   amortizes per-dispatch overhead).
2. ``overloaded``: the same loop deliberately fed at 30 fps with no
   consumer — the saturation behavior (ring drops, backlog growth),
   labeled as such.
3. ``decomposed``: each hardware-bound term measured separately —
   H2D of a uint8 frame (distinct data per rep), the marginal device
   step time (scan slope, the same method as bench.py), and the PCM
   readback — whose sum is the device-bound part of the frame->audio
   latency.

Environment:
  VAUDIO_BENCH_RES=HxW        (default 1080x1920)
  VAUDIO_LAT_FRAMES=N         streaming frames (default 60)
  VAUDIO_LAT_OUT=path         artifact path (default '' = don't write)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def measure_streaming(cfg, frames, fps, chunk_frames=1, drain=True,
                      pace=True, warm=True, pipeline_depth=4):
    """The reference-probe number through the pipelined host loop.

    ``fps``: producer pacing (ignored when ``pace=False`` — the producer
    free-runs, which is the calibration mode: its ``achieved_fps`` is
    what the FULL loop+transport actually sustains).  ``drain``: run a
    consumer thread pulling 512-sample quanta at the audio-hardware
    cadence (the AVAudioSourceNode equivalent) so the ring never backs
    up — required for a steady-state p50.  ``fps`` above the sustainable
    rate with ``drain=False`` gives the labeled overload case."""
    import dataclasses
    import threading
    import time as _time

    from vaudio.runtime.stream import StreamingAuralizer
    cfg_run = dataclasses.replace(cfg, video_fps=fps)
    if warm:
        # Warm the compile cache outside the timed run.
        s = StreamingAuralizer(cfg_run, realtime=True, debug=False,
                               chunk_frames=chunk_frames,
                               pipeline_depth=pipeline_depth)
        s.run_until_exhausted(list(frames[:max(2, 2 * chunk_frames)]),
                              timeout=900)
        s.stop()
    s = StreamingAuralizer(cfg_run, realtime=pace, debug=False,
                           chunk_frames=chunk_frames,
                           pipeline_depth=pipeline_depth)

    stop_drain = threading.Event()

    def consumer():
        quantum = 512 * cfg.channels
        period = 512.0 / cfg.sample_rate
        while not stop_drain.is_set():
            t0 = _time.monotonic()
            s.pull(quantum)
            dt = period - (_time.monotonic() - t0)
            if dt > 0:
                _time.sleep(dt)

    # Trim to a chunk multiple: a trailing partial chunk is re-dispatched
    # as single frames through a DIFFERENT (untraced) graph and its
    # compile would pollute the tail percentiles.
    if chunk_frames > 1:
        frames = frames[:len(frames) // chunk_frames * chunk_frames]

    drain_thread = None
    if drain:
        drain_thread = threading.Thread(target=consumer, daemon=True)
        drain_thread.start()
    try:
        s.run_until_exhausted(iter(frames), timeout=900)
    finally:
        stop_drain.set()
        if drain_thread is not None:
            drain_thread.join(timeout=5)
    m = s.metrics
    ring = s.ring
    # Steady-state percentiles: drop the first few records (fresh-process
    # trace/cache-load transients), keeping the full set if the run is
    # too short to spare them.
    lat = list(m._latencies_ms)
    skip = 3 if len(lat) > 8 else 0
    lat_ss = np.asarray(lat[skip:]) if lat else np.asarray([0.0])
    out = {
        "input_fps": fps if pace else "free_run",
        "chunk_frames": chunk_frames,
        "drained": drain,
        "frames": m.frames_processed,
        "skipped_warmup_records": skip,
        "p50_ms": round(float(np.percentile(lat_ss, 50)), 2),
        "p99_ms": round(float(np.percentile(lat_ss, 99)), 2),
        "hardware_latency_ms": round(s.sink_latency_ms, 2),
        "total_p50_ms": round(float(np.percentile(lat_ss, 50))
                              + s.sink_latency_ms, 2),
        "achieved_fps": round(m.achieved_fps, 2),
        "dropped_frames": int(getattr(ring, "dropped_frames", 0)),
        "pipeline_depth": s.pipeline_depth,
    }
    s.stop()
    return out


def measure_decomposed(cfg, h, w):
    """Measure each hardware-bound latency term separately."""
    import jax
    import jax.numpy as jnp

    from vaudio.dsp import hann_window_norm
    from vaudio.runtime.step import default_params, frame_step, init_carry
    from vaudio.synth import SynthConstants

    consts = SynthConstants.create(cfg)
    window = jnp.asarray(hann_window_norm(cfg.nfft))
    params = default_params(cfg)
    rng = np.random.default_rng(0)
    frame_bytes = h * w * 3

    # Transfer-completion verification: every H2D timing is checked by
    # fetching a device-computed checksum OF the transferred bytes — the
    # value cannot exist before the transfer completed.  The
    # resident-array checksum cost is measured once and subtracted.
    @jax.jit
    def _checksum(x):
        return jnp.sum(x.astype(jnp.uint32) * jnp.uint32(2654435761))

    warm = jax.device_put(rng.integers(0, 256, 1024, dtype=np.uint8))
    float(_checksum(warm))                               # compile
    t0 = time.perf_counter()
    for _ in range(3):
        float(_checksum(warm))
    csum_baseline_ms = (time.perf_counter() - t0) / 3 * 1e3

    def median_put_ms(nbytes, reps=10):
        """Median VERIFIED H2D time for distinct uint8 payloads: the
        max of (device_put+block) and (time-to-checksum-value minus the
        resident checksum baseline)."""
        times = []
        for _ in range(reps):
            payload = rng.integers(0, 256, nbytes, dtype=np.uint8)
            t0 = time.perf_counter()
            d = jax.device_put(payload)
            jax.block_until_ready(d)
            t1 = time.perf_counter()
            float(_checksum(d))
            t2 = time.perf_counter()
            times.append(max(t1 - t0,
                             (t2 - t0) - csum_baseline_ms * 1e-3) * 1e3)
        return float(np.median(times[2:]))

    def median_get_ms(nbytes, reps=10):
        """Median D2H time for distinct nbytes-sized device arrays."""
        times = []
        for i in range(reps):
            d = jax.device_put(rng.integers(0, 256, nbytes,
                                            dtype=np.uint8))
            jax.block_until_ready(d)
            t0 = time.perf_counter()
            _ = np.asarray(d)
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[2:]))

    # Two-size linear fits split the transport's FIXED per-call overhead
    # from the PER-BYTE link cost, which is the hardware-bound term.
    small = 64 * 1024
    h2d_small, h2d_big = median_put_ms(small), median_put_ms(frame_bytes)
    h2d_per_byte = max(h2d_big - h2d_small, 0.0) / (frame_bytes - small)
    h2d_fixed = max(h2d_small - h2d_per_byte * small, 0.0)
    h2d_frame_hw = h2d_per_byte * frame_bytes

    pcm_bytes = cfg.hop_size * cfg.channels * 4
    d2h_small, d2h_big = median_get_ms(small), median_get_ms(8 << 20)
    d2h_per_byte = max(d2h_big - d2h_small, 0.0) / ((8 << 20) - small)
    d2h_fixed = max(d2h_small - d2h_per_byte * small, 0.0)
    d2h_pcm_hw = d2h_per_byte * pcm_bytes

    # --- Marginal device step: scan slope, bench.py's method/sizes
    # (dispatch overhead cancels between the two scan lengths). ---
    def scan_time(T, seed, iters=8):
        frames = jax.random.bits(jax.random.PRNGKey(seed), (T, h, w, 3),
                                 jnp.uint8)
        jax.block_until_ready(frames)

        @jax.jit
        def scan_chunk(carry, frames):
            def body(c, f):
                return frame_step(c, f, params, cfg, consts, window)
            return jax.lax.scan(body, carry, frames, unroll=4)
        carry = init_carry(cfg)
        carry, outs = scan_chunk(carry, frames)     # compile
        jax.block_until_ready(outs["pcm"])
        t0 = time.perf_counter()
        for _ in range(iters):
            carry, outs = scan_chunk(carry, frames)
        jax.block_until_ready(outs["pcm"])
        return (time.perf_counter() - t0) / iters * 1e3

    t_small, t_big = scan_time(16, 0), scan_time(64, 1)
    step_ms = (t_big - t_small) / 48.0

    # --- Single-dispatch step: what one pipelined stage costs, dispatch
    # included (chained carry, distinct frames). ---
    step1 = jax.jit(lambda c, f, p: frame_step(c, f, p, cfg, consts,
                                               window))
    carry = init_carry(cfg)
    frames_dev = [jax.device_put(rng.integers(0, 256, (h, w, 3),
                                              dtype=np.uint8))
                  for _ in range(8)]
    carry, out = step1(carry, frames_dev[0], params)   # compile
    jax.block_until_ready(out["pcm"])
    t0 = time.perf_counter()
    for fr in frames_dev:
        carry, out = step1(carry, fr, params)
        jax.block_until_ready(out["pcm"])
    dispatch_step_ms = (time.perf_counter() - t0) / len(frames_dev) * 1e3

    hw_total = h2d_frame_hw + step_ms + d2h_pcm_hw
    return {
        "h2d_frame_measured_ms": round(h2d_big, 3),
        "h2d_transport_fixed_ms": round(h2d_fixed, 3),
        "h2d_frame_hardware_ms": round(h2d_frame_hw, 3),
        "h2d_bandwidth_GBps": round(1e-6 / max(h2d_per_byte, 1e-12), 2),
        "device_step_marginal_ms": round(step_ms, 3),
        "device_step_with_dispatch_ms": round(dispatch_step_ms, 3),
        "d2h_transport_fixed_ms": round(d2h_fixed, 3),
        "d2h_pcm_hardware_ms": round(d2h_pcm_hw, 4),
        "d2h_bandwidth_GBps": round(1e-6 / max(d2h_per_byte, 1e-12), 2),
        "hardware_bound_total_ms": round(hw_total, 3),
    }


def main():
    import jax

    import _common
    _common.enable_compile_cache()

    from vaudio.config import AuralizerConfig

    res = os.environ.get("VAUDIO_BENCH_RES", "1080x1920")
    h, w = (int(x) for x in res.split("x"))
    n = int(os.environ.get("VAUDIO_LAT_FRAMES", "60"))
    out_path = os.environ.get("VAUDIO_LAT_OUT", "")

    cfg = AuralizerConfig(sample_rate=48000.0)
    log(f"latency: backend={jax.default_backend()} device="
        f"{jax.devices()[0]} frame={h}x{w}")

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)

    decomposed = measure_decomposed(cfg, h, w)
    log(f"latency decomposed: {decomposed}")

    # Steady state: pace input at 80% of what the FULL loop + transport
    # actually sustains, measured by a free-running calibration pass of
    # the same streaming loop (drained).  The single-dispatch estimate
    # is NOT a valid proxy: it misses per-frame H2D prep, PCM readback
    # and host-loop overhead — deriving the pacing from it once produced
    # a 25.95 fps target against a 2 fps loop, i.e. the saturated-queue
    # artifact this benchmark exists to avoid.
    def calibrated_steady(label):
        calib = measure_streaming(cfg, frames[:24], fps=30.0,
                                  chunk_frames=1, drain=True, pace=False)
        log(f"latency calibration {label} (free-run, drained): {calib}")
        steady_fps = round(0.8 * max(calib["achieved_fps"], 0.1), 2)
        # Saturation guard: a short free-run calibration can overestimate
        # (warm-cache transients).  If the paced run could not keep up —
        # achieved well below the pacing — its percentiles are a queueing
        # artifact, not steady state: re-pace at 80% of the rate the
        # paced run itself demonstrated.
        for _ in range(2):
            out = measure_streaming(cfg, frames, fps=steady_fps,
                                    chunk_frames=1, drain=True,
                                    warm=False)
            out["calibration_free_run_fps"] = calib["achieved_fps"]
            log(f"latency steady-state {label} ({steady_fps} fps, "
                f"drained): {out}")
            if out["achieved_fps"] >= 0.88 * steady_fps:
                out["saturated"] = False
                return out
            steady_fps = round(0.8 * max(out["achieved_fps"], 0.1), 2)
            log(f"latency {label}: paced run saturated, re-pacing at "
                f"{steady_fps} fps")
        out["saturated"] = True   # still not converged: label it honestly
        return out

    def pipeline_frontier():
        """(chunk_frames x pipeline_depth) free-run frontier: does
        depth-K dispatch pipelining (runtime.stream) buy throughput?
        Each config free-runs drained; the depth-4/depth-1 fps ratio
        per chunk is the measured overlap (~1.0 = per-call dispatches
        serialize and the benefit is unmeasurable)."""
        rows = []
        for chunk in (1, 2, 4, 8):
            per_depth = {}
            for depth in (1, 4):
                r = measure_streaming(cfg, frames[:32], fps=30.0,
                                      chunk_frames=chunk, drain=True,
                                      pace=False, warm=(depth == 1),
                                      pipeline_depth=depth)
                per_depth[depth] = r
                log(f"latency frontier chunk{chunk} depth{depth}: "
                    f"fps={r['achieved_fps']} p50={r['p50_ms']}ms")
            ratio = (per_depth[4]["achieved_fps"]
                     / max(per_depth[1]["achieved_fps"], 1e-6))
            rows.append({
                "chunk_frames": chunk,
                "depth1_fps": per_depth[1]["achieved_fps"],
                "depth4_fps": per_depth[4]["achieved_fps"],
                "depth4_over_depth1": round(ratio, 3),
                "depth1_p50_ms": per_depth[1]["p50_ms"],
                "depth4_p50_ms": per_depth[4]["p50_ms"],
                "verdict": ("overlap measured" if ratio >= 1.10 else
                            "dispatches serialize; benefit "
                            "unmeasurable"),
            })
        return rows

    frontier = pipeline_frontier()
    steady = calibrated_steady("")
    # The chunked pipeline is a THROUGHPUT configuration: it buffers
    # chunk_frames frames before dispatching, so per-frame latency
    # includes the chunk-fill time (chunk_frames / input_fps) by
    # construction — pacing it *below* its capacity makes latency
    # WORSE, not better (measured: 2.3 s free-run -> 10.8 s at 1.74
    # fps), and a paced "steady state" search cannot converge.  Its
    # honest latency figure is the drained FREE-RUN row, labeled as
    # such: fill + service time at capacity.
    steady_chunked = measure_streaming(cfg, frames[:48], fps=30.0,
                                       chunk_frames=8, drain=True,
                                       pace=False)
    steady_chunked["note"] = (
        "throughput configuration measured free-running (drained): "
        "latency includes the inherent 8-frame chunk-fill time; pacing "
        "below capacity only inflates fill time")
    log(f"latency chunked x8 (free-run, drained): {steady_chunked}")
    overloaded = measure_streaming(cfg, frames, fps=30.0, drain=False)
    log(f"latency overloaded (30 fps, no consumer): {overloaded}")

    artifact = {
        "config": {"frame": f"{h}x{w}", "sample_rate": cfg.sample_rate,
                   "frames": n,
                   "backend": str(jax.devices()[0])},
        "budget_ms": 33.0,
        "steady_state": steady,
        "pipeline_frontier": frontier,
        "chunked_free_run": steady_chunked,
        "overloaded": overloaded,
        "decomposed_hardware_bound": decomposed,
        "steady_state_within_budget":
            steady["total_p50_ms"] < 33.0,
        "hardware_bound_within_budget":
            decomposed["hardware_bound_total_ms"] < 33.0,
    }
    print(json.dumps(artifact))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(artifact, f, indent=2)
        log(f"latency: wrote {out_path}")


if __name__ == "__main__":
    main()
