#!/usr/bin/env python
"""Batched multi-stream throughput on one chip (BASELINE config 5 building
block): vmap S concurrent 1080p streams through the fused step and report
aggregate frames/s and per-stream realtime factor.

Methodology follows bench.py: device-resident uint8 frames, carries
chained between calls, marginal cost as the SLOPE between a small and a
large scan length, and the median of several interleaved slope
estimates (default delta: 12 batched frames x 8 streams = 96
stream-frames).

Writes a JSON record to $VAUDIO_BENCH_JSON if set.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

_SEED = 0


def main():
    import _common
    _common.enable_compile_cache()

    from vaudio.config import AuralizerConfig
    from vaudio.parallel import init_carry_batch
    from vaudio.runtime.step import default_params
    from vaudio.dsp import hann_window_norm
    from vaudio.synth import SynthConstants
    from vaudio.runtime.step import frame_step

    res = os.environ.get("VAUDIO_BENCH_RES", "1080x1920")
    h, w = (int(x) for x in res.split("x"))
    n_streams = int(os.environ.get("VAUDIO_BENCH_STREAMS", "8"))
    unroll = int(os.environ.get("VAUDIO_BENCH_UNROLL", "1"))  # unroll>1 hurts batched: 2x the 8x-larger live intermediates
    iters = int(os.environ.get("VAUDIO_BENCH_ITERS", "6"))
    n_reps = int(os.environ.get("VAUDIO_BENCH_SLOPE_REPS", "3"))
    chunks = [int(x) for x in
              os.environ.get("VAUDIO_BENCH_CHUNKS", "4,16").split(",")]

    cfg = AuralizerConfig(sample_rate=48000.0)
    consts = SynthConstants.create(cfg)
    window = jnp.asarray(hann_window_norm(cfg.nfft))
    params = default_params(cfg)

    record = {"streams": n_streams, "resolution": f"{h}x{w}",
              "chunks": chunks, "slope_reps": n_reps,
              "device": str(jax.devices()[0])}

    def frames_for(shape, seed):
        # <=2-batched-frame slices: threefry's u32 intermediates are 4x
        # the u8 output and would transiently eat multiple GB in one shot.
        T = shape[0]
        parts = []
        for i in range(0, T, 2):
            n = min(2, T - i)
            parts.append(jax.random.bits(jax.random.PRNGKey(seed + i),
                                         (n,) + shape[1:], jnp.uint8))
        fr = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        jax.block_until_ready(fr)
        return fr

    def measure(label, bench_T):
        slopes = []
        for rep in range(n_reps):
            t_small = bench_T(chunks[0], _SEED + 7 * rep)
            t_big = bench_T(chunks[1], _SEED + 1000 + 7 * rep)
            ms = (t_big - t_small) / (chunks[1] - chunks[0])
            print(f"[{label}] rep{rep}: chunk{chunks[0]}={t_small:.1f}ms "
                  f"chunk{chunks[1]}={t_big:.1f}ms -> "
                  f"{ms * 1e3:.0f} us/batched-frame", flush=True)
            slopes.append(ms)
        ms = statistics.median(slopes)
        agg_fps = n_streams * 1000.0 / ms
        per_stream_rtf = (1000.0 / ms) / cfg.video_fps
        print(f"[{label}]   {n_streams} streams @ {h}x{w}: "
              f"{ms:.3f} ms/batched-frame, "
              f"aggregate {agg_fps:.0f} frames/s, "
              f"per-stream {per_stream_rtf:.1f}x realtime", flush=True)
        record[label] = {"ms_per_batched_frame": round(ms, 4),
                         "aggregate_fps": round(agg_fps, 1),
                         "per_stream_x_realtime": round(per_stream_rtf, 2)}

    def bench_scan_T(T, seed):
        frames = frames_for((T, n_streams, h, w, 3), seed)

        @jax.jit
        def scan_chunk(carry, frames):
            def body(c, fr):
                step = jax.vmap(
                    lambda cc, f: frame_step(cc, f, params, cfg, consts,
                                             window),
                    in_axes=(0, 0))
                return step(c, fr)
            return jax.lax.scan(body, carry, frames, unroll=unroll)

        carry = init_carry_batch(cfg, n_streams)
        carry, outs = scan_chunk(carry, frames)
        jax.block_until_ready(outs["pcm"])
        t0 = time.perf_counter()
        for i in range(iters):
            carry, outs = scan_chunk(carry, frames)
        jax.block_until_ready(outs["pcm"])
        return (time.perf_counter() - t0) / iters * 1e3

    measure("scan", bench_scan_T)

    # Chunk-batched variant: vmap(chunk_pipeline) over streams — each
    # stream's synthesis runs as one frame-batched contraction.
    from vaudio.runtime.chunked import chunk_pipeline

    def bench_chunked_T(T, seed):
        frames = frames_for((n_streams, T, h, w, 3), seed)

        @jax.jit
        def run(carry, frames):
            step = jax.vmap(
                lambda cc, fr: chunk_pipeline(cc, fr, params, cfg, consts,
                                              window),
                in_axes=(0, 0))
            return step(carry, frames)

        carry = init_carry_batch(cfg, n_streams)
        carry, outs = run(carry, frames)
        jax.block_until_ready(outs["pcm"])
        t0 = time.perf_counter()
        for i in range(iters):
            carry, outs = run(carry, frames)
        jax.block_until_ready(outs["pcm"])
        return (time.perf_counter() - t0) / iters * 1e3

    measure("chunked", bench_chunked_T)

    out = os.environ.get("VAUDIO_BENCH_JSON")
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
