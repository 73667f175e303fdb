#!/usr/bin/env python
"""Headline benchmark: real-time factor sonifying 1080p30 video to 48 kHz
STEREO PCM on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} plus a
``mono_x_realtime`` key (the reference's own output is mono 44.1 kHz —
SoundEngine.swift:165 — so both operating points are recorded) and the
device it ran on (JAX platform, device kind and count, the card's name
and power limit from nvidia-smi, XLA_FLAGS).  ``vs_baseline`` is
value / 10 — the ratio to the north-star target (BASELINE.md).  Exits
non-zero without a record when JAX finds no GPU.

Methodology: uint8 frames are pre-generated DEVICE-RESIDENT (the
steady-state serving configuration, where ingest overlaps compute) and
run through the chunk-batched pipeline (runtime.chunked); the
sequential scan path — dispatched as blocked sub-chunks of 8 by
default, see VAUDIO_BENCH_SCAN_BLOCK — is co-measured as
``scan_path_x_realtime``.  The reported per-frame time is the SLOPE
between a small and a large chunk length, which cancels per-dispatch
overhead.  The first call of each shape (compilation) is logged as
set-up time and never timed.

Environment overrides:
  VAUDIO_BENCH_RES=HxW      frame resolution   (default 1080x1920)
  VAUDIO_BENCH_CHUNKS=a,b   slope chunk sizes  (default 16,128)
  VAUDIO_BENCH_ITERS=N      timed repetitions  (default 12)
  VAUDIO_BENCH_MATMUL_IRFFT=0/1  dense-matmul IDFT instead of the XLA FFT
  VAUDIO_BENCH_MATMUL_EMA=0/1    spectrum EMA as one triangular matmul
                                 instead of the serial scan
  VAUDIO_BENCH_FAST_ACOS=0/1     polynomial hue arccos (<=2e-8 rad;
                                 default 1 = the config default)
  VAUDIO_BENCH_CHANNELS=1/2 stereo (default) or mono headline config
  VAUDIO_BENCH_QUANTIZE=0/1 strict-parity 8-bit mip chain
                            (cfg.quantize_mips)
  VAUDIO_BENCH_QUANTIZE_INT8=0/1 all-integer quantized chain
                            (cfg.quantize_mips_int8; needs QUANTIZE=1)
  VAUDIO_BENCH_MONO=0/1     also measure the mono config (default 1)
  VAUDIO_BENCH_SCAN=0/1     also measure the sequential scan path (default 1)
  VAUDIO_BENCH_SCAN_BLOCK=N scan-path dispatch granularity (default 8:
                            blocked sub-chunks — a device-side lax.scan
                            of chunk_pipeline bodies, runtime.chunked.
                            blocked_pipeline; 0/1 = the per-frame
                            frame_step scan)
  VAUDIO_BENCH_UNROLL=N     per-frame scan unroll factor (default 8)

The persistent compile cache follows vaudio.utils.compile_cache
(JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache).
"""

import json
import os
import sys
import time


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    from vaudio.utils.compile_cache import enable_compile_cache
    from vaudio.utils.device import (parse_name_power, query_name_power,
                                     require_gpu)
    enable_compile_cache()
    try:
        device = require_gpu()
        device["cards"] = [{"name": n, "power_limit": p} for n, p in
                           parse_name_power(query_name_power())]
    except (RuntimeError, ValueError) as e:
        log(f"bench: {e}")
        return 2
    device["xla_flags"] = os.environ.get("XLA_FLAGS", "")
    log(f"bench: device {device}")

    import jax
    import jax.numpy as jnp

    from vaudio.config import AuralizerConfig
    from vaudio.dsp import hann_window_norm
    from vaudio.runtime.step import default_params, frame_step, init_carry
    from vaudio.synth import SynthConstants

    res = os.environ.get("VAUDIO_BENCH_RES", "1080x1920")
    h, w = (int(x) for x in res.split("x"))
    chunks = [int(x) for x in
              os.environ.get("VAUDIO_BENCH_CHUNKS", "16,128").split(",")]
    iters = int(os.environ.get("VAUDIO_BENCH_ITERS", "12"))
    matmul_irfft = os.environ.get("VAUDIO_BENCH_MATMUL_IRFFT", "0") == "1"
    matmul_ema = os.environ.get("VAUDIO_BENCH_MATMUL_EMA", "0") == "1"
    # Default "1" tracks the AuralizerConfig default (fast_hue_acos=True)
    # so bench.py measures what production runs.
    fast_acos = os.environ.get("VAUDIO_BENCH_FAST_ACOS", "1") == "1"
    quantize = os.environ.get("VAUDIO_BENCH_QUANTIZE", "0") == "1"
    quantize_int8 = os.environ.get("VAUDIO_BENCH_QUANTIZE_INT8",
                                   "0") == "1"
    channels = int(os.environ.get("VAUDIO_BENCH_CHANNELS", "2"))
    also_mono = os.environ.get("VAUDIO_BENCH_MONO", "1") == "1" \
        and channels == 2
    unroll = int(os.environ.get("VAUDIO_BENCH_UNROLL", "8"))
    scan_block = int(os.environ.get("VAUDIO_BENCH_SCAN_BLOCK", "8"))

    log(f"bench: frame={h}x{w} chunks={chunks}")

    def measure(ch, mode="chunked"):
        """``mode``: 'chunked' = the chunk-batched pipeline (serial scan
        only for the hue EMA, ONE frame-batched contraction for the heavy
        stage — runtime.chunked); 'scan' = the sequential path (blocked
        sub-chunks, or the per-frame lax.scan of frame_step)."""
        cfg = AuralizerConfig(sample_rate=48000.0,
                              use_matmul_irfft=matmul_irfft,
                              use_matmul_ema=matmul_ema,
                              fast_hue_acos=fast_acos,
                              quantize_mips=quantize,
                              quantize_mips_int8=quantize_int8,
                              channels=ch)
        consts = SynthConstants.create(cfg)
        window = jnp.asarray(hann_window_norm(cfg.nfft))
        params = default_params(cfg)
        if mode == "chunked":
            from vaudio.runtime.chunked import chunk_pipeline

        # One compiled program per chunk length.
        def bench_chunk(T, seed0):
            # Frames are uint8 (the camera-native ingest dtype; the step
            # normalizes on device) and DEVICE-RESIDENT before timing
            # starts: the measured region is exactly the frame->audio
            # pipeline.  Generated in <=8-frame slices: threefry's u32
            # intermediates are 4x the u8 output.
            parts = []
            for i in range(0, T, 8):
                n = min(8, T - i)
                parts.append(jax.random.bits(
                    jax.random.PRNGKey(seed0 + 7919 * i),
                    (n, h, w, 3), jnp.uint8))
            frames = (jnp.concatenate(parts, axis=0) if len(parts) > 1
                      else parts[0])
            del parts
            jax.block_until_ready(frames)

            if mode == "chunked":
                @jax.jit
                def scan_chunk(carry, frames):
                    return chunk_pipeline(carry, frames, params, cfg,
                                          consts, window)
            elif scan_block > 1:
                from vaudio.runtime.chunked import blocked_pipeline

                @jax.jit
                def scan_chunk(carry, frames):
                    return blocked_pipeline(carry, frames, params, cfg,
                                            consts, window,
                                            block=scan_block)
            else:
                @jax.jit
                def scan_chunk(carry, frames):
                    def body(c, f):
                        return frame_step(c, f, params, cfg, consts,
                                          window)
                    # unroll lets XLA overlap kernels across iterations —
                    # the single-stream step is scheduling-gap-bound.
                    return jax.lax.scan(body, carry, frames,
                                        unroll=unroll)

            carry = init_carry(cfg)
            t0 = time.perf_counter()
            carry, outs = scan_chunk(carry, frames)
            jax.block_until_ready(outs["pcm"])
            log(f"bench[ch={ch},{mode}]: chunk{T} first call (incl. "
                f"compile) {time.perf_counter() - t0:.1f}s")
            # MIN of two timed loops: host pauses (GC, scheduling) only
            # ever INFLATE a loop, so the min is the better estimator of
            # the true per-call time.
            best = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                for i in range(iters):
                    carry, outs = scan_chunk(carry, frames)
                jax.block_until_ready(outs["pcm"])
                best = min(best,
                           (time.perf_counter() - t0) / iters * 1e3)
            return best  # ms/call

        # The MEDIAN of several interleaved slope estimates (compiles are
        # shared; each extra estimate is only `iters` timed calls).
        n_reps = int(os.environ.get("VAUDIO_BENCH_SLOPE_REPS", "3"))
        max_reps = int(os.environ.get("VAUDIO_BENCH_MAX_REPS", "8"))
        seed = 0
        import statistics

        # Adaptive reps with positive-slope filtering: host noise can
        # inflate EITHER endpoint of a slope pair, so a single rep can
        # come out negative.  Keep sampling until >= 3 positive slopes agree
        # within 40% of their median, or the rep budget runs out; the
        # reported number is the median of the positive slopes.
        slopes: list = []
        rep = 0
        stable = False

        def mid3(ss):
            v = sorted(s for s in ss if s > 0)
            return v[(len(v) - 3) // 2:][:3] if len(v) >= 3 else v

        while True:
            t_small = bench_chunk(chunks[0], seed + rep)
            t_big = bench_chunk(chunks[1], seed + 1000 + rep)
            ms = (t_big - t_small) / (chunks[1] - chunks[0])
            log(f"bench[ch={ch},{mode}] rep{rep}: "
                f"chunk{chunks[0]}={t_small:.1f}ms "
                f"chunk{chunks[1]}={t_big:.1f}ms -> {ms * 1e3:.0f} "
                f"us/frame")
            slopes.append(ms)
            rep += 1
            valid = sorted(s for s in slopes if s > 0)
            if rep >= n_reps and len(valid) >= 3:
                med = statistics.median(valid)
                mid = mid3(slopes)
                if (mid[-1] - mid[0]) <= 0.4 * med:
                    stable = True
                    break
                log(f"bench[ch={ch},{mode}]: slopes unstable "
                    f"({[round(s * 1e3) for s in valid]} us) — extra rep")
            if rep >= max_reps:
                break
        valid = [s for s in slopes if s > 0]
        fallback = False
        if valid:
            # Median of the middle-3 positive slopes: identical to the
            # plain median when the stability gate passed, outlier-
            # trimmed when it never did.
            ms_per_frame = statistics.median(mid3(slopes))
        else:
            # Last resort (every slope came out <= 0): report the best
            # whole-call time per frame at the large chunk — an honest
            # UPPER bound (includes per-dispatch overhead), never
            # garbage-negative.
            fallback = True
            ms_per_frame = bench_chunk(chunks[1], seed + 4242) / chunks[1]
        fps = 1000.0 / ms_per_frame
        rtf = fps / cfg.video_fps
        if fallback:
            log(f"bench[ch={ch},{mode}]: all {rep} slopes non-positive; "
                f"per-call UPPER BOUND {ms_per_frame:.3f} ms/frame "
                f"(NOT a slope) -> {fps:.0f} frames/s = {rtf:.1f}x "
                f"realtime @30fps")
        else:
            log(f"bench[ch={ch},{mode}]: median {ms_per_frame:.3f} "
                f"ms/frame over {len(valid)}/{rep} slopes "
                f"({'stable' if stable else 'UNSTABLE'}) -> "
                f"{fps:.0f} frames/s = {rtf:.1f}x "
                f"realtime @30fps; audio out "
                f"{fps * cfg.hop_size * ch / 1e6:.2f} Msamples/s")
        quality = {"slopes_us": [round(s * 1e3, 2) for s in slopes],
                   "valid_reps": len(valid), "stable": stable,
                   "fallback_upper_bound": fallback}
        return rtf, ms_per_frame, quality

    rtf, ms_per_frame, quality = measure(channels, "chunked")
    record = {
        "metric": ("realtime_factor_1080p30_to_48kHz_stereo_per_chip"
                   if channels == 2 else
                   "realtime_factor_1080p30_to_48kHz_per_chip"),
        "value": round(rtf, 2),
        "unit": "x_realtime",
        "vs_baseline": round(rtf / 10.0, 3),
        "us_per_frame": round(ms_per_frame * 1e3, 2),
        "device": device,
        # Measurement-quality markers: a degraded-host fallback or an
        # unstable median must be distinguishable from a clean slope
        # measurement downstream.
        "stable": quality["stable"],
        "valid_reps": quality["valid_reps"],
        "slopes_us": quality["slopes_us"],
    }
    if quality["fallback_upper_bound"]:
        record["fallback_upper_bound"] = True
    if quantize:
        record["quantize_mips"] = True   # strict-parity 8-bit mip chain
    if os.environ.get("VAUDIO_BENCH_SCAN", "1") == "1":
        s_rtf, _, s_q = measure(channels, "scan")
        record["scan_path_x_realtime"] = round(s_rtf, 2)
        record["scan_stable"] = s_q["stable"]
        # Dispatch granularity of the sequential scan measured above
        # (>1 = blocked sub-chunks, else the per-frame scan).
        record["scan_block"] = scan_block
    if also_mono:
        m_rtf, _, m_q = measure(1, "chunked")
        record["mono_x_realtime"] = round(m_rtf, 2)
        record["mono_stable"] = m_q["stable"]
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
