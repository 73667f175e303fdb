#!/usr/bin/env python
"""Smoke test of vaudio's main path on an NVIDIA GPU.

Drives the public entry points once at the default deployment's full
width — 1080x1920 u8 RGB frames at 30 fps, mip level 3, a 4x4 cell grid,
360 hue bins, 13 harmonics + 18 Bessel partials per cell, a 4096-point
IFFT with a 2048 hop, 48 kHz stereo out — and checks the audio by the
repo's own means.  Phases, all on one card:

1. device   JAX must find a GPU (there is no CPU fallback); prints the
            device kind and count, XLA_FLAGS, and the card's name and
            power limit as nvidia-smi reports them.
2. offline  ``Auralizer.sonify`` chunked and scan on 64 structured
            frames: PCM shape and finiteness, golden hue -> f0 (solid
            green -> the ~440 Hz comb), chunked vs scan within the
            documented band, the first 8 frames vs the same jitted
            pipeline on the host CPU; compile time (set-up), the chunk
            step's memory analysis and the peak device memory.
3. parity   each numerics-critical stage against a float64 oracle on
            the device (an f32 dot left at DEFAULT precision would run
            in TF32 here and fail).
4. stream   ``Auralizer(realtime=True)`` start/pull at chunk 1, 60
            frames fed at 30 fps; PCM for every consumed frame; drop,
            underrun and frame->audio latency printed for information.
5. pod      one 8-slot ``MultiStreamAuralizer``, each slot against its
            single-stream result.

``--four`` instead runs only the multi-device paths on four GPUs (DP-4
chunked step, 2x2 stream x cell step with its psum, the OrthoModes DP
step, a MultiHostPod tick, and a 4-slot MultiStreamAuralizer over the
4-device mesh), each against its one-device result.

The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
a failing phase exits non-zero without it.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

from __graft_entry__ import hue_bands_u8, max_err, multichip_paths
from vaudio.config import AuralizerConfig, LiveParams

FULL_HEIGHT, FULL_WIDTH = 1080, 1920
FULL_CONFIG = AuralizerConfig(sample_rate=48000.0, channels=2)
GREEN_HUE = 0.33          # README quick start: solid green -> 440 Hz comb

# Chunked vs scan: the default prefix-sum phases random-walk away from
# the serial scan by ~f32 ulp of the raw phase advance per frame
# (config.use_cumsum_phases); tests/test_chunked.py bounds the audio at
# 2e-3 for 32 frames, and the walk grows about linearly with the frame
# count, so 64 frames get twice that.
CHUNKED_VS_SCAN_ATOL = 4e-3
# GPU vs host CPU on the same jitted pipeline: the backends' exp2, sin
# and cos differ by an ulp, and a raw per-frame phase advance reaches
# ~5400 rad (f32 ulp ~5e-4 rad), so phases can part by ~1e-3 rad within
# 8 frames; cuFFT vs the CPU FFT and the dots' summation order add
# ~1e-6.  Hues are integers from exact integer histograms: equal.
GPU_VS_CPU_ATOL = 1e-3
# Pod slot vs single-stream run: the same per-frame step vmapped over 8
# slots; batch-dependent algorithm choice reorders float sums (the bound
# of tests/test_multistream.py).
POD_VS_SINGLE_ATOL = 2e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def last_line(info: dict) -> str:
    """The result line: exactly platform, kind and count under
    ``device``."""
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})


def check(name: str, err: float, tol: float, out: dict) -> None:
    out[name] = err
    log(f"  {name}: max error {err:.3e} (tolerance {tol:.1e})")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err:.3e} exceeds {tol:.1e}")


def structured_frames(n_frames: int, height: int, width: int,
                      n_banded: int) -> np.ndarray:
    """``n_banded`` frames of four hue bands, then solid green (all u8)."""
    banded = hue_bands_u8([0.0, 0.25, 0.5, 0.75], height, width)
    green = hue_bands_u8([GREEN_HUE], height, width)
    return np.stack([banded] * n_banded + [green] * (n_frames - n_banded))


def hue_bin(rgb_u8, bins: int) -> int:
    """Host float64 oracle of the histogram bin of one RGB pixel
    (convolveFeatures.metal:14-38,159)."""
    r, g, b = (float(c) / 255.0 for c in rgb_u8)
    num = 0.5 * ((r - g) + (r - b))
    den = np.sqrt((r - g) ** 2 + (r - b) * (g - b))
    theta = np.arccos(np.clip(num / den, -1.0, 1.0))
    h = (theta if b <= g else 2 * np.pi - theta) / (2 * np.pi)
    return int(min(max(int(h * (bins - 1)), 0), bins - 1))


def dominant_freqs(pcm, sample_rate: float, top: int = 8):
    """Frequencies of the ``top`` strongest rfft bins of the last 4096
    samples (one channel)."""
    tail = np.asarray(pcm, np.float64)[-4096:]
    spec = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
    freqs = np.fft.rfftfreq(len(tail), 1.0 / sample_rate)
    return freqs[np.argsort(spec)[::-1][:top]]


def memory_summary(compiled) -> str:
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    if ma is None or not all(hasattr(ma, f) for f in fields):
        return str(ma)
    return ", ".join(f"{f[:-len('_size_in_bytes')]}="
                     f"{getattr(ma, f) / 2**20:.1f} MiB" for f in fields)


def peak_memory(device) -> str:
    stats = device.memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "not reported by this backend"
    return f"{stats['peak_bytes_in_use'] / 2**20:.1f} MiB"


# ---------------------------------------------------------------------------
# Phases.  Each takes its configuration and sizes as arguments (the tests
# run them at 64x64 on the CPU backend), returns its measured errors and
# raises on any failed check.
# ---------------------------------------------------------------------------

def phase_offline(cfg: AuralizerConfig, frames: np.ndarray,
                  cpu_frames: int = 8) -> dict:
    import jax
    import jax.numpy as jnp

    from vaudio.api import Auralizer
    from vaudio.runtime.chunked import make_chunk_pipeline
    from vaudio.runtime.step import init_carry
    from vaudio.synth import SynthConstants

    out = {}
    T = frames.shape[0]
    hop, ch = cfg.hop_size, cfg.channels
    params = LiveParams().as_arrays()
    dev = jax.devices()[0]

    # Set-up: compile the T-frame chunk step ahead of time.
    step = make_chunk_pipeline(cfg)
    frames_dev = jax.device_put(frames, dev)
    t0 = time.perf_counter()
    compiled = step.lower(init_carry(cfg), frames_dev, params).compile()
    out["compile_s"] = time.perf_counter() - t0
    log(f"  compile of the T={T} chunk step: {out['compile_s']:.1f} s "
        "(set-up time)")
    log(f"  memory_analysis: {memory_summary(compiled)}")
    del frames_dev, compiled

    aur = Auralizer(config=cfg)
    t0 = time.perf_counter()
    pcm_c, dbg_c = aur.sonify(frames, debug=True, mode="chunked")
    log(f"  sonify chunked, first call incl. compile: "
        f"{time.perf_counter() - t0:.1f} s")
    want = (T * hop,) if ch == 1 else (T * hop, ch)
    if pcm_c.shape != want:
        raise AssertionError(f"chunked PCM shape {pcm_c.shape} != {want}")
    if not np.all(np.isfinite(pcm_c)) or np.abs(pcm_c).max() < 1e-3:
        raise AssertionError("chunked PCM is non-finite or silent")
    t0 = time.perf_counter()
    pcm_s, dbg_s = aur.sonify(frames, debug=True, mode="scan")
    log(f"  sonify scan, first call incl. compile: "
        f"{time.perf_counter() - t0:.1f} s")
    if pcm_s.shape != want or not np.all(np.isfinite(pcm_s)):
        raise AssertionError(f"scan PCM shape {pcm_s.shape} or non-finite")
    if not np.array_equal(dbg_c["hues"], dbg_s["hues"]):
        raise AssertionError("chunked and scan hues differ")
    check("chunked_vs_scan_pcm", max_err(pcm_c, pcm_s),
          CHUNKED_VS_SCAN_ATOL, out)

    # Golden hue -> f0 with instant smoothing (the hue EMA truncates
    # toward its start otherwise): every cell of a solid green frame
    # takes the host oracle's bin, and the strongest partial of each
    # channel sits on the snapped fundamental 220 * 2^(3 hue / 360).
    green = np.stack([hue_bands_u8([GREEN_HUE], *frames.shape[1:3])] * T)
    golden = Auralizer(config=cfg, params=LiveParams(spectrum_mixing=0.0))
    pcm_g, dbg_g = golden.sonify(green, debug=True, mode="chunked")
    b = hue_bin(green[0, 0, 0], cfg.num_hue_bins)
    hues = np.asarray(dbg_g["hues"][-1])
    if not np.all(hues == b):
        raise AssertionError(f"green hues {hues} != oracle bin {b}")
    freqs = SynthConstants.create(cfg).freqs
    f0 = float(freqs[np.argmin(np.abs(
        freqs - 220.0 * 2.0 ** (3.0 * b / 360.0)))])
    if abs(f0 - 440.0) > 0.03 * 440.0:
        raise AssertionError(f"green f0 {f0:.1f} Hz is not the 440 Hz comb")
    chans = [pcm_g] if ch == 1 else [pcm_g[:, c] for c in range(ch)]
    for c, x in enumerate(chans):
        off = np.min(np.abs(dominant_freqs(x, cfg.sample_rate) - f0))
        if off >= 2 * cfg.bin_width:
            raise AssertionError(f"channel {c}: no peak within 2 bins of "
                                 f"f0 {f0:.1f} Hz")
    out["green_f0_hz"] = f0
    log(f"  golden: green -> hue bin {b} in all cells -> f0 {f0:.1f} Hz, "
        f"strongest partials on it in {len(chans)} channel(s)")

    # The first frames through the same jitted pipeline on the host CPU.
    n = min(cpu_frames, T)
    dstep = make_chunk_pipeline(cfg, debug=True)
    _, dev_out = dstep(init_carry(cfg), jnp.asarray(frames[:n]), params)
    cpu = jax.devices("cpu")[0]
    _, cpu_out = dstep(jax.device_put(init_carry(cfg), cpu),
                       jax.device_put(frames[:n], cpu),
                       jax.device_put(params, cpu))
    if not np.array_equal(np.asarray(dev_out["hues"]),
                          np.asarray(cpu_out["hues"])):
        raise AssertionError(f"{dev.platform} and CPU hues differ")
    check(f"{dev.platform}_vs_cpu_pcm_{n}_frames",
          max_err(dev_out["pcm"], cpu_out["pcm"]), GPU_VS_CPU_ATOL, out)
    log(f"  peak device memory: {peak_memory(dev)}")
    return out


def phase_parity(height: int, width: int, seed: int = 20260816) -> dict:
    """Each parity-critical stage on the default device against a
    float64 host oracle, with the repo's tolerances."""
    import jax
    import jax.numpy as jnp

    from vaudio.dsp import hann_sinc_peak_fast
    from vaudio.runtime.step import init_carry
    from vaudio.synth import SynthConstants, phase_accumulate, \
        phase_advance
    from vaudio.synth.spectrum import contract_spectrum
    from vaudio.vision.features import (acos_poly, hue_histogram_planes,
                                        mip_downsample_planes,
                                        rgb_to_hsi_planes)

    out = {}
    rng = np.random.default_rng(seed)
    cfg = AuralizerConfig()

    # -- mip chain, u8 integer path and f32 path, vs the f64 box mean
    planes = rng.integers(0, 256, (3, height, width), dtype=np.uint8)
    k = 1 << 3
    ho, wo = height >> 3, width >> 3
    oracle = planes[:, :ho * k, :wo * k].astype(np.float64).reshape(
        3, ho, k, wo, k).sum(axis=(2, 4)) / (255.0 * k * k)
    got = mip_downsample_planes(jnp.asarray(planes), 3, scale=1 / 255.0)
    check("mip_u8_int8_path", max_err(got, oracle), 1e-6, out)
    got = mip_downsample_planes(
        jnp.asarray(planes.astype(np.float32) / 255.0), 3)
    check("mip_f32_path", max_err(got, oracle), 2e-6, out)

    # -- tiled two-level histogram vs integer host binning, at the mip
    # dims of this frame size (1080p: 135 x 240, ragged cells)
    hm, wm = ho, wo
    hp, sp, ip = (rng.random((hm, wm)).astype(np.float32) for _ in range(3))
    got = hue_histogram_planes(jnp.asarray(hp), jnp.asarray(sp),
                               jnp.asarray(ip), cfg)
    gate = (sp > cfg.saturation_gate) & (ip > cfg.intensity_gate)
    bins_i = np.clip((hp * np.float32(cfg.num_hue_bins - 1)
                      ).astype(np.int32), 0, cfg.num_hue_bins - 1)
    y, x = np.mgrid[0:hm, 0:wm]
    cell = (x * cfg.grid_size) // wm * cfg.grid_size \
        + ((hm - 1 - y) * cfg.grid_size) // hm
    oracle_h = np.zeros((cfg.num_cells, cfg.num_hue_bins))
    np.add.at(oracle_h, (cell[gate], bins_i[gate]), 1.0)
    check("hue_histogram_tiled", max_err(got, oracle_h), 0.0, out)

    # -- polynomial acos (fast_hue_acos): the polynomial's promise
    # (2e-8 rad) plus an ulp or so of device sqrt/fma rounding near pi
    # (f32 ulp 2.4e-7); then its effect on hue planes vs jnp.arccos
    xg = np.linspace(-1.0, 1.0, 200_001).astype(np.float32)
    check("acos_poly_dense_grid",
          max_err(acos_poly(jnp.asarray(xg)),
                  np.arccos(xg.astype(np.float64))), 8e-7, out)
    rp, gp, bp = (jnp.asarray(rng.random((hm, wm)).astype(np.float32))
                  for _ in range(3))
    h_poly = rgb_to_hsi_planes(rp, gp, bp, fast_acos=True)[0]
    h_ref = rgb_to_hsi_planes(rp, gp, bp, fast_acos=False)[0]
    check("hsi_hue_poly_vs_exact", max_err(h_poly, h_ref), 1e-6, out)

    # -- spectrum contraction: the dot's own error, against the same f32
    # peak matrix contracted in f64 on the host
    consts = SynthConstants.create(cfg)
    npartials = int(consts.seed_phase.size)
    pf = rng.uniform(30.0, 8000.0, npartials).astype(np.float32)
    wgt = rng.normal(0, 1e-3, (npartials, 2)).astype(np.float32)
    ibw = np.full(npartials, 1.0 / cfg.narrow_bandwidth, np.float32)
    cur = contract_spectrum(jnp.asarray(pf), jnp.asarray(wgt),
                            jnp.asarray(ibw), cfg, consts)
    d32 = (np.asarray(consts.freqs)[:, None] - pf[None, :]) \
        * (np.float32(1.0 / cfg.bin_width) * ibw)[None, :]
    W = np.asarray(hann_sinc_peak_fast(jnp.asarray(d32)), np.float64)
    oracle_c = W @ wgt.astype(np.float64)
    check("spectrum_contraction", max_err(cur, oracle_c),
          np.abs(oracle_c).max() * 2e-6 + 1e-9, out)

    # -- phase accumulation over 128 frames, serial vs prefix sum, vs an
    # f64 oracle (circular errors; the documented random-walk band of
    # config.use_cumsum_phases with 2x headroom)
    T = 128
    hues_seq = jnp.asarray(rng.integers(0, 360, (T, cfg.num_cells)),
                           jnp.int32)
    p0 = jnp.asarray(rng.uniform(0, 2 * np.pi, init_carry(cfg).phases.shape),
                     jnp.float32)
    two_pi = np.float32(2.0 * np.pi)

    @jax.jit
    def both_paths(p0, hues_seq):
        serial, _ = jax.lax.scan(
            lambda p, h: (phase_accumulate(p, h, cfg, consts), None),
            p0, hues_seq)
        adv = jax.vmap(lambda h: phase_advance(h, cfg, consts))(hues_seq)
        pre = jax.lax.associative_scan(
            lambda a, b: jnp.mod(a + b, two_pi), jnp.mod(adv, two_pi),
            axis=0)
        return serial, jnp.mod(p0 + pre[-1], two_pi), adv

    serial, cum, adv = (np.asarray(a, np.float64)
                        for a in both_paths(p0, hues_seq))

    def circ(a, b):
        d = np.abs(a - b)
        return float(np.minimum(d, 2 * np.pi - d).max())

    oracle_p = np.mod(np.asarray(p0, np.float64) + adv.sum(axis=0),
                      2 * np.pi)
    check("phase_serial_vs_f64", circ(serial, oracle_p), 3.2e-2, out)
    check("phase_cumsum_vs_f64", circ(cum, oracle_p), 3.2e-2, out)
    check("phase_cumsum_vs_serial", circ(cum, serial), 2e-2, out)
    return out


def phase_stream(cfg: AuralizerConfig, frames: np.ndarray,
                 card: str = "") -> dict:
    """Live path: realtime producer at cfg.video_fps, chunk 1, and an
    audio-callback consumer pulling 512-sample quanta in real time."""
    from vaudio.api import Auralizer

    out = {}
    hop = cfg.hop_size * cfg.channels
    aur = Auralizer(config=cfg, realtime=True)
    # Warm-up (compile, and latch the ring's warm-up gate): not measured.
    aur.run_until_exhausted(iter(frames[:cfg.warmup_frames]), timeout=900)
    aur.pull(hop)
    aur.stop()
    under0 = aur.metrics["underrun_samples"]
    drop0 = aur.metrics["dropped_frames"]

    aur.start(iter(frames))
    pulled = []
    for block in aur.audio_stream(quantum=512, pace=True):
        pulled.append(block)
    aur.raise_if_failed()
    m = aur.metrics
    pcm = np.concatenate(pulled)
    consumed = m["frames_processed"]
    dropped = m["dropped_frames"] - drop0
    underrun = m["underrun_samples"] - under0
    if consumed != len(frames):
        raise AssertionError(f"engine consumed {consumed} of "
                             f"{len(frames)} frames")
    if not np.all(np.isfinite(pcm)):
        raise AssertionError("stream PCM is non-finite")
    delivered = pcm.size - underrun
    if delivered != (consumed - dropped) * hop:
        raise AssertionError(
            f"{delivered} PCM samples reached the consumer for "
            f"{consumed - dropped} written frames of {hop}")
    out.update(frames=consumed, dropped=dropped, underrun_samples=underrun,
               latency_p50_ms=m["latency_p50_ms"],
               latency_p99_ms=m["latency_p99_ms"])
    log(f"  {consumed} frames consumed, PCM for each written frame; "
        f"dropped {dropped}, underrun samples {underrun}")
    log(f"  frame->audio latency p50 {m['latency_p50_ms']:.2f} ms, p99 "
        f"{m['latency_p99_ms']:.2f} ms (informational; {card})")
    return out


def pod_vs_single(pod, cfg: AuralizerConfig, clips) -> float:
    """Run ``pod`` over ``clips`` (one per slot) to the end and return the
    largest PCM difference between a slot and a single-stream run of the
    same per-frame step on the same clip."""
    import jax.numpy as jnp

    from vaudio.runtime import init_carry, make_step
    from vaudio.runtime.step import default_params

    try:
        pod.start([iter(c) for c in clips])
        t0 = time.monotonic()
        while pod.is_running:
            pod.raise_if_failed()
            if time.monotonic() - t0 > 900:
                raise TimeoutError("pod still running")
            time.sleep(0.005)
        pod.raise_if_failed()
        step, params, errs = make_step(cfg), default_params(cfg), []
        for s, clip in enumerate(clips):
            carry, ref = init_carry(cfg), []
            for f in clip:
                carry, o = step(carry, jnp.asarray(f), params)
                ref.append(np.asarray(o["pcm"]).reshape(-1))
            errs.append(max_err(pod.pull(s, sum(r.size for r in ref)),
                                np.concatenate(ref)))
    finally:
        pod.stop()
    return max(errs)


def phase_pod(cfg: AuralizerConfig, clips) -> dict:
    """One batched pod on one device, each slot against its single-stream
    result."""
    from vaudio.runtime import MultiStreamAuralizer

    out = {}
    pod = MultiStreamAuralizer(cfg, n_streams=len(clips))
    check(f"pod_{len(clips)}_slots_vs_single", pod_vs_single(pod, cfg, clips),
          POD_VS_SINGLE_ATOL, out)
    return out


def phase_four(devices, height: int, width: int) -> dict:
    """The multi-device paths over ``devices``, each against its
    one-device result, plus a pod over a mesh of all of them."""
    from vaudio.parallel import make_stream_mesh
    from vaudio.runtime import MultiStreamAuralizer

    out = dict(multichip_paths(devices, height, width,
                               log=lambda m: log(f"  {m}")))
    cfg = FULL_CONFIG
    n = len(devices)
    clips = [np.stack([hue_bands_u8((s / n + np.arange(4) / 4.0) % 1.0,
                                    height, width)] * 3) for s in range(n)]
    pod = MultiStreamAuralizer(cfg, n_streams=n, params=LiveParams(),
                               mesh=make_stream_mesh(n, 1, devices=devices))
    check(f"mesh_pod_{n}_slots_vs_single", pod_vs_single(pod, cfg, clips),
          POD_VS_SINGLE_ATOL, out)
    return out


# ---------------------------------------------------------------------------

def _keep_host_cpu_backend() -> None:
    """The offline phase compares against the host CPU backend, so keep
    it initialized beside the accelerator when JAX_PLATFORMS narrows the
    platform list (it must run before the first backend use)."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        import jax
        jax.config.update("jax_platforms", plats + ",cpu")


def run_phase(name: str, fn, *args, **kwargs) -> dict:
    log(f"phase {name}:")
    t0 = time.perf_counter()
    res = fn(*args, **kwargs)
    log(f"phase {name}: OK in {time.perf_counter() - t0:.1f} s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on 4 GPUs")
    args = ap.parse_args(argv)

    _keep_host_cpu_backend()
    from vaudio.utils.compile_cache import enable_compile_cache
    from vaudio.utils.device import (jax_device_info, parse_name_power,
                                     query_name_power)
    enable_compile_cache()

    import jax
    info = jax_device_info()
    log(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    if info["platform"] != "gpu":
        print(f"chip_smoke: JAX found no GPU (default backend "
              f"{info['platform']!r}); nothing was run", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if info["count"] < need:
        print(f"chip_smoke: needs {need} GPU(s), JAX sees "
              f"{info['count']}", file=sys.stderr)
        return 2
    try:
        card = query_name_power()
        log(card)
        card_line = ", ".join(parse_name_power(card)[0])
        if args.four:
            run_phase("four", phase_four, jax.devices()[:4], FULL_HEIGHT,
                      FULL_WIDTH)
        else:
            cfg = FULL_CONFIG
            frames = structured_frames(64, FULL_HEIGHT, FULL_WIDTH,
                                       n_banded=16)
            run_phase("offline", phase_offline, cfg, frames)
            run_phase("parity", phase_parity, FULL_HEIGHT, FULL_WIDTH)
            run_phase("stream", phase_stream, cfg, frames[:60],
                      card=card_line)
            clips = [np.stack([hue_bands_u8(
                (s / 8 + np.arange(4) / 4.0) % 1.0, FULL_HEIGHT,
                FULL_WIDTH)] * 4) for s in range(8)]
            run_phase("pod", phase_pod, cfg, clips)
            log(f"peak device memory: {peak_memory(jax.devices()[0])}")
    except Exception:                # report, then fail without a result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(last_line(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
