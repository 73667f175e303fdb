"""Public API + IO + CLI tests (the VideoToAudio-surface parity layer)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from vaudio.api import Auralizer
from vaudio.config import AuralizerConfig, LiveParams
from vaudio.io import (ArraySource, bgra_to_rgb, hsb_frames, hsb_to_rgb,
                       read_wav, solid_color_frames, write_wav)
from vaudio.utils import peak_shape_curve, spectrum_display, FrameTimer


class TestIO:
    def test_wav_roundtrip(self, tmp_path, rng):
        audio = rng.uniform(-0.9, 0.9, 8192).astype(np.float32)
        path = str(tmp_path / "t.wav")
        write_wav(path, audio, 44100.0)
        back, sr = read_wav(path)
        assert sr == 44100.0
        np.testing.assert_allclose(back, audio, atol=1e-4)

    def test_wav_stereo(self, tmp_path, rng):
        audio = rng.uniform(-0.5, 0.5, (1024, 2)).astype(np.float32)
        path = str(tmp_path / "s.wav")
        write_wav(path, audio, 48000.0, channels=2)
        back, sr = read_wav(path)
        assert back.shape == (1024, 2) and sr == 48000.0

    def test_mono_to_stereo_upmix(self, tmp_path):
        write_wav(str(tmp_path / "u.wav"), np.zeros(64, np.float32),
                  channels=2)
        back, _ = read_wav(str(tmp_path / "u.wav"))
        assert back.shape == (64, 2)

    def test_bgra_to_rgb(self):
        bgra = np.zeros((2, 2, 4), np.uint8)
        bgra[..., 0] = 255   # blue channel
        rgb = bgra_to_rgb(bgra)
        np.testing.assert_allclose(rgb[..., 2], 1.0)
        np.testing.assert_allclose(rgb[..., 0], 0.0)

    def test_hsb_to_rgb_primaries(self):
        np.testing.assert_allclose(hsb_to_rgb(0.0, 1.0, 1.0), [1, 0, 0],
                                   atol=1e-6)
        np.testing.assert_allclose(hsb_to_rgb(1 / 3, 1.0, 1.0), [0, 1, 0],
                                   atol=1e-6)
        np.testing.assert_allclose(hsb_to_rgb(2 / 3, 1.0, 1.0), [0, 0, 1],
                                   atol=1e-6)
        # brightness/saturation behavior
        np.testing.assert_allclose(hsb_to_rgb(0.5, 0.0, 0.7),
                                   [0.7, 0.7, 0.7], atol=1e-6)

    def test_array_source(self, tmp_path, rng):
        frames = (rng.uniform(0, 255, (4, 16, 16, 3))).astype(np.uint8)
        src = ArraySource(frames, fps=30.0)
        assert src.shape == (16, 16) and src.num_frames == 4
        lst = list(src.frames())
        # uint8 is preserved (device-side normalization saves 4x ingest BW)
        assert len(lst) == 4 and lst[0].dtype == np.uint8
        as_f = ArraySource(frames, as_float=True)
        np.testing.assert_allclose(as_f.tensor(),
                                   frames.astype(np.float32) / 255.0)
        path = str(tmp_path / "f.npy")
        np.save(path, frames)
        src2 = ArraySource.load(path)
        np.testing.assert_allclose(src2.tensor(), src.tensor())

    def test_array_source_rejects_bad_shape(self):
        with pytest.raises(ValueError):
            ArraySource(np.zeros((4, 16, 16)))


class TestAuralizerAPI:
    def test_offline_sonify(self):
        aur = Auralizer()
        frames = solid_color_frames([1, 0.1, 0.1], 128, 128, 4)
        audio = aur.sonify(frames)
        assert audio.shape == (4 * 2048,)
        assert np.all(np.isfinite(audio))

    def test_sonify_with_debug(self):
        aur = Auralizer()
        frames = solid_color_frames([0.1, 1, 0.1], 128, 128, 2)
        audio, dbg = aur.sonify(frames, debug=True)
        assert dbg["hues"].shape == (2, 16)
        assert dbg["spectrum"].shape == (2, 2047, 2)

    def test_sonify_to_wav(self, tmp_path):
        aur = Auralizer()
        frames = solid_color_frames([1, 0.1, 0.1], 128, 128, 3)
        path = str(tmp_path / "o.wav")
        aur.sonify_to_wav(frames, path)
        back, sr = read_wav(path)
        assert len(back) == 3 * 2048 and sr == 44100.0

    def test_streaming_lifecycle_and_metrics(self):
        frames = solid_color_frames([1, 0.1, 0.1], 128, 128, 6)
        aur = Auralizer(source=frames, debug=True)
        assert not aur.is_running
        aur.run_until_exhausted()
        m = aur.metrics
        assert m["frames_processed"] == 6
        assert m["processing_latency_ms"] > 0
        assert "hues" in aur.debug
        pcm = aur.pull(1024)
        assert pcm.shape == (1024,)
        aur.stop()
        assert aur.metrics["buffer_fill"] == 0

    def test_source_object_with_frames_method(self, tmp_path):
        """Auralizer(source=<any source object>) must duck-type .frames()
        — previously only ArraySource/ndarray worked and every other
        source (RawVideoSource, VideoFileSource, Cv2CameraSource) had to
        be pre-converted by the caller."""
        frames = solid_color_frames([0.1, 1, 0.1], 64, 64, 4)

        class MySource:                      # user-defined source contract
            shape = (64, 64)

            def frames(self):
                yield from frames

        aur = Auralizer(source=MySource())
        aur.run_until_exhausted()
        assert aur.metrics["frames_processed"] == 4
        aur.stop()

    def test_chunk_frames_and_metrics_log_kwargs(self, tmp_path):
        """Auralizer forwards chunk_frames/metrics_log to the streaming
        loop: the throughput knob and the JSONL log are front-door
        options, not StreamingAuralizer-only (SERVING.md's 'one knob
        that matters')."""
        frames = solid_color_frames([1, 0.2, 0.1], 64, 64, 8)
        log = str(tmp_path / "m.jsonl")
        aur = Auralizer(source=frames, chunk_frames=4, metrics_log=log,
                        debug=False)
        aur.run_until_exhausted()
        m = aur.metrics
        assert m["frames_processed"] == 8
        assert m["dispatches"] == 2            # two chunks of 4
        chunked = aur.pull(8 * 2048)
        aur.stop()
        # One record per DISPATCH (two chunks of 4), each counting its
        # real frames.
        records = [json.loads(l) for l in open(log)]
        assert len(records) == 2
        assert sum(r["frames"] for r in records) == 8
        assert all("latency_ms" in r for r in records)
        ref = Auralizer(source=frames, debug=False)
        ref.run_until_exhausted()
        np.testing.assert_allclose(chunked, ref.pull(8 * 2048), atol=2e-4)
        ref.stop()

    def test_toggle(self):
        frames = solid_color_frames([1, 0.1, 0.1], 64, 64, 3)
        aur = Auralizer(source=frames)
        aur.toggle()          # start
        aur.toggle()          # stop
        assert not aur.is_running

    def test_custom_config_sample_rate(self):
        cfg = AuralizerConfig(sample_rate=48000.0)
        aur = Auralizer(config=cfg)
        frames = solid_color_frames([1, 0.1, 0.1], 64, 64, 2)
        audio = aur.sonify(frames)
        assert audio.shape == (2 * 2048,)


class TestDisplayUtils:
    def test_spectrum_display(self, rng):
        cfg = AuralizerConfig()
        spec = rng.normal(0, 0.1, (cfg.num_bins, 2)).astype(np.float32)
        d = spectrum_display(spec, cfg)
        assert np.all((d["log_x"] >= 0) & (d["log_x"] <= 1))
        assert np.all((d["norm_y"] >= 0) & (d["norm_y"] <= 1))
        assert d["db"].max() <= 5.0 + 1e-6

    def test_peak_shape_curve(self):
        d, w = peak_shape_curve(bandwidth=1.0)
        assert np.isclose(w[len(w) // 2], 0.5, atol=1e-6)  # W(0) = 0.5
        d2, w2 = peak_shape_curve(bandwidth=1.0, q=2.0)
        assert np.all(np.abs(w2) <= np.abs(w) + 1e-7)

    def test_frame_timer(self):
        t = FrameTimer()
        for _ in range(3):
            with t.frame():
                pass
        s = t.summary()
        assert s["count"] == 3 and s["p50_ms"] >= 0


class TestCLI:
    def _run(self, *args):
        env = dict(os.environ, VAUDIO_PLATFORM="cpu", JAX_PLATFORMS="cpu",
                   JAX_COMPILATION_CACHE_DIR="/tmp/vaudio_test_jax_cache",
                   PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH", ""))
        # Generous timeout: the subprocess compiles its own jit while the
        # surrounding suite may be saturating this host's single core.
        return subprocess.run(
            [sys.executable, "-m", "vaudio", *args],
            capture_output=True, text=True, env=env, cwd="/root/repo",
            timeout=900)

    def test_info(self):
        r = self._run("info")
        assert r.returncode == 0
        info = json.loads(r.stdout)
        assert info["derived"]["num_bins"] == 2047

    def test_synthetic(self, tmp_path):
        out = str(tmp_path / "c.wav")
        r = self._run("synthetic", "--hue", "0.33", "--frames", "4",
                      "--width", "128", "--height", "128", "-o", out)
        assert r.returncode == 0, r.stderr
        audio, sr = read_wav(out)
        assert len(audio) == 4 * 2048

    def test_sonify_npy(self, tmp_path):
        frames = solid_color_frames([1, 0.1, 0.1], 64, 64, 3)
        inp = str(tmp_path / "frames.npy")
        np.save(inp, frames)
        out = str(tmp_path / "o.wav")
        r = self._run("sonify", inp, "-o", out)
        assert r.returncode == 0, r.stderr
        audio, _ = read_wav(out)
        assert len(audio) == 3 * 2048

    def test_sonify_orthomodes_model(self, tmp_path):
        """`vaudio sonify --model orthomodes` routes file input through
        the second model family (per-pixel A/Q/f0 synthesis)."""
        frames = solid_color_frames([0.1, 1, 0.1], 32, 32, 3)
        inp = str(tmp_path / "frames.npy")
        np.save(inp, frames)
        out = str(tmp_path / "om.wav")
        r = self._run("sonify", inp, "-o", out, "--model", "orthomodes")
        assert r.returncode == 0, r.stderr
        audio, _ = read_wav(out)
        assert len(audio) == 3 * 2048


class TestApiCheckpoint:
    def test_stream_state_roundtrip(self, tmp_path):
        frames = solid_color_frames([1, 0.2, 0.1], 64, 64, 4)
        aur = Auralizer(source=frames)
        aur.run_until_exhausted()
        p = str(tmp_path / "st.npz")
        aur.save_state(p)
        aur2 = Auralizer()
        aur2.load_state(p)
        np.testing.assert_array_equal(
            np.asarray(aur._stream._carry.phases),
            np.asarray(aur2._stream._carry.phases))


class TestInspectFrame:
    def test_full_debug_surface(self, rng):
        aur = Auralizer()
        frame = rng.uniform(0, 1, (128, 128, 3)).astype(np.float32)
        d = aur.inspect_frame(frame)
        # mip dims 16x16, rotated maps (W,H,4)
        assert d["hue_map"].shape == (16, 16, 4)
        assert d["saturation_map"].shape == (16, 16, 4)
        assert d["intensity_map"].shape == (16, 16, 4)
        assert d["histogram"].shape == (16, 360)
        assert d["hues"].shape == (16,)
        assert d["mip_hsi"].shape == (16, 16, 3)

    def test_uint8_input(self, rng):
        aur = Auralizer()
        frame = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
        d = aur.inspect_frame(frame)
        assert np.all(np.isfinite(d["grads"]))


class TestYuv:
    def test_yuv420_grey_roundtrip(self):
        from vaudio.io import yuv420_to_rgb
        # Y=128 (mid grey), U=V=128 (no chroma) -> equal RGB channels.
        y = np.full((8, 8), 128, np.uint8)
        u = np.full((4, 4), 128, np.uint8)
        v = np.full((4, 4), 128, np.uint8)
        rgb = yuv420_to_rgb(y, u, v)
        assert rgb.shape == (8, 8, 3)
        assert np.all(rgb[..., 0] == rgb[..., 1])
        assert np.all(rgb[..., 1] == rgb[..., 2])

    def test_red_has_high_v(self):
        from vaudio.io import yuv420_to_rgb
        y = np.full((4, 4), 81, np.uint8)    # BT.601 Y of pure red
        u = np.full((2, 2), 90, np.uint8)
        v = np.full((2, 2), 240, np.uint8)
        rgb = yuv420_to_rgb(y, u, v)
        assert rgb[..., 0].mean() > 200      # red dominant
        assert rgb[..., 1].mean() < 90

    def test_yuv_file_source(self, tmp_path):
        from vaudio.io import Yuv420FileSource
        h, w = 16, 16
        n = 3
        data = np.random.default_rng(0).integers(
            0, 256, n * (h * w + 2 * (h // 2) * (w // 2))).astype(np.uint8)
        p = str(tmp_path / "clip.yuv")
        data.tofile(p)
        src = Yuv420FileSource(p, width=w, height=h)
        frames = list(src.frames())
        assert len(frames) == n
        assert frames[0].shape == (h, w, 3) and frames[0].dtype == np.uint8


class TestStreamCLI:
    def test_stdin_stdout_pipe(self, tmp_path):
        import subprocess
        frames = (solid_color_frames([1, 0.2, 0.1], 64, 64, 4)
                  * 255).astype(np.uint8)
        # VAUDIO_PLATFORM: the CLI applies the override via
        # jax.config.update before any backend touch (cli.py), which
        # holds even when jax was imported before the environment was
        # read.
        env = dict(os.environ, VAUDIO_PLATFORM="cpu", JAX_PLATFORMS="cpu",
                   JAX_COMPILATION_CACHE_DIR="/tmp/vaudio_test_jax_cache",
                   PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH",
                                                             ""))
        r = subprocess.run(
            [sys.executable, "-m", "vaudio", "stream", "--size", "64x64"],
            input=frames.tobytes(), capture_output=True, env=env,
            cwd="/root/repo", timeout=300)
        assert r.returncode == 0, r.stderr.decode()[-500:]
        pcm = np.frombuffer(r.stdout, "<f4")
        assert len(pcm) >= 4 * 2048
        assert np.all(np.isfinite(pcm))

    def test_chunk_frames_and_metrics_log_flags(self, tmp_path):
        """`vaudio stream --chunk-frames 4 --metrics-log x.jsonl`: the
        throughput pipeline + per-frame JSONL at the CLI front door."""
        frames = (solid_color_frames([0.2, 0.9, 0.2], 64, 64, 8)
                  * 255).astype(np.uint8)
        log = str(tmp_path / "m.jsonl")
        env = dict(os.environ, VAUDIO_PLATFORM="cpu", JAX_PLATFORMS="cpu",
                   JAX_COMPILATION_CACHE_DIR="/tmp/vaudio_test_jax_cache",
                   PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH",
                                                             ""))
        r = subprocess.run(
            [sys.executable, "-m", "vaudio", "stream", "--size", "64x64",
             "--chunk-frames", "4", "--metrics-log", log],
            input=frames.tobytes(), capture_output=True, env=env,
            cwd="/root/repo", timeout=300)
        assert r.returncode == 0, r.stderr.decode()[-500:]
        pcm = np.frombuffer(r.stdout, "<f4")
        assert len(pcm) >= 8 * 2048 and np.all(np.isfinite(pcm))
        records = [json.loads(l) for l in open(log)]
        assert sum(r["frames"] for r in records) == 8

    def test_sigterm_graceful_shutdown_saves_state(self, tmp_path):
        """SIGTERM mid-stream exits cleanly (rc 143): PCM flushed,
        --save-state honored, 'interrupted' reported — the deliberate
        stop path (SoundEngine.swift:459-474), not a mid-write death."""
        import signal
        import subprocess
        frames = (solid_color_frames([1, 0.2, 0.1], 64, 64, 6)
                  * 255).astype(np.uint8)
        env = dict(os.environ, VAUDIO_PLATFORM="cpu", JAX_PLATFORMS="cpu",
                   JAX_COMPILATION_CACHE_DIR="/tmp/vaudio_test_jax_cache",
                   PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH",
                                                             ""))
        ckpt = str(tmp_path / "sig_carry.npz")
        p = subprocess.Popen(
            [sys.executable, "-m", "vaudio", "stream", "--size", "64x64",
             "--save-state", ckpt],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env=env, cwd="/root/repo")
        try:
            # Feed frames but keep stdin open: the stream stays live
            # until the signal arrives.
            p.stdin.write(frames.tobytes())
            p.stdin.flush()
            pcm0 = p.stdout.read(2048 * 4)     # one hop of f32 PCM
            assert len(pcm0) == 2048 * 4       # drain loop is running
            p.send_signal(signal.SIGTERM)
            out, err = p.communicate(timeout=120)
        except Exception:
            p.kill()
            raise
        assert p.returncode == 143, err.decode()[-500:]
        assert b"interrupted; shutting down cleanly" in err
        assert b"DSP state saved" in err
        data = np.load(ckpt)
        assert "phases" in data.files          # a real carry snapshot
        pcm = np.frombuffer(pcm0 + out, "<f4")
        assert np.all(np.isfinite(pcm))

    def test_checkpoint_resume_across_runs(self, tmp_path):
        """--save-state / --load-state: a stream split across two CLI
        processes produces the same PCM as one continuous run (the DSP
        carry — phases, spectrum EMA, OLA tail, AGC — resumes
        seamlessly; runtime/checkpoint.py)."""
        import subprocess
        rng = np.random.default_rng(7)
        frames = rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
        env = dict(os.environ, VAUDIO_PLATFORM="cpu", JAX_PLATFORMS="cpu",
                   JAX_COMPILATION_CACHE_DIR="/tmp/vaudio_test_jax_cache",
                   PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH",
                                                             ""))
        ckpt = str(tmp_path / "carry.npz")

        def run(tensor, extra):
            r = subprocess.run(
                [sys.executable, "-m", "vaudio", "stream", "--size",
                 "64x64"] + extra,
                input=tensor.tobytes(), capture_output=True, env=env,
                cwd="/root/repo", timeout=300)
            assert r.returncode == 0, r.stderr.decode()[-500:]
            return np.frombuffer(r.stdout, "<f4")

        whole = run(frames, [])
        first = run(frames[:4], ["--save-state", ckpt])
        second = run(frames[4:], ["--load-state", ckpt])
        assert os.path.exists(ckpt)
        split = np.concatenate([first, second])
        assert split.shape == whole.shape
        np.testing.assert_allclose(split, whole, atol=1e-5)


class TestNv12:
    def test_nv12_equals_i420(self, tmp_path, rng):
        from vaudio.io import Yuv420FileSource
        h, w = 16, 16
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
        v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
        i420 = np.concatenate([y.ravel(), u.ravel(), v.ravel()])
        uv = np.empty((h // 2, w), np.uint8)
        uv[:, 0::2], uv[:, 1::2] = u, v
        nv12 = np.concatenate([y.ravel(), uv.ravel()])
        p1, p2 = str(tmp_path / "a.yuv"), str(tmp_path / "b.yuv")
        i420.tofile(p1)
        nv12.tofile(p2)
        f1 = next(Yuv420FileSource(p1, w, h, raw=True).frames())
        f2 = next(Yuv420FileSource(p2, w, h, raw=True, fmt="nv12").frames())
        for k in ("y", "u", "v"):
            np.testing.assert_array_equal(f1[k], f2[k])

    def test_bad_format_rejected(self):
        from vaudio.io import Yuv420FileSource
        with pytest.raises(ValueError):
            Yuv420FileSource("x.yuv", 8, 8, fmt="yuyv")
