"""`vaudio doctor` — active environment health checks
(vaudio/utils/doctor.py).

The reference degrades with guard-let + print (SURVEY.md §5); the
doctor turns those failure modes into pre-serving verdicts.  The key
property under test: every backend-touching probe is WATCHDOGGED — a
hung backend initialization yields a fail verdict, never a hang."""

import json
import os
import stat
import subprocess
import sys

from vaudio.utils.doctor import (check_backend, check_compile_cache,
                                 check_decode, check_native,
                                 check_player, check_smoke,
                                 format_report, run_doctor)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestChecks:
    def test_backend_cpu_ok(self):
        c = check_backend(platform="cpu", timeout=120)
        assert c["status"] == "ok", c
        assert "cpu" in c["detail"]

    def test_backend_watchdog_kills_hung_probe(self, monkeypatch):
        """A hung backend init must yield a fail verdict within the
        watchdog budget, not hang the doctor (the hung-runtime mode)."""
        import vaudio.utils.doctor as doc
        real_run = subprocess.run

        def hang(cmd, **kw):
            # Substitute a probe that sleeps forever; keep the caller's
            # timeout so the watchdog path is exercised for real.
            return real_run([sys.executable, "-c",
                             "import time; time.sleep(3600)"], **kw)
        monkeypatch.setattr(doc.subprocess, "run", hang)
        c = doc.check_backend(platform="cpu", timeout=1.5)
        assert c["status"] == "fail"
        assert "accelerator runtime not answering" in c["detail"]

    def test_compile_cache_respects_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / "cache"))
        c = check_compile_cache()
        assert c["status"] == "ok"
        assert str(tmp_path / "cache") in c["detail"]
        assert (tmp_path / "cache").is_dir()

    def test_compile_cache_precedence_matches_runtime(self, tmp_path,
                                                      monkeypatch):
        """The doctor validates the directory the runtime actually
        uses: JAX_COMPILATION_CACHE_DIR when set, else the checkout's
        .jax_cache (vaudio.utils.compile_cache)."""
        from vaudio.utils import compile_cache
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / "jax_dir"))
        c = check_compile_cache()
        assert str(tmp_path / "jax_dir") in c["detail"]
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        monkeypatch.setattr(compile_cache, "DEFAULT_DIR",
                            str(tmp_path / "checkout_cache"))
        c = check_compile_cache()
        assert str(tmp_path / "checkout_cache") in c["detail"]

    def test_compile_cache_unwritable_fails(self, tmp_path, monkeypatch):
        ro = tmp_path / "ro"
        ro.mkdir()
        os.chmod(ro, stat.S_IRUSR | stat.S_IXUSR)
        if os.access(ro / "x", os.W_OK) or os.geteuid() == 0:
            # root ignores mode bits; point at an impossible path instead
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               "/proc/definitely/not/writable")
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(ro / "sub"))
        c = check_compile_cache()
        assert c["status"] == "fail"
        assert "not writable" in c["detail"]

    def test_native_loads_in_this_image(self):
        c = check_native()
        assert c["status"] == "ok", c

    def test_player_found_via_override(self, tmp_path, monkeypatch):
        fake = tmp_path / "fakeplay"
        fake.write_text("#!/bin/sh\ncat > /dev/null\n")
        fake.chmod(0o755)
        monkeypatch.setenv("VAUDIO_PLAYER", str(fake))
        monkeypatch.setenv("PATH",
                           f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
        c = check_player()
        assert c["status"] == "ok" and "fakeplay" in c["detail"]

    def test_player_missing_is_warn_not_fail(self, monkeypatch):
        monkeypatch.delenv("VAUDIO_PLAYER", raising=False)
        monkeypatch.setenv("PATH", "/nonexistent")
        c = check_player()
        assert c["status"] == "warn"

    def test_decode_reports_a_backend(self):
        # This image ships cv2; at minimum the check must not fail.
        c = check_decode()
        assert c["status"] in ("ok", "warn")

    def test_smoke_cpu(self):
        c = check_smoke(platform="cpu", timeout=300)
        assert c["status"] == "ok", c
        assert "PCM" in c["detail"]

    def test_smoke_default_backend_reports_device(self):
        """With no platform the smoke runs on the default backend (the
        one a deployment uses — here the harness's CPU) and names it."""
        c = check_smoke(timeout=300)
        assert c["status"] == "ok", c
        assert c["detail"].endswith("on cpu cpu")

    def test_run_doctor_smokes_the_requested_backend(self, monkeypatch):
        import vaudio.utils.doctor as doc
        seen = []
        monkeypatch.setattr(doc, "check_smoke",
                            lambda platform, timeout: seen.append(platform)
                            or {"name": "smoke", "status": "ok",
                                "detail": "stub"})
        run_doctor(skip_backend=True)
        run_doctor(platform="cpu", skip_backend=True)
        assert seen == [None, "cpu"]

    def test_format_report_counts(self):
        checks = [{"name": "a", "status": "ok", "detail": "x"},
                  {"name": "bb", "status": "warn", "detail": "y"},
                  {"name": "c", "status": "fail", "detail": "z"}]
        text = format_report(checks)
        assert "1 failed" in text and "1 warning" in text
        assert "[FAIL] c" in text


class TestPanelCheck:
    def test_pod_panel_ok_warn_fail(self):
        """check_panel against a real pod panel: ok while serving,
        warn with a failed slot, fail once stopped."""
        import numpy as np

        from vaudio.config import AuralizerConfig
        from vaudio.runtime import MultiStreamAuralizer
        from vaudio.utils.doctor import check_panel

        cfg = AuralizerConfig()
        pod = MultiStreamAuralizer(cfg, n_streams=2,
                                   exit_when_exhausted=False)
        server = pod.serve(port=0)
        try:
            frame = np.zeros((64, 64, 3), np.uint8)

            def bad():
                yield frame
                raise OSError("camera unplugged")
            pod.start([iter([frame.copy()] * 2), bad()])
            import time as _t
            t0 = _t.monotonic()
            while pod.slot_errors[1] is None:
                pod.raise_if_failed()
                assert _t.monotonic() - t0 < 120
                _t.sleep(0.01)
            c = check_panel(server.url)
            assert c["status"] == "warn", c       # slot 1 failed
            assert "1 failed [1]" in c["detail"]
            pod.slot_errors[1] = None             # pretend healthy
            c = check_panel(server.url)
            assert c["status"] == "ok", c
            pod.stop()
            c = check_panel(server.url)
            assert c["status"] == "fail" and "STOPPED" in c["detail"]
        finally:
            server.stop()
            pod.stop()

    def test_unreachable_panel_fails(self):
        from vaudio.utils.doctor import check_panel
        c = check_panel("http://127.0.0.1:1", timeout=3)
        assert c["status"] == "fail"
        assert "unreachable" in c["detail"]

    def test_fleet_urls_one_row_per_pod(self):
        """run_doctor(url=[...]) probes every pod: one labeled panel
        row each, dead pods failing without hiding the live ones."""
        from vaudio.config import AuralizerConfig
        from vaudio.runtime import MultiStreamAuralizer
        from vaudio.utils.doctor import run_doctor
        pod = MultiStreamAuralizer(AuralizerConfig(), n_streams=1,
                                   exit_when_exhausted=False)
        server = pod.serve(port=0)
        try:
            pod.start([iter(())])
            checks = run_doctor(skip_backend=True, skip_smoke=True,
                                url=[server.url, "http://127.0.0.1:1"])
            rows = {c["name"]: c for c in checks
                    if c["name"].startswith("panel")}
            assert set(rows) == {"panel[0]", "panel[1]"}
            assert rows["panel[0]"]["status"] == "ok"
            assert rows["panel[1]"]["status"] == "fail"
            assert server.url.rstrip("/") in rows["panel[0]"]["detail"]
        finally:
            server.stop()
            pod.stop()

    def test_stream_panel_shape(self):
        """check_panel recognizes the single-stream panel's metrics
        shape (no 'slots' key)."""
        import numpy as np

        from vaudio.api import Auralizer
        from vaudio.io import ArraySource
        from vaudio.utils.doctor import check_panel

        clip = np.zeros((3, 64, 64, 3), np.float32)
        aur = Auralizer(source=ArraySource(clip))
        aur.start()
        server = aur.serve(port=0)
        try:
            c = check_panel(server.url)
            assert c["status"] == "ok"
            assert "stream:" in c["detail"]
        finally:
            server.stop()
            aur.stop()


class TestDoctorCLI:
    def test_cli_json_and_exit_code(self):
        env = dict(os.environ)
        env["VAUDIO_PLATFORM"] = "cpu"
        env.setdefault("PYTHONPATH", "")
        env["PYTHONPATH"] = (f"{REPO}{os.pathsep}{env['PYTHONPATH']}"
                             if env["PYTHONPATH"] else REPO)
        proc = subprocess.run(
            [sys.executable, "-m", "vaudio", "doctor", "--platform",
             "cpu", "--skip-smoke", "--json"],
            capture_output=True, text=True, timeout=240, env=env,
            cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-2000:]
        checks = json.loads(proc.stdout)
        names = {c["name"] for c in checks}
        assert {"versions", "backend", "compile_cache", "native",
                "decode", "player"} <= names
        assert all(c["status"] != "fail" for c in checks)

    def test_doctor_never_holds_a_backend(self):
        """The doctor's own process never initializes a JAX backend: its
        probes are children, and a parent holding the card would starve
        them (one JAX process per card)."""
        env = dict(os.environ, PYTHONPATH=REPO)
        code = ("from vaudio.utils.doctor import run_doctor\n"
                "run_doctor(skip_backend=True, skip_smoke=True)\n"
                "from jax._src import xla_bridge\n"
                "print('BACKENDS', sorted(xla_bridge._backends))\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "BACKENDS []" in proc.stdout

    def test_run_doctor_skips(self):
        checks = run_doctor(skip_backend=True, skip_smoke=True)
        names = [c["name"] for c in checks]
        assert "backend" not in names and "smoke" not in names
