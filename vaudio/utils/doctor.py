"""Environment health checks — the `vaudio doctor` CLI.

The reference app's failure handling is guard-let + print degradation
(SURVEY.md §5: camera missing -> print, audio engine failure -> print;
VideoToAudio.swift:73-77, SoundEngine.swift:159-163).  A production
deployment needs those failure modes CHECKED before serving, not
discovered mid-stream: does the accelerator backend initialize (a wedged
device runtime can make a bare ``jax.devices()`` hang), is the persistent
compile cache writable, does the native runtime library build/load,
which decode backends and audio sinks exist, and does a frame actually
sonify end-to-end on the default backend.

Design rules:

* **Every probe is time-bounded.**  Anything that can touch the
  accelerator backend runs in a watchdogged SUBPROCESS, one after the
  other: the doctor itself never initializes a backend (so it never
  holds a card its probes need) and never hangs.
* **Three verdicts**: ``ok`` (healthy), ``warn`` (an optional
  capability is missing — raw serving still works), ``fail`` (a
  required capability is broken).  The CLI exits 1 only on ``fail``.

Each check returns ``{"name", "status", "detail"}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional

Check = Dict[str, str]


def _result(name: str, status: str, detail: str) -> Check:
    return {"name": name, "status": status, "detail": detail}


def check_versions() -> Check:
    """Interpreter / library versions (never fails — context for the
    rest of the report)."""
    import jax
    import numpy as np

    import vaudio
    detail = (f"python {sys.version.split()[0]}, "
              f"vaudio {vaudio.__version__}, jax {jax.__version__}, "
              f"numpy {np.__version__}")
    return _result("versions", "ok", detail)


def _subprocess_env() -> dict:
    """Child env for probes: inherit everything (platform selection and
    XLA flags must match the deployment being probed) and make the repo
    importable."""
    env = dict(os.environ)
    here = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if here not in parts:
        env["PYTHONPATH"] = os.pathsep.join([here] + parts)
    return env


def check_backend(platform: Optional[str] = None,
                  timeout: float = 90.0) -> Check:
    """Probe accelerator-backend initialization in a watchdogged
    subprocess.  A healthy backend answers in seconds; a hung device runtime
    hangs its child, which the watchdog kills — the doctor
    reports ``fail`` instead of hanging."""
    code = (
        "import json, sys\n"
        "import jax\n"
        + (f"jax.config.update('jax_platforms', {platform!r})\n"
           if platform else "")
        + "ds = jax.devices()\n"
        "print(json.dumps({'platform': jax.default_backend(),"
        " 'n': len(ds), 'kind': ds[0].device_kind}))\n")
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=timeout, env=_subprocess_env())
    except subprocess.TimeoutExpired:
        return _result(
            "backend", "fail",
            f"backend init exceeded {timeout:.0f}s — accelerator runtime "
            "not answering (check the rest with --platform cpu)")
    if proc.returncode != 0:
        tail = " ".join((proc.stderr or "").strip().splitlines()[-1:])
        return _result("backend", "fail",
                       f"backend init failed: {tail or 'no stderr'}")
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    return _result(
        "backend", "ok",
        f"{info['platform']} ({info['n']} device(s), {info['kind']})")


def check_compile_cache() -> Check:
    """The persistent compile cache directory must be writable: a cold
    1080p compile takes far longer than a warm cache hit
    (docs/SERVING.md operational rules).  Validates the directory every
    entry point uses (vaudio.utils.compile_cache)."""
    from vaudio.utils.compile_cache import compile_cache_dir
    path = compile_cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
        probe = os.path.join(path, ".doctor_probe")
        with open(probe, "w") as fh:
            fh.write("ok")
        os.remove(probe)
    except OSError as e:
        return _result("compile_cache", "fail",
                       f"{path} not writable: {e}")
    n = sum(1 for f in os.listdir(path) if not f.startswith("."))
    return _result("compile_cache", "ok",
                   f"{path} writable ({n} cached program(s))")


def check_native() -> Check:
    """Build (if needed) and load the native runtime library
    (native/ringbuffer.cpp + framereader.cpp).  Optional: the Python
    ring-buffer twin is functionally identical, so a missing toolchain
    is a warn, not a fail."""
    from vaudio.runtime.ringbuffer import _LIB_PATH, _load_native
    lib = _load_native()
    if lib is None:
        return _result(
            "native", "warn",
            f"{_LIB_PATH} failed to build/load (g++/make missing?) — "
            "Python ring-buffer fallback in use (functional, slower "
            "ingest overlap)")
    return _result("native", "ok", f"{_LIB_PATH} loaded")


def check_decode() -> Check:
    """Encoded-video decode backends (io.VideoFileSource): cv2 and/or
    an ffmpeg binary.  Raw rgb24/i420/nv12 ingest needs neither."""
    found = []
    try:
        import cv2
        found.append(f"cv2 {cv2.__version__}")
    except Exception:
        pass
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg:
        found.append(ffmpeg)
    if not found:
        return _result(
            "decode", "warn",
            "no encoded-video backend (cv2 import failed, no ffmpeg on "
            "PATH): mp4/avi/mkv inputs unavailable; raw rgb24/i420/"
            "nv12 and .npy ingest unaffected")
    return _result("decode", "ok", ", ".join(found))


def check_player() -> Check:
    """Audio playback sink for ``stream --play``
    (io.SubprocessPlayer: $VAUDIO_PLAYER or aplay/pw-play/paplay/
    ffplay)."""
    override = os.environ.get("VAUDIO_PLAYER")
    if override:
        exe = shutil.which(override.split()[0])
        if exe:
            return _result("player", "ok", f"$VAUDIO_PLAYER -> {exe}")
        return _result("player", "warn",
                       f"$VAUDIO_PLAYER={override!r} not on PATH")
    for cand in ("aplay", "pw-play", "paplay", "ffplay"):
        exe = shutil.which(cand)
        if exe:
            return _result("player", "ok", exe)
    return _result(
        "player", "warn",
        "no audio player on PATH (aplay/pw-play/paplay/ffplay): "
        "stream --play unavailable; WAV/stdout sinks unaffected")


def check_smoke(platform: Optional[str] = None,
                timeout: float = 300.0) -> Check:
    """End-to-end smoke in a watchdogged subprocess: two solid-color
    frames through the full pipeline (Auralizer.sonify), asserting
    finite, non-trivial PCM.  Runs on the default backend (the one a
    deployment would use) unless ``platform`` names another, and
    reports the platform and device kind it ran on."""
    code = (
        "import numpy as np\n"
        "import jax\n"
        + (f"jax.config.update('jax_platforms', {platform!r})\n"
           if platform else "")
        + "from vaudio.api import Auralizer\n"
        "frames = np.tile(np.array([220, 40, 30], np.uint8),"
        " (2, 64, 64, 1))\n"
        "pcm = np.asarray(Auralizer().sonify(frames))\n"
        "assert pcm.size and np.isfinite(pcm).all(), pcm.shape\n"
        "dev = jax.devices()[0]\n"
        "print('PCM', pcm.shape, float(np.abs(pcm).max()), 'on',"
        " dev.platform, dev.device_kind)\n")
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=timeout, env=_subprocess_env())
    except subprocess.TimeoutExpired:
        return _result("smoke", "fail",
                       f"end-to-end sonify exceeded {timeout:.0f}s")
    if proc.returncode != 0:
        tail = " ".join((proc.stderr or "").strip().splitlines()[-1:])
        return _result("smoke", "fail",
                       f"sonify failed: {tail or 'no stderr'}")
    return _result("smoke", "ok", proc.stdout.strip().splitlines()[-1])


def check_panel(url: str, timeout: float = 10.0,
                token: Optional[str] = None) -> Check:
    """Health of a RUNNING deployment over its HTTP panel (stream
    panel, `vaudio stream --serve`, or pod panel, `vaudio pod
    --serve`): GET /metrics and judge the serving state.  A pod with
    failed slots is a ``warn`` (failures are slot-isolated; re-arm
    them); an unreachable panel or a stopped pod is a ``fail``."""
    import urllib.request
    base = url if "://" in url else f"http://{url}"
    base = base.rstrip("/")
    req = urllib.request.Request(
        base + "/metrics",
        headers=({"Authorization": f"Bearer {token}"} if token else {}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            m = json.loads(r.read())
    except (OSError, ValueError) as e:
        return _result("panel", "fail",
                       f"{base}/metrics unreachable or invalid: {e}")
    if "slots" in m:                               # pod panel
        slots = m.get("slots", [])
        failed = [i for i, s in enumerate(slots) if s.get("failed")]
        active = sum(1 for s in slots if s.get("active"))
        p50 = m.get("dispatch_latency_p50_ms")
        detail = (f"pod {'running' if m.get('running') else 'STOPPED'}"
                  f": {m.get('n_streams')} slot(s), {active} active, "
                  f"{len(failed)} failed"
                  + (f" {failed}" if failed else "")
                  + f", {m.get('frames_processed', 0)} frames"
                  + (f", p50 dispatch {p50:.1f} ms"
                     if isinstance(p50, (int, float)) else ""))
        if not m.get("running"):
            return _result("panel", "fail", detail)
        return _result("panel", "warn" if failed else "ok", detail)
    p50 = m.get("total_latency_p50_ms")
    detail = (f"stream: {m.get('frames_processed', 0)} frames, "
              f"buffer fill {m.get('buffer_fill')}, "
              f"{m.get('dropped_frames', 0)} dropped"
              + (f", p50 total latency {p50:.1f} ms"
                 if isinstance(p50, (int, float)) else ""))
    return _result("panel", "ok", detail)


def run_doctor(platform: Optional[str] = None, timeout: float = 90.0,
               skip_backend: bool = False, skip_smoke: bool = False,
               smoke_timeout: float = 300.0,
               url=None,
               token: Optional[str] = None) -> List[Check]:
    """Run every check; see the module docstring for the verdict
    model.  With ``url`` (one base URL or a list — a fleet), also probe
    each RUNNING deployment's HTTP panel (:func:`check_panel`)."""
    checks = [check_versions()]
    if not skip_backend:
        checks.append(check_backend(platform, timeout))
    checks.extend([check_compile_cache(), check_native(),
                   check_decode(), check_player()])
    if not skip_smoke:
        checks.append(check_smoke(platform, smoke_timeout))
    if url:
        urls = [url] if isinstance(url, str) else list(url)
        for i, u in enumerate(urls):
            c = check_panel(u, token=token)
            if len(urls) > 1:      # fleet probe: name each pod's row
                c["name"] = f"panel[{i}]"
                if u.rstrip("/") not in c["detail"]:
                    # failure details already name the URL
                    c["detail"] = f"{u}: {c['detail']}"
            checks.append(c)
    return checks


def format_report(checks: List[Check]) -> str:
    mark = {"ok": " ok ", "warn": "warn", "fail": "FAIL"}
    width = max(len(c["name"]) for c in checks)
    lines = [f"[{mark[c['status']]}] {c['name']:<{width}}  {c['detail']}"
             for c in checks]
    bad = sum(c["status"] == "fail" for c in checks)
    warn = sum(c["status"] == "warn" for c in checks)
    lines.append(f"doctor: {len(checks)} checks, {bad} failed, "
                 f"{warn} warning(s)")
    return "\n".join(lines)
