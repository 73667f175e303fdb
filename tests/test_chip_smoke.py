"""chip_smoke.py and the GPU bring-up surface, on the CPU harness.

The phase functions run at 64x64 (mip level 1, so every 4x4 cell keeps
enough pixels to pass the histogram count gate); the script itself must
refuse to report a result without a GPU.  The full-width run is
``python chip_smoke.py`` on the card (and ``test_main_on_card`` under
``-m gpu``)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from vaudio.config import AuralizerConfig, LiveParams  # noqa: E402
from vaudio.utils.device import parse_name_power, require_gpu  # noqa: E402

SMALL = dataclasses.replace(cs.FULL_CONFIG, mip_level=1, video_fps=240.0)


def small_frames(n, n_banded):
    return cs.structured_frames(n, 64, 64, n_banded=n_banded)


class TestPhases:
    def test_offline(self):
        out = cs.phase_offline(SMALL, small_frames(16, 4))
        assert out["chunked_vs_scan_pcm"] <= cs.CHUNKED_VS_SCAN_ATOL
        assert abs(out["green_f0_hz"] - 440.0) < 0.03 * 440.0

    def test_parity(self):
        out = cs.phase_parity(64, 64)
        assert out["hue_histogram_tiled"] == 0.0
        assert set(out) >= {"mip_u8_int8_path", "spectrum_contraction",
                            "phase_cumsum_vs_serial"}

    def test_stream(self):
        out = cs.phase_stream(SMALL, small_frames(12, 4), card="cpu")
        assert out["frames"] == 12

    def test_pod(self):
        clips = [np.stack([cs.hue_bands_u8((s / 4 + np.arange(4) / 4.0) % 1,
                                           64, 64)] * 3) for s in range(4)]
        out = cs.phase_pod(SMALL, clips)
        assert out["pod_4_slots_vs_single"] <= cs.POD_VS_SINGLE_ATOL

    def test_multi_device_on_8_virtual_devices(self):
        devs = jax.devices()
        assert len(devs) == 8
        out = cs.phase_four(devs, 64, 64)
        assert "dp4xtp2 scan step" in out
        assert out["mesh_pod_8_slots_vs_single"] <= cs.POD_VS_SINGLE_ATOL

    def test_check_raises_past_tolerance(self):
        out = {}
        cs.check("x", 1e-4, 1e-3, out)
        assert out == {"x": 1e-4}
        with pytest.raises(AssertionError):
            cs.check("y", 2e-3, 1e-3, out)
        with pytest.raises(AssertionError):
            cs.check("z", float("nan"), 1e-3, out)


class TestResultLine:
    def test_last_line_has_only_the_device_keys(self):
        line = cs.last_line({"platform": "gpu", "kind": "NVIDIA H100",
                             "count": 4, "extra": 1})
        assert json.loads(line) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100", "count": 4}}
        assert "\n" not in line

    @pytest.mark.parametrize("text,want", [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n",
         [("NVIDIA H100 80GB HBM3", "700.00 W")]),
        ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W",
         [("NVIDIA H100 80GB HBM3", "500.00 W"),
          ("NVIDIA H100 80GB HBM3", "700.00 W")]),
        ("Card, with comma, [N/A]", [("Card, with comma", "[N/A]")]),
    ])
    def test_nvidia_smi_parser(self, text, want):
        assert parse_name_power(text) == want

    def test_nvidia_smi_parser_rejects_garbage(self):
        with pytest.raises(ValueError):
            parse_name_power("no separator here")

    def test_require_gpu_refuses_the_cpu(self):
        with pytest.raises(RuntimeError, match="no GPU"):
            require_gpu()

    def test_main_without_gpu_fails_with_no_result(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
        assert "no GPU" in proc.stderr


@pytest.mark.gpu
def test_main_on_card(gpu_device):
    """The whole smoke at full width on the card (run with
    ``VAUDIO_TEST_PLATFORM=cuda,cpu python -m pytest -m gpu tests/``)."""
    assert cs.main([]) == 0


# ---------------------------------------------------------------------------
# Compile-cache placement: every entry point caches in
# JAX_COMPILATION_CACHE_DIR when it is set, else <checkout>/.jax_cache.
# ---------------------------------------------------------------------------

ENTRY_CODE = {
    "cli": "from vaudio.cli import main; main(['info'])",
    "bench": "import bench; assert bench.main() != 0",
    "chip_smoke": "import chip_smoke; assert chip_smoke.main([]) != 0",
    "doctor": ("from vaudio.utils.doctor import check_compile_cache; "
               "print(check_compile_cache()['detail'])"),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_CODE))
@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(entry, env_set, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", VAUDIO_PLATFORM="cpu",
               PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if env_set:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = (ENTRY_CODE[entry] + "\nimport jax\n"
            "print('CACHE=' + str(jax.config.jax_compilation_cache_dir))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    if entry == "doctor":               # validates, never configures jax
        assert proc.stdout.startswith(f"{want} writable")
    else:
        assert f"CACHE={want}" in proc.stdout.splitlines()


# ---------------------------------------------------------------------------
# No hand-written kernel is left on any path.
# ---------------------------------------------------------------------------

def _jaxpr_frame_step():
    from vaudio.runtime import init_carry, make_step
    from vaudio.runtime.step import default_params
    cfg = AuralizerConfig()
    return jax.make_jaxpr(make_step(cfg, jit=False))(
        init_carry(cfg), jnp.zeros((64, 64, 3), jnp.uint8),
        default_params(cfg))


def _jaxpr_chunk_pipeline():
    from vaudio.runtime import init_carry
    from vaudio.runtime.chunked import make_chunk_pipeline
    from vaudio.runtime.step import default_params
    cfg = AuralizerConfig(channels=2)
    return jax.make_jaxpr(make_chunk_pipeline(cfg, jit=False))(
        init_carry(cfg), jnp.zeros((4, 64, 64, 3), jnp.uint8),
        default_params(cfg))


def _jaxpr_tp_step():
    from vaudio.parallel import (init_carry_batch, make_parallel_step,
                                 make_stream_mesh)
    cfg = AuralizerConfig()
    mesh = make_stream_mesh(2, 2, devices=jax.devices()[:4])
    return jax.make_jaxpr(make_parallel_step(cfg, mesh, jit=False))(
        init_carry_batch(cfg, 2), jnp.zeros((2, 64, 64, 3), jnp.uint8),
        LiveParams().as_arrays())


def _jaxpr_orthomodes_step():
    from vaudio.runtime.engine import make_engine
    eng = make_engine("orthomodes", AuralizerConfig())
    frame = jnp.zeros((32, 32, 3), jnp.float32)
    return jax.make_jaxpr(eng.raw_step())(
        eng.init_carry(frame), frame, eng.params_arrays(LiveParams()))


@pytest.mark.parametrize("build", [_jaxpr_frame_step, _jaxpr_chunk_pipeline,
                                   _jaxpr_tp_step, _jaxpr_orthomodes_step],
                         ids=["frame_step", "chunk_pipeline", "tp_step",
                              "orthomodes_step"])
def test_no_pallas_call(build):
    text = str(build())
    assert "pallas_call" not in text
    assert "dot_general" in text or "fft" in text
