"""Wall-clock-bounded long-run soak in CI (the full 100k-frame run is
benchmarks/soak.py; this bounded version must still cover thousands of
frames of phase/AGC recurrence on the CPU harness)."""

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_bounded_soak():
    from benchmarks.soak import run_soak
    # size 64 + mip 1 -> 64 mip px/cell: same hue-gate margin as a
    # 256/mip-3 run at 9x less pixel work.
    summary = run_soak(total_frames=200_000, budget_s=45.0, chunk=1000,
                       size=64, mip_level=1, log=lambda s: None)
    assert summary["ok"]
    # The CPU harness does >100 fps at 64x64; a 45 s budget must clear
    # several thousand frames (minutes of synthesized audio).
    assert summary["frames"] >= 3000, summary
    assert summary["agc_envelope_max"] < 1e3
    # The realism criteria the r2 soak silently missed: audible output
    # and a moving hue EMA.
    assert summary["pcm_rms_min"] > 1e-2
    assert summary["distinct_hue_states"] >= 2
