"""Config-permutation smoke tests: every flag combination must produce
finite audio through the full pipeline."""

import dataclasses
import itertools

import numpy as np
import pytest

from vaudio.config import AuralizerConfig, LiveParams
from vaudio.runtime import run_offline


FLAGS = ["quirk_compat", "linear_cell_grads", "quantize_mips",
         "enable_filters"]


# 8 combos cover every flag on and off in mixed company (each flag toggles
# across the set); the full 2^4 sweep costs ~3 min of compiles on the
# single-core CI host for no extra coverage of pairwise interactions.
@pytest.mark.parametrize("bits", [0, 1, 2, 4, 8, 7, 13, 15])
def test_flag_combinations(bits, rng):
    kwargs = {f: bool(bits >> i & 1) for i, f in enumerate(FLAGS)}
    # Small nfft keeps the 16 compiles cheap on the single-core CI host;
    # the default-size pipeline is exercised everywhere else.
    cfg = dataclasses.replace(AuralizerConfig(), nfft=1026, **kwargs)
    frames = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    audio, carry, _ = run_offline(frames, cfg, LiveParams().as_arrays())
    a = np.asarray(audio)
    assert a.shape == (2 * cfg.hop_size,)
    assert np.all(np.isfinite(a))


@pytest.mark.parametrize("channels", [1, 2])
def test_channel_pallas_combos(channels, rng):
    cfg = dataclasses.replace(AuralizerConfig(), channels=channels)
    frames = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    audio, _, _ = run_offline(frames, cfg, LiveParams().as_arrays())
    assert np.all(np.isfinite(np.asarray(audio)))
