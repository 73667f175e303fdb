"""Driver entry-point contract tests (8-device virtual CPU mesh)."""

import os
import sys

import numpy as np

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    carry, out = jax.jit(fn)(*args)
    assert out["pcm"].shape == (2048,)
    assert np.all(np.isfinite(np.asarray(out["pcm"])))


def test_dryrun_multichip_8():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_dryrun_multichip_4():
    import __graft_entry__ as ge
    ge.dryrun_multichip(4)
