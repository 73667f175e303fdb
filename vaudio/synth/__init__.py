"""Spectral synthesis — the L3 layer of SURVEY.md §1.

Re-expression, as dense XLA contractions, of the reference's additive
harmonic+Bessel synthesizer: the ``computeSpectrum`` Metal kernel
(Metal Functions/SpectrumCompute.metal:82-214) and the CPU-side phase
accumulation (SoundEngine.swift:257-286).

The per-bin/per-cell/per-partial triple loop becomes a dense two-stage
computation: a (bins x partials) windowed-sinc peak matrix evaluated
elementwise, contracted with per-partial complex weights in one dot.
"""

from vaudio.synth.spectrum import (
    SynthConstants,
    build_spectrum,
    cell_pan_gains,
    contract_spectrum,
    finalize_spectrum,
    flatten_partials,
    live_pan_from_params,
    live_pan_gains,
    partial_weights,
    phase_accumulate,
    phase_advance,
    spectral_filter_gain,
)

__all__ = [
    "spectral_filter_gain",
    "live_pan_from_params",
    "live_pan_gains",
    "SynthConstants",
    "build_spectrum",
    "cell_pan_gains",
    "contract_spectrum",
    "finalize_spectrum",
    "flatten_partials",
    "partial_weights",
    "phase_accumulate",
    "phase_advance",
]
