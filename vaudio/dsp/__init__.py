"""Pure DSP / math primitives (the L1 layer of SURVEY.md §1).

Re-expression of video-auralizer/HelperFunctions.swift plus the closed-form
peak/hash math embedded in the Metal kernels.  Everything here is a pure jnp
function operating on float32 arrays and safe to use under `jax.jit` /
`lax.scan`.
"""

from vaudio.dsp.core import (
    agc_normalize,
    find_closest_index,
    hann_sinc_peak,
    hann_sinc_peak_fast,
    sinpi_reduced,
    hann_window_norm,
    hash_phase,
    hue_to_f0,
    irfft_from_half,
    irfft_from_half_dense,
    linear_to_log2,
    linspace,
    mirror_and_conjugate,
    overlap_add,
    sigmoid_normalize,
    sinc,
)

__all__ = [
    "agc_normalize",
    "find_closest_index",
    "hann_sinc_peak",
    "hann_sinc_peak_fast",
    "sinpi_reduced",
    "hann_window_norm",
    "hash_phase",
    "hue_to_f0",
    "irfft_from_half",
    "irfft_from_half_dense",
    "linear_to_log2",
    "linspace",
    "mirror_and_conjugate",
    "overlap_add",
    "sigmoid_normalize",
    "sinc",
]
