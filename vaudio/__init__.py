"""Vaudio — a real-time video-sonification framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of
``ma-casali/video-auralizer`` (an iOS Swift/Metal app): live video frames are
reduced to per-cell color/gradient features that drive an additive
harmonic+Bessel spectral synthesizer, inverse-FFT'd and overlap-added into a
streaming PCM signal.

Layer map (mirrors SURVEY.md §1 of the reference):

* ``vaudio.dsp``      — pure DSP primitives (ref L1, HelperFunctions.swift)
* ``vaudio.vision``   — frame feature extraction (ref L2, VisionEngine.swift
                        + convolveFeatures.metal)
* ``vaudio.synth``    — spectral synthesis (ref L3, SoundEngine.swift +
                        SpectrumCompute.metal)
* ``vaudio.runtime``  — the single jitted per-frame step, offline scan and
                        streaming host loop (ref L3/L4 runtime behavior)
* ``vaudio.io``       — frame sources and PCM sinks (ref L6 + AVFoundation)
* ``vaudio.parallel`` — multi-stream batching and mesh sharding
* ``vaudio.api``      — the public surface (ref L4, VideoToAudio.swift)
"""

from vaudio.config import AuralizerConfig, LiveParams, DEFAULT_CONFIG

__version__ = "0.1.0"

__all__ = ["AuralizerConfig", "LiveParams", "DEFAULT_CONFIG", "__version__"]
