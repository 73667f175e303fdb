"""Vision engine — frame feature extraction (the L2 layer of SURVEY.md §1).

Re-expression, as one fused XLA graph, of video-auralizer/VisionEngine.swift
and the two live Metal kernels in Metal Functions/convolveFeatures.metal:

* mip-pyramid downsampling (Metal ``generateMipmaps``) -> repeated 2x2
  mean pooling;
* ``convolveFeatures`` -> fused HSI conversion + four 3x3 zero-sum mode
  stencils with clamp-to-edge borders;
* ``calculateHueHistogram`` -> an atomics-free one-hot/matmul histogram
  (exact integer counts, equal to the Metal atomic scatter-add);
* the CPU reductions of ``processVideoFrame`` (per-cell hue argmax + EMA,
  per-cell gradient statistics) -> batched reductions.
"""

from vaudio.vision.features import (
    acos_poly,
    cell_gradient_stats,
    extract_features,
    frame_mip_planes,
    frame_stats,
    hist_max_and_arg,
    feature_stencil,
    hue_histogram,
    mip_downsample,
    rgb_to_hsi,
    rgb_to_hsi_planes,
    rotate_cw,
    update_hues,
    update_hues_from_stats,
    yuv420_mip_to_rgb_planes,
)

__all__ = [
    "acos_poly",
    "cell_gradient_stats",
    "extract_features",
    "frame_mip_planes",
    "frame_stats",
    "hist_max_and_arg",
    "feature_stencil",
    "hue_histogram",
    "mip_downsample",
    "rgb_to_hsi",
    "rgb_to_hsi_planes",
    "rotate_cw",
    "update_hues",
    "update_hues_from_stats",
    "yuv420_mip_to_rgb_planes",
]
