"""Frame feature extraction as pure jnp functions.

The reference splits this work across a GPU mip/blit pass, two Metal compute
kernels and two hot CPU loops with three host<->device bounces
(VisionEngine.swift:91-316).  Here the whole thing is one fused XLA graph:
device-resident from frame tensor to the 16 hues + 16 gradient vectors.

Layout strategy: channel-PLANES, not interleaved.  An (H, W, 3) array
puts a 3-element axis innermost, which wastes vector width and forces
strided access; all hot math here runs on (H, W) planes with W
contiguous.  The kernels' rotated
output indexing (convolveFeatures.metal:53-59) is folded into *index
arithmetic* — cell assignment and slice bounds — instead of materializing
rotated copies; explicit rotation only happens for debug map export.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from vaudio.config import AuralizerConfig

_TWO_PI = np.float32(2.0 * np.pi)

# GPU tensor cores run f32 dots at DEFAULT precision in TF32 (a 10-bit
# mantissa, ~1e-3 relative error), which the CPU test harness can never
# see.  Every parity-critical f32 contraction pins HIGHEST (exact f32);
# the FLOP cost is invisible next to these dots' memory traffic.  Integer
# (int8 -> i32) contractions are exact by construction and stay DEFAULT.
_EXACT = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Color space
# ---------------------------------------------------------------------------

# Abramowitz & Stegun 4.4.46: acos(x) = sqrt(1-x) * P7(x) on [0, 1],
# max abs error <= 2e-8 rad (mirrored via acos(-x) = pi - acos(x)).
_ACOS_COEFFS = tuple(np.float32(c) for c in (
    1.5707963050, -0.2145988016, 0.0889789874, -0.0501743046,
    0.0308918810, -0.0170881256, 0.0066700901, -0.0012624911))


def acos_poly(x):
    """Polynomial arccos: one sqrt + 7 fma + a sign select, replacing the
    transcendental acos expansion on the elementwise hue hot path
    (cfg.fast_hue_acos).  Max abs error 2e-8 rad over [-1, 1] — a hue
    deviation of 3e-9 of the circle, 6 orders below the 1/360 histogram
    bin width."""
    a = jnp.abs(x)
    p = _ACOS_COEFFS[-1]
    for c in _ACOS_COEFFS[-2::-1]:
        p = p * a + c
    r = jnp.sqrt(jnp.maximum(np.float32(1.0) - a, np.float32(0.0))) * p
    return jnp.where(x >= 0.0, r, np.float32(np.pi) - r)


def rgb_to_hsi_planes(r, g, b, fast_acos: bool = False):
    """RGB planes -> (H, S, I) planes; the Metal helper's exact math
    (convolveFeatures.metal:14-38).

    I = mean(r,g,b); S = 1 - min/I (0 where I<=0);
    H = acos-formula angle normalized to [0,1], 0 where the denominator
    vanishes (grey pixels).  The acos argument is clamped to [-1,1] — Metal
    leaves it UB outside; clamping matches the mathematically exact value.

    ``fast_acos`` swaps jnp.arccos for :func:`acos_poly` (<= 2e-8 rad).
    """
    i = (r + g + b) * np.float32(1.0 / 3.0)
    min_val = jnp.minimum(r, jnp.minimum(g, b))
    s = jnp.where(i > 0.0, 1.0 - min_val / jnp.where(i > 0.0, i, 1.0), 0.0)

    num = 0.5 * ((r - g) + (r - b))
    den = jnp.sqrt((r - g) ** 2 + (r - b) * (g - b))
    safe_den = jnp.where(den != 0.0, den, 1.0)
    arg = jnp.clip(num / safe_den, -1.0, 1.0)
    theta = acos_poly(arg) if fast_acos else jnp.arccos(arg)
    h = jnp.where(b <= g, theta, _TWO_PI - theta) / _TWO_PI
    h = jnp.where(den != 0.0, h, 0.0)
    return h, s, i


def rgb_to_hsi(rgb):
    """Channels-last convenience wrapper over :func:`rgb_to_hsi_planes`.

    Args: rgb: f32[..., 3] in [0, 1].  Returns f32[..., 3] (H, S, I).
    """
    rgb = jnp.asarray(rgb, dtype=jnp.float32)
    h, s, i = rgb_to_hsi_planes(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    return jnp.stack([h, s, i], axis=-1)


# ---------------------------------------------------------------------------
# Mip pyramid
# ---------------------------------------------------------------------------

def _pool_one_level(planes):
    """(C, H, W) -> (C, H//2, W//2) 2x2 mean pool as two banded matmuls.

    One mip level of the chain.  Odd dims: the last row/col is dropped
    (the banded matrix only covers full 2-blocks) — Metal's mip chain
    floor-halves each level, so dims match d>>1 exactly; its weighted
    3-tap filter at odd edges is approximated by the crop — a one-texel
    boundary difference, documented in docs/PARITY.md.

    Same banded-matmul formulation as the one-shot path below.
    """
    c, h, w = planes.shape
    pr = jnp.asarray(_pool_matrix(h, 1))
    rows = jax.lax.dot_general(
        planes, pr, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=_EXACT)                             # (c, w, h//2)
    rows = jnp.swapaxes(rows, 1, 2)                   # (c, h//2, w)
    pc = jnp.asarray(_pool_matrix(w, 1))
    return jax.lax.dot_general(
        rows, pc, dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=_EXACT)                             # (c, h//2, w//2)


@functools.lru_cache(maxsize=32)
def _pool_matrix(n: int, level: int):
    """Banded box-averaging matrix: P[r, i] = 1/2^level for r in block i.

    Output block i covers rows [i*2^l, (i+1)*2^l) — exactly the pixels the
    repeated crop-and-halve chain averages, so the one-shot pooling is
    arithmetically identical (modulo f32 associativity) including the
    odd-dimension truncation behavior.
    """
    m = n >> level
    k = 1 << level
    p = np.zeros((n, m), np.float32)
    for i in range(m):
        p[i * k:(i + 1) * k, i] = 1.0 / k
    return p


def _quant_pool_level_u8(m):
    """One 8-bit-quantized mip level entirely in integer arithmetic:
    (C, H, W) u8 -> (C, H//2, W//2) u8 with each output the round-half-
    to-even of the 2x2 block mean — the idealized bgra8Unorm mip step
    (VisionEngine.swift:137-147) on the 0..255 grid.

    Same integer recipe as the one-shot u8 path in mip_downsample_planes:
    XOR-0x80 bitcast to s8, 0/1-banded int8 row matmul accumulating
    i32, lossless q/r split for the int8 column matmul (row sums span
    [-256, 254] — one bit too wide for s8), then an integer rounding
    epilogue on the 4x-smaller output.  Exact by construction: the i32
    block sum S = sum of the four u8 values, and the output is
    round_half_even(S / 4) = (S >> 2) + bump with bump = 1 iff
    rem == 3 or (rem == 2 and the floor is odd).
    """
    c, h, w = m.shape
    s8 = jax.lax.bitcast_convert_type(m ^ np.uint8(0x80), jnp.int8)
    pr_i8 = jnp.asarray((_pool_matrix(h, 1) > 0).astype(np.int8))
    rows = jax.lax.dot_general(
        s8, pr_i8, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)             # (c, w, h2)
    rows = jnp.swapaxes(rows, 1, 2)                   # (c, h2, w)
    q = jnp.right_shift(rows, 1)                      # [-128, 127]
    r = rows - (q << 1)                               # {0, 1}
    pc_i8 = jnp.asarray((_pool_matrix(w, 1) > 0).astype(np.int8))

    def idot(x):
        return jax.lax.dot_general(
            x.astype(jnp.int8), pc_i8,
            dimension_numbers=(((2,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)

    acc = (idot(q) << 1) + idot(r)                    # sum of (v - 128)
    s = acc + np.int32(512)                           # block sum of v
    base = jnp.right_shift(s, 2)
    rem = s & 3
    bump = ((rem == 3) | ((rem == 2) & ((base & 1) == 1)))
    return (base + bump.astype(jnp.int32)).astype(jnp.uint8)


def mip_downsample_planes(planes, level: int, quantize: bool = False,
                          scale: float = 1.0, quantize_int8: bool = False):
    """(C, H, W) planes -> (C, H>>l, W>>l) box downsample.

    Equivalent of blit ``generateMipmaps`` + mip-level sampling
    (VisionEngine.swift:152-173,189-192).

    The 8x box filter is two contractions with banded averaging
    matrices (rows then columns) rather than a reshape-and-mean, so the
    u8 path stays exact in integer arithmetic end to end.

    ``scale`` is folded into the row-pooling matrix — uint8 camera frames
    pass ``scale=1/255`` so the normalization costs no extra memory pass
    over the full-resolution frame.

    ``quantize=True`` keeps the level-by-level path and rounds each level
    to 8-bit steps like a bgra8Unorm mip chain (parity knob).
    """
    planes = jnp.asarray(planes)
    is_u8 = planes.dtype == jnp.uint8
    c, h, w = planes.shape
    if (h >> level) == 0 or (w >> level) == 0:
        raise ValueError(f"frame dims ({h},{w}) too small for mip {level}")
    if quantize:
        if (quantize_int8 and is_u8 and level >= 1
                and abs(scale * 255.0 - 1.0) < 1e-9):
            # All-integer quantized chain (cfg.quantize_mips_int8): each
            # level is _quant_pool_level_u8 — int8 matmuls with an
            # exact round-half-even integer epilogue, so the u8 frame
            # never leaves the 0..255 grid until the final scale.
            # Deviation vs the f32 emulation below: at an EXACT block-
            # mean midpoint (block sum ≡ 2 mod 4) the f32 path's
            # rounding direction is decided by ~1e-4 of accumulated f32
            # error while this path rounds half-to-even — ≤ 1 grid step
            # per level, both being approximations of Metal's
            # unspecified bgra8Unorm rounding (docs/PARITY.md).
            m = planes
            for _ in range(level):
                m = _quant_pool_level_u8(m)
            return m.astype(jnp.float32) * np.float32(1.0 / 255.0)
        # Strict-parity path: quantize every level to the 8-bit grid like
        # a bgra8Unorm mip chain (VisionEngine.swift:137-147).  The
        # inter-level rounding is nonlinear, so the levels can't fuse
        # into one matmul — but each level is still the banded-matmul
        # pool, keeping the knob usable at production resolutions.
        planes = planes.astype(jnp.float32)
        if scale != 1.0:
            planes = planes * np.float32(scale)
        for _ in range(level):
            planes = jnp.round(_pool_one_level(planes) * 255.0) / 255.0
        return planes
    if level == 0:
        planes = planes.astype(jnp.float32)
        return planes * np.float32(scale) if scale != 1.0 else planes

    k = 1 << level
    if is_u8 and level <= 7:
        # all-integer fast path for camera frames — exact by
        # construction:
        # * u8 XOR 0x80 bitcast to s8 equals (value - 128) exactly; the
        #   row pool is an s8 x s8 integer matmul with 0/1 banded
        #   entries accumulating in i32 (block sums <= 128*2^level);
        # * the COLUMN pool stays integer too: an f32 dot here would pay
        #   either reduced-precision operand rounding at DEFAULT
        #   precision (the rows exceed a TF32 or bf16 mantissa) or a
        #   multi-pass HIGHEST dot.  Instead the i32 row sums
        #   split losslessly into two int8 halves (q = rows >> level in
        #   [-128, 127]; r = rows - (q << level) in [0, 2^level - 1])
        #   and two 0/1-banded int8 matmuls recombine as (q@P << level)
        #   + r@P — bit-exact i32, 2 int8 passes on the 2^level-
        #   smaller intermediate;
        # * the mean normalization, +128 offset undo and the extra
        #   ``scale`` (1/255, studio swing, ...) fold into ONE f32
        #   multiply-add on the final (tiny) output.  The full-
        #   resolution frame is read once, as int8.
        s8 = jax.lax.bitcast_convert_type(
            planes ^ np.uint8(0x80), jnp.int8)
        pr_i8 = jnp.asarray(
            (_pool_matrix(h, level) > 0).astype(np.int8))
        rows = jax.lax.dot_general(
            s8, pr_i8, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)         # (c, w, m) i32
        rows = jnp.swapaxes(rows, 1, 2)               # (c, m, w)
        q = jnp.right_shift(rows, level)              # arithmetic; floor
        r = rows - (q << level)                       # in [0, 2^level)
        pc_i8 = jnp.asarray(
            (_pool_matrix(w, level) > 0).astype(np.int8))
        def idot(x):
            return jax.lax.dot_general(
                x.astype(jnp.int8), pc_i8,
                dimension_numbers=(((2,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)
        acc = (idot(q) << level) + idot(r)            # (c, m, n) exact i32
        gain = np.float32(scale / (k * k))
        return acc.astype(jnp.float32) * gain + np.float32(128.0 * scale)
    # f32-input path (and the level > 7 u8 corner, where the int8 split
    # no longer fits): two f32 banded matmuls at pinned-exact precision.
    pr = jnp.asarray(_pool_matrix(h, level) * np.float32(scale))
    rows = jax.lax.dot_general(
        planes.astype(jnp.float32), pr,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=_EXACT)                             # (c, w, m)
    pc = jnp.asarray(_pool_matrix(w, level))
    rows = jnp.swapaxes(rows, 1, 2)                   # (c, m, w)
    return jax.lax.dot_general(
        rows, pc, dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=_EXACT)                             # (c, m, n)


def mip_downsample(frame, level: int, quantize: bool = False):
    """Channels-last wrapper: f32[H, W, C] -> f32[H>>l, W>>l, C]."""
    frame = jnp.asarray(frame, dtype=jnp.float32)
    planes = jnp.transpose(frame, (2, 0, 1))
    out = mip_downsample_planes(planes, level, quantize)
    return jnp.transpose(out, (1, 2, 0))


# ---------------------------------------------------------------------------
# Rotation
# ---------------------------------------------------------------------------

def rotate_cw(x):
    """The kernels' rotated output indexing (convolveFeatures.metal:53-59):
    out[rotY, rotX] with rotX = (H-1) - y, rotY = x, i.e. a 90-degree
    clockwise rotation.  (H, W, ...) -> (W, H, ...).

    Hot paths avoid this copy by rotating indices instead (see
    :func:`hue_histogram` / :func:`cell_gradient_stats`); it is kept for
    debug-map export and tests.
    """
    return jnp.rot90(x, k=-1, axes=(0, 1))


# ---------------------------------------------------------------------------
# 3x3 mode stencils
# ---------------------------------------------------------------------------

# The four zero-sum masks, written as k[dy+1][dx+1] from the tap/weight
# vectors in convolveFeatures.metal:94-113 (taps i{x}{y}: x = left..right,
# y = top..bottom).
MODE_KERNELS = np.array(
    [
        # breathing (center-surround)
        [[-1, 0, -1],
         [0, 4, 0],
         [-1, 0, -1]],
        # "vertical tilt" (a horizontal-direction gradient; reference name kept)
        [[1, 0, -1],
         [1, 0, -1],
         [1, 0, -1]],
        # "horizontal tilt" (vertical-direction gradient)
        [[-1, -1, -1],
         [0, 0, 0],
         [1, 1, 1]],
        # saddle (diagonal)
        [[1, 0, -1],
         [0, 0, 0],
         [-1, 0, 1]],
    ],
    dtype=np.float32,
)  # (4 modes, 3, 3)


def feature_stencil_plane(plane):
    """Apply the four 3x3 mode masks to one (H, W) channel plane.

    Fused equivalent of the ``convolveFeatures`` kernel body
    (convolveFeatures.metal:40-130) before its rotated write, for a single
    channel.  Borders are clamp-to-edge (the Metal sampler).

    Returns: f32[4, H, W] — one plane per mode.
    """
    plane = jnp.asarray(plane, dtype=jnp.float32)
    h, w = plane.shape
    padded = jnp.pad(plane, ((1, 1), (1, 1)), mode="edge")
    outs = []
    for m in range(4):
        acc = jnp.zeros((h, w), jnp.float32)
        for dy in range(3):
            for dx in range(3):
                k = MODE_KERNELS[m, dy, dx]
                if k == 0.0:
                    continue
                acc = acc + np.float32(k) * padded[dy:dy + h, dx:dx + w]
        outs.append(acc)
    return jnp.stack(outs)


def feature_stencil(hsi):
    """Channels-last wrapper: f32[H, W, 3] -> f32[H, W, 3, 4]."""
    hsi = jnp.asarray(hsi, dtype=jnp.float32)
    per_ch = [feature_stencil_plane(hsi[..., c]) for c in range(3)]
    return jnp.stack([jnp.transpose(p, (1, 2, 0)) for p in per_ch], axis=2)


# ---------------------------------------------------------------------------
# Hue histogram (atomics-free)
# ---------------------------------------------------------------------------

def _cell_ids_unrotated(shape: Tuple[int, int], grid: int):
    """Per-pixel cell index in IMAGE orientation, reproducing the kernel's
    integer arithmetic on rotated coordinates
    (convolveFeatures.metal:155-157): for pixel (y, x) the rotated coords
    are (ry, rx) = (x, H-1-y), and
    row = ry*grid // W, col = rx*grid // H, cell = row*grid + col."""
    hm, wm = shape
    y = jax.lax.broadcasted_iota(jnp.int32, (hm, wm), 0)
    x = jax.lax.broadcasted_iota(jnp.int32, (hm, wm), 1)
    row = (x * grid) // wm
    col = ((hm - 1 - y) * grid) // hm
    return row * grid + col


def _cell_ids(shape_rot: Tuple[int, int], grid: int):
    """Cell ids on the *rotated* image (debug/spatial-mode path)."""
    wm, hm = shape_rot
    row = (jax.lax.broadcasted_iota(jnp.int32, (wm, hm), 0) * grid) // wm
    col = (jax.lax.broadcasted_iota(jnp.int32, (wm, hm), 1) * grid) // hm
    return row * grid + col


def _cell_tile_bounds(hm: int, wm: int, grid: int):
    """Static per-cell pixel rectangles in image orientation.

    The rotated-coordinate cell arithmetic (_cell_ids_unrotated) makes
    every cell a contiguous rectangle: cell row = x-band, cell col =
    flipped-y band.  Returns (x_bands, y_bands): per band index, a
    (start, length) pair; lengths are ragged when grid does not divide
    the dims (e.g. 135 rows -> 33/34/34/34)."""
    row_of_x = (np.arange(wm) * grid) // wm
    col_of_y = ((hm - 1 - np.arange(hm)) * grid) // hm
    xb = [(int(np.argmax(row_of_x == r)), int(np.sum(row_of_x == r)))
          for r in range(grid)]
    yb = [(int(np.argmax(col_of_y == c)), int(np.sum(col_of_y == c)))
          for c in range(grid)]
    return xb, yb


def hue_bin_factorization(bins: int):
    """``bins = f1 * f2`` with ``f2`` the LARGEST factor <= 16 — the
    tiled histogram's two-level split (360 -> 24 x 15).  Returns
    ``(None, None)`` for unfactorable (prime) counts."""
    f2 = next((f for f in range(16, 1, -1) if bins % f == 0), None)
    return (None, None) if f2 is None else (bins // f2, f2)


def hue_histogram_planes(h, s, i, cfg: AuralizerConfig,
                         method: str = "tiled"):
    """Per-cell hue histogram over gated pixels, from HSI planes in image
    orientation (rotation folded into the cell-id arithmetic).

    Equivalent of ``calculateHueHistogram`` (convolveFeatures.metal:132-165)
    with the atomic scatter-add re-expressed without atomics; all methods
    produce identical integer counts:

    * ``tiled`` (default): cells are contiguous rectangles (see
      :func:`_cell_tile_bounds`), so no cell one-hot is needed — pixels
      tile statically per cell — and the bin axis factors as bins =
      f1*f2 (360 = 24*15), so the joint histogram is a per-cell int8
      contraction of a (pixels, f1) high-digit one-hot against a
      (pixels, f2) low-digit one-hot: hist[c, hi*f2+lo].  One-hot
      elements drop from pixels*360 to pixels*(24+15), ~9x fewer
      compares than the dense one-hot.
    * ``matmul``: hist = cell_onehot^T @ bin_onehot — one
      (cells x pixels) @ (pixels x bins) contraction; the outer product
      of two one-hot encodings summed over pixels IS the joint histogram.
      One-hots are built in int8 (exact for 0/1) with i32 accumulation;
      counts <= pixels fit i32 exactly.
    * ``scatter``: XLA scatter-add on a flat (cells*bins) table.

    Pixels are gated on ``S > 0 and I > 0.1`` (convolveFeatures.metal:154);
    bin = floor(H * 359) of 360 bins (convolveFeatures.metal:159).

    Returns: f32[num_cells, num_hue_bins] counts.
    """
    grid = cfg.grid_size
    bins = cfg.num_hue_bins
    cells = cfg.num_cells
    hm, wm = h.shape

    gate = (s > cfg.saturation_gate) & (i > cfg.intensity_gate)
    bin_idx = jnp.clip((h * np.float32(bins - 1)).astype(jnp.int32),
                       0, bins - 1)

    if method == "tiled":
        f1, f2 = hue_bin_factorization(bins)
        if f2 is None:              # prime bin count: dense fallback
            return hue_histogram_planes(h, s, i, cfg, method="matmul")
        xb, yb = _cell_tile_bounds(hm, wm, grid)
        cw = max(n for _, n in xb) or 1
        rh = max(n for _, n in yb) or 1
        tb, tg = [], []
        for r in range(grid):           # cell row = x band
            x0, xw = xb[r]
            for c2 in range(grid):      # cell col = flipped-y band
                y0, yh = yb[c2]
                pad = ((0, rh - yh), (0, cw - xw))
                tb.append(jnp.pad(jax.lax.slice(
                    bin_idx, (y0, x0), (y0 + yh, x0 + xw)), pad))
                tg.append(jnp.pad(jax.lax.slice(
                    gate, (y0, x0), (y0 + yh, x0 + xw)), pad))
        tb = jnp.stack(tb).reshape(cells, rh * cw)
        g8 = jnp.stack(tg).reshape(cells, rh * cw).astype(jnp.int8)
        hi = tb // f2
        lo = tb - hi * f2
        hi_oh = (hi[..., None] == jnp.arange(f1)).astype(jnp.int8) \
            * g8[..., None]
        lo_oh = (lo[..., None] == jnp.arange(f2)).astype(jnp.int8)
        hist3 = jax.lax.dot_general(
            hi_oh, lo_oh,
            dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32)        # (cells, f1, f2)
        return hist3.reshape(cells, bins).astype(jnp.float32)

    cell_idx = _cell_ids_unrotated((hm, wm), grid)
    p = hm * wm
    if method == "matmul":
        gate_i = gate.reshape(p, 1).astype(jnp.int8)
        cell_oh = jax.nn.one_hot(cell_idx.reshape(p), cells,
                                 dtype=jnp.int8) * gate_i
        bin_oh = jax.nn.one_hot(bin_idx.reshape(p), bins,
                                dtype=jnp.int8)
        return jax.lax.dot_general(
            cell_oh, bin_oh,
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        ).astype(jnp.float32)
    elif method == "scatter":
        flat = (cell_idx * bins + bin_idx).reshape(-1)
        upd = gate.reshape(-1).astype(jnp.float32)
        hist = jnp.zeros((cells * bins,), jnp.float32).at[flat].add(upd)
        return hist.reshape(cells, bins)
    raise ValueError(f"unknown histogram method {method!r}")


def hue_histogram(hsi_rot, cfg: AuralizerConfig, method: str = "matmul"):
    """Rotated-layout wrapper (tests/parity): f32[Wm, Hm, 3] rotated HSI
    image -> f32[cells, bins].  Un-rotates and delegates to the planes
    implementation."""
    hsi = jnp.rot90(jnp.asarray(hsi_rot, jnp.float32), k=1, axes=(0, 1))
    return hue_histogram_planes(hsi[..., 0], hsi[..., 1], hsi[..., 2], cfg,
                                method=method)


def hist_max_and_arg(hist):
    """Per-cell (max count, argmax bin) with the LAST-maximum tie-break of
    Swift's ``max(by:)`` (VisionEngine.swift:264: it replaces the running
    result whenever the candidate is not strictly less, so equal max
    counts resolve to the highest bin) — an argmax over the reversed bin
    axis.  Batchable: hist may carry leading axes.
    """
    bins = hist.shape[-1]
    max_val = jnp.max(hist, axis=-1)
    arg = (bins - 1 - jnp.argmax(hist[..., ::-1], axis=-1)
           ).astype(jnp.float32)
    return max_val, arg


def update_hues_from_stats(max_val, arg, prev_hues, mixing,
                           cfg: AuralizerConfig):
    """The EMA/gate recurrence of the hue update, on precomputed per-cell
    histogram stats — the only serial piece of the vision pass (the
    chunk-batched pipeline scans just this over frames)."""
    mixed = prev_hues.astype(jnp.float32) * mixing + arg * (1.0 - mixing)
    new = mixed.astype(jnp.int32)  # truncation, as Swift Int32(Float)
    return jnp.where(max_val > np.float32(cfg.hist_count_gate), new,
                     prev_hues).astype(jnp.int32)


def update_hues(hist, prev_hues, mixing, cfg: AuralizerConfig):
    """Per-cell dominant-hue argmax, gated and EMA-smoothed.

    Reproduces the CPU reduction at VisionEngine.swift:255-271: for each
    cell, if max count > 20, the new hue is
    ``int32(prev*mix + argmax*(1-mix))`` (truncating), else unchanged.
    LAST-maximum tie-break matches Swift's ``max(by:)`` — see
    :func:`hist_max_and_arg`.

    Args:
      hist: f32[cells, bins]; prev_hues: i32[cells]; mixing: f32 scalar.
    Returns: i32[cells].
    """
    max_val, arg = hist_max_and_arg(hist)
    return update_hues_from_stats(max_val, arg, prev_hues, mixing, cfg)


# ---------------------------------------------------------------------------
# Gradient statistics
# ---------------------------------------------------------------------------

def cell_gradient_stats_planes(modes, cfg: AuralizerConfig):
    """Aggregate intensity-channel mode planes into 16 per-cell vectors.

    Reproduces VisionEngine.swift:273-295: stats are (RMS of breathing,
    mean|vTilt|, mean|hTilt|, max|saddle|) over each cell's pixels.

    Args: modes: f32[4, Hm, Wm] in IMAGE orientation.

    Cell assignment (cfg.linear_cell_grads=True, the reference quirk):
    contiguous 1/16 slices of the flattened ROTATED buffer.  The rotated
    flat index is x*Hm + (Hm-1-y), so slice boundaries are contiguous
    ranges of x — when Wm % 16 == 0 each cell is exactly a Wm/16-column
    band of the unrotated image and the stats reduce over column bands with
    no rotation copy (reductions are pixel-order invariant).  Otherwise we
    fall back to an explicit rotation.
    """
    _, hm, wm = modes.shape
    cells = cfg.num_cells

    if cfg.linear_cell_grads:
        p = hm * wm
        per = p // cells
        if wm % cells == 0:
            # Fast path: column bands, no rotation materialized.
            cw = wm // cells
            b = modes.reshape(4, hm, cells, cw)       # split columns
            sq = jnp.sum(b[0] * b[0], axis=(0, 2))    # (cells,)
            ay = jnp.sum(jnp.abs(b[1]), axis=(0, 2))
            az = jnp.sum(jnp.abs(b[2]), axis=(0, 2))
            aw = jnp.max(jnp.abs(b[3]), axis=(0, 2))
            n = np.float32(hm * cw)
            return jnp.stack([jnp.sqrt(sq / n), ay / n, az / n, aw], axis=1)
        # Generic path: explicit rotated flattening with remainder-to-last.
        flat = jnp.stack([jnp.rot90(modes[m], k=-1).reshape(p)
                          for m in range(4)], axis=1)  # (p, 4)
        stats = []
        for c in range(cells):
            start = c * per
            end = p if c == cells - 1 else (c + 1) * per
            sl = flat[start:end]
            n = np.float32(end - start)
            stats.append(jnp.stack([
                jnp.sqrt(jnp.sum(sl[:, 0] * sl[:, 0]) / n),
                jnp.sum(jnp.abs(sl[:, 1])) / n,
                jnp.sum(jnp.abs(sl[:, 2])) / n,
                jnp.max(jnp.abs(sl[:, 3])),
            ]))
        return jnp.stack(stats)

    # Clean mode: the histogram's 4x4 spatial tiling (on rotated coords).
    cell_idx = _cell_ids_unrotated((hm, wm), cfg.grid_size).reshape(-1)
    oh = jax.nn.one_hot(cell_idx, cells, dtype=jnp.float32)  # (p, cells)
    counts = jnp.sum(oh, axis=0)
    flat = modes.reshape(4, -1)                               # (4, p)
    sq = jnp.matmul(flat[0] * flat[0], oh, precision=_EXACT)
    ay = jnp.matmul(jnp.abs(flat[1]), oh, precision=_EXACT)
    az = jnp.matmul(jnp.abs(flat[2]), oh, precision=_EXACT)
    aw = jnp.max(jnp.where(oh.T > 0, jnp.abs(flat[3])[None, :], 0.0),
                 axis=1)
    return jnp.stack([jnp.sqrt(sq / counts), ay / counts, az / counts, aw],
                     axis=1)


def cell_gradient_stats(intensity_feat_rot, cfg: AuralizerConfig):
    """Rotated-layout wrapper (tests/parity): f32[Wm, Hm, 4] rotated mode
    maps -> f32[cells, 4]."""
    x = jnp.asarray(intensity_feat_rot, jnp.float32)
    modes = jnp.rot90(x, k=1, axes=(0, 1))        # back to image orientation
    return cell_gradient_stats_planes(jnp.transpose(modes, (2, 0, 1)), cfg)


# ---------------------------------------------------------------------------
# Full vision step
# ---------------------------------------------------------------------------

def yuv420_mip_to_rgb_planes(y, u, v, cfg: AuralizerConfig,
                             studio_swing: bool = True):
    """Planar YUV 4:2:0 camera frame -> RGB mip planes on the device.

    Ships 1.5 bytes/px over PCIe instead of 3 and exploits linearity: the
    box mip filter commutes with the affine BT.601 transform, so Y pools by
    2^level and the half-resolution chroma by 2^(level-1) FIRST (banded
    matmuls on the uint8 planes), and the color conversion runs on the tiny
    mip — no chroma upsampling, no full-resolution RGB tensor ever exists.

    Args: y: u8[H, W]; u, v: u8[H/2, W/2] (H, W even).
    Returns: f32[3, H>>level, W>>level] RGB in [0, 1].
    """
    level = cfg.mip_level
    if level < 1:
        raise ValueError(
            f"the planar-YUV ingest path pools half-resolution chroma at "
            f"mip level-1 and so requires mip_level >= 1 (got {level}); "
            f"convert to RGB on the host (io.yuv420_to_rgb) for mip_level=0")
    if studio_swing:
        y_scale, y_off = 1.0 / 219.0, -16.0 / 219.0
        c_scale, c_off = 1.0 / 224.0, -128.0 / 224.0
    else:
        y_scale, y_off = 1.0 / 255.0, 0.0
        c_scale, c_off = 1.0 / 255.0, -128.0 / 255.0
    my = mip_downsample_planes(y[None], level, scale=y_scale)[0] + y_off
    mu = mip_downsample_planes(u[None], level - 1, scale=c_scale)[0] + c_off
    mv = mip_downsample_planes(v[None], level - 1, scale=c_scale)[0] + c_off
    # Chroma mips can be one texel larger on odd dims; crop to luma dims.
    mu = mu[:my.shape[0], :my.shape[1]]
    mv = mv[:my.shape[0], :my.shape[1]]
    r = my + 1.402 * mv
    g = my - 0.344136 * mu - 0.714136 * mv
    b = my + 1.772 * mu
    return jnp.clip(jnp.stack([r, g, b]), 0.0, 1.0)


def frame_mip_planes(frame, cfg: AuralizerConfig):
    """The mip-pool stage of the vision pass: frame -> f32[3, hm, wm]
    RGB mip planes (blit + generateMipmaps + mip-level sampling,
    VisionEngine.swift:130-173,189-192)."""
    if isinstance(frame, dict):
        return yuv420_mip_to_rgb_planes(jnp.asarray(frame["y"]),
                                        jnp.asarray(frame["u"]),
                                        jnp.asarray(frame["v"]), cfg)
    frame = jnp.asarray(frame)
    # uint8 camera frames: the 1/255 normalization folds into the
    # pooling matrix — no separate full-resolution memory pass.
    scale = 1.0 / 255.0 if frame.dtype == jnp.uint8 else 1.0
    planes = jnp.transpose(frame, (2, 0, 1))              # (3, H, W)
    return mip_downsample_planes(planes, cfg.mip_level,
                                 cfg.quantize_mips, scale=scale,
                                 quantize_int8=cfg.quantize_mips_int8)


def frame_stats(frame, cfg: AuralizerConfig,
                compute_debug_maps: bool = False):
    """The stateless part of the vision pass: frame -> (hist f32[16,360],
    grads f32[16,4], debug dict).  Per-frame independent, so the
    chunk-batched pipeline vmaps it over whole frame chunks — only the
    hue EMA (:func:`update_hues_from_stats`) is a serial recurrence.
    """
    mip = frame_mip_planes(frame, cfg)
    h, s, i = rgb_to_hsi_planes(mip[0], mip[1], mip[2],
                                fast_acos=cfg.fast_hue_acos)

    hist = hue_histogram_planes(h, s, i, cfg)
    imodes = feature_stencil_plane(i)                     # (4, hm, wm)
    grads = cell_gradient_stats_planes(imodes, cfg)

    debug = {"histogram": hist}
    if compute_debug_maps:
        hmodes = feature_stencil_plane(h)
        smodes = feature_stencil_plane(s)
        def rot_pack(m):   # (4, hm, wm) -> rotated (wm, hm, 4)
            return jnp.stack([jnp.rot90(m[k], k=-1) for k in range(4)],
                             axis=-1)
        debug.update(
            hue_map=rot_pack(hmodes),
            saturation_map=rot_pack(smodes),
            intensity_map=rot_pack(imodes),
            mip_hsi=jnp.stack([h, s, i], axis=-1),
        )
    return hist, grads, debug


def extract_features(frame, prev_hues, mixing, cfg: AuralizerConfig,
                     compute_debug_maps: bool = False):
    """Full L2 pass: frame -> (hues i32[16], grads f32[16,4], debug dict).

    One fused graph replacing the reference's two command buffers + two CPU
    reduction loops (VisionEngine.swift:91-316).

    Args:
      frame: f32[H, W, 3] RGB in [0,1], u8[H, W, 3] RGB, or a dict
        ``{"y", "u", "v"}`` of planar uint8 YUV 4:2:0 (camera-native).
      prev_hues: i32[16] carried hue state.
      mixing: f32 scalar EMA coefficient (VisionEngine.spectrumMixing).
      compute_debug_maps: also return the hue/saturation/intensity mode maps
        the reference exposes on its debug screen (rotated layout, matching
        the Metal buffers).
    """
    hist, grads, debug = frame_stats(frame, cfg,
                                     compute_debug_maps=compute_debug_maps)
    hues = update_hues(hist, prev_hues, mixing, cfg)
    return hues, grads, debug
