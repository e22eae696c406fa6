"""A baseline JPEG round trip of one 8-bit gray channel, in numpy.

``round_trip_gray(image, quality)`` equals ``cv2.imdecode(cv2.imencode(
".jpg", image, [IMWRITE_JPEG_QUALITY, quality])[1], IMREAD_GRAYSCALE)``
bit for bit (OpenCV 5.0's libjpeg-turbo): the entropy coding between the
two is lossless, so the round trip is

  * the image padded to whole 8x8 blocks by repeating its last column and
    row (libjpeg's ``expand_right_edge`` / ``expand_bottom_edge``), the
    samples centred on 128;
  * libjpeg's integer forward DCT (``jfdctint.c``, ``jpeg_fdct_islow``:
    13-bit constants, two passes, the output 8 times the true DCT);
  * quantisation by ``8 q``, rounded half away from zero (what libjpeg-turbo's
    reciprocal multiply gives for every 16-bit coefficient), with the
    standard luminance table scaled to ``quality`` (``jpeg_set_quality``,
    baseline: 1..255);
  * dequantisation and libjpeg's integer inverse DCT (``jidctint.c``,
    ``jpeg_idct_islow``), its output mapped through the range-limit table
    (``prepare_range_limit_table``), then cropped back to the image.

The port writes and reads no JPEG files (``utils/png.py``); this is what
``tools/shift_fixtures.py`` needs to degrade a page as the JAX tool does.
"""
from __future__ import annotations

import numpy as np

CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172

# ITU T.81 Annex K.1, row-major (the DCT's natural order).
LUMINANCE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    np.int64,
)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def quality_table(quality: int) -> np.ndarray:
    """The luminance table scaled to ``quality`` as ``jpeg_set_quality``
    scales it, forced to baseline (1..255)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((LUMINANCE * scale + 50) // 100, 1, 255)


def _odd_part(t0, t1, t2, t3):
    """The rotations shared by both transforms' odd halves (figure 8 of the
    LL&M paper in libjpeg): returns the four outputs before descaling."""
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0, t1 = t0 * FIX_0_298631336, t1 * FIX_2_053119869
    t2, t3 = t2 * FIX_3_072711026, t3 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
    return t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4


def _fdct_pass(d: np.ndarray, axis: int, first: bool) -> np.ndarray:
    """One pass of ``jpeg_fdct_islow`` along ``axis`` (rows first)."""
    g = [np.take(d, i, axis=axis) for i in range(8)]
    t0, t7 = g[0] + g[7], g[0] - g[7]
    t1, t6 = g[1] + g[6], g[1] - g[6]
    t2, t5 = g[2] + g[5], g[2] - g[5]
    t3, t4 = g[3] + g[4], g[3] - g[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    n = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
    out = [None] * 8
    if first:
        out[0], out[4] = (t10 + t11) << PASS1_BITS, (t10 - t11) << PASS1_BITS
    else:
        out[0], out[4] = _descale(t10 + t11, PASS1_BITS), _descale(t10 - t11, PASS1_BITS)
    z1 = (t12 + t13) * FIX_0_541196100
    out[2] = _descale(z1 + t13 * FIX_0_765366865, n)
    out[6] = _descale(z1 - t12 * FIX_1_847759065, n)
    o7, o5, o3, o1 = _odd_part(t4, t5, t6, t7)
    out[7], out[5], out[3], out[1] = (_descale(v, n) for v in (o7, o5, o3, o1))
    return np.stack(out, axis=axis)


def _idct_pass(d: np.ndarray, axis: int, first: bool) -> np.ndarray:
    """One pass of ``jpeg_idct_islow`` along ``axis`` (columns first). Its
    shortcuts for all-zero AC terms give the same values and are not taken."""
    g = [np.take(d, i, axis=axis) for i in range(8)]
    z1 = (g[2] + g[6]) * FIX_0_541196100
    t2 = z1 - g[6] * FIX_1_847759065
    t3 = z1 + g[2] * FIX_0_765366865
    t0, t1 = (g[0] + g[4]) << CONST_BITS, (g[0] - g[4]) << CONST_BITS
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o0, o1, o2, o3 = _odd_part(g[7], g[5], g[3], g[1])
    n = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS + 3
    out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]
    return np.stack([_descale(v, n) for v in out], axis=axis)


def _range_limit(x: np.ndarray) -> np.ndarray:
    """libjpeg's post-IDCT table, indexed by ``x & 1023``: ``x + 128``
    clamped to 0..255 for -512 <= x < 512, wrapping beyond."""
    i = x & 1023
    return np.where(i < 128, i + 128, np.where(i < 512, 255, np.where(i < 896, 0, i - 896)))


def round_trip_gray(image: np.ndarray, quality: int) -> np.ndarray:
    """(H, W) uint8 -> (H, W) uint8: encode at ``quality`` and decode
    (module docstring)."""
    if image.dtype != np.uint8 or image.ndim != 2:
        raise ValueError(f"round_trip_gray: want (H, W) uint8, got {image.dtype} {image.shape}")
    h, w = image.shape
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    x = np.pad(image, ((0, hp - h), (0, wp - w)), mode="edge").astype(np.int64) - 128
    blocks = x.reshape(hp // 8, 8, wp // 8, 8).transpose(0, 2, 1, 3)
    coef = _fdct_pass(_fdct_pass(blocks, 3, True), 2, False)
    q = quality_table(quality)
    div = q << 3
    level = (np.abs(coef) + (div >> 1)) // div
    level = np.where(coef < 0, -level, level)
    pixels = _range_limit(_idct_pass(_idct_pass(level * q, 2, True), 3, False))
    return pixels.transpose(0, 2, 1, 3).reshape(hp, wp)[:h, :w].astype(np.uint8)
