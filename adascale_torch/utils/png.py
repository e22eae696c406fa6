"""Page images without OpenCV or PIL: PNG through ``zlib`` and numpy.

``read_image(path)`` returns an (H, W, 3) RGB uint8 page from

  * a PNG of 8-bit gray, RGB or RGBA, non-interlaced, with any of the five
    row filters (alpha is dropped and gray repeated into three channels, as
    ``cv2.imread``'s default colour mode reads them);
  * an ``.npz`` page holding an ``image`` array, as
    ``tests/fixtures/shift_pages`` do.

JPEG, 16-bit, interlaced, palette and gray + alpha PNG raise with a message
that says so (JPEG is out of scope, ROADMAP Queue 1 item 14). ``write_png(path, image)`` writes
gray, RGB or RGBA uint8 with no row filter.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Channels per colour type read: 0 gray, 2 RGB, 6 RGBA.
CHANNELS = {0: 1, 2: 3, 6: 4}


def read_image(path: str) -> np.ndarray:
    """The page at ``path`` as (H, W, 3) RGB uint8 (module docstring)."""
    if str(path).endswith(".npz"):
        with np.load(path) as page:
            image = page["image"]
        if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"{path}: want an (H, W, 3) uint8 'image', got {image.dtype} {image.shape}")
        return image
    with open(path, "rb") as fin:
        data = fin.read()
    if data[:2] == b"\xff\xd8":
        raise NotImplementedError(f"{path}: JPEG is not read by the port (ROADMAP Queue 1 item 14); use PNG or .npz")
    return to_rgb(read_png_bytes(data, str(path)))


def to_rgb(pixels: np.ndarray) -> np.ndarray:
    """(H, W, channels) gray / RGB / RGBA -> (H, W, 3) RGB."""
    if pixels.shape[2] == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def read_png_bytes(data: bytes, name: str = "PNG") -> np.ndarray:
    """A PNG file's bytes -> (H, W, channels) uint8 as stored."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8:
        raise NotImplementedError(f"{name}: {depth}-bit PNG is not read by the port (8-bit only)")
    if interlace:
        raise NotImplementedError(f"{name}: interlaced PNG is not read by the port")
    if colour not in CHANNELS:
        raise NotImplementedError(f"{name}: PNG colour type {colour} is not read by the port (gray, RGB, RGBA)")
    channels = CHANNELS[colour]
    rows = unfilter(zlib.decompress(b"".join(idat)), height, width * channels, channels)
    return rows.reshape(height, width, channels)


def unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)
    on ``height`` rows of ``stride`` bytes, ``bpp`` bytes a pixel."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG image data of {len(raw)} bytes, want {height * (stride + 1)}")
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        kind, row = raw[start], np.frombuffer(raw, np.uint8, stride, start + 1)
        if kind == 0:
            cur = row
        elif kind == 1:
            cur = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = row + prev
        elif kind in (3, 4):
            cur = np.array(_unfilter_serial(row.tolist(), prev.tolist(), bpp, kind), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_serial(row: list, prev: list, bpp: int, kind: int) -> list:
    """The average (3) and Paeth (4) filters, which read the row's own
    unfiltered bytes to their left: a byte at a time."""
    cur = [0] * len(row)
    for i, v in enumerate(row):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            cur[i] = (v + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (v + pred) & 0xFF
    return cur


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8 image as an
    8-bit gray, RGB or RGBA PNG, every row unfiltered."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[:, :, None]
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in (1, 3, 4):
        raise ValueError(f"write_png: want gray, RGB or RGBA uint8, got {image.dtype} {image.shape}")
    height, width, channels = image.shape
    colour = {1: 0, 3: 2, 4: 6}[channels]
    rows = np.concatenate([np.zeros((height, 1), np.uint8), image.reshape(height, -1)], axis=1)
    with open(path, "wb") as fout:
        fout.write(SIGNATURE)
        fout.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)))
        fout.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        fout.write(_chunk(b"IEND", b""))
