"""The synthetic-page rasterizer in C++, built with g++ and bound with ctypes.

Counterpart of ``adascale/native/__init__.py``. ``load_library()`` compiles
``synth_render.cpp`` (``g++ -O3 -march=native -shared -fPIC -std=c++17``)
once per hash of the source, the flags and the host CPU's features into
``_build/synth_render_<hash>.so`` beside this file and loads it. A failed
build raises with g++'s output: nothing falls back to another renderer.

The library draws a page's ordered command buffer (``execute_draw_buffer``:
glyph tiles blended through each char quad's homography, thick line
segments) and a crop's label maps (``render_labels_native``: quad fills and
the gaussian heatmap). Both are deterministic in their inputs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "synth_render.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _cpu_flags() -> str:
    """The host CPU's feature flags: ``-march=native`` builds for them, so a
    build made on another machine (a copied checkout) is not reused."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return platform.processor()


def library_path() -> str:
    """Where the library of the current source, flags and CPU is (or will
    be) built."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_flags().encode())
    return os.path.join(BUILD_DIR, f"synth_render_{h.hexdigest()[:16]}.so")


def _build(out_so: str) -> None:
    os.makedirs(os.path.dirname(out_so), exist_ok=True)
    # Build into a temporary name and rename: processes that start at once
    # (a generator pool's workers) may race on the first build, and the
    # rename is atomic.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out_so))
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True, timeout=300
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed to build {SOURCE} (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, out_so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> ctypes.CDLL:
    """The compiled library, built first if this source has no build yet.
    Raises when g++ is missing or fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so_path = library_path()
        if not os.path.exists(so_path):
            try:
                _build(so_path)
            except FileNotFoundError as exc:
                raise RuntimeError(f"g++ is needed to build {SOURCE}: {exc}") from exc
        lib = ctypes.CDLL(so_path)
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        c_int = ctypes.c_int
        lib.asr_execute.argtypes = [u8p, c_int, c_int, i32p, i32p, u8p, f32p, c_int, u8p, c_int, c_int]
        lib.asr_execute.restype = None
        lib.asr_render_labels.argtypes = [u8p, f32p, f32p, c_int, c_int, f32p, f32p, f32p, f32p, c_int]
        lib.asr_render_labels.restype = None
        _lib = lib
        return lib


def execute_draw_buffer(
    image: np.ndarray,  # (H, W, 3) uint8, drawn in place
    types: np.ndarray,  # (N,) int32: 0 glyph, 1 line
    aux: np.ndarray,  # (N,) int32: atlas tile index / line thickness
    inks: np.ndarray,  # (N,) uint8
    geo: np.ndarray,  # (N, 8) float32: quad corners / line ends
    atlas: np.ndarray,  # (T, tile, tile) uint8
) -> None:
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3 or not image.flags.c_contiguous:
        raise ValueError(f"image must be a C-contiguous (H, W, 3) uint8 array, got {image.dtype} {image.shape}")
    n = len(types)
    if not (len(aux) == len(inks) == len(geo) == n) or np.shape(geo)[1:] != (8,):
        raise ValueError("types, aux, inks and geo must describe the same commands")
    if atlas.ndim != 3 or atlas.shape[1] != atlas.shape[2]:
        raise ValueError(f"atlas must be (T, tile, tile), got {atlas.shape}")
    if n == 0:
        return
    lib = load_library()
    h, w = image.shape[:2]
    lib.asr_execute(
        image, h, w,
        np.ascontiguousarray(types, np.int32),
        np.ascontiguousarray(aux, np.int32),
        np.ascontiguousarray(inks, np.uint8),
        np.ascontiguousarray(geo, np.float32),
        n,
        np.ascontiguousarray(atlas, np.uint8),
        atlas.shape[0],
        atlas.shape[1],
    )


def render_labels_native(
    shape: tuple,
    quads: np.ndarray,  # (N, 4, 2) float32, downsampled-crop coords
    heights: np.ndarray,  # (N,) float32
    centers: np.ndarray,  # (N, 2) float32 (cx, cy)
    sigmas: np.ndarray,  # (N,) float32
):
    """(mask uint8, height map f32, gaussian f32), each of ``shape``."""
    h, w = shape
    mask = np.zeros((h, w), np.uint8)
    height_map = np.zeros((h, w), np.float32)
    gaussian = np.zeros((h, w), np.float32)
    n = len(quads)
    if not (len(heights) == len(centers) == len(sigmas) == n):
        raise ValueError("quads, heights, centers and sigmas must describe the same chars")
    if n:
        load_library().asr_render_labels(
            mask, height_map, gaussian, h, w,
            np.ascontiguousarray(np.reshape(quads, (n, 8)), np.float32),
            np.ascontiguousarray(heights, np.float32),
            np.ascontiguousarray(centers, np.float32),
            np.ascontiguousarray(sigmas, np.float32),
            n,
        )
    return mask, height_map, gaussian


def available() -> bool:
    """True when the library loads (building it if needed); a build that
    fails raises instead of answering False."""
    return load_library() is not None
