"""Headless canvas: a stdlib-only PNG encoder.

The port's own copy of ``astarpa_tpu/vis/canvas.py`` (the code kept
identical).  Equivalent role to the reference's `Canvas` trait + SDL2/BMP
backends (`pa-vis/src/canvas.rs`, `sdl.rs`): frames go straight to PNG
files (zlib + hand-rolled chunks, no image deps).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def png_bytes(rgb: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 array as a PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    assert c == 3
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path, rgb: np.ndarray) -> None:
    Path(path).write_bytes(png_bytes(rgb))
