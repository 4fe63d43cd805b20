"""Framebuffer -> PNG viewer, matching the reference's output orientation.

The reference viewer (viewer/image.py:7-19) transposes the uint8 ``(3, w, h)``
framebuffer to ``(w, h, 3)``, then applies ``ImageOps.mirror(im.rotate(270))`` to fix
its axis convention. We reproduce the exact same pixel arrangement with pure numpy
(verified against the PIL composition in tests), so saving does not depend on PIL's
rotation resampling behavior.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def framebuffer_to_array(fb: np.ndarray) -> np.ndarray:
    """uint8 ``(3, w, h)`` framebuffer -> display-oriented ``(h, w, 3)`` array.

    Derivation: let ``A[x, y, c] = fb[c, x, y]``. PIL ``rotate(270)`` (90° clockwise)
    maps ``B[i, j] = A[n-1-j, i]``; ``mirror`` (left-right flip) then gives
    ``C[i, j] = B[i, m-1-j] = A[j, i]`` after simplification over the w x h extents —
    i.e. the net transform is a pure transpose of the first two axes.
    """
    fb = np.asarray(fb)
    a = np.moveaxis(fb, 0, -1)  # (w, h, 3)
    return np.transpose(a, (1, 0, 2))  # (h, w, 3)


def encode_png(img: np.ndarray, *, level: int = 6) -> bytes:
    """Encode an ``(h, w, 3)`` uint8 RGB array as PNG bytes with the standard
    library alone (8-bit truecolour, no interlace, filter 0 on every row)."""
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (h, w, 3) RGB8 array, got {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)],
                          axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)) +
            chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) +
            chunk(b"IEND", b""))


def save_png(fb: np.ndarray, path: str) -> None:
    """Save a uint8 ``(3, w, h)`` framebuffer as a PNG (reference main.py:51-53).

    Encoding goes through the native C++ encoder (native/png_writer.cpp via
    utils/native.py) when it builds, and through :func:`encode_png` otherwise,
    so saving needs neither Pillow nor a compiler. Pixel-exact equivalence of
    the two routes is pinned by tests/test_native_png.py.
    """
    arr = framebuffer_to_array(fb).astype(np.uint8)
    from . import native

    if native.available():
        native.write_png(path, arr)
        return
    with open(path, "wb") as f:
        f.write(encode_png(arr))
