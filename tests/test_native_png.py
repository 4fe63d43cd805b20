"""Native C++ PNG encoder (native/png_writer.cpp + utils/native.py).

The save path must be pixel-exact against PIL's decoder: PNG is lossless, so
whatever either encoder writes — the native one or the standard-library one in
utils/image.py — PIL must read back bit-identically. These tests also pin the
save_png dispatch (native preferred, standard-library fallback)."""
import io
import os

import numpy as np
import pytest

from python_ray_tracer_jax.utils import image, native


requires_native = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no compiler)")


@requires_native
@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (33, 64), (128, 200)])
def test_native_png_roundtrip(tmp_path, shape):
    from PIL import Image

    h, w = shape
    rng = np.random.default_rng(42)
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    path = str(tmp_path / "out.png")
    native.write_png(path, img)
    back = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(back, img)


@requires_native
def test_native_encode_bytes_matches_file(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(20, 31, 3), dtype=np.uint8)
    data = native.encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(back, img)


@requires_native
def test_native_png_smooth_image_and_levels(tmp_path):
    """Rendered-image-like gradient: exercises the Sub filter's intended case
    and checks compression levels change size but never pixels."""
    from PIL import Image

    y = np.linspace(0, 255, 90, dtype=np.uint8)[:, None]
    x = np.linspace(0, 255, 120, dtype=np.uint8)[None, :]
    img = np.stack([y + 0 * x, 0 * y + x, (y // 2 + x // 2)], axis=-1)
    img = img.astype(np.uint8)
    sizes = {}
    for level in (1, 6, 9):
        data = native.encode_png(img, level=level)
        sizes[level] = len(data)
        back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(back, img)
    assert sizes[9] <= sizes[1]
    # Sub filtering should beat raw size comfortably on a smooth gradient
    assert sizes[6] < img.nbytes // 4


@requires_native
def test_save_png_native_matches_pil_route(tmp_path, monkeypatch):
    """save_png writes the same pixels through either backend (reference
    output contract: viewer/image.py:7-19 orientation included)."""
    from PIL import Image

    rng = np.random.default_rng(7)
    fb = rng.integers(0, 256, size=(3, 24, 17), dtype=np.uint8)  # (3, w, h)
    p_native = str(tmp_path / "native.png")
    p_pil = str(tmp_path / "pil.png")
    image.save_png(fb, p_native)
    monkeypatch.setattr(native, "available", lambda: False)
    image.save_png(fb, p_pil)
    a = np.asarray(Image.open(p_native).convert("RGB"))
    b = np.asarray(Image.open(p_pil).convert("RGB"))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (17, 24, 3)  # display orientation (h, w, 3)


def test_save_png_pil_fallback(tmp_path, monkeypatch):
    """Without the native library, save_png still works — through the
    standard-library encoder, not Pillow."""
    import sys
    from PIL import Image

    monkeypatch.setattr(native, "available", lambda: False)
    fb = np.zeros((3, 8, 6), dtype=np.uint8)
    fb[0] = 255
    path = str(tmp_path / "fallback.png")
    monkeypatch.setitem(sys.modules, "PIL", None)   # Pillow unavailable
    image.save_png(fb, path)
    monkeypatch.delitem(sys.modules, "PIL")
    back = np.asarray(Image.open(path).convert("RGB"))
    assert back.shape == (6, 8, 3)
    np.testing.assert_array_equal(back[..., 0], 255)
    np.testing.assert_array_equal(back[..., 1:], 0)


@requires_native
def test_native_rejects_bad_shapes():
    with pytest.raises(ValueError):
        native.write_png("/tmp/x.png", np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        native.encode_png(np.zeros((4, 4, 4), np.uint8))


@requires_native
def test_native_write_io_error(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(RuntimeError):
        native.write_png(str(tmp_path / "no_dir" / "x.png"), img)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (33, 64), (128, 200)])
def test_stdlib_png_roundtrip(shape):
    """utils.image.encode_png (zlib only) decodes bit-identically in PIL."""
    from PIL import Image

    h, w = shape
    img = np.random.default_rng(3).integers(0, 256, size=(h, w, 3),
                                            dtype=np.uint8)
    data = image.encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(back, img)


def test_stdlib_png_levels_and_shapes():
    y = np.linspace(0, 255, 90, dtype=np.uint8)[:, None]
    x = np.linspace(0, 255, 120, dtype=np.uint8)[None, :]
    img = np.stack([y + 0 * x, 0 * y + x, (y // 2 + x // 2)], axis=-1)
    img = img.astype(np.uint8)
    assert len(image.encode_png(img, level=9)) <= len(image.encode_png(img,
                                                                      level=1))
    with pytest.raises(ValueError):
        image.encode_png(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        image.encode_png(np.zeros((4, 4, 4), np.uint8))
