"""ctypes loader for the native runtime library (native/png_writer.cpp).

The reference's viewer depends on Pillow for all output (reference
viewer/image.py:7-19, requirements.txt:4). This framework's output layer is
native C++ instead: a zlib-backed PNG encoder built as ``librt_native.so``
and called through ctypes — no third-party Python imaging dependency on the
save path (utils/image.encode_png, a standard-library encoder, is the fallback;
PIL remains only as the decode oracle in tests).

The library is built on demand from the repo's ``native/`` directory the
first time it is needed (a few hundred ms with g++ -O2); the artifact is
cached at ``native/build/librt_native.so``. Environments without a compiler
or without the source tree simply report ``available() -> False`` and
callers fall back to utils/image.encode_png.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ABI_VERSION = 1

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def _native_dir() -> str | None:
    """Locate the ``native/`` source dir (repo layout: package sits beside it)."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    d = os.path.join(pkg_root, "native")
    return d if os.path.isfile(os.path.join(d, "png_writer.cpp")) else None


def _build(native_dir: str) -> str | None:
    so = os.path.join(native_dir, "build", "librt_native.so")
    src = os.path.join(native_dir, "png_writer.cpp")
    makefile = os.path.join(native_dir, "Makefile")

    def fresh() -> bool:
        # Staleness covers the Makefile too: a flag change must rebuild.
        try:
            deps = [os.path.getmtime(src)]
            if os.path.isfile(makefile):
                deps.append(os.path.getmtime(makefile))
            return os.path.isfile(so) and os.path.getmtime(so) >= max(deps)
        except OSError:
            return False

    if fresh():
        return so
    # Serialize concurrent builders (parallel pytest workers / processes):
    # an exclusive flock around `make` prevents two `make` runs racing on the
    # same output file; whoever waited re-checks freshness and skips.
    try:
        os.makedirs(os.path.join(native_dir, "build"), exist_ok=True)
        with open(os.path.join(native_dir, "build", ".lock"), "w") as lockf:
            try:
                import fcntl
                fcntl.flock(lockf, fcntl.LOCK_EX)
            except ImportError:  # non-POSIX: fall back to unlocked build
                pass
            if not fresh():
                subprocess.run(["make", "-C", native_dir, "-s"], check=True,
                               capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    return so if os.path.isfile(so) else None


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        override = os.environ.get("RT_NATIVE_LIB")
        native_dir = _native_dir()
        so = override or (_build(native_dir) if native_dir else None)
        if not so or not os.path.isfile(so):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.rt_native_abi_version.restype = ctypes.c_int
            if lib.rt_native_abi_version() != _ABI_VERSION:
                raise OSError(f"librt_native ABI mismatch at {so}")
            lib.rt_write_png.restype = ctypes.c_int
            lib.rt_write_png.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int64, ctypes.c_int32]
            lib.rt_encode_png.restype = ctypes.c_int
            lib.rt_encode_png.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.rt_free.argtypes = [ctypes.c_void_p]
        except OSError:
            _load_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is present (building it if necessary)."""
    return _load() is not None


def write_png(path: str, img: np.ndarray, *, level: int = 6) -> None:
    """Write an ``(h, w, 3)`` uint8 RGB array as a PNG via the native encoder.

    Raises ``RuntimeError`` if the library is unavailable or encoding fails —
    callers that want graceful degradation check :func:`available` first
    (``utils.image.save_png`` does, falling back to ``encode_png``).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native PNG encoder unavailable (no compiler or "
                           "source tree); use utils.image.encode_png")
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (h, w, 3) RGB8 array, got {arr.shape}")
    h, w = arr.shape[0], arr.shape[1]
    rc = lib.rt_write_png(path.encode(), arr.ctypes.data, w, h,
                          arr.strides[0], level)
    if rc != 0:
        raise RuntimeError(f"rt_write_png failed with code {rc} for {path}")


def encode_png(img: np.ndarray, *, level: int = 6) -> bytes:
    """Encode an ``(h, w, 3)`` uint8 RGB array to PNG bytes (native encoder)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native PNG encoder unavailable")
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (h, w, 3) RGB8 array, got {arr.shape}")
    h, w = arr.shape[0], arr.shape[1]
    out = ctypes.c_void_p()
    out_len = ctypes.c_size_t()
    rc = lib.rt_encode_png(arr.ctypes.data, w, h, arr.strides[0], level,
                           ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"rt_encode_png failed with code {rc}")
    try:
        return ctypes.string_at(out.value, out_len.value)
    finally:
        lib.rt_free(out)
