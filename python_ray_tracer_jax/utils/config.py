"""Render configuration.

The reference has no config system — every knob is a hard-coded local in its driver
(main.py:10-12: ``w, h``, ``amb, lamb, refl, refl_depth``, ``aliasing``; camera pose
main.py:24; fov camera.py:8). This dataclass is that implicit config surface made
explicit, plus the knobs the reference lacks (compat mode, backend selection,
row chunking, the clean-mode specular term).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


@dataclasses.dataclass
class RenderConfig:
    width: int = 1000
    height: int = 1000
    ambient: float = 0.0
    lambert: float = 0.6
    reflection: float = 0.3
    depth: int = 2
    aliasing: bool = True
    fov: float = 45.0
    camera_position: Tuple[float, float, float] = (-2.0, 0.0, 2.0)
    camera_euler: Tuple[float, float, float] = (0.0, -30.0, 0.0)
    # Knobs with no reference analogue:
    compat: bool = True            # reproduce reference quirks bit-for-bit
    # "auto" resolves per device: the fused kernel on a GPU, the XLA-fused jnp
    # path elsewhere (interpret mode is a test facility, not a CPU backend).
    # See resolve_backend.
    backend: str = "auto"          # "auto" | "jnp" | "pallas"
    row_chunk: Optional[int] = None
    specular: float = 0.0          # Phong highlight (clean mode only)
    shininess: float = 32.0

    @staticmethod
    def reference_defaults() -> "RenderConfig":
        """The reference driver's exact settings (main.py:10-12, 24)."""
        return RenderConfig()


def resolve_backend(backend: str) -> str:
    """Resolve ``"auto"`` to the fastest backend for the attached device.

    On a GPU that is the fused per-pixel kernel (ops/pallas/render_pallas.py),
    which outruns XLA's build of the jnp path at every measured shape (see
    PERF.md); elsewhere the jnp/XLA path is the only one that runs.
    ``"pallas"`` on a machine without a GPU raises ``RuntimeError``. Explicit
    ``"jnp"`` passes through.
    """
    import jax

    platform = jax.default_backend()
    if backend == "auto":
        return "pallas" if platform == "gpu" else "jnp"
    if backend == "pallas" and platform != "gpu":
        raise RuntimeError(
            f"backend 'pallas' needs a GPU, and JAX's default backend is "
            f"{platform!r}; use --backend jnp or auto")
    return backend


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing. Otherwise the cache goes to ``.jax_cache/`` at the checkout
    root: a fixed path, because the path is part of the cache key.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    return _CACHE_DIR
