"""Image-level rendering pipeline: analytic ray-gen, 3x3 supersampling, framebuffer.

Reference parity (kernels.py:6-73) with a vectorized structure: instead of one CUDA
thread per pixel gathering neighbor pixel locations from a device array, the 9 AA
sample directions are computed *analytically* as half-pixel offsets in index space
(the reference's ``linear_comb(P, P_neighbor, .5, .5)`` midpoints, kernels.py:43-50,
are exactly half-index steps on its linear pixel grid). This removes the neighbor
gather entirely — which is what later lets the sharded renderer run with zero halo
exchange.

Compat quirks reproduced (see SURVEY §2 comp. 8, 11):
  * AA accumulation swaps G/B of the neighbor samples (``G += B_s; B += G_s``,
    kernels.py:59-60);
  * ``clip_color_vector`` swaps G/B *again* on store (common.py:61-63);
  * net effect: ``out = (R_p+R_n, B_p+G_n, G_p+B_n)/9`` on interior pixels and
    ``(R_p, B_p, G_p)`` on the border;
  * border pixels take a single center sample (kernels.py:29);
  * rounding is round-half-to-even (Python ``round`` under numba, common.py:57 —
    ``jnp.round`` matches).

Known divergence from the reference (documented, not reproduced): the reference's
bounds tests use ``<=`` (kernels.py:13, 29), so threads at ``x == w-1`` read the
out-of-bounds pixel column ``x+1 == w`` — undefined garbage on real CUDA hardware and
an IndexError in the CUDA simulator. We treat the outermost ring as border pixels
(single sample), the only well-defined interpretation.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .shade import sample

# 8 neighbor half-offsets in (x, y) pixel-index space (kernels.py:32-50):
# left, right, top, bottom, then the four corners.
_AA_OFFSETS = (
    (-0.5, 0.0), (0.5, 0.0), (0.0, 0.5), (0.0, -0.5),
    (-0.5, 0.5), (0.5, 0.5), (-0.5, -0.5), (0.5, -0.5),
)


def render_rays(pixel_xy, camera, scene, *, depth: int, compat: bool = True):
    """Shade a batch of fractional pixel coordinates ``(..., 2)`` -> rgb ``(..., 3)``."""
    d = camera.ray_directions(pixel_xy, compat=compat)
    o = jnp.broadcast_to(camera.ray_origin(), d.shape)
    return sample(o, d, scene, depth=depth, compat=compat)


def _render_block(xs, ys, camera, scene, *, depth, aliasing, compat):
    """Render the pixel block spanned by index vectors ``xs (W,)`` x ``ys (H,)``.

    Returns a float ``(W, H, 3)`` image in [0, ~1] scale, with the compat channel
    semantics applied but *before* 0-255 quantization (that happens in
    :func:`to_framebuffer` so the float image stays differentiable).
    """
    w_total, h_total = camera.resolution
    gx = xs[:, None] * jnp.ones_like(ys)[None, :]
    gy = jnp.ones_like(xs)[:, None] * ys[None, :]
    center = jnp.stack([gx, gy], axis=-1)                      # (W, H, 2)

    primary = render_rays(center, camera, scene, depth=depth, compat=compat)

    if not aliasing:
        if compat:
            # Store-time G/B swap (common.py:61-63) with no AA to undo it.
            return primary[..., jnp.asarray([0, 2, 1])]
        return primary

    acc = jnp.zeros_like(primary)
    for ox, oy in _AA_OFFSETS:
        off = jnp.asarray([ox, oy], primary.dtype)
        acc = acc + render_rays(center + off, camera, scene, depth=depth, compat=compat)

    interior = ((gx >= 1.0) & (gx <= w_total - 2) &
                (gy >= 1.0) & (gy <= h_total - 2))[..., None]
    if compat:
        pr, pg, pb = primary[..., 0], primary[..., 1], primary[..., 2]
        nr, ng, nb = acc[..., 0], acc[..., 1], acc[..., 2]
        # Accumulation swap + store swap composed (see module docstring).
        aa = jnp.stack([pr + nr, pb + ng, pg + nb], axis=-1) / 9.0
        border = jnp.stack([pr, pb, pg], axis=-1)
        return jnp.where(interior, aa, border)
    aa = (primary + acc) / 9.0
    return jnp.where(interior, aa, primary)


@partial(jax.jit, static_argnames=("depth", "aliasing", "compat", "row_chunk"))
def render_image(camera, scene, *, depth: int = 2, aliasing: bool = True,
                 compat: bool = True, row_chunk: int | None = None) -> jnp.ndarray:
    """Render the full image -> float ``(w, h, 3)`` in [0, ~1] scale.

    ``row_chunk`` optionally scans over row blocks with rematerialization
    (``jax.checkpoint``) to bound peak memory for large images — the backward pass
    recomputes each block instead of keeping all AA/bounce residuals live.
    """
    w, h = camera.resolution
    ys = jnp.arange(h, dtype=jnp.float32)

    def block(xs):
        return _render_block(xs, ys, camera, scene,
                             depth=depth, aliasing=aliasing, compat=compat)

    if row_chunk is None or row_chunk >= w:
        return block(jnp.arange(w, dtype=jnp.float32))
    assert w % row_chunk == 0, f"width {w} not divisible by row_chunk {row_chunk}"
    xs_blocks = jnp.arange(w, dtype=jnp.float32).reshape(w // row_chunk, row_chunk)
    out = jax.lax.map(jax.checkpoint(block), xs_blocks)
    return out.reshape(w, h, 3)


def to_framebuffer(img: jnp.ndarray) -> jnp.ndarray:
    """Quantize a float [0,1]-scale image to the reference's uint8 ``(3, w, h)``
    framebuffer: scale to 0-255, round half-to-even, clamp (common.py:52-57)."""
    x = jnp.clip(jnp.round(img * 255.0), 0.0, 255.0).astype(jnp.uint8)
    return jnp.moveaxis(x, -1, 0)
