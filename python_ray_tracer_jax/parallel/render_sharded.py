"""Multi-chip rendering and render-to-loss via ``shard_map`` over a device mesh.

Design (SURVEY §7 step 6): the image's width axis is sharded across the ``"rays"``
mesh axis; the scene/camera pytrees are replicated. Because ray generation is
*analytic* (models/camera.py), each shard synthesizes its own rays — including the AA
half-offset samples that straddle shard boundaries — so the forward pass needs **zero
communication**: no halo exchange, no gather. The only collective in the whole
pipeline is the ``psum`` of scene-parameter gradients (and the scalar loss), which
``shard_map``'s transpose inserts automatically for replicated inputs and XLA hands
to NCCL on GPUs.

There is no reference analogue (single GPU, SURVEY §5).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.render import _render_block
from .mesh import RAY_AXIS


def _shard_rows(w: int, mesh: Mesh, axis: str):
    n = mesh.shape[axis]
    assert w % n == 0, f"width {w} must be divisible by mesh axis size {n}"
    return w // n


@partial(jax.jit, static_argnames=("resolution", "mesh", "depth", "aliasing",
                                   "compat", "axis", "backend",
                                   "pallas_interpret"))
def _render_sharded_impl(scene, camera, *, resolution, mesh, depth, aliasing,
                         compat, axis, backend, pallas_interpret):
    w, h = resolution
    rows_per = _shard_rows(w, mesh, axis)
    ys = jnp.arange(h, dtype=jnp.float32)

    if backend == "pallas":
        from ..ops.pallas.render_pallas import render_image_pallas

        def shard_fn(scene, camera):
            i = jax.lax.axis_index(axis)
            x0 = (i * rows_per).astype(jnp.float32)
            return render_image_pallas(camera, scene, depth=depth,
                                       aliasing=aliasing, compat=compat,
                                       x_offset=x0, local_width=rows_per,
                                       interpret=pallas_interpret)
    else:
        def shard_fn(scene, camera):
            i = jax.lax.axis_index(axis)
            xs = jnp.arange(rows_per, dtype=jnp.float32) + i * rows_per
            return _render_block(xs, ys, camera, scene,
                                 depth=depth, aliasing=aliasing, compat=compat)

    fn = shard_map(shard_fn, mesh=mesh, in_specs=(P(), P()),
                   out_specs=P(axis, None, None), check_vma=False)
    return fn(scene, camera)


def render_image_sharded(camera, scene, mesh: Mesh, *, depth: int = 2,
                         aliasing: bool = True, compat: bool = True,
                         axis: str = RAY_AXIS, backend: str = "jnp",
                         pallas_interpret: bool = False) -> jnp.ndarray:
    """Distributed render -> ``(w, h, 3)`` float image sharded over ``axis``.

    Each device renders a contiguous block of image columns (x rows in the
    reference's (w, h) indexing). Communication-free; the result stays sharded so a
    downstream loss can reduce it without a gather. ``backend="pallas"`` runs the
    fused GPU kernel on each shard's global column slice (``pallas_interpret``
    runs it in the Pallas interpreter instead); ``"jnp"`` the XLA-fused
    differentiable path. Jitted and cached per (mesh, resolution, flags) —
    repeated calls don't re-trace.
    """
    return _render_sharded_impl(scene, camera, resolution=camera.resolution,
                                mesh=mesh, depth=depth, aliasing=aliasing,
                                compat=compat, axis=axis, backend=backend,
                                pallas_interpret=pallas_interpret)


def make_loss_fn(camera, target, mesh: Mesh, *, depth: int = 2, aliasing: bool = True,
                 compat: bool = True, axis: str = RAY_AXIS, soft: bool = False,
                 tau: float = 0.05):
    """Build ``loss(scene) -> scalar`` where the pixel loss is computed shard-local
    and ``psum``-reduced across the mesh; its gradient w.r.t. the replicated scene is
    all-reduced by the shard_map transpose (overlapping backward compute with the
    collective is XLA's job once both live in one jitted computation).

    ``soft=True`` renders each shard with the soft-visibility renderer
    (ops/soft.py) — distributed silhouette-aware inverse rendering; the target
    should come from the same renderer at the same ``tau``.
    """
    w, h = camera.resolution
    rows_per = _shard_rows(w, mesh, axis)
    ys = jnp.arange(h, dtype=jnp.float32)
    denom = jnp.float32(w * h * 3)

    def shard_fn(scene, target_shard):
        i = jax.lax.axis_index(axis)
        xs = jnp.arange(rows_per, dtype=jnp.float32) + i * rows_per
        if soft:
            from ..ops.soft import render_rays_soft
            gx = xs[:, None] * jnp.ones_like(ys)[None, :]
            gy = jnp.ones_like(xs)[:, None] * ys[None, :]
            pix = jnp.stack([gx, gy], axis=-1)
            d = camera.ray_directions(pix, compat=False)
            o = jnp.broadcast_to(camera.ray_origin(), d.shape)
            img = render_rays_soft(o, d, scene, tau=tau)
        else:
            img = _render_block(xs, ys, camera, scene,
                                depth=depth, aliasing=aliasing, compat=compat)
        err = jnp.sum((img - target_shard) ** 2) / denom
        return jax.lax.psum(err, axis)

    sharded = shard_map(shard_fn, mesh=mesh, in_specs=(P(), P(axis, None, None)),
                        out_specs=P(), check_vma=False)

    def loss(scene):
        return sharded(scene, target)

    return loss
