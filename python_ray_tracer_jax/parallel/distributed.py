"""Multi-host initialization and framebuffer assembly.

The reference is single-process/single-GPU: its "communication backend" is
``cuda.to_device``/``copy_to_host`` (reference src/main.py:19-32,51 — SURVEY §5).
Across devices the analogue is two-stage: process startup rendezvous over the
network (``jax.distributed.initialize``), then framebuffer assembly as an XLA
``all_gather`` over the ray-DP mesh — NCCL carries it over NVLink between the
cards of a host and over the network between hosts — and afterwards every process
holds the full image addressably (PNG writing is then a host-0 concern, the
``copy_to_host`` analogue).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .mesh import RAY_AXIS


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX. No-op when single-process (the common dev case)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes, process_id=process_id)


@partial(jax.jit, static_argnames=("mesh", "axis"))
def _all_gather_image(image, *, mesh: Mesh, axis: str):
    """Replicate a width-sharded ``(w, h, 3)`` image across the mesh.

    No buffer donation: gather_framebuffer reads as a pure assembly step, so
    the caller's sharded framebuffer must stay alive (donating it makes any
    later use of the input raise "Array has been deleted").

    One tiled ``all_gather`` over the mesh axis: each device contributes its
    column block and receives everyone else's. XLA hands the collective to NCCL
    — no host-side scatter/gather code anywhere.
    """
    def shard_fn(shard):
        return jax.lax.all_gather(shard, axis, axis=0, tiled=True)

    fn = shard_map(shard_fn, mesh=mesh, in_specs=P(axis, None, None),
                   out_specs=P(), check_vma=False)
    return fn(image)


def gather_framebuffer(image, mesh: Optional[Mesh] = None,
                       axis: str = RAY_AXIS) -> np.ndarray:
    """Assemble a (possibly sharded / multi-host) device image on this host.

    Three cases, fastest first:

    * already replicated / single-device: plain device-to-host copy;
    * sharded over ``mesh`` (pass the mesh used to render): a jitted tiled
      ``all_gather`` replicates the framebuffer across every device/host, then
      the local copy is fetched — the production multi-chip/multi-host path;
    * sharded but no mesh given: reconstructed via
      ``multihost_utils.process_allgather`` (host-level fallback).
    """
    if not isinstance(image, jax.Array):
        return np.asarray(image)
    sharded = len(image.sharding.device_set) > 1
    if sharded and mesh is not None:
        image = _all_gather_image(image, mesh=mesh, axis=axis)
        return np.asarray(jax.device_get(image.addressable_data(0)))
    if sharded and not image.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(image, tiled=True))
    return np.asarray(jax.device_get(image))
