"""Device mesh construction for ray data parallelism.

The reference's only parallelism is the intra-device CUDA grid (one thread per pixel,
main.py:35-38). This framework extends the same axis — pixels/rays — across devices:
a 1-D ``Mesh`` over all devices with axis name ``"rays"``, sharding the image's width
dimension. Scene and camera are tiny and replicated (SURVEY §2, parallelism
inventory). Multi-host runs reuse the same mesh: ``jax.devices()`` spans hosts after
``jax.distributed.initialize`` (see :mod:`.distributed`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = RAY_AXIS) -> Mesh:
    """1-D mesh over all (or given) devices, in the order given.

    The cards of one host are joined all to all by NVLink, so device order does
    not change the cost of the mesh's collectives."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (axis_name,))


def image_sharding(mesh: Mesh, axis_name: str = RAY_AXIS) -> NamedSharding:
    """Sharding for a ``(w, h, 3)`` image: width split across the ray axis."""
    return NamedSharding(mesh, P(axis_name, None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
