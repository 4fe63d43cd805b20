"""Differentiable shading core: closest-hit shading, shadows, Lambert, Phong, bounces.

A vectorized re-design of the reference's scalar recursion (reference trace.py:45-133):
every function is vectorized over an arbitrary ray batch, discrete decisions (hit/miss,
shadow, back-facing light) are boolean masks combined with ``jnp.where``, and the
"recursive" mirror reflection is a fixed-depth unrolled loop carrying
``(rgb, origin, direction, alive)`` — the 404.0 sentinel triples of the reference
(trace.py:56-57, 124-126) become a single ``alive`` mask.

Shading model parity (SURVEY §2 comp. 9): ambient + Lambert + hard shadows + recursive
mirror reflection; *no* specular in compat mode. Clean mode adds a Phong specular
highlight (gated on ``materials.specular``) for BASELINE configs[2].
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .intersect import closest_hit, any_hit

# np.float32, not jnp.float32: no backend init at import (see ops/intersect.py)
BIAS = np.float32(2e-4)  # shadow/mirror acne offset, reference trace.py:82


def _normalize(v, axis=-1):
    n2 = jnp.sum(v * v, axis=axis, keepdims=True)
    n = jnp.sqrt(jnp.where(n2 > 0, n2, 1.0))
    return v / n


def reflect(d, n):
    """Unit mirror reflection of direction ``d`` about unit normal ``n``
    (reference common.py:114-120, which also renormalizes)."""
    return _normalize(d - 2.0 * jnp.sum(d * n, axis=-1, keepdims=True) * n)


class TraceState(NamedTuple):
    rgb: jnp.ndarray        # (..., 3) accumulated color of this trace, [0,1] scale
    point: jnp.ndarray      # (..., 3) biased hit point (next bounce origin)
    direction: jnp.ndarray  # (..., 3) unit reflection direction
    alive: jnp.ndarray      # (...,)   ray hit something this trace


def _surface_attributes(P, hits, scene):
    """Gather albedo and unit normal of the hit object for every ray.

    Replaces the reference's obj_type branch (trace.py:63-71) with masked gathers over
    the concatenated [spheres ++ planes] object axis.
    """
    n_sph = scene.spheres.count
    n_pln = scene.planes.count
    obj = hits["obj"]
    is_plane = hits["is_plane"]
    if n_sph and n_pln:
        albedo_all = jnp.concatenate([scene.spheres.albedo, scene.planes.albedo], axis=0)
        albedo = albedo_all[obj]
        cen = scene.spheres.center[jnp.minimum(obj, n_sph - 1)]
        n_sphere = _normalize(P - cen)
        n_plane = scene.planes.normal[jnp.clip(obj - n_sph, 0, n_pln - 1)]
        normal = jnp.where(is_plane[..., None], n_plane, n_sphere)
    elif n_sph:
        albedo = scene.spheres.albedo[obj]
        normal = _normalize(P - scene.spheres.center[obj])
    else:
        albedo = scene.planes.albedo[obj]
        normal = scene.planes.normal[obj]
    return albedo, normal


def trace_once(ray_o, ray_d, scene, *, compat: bool = True) -> TraceState:
    """One shading evaluation (reference ``trace``, trace.py:45-112), batched.

    Returns a :class:`TraceState`; dead lanes carry zero rgb and unspecified
    point/direction (masked out by the caller via ``alive``).
    """
    if scene.spheres.count == 0 and scene.planes.count == 0:
        shape = jnp.broadcast_shapes(ray_o.shape, ray_d.shape)
        z = jnp.zeros(shape, ray_d.dtype)
        return TraceState(rgb=z, point=jnp.broadcast_to(ray_o, shape),
                          direction=jnp.broadcast_to(ray_d, shape),
                          alive=jnp.zeros(shape[:-1], bool))
    m = scene.materials
    hits = closest_hit(ray_o, ray_d, scene, compat=compat)
    alive = hits["hit"]
    t = hits["t"]
    P = ray_o + jnp.where(alive, t, 0.0)[..., None] * ray_d
    albedo, N = _surface_attributes(P, hits, scene)

    # Ambient term (trace.py:77).
    rgb = m.ambient * albedo

    # Shadow rays + Lambert, per light (trace.py:79-102). P is biased along the
    # normal first (trace.py:82-83).
    Pb = P + BIAS * N
    if scene.lights.count:
        L = _normalize(scene.lights.position - Pb[..., None, :])      # (..., L, 3)
        occluded = any_hit(Pb[..., None, :], L, scene, compat=compat)  # (..., L)
        lam = m.lambert * jnp.sum(L * N[..., None, :], axis=-1)        # (..., L)
        lam = jnp.where(~occluded & (lam > 0.0), lam, 0.0)
        rgb = rgb + jnp.sum(lam, axis=-1)[..., None] * albedo
        if not compat:
            # Phong specular highlight (clean-mode extension; the reference has no
            # specular term — SURVEY §2 comp. 9). White highlight, shadow-masked.
            # pow via double-where masked exp/log so autodiff w.r.t. shininess is
            # NaN-free on masked lanes (0**s * log(0) would poison the grad).
            R = reflect(ray_d, N)
            spec = jnp.sum(L * R[..., None, :], axis=-1)
            smask = ~occluded & (spec > 0.0)
            s_safe = jnp.where(smask, spec, 1.0)
            p = jnp.where(smask, jnp.exp(m.shininess * jnp.log(s_safe)), 0.0)
            phong = m.specular * jnp.sum(p, axis=-1)
            rgb = rgb + phong[..., None]

    # Mirror reflection direction + acne bias along it (trace.py:104-110).
    R = reflect(ray_d, N)
    Pb = Pb + BIAS * R

    rgb = jnp.where(alive[..., None], rgb, 0.0)
    return TraceState(rgb=rgb, point=Pb, direction=R, alive=alive)


def sample(ray_o, ray_d, scene, *, depth: int, compat: bool = True) -> jnp.ndarray:
    """Primary trace + ``depth`` mirror bounces (reference ``sample``, trace.py:115-133).

    Bounce ``i`` contributes ``reflection**(i+1) * rgb_i``, gated on the *previous*
    trace having hit (the reference's sentinel ``continue``). ``depth`` is static, so
    the loop unrolls at trace time — no data-dependent control flow under ``jit``.
    """
    refl = scene.materials.reflection
    st = trace_once(ray_o, ray_d, scene, compat=compat)
    rgb = st.rgb
    for i in range(depth):
        prev_alive = st.alive
        st = trace_once(st.point, st.direction, scene, compat=compat)
        w = (refl ** (i + 1)) * prev_alive.astype(rgb.dtype)
        rgb = rgb + w[..., None] * st.rgb
        # Once dead, stay dead (sentinels never reset in the reference loop).
        st = st._replace(alive=st.alive & prev_alive)
    return rgb
