"""Vectorized, differentiable ray/primitive intersection ("intersection BLAS").

A vectorized re-design of the reference's per-thread sequential closest-hit loop
(reference trace.py:8-41, intersections.py:7-68): distances to *all* objects are
computed as batched broadcasted arithmetic over a ``(..., N_obj)`` axis, and the
closest hit is an ``argmin`` reduction instead of a data-dependent loop. This is the
differentiable reference path; the fused GPU kernel (ops/pallas/render_pallas.py)
runs the reference's per-pixel loop instead. Misses are boolean masks, not the reference's -999.x / 404 sentinels.

Gradient safety: every ``sqrt``/division that is undefined on the miss branch uses the
double-``where`` trick so ``jax.grad`` never sees a NaN from an inactive branch.

Compat semantics reproduced exactly (for parity with the reference):
  * far clip: hits count only if ``0 < t < 999`` (init ``intersect_dist = 999.0``,
    trace.py:17, 26, 36);
  * plane parallel threshold ``|d . n| < 1e-3`` (intersections.py:46, 55);
  * nearest *positive* quadratic root, allowing the far root when the origin is
    inside the sphere (intersections.py:28-38);
  * tie-break: spheres before planes, lower index first (strict ``>`` comparison in
    trace.py:26, 36 means the earlier object keeps the hit) — ``argmin`` returns the
    first occurrence, matching.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# np.float32 (not jnp.float32) scalars: the jnp scalar constructor creates a
# device array, which would initialize the XLA backend at import time and
# break multi-host startup (jax.distributed.initialize must run before any
# backend init — parallel/distributed.py, tests/mp_worker.py).
FAR = np.float32(999.0)  # reference init distance, trace.py:17
BIG = np.float32(1e30)   # internal "no hit" distance


def _safe_div(num, den, eps=1e-30):
    den_safe = jnp.where(jnp.abs(den) > eps, den, jnp.float32(1.0))
    return num / den_safe


def intersect_spheres(ray_o, ray_d, center, radius, *, compat: bool = True):
    """Distances from rays to a batch of spheres.

    Args:
      ray_o: ``(..., 3)`` ray origins.
      ray_d: ``(..., 3)`` unit ray directions.
      center: ``(N, 3)`` sphere centers; radius: ``(N,)``.
      compat: renormalize direction like the reference does internally
        (intersections.py:14) — a no-op up to f32 rounding for already-unit dirs.

    Returns:
      ``(t, valid)``: ``t (..., N)`` distances (``BIG`` where invalid),
      ``valid (..., N)`` boolean hit mask (positive root exists).
    """
    if compat:
        n = jnp.sqrt(jnp.sum(ray_d * ray_d, axis=-1, keepdims=True))
        ray_d = ray_d / n
    # L = o - c, per object: (..., N, 3) via broadcast
    L = ray_o[..., None, :] - center  # (..., N, 3)
    # b/2 = L . d ; c = L.L - r^2 ; a == 1 for unit d (kept general like the reference)
    a = jnp.sum(ray_d * ray_d, axis=-1)[..., None]            # (..., 1)
    b = 2.0 * jnp.sum(L * ray_d[..., None, :], axis=-1)        # (..., N)
    c = jnp.sum(L * L, axis=-1) - radius * radius              # (..., N)
    disc = b * b - 4.0 * a * c
    has_root = disc >= 0.0
    # disc > 0, not has_root: a tangent ray (disc == 0 exactly) would give
    # sqrt'(0) = inf, and inf times the zero cotangent of a sphere that is
    # not the closest hit is NaN. The forward value is the same.
    sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 0.0))
    inv2a = _safe_div(jnp.float32(1.0), 2.0 * a)
    t_near = (-b - sq) * inv2a
    t_far = (-b + sq) * inv2a
    # Nearest positive root (reference intersections.py:28-38: near root if its
    # numerator > 0, else far root if positive, else miss).
    near_pos = (-b - sq) > 0.0
    far_pos = (-b + sq) > 0.0
    t = jnp.where(near_pos, t_near, t_far)
    valid = has_root & (near_pos | far_pos)
    return jnp.where(valid, t, BIG), valid


def intersect_planes(ray_o, ray_d, origin, normal, *, compat: bool = True):
    """Distances from rays to a batch of infinite planes.

    ``origin (M,3)``, unit ``normal (M,3)``. Parallel threshold is the reference's
    1e-3 in compat mode (intersections.py:46), 1e-8 otherwise.

    Returns ``(t, valid)`` with shapes ``(..., M)``.
    """
    eps = jnp.float32(1e-3 if compat else 1e-8)
    denom = jnp.sum(ray_d[..., None, :] * normal, axis=-1)          # (..., M)
    not_parallel = jnp.abs(denom) >= eps
    lp = origin - ray_o[..., None, :]                                # (..., M, 3)
    num = jnp.sum(lp * normal, axis=-1)                              # (..., M)
    # Divide by 1 where the ray counts as parallel: t is masked there anyway,
    # and num/denom**2 in the gradient would overflow to inf for a tiny denom.
    t = num / jnp.where(not_parallel, denom, jnp.float32(1.0))
    valid = not_parallel & (t > 0.0)
    return jnp.where(valid, t, BIG), valid


def closest_hit(ray_o, ray_d, scene, *, compat: bool = True):
    """Closest-hit over the whole scene (reference ``get_intersection`` trace.py:8-41).

    Returns a dict with:
      ``t (...,)`` hit distance; ``hit (...,)`` bool; ``obj (...,)`` int index into the
      concatenated [spheres ++ planes] axis; ``is_plane (...,)`` bool.
    """
    batch = jnp.broadcast_shapes(ray_o.shape[:-1], ray_d.shape[:-1])
    if scene.spheres.count == 0 and scene.planes.count == 0:
        zi = jnp.zeros(batch, jnp.int32)
        return dict(t=jnp.full(batch, BIG), hit=jnp.zeros(batch, bool),
                    obj=zi, is_plane=jnp.zeros(batch, bool))
    ts, vs = intersect_spheres(ray_o, ray_d, scene.spheres.center,
                               scene.spheres.radius, compat=compat)
    tp, vp = intersect_planes(ray_o, ray_d, scene.planes.origin,
                              scene.planes.normal, compat=compat)
    t_all = jnp.concatenate([ts, tp], axis=-1)
    if compat:
        # Far-clip quirk: a hit at t >= 999.0 is treated as a miss (trace.py:17,26).
        t_all = jnp.where(t_all < FAR, t_all, BIG)
    n_sph = ts.shape[-1]
    obj = jnp.argmin(t_all, axis=-1)
    t = jnp.min(t_all, axis=-1)
    hit = t < BIG
    return dict(t=t, hit=hit, obj=obj, is_plane=obj >= n_sph)


def any_hit(ray_o, ray_d, scene, *, compat: bool = True):
    """Occlusion query for shadow rays.

    Compat mode reproduces the reference's shadow semantics exactly: the shadow test is
    a full closest-hit with **no maximum distance** (trace.py:92-96) — objects beyond
    the light still occlude — subject to the same 999.0 far clip.
    """
    batch = jnp.broadcast_shapes(ray_o.shape[:-1], ray_d.shape[:-1])
    if scene.spheres.count == 0 and scene.planes.count == 0:
        return jnp.zeros(batch, bool)
    ts, _ = intersect_spheres(ray_o, ray_d, scene.spheres.center,
                              scene.spheres.radius, compat=compat)
    tp, _ = intersect_planes(ray_o, ray_d, scene.planes.origin,
                             scene.planes.normal, compat=compat)
    t_all = jnp.concatenate([ts, tp], axis=-1)
    if compat:
        t_all = jnp.where(t_all < FAR, t_all, BIG)
    return jnp.min(t_all, axis=-1) < BIG
