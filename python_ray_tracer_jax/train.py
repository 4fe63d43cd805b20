"""Inverse rendering: fit scene parameters to a target image by gradient descent.

BASELINE configs[3] ("differentiable inverse render: fit sphere positions/albedos to
target image via pixel-grad descent"). The reference has no backward pass at all —
this subsystem exists only in this framework. The training step is one jitted
function: render -> pixel MSE -> ``jax.grad`` w.r.t. the scene pytree -> optax
update. On a mesh, the loss comes from :mod:`.parallel.render_sharded` and scene
gradients are ``psum``-all-reduced across the devices inside the same jitted step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import optax

from .models.scene import Scene
from .ops.render import render_image
from .parallel.render_sharded import make_loss_fn
from .utils.metrics import MetricsLogger


def pixel_loss(camera, target, *, depth: int = 2, aliasing: bool = False,
               compat: bool = True, row_chunk: Optional[int] = None) -> Callable:
    """Single-device ``loss(scene) -> scalar`` mean-squared pixel error."""
    def loss(scene):
        img = render_image(camera, scene, depth=depth, aliasing=aliasing,
                           compat=compat, row_chunk=row_chunk)
        return jnp.mean((img - target) ** 2)
    return loss


def soft_pixel_loss(camera, target, *, tau: float = 0.05,
                    row_chunk: Optional[int] = None,
                    bounce_depth: int = 0) -> Callable:
    """Silhouette-aware loss via the soft-visibility renderer (ops/soft.py).

    The target should be produced by the same renderer at the same ``tau`` so
    the residual isn't dominated by the soft/hard appearance gap.
    ``bounce_depth=1`` adds the depth-1 mirror bounce (reflection-coefficient
    fitting — ops/soft.py)."""
    from .ops.soft import render_image_soft

    def loss(scene):
        img = render_image_soft(camera, scene, tau=tau, row_chunk=row_chunk,
                                bounce_depth=bounce_depth)
        return jnp.mean((img - target) ** 2)
    return loss


def _mask_grads(grads: Scene, trainable: Optional[Sequence[str]]) -> Scene:
    """Zero out gradients for non-trainable scene fields.

    ``trainable`` entries are either top-level field names (``"spheres"``) or dotted
    leaf paths (``"spheres.center"``); anything not covered is frozen.
    """
    if trainable is None:
        return grads
    tops = {t for t in trainable if "." not in t}
    leaves = {tuple(t.split(".")) for t in trainable if "." in t}
    updates = {}
    for f in dataclasses.fields(grads):
        if f.name in tops:
            continue
        sub = getattr(grads, f.name)
        sub_updates = {}
        for sf in dataclasses.fields(sub):
            if (f.name, sf.name) not in leaves:
                sub_updates[sf.name] = jax.tree_util.tree_map(
                    jnp.zeros_like, getattr(sub, sf.name))
        if sub_updates:
            updates[f.name] = dataclasses.replace(sub, **sub_updates)
    return dataclasses.replace(grads, **updates) if updates else grads


def make_train_step(loss_fn: Callable, optimizer: optax.GradientTransformation,
                    trainable: Optional[Sequence[str]] = None):
    """Jitted ``(scene, opt_state) -> (scene, opt_state, loss)`` step, with
    ``loss_fn`` differentiated by XLA."""
    vg = jax.value_and_grad(loss_fn)

    @jax.jit
    def step(scene, opt_state):
        loss, grads = vg(scene)
        grads = _mask_grads(grads, trainable)
        updates, opt_state = optimizer.update(grads, opt_state, scene)
        scene = optax.apply_updates(scene, updates)
        return scene, opt_state, loss

    return step


def fit_scene(init_scene: Scene, camera, target, *, steps: int = 200,
              lr: float = 2e-2, depth: int = 2, aliasing: bool = False,
              compat: bool = True, trainable: Optional[Sequence[str]] = ("spheres",),
              mesh=None, row_chunk: Optional[int] = None,
              logger: Optional[MetricsLogger] = None, log_every: int = 20):
    """Run the inverse-render optimization; returns ``(scene, losses)``.

    ``trainable`` selects which top-level scene fields receive updates (default:
    sphere geometry/albedo, matching configs[3]); the rest stay frozen. With a
    ``mesh`` the loss is rendered ray-DP sharded and its gradients are
    ``psum``'d (:func:`.parallel.render_sharded.make_loss_fn`); otherwise
    ``row_chunk`` bounds the single-device step's memory.
    """
    if mesh is not None:
        loss_fn = make_loss_fn(camera, target, mesh, depth=depth,
                               aliasing=aliasing, compat=compat)
    else:
        loss_fn = pixel_loss(camera, target, depth=depth, aliasing=aliasing,
                             compat=compat, row_chunk=row_chunk)
    optimizer = optax.adam(lr)
    step = make_train_step(loss_fn, optimizer, trainable)
    opt_state = optimizer.init(init_scene)
    scene = init_scene
    losses = []
    for i in range(steps):
        scene, opt_state, loss = step(scene, opt_state)
        losses.append(float(loss))
        if logger is not None and (i % log_every == 0 or i == steps - 1):
            logger.log(i, loss=float(loss))
    return scene, losses


def fit_camera(init_camera, scene, target, *, steps: int = 300,
               lr: float = 1e-2, depth: int = 1, aliasing: bool = False,
               compat: bool = True, fit_fov: bool = False,
               logger: Optional[MetricsLogger] = None, log_every: int = 20):
    """Inverse rendering w.r.t. the CAMERA: recover pose from a target image.

    The dual of :func:`fit_scene` (scene fixed, camera free) — a capability the
    reference cannot express (its camera grid is baked on the host,
    reference src/camera.py:18-26; ours is an analytic differentiable pytree).
    Optimizes position + Euler angles (rotation re-orthonormalized every step
    by reconstruction through ``euler_rotation``, so the fit stays on SO(3))
    and optionally fov. Camera gradients are smooth almost everywhere: pose
    perturbations move shading continuously except at silhouette pixels, so
    small pose errors fit well even with hard visibility.

    ``init_camera``'s rotation is assumed to come from ``Camera.build`` /
    ``euler_rotation``; the initial Euler angles are re-derived from the matrix
    (ZYX convention, reference rotation.py:34-43).

    Returns ``(fitted_camera, losses)``.
    """
    from .models.camera import Camera, euler_rotation

    R = init_camera.rotation
    # Invert euler_rotation = Rz(yaw) @ Ry(pitch) @ Rx(roll) with the
    # reference's TRANSPOSED Ry (rotation.py:18-20: Ry_ref(t) = Ry_std(-t)),
    # which flips the standard ZYX extraction to R[2,0] = +sin(pitch).
    # Verified exact (<1e-7) over 200 random poses, |angles| < 1.2 rad.
    pitch0 = jnp.arcsin(jnp.clip(R[2, 0], -1.0, 1.0))
    yaw0 = jnp.arctan2(R[1, 0], R[0, 0])
    roll0 = jnp.arctan2(R[2, 1], R[2, 2])
    params = {
        "position": jnp.asarray(init_camera.position, jnp.float32),
        "euler": jnp.stack([roll0, pitch0, yaw0]).astype(jnp.float32),
        "fov": jnp.asarray(init_camera.fov, jnp.float32),
    }
    resolution = init_camera.resolution

    def camera_of(p):
        return Camera(position=p["position"],
                      rotation=euler_rotation(p["euler"][0], p["euler"][1],
                                              p["euler"][2], is_radians=True),
                      fov=p["fov"], resolution=resolution)

    def loss_fn(p):
        img = render_image(camera_of(p), scene, depth=depth, aliasing=aliasing,
                           compat=compat)
        return jnp.mean((img - target) ** 2)

    vg = jax.value_and_grad(loss_fn)

    optimizer = optax.adam(lr)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(p, opt_state):
        loss, grads = vg(p)
        if not fit_fov:
            grads = {**grads, "fov": jnp.zeros_like(grads["fov"])}
        updates, opt_state = optimizer.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
        if logger is not None and (i % log_every == 0 or i == steps - 1):
            logger.log(i, loss=float(loss))
    return camera_of(params), losses


def fit_scene_soft(init_scene: Scene, camera, target_scene: Scene, *,
                   steps: int = 200, lr: float = 1e-2,
                   taus: Sequence[float] = (0.15, 0.05, 0.02),
                   trainable: Optional[Sequence[str]] = ("spheres.center",),
                   logger: Optional[MetricsLogger] = None,
                   bounce_depth: int = 0, row_chunk: Optional[int] = None):
    """Coarse-to-fine soft-visibility fitting (anneal ``tau`` toward hard).

    At each ``tau`` the *target* is re-rendered from ``target_scene`` with the same
    softness, so only geometry/material mismatch drives the loss. Robust where the
    hard a.e. gradient misleads (overlapping silhouettes — see ops/soft.py).
    ``bounce_depth=1`` adds the depth-1 mirror bounce (fits
    ``materials.reflection`` and reflective appearance); ``row_chunk`` bounds the
    step's memory on dense scenes. Returns ``(scene, losses)``.
    """
    from .ops.soft import render_image_soft

    scene = init_scene
    losses = []
    per_stage = max(1, steps // len(taus))
    for tau in taus:
        target = render_image_soft(camera, target_scene, tau=tau,
                                   row_chunk=row_chunk,
                                   bounce_depth=bounce_depth)
        optimizer = optax.adam(lr)
        loss_fn = soft_pixel_loss(camera, target, tau=tau, row_chunk=row_chunk,
                                  bounce_depth=bounce_depth)
        step = make_train_step(loss_fn, optimizer, trainable)
        opt_state = optimizer.init(scene)
        for i in range(per_stage):
            scene, opt_state, loss = step(scene, opt_state)
            losses.append(float(loss))
        if logger is not None:
            logger.log(len(losses), tau=float(tau), loss=losses[-1])
    return scene, losses
