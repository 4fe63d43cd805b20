"""Pinhole camera: pose, Euler rotations, and analytic pixel-grid generation.

Parity with reference scene/camera.py and scene/rotation.py, but the pixel grid is a
*closed-form linear function of the pixel index* — this is the trick the
whole framework leans on: because any device can compute any pixel's ray analytically,
the sharded renderer needs **zero communication** for ray generation or AA halos
(each shard synthesizes its own rays, including AA half-offset neighbors).

Rotation convention: the reference's ``rotation_y`` uses the transposed sign convention
([[c,0,-s],[0,1,0],[s,0,c]], rotation.py:18-20). We adopt the reference convention as
THE convention (the default camera pose ``euler=[0,-30,0]`` depends on it).

Aspect-ratio quirk: the reference computes ``AR = int(width / height)``
(camera.py:22) — an integer truncation that distorts non-integer aspect ratios and
degenerates to 0 for portrait images. ``compat=True`` reproduces it; ``compat=False``
uses the true float ratio.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp


def rotation_x(phi: jnp.ndarray) -> jnp.ndarray:
    """Rotation about X by ``phi`` radians (reference rotation.py:4-11)."""
    c, s = jnp.cos(phi), jnp.sin(phi)
    o, z = jnp.ones_like(c), jnp.zeros_like(c)
    return jnp.stack([
        jnp.stack([o, z, z]), jnp.stack([z, c, -s]), jnp.stack([z, s, c])
    ])


def rotation_y(theta: jnp.ndarray) -> jnp.ndarray:
    """Rotation about Y, *reference sign convention* (rotation.py:14-21)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    o, z = jnp.ones_like(c), jnp.zeros_like(c)
    return jnp.stack([
        jnp.stack([c, z, -s]), jnp.stack([z, o, z]), jnp.stack([s, z, c])
    ])


def rotation_z(psi: jnp.ndarray) -> jnp.ndarray:
    """Rotation about Z by ``psi`` radians (reference rotation.py:24-31)."""
    c, s = jnp.cos(psi), jnp.sin(psi)
    o, z = jnp.ones_like(c), jnp.zeros_like(c)
    return jnp.stack([
        jnp.stack([c, -s, z]), jnp.stack([s, c, z]), jnp.stack([z, z, o])
    ])


def euler_rotation(roll, pitch, yaw, is_radians: bool = False) -> jnp.ndarray:
    """``Rz(yaw) @ Ry(pitch) @ Rx(roll)``, angles in degrees by default
    (reference rotation.py:34-43)."""
    roll = jnp.asarray(roll, jnp.float32)
    pitch = jnp.asarray(pitch, jnp.float32)
    yaw = jnp.asarray(yaw, jnp.float32)
    if not is_radians:
        roll, pitch, yaw = jnp.deg2rad(roll), jnp.deg2rad(pitch), jnp.deg2rad(yaw)
    # Full f32 precision: a GPU float32 matmul may otherwise run in TF32.
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    return mm(rotation_z(yaw), mm(rotation_y(pitch), rotation_x(roll)))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Camera:
    """Differentiable pinhole camera.

    ``rotation`` is the 3x3 world-from-camera matrix; ``position`` the eye point;
    ``fov`` the full horizontal field of view in degrees (reference camera.py:8-12,
    default 45°). ``resolution`` is static metadata (not a leaf).
    """

    position: jnp.ndarray
    rotation: jnp.ndarray
    fov: jnp.ndarray
    resolution: Tuple[int, int] = dataclasses.field(metadata=dict(static=True),
                                                    default=(256, 256))

    @staticmethod
    def build(resolution: Tuple[int, int], position, euler, fov: float = 45.0) -> "Camera":
        return Camera(
            position=jnp.asarray(position, jnp.float32),
            rotation=euler_rotation(euler[0], euler[1], euler[2]).astype(jnp.float32),
            fov=jnp.asarray(fov, jnp.float32),
            resolution=tuple(resolution),
        )

    # ---- analytic pixel grid -------------------------------------------------
    def grid_params(self, compat: bool = True):
        """Closed-form pixel-grid coefficients.

        The reference builds ``np.mgrid[AR:-AR:wj, 1:-1:hj]`` (camera.py:23): pixel
        (x, y) maps to camera-space ``(focal, y0 + x*dy, z0 + y*dz)`` with inclusive
        endpoints. Returns ``(focal, y0, dy, z0, dz)`` as f32 scalars.
        """
        w, h = self.resolution
        ar = float(int(w / h)) if compat else float(w) / float(h)
        focal = 1.0 / jnp.tan(jnp.deg2rad(self.fov) / 2.0)
        y0 = jnp.float32(ar)
        dy = jnp.float32(-2.0 * ar / (w - 1)) if w > 1 else jnp.float32(0.0)
        z0 = jnp.float32(1.0)
        dz = jnp.float32(-2.0 / (h - 1)) if h > 1 else jnp.float32(0.0)
        return focal.astype(jnp.float32), y0, dy, z0, dz

    def pixel_locations(self, compat: bool = True) -> jnp.ndarray:
        """Dense ``(3, w, h)`` image-plane grid (reference camera.py:18-26 layout)."""
        w, h = self.resolution
        focal, y0, dy, z0, dz = self.grid_params(compat)
        xs = jnp.arange(w, dtype=jnp.float32)
        ys = jnp.arange(h, dtype=jnp.float32)
        yy = (y0 + xs * dy)[:, None] * jnp.ones((1, h), jnp.float32)
        zz = jnp.ones((w, 1), jnp.float32) * (z0 + ys * dz)[None, :]
        xx = jnp.full((w, h), focal, jnp.float32)
        return jnp.stack([xx, yy, zz])

    def ray_origin(self) -> jnp.ndarray:
        return self.position

    def ray_directions(self, pixel_xy: jnp.ndarray, compat: bool = True) -> jnp.ndarray:
        """Unit world-space ray directions for fractional pixel coords ``(..., 2)``.

        Fractional coordinates support AA half-offsets (reference kernels.py:43-50
        samples midpoints between neighboring pixel locations — a half-step in index
        space). Fully analytic: no gather from a stored grid.
        """
        focal, y0, dy, z0, dz = self.grid_params(compat)
        px = pixel_xy[..., 0]
        py = pixel_xy[..., 1]
        p = jnp.stack([jnp.broadcast_to(focal, px.shape), y0 + px * dy, z0 + py * dz],
                      axis=-1)
        # R @ p (kernels.py:22) as explicit broadcast-multiply-reduce: on a GPU
        # a float32 jnp matmul may run in TF32 (~3 decimal digits, a ~5e-4
        # direction error), and a 3-wide contraction gains nothing from the
        # tensor cores.
        d = jnp.sum(self.rotation * p[..., None, :], axis=-1)
        n = jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
        return d / n


def default_camera(resolution: Tuple[int, int] = (1000, 1000)) -> Camera:
    """The reference driver's camera (main.py:24)."""
    return Camera.build(resolution, position=[-2.0, 0.0, 2.0], euler=[0.0, -30.0, 0.0])
