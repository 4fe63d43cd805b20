"""Scene representation as a differentiable JAX pytree.

Design: the scene is a batched structure-of-arrays pytree
(``Spheres.center`` is ``(N, 3)``, ``Spheres.radius`` is ``(N,)`` ...), so every
intersection sweep is a vectorized reduction over the object axis instead of the
reference's per-thread sequential loop (reference: trace.py:22-39). Because the scene is
a pytree, ``jax.grad`` differentiates renders w.r.t. every geometric and material
parameter for free — the reference has no backward pass at all.

Feature parity with the reference scene model (scene/scene.py:9-115):
  * ``Sphere(origin, radius, color)``     -> ``Spheres`` batch   (scene.py:10-23)
  * ``Light(origin)``                     -> ``Lights`` batch    (scene.py:27-36)
  * ``Plane(origin, normal, color)``      -> ``Planes`` batch; the normal is
    normalized at build time exactly like the reference (scene.py:50)
  * ``Scene.default_scene()``             -> :func:`default_scene` (scene.py:100-115)
  * SoA packing ``generate_scene``        -> :meth:`Scene.to_soa` (scene.py:69-97)

Colors: the reference stores and shades colors in the 0-255 range (scene/colors.py).
Internally we keep albedo in [0, 1] — shading is linear in albedo so the two scales are
equivalent up to the final ``*255`` at the framebuffer edge, where parity is asserted.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

# Named colors (0-255 ints, converted to [0,1] floats at scene build).
# Parity with reference scene/colors.py:1-6.
RED = (255, 70, 70)
GREEN = (70, 255, 70)
BLUE = (70, 70, 255)
YELLOW = (255, 255, 70)
GREY = (125, 125, 125)
MAGENTA = (139, 0, 139)


def _f32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Spheres:
    """Batch of spheres: ``center (N,3)``, ``radius (N,)``, ``albedo (N,3)`` in [0,1]."""

    center: jnp.ndarray
    radius: jnp.ndarray
    albedo: jnp.ndarray

    @staticmethod
    def build(items: Sequence[tuple]) -> "Spheres":
        """Build from ``[(origin, radius, color255), ...]``. Empty list is allowed."""
        n = len(items)
        if n == 0:
            return Spheres(jnp.zeros((0, 3), jnp.float32), jnp.zeros((0,), jnp.float32),
                           jnp.zeros((0, 3), jnp.float32))
        centers = _f32([it[0] for it in items])
        radii = _f32([it[1] for it in items])
        albedo = _f32([it[2] for it in items]) / 255.0
        return Spheres(centers, radii, albedo)

    @property
    def count(self) -> int:
        return self.center.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Planes:
    """Batch of infinite planes: ``origin (M,3)``, unit ``normal (M,3)``, ``albedo (M,3)``."""

    origin: jnp.ndarray
    normal: jnp.ndarray
    albedo: jnp.ndarray

    @staticmethod
    def build(items: Sequence[tuple]) -> "Planes":
        m = len(items)
        if m == 0:
            z3 = jnp.zeros((0, 3), jnp.float32)
            return Planes(z3, z3, z3)
        origins = _f32([it[0] for it in items])
        normals = _f32([it[1] for it in items])
        # Normalize at build time — same contract as reference scene.py:50.
        normals = normals / jnp.linalg.norm(normals, axis=-1, keepdims=True)
        albedo = _f32([it[2] for it in items]) / 255.0
        return Planes(origins, normals, albedo)

    @property
    def count(self) -> int:
        return self.origin.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Lights:
    """Batch of point lights: ``position (L,3)`` (reference scene.py:27-36)."""

    position: jnp.ndarray

    @staticmethod
    def build(positions: Sequence) -> "Lights":
        if len(positions) == 0:
            return Lights(jnp.zeros((0, 3), jnp.float32))
        return Lights(_f32(positions))

    @property
    def count(self) -> int:
        return self.position.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Materials:
    """Global material/shading coefficients (differentiable scalars).

    ``ambient``, ``lambert``, ``reflection`` mirror the reference's ``amb, lamb, refl``
    driver knobs (main.py:11). ``specular``/``shininess`` add a Phong highlight term the
    reference lacks (clean mode only; SURVEY §2 comp. 9 notes no specular in reference).
    """

    ambient: jnp.ndarray
    lambert: jnp.ndarray
    reflection: jnp.ndarray
    specular: jnp.ndarray
    shininess: jnp.ndarray

    @staticmethod
    def build(ambient=0.0, lambert=0.6, reflection=0.3, specular=0.0, shininess=32.0):
        return Materials(_f32(ambient), _f32(lambert), _f32(reflection),
                         _f32(specular), _f32(shininess))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Scene:
    """Complete differentiable scene pytree."""

    spheres: Spheres
    planes: Planes
    lights: Lights
    materials: Materials

    def to_soa(self):
        """Pack to the reference's column-major SoA float32 arrays.

        Returns ``(spheres (7,N), lights (3,L), planes (9,M))`` with the exact row
        layout the reference kernels index (scene.py:69-97; rows documented in
        SURVEY §3e). Albedo is re-scaled back to 0-255 to match the reference arrays.
        """
        sp = np.zeros((7, self.spheres.count), np.float32)
        sp[0:3] = np.asarray(self.spheres.center).T
        sp[3] = np.asarray(self.spheres.radius)
        sp[4:7] = np.asarray(self.spheres.albedo).T * 255.0
        li = np.asarray(self.lights.position, np.float32).T.copy()
        pl = np.zeros((9, self.planes.count), np.float32)
        pl[0:3] = np.asarray(self.planes.origin).T
        pl[3:6] = np.asarray(self.planes.normal).T
        pl[6:9] = np.asarray(self.planes.albedo).T * 255.0
        return sp, li, pl

    @staticmethod
    def from_soa(spheres: np.ndarray, lights: np.ndarray, planes: np.ndarray,
                 materials: Materials | None = None) -> "Scene":
        """Inverse of :meth:`to_soa` — accepts reference-layout arrays."""
        sph = Spheres(_f32(spheres[0:3].T), _f32(spheres[3]), _f32(spheres[4:7].T) / 255.0)
        pln = Planes(_f32(planes[0:3].T), _f32(planes[3:6].T), _f32(planes[6:9].T) / 255.0)
        lts = Lights(_f32(lights.T))
        return Scene(sph, pln, lts, materials or Materials.build())


def default_scene(materials: Materials | None = None) -> Scene:
    """The reference demo scene: 3 lights, 6 spheres, 1 grey ground plane
    (reference scene.py:100-115)."""
    lights = Lights.build([[2.5, -2.0, 3.0], [2.5, 2.0, 3.0], [5.0, 0.1, 6.0]])
    spheres = Spheres.build([
        ([2.2, 0.3, 1.0], 1.0, RED),
        ([0.6, 0.7, 0.4], 0.4, BLUE),
        ([0.6, -0.8, 0.5], 0.5, YELLOW),
        ([-1.2, 0.2, 0.5], 0.5, MAGENTA),
        ([-1.7, -0.5, 0.3], 0.3, GREEN),
        ([-2.0, 1.31, 1.3], 1.3, RED),
    ])
    planes = Planes.build([([5, 0, 0], [0, 0, 1], GREY)])
    return Scene(spheres, planes, lights, materials or Materials.build())


def random_scene(key: jax.Array, n_spheres: int = 100, n_lights: int = 3,
                 materials: Materials | None = None) -> Scene:
    """Procedural N-sphere scene for scaling benchmarks (BASELINE configs[4])."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    centers = jnp.stack([
        jax.random.uniform(k1, (n_spheres,), minval=-8.0, maxval=8.0),
        jax.random.uniform(k2, (n_spheres,), minval=-8.0, maxval=8.0),
        jax.random.uniform(k3, (n_spheres,), minval=0.2, maxval=4.0),
    ], axis=-1)
    radii = jax.random.uniform(k4, (n_spheres,), minval=0.15, maxval=0.8)
    albedo = jax.random.uniform(k5, (n_spheres, 3), minval=0.2, maxval=1.0)
    spheres = Spheres(centers.astype(jnp.float32), radii.astype(jnp.float32),
                      albedo.astype(jnp.float32))
    planes = Planes.build([([5, 0, 0], [0, 0, 1], GREY)])
    lpos = jnp.asarray([[2.5, -2.0, 6.0], [2.5, 2.0, 6.0], [5.0, 0.1, 9.0]], jnp.float32)
    lights = Lights(lpos[:n_lights])
    return Scene(spheres, planes, lights, materials or Materials.build())
