"""python_ray_tracer_jax — a differentiable ray tracing framework in JAX.

A JAX/XLA/Pallas re-design of the capabilities of peter-seres/python-ray-tracer
(pinhole ray generation, sphere/plane intersection, ambient + Lambert shading with
hard shadows, recursive mirror reflections, 3x3 supersampling, PNG output),
extended with end-to-end autodiff, a fused per-pixel GPU render kernel (Pallas,
Triton route), and shard_map data parallelism over rays on device meshes.

See SURVEY.md at the repo root for the structural map of the reference this framework
is built to match.
"""
from .models.scene import (Scene, Spheres, Planes, Lights, Materials, default_scene,
                           random_scene, RED, GREEN, BLUE, YELLOW, GREY, MAGENTA)
from .models.camera import Camera, default_camera, euler_rotation
from .ops.render import render_image, render_rays, to_framebuffer
from .ops.soft import render_image_soft, render_rays_soft
from .ops.pallas import render_image_pallas, render_image_fast
from .ops.shade import sample, trace_once, reflect
from .ops.intersect import intersect_spheres, intersect_planes, closest_hit, any_hit
from .utils.config import RenderConfig
from .utils.image import save_png, framebuffer_to_array
from .utils.timing import time_fn, rays_per_image
from .utils.checkpoint import save_pytree, load_pytree
from .utils.metrics import MetricsLogger

__version__ = "0.1.0"

__all__ = [
    "Scene", "Spheres", "Planes", "Lights", "Materials", "default_scene",
    "random_scene", "Camera", "default_camera", "euler_rotation",
    "render_image", "render_rays", "to_framebuffer", "render_image_soft",
    "render_image_pallas", "render_image_fast",
    "render_rays_soft", "sample", "trace_once",
    "reflect", "intersect_spheres", "intersect_planes", "closest_hit", "any_hit",
    "RenderConfig", "save_png", "framebuffer_to_array", "time_fn", "rays_per_image",
    "save_pytree", "load_pytree", "MetricsLogger",
    "RED", "GREEN", "BLUE", "YELLOW", "GREY", "MAGENTA",
]
