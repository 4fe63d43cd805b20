"""Framebuffer parity: batched jnp renderer vs the independent scalar oracle.

The oracle (tests/oracle.py) re-implements the reference's documented compat
semantics in scalar f64 numpy; the framework renders the same scenes in batched f32
jnp. Quantized uint8 framebuffers must agree except for isolated quantization-edge
pixels (f32 vs f64 can flip a hit test exactly on a silhouette).
"""
import numpy as np
import pytest

import python_ray_tracer_jax as rt

from . import oracle


def _fb_close(fb_jax, fb_oracle, max_bad_frac=0.005, tol=2):
    a = np.asarray(fb_jax).astype(np.int32)
    b = np.asarray(fb_oracle).astype(np.int32)
    diff = np.abs(a - b)
    bad = (diff > tol).mean()
    assert bad <= max_bad_frac, (
        f"{bad:.2%} of channel values differ by more than {tol} "
        f"(max diff {diff.max()})")
    # the overwhelming majority must be within 1
    assert (diff <= 1).mean() > 0.98


def _render_framework(scene_soa, w, h, cam_pos, cam_euler, *, depth, aliasing,
                      amb=0.0, lamb=0.6, refl=0.3):
    sph, li, pl = scene_soa
    scene = rt.Scene.from_soa(np.asarray(sph, np.float32), np.asarray(li, np.float32),
                              np.asarray(pl, np.float32),
                              rt.Materials.build(amb, lamb, refl))
    cam = rt.Camera.build((w, h), cam_pos, cam_euler)
    img = rt.render_image(cam, scene, depth=depth, aliasing=aliasing, compat=True)
    return rt.to_framebuffer(img)


def test_single_sphere_plane_primary():
    """BASELINE configs[0]: one sphere + ground plane, primary rays, small image."""
    spheres = np.zeros((7, 1))
    spheres[0:3, 0], spheres[3, 0], spheres[4:7, 0] = [3.0, 0.0, 1.0], 1.0, [255, 70, 70]
    planes = np.zeros((9, 1))
    planes[0:3, 0], planes[3:6, 0], planes[6:9, 0] = [5, 0, 0], [0, 0, 1], [125] * 3
    lights = np.array([[2.5, -2.0, 3.0]]).T
    soa = (spheres, lights, planes)
    w = h = 24
    fb_o = oracle.render(oracle.OracleScene(*soa), w, h, [-2, 0, 2], [0, -30, 0],
                         depth=0, aliasing=False)
    fb_j = _render_framework(soa, w, h, [-2, 0, 2], [0, -30, 0], depth=0, aliasing=False)
    _fb_close(fb_j, fb_o)


@pytest.mark.parametrize("depth,aliasing", [(0, False), (2, False), (2, True)])
def test_demo_scene_parity(depth, aliasing):
    """Reference demo scene at a small resolution, increasing feature coverage."""
    soa = oracle.default_scene_soa()
    w = h = 24
    fb_o = oracle.render(oracle.OracleScene(*soa), w, h, [-2, 0, 2], [0, -30, 0],
                         depth=depth, aliasing=aliasing)
    fb_j = _render_framework(soa, w, h, [-2, 0, 2], [0, -30, 0],
                             depth=depth, aliasing=aliasing)
    _fb_close(fb_j, fb_o)


def test_ambient_and_depth4():
    soa = oracle.default_scene_soa()
    w = h = 16
    fb_o = oracle.render(oracle.OracleScene(*soa), w, h, [-2, 0, 2], [0, -30, 0],
                         amb=0.1, depth=4, aliasing=False)
    fb_j = _render_framework(soa, w, h, [-2, 0, 2], [0, -30, 0],
                             amb=0.1, depth=4, aliasing=False)
    _fb_close(fb_j, fb_o)


def test_row_chunked_render_matches_whole(demo_scene):
    cam = rt.default_camera((32, 32))
    whole = rt.render_image(cam, demo_scene, depth=2, aliasing=True, compat=True)
    chunked = rt.render_image(cam, demo_scene, depth=2, aliasing=True, compat=True,
                              row_chunk=8)
    np.testing.assert_allclose(np.asarray(whole), np.asarray(chunked), atol=1e-6)
