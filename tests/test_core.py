"""Unit tests: rotations, camera grid, intersections, shading terms, viewer."""
import jax.numpy as jnp
import numpy as np
import pytest

import python_ray_tracer_jax as rt
from python_ray_tracer_jax.models import camera as cam_mod

from . import oracle


def test_euler_rotation_matches_oracle():
    for angles in [(0, 0, 0), (10, -30, 45), (90, 0, 0), (-15, 60, 120)]:
        a = np.asarray(rt.euler_rotation(*angles))
        b = oracle.euler_rot(*angles)
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_rotation_identity_and_orthogonality():
    R = np.asarray(rt.euler_rotation(23.0, -42.0, 11.0))
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-6)


def test_pixel_grid_matches_reference_layout():
    """Grid = mgrid[AR:-AR:wj, 1:-1:hj] with x = 1/tan(fov/2) (camera.py:22-26)."""
    w, h = 8, 6
    cam = rt.Camera.build((w, h), [0, 0, 0], [0, 0, 0], fov=45.0)
    grid = np.asarray(cam.pixel_locations(compat=True))
    AR = int(w / h)
    yy, zz = np.mgrid[AR:-AR:complex(0, w), 1:-1:complex(0, h)]
    xx = np.ones_like(yy) / np.tan(np.radians(45.0) / 2)
    np.testing.assert_allclose(grid, np.array([xx, yy, zz]), atol=1e-5)


def test_pixel_grid_clean_mode_true_aspect():
    cam = rt.Camera.build((8, 6), [0, 0, 0], [0, 0, 0])
    _, y0, dy, _, _ = cam.grid_params(compat=False)
    assert float(y0) == pytest.approx(8 / 6)


def test_sphere_intersection_analytic():
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    center = jnp.asarray([[5.0, 0.0, 0.0]])
    radius = jnp.asarray([2.0])
    t, valid = rt.intersect_spheres(o, d, center, radius)
    assert bool(valid[0, 0])
    assert float(t[0, 0]) == pytest.approx(3.0, abs=1e-5)
    # from inside the sphere: far root
    o2 = jnp.asarray([[5.0, 0.0, 0.0]])
    t2, v2 = rt.intersect_spheres(o2, d, center, radius)
    assert bool(v2[0, 0]) and float(t2[0, 0]) == pytest.approx(2.0, abs=1e-5)
    # behind
    o3 = jnp.asarray([[10.0, 0.0, 0.0]])
    _, v3 = rt.intersect_spheres(o3, d, center, radius)
    assert not bool(v3[0, 0])
    # clean miss
    o4 = jnp.asarray([[0.0, 5.0, 0.0]])
    _, v4 = rt.intersect_spheres(o4, d, center, radius)
    assert not bool(v4[0, 0])


def test_plane_intersection_analytic():
    o = jnp.asarray([[0.0, 0.0, 1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    po = jnp.asarray([[0.0, 0.0, 0.0]])
    pn = jnp.asarray([[0.0, 0.0, 1.0]])
    t, valid = rt.intersect_planes(o, d, po, pn)
    assert bool(valid[0, 0]) and float(t[0, 0]) == pytest.approx(1.0, abs=1e-6)
    # parallel (compat threshold 1e-3)
    d2 = jnp.asarray([[1.0, 0.0, -0.0005]])
    _, v2 = rt.intersect_planes(o, d2, po, pn, compat=True)
    assert not bool(v2[0, 0])
    _, v3 = rt.intersect_planes(o, d2 / jnp.linalg.norm(d2), po, pn, compat=False)
    assert bool(v3[0, 0])


def test_far_clip_quirk():
    """Hits beyond t=999 are misses in compat mode (trace.py:17)."""
    scene = rt.Scene(
        rt.Spheres.build([([1500.0, 0.0, 0.0], 10.0, rt.RED)]),
        rt.Planes.build([]), rt.Lights.build([]), rt.Materials.build())
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    hits = rt.closest_hit(o, d, scene, compat=True)
    assert not bool(hits["hit"][0])
    hits2 = rt.closest_hit(o, d, scene, compat=False)
    assert bool(hits2["hit"][0])


def test_tie_break_sphere_before_plane():
    """Equidistant surfaces: strict > means the sphere (scanned first) wins."""
    scene = rt.Scene(
        rt.Spheres.build([([2.0, 0.0, 0.0], 1.0, rt.RED)]),
        rt.Planes.build([([1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], rt.GREY)]),
        rt.Lights.build([]), rt.Materials.build())
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    hits = rt.closest_hit(o, d, scene)
    assert bool(hits["hit"][0]) and not bool(hits["is_plane"][0])


def test_reflect_unit():
    d = jnp.asarray([[1.0, -1.0, 0.0]]) / np.sqrt(2)
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    r = np.asarray(rt.reflect(d, n))[0]
    np.testing.assert_allclose(r, [1 / np.sqrt(2), 1 / np.sqrt(2), 0.0], atol=1e-6)


def test_shadowed_point_gets_only_ambient():
    """Occluder between surface and the single light -> Lambert suppressed."""
    mats = rt.Materials.build(ambient=0.1, lambert=0.9)
    base = rt.Scene(
        rt.Spheres.build([([0.0, 0.0, 5.0], 1.0, rt.RED)]),   # occluder
        rt.Planes.build([([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], rt.GREY)]),
        rt.Lights.build([[0.0, 0.0, 10.0]]), mats)
    o = jnp.asarray([[0.0, 0.0, 3.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    st = rt.trace_once(o, d, base)
    grey = 125 / 255
    np.testing.assert_allclose(np.asarray(st.rgb)[0], [0.1 * grey] * 3, atol=1e-5)
    # remove occluder -> ambient + full Lambert (L == N)
    no_occ = rt.Scene(rt.Spheres.build([]), base.planes, base.lights, mats)
    st2 = rt.trace_once(o, d, no_occ)
    np.testing.assert_allclose(np.asarray(st2.rgb)[0], [(0.1 + 0.9) * grey] * 3,
                               atol=1e-4)


def test_viewer_matches_pil_composition():
    """Pure-numpy orientation == reference PIL transpose+rotate(270)+mirror."""
    from PIL import Image, ImageOps
    rng = np.random.default_rng(0)
    fb = rng.integers(0, 256, size=(3, 12, 8), dtype=np.uint8)
    ours = rt.framebuffer_to_array(fb)
    y = np.zeros((12, 8, 3), np.uint8)
    for c in range(3):
        y[:, :, c] = fb[c]
    ref = np.asarray(ImageOps.mirror(Image.fromarray(y, "RGB").rotate(270, expand=True)))
    np.testing.assert_array_equal(ours, ref)


def test_scene_soa_roundtrip(demo_scene):
    soa = demo_scene.to_soa()
    assert soa[0].shape == (7, 6) and soa[1].shape == (3, 3) and soa[2].shape == (9, 1)
    back = rt.Scene.from_soa(*soa)
    np.testing.assert_allclose(np.asarray(back.spheres.center),
                               np.asarray(demo_scene.spheres.center), atol=1e-6)
    np.testing.assert_allclose(np.asarray(back.planes.albedo),
                               np.asarray(demo_scene.planes.albedo), atol=1e-6)


def test_compat_channel_swap_vs_clean(demo_scene):
    """Compat framebuffer stores (R, B, G) on borders; clean mode stores (R, G, B)."""
    cam = rt.default_camera((16, 16))
    compat = np.asarray(rt.render_image(cam, demo_scene, depth=0, aliasing=False,
                                        compat=True))
    clean = np.asarray(rt.render_image(cam, demo_scene, depth=0, aliasing=False,
                                       compat=False))
    np.testing.assert_allclose(compat[..., 0], clean[..., 0], atol=1e-5)
    np.testing.assert_allclose(compat[..., 1], clean[..., 2], atol=1e-5)
    np.testing.assert_allclose(compat[..., 2], clean[..., 1], atol=1e-5)


def test_empty_scene_renders_black():
    scene = rt.Scene(rt.Spheres.build([]), rt.Planes.build([]),
                     rt.Lights.build([]), rt.Materials.build())
    cam = rt.default_camera((8, 8))
    img = np.asarray(rt.render_image(cam, scene, depth=1, aliasing=False))
    np.testing.assert_array_equal(img, 0.0)


def test_phong_highlight_clean_mode():
    mats = rt.Materials.build(ambient=0.0, lambert=0.0, specular=1.0, shininess=8.0)
    scene = rt.Scene(rt.Spheres.build([]),
                     rt.Planes.build([([0, 0, 0], [0, 0, 1], rt.GREY)]),
                     rt.Lights.build([[0.0, 0.0, 5.0]]), mats)
    # Ray straight down: reflection goes straight up, directly at the light.
    o = jnp.asarray([[0.0, 0.0, 2.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    st = rt.trace_once(o, d, scene, compat=False)
    assert float(st.rgb[0, 0]) == pytest.approx(1.0, abs=1e-4)
    st_compat = rt.trace_once(o, d, scene, compat=True)
    assert float(st_compat.rgb[0, 0]) == 0.0  # no specular in compat mode
