"""Batched multi-frame rendering (animation.py): one compile, N frames."""
import os

import jax
import numpy as np

import python_ray_tracer_jax as rt
from python_ray_tracer_jax import animation


def test_orbit_cameras_look_at_center():
    cams = animation.orbit_cameras((16, 16), center=[1.0, 0.0, 1.0],
                                   radius=4.0, height=1.5, n_frames=6)
    assert cams.position.shape == (6, 3)
    assert cams.rotation.shape == (6, 3, 3)
    # forward = rotated +x must point from each eye toward the center
    fwd = np.asarray(cams.rotation) @ np.array([1.0, 0.0, 0.0])
    to_c = np.array([1.0, 0.0, 1.0]) - np.asarray(cams.position)
    to_c /= np.linalg.norm(to_c, axis=1, keepdims=True)
    np.testing.assert_allclose(fwd, to_c, atol=1e-5)


def test_render_frames_match_single_renders(demo_scene):
    cams = animation.orbit_cameras((24, 16), center=[1.0, 0.0, 1.0],
                                   radius=4.0, height=1.5, n_frames=3)
    frames = np.asarray(animation.render_frames(
        cams, demo_scene, depth=1, aliasing=False, backend="jnp"))
    assert frames.shape == (3, 24, 16, 3)
    for k in range(3):
        cam = rt.Camera(position=cams.position[k], rotation=cams.rotation[k],
                        fov=cams.fov[k], resolution=(24, 16))
        single = np.asarray(rt.render_image(cam, demo_scene, depth=1,
                                            aliasing=False))
        # lax.map bodies fuse differently than the standalone jit — a few
        # near-tie pixels move by ~1e-4 (same class as the kernel parity tests)
        d = np.abs(frames[k] - single)
        assert (d > 1e-3).mean() == 0.0 and d.max() < 1e-2
    # frames actually differ (the orbit moved)
    assert np.abs(frames[0] - frames[1]).max() > 1e-3


def test_save_animation_writes_gif(tmp_path, demo_scene):
    cams = animation.orbit_cameras((16, 16), center=[1.0, 0.0, 1.0],
                                   radius=4.0, height=1.5, n_frames=2)
    frames = animation.render_frames(cams, demo_scene, depth=0,
                                     aliasing=False, backend="jnp")
    path = os.path.join(tmp_path, "orbit.gif")
    animation.save_animation(frames, path, fps=8)
    from PIL import Image
    im = Image.open(path)
    assert im.format == "GIF" and getattr(im, "n_frames", 1) == 2
