"""Golden-framebuffer regression tests.

Pinned uint8 renders of the demo scene guard against silent behavior drift
across rounds of development (the reference's only 'verification' was eyeballing
the output PNG — these make that check exact and automatic). Regenerate with
the snippet in tests/goldens/README if an *intentional* behavior change lands.
"""
import os

import numpy as np
import pytest

import python_ray_tracer_jax as rt

_GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "demo_frames.npz")

_CONFIGS = {
    "demo_64_d2_aa_compat": ((64, 64), 2, True, True),
    "demo_64_d2_noaa_clean": ((64, 64), 2, False, False),
    "demo_48_d4_noaa_compat": ((48, 48), 4, False, True),
}


def _same_toolchain(npz) -> bool:
    """True when the goldens were generated by THIS jax/platform/machine —
    the only case where bit-exact CPU codegen is guaranteed."""
    import platform as _platform

    import jax
    if "_meta" not in npz:
        return False
    meta = str(npz["_meta"])
    return meta == f"jax={jax.__version__}|cpu|{_platform.machine()}"


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_golden_framebuffer(name, demo_scene):
    (w, h), depth, aa, compat = _CONFIGS[name]
    cam = rt.default_camera((w, h))
    img = rt.render_image(cam, demo_scene, depth=depth, aliasing=aa,
                          compat=compat)
    fb = np.asarray(rt.to_framebuffer(img)).astype(np.int32)
    npz = np.load(_GOLDEN)
    want = npz[name].astype(np.int32)
    diff = np.abs(fb - want)
    if _same_toolchain(npz):
        # EXACT on the generating toolchain: any drift is a behavior change.
        np.testing.assert_array_equal(fb, want, err_msg=name)
    else:
        # Other platforms: XLA CPU codegen (FMA contraction, reductions) may
        # legitimately differ by single-level rounding on a few pixels.
        assert diff.max() <= 1, f"{name}: max diff {diff.max()}"
        assert (diff > 0).mean() < 0.01, \
            f"{name}: {(diff > 0).mean():.2%} changed"


def _kernel_fb(name, scene):
    from python_ray_tracer_jax.ops.pallas.render_pallas import \
        render_image_pallas
    (w, h), depth, aa, compat = _CONFIGS[name]
    img = render_image_pallas(rt.default_camera((w, h)), scene, depth=depth,
                              aliasing=aa, compat=compat, interpret=True)
    fb = np.asarray(rt.to_framebuffer(img)).astype(np.int32)
    return fb, np.load(_GOLDEN)[name].astype(np.int32)


@pytest.mark.parametrize("name", ["demo_48_d4_noaa_compat",
                                  "demo_64_d2_noaa_clean"])
def test_kernel_golden_framebuffer(name, demo_scene):
    """The fused kernel (Pallas interpreter) against the same jnp goldens, at
    the cross-toolchain tolerance above: the kernel's own drift is caught
    here even where the parity tests would move with a shared change."""
    fb, want = _kernel_fb(name, demo_scene)
    diff = np.abs(fb - want)
    assert diff.max() <= 1, f"{name}: max diff {diff.max()}"
    assert (diff > 0).mean() < 0.01, f"{name}: {(diff > 0).mean():.2%} changed"


def test_kernel_golden_framebuffer_aa(demo_scene):
    """The AA golden at the cross-backend bar: at most 0.1% of pixels may move
    by more than one level. One of the nine samples of a silhouette pixel can
    take the other side of a near-tied hit test under a different float32
    association (a 36/9 = 4-level step); at this pixel the kernel is the one
    that agrees with the float64 oracle."""
    fb, want = _kernel_fb("demo_64_d2_aa_compat", demo_scene)
    moved = np.abs(fb - want).max(axis=0)
    assert (moved > 1).mean() <= 1e-3, f"{(moved > 1).sum()} pixels flipped"
