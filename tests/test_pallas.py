"""Fused GPU render kernel vs the jnp reference path.

Every kernel test here runs the kernel in the Pallas interpreter on the CPU
(``interpret=True``); the compiled kernel is checked on the card by
chip_smoke.py and by the ``gpu``-marked test at the end of this file.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import python_ray_tracer_jax as rt
from python_ray_tracer_jax.ops.pallas import render_pallas as rp
from python_ray_tracer_jax.ops.pallas.render_pallas import (render_image_pallas,
                                                            render_image_fast)


def _compare(cam, scene, *, depth, aliasing, compat, atol=1e-4, **kw):
    ref = np.asarray(rt.render_image(cam, scene, depth=depth, aliasing=aliasing,
                                     compat=compat))
    out = np.asarray(render_image_pallas(cam, scene, depth=depth,
                                         aliasing=aliasing, compat=compat,
                                         interpret=True, **kw))
    assert out.shape == ref.shape
    diff = np.abs(out - ref)
    # f32 reassociation can flip a near-tied hit/shadow test at isolated pixels;
    # flips are discrete and bounded by the shading range, so bound the *count*
    # of outliers at two magnitudes rather than the worst case.
    frac_bad = (diff > atol).mean()
    assert frac_bad <= 0.005, f"{frac_bad:.2%} of values exceed atol={atol}"
    assert (diff > 0.05).mean() <= 0.002, (
        f"{(diff > 0.05).mean():.2%} hit-flip outliers (max {diff.max()})")
    return out


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("aliasing", [False, True])
@pytest.mark.parametrize("depth", [0, 1, 2, 4])
def test_pallas_matches_jnp(demo_scene, depth, aliasing, compat):
    cam = rt.default_camera((24, 24))
    _compare(cam, demo_scene, depth=depth, aliasing=aliasing, compat=compat)


def test_pallas_clean_specular(demo_scene):
    """Clean-mode Phong specular in the kernel == jnp path with specular > 0
    (the specular=0 clean cases above cannot see a dropped term)."""
    cam = rt.default_camera((16, 16))
    scene = dataclasses.replace(
        demo_scene, materials=rt.Materials.build(specular=0.8, shininess=16.0))
    spec = _compare(cam, scene, depth=2, aliasing=False, compat=False)
    base = np.asarray(rt.render_image(cam, demo_scene, depth=2, aliasing=False,
                                      compat=False))
    assert np.abs(spec - base).max() > 0.05   # the term actually shades


@pytest.mark.parametrize("size", [(40, 24), (13, 7), (33, 17), (1, 1)])
def test_pallas_nonsquare_partial_tiles(demo_scene, size):
    """Pixel counts that are not a multiple of the program block: the padded
    tail is computed and sliced off without touching real pixels."""
    assert (size[0] * size[1]) % rp._BLOCK != 0
    cam = rt.Camera.build(size, [-2, 0, 2], [0, -30, 0])
    _compare(cam, demo_scene, depth=1, aliasing=True, compat=True)


@pytest.mark.parametrize("aliasing", [False, True])
@pytest.mark.parametrize("n_slices", [2, 4])
def test_pallas_slices_reassemble(demo_scene, n_slices, aliasing):
    """x_offset/local_width slices (the ray-DP shard layout) reassemble to the
    whole-image kernel render, AA halos at slice boundaries included."""
    cam = rt.default_camera((32, 16))
    kw = dict(depth=2, aliasing=aliasing, compat=True, interpret=True)
    whole = np.asarray(render_image_pallas(cam, demo_scene, **kw))
    step = 32 // n_slices
    parts = [np.asarray(render_image_pallas(cam, demo_scene, x_offset=i * step,
                                            local_width=step, **kw))
             for i in range(n_slices)]
    # each slice is its own XLA program, which may contract a different f32
    # expression into an FMA: ~1e-6 level differences, no hit flips
    np.testing.assert_allclose(np.concatenate(parts, axis=0), whole, atol=2e-5)


@pytest.mark.parametrize("n_spheres,n_lights", [(24, 3), (40, 3), (6, 20)])
def test_pallas_large_scene_rolled_loops(n_spheres, n_lights):
    """Many spheres, and more than 16 lights: the object and light loops are
    rolled ``fori_loop``s whatever the count."""
    scene = rt.random_scene(jax.random.key(1), n_spheres=n_spheres)
    if n_lights != scene.lights.count:
        # a ring of lights high above the spheres
        a = jnp.linspace(0.0, 2.0 * jnp.pi, n_lights, endpoint=False)
        lights = jnp.stack([2.0 + 6.0 * jnp.cos(a), 6.0 * jnp.sin(a),
                            jnp.full((n_lights,), 9.0)], axis=-1)
        scene = dataclasses.replace(scene, lights=rt.Lights(lights))
    cam = rt.Camera.build((32, 32), [-6, 0, 3], [0, -20, 0])
    _compare(cam, scene, depth=1, aliasing=False, compat=True)


@pytest.mark.parametrize("spheres,planes,lights", [
    (True, False, False), (False, True, True), (True, True, False),
    (False, False, False)])
def test_pallas_no_planes_no_lights(spheres, planes, lights):
    """Scenes without planes, spheres or lights compile their loops away."""
    scene = rt.Scene(
        rt.Spheres.build([([3.0, 0.0, 0.0], 1.0, rt.RED)] if spheres else []),
        rt.Planes.build([([5, 0, -1], [0, 0, 1], rt.GREY)] if planes else []),
        rt.Lights.build([[2.5, -2.0, 3.0]] if lights else []),
        rt.Materials.build(ambient=0.5))
    cam = rt.Camera.build((16, 16), [0, 0, 0.5], [0, -10, 0])
    out = _compare(cam, scene, depth=1, aliasing=False, compat=True)
    assert (out.max() > 0.0) == (spheres or planes)


@pytest.mark.parametrize("aliasing", [False, True])
def test_render_image_fast_grads_match_jnp(demo_scene, aliasing):
    """custom_vjp: kernel forward, jnp-autodiff backward. With a loss linear in
    the image both see the same cotangent, so the gradients match."""
    cam = rt.default_camera((16, 16))
    w = jax.random.uniform(jax.random.key(0), (16, 16, 3))

    def loss_fast(s):
        return jnp.sum(render_image_fast(cam, s, 1, aliasing, True, True) * w)

    def loss_ref(s):
        return jnp.sum(rt.render_image(cam, s, depth=1, aliasing=aliasing) * w)

    v_fast, g_fast = jax.value_and_grad(loss_fast)(demo_scene)
    v_ref, g_ref = jax.value_and_grad(loss_ref)(demo_scene)
    np.testing.assert_allclose(float(v_fast), float(v_ref), rtol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(g_fast),
                    jax.tree_util.tree_leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("aliasing", [False, True])
def test_pallas_sharded_slices(demo_scene, aliasing):
    """Sharded kernel path on 4 virtual devices: per-device global column
    slices == whole image."""
    from python_ray_tracer_jax.parallel.mesh import make_mesh
    from python_ray_tracer_jax.parallel.render_sharded import render_image_sharded

    mesh = make_mesh(jax.devices()[:4])
    cam = rt.default_camera((32, 32))
    whole = np.asarray(rt.render_image(cam, demo_scene, depth=1,
                                       aliasing=aliasing))
    out = render_image_sharded(cam, demo_scene, mesh, depth=1,
                               aliasing=aliasing, backend="pallas",
                               pallas_interpret=True)
    assert len(out.sharding.device_set) == 4
    diff = np.abs(np.asarray(out) - whole)
    assert (diff > 1e-4).mean() < 0.005 and diff.max() < 0.05


def test_pallas_requires_gpu_unless_interpret(demo_scene):
    """No silent fallback: off a GPU the compiled kernel refuses to run, and
    the interpreter is reached only by asking for it."""
    cam = rt.default_camera((8, 8))
    with pytest.raises(RuntimeError, match="GPU"):
        render_image_pallas(cam, demo_scene)
    with pytest.raises(RuntimeError, match="GPU"):
        render_image_fast(cam, demo_scene)
    from python_ray_tracer_jax.parallel.mesh import make_mesh
    from python_ray_tracer_jax.parallel.render_sharded import render_image_sharded
    with pytest.raises(RuntimeError, match="GPU"):
        render_image_sharded(cam, demo_scene, make_mesh(jax.devices()[:2]),
                             backend="pallas")


def test_pack_table_layout(demo_scene):
    """The kernel's scene table: power-of-two length, header then the SoA rows
    at the offsets the kernel reads."""
    cam = rt.default_camera((8, 8))
    tab = np.asarray(rp._pack_table(cam, demo_scene, True, 3.0))
    ns, npl, nl = 6, 1, 3
    sph, pln, lts, size = rp._layout(ns, npl, nl)
    assert tab.shape == (size,) and size & (size - 1) == 0
    assert tab[rp._P_X0] == 3.0
    np.testing.assert_array_equal(tab[rp._P_OFFS:rp._P_OFFS + 2], [0.0, 0.0])
    np.testing.assert_allclose(tab[sph:sph + ns],
                               np.asarray(demo_scene.spheres.center)[:, 0])
    np.testing.assert_allclose(tab[sph + 3 * ns:sph + 4 * ns],
                               np.asarray(demo_scene.spheres.radius))
    np.testing.assert_allclose(tab[pln + 3 * npl:pln + 6 * npl],
                               np.asarray(demo_scene.planes.normal)[0])
    np.testing.assert_allclose(tab[lts + 2 * nl:lts + 3 * nl],
                               np.asarray(demo_scene.lights.position)[:, 2])
    assert not tab[lts + 3 * nl:].any()


@pytest.mark.parametrize("aliasing", [False, True])
def test_pallas_lowers_to_triton(demo_scene, aliasing):
    """The kernel lowers for CUDA through the Triton route (this catches an
    operation the Triton lowering lacks; PTX codegen runs on the card)."""
    cam = rt.default_camera((24, 16))

    def f(c, s):
        return rp._render_image_pallas(c, s, depth=2, aliasing=aliasing,
                                       compat=True, interpret=False,
                                       x_offset=0.0, local_width=None)

    text = jax.jit(f).trace(cam, demo_scene).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.gpu
@pytest.mark.parametrize("aliasing", [False, True])
def test_pallas_compiled_matches_jnp(gpu, demo_scene, aliasing):
    """The compiled kernel on the card == the jnp path on the card."""
    cam = rt.default_camera((128, 96))
    ref = np.asarray(rt.to_framebuffer(rt.render_image(
        cam, demo_scene, depth=2, aliasing=aliasing))).astype(int)
    out = np.asarray(rt.to_framebuffer(render_image_pallas(
        cam, demo_scene, depth=2, aliasing=aliasing))).astype(int)
    assert (np.abs(out - ref).max(axis=0) > 1).mean() <= 1e-3
