"""Gradient correctness: autodiff vs central finite differences.

The reference has no backward pass at all (SURVEY §4), so gradients are verified
against numerics. The masked renderer's gradient is the almost-everywhere derivative:
it is exact for parameters that don't move visibility boundaries (albedos, material
scalars) and for geometry parameters as long as the probed pixels stay strictly on
one side of every silhouette/shadow edge. Tests are split accordingly:

  * global-loss FD checks for smooth parameters;
  * interior-region FD checks for geometry (sphere center/radius, light position) on
    a scene designed so no boundary crosses the region under the FD stencil;
  * NaN/Inf-freedom for the full pipeline (AA + depth-4 bounces).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import python_ray_tracer_jax as rt


def _fd(f, x0, bump, eps):
    return (float(f(bump(x0, +eps))) - float(f(bump(x0, -eps)))) / (2 * eps)


# --- smooth parameters: global loss ---------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cam = rt.default_camera((24, 24))
    scene = rt.default_scene()
    def loss(s):
        return jnp.sum(rt.render_image(cam, s, depth=2, aliasing=False) ** 2)
    return cam, scene, loss


@pytest.mark.parametrize("path,idx", [
    (("spheres", "albedo"), (0, 1)),
    (("spheres", "albedo"), (5, 0)),
    (("planes", "albedo"), (0, 0)),
])
def test_albedo_grads_global(setup, path, idx):
    cam, scene, loss = setup
    g = jax.grad(loss)(scene)
    auto = float(getattr(getattr(g, path[0]), path[1])[idx])

    def bump(s, e):
        sub = getattr(s, path[0])
        leaf = getattr(sub, path[1]).at[idx].add(e)
        return dataclasses.replace(s, **{path[0]: dataclasses.replace(
            sub, **{path[1]: leaf})})
    fd = _fd(loss, scene, bump, 1e-3)
    assert auto == pytest.approx(fd, rel=0.02, abs=0.05), (auto, fd)


@pytest.mark.parametrize("field", ["ambient", "lambert", "reflection"])
def test_material_grads_global(setup, field):
    cam, scene, loss = setup
    g = jax.grad(loss)(scene)
    auto = float(getattr(g.materials, field))

    def bump(s, e):
        m = dataclasses.replace(s.materials,
                                **{field: getattr(s.materials, field) + e})
        return dataclasses.replace(s, materials=m)
    fd = _fd(loss, scene, bump, 1e-3)
    assert auto == pytest.approx(fd, rel=0.02, abs=1e-2), (auto, fd)


# --- geometry parameters: interior region, boundary-free ------------------------

@pytest.fixture(scope="module")
def geo_setup():
    """One big head-on sphere; loss over the central pixel block only, far from the
    silhouette and from any shadow edge (single light behind the camera)."""
    scene = rt.Scene(
        rt.Spheres.build([([4.0, 0.0, 0.0], 1.5, rt.RED)]),
        rt.Planes.build([([10.0, 0.0, 0.0], [-1.0, 0.0, 0.0], rt.GREY)]),
        rt.Lights.build([[-2.0, 1.0, 1.0]]),
        rt.Materials.build(ambient=0.1, lambert=0.7, reflection=0.2))
    cam = rt.Camera.build((32, 32), [0.0, 0.0, 0.0], [0.0, 0.0, 0.0])

    def loss(s):
        img = rt.render_image(cam, s, depth=1, aliasing=False)
        return jnp.sum(img[12:20, 12:20] ** 2)
    return cam, scene, loss


@pytest.mark.parametrize("path,idx,eps", [
    (("spheres", "center"), (0, 0), 1e-3),
    (("spheres", "center"), (0, 1), 1e-3),
    (("spheres", "center"), (0, 2), 1e-3),
    (("spheres", "radius"), (0,), 1e-3),
    (("lights", "position"), (0, 1), 1e-3),
    (("lights", "position"), (0, 2), 1e-3),
])
def test_geometry_grads_interior(geo_setup, path, idx, eps):
    cam, scene, loss = geo_setup
    g = jax.grad(loss)(scene)
    auto = float(getattr(getattr(g, path[0]), path[1])[idx])

    def bump(s, e):
        sub = getattr(s, path[0])
        leaf = getattr(sub, path[1]).at[idx].add(e)
        return dataclasses.replace(s, **{path[0]: dataclasses.replace(
            sub, **{path[1]: leaf})})
    fd = _fd(loss, scene, bump, eps)
    assert auto == pytest.approx(fd, rel=0.05, abs=0.05), (auto, fd)


def test_camera_grads_interior(geo_setup):
    _, scene, _ = geo_setup

    def loss_cam(cam):
        img = rt.render_image(cam, scene, depth=1, aliasing=False)
        return jnp.sum(img[12:20, 12:20] ** 2)

    cam0 = rt.Camera.build((32, 32), [0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    g = jax.grad(loss_cam)(cam0)
    auto = float(g.position[1])
    fd = _fd(loss_cam, cam0,
             lambda c, e: dataclasses.replace(c, position=c.position.at[1].add(e)),
             1e-3)
    assert auto == pytest.approx(fd, rel=0.05, abs=0.05), (auto, fd)
    assert np.isfinite(np.asarray(g.rotation)).all()
    assert np.isfinite(float(g.fov))


# --- robustness ------------------------------------------------------------------

@pytest.mark.slow  # depth-4 AA autodiff compile ~30 s; depth-2 NaN coverage
def test_no_nan_grads_full_pipeline(setup):  # stays fast via the other tests
    cam, scene, _ = setup
    def loss(s):
        return jnp.sum(rt.render_image(cam, s, depth=4, aliasing=True) ** 2)
    g = jax.grad(loss)(scene)
    for leaf in jax.tree_util.tree_leaves(g):
        assert not bool(jnp.isnan(leaf).any())
        assert not bool(jnp.isinf(leaf).any())


def test_grads_nonzero_where_expected(setup):
    cam, scene, loss = setup
    g = jax.grad(loss)(scene)
    assert float(jnp.abs(g.spheres.center).sum()) > 0
    assert float(jnp.abs(g.lights.position).sum()) > 0
    assert float(jnp.abs(g.materials.lambert)) > 0


def _tangent_sphere_loss(x):
    """A ray exactly tangent to sphere 1 (discriminant exactly 0) whose
    closest hit is sphere 0: sphere 1's distance gets a zero cotangent."""
    o = jnp.asarray([0.0, 1.0, 0.0]) + x
    d = jnp.asarray([1.0, 0.0, 0.0])
    center = jnp.asarray([[2.0, 1.0, 0.0], [5.0, 0.0, 0.0]])
    t, valid = rt.intersect_spheres(o, d, center, jnp.asarray([0.5, 1.0]))
    assert bool(valid[1])
    return jnp.min(t)


def _parallel_plane_loss(x):
    """A ray so close to parallel that 1/denom**2 overflows float32; the plane
    is masked out (|d . n| < eps), so its distance gets a zero cotangent."""
    o = jnp.asarray([0.0, 0.0, 1.0])
    d = jnp.asarray([1.0, 0.0, 1e-20]) + x
    origin = jnp.asarray([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    normal = jnp.asarray([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0]])
    t, valid = rt.intersect_planes(o, d, origin, normal)
    return jnp.sum(jnp.where(valid, t, 0.0))


@pytest.mark.parametrize("loss", [_tangent_sphere_loss, _parallel_plane_loss])
def test_degenerate_intersection_grads_finite(loss):
    """Derivative singularities on branches that do not win stay out of the
    gradient: a tangent ray and a near-parallel plane must not turn the
    gradient into NaN (on the GPU the fused jit of a camera fit met one)."""
    g = jax.grad(loss)(jnp.zeros(3))
    assert np.isfinite(np.asarray(g)).all(), g
