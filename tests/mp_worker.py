"""Multi-process worker for the real multi-host test (see test_parallel.py).

Launched as ``python tests/mp_worker.py <process_id> <port>`` — two of these
form a 2-process x 2-local-device JAX cluster over loopback (Gloo), the CPU
stand-in for several hosts on a network. Each process renders its shards
of the demo scene over the GLOBAL 4-device mesh via the production sharded
path, assembles the framebuffer with ``gather_framebuffer`` (the tiled
``all_gather`` collective — reference analogue ``copy_to_host``,
/root/reference/src/main.py:51), and checks it against an unsharded local
render. Prints ``MP_OK <pid>`` on success.
"""
import os
import sys

pid, port = int(sys.argv[1]), sys.argv[2]
check_train = len(sys.argv) > 3 and sys.argv[3] == "train"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from python_ray_tracer_jax.parallel.distributed import (gather_framebuffer,  # noqa: E402
                                                        initialize)

initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
           process_id=pid)

import python_ray_tracer_jax as rt  # noqa: E402
from python_ray_tracer_jax.parallel.mesh import make_mesh  # noqa: E402
from python_ray_tracer_jax.parallel.render_sharded import render_image_sharded  # noqa: E402

assert jax.process_count() == 2, jax.process_count()
assert jax.local_device_count() == 2, jax.local_device_count()
assert jax.device_count() == 4, jax.device_count()

scene = rt.default_scene()
cam = rt.default_camera((32, 16))
mesh = make_mesh()  # all 4 devices, spanning both processes

img = render_image_sharded(cam, scene, mesh, depth=1, aliasing=True)
# the render must actually be distributed: this process holds only its shards
assert not img.is_fully_addressable

fb = gather_framebuffer(img, mesh)
assert fb.shape == (32, 16, 3), fb.shape
ref = np.asarray(rt.render_image(cam, scene, depth=1, aliasing=True))
np.testing.assert_allclose(fb, ref, atol=2e-5)

# host-level fallback path (no mesh passed): multihost_utils.process_allgather
fb2 = gather_framebuffer(img)
np.testing.assert_allclose(fb2, ref, atol=2e-5)

if check_train:
    # Training collective ("train" argv flag — the cross-process autodiff
    # traces are heavy, so this runs under the slow test only): value_and_grad
    # of the sharded render-to-loss — the shard_map transpose psums loss and
    # replicated-scene grads ACROSS the real process boundary; both must match
    # the single-device values.
    import dataclasses  # noqa: E402

    from python_ray_tracer_jax import train  # noqa: E402
    from python_ray_tracer_jax.parallel.mesh import image_sharding  # noqa: E402
    from python_ray_tracer_jax.parallel.render_sharded import make_loss_fn  # noqa: E402

    target = rt.render_image(cam, scene, depth=1, aliasing=False)
    target_sh = jax.device_put(target, image_sharding(mesh))
    perturbed = dataclasses.replace(
        scene, spheres=dataclasses.replace(scene.spheres,
                                           center=scene.spheres.center + 0.05))
    loss_sh, grads_sh = jax.value_and_grad(
        make_loss_fn(cam, target_sh, mesh, depth=1, aliasing=False))(perturbed)
    loss_1, grads_1 = jax.value_and_grad(
        train.pixel_loss(cam, target, depth=1))(perturbed)
    assert abs(float(loss_sh) - float(loss_1)) < 1e-5 * abs(float(loss_1))
    for a, b in zip(jax.tree_util.tree_leaves(grads_sh),
                    jax.tree_util.tree_leaves(grads_1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-2,
                                   atol=1e-5)

print(f"MP_OK {pid}", flush=True)
