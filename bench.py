"""Benchmark harness: the demo scene at 1080p on one GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, "secondary": {...}}

Headline metric: primary-ray forward throughput at 1080p (demo scene, reflection
depth 2, no AA, fused kernel) in Mrays/s on one card. ``secondary`` carries the
median milliseconds of the kernel with 3x3 AA (the reference driver's default) and
at depth 0, of XLA's build of the jnp path, and of one jitted XLA-autodiff train
step (no AA, depth 2, ``row_chunk=240``).

Timing: ``utils.timing.time_samples`` — each call timed alone and ended with
``block_until_ready``, after a warm-up call that absorbs compilation; the median
of the samples is reported. Exits 1 without a JSON line when JAX finds no GPU: a
CPU number is not a device measurement.
"""
from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    import python_ray_tracer_jax as rt
    from python_ray_tracer_jax.utils.config import enable_compile_cache
    from python_ray_tracer_jax.utils.timing import time_fn

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX's first device is {dev.platform!r}")
        return 1
    log(f"device: {dev.device_kind} x{len(jax.devices())}")

    w, h = 1920, 1080
    scene = rt.default_scene()
    camera = rt.Camera.build((w, h), [-2.0, 0.0, 2.0], [0.0, -30.0, 0.0])
    primary = w * h
    secondary = {}

    def kernel(depth, aliasing):
        return lambda: rt.render_image_pallas(camera, scene, depth=depth,
                                              aliasing=aliasing, compat=True)

    headline = None
    for key, depth, aa in [("kernel_depth2_ms", 2, False),
                           ("kernel_depth0_ms", 0, False),
                           ("kernel_depth2_aa_ms", 2, True)]:
        secs = time_fn(kernel(depth, aa), warmup=1, iters=20)
        log(f"{key}: {secs * 1e3:.3f} ms")
        secondary[key] = secs * 1e3
        if headline is None:
            headline = primary / secs / 1e6

    jnp_secs = time_fn(lambda: rt.render_image(camera, scene, depth=2,
                                               aliasing=False, compat=True),
                       warmup=1, iters=5)
    log(f"xla_depth2_ms: {jnp_secs * 1e3:.3f} ms")
    secondary["xla_depth2_ms"] = jnp_secs * 1e3

    target = rt.render_image(camera, scene, depth=2, aliasing=False,
                             compat=True, row_chunk=240)
    loss_grad = jax.jit(jax.value_and_grad(
        lambda s: jnp.mean((rt.render_image(camera, s, depth=2, aliasing=False,
                                            compat=True, row_chunk=240)
                            - target) ** 2)))
    step_secs = time_fn(loss_grad, scene, warmup=1, iters=5)
    log(f"xla_train_step_ms: {step_secs * 1e3:.3f} ms")
    secondary["xla_train_step_ms"] = step_secs * 1e3

    print(json.dumps({
        "metric": "primary_Mrays_per_s_fwd_1080p",
        "value": headline,
        "unit": "Mrays/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "secondary": secondary,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
