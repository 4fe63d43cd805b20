"""Smoke run of the main path on one GPU: render, oracle parity, fit.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the ray-sharded phase only

One process does every phase and raises on the first failure. The findings go
to stdout line by line; the last line is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only after every phase has passed. Without a GPU the script exits
non-zero before any phase runs.

Phases (one card):

1. device — platform, device kind and count, the card's name and power limit
   from ``nvidia-smi``, the JAX version and the compile-cache directory;
2. frame — ``cli render`` at 1920x1080 (demo scene, 3x3 AA, depth 2, compat),
   then the fused kernel against XLA's build of the jnp path at 1080p in four
   cases, on uint8 framebuffers: at most 0.1% of pixels may differ by more than
   one level (near-tie closest-hit flips at silhouettes under a different
   float32 association), with the median time of each path;
3. oracle — the jnp path on the card against the scalar float64 oracle
   (tests/oracle.py) at 64x64: at least 99.5% of uint8 values equal;
4. fit, which runs first so that the peak memory it reports is its own — one
   jitted XLA-autodiff train step at 1080p with its median time and peak
   memory, a few steps of ``train.fit_scene``, ``fit_camera`` and
   ``fit_scene_soft`` (each loss must fall, every gradient finite), and
   ``render_image_fast`` gradients against ``jax.grad`` of the jnp path.

Four cards: a 4K, 3x3 AA, 100-sphere render sharded over the rays with the
kernel on every card, assembled with ``gather_framebuffer`` and compared with
the single-card render; then one psum'd ``make_loss_fn`` loss and gradient
against the single-card ones.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

FLIP_LEVELS = 1           # a pixel "flips" when a channel moves more than this
FLIP_FRACTION = 1e-3      # at most this share of pixels may flip
ORACLE_AGREE = 0.995      # share of uint8 values equal to the float64 oracle


def say(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, *args, iters: int):
    from python_ray_tracer_jax.utils.timing import time_samples

    samples = time_samples(fn, *args, warmup=1, iters=iters)
    return float(np.median(samples)) * 1e3, len(samples)


def framebuffer(img) -> np.ndarray:
    import python_ray_tracer_jax as rt

    return np.asarray(rt.to_framebuffer(img)).astype(np.int32)


def check_flips(name: str, a, b) -> None:
    """Raise unless float images ``a`` and ``b`` agree as uint8 framebuffers."""
    fa, fb = framebuffer(a), framebuffer(b)
    if fa.shape != fb.shape:
        raise AssertionError(f"{name}: shapes {fa.shape} != {fb.shape}")
    d = np.abs(fa - fb).max(axis=0)
    flipped = int((d > FLIP_LEVELS).sum())
    share = flipped / d.size
    say(f"  {name}: {flipped} of {d.size} pixels differ by more than "
        f"{FLIP_LEVELS} level ({share:.5%}, limit {FLIP_FRACTION:.1%}); "
        f"max {int(d.max())} levels")
    if share > FLIP_FRACTION:
        raise AssertionError(f"{name}: {share:.4%} of pixels flipped")


def check_grads(name: str, got, refs, atol: float = 0.0) -> None:
    """Raise unless gradient pytree ``got`` matches ``refs[0]`` within rtol
    1e-4 and ``atol`` plus twice the spread between the reference runs.

    On the card the jnp gradients' scatter-adds (the transpose of the per-ray
    gathers) accumulate with atomics, in no fixed order, into sums with heavy
    cancellation, so two runs of one program differ; a difference of that
    size is no fault."""
    import jax

    worst = 0.0
    for a, *bs in zip(*(jax.tree_util.tree_leaves(g) for g in (got, *refs))):
        a, bs = np.asarray(a), np.stack([np.asarray(b) for b in bs])
        spread = float((bs.max(axis=0) - bs.min(axis=0)).max())
        worst = max(worst, spread / max(float(np.abs(bs[0]).max()), 1e-30))
        np.testing.assert_allclose(a, bs[0], rtol=1e-4,
                                   atol=atol + 2.0 * spread, err_msg=name)
    say(f"  {name}: gradients match (rtol 1e-4, atol {atol:g} plus twice the "
        f"reference's run-to-run spread, at most {worst:.2e} of a leaf's "
        f"largest entry)")


def phase_device(count: int):
    import jax

    from python_ray_tracer_jax.utils.config import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {devs[0].platform!r}")
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, JAX sees {len(devs)}")
    say(f"[device] {devs[0].device_kind}, {len(devs)} visible, using {count}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    for line in smi.stdout.strip().splitlines():
        say(f"[device] nvidia-smi: {line.strip()}")
    say(f"[device] jax {jax.__version__}, compile cache {cache}")
    return devs[:count]


def phase_frame(width: int = 1920, height: int = 1080,
                interpret: bool = False) -> None:
    import jax

    import python_ray_tracer_jax as rt
    from python_ray_tracer_jax.cli import main as cli_main

    out = os.path.join("output", f"render_{width}x{height}.png")
    say(f"[frame] cli render {width}x{height}, demo scene, AA, depth 2, compat")
    if cli_main(["render", "--width", str(width), "--height", str(height),
                 "--out", out]) != 0:
        raise AssertionError("cli render failed")
    if not os.path.getsize(out):
        raise AssertionError(f"{out} is empty")

    demo = rt.default_scene()
    clean = dataclasses.replace(
        demo, materials=rt.Materials.build(specular=0.5, shininess=32.0))
    dense = rt.random_scene(jax.random.key(0), 100)
    cam = rt.default_camera((width, height))
    cases = [("demo AA depth 2", demo, 2, True, True),
             ("demo no-AA depth 2", demo, 2, False, True),
             ("clean specular 0.5 depth 4", clean, 4, False, False),
             ("100 spheres no-AA depth 2", dense, 2, False, True)]
    for name, scene, depth, aa, compat in cases:
        kw = dict(depth=depth, aliasing=aa, compat=compat)
        kernel = jax.jit(lambda c, s, kw=kw: rt.render_image_pallas(
            c, s, interpret=interpret, **kw))
        xla = jax.jit(lambda c, s, kw=kw: rt.render_image(c, s, **kw))
        a, b = kernel(cam, scene), xla(cam, scene)
        check_flips(name, a, b)
        if not np.isfinite(np.asarray(a)).all():
            raise AssertionError(f"{name}: kernel output is not finite")
        k_ms, k_n = median_ms(kernel, cam, scene, iters=20)
        x_ms, x_n = median_ms(xla, cam, scene, iters=5)
        say(f"  {name}: kernel {k_ms:.3f} ms (median of {k_n}), "
            f"XLA {x_ms:.3f} ms (median of {x_n}), "
            f"{x_ms / k_ms:.1f}x")


def phase_oracle(size: int = 64) -> None:
    import python_ray_tracer_jax as rt
    from tests import oracle

    soa = oracle.default_scene_soa()
    fb_o = oracle.render(oracle.OracleScene(*soa), size, size, [-2, 0, 2],
                         [0, -30, 0], depth=2, aliasing=True)
    sph, li, pln = (np.asarray(x, np.float32) for x in soa)
    scene = rt.Scene.from_soa(sph, li, pln, rt.Materials.build(0.0, 0.6, 0.3))
    cam = rt.Camera.build((size, size), [-2, 0, 2], [0, -30, 0])
    fb_j = np.asarray(rt.to_framebuffer(rt.render_image(
        cam, scene, depth=2, aliasing=True, compat=True)))
    agree = float((fb_j == np.asarray(fb_o)).mean())
    say(f"[oracle] {size}x{size} demo AA depth 2: {agree:.4%} of uint8 values "
        f"equal the float64 oracle (limit {ORACLE_AGREE:.1%})")
    if agree < ORACLE_AGREE:
        raise AssertionError(f"oracle agreement {agree:.4%}")


def _finite_grads(name: str, grads) -> None:
    import jax

    leaves = jax.tree_util.tree_leaves(grads)
    if not all(np.isfinite(np.asarray(g)).all() for g in leaves):
        raise AssertionError(f"{name}: non-finite gradient")


def _falls(name: str, losses) -> None:
    say(f"  {name}: loss {losses[0]:.4e} -> {losses[-1]:.4e} "
        f"over {len(losses)} steps")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall")


def phase_fit(size: int = 256, width: int = 1920, height: int = 1080,
              interpret: bool = False) -> None:
    import jax
    import jax.numpy as jnp
    import optax

    import python_ray_tracer_jax as rt
    from python_ray_tracer_jax import train

    # One XLA-autodiff train step at full resolution, first, so that the
    # process's peak memory is this step's.
    big = rt.default_camera((width, height))
    scene = rt.default_scene()
    big_target = rt.render_image(big, scene, depth=2, aliasing=False,
                                 row_chunk=240)
    opt = optax.adam(1e-2)
    step = train.make_train_step(
        train.pixel_loss(big, big_target, depth=2, row_chunk=240), opt,
        ("spheres.center",))
    state = opt.init(scene)
    temp = step.lower(scene, state).compile().memory_analysis()
    ms, n = median_ms(step, scene, state, iters=5)
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    say(f"[fit] XLA train step {width}x{height} no-AA depth 2 row_chunk 240: "
        f"{ms:.3f} ms (median of {n}); peak device memory "
        f"{'not reported' if peak is None else f'{peak / 2**30:.3f} GiB'}; "
        f"compiled temp "
        f"{getattr(temp, 'temp_size_in_bytes', 0) / 2**30:.3f} GiB")

    say(f"[fit] {size}x{size} fits through train.*")
    two = rt.Scene(
        rt.Spheres.build([([2.5, 0.5, 1.0], 0.8, rt.RED),
                          ([1.5, -0.9, 0.5], 0.5, rt.BLUE)]),
        rt.Planes.build([([5, 0, 0], [0, 0, 1], rt.GREY)]),
        rt.Lights.build([[2.5, -2.0, 3.0], [2.5, 2.0, 3.0]]),
        rt.Materials.build())
    cam = rt.default_camera((size, size))
    moved = dataclasses.replace(two, spheres=dataclasses.replace(
        two.spheres, center=two.spheres.center + jnp.asarray([0.2, -0.15, 0.1])))

    target = rt.render_image(cam, two, depth=2, aliasing=False)
    loss = train.pixel_loss(cam, target, depth=2)
    _finite_grads("fit_scene", jax.grad(loss)(moved))
    _, losses = train.fit_scene(moved, cam, target, steps=10, lr=2e-2,
                                trainable=("spheres.center",))
    _falls("fit_scene", losses)

    target_c = rt.render_image(cam, two, depth=1, aliasing=False)
    init_cam = rt.Camera.build(cam.resolution, [-1.9, -0.08, 2.08],
                               [1.5, -27.5, 2.0])
    _finite_grads("fit_camera", jax.grad(
        lambda c: jnp.mean((rt.render_image(c, two, depth=1, aliasing=False)
                            - target_c) ** 2))(init_cam))
    _, losses = train.fit_camera(init_cam, two, target_c, steps=10, lr=1e-2)
    _falls("fit_camera", losses)

    demo = rt.default_scene(rt.Materials.build(ambient=0.2, lambert=0.6))
    soft_cam = rt.default_camera((size // 2, size // 2))
    soft_init = dataclasses.replace(demo, spheres=dataclasses.replace(
        demo.spheres, center=demo.spheres.center + 0.1))
    soft_target = rt.render_image_soft(soft_cam, demo, tau=0.05)
    _finite_grads("fit_scene_soft", jax.grad(
        train.soft_pixel_loss(soft_cam, soft_target, tau=0.05))(soft_init))
    _, losses = train.fit_scene_soft(soft_init, soft_cam, demo, steps=10,
                                     taus=(0.05,))
    _falls("fit_scene_soft", losses)

    # render_image_fast: kernel forward, jnp-autodiff backward. With a loss
    # linear in the image both gradients see the same cotangent.
    weights = jax.random.uniform(jax.random.key(1), (size, size, 3))

    def linear(render):
        return jax.jit(jax.grad(lambda s: jnp.sum(render(s) * weights)))

    grad_ref = linear(lambda s: rt.render_image(cam, s, depth=2))
    g_fast = linear(lambda s: rt.render_image_fast(
        cam, s, 2, True, True, interpret))(scene)
    check_grads(f"render_image_fast vs jnp at {size}x{size}", g_fast,
                [grad_ref(scene) for _ in range(3)])


def phase_four_cards(devices, width: int = 3840, height: int = 2160,
                     n_spheres: int = 100, loss_size=(960, 540),
                     interpret: bool = False) -> None:
    import jax

    import python_ray_tracer_jax as rt
    from python_ray_tracer_jax import train
    from python_ray_tracer_jax.parallel.distributed import gather_framebuffer
    from python_ray_tracer_jax.parallel.mesh import image_sharding, make_mesh
    from python_ray_tracer_jax.parallel.render_sharded import (
        make_loss_fn, render_image_sharded)

    mesh = make_mesh(devices)
    scene = rt.random_scene(jax.random.key(0), n_spheres)
    cam = rt.default_camera((width, height))
    say(f"[four] {width}x{height} AA depth 2, {n_spheres} spheres, kernel on "
        f"each of {len(devices)} cards")
    def sharded_render():
        return render_image_sharded(cam, scene, mesh, depth=2, aliasing=True,
                                    backend="pallas",
                                    pallas_interpret=interpret)

    def single_render():
        return rt.render_image_pallas(cam, scene, depth=2, aliasing=True,
                                      interpret=interpret)

    sharded = sharded_render()
    for shard in sharded.addressable_shards:
        say(f"  shard {shard.index[0]} on {shard.device}")
    if len({s.device for s in sharded.addressable_shards}) != len(devices):
        raise AssertionError("shards do not cover every card")
    assembled = gather_framebuffer(sharded, mesh=mesh)
    check_flips("sharded vs single-card", assembled, single_render())
    for name, fn in (("sharded", sharded_render), ("single-card", single_render)):
        ms, n = median_ms(fn, iters=3)
        say(f"  {name} {width}x{height} frame: {ms:.3f} ms (median of {n})")

    w, h = loss_size
    lcam = rt.default_camera((w, h))
    demo = rt.default_scene()
    moved = dataclasses.replace(demo, spheres=dataclasses.replace(
        demo.spheres, center=demo.spheres.center + 0.05))
    target = rt.render_image(lcam, demo, depth=2, aliasing=True)
    sharded_loss = make_loss_fn(lcam, jax.device_put(target,
                                                     image_sharding(mesh)),
                                mesh, depth=2, aliasing=True)
    loss_m, grads_m = jax.jit(jax.value_and_grad(sharded_loss))(moved)
    single_vg = jax.jit(jax.value_and_grad(train.pixel_loss(
        lcam, target, depth=2, aliasing=True, row_chunk=w // 4)))
    runs = [single_vg(moved) for _ in range(3)]
    loss_1 = float(runs[0][0])
    np.testing.assert_allclose(float(loss_m), loss_1, rtol=1e-5)
    say(f"  psum'd loss {float(loss_m):.6e} == single-card {loss_1:.6e} "
        f"(rtol 1e-5) at {w}x{h}")
    check_grads("psum'd vs single-card", grads_m, [g for _, g in runs],
                atol=1e-7)


def ok_line(devices) -> str:
    """The last line: the devices the phases ran on, as JAX reports them."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {"platform": d.platform,
                                              "kind": d.device_kind,
                                              "count": len(devices)}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the ray-sharded phase on four cards, and "
                         "nothing else")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    count = 4 if args.four_cards else 1
    devices = phase_device(count)
    phases = ([lambda: phase_four_cards(devices)] if args.four_cards
              else [phase_fit, phase_frame, phase_oracle])
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        say(f"[time] {time.perf_counter() - t0:.1f} s, compilation included")
    print(ok_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
