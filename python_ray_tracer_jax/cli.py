"""Command-line driver — the reference's ``main.py`` re-imagined.

``python -m python_ray_tracer_jax.cli render`` reproduces the reference driver's
end-to-end flow (main.py:8-55): build the demo scene, render with the reference's
settings (1000x1000, amb=0, lamb=0.6, refl=0.3, depth=2, AA on), print an honestly
synced wall-clock time, and save a PNG. The ``fit`` and ``animate`` subcommands
expose what the reference lacks (inverse rendering, batched orbit frames), with
every knob from :class:`RenderConfig` as a flag instead of a hardcoded local.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import (Camera, default_scene, random_scene, render_image, to_framebuffer,
               save_png, time_fn, rays_per_image, Materials, MetricsLogger)
from .utils.config import RenderConfig, enable_compile_cache, resolve_backend


def _add_render_args(p: argparse.ArgumentParser) -> None:
    d = RenderConfig()
    p.add_argument("--width", type=int, default=d.width)
    p.add_argument("--height", type=int, default=d.height)
    p.add_argument("--ambient", type=float, default=d.ambient)
    p.add_argument("--lambert", type=float, default=d.lambert)
    p.add_argument("--reflection", type=float, default=d.reflection)
    p.add_argument("--depth", type=int, default=d.depth)
    p.add_argument("--no-aliasing", action="store_true")
    p.add_argument("--fov", type=float, default=d.fov)
    p.add_argument("--clean", action="store_true",
                   help="disable reference-quirk compat mode")
    p.add_argument("--backend", choices=["auto", "jnp", "pallas"],
                   default=d.backend,
                   help="auto = the fused pallas kernel on a GPU, jnp "
                        "elsewhere; pallas needs a GPU")
    p.add_argument("--soft", type=float, default=0.0, metavar="TAU",
                   help="render with the soft-visibility renderer at this tau")
    p.add_argument("--spheres", type=int, default=0,
                   help="random N-sphere scene instead of the demo scene")
    p.add_argument("--out", type=str, default="output/render.png")


def _build(args):
    cfg = RenderConfig(width=args.width, height=args.height, ambient=args.ambient,
                       lambert=args.lambert, reflection=args.reflection,
                       depth=args.depth, aliasing=not args.no_aliasing, fov=args.fov,
                       compat=not args.clean,
                       backend=resolve_backend(args.backend))
    mats = Materials.build(cfg.ambient, cfg.lambert, cfg.reflection,
                           cfg.specular, cfg.shininess)
    if args.spheres > 0:
        import jax
        scene = random_scene(jax.random.key(0), args.spheres, materials=mats)
    else:
        scene = default_scene(mats)
    cam = Camera.build((cfg.width, cfg.height), cfg.camera_position,
                       cfg.camera_euler, cfg.fov)
    return cfg, scene, cam


def _render_fn(cfg, soft_tau=0.0):
    """Resolve the render callable. The chosen pipeline is recorded on the
    closure as ``fn.kind`` ("soft" | "pallas" | "jnp") so callers never
    re-derive the dispatch decision."""
    if soft_tau > 0.0:
        from .ops.soft import render_image_soft

        def fn(cam, scene):
            return render_image_soft(cam, scene, tau=soft_tau)
        fn.kind = "soft"
        return fn
    if cfg.backend == "pallas":
        from .ops.pallas.render_pallas import render_image_pallas

        def fn(cam, scene):
            return render_image_pallas(cam, scene, depth=cfg.depth,
                                       aliasing=cfg.aliasing, compat=cfg.compat)
        fn.kind = "pallas"
        return fn

    def fn(cam, scene):
        return render_image(cam, scene, depth=cfg.depth, aliasing=cfg.aliasing,
                            compat=cfg.compat, row_chunk=cfg.row_chunk)
    fn.kind = "jnp"
    return fn


def cmd_render(args) -> int:
    cfg, scene, cam = _build(args)
    fn = _render_fn(cfg, soft_tau=args.soft)
    secs = time_fn(fn, cam, scene, warmup=1, iters=5)
    img = fn(cam, scene)
    n_rays = rays_per_image(cfg.width, cfg.height, depth=cfg.depth,
                            aliasing=cfg.aliasing, n_lights=scene.lights.count)
    print(f"time: {secs * 1000:,.1f} ms  "
          f"({n_rays / secs / 1e6:,.1f} Mrays/s, {cfg.width}x{cfg.height}, "
          f"backend={fn.kind})")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_png(np.asarray(to_framebuffer(img)), args.out)
    print(f"saved {args.out}")
    return 0


def _loss_span(losses) -> str:
    """first -> last loss for the fit summary; tolerates --steps 0."""
    if not losses:
        return "(0 steps)"
    return f"{losses[0]:.3e} -> {losses[-1]:.3e}"


def cmd_fit(args) -> int:
    """Inverse-render demo (BASELINE configs[3]): perturb sphere positions in the
    demo scene, recover them by pixel-gradient descent.

    ``--mode soft`` (default) uses the soft-visibility renderer with coarse-to-fine
    tau annealing — robust even on the crowded 6-sphere demo scene, whose
    silhouette-dominated loss misleads hard-visibility a.e. gradients. ``--mode
    hard`` optimizes through the hard renderer (works on well-separated scenes).
    ``--mode camera`` fixes the scene and recovers a perturbed camera pose
    instead (train.fit_camera).
    """
    import dataclasses
    import jax.numpy as jnp
    from . import Scene, Spheres, Planes, Lights, GREY, RED, BLUE
    from . import train

    cfg, scene, cam = _build(args)
    if args.mode in ("hard", "camera"):
        if args.spheres > 0:
            pass  # the user configured a specific scene: fit THAT scene
        else:
            # Hard-visibility gradients need a well-separated scene to
            # converge (the crowded demo scene's silhouette-dominated loss
            # misleads them) — say so instead of swapping silently.
            print(f"[fit] --mode {args.mode}: using the built-in 2-sphere "
                  f"well-separated scene (hard-visibility gradients mislead "
                  f"on the crowded demo scene); pass --spheres N to fit a "
                  f"scene of your own", file=sys.stderr)
            mats = Materials.build(cfg.ambient, cfg.lambert, cfg.reflection)
            scene = Scene(
                Spheres.build([([2.5, 0.5, 1.0], 0.8, RED),
                               ([1.5, -0.9, 0.5], 0.5, BLUE)]),
                Planes.build([([5, 0, 0], [0, 0, 1], GREY)]),
                Lights.build([[2.5, -2.0, 3.0], [2.5, 2.0, 3.0]]), mats)
    if args.mode == "camera":
        target = render_image(cam, scene, depth=cfg.depth, aliasing=False,
                              compat=cfg.compat)
        init_cam = Camera.build(cam.resolution,
                                np.asarray(cam.position) + [0.1, -0.08, 0.08],
                                [1.5, -27.5, 2.0], float(cam.fov))
        logger = MetricsLogger("fit")
        fitted, losses = train.fit_camera(init_cam, scene, target,
                                          steps=args.steps, lr=args.lr,
                                          depth=cfg.depth,
                                          compat=cfg.compat, logger=logger)
        p0 = float(np.abs(np.asarray(init_cam.position) -
                          np.asarray(cam.position)).max())
        p1 = float(np.abs(np.asarray(fitted.position) -
                          np.asarray(cam.position)).max())
        print(f"loss: {_loss_span(losses)}  "
              f"camera pos err: {p0:.3f} -> {p1:.4f}")
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            img = render_image(fitted, scene, depth=cfg.depth, aliasing=False,
                               compat=cfg.compat)
            save_png(np.asarray(to_framebuffer(img)), args.out)
        return 0
    init = dataclasses.replace(
        scene, spheres=dataclasses.replace(
            scene.spheres,
            center=scene.spheres.center + jnp.asarray([0.2, -0.15, 0.1])))
    logger = MetricsLogger("fit")
    if args.mode == "soft":
        fitted, losses = train.fit_scene_soft(init, cam, scene, steps=args.steps,
                                              lr=args.lr, logger=logger,
                                              bounce_depth=args.bounce_depth)
    else:
        target = render_image(cam, scene, depth=cfg.depth, aliasing=False,
                              compat=cfg.compat)
        fitted, losses = train.fit_scene(init, cam, target, steps=args.steps,
                                         lr=args.lr, depth=cfg.depth,
                                         compat=cfg.compat, logger=logger,
                                         trainable=("spheres.center",))
    import numpy as _np
    errs = _np.linalg.norm(_np.asarray(fitted.spheres.center -
                                       scene.spheres.center), axis=1)
    err0 = float(jnp.abs(init.spheres.center - scene.spheres.center).max())
    print(f"loss: {_loss_span(losses)}  "
          f"center err: {err0:.3f} -> median {float(_np.median(errs)):.4f} "
          f"/ max {errs.max():.4f}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        img = render_image(cam, fitted, depth=cfg.depth, aliasing=False,
                           compat=cfg.compat)
        save_png(np.asarray(to_framebuffer(img)), args.out)
    return 0


def cmd_animate(args) -> int:
    """Orbit-animation demo: render N frames around the scene in jit-unrolled
    blocks over a stacked camera trajectory (animation.render_frames; blocks of
    12 amortize dispatch without tracing one huge program) and save a GIF."""
    from . import animation

    cfg, scene, _ = _build(args)
    cams = animation.orbit_cameras((cfg.width, cfg.height),
                                   center=[1.0, 0.0, 1.0], radius=4.0,
                                   height=1.5, n_frames=args.frames,
                                   fov=cfg.fov)
    secs = time_fn(lambda: animation.render_frames(
        cams, scene, depth=cfg.depth, aliasing=cfg.aliasing, compat=cfg.compat,
        backend=cfg.backend)[0], warmup=1, iters=3)
    frames = animation.render_frames(cams, scene, depth=cfg.depth,
                                     aliasing=cfg.aliasing, compat=cfg.compat,
                                     backend=cfg.backend)
    print(f"{args.frames} frames in {secs * 1000:,.1f} ms "
          f"({secs * 1000 / args.frames:,.2f} ms/frame, backend={cfg.backend})")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    animation.save_animation(frames, args.out, fps=args.fps)
    print(f"saved {args.out}")
    return 0


def main(argv=None) -> int:
    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="python_ray_tracer_jax")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a scene to PNG")
    _add_render_args(pr)
    pf = sub.add_parser("fit", help="inverse-render demo (fit perturbed scene back)")
    _add_render_args(pf)
    pf.set_defaults(out="output/fit.png")  # don't clobber render's default PNG
    pf.add_argument("--steps", type=int, default=150)
    pf.add_argument("--lr", type=float, default=1e-2)
    pf.add_argument("--mode", choices=["soft", "hard", "camera"], default="soft")
    pf.add_argument("--bounce-depth", type=int, default=0, choices=[0, 1],
                    help="soft mode: add a depth-1 mirror bounce (makes "
                         "reflection trainable)")
    pa = sub.add_parser("animate", help="orbit-animation GIF (batched frames)")
    _add_render_args(pa)
    pa.set_defaults(out="output/orbit.gif")
    pa.add_argument("--frames", type=int, default=24)
    pa.add_argument("--fps", type=int, default=12)
    args = ap.parse_args(argv)
    if args.cmd == "render":
        return cmd_render(args)
    if args.cmd == "fit":
        return cmd_fit(args)
    if args.cmd == "animate":
        return cmd_animate(args)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
