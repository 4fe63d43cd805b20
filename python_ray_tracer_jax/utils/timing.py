"""Honest device timing + ray-throughput accounting.

The reference's self-timer brackets an *asynchronous* kernel launch without a device
sync (main.py:44-49), so its printed milliseconds can under-report arbitrarily. Here
every timed region calls ``jax.block_until_ready`` on the result, after a warm-up
call that absorbs compilation — the reference's warm-up-then-time pattern
(main.py:41-48) done correctly.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, List

import jax


def time_samples(fn: Callable, *args, warmup: int = 1, iters: int = 5,
                 **kwargs) -> List[float]:
    """Wall-clock seconds of each of ``iters`` calls, after ``warmup`` calls.

    Every call is timed alone and ends in ``jax.block_until_ready`` on its
    result, so a sample covers dispatch plus the device's work for that call.
    The warm-up absorbs compilation."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        samples.append(time.perf_counter() - t0)
    return samples


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 5,
            **kwargs) -> float:
    """Median of :func:`time_samples`: seconds per call."""
    return statistics.median(time_samples(fn, *args, warmup=warmup,
                                          iters=iters, **kwargs))


def rays_per_image(width: int, height: int, *, depth: int, aliasing: bool,
                   n_lights: int, primary_only: bool = False) -> int:
    """Count rays traced for one render.

    ``primary_only`` counts one ray per pixel (the Grays/s headline convention of
    BASELINE.md). Otherwise counts every traced ray: per pixel, S samples
    (9 interior / 1 border with AA), each sample casting (1 + depth) eye/bounce rays,
    each of which sweeps n_lights shadow rays on hit. Shadow rays are counted
    optimistically (every trace alive) — a stable upper-bound denominator.
    """
    if primary_only:
        return width * height
    if aliasing:
        interior = max(width - 2, 0) * max(height - 2, 0)
        samples = interior * 9 + (width * height - interior)
    else:
        samples = width * height
    per_sample = (1 + depth) * (1 + n_lights)
    return samples * per_sample
