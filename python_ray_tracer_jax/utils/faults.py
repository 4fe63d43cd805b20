"""Failure detection, fault injection, and elastic resume for training loops.

The reference is a single-GPU numba script with no failure story (SURVEY §5
records the subsystem as absent). A production multi-chip training service
needs three pieces, built here:

1. **Device health probe** — every device must round-trip a tiny jitted
   computation with a known answer. A wedged card or a lost host fails the
   probe in milliseconds instead of failing a
   long render/fit job minutes in.
2. **Non-finite-loss detection with elastic resume** — the fit loop
   checkpoints every K steps (path-keyed npz, utils/checkpoint.py) and on a
   NaN/Inf loss or a raised device error restores the last good state and
   continues, up to ``max_restarts``. Because the compute is functionally
   pure, a *deterministic* NaN (bad hyperparameters) reproduces on every
   restart — the loop detects that it is not making progress past the same
   step and surfaces the diagnosis instead of spinning.
3. **Deterministic fault injection** — so 1+2 are testable without real
   hardware failures (tests/test_faults.py).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .checkpoint import save_pytree, load_pytree


class InjectedFault(RuntimeError):
    """Raised by :class:`FaultInjector` in ``mode="exception"``."""


class UnrecoverableTraining(RuntimeError):
    """Raised when elastic resume exhausts ``max_restarts``."""


def device_healthcheck(devices: Optional[Sequence[jax.Device]] = None,
                       ) -> dict:
    """Probe each device with a tiny computation whose answer is known.

    Returns ``{device_str: ok_bool}``. A healthy device computes
    ``sum(iota(64)) == 2016`` on-device and returns it; any exception or a
    wrong answer (memory corruption) marks the device unhealthy. Cheap enough
    to run before every job and between fit stages.
    """
    devices = list(devices) if devices is not None else jax.devices()
    probe = jax.jit(lambda x: jnp.sum(x * jnp.arange(64, dtype=jnp.float32)))
    status = {}
    for d in devices:
        try:
            x = jax.device_put(jnp.ones((64,), jnp.float32), d)
            status[str(d)] = float(probe(x)) == 2016.0
        except Exception:
            status[str(d)] = False
    return status


@dataclasses.dataclass
class FaultInjector:
    """Deterministically corrupt chosen steps of a training loop.

    ``fail_steps`` are *global* step indices; each fires only once (a restarted
    loop re-executing the same step index does not re-fail), emulating a
    transient hardware fault. ``mode``:

    - ``"nan"``: the step's loss becomes NaN (silent-corruption class — what
      jax_debug_nans catches inside jit, surfaced here at the loop level);
    - ``"exception"``: raises :class:`InjectedFault` (device-loss class).
    """
    fail_steps: Sequence[int]
    mode: str = "nan"
    _fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int, loss: float) -> float:
        if step in self.fail_steps and step not in self._fired:
            self._fired.add(step)
            if self.mode == "exception":
                raise InjectedFault(f"injected device fault at step {step}")
            return float("nan")
        return loss


@dataclasses.dataclass
class RestartEvent:
    step: int            # step that failed
    reason: str
    restored_step: int   # last good checkpointed step resumed from


def resilient_fit(step_fn: Callable, scene, opt_state, *, steps: int,
                  ckpt_dir: str, ckpt_every: int = 20, max_restarts: int = 3,
                  injector: Optional[FaultInjector] = None,
                  on_restart: Optional[Callable] = None,
                  ) -> Tuple[object, object, List[float], List[RestartEvent]]:
    """Run ``step_fn(scene, opt_state) -> (scene, opt_state, loss)`` for
    ``steps`` steps with checkpointed elastic resume.

    On a non-finite loss or a raised step error the loop restores the last
    good checkpoint and re-runs from there; after ``max_restarts`` failures
    *at the same step* it raises :class:`UnrecoverableTraining` (purely
    functional compute means an identical re-failure is deterministic, not
    transient — retrying cannot help). ``on_restart(scene, opt_state, event)``
    may return modified ``(scene, opt_state)`` (e.g. a lower learning rate).

    Returns ``(scene, opt_state, losses, restart_events)``; ``losses`` has one
    entry per *successful* step.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "resilient.npz")

    def save(step):
        save_pytree(path, {"scene": scene, "opt": opt_state,
                           "step": jnp.asarray(step, jnp.int32)})

    def load():
        tree = load_pytree(path, {"scene": scene, "opt": opt_state,
                                  "step": jnp.asarray(0, jnp.int32)})
        return tree["scene"], tree["opt"], int(tree["step"])

    save(0)
    losses: List[float] = []
    events: List[RestartEvent] = []
    i = 0
    while i < steps:
        try:
            new_scene, new_opt, loss = step_fn(scene, opt_state)
            loss = float(loss)
            if injector is not None:
                loss = injector.maybe_fail(i, loss)
            if not math.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {i}: {loss}")
        except (FloatingPointError, InjectedFault, RuntimeError) as e:
            same_step_failures = sum(1 for ev in events if ev.step == i)
            if same_step_failures + 1 > max_restarts:
                raise UnrecoverableTraining(
                    f"step {i} failed {same_step_failures + 1}x "
                    f"(deterministic failure, restarts cannot help): {e}"
                ) from e
            scene, opt_state, restored = load()
            ev = RestartEvent(step=i, reason=f"{type(e).__name__}: {e}",
                              restored_step=restored)
            events.append(ev)
            del losses[restored:]
            i = restored
            if on_restart is not None:
                out = on_restart(scene, opt_state, ev)
                if out is not None:
                    scene, opt_state = out
            continue
        scene, opt_state = new_scene, new_opt
        losses.append(loss)
        i += 1
        if i % ckpt_every == 0:
            save(i)
    return scene, opt_state, losses, events
