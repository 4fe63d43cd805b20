"""Failure detection / fault injection / elastic resume (utils/faults.py).

The reference has no failure-handling subsystem (single-GPU script); these
tests pin this framework's: device health probes, NaN-loss detection with
checkpointed restart, exception-class faults, and the deterministic-failure
diagnosis when restarts cannot help."""
import jax
import jax.numpy as jnp
import optax
import pytest

import python_ray_tracer_jax as rt
from python_ray_tracer_jax import train
from python_ray_tracer_jax.utils.faults import (FaultInjector, InjectedFault,
                                                UnrecoverableTraining,
                                                device_healthcheck,
                                                resilient_fit)


def test_device_healthcheck_all_ok():
    status = device_healthcheck()
    assert status and all(status.values())


def _make_step(depth=0, res=(16, 16)):
    cam = rt.Camera.build(res, [-2.0, 0.0, 2.0], [0.0, -30.0, 0.0])
    scene = rt.default_scene()
    target = rt.render_image(cam, scene, depth=depth, aliasing=False)
    loss_fn = train.pixel_loss(cam, target, depth=depth)
    opt = optax.adam(1e-2)
    step = train.make_train_step(loss_fn, opt, trainable=("spheres.center",))
    return scene, opt.init(scene), step


def test_resilient_fit_recovers_from_nan(tmp_path):
    scene, opt_state, step = _make_step()
    inj = FaultInjector(fail_steps=[5], mode="nan")
    out_scene, _, losses, events = resilient_fit(
        step, scene, opt_state, steps=8, ckpt_dir=str(tmp_path),
        ckpt_every=2, injector=inj)
    assert len(losses) == 8 and all(jnp.isfinite(jnp.asarray(losses)))
    assert len(events) == 1
    assert events[0].step == 5 and events[0].restored_step == 4
    assert "non-finite" in events[0].reason


def test_resilient_fit_recovers_from_exception(tmp_path):
    scene, opt_state, step = _make_step()
    inj = FaultInjector(fail_steps=[3], mode="exception")
    _, _, losses, events = resilient_fit(
        step, scene, opt_state, steps=6, ckpt_dir=str(tmp_path),
        ckpt_every=2, injector=inj)
    assert len(losses) == 6
    assert len(events) == 1 and "InjectedFault" in events[0].reason


def test_resilient_fit_deterministic_failure_diagnosed(tmp_path):
    scene, opt_state, step = _make_step()

    class AlwaysFail(FaultInjector):
        def maybe_fail(self, step, loss):
            if step == 2:
                return float("nan")   # fires on every retry, not once
            return loss

    with pytest.raises(UnrecoverableTraining, match="deterministic"):
        resilient_fit(step, scene, opt_state, steps=5,
                      ckpt_dir=str(tmp_path), ckpt_every=1,
                      max_restarts=2, injector=AlwaysFail(fail_steps=[]))


def test_on_restart_hook_sees_event(tmp_path):
    scene, opt_state, step = _make_step()
    seen = []

    def hook(s, o, ev):
        seen.append(ev)
        return s, o

    resilient_fit(step, scene, opt_state, steps=4, ckpt_dir=str(tmp_path),
                  ckpt_every=1, injector=FaultInjector(fail_steps=[1]),
                  on_restart=hook)
    assert len(seen) == 1 and seen[0].step == 1
