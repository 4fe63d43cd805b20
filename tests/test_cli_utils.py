"""CLI and utility-layer coverage (cheap, CPU-only)."""
import json
import os

import numpy as np
import pytest

import python_ray_tracer_jax as rt
from python_ray_tracer_jax.cli import main
from python_ray_tracer_jax.utils.metrics import MetricsLogger
from python_ray_tracer_jax.utils.profiling import annotate, capture_trace
from python_ray_tracer_jax.utils.timing import time_fn, rays_per_image


def test_cli_render_writes_png(tmp_path):
    out = os.path.join(tmp_path, "r.png")
    assert main(["render", "--width", "24", "--height", "24", "--depth", "0",
                 "--no-aliasing", "--out", out]) == 0
    from PIL import Image
    img = Image.open(out)
    assert img.size == (24, 24)


def test_cli_render_clean_and_soft(tmp_path):
    out1 = os.path.join(tmp_path, "clean.png")
    out2 = os.path.join(tmp_path, "soft.png")
    assert main(["render", "--width", "16", "--height", "16", "--clean",
                 "--no-aliasing", "--depth", "0", "--out", out1]) == 0
    assert main(["render", "--width", "16", "--height", "16", "--soft", "0.05",
                 "--out", out2]) == 0
    a = np.asarray(__import__("PIL.Image", fromlist=["Image"]).open(out1))
    b = np.asarray(__import__("PIL.Image", fromlist=["Image"]).open(out2))
    assert a.shape == b.shape == (16, 16, 3)
    assert not np.array_equal(a, b)  # soft edges differ from hard


@pytest.mark.parametrize("backend,soft,kind", [
    ("jnp", 0.0, "jnp"), ("pallas", 0.0, "pallas"), ("pallas", 0.05, "soft"),
    ("jnp", 0.05, "soft")])
def test_render_fn_routes(backend, soft, kind):
    """The CLI's render dispatch: soft renders go to the soft renderer, hard
    renders to the resolved backend (resolution itself is tested below)."""
    from python_ray_tracer_jax.cli import _render_fn
    from python_ray_tracer_jax.utils.config import RenderConfig

    assert _render_fn(RenderConfig(backend=backend), soft_tau=soft).kind == kind


@pytest.mark.parametrize("platform,backend,want", [
    ("gpu", "auto", "pallas"), ("cpu", "auto", "jnp"), ("gpu", "jnp", "jnp"),
    ("gpu", "pallas", "pallas"), ("cpu", "jnp", "jnp"),
    ("cpu", "pallas", RuntimeError)])
def test_resolve_backend(monkeypatch, platform, backend, want):
    """auto picks the fused kernel on a GPU and the jnp path elsewhere; an
    explicit kernel request off a GPU raises instead of falling back."""
    import jax
    from python_ray_tracer_jax.utils.config import resolve_backend

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="GPU"):
            resolve_backend(backend)
    else:
        assert resolve_backend(backend) == want


def test_cli_render_pallas_refuses_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="GPU"):
        main(["render", "--width", "8", "--height", "8", "--backend", "pallas",
              "--out", os.path.join(tmp_path, "p.png")])


@pytest.mark.parametrize("env_set", [False, True])
def test_enable_compile_cache(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and is left to JAX; otherwise the cache
    goes to a fixed directory in the checkout."""
    import jax
    from python_ray_tracer_jax.utils import config

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert config.enable_compile_cache() == str(tmp_path)
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = config.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(rt.__file__)))
        assert path == os.path.join(root, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]


def test_bench_refuses_cpu(capsys):
    """bench.py measures a GPU or nothing: no JSON line off the card."""
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import bench
    finally:
        sys.path.remove(root)
    assert bench.main() == 1
    assert capsys.readouterr().out == ""


def test_cli_random_scene(tmp_path):
    out = os.path.join(tmp_path, "rand.png")
    assert main(["render", "--width", "16", "--height", "16", "--spheres", "5",
                 "--depth", "0", "--no-aliasing", "--out", out]) == 0


def test_cli_rejects_unknown_flag():
    with pytest.raises(SystemExit) as e:
        main(["render", "--widht", "64"])
    assert e.value.code == 2


def test_metrics_logger_jsonl(tmp_path):
    log = MetricsLogger("t", echo=False)
    log.log(0, loss=1.5, mrays=2.0)
    log.log(1, loss=0.5)
    path = os.path.join(tmp_path, "m.jsonl")
    log.dump_jsonl(path)
    recs = [json.loads(l) for l in open(path)]
    assert len(recs) == 2 and recs[0]["loss"] == 1.5
    assert log.last("loss") == 0.5
    assert log.last("mrays") == 2.0


def test_time_fn_measures(monkeypatch):
    """time_samples times each call alone (after the warm-up); time_fn is
    their median."""
    import statistics
    from python_ray_tracer_jax.utils.timing import time_samples

    calls = []

    def fn():
        calls.append(1)
        import jax.numpy as jnp
        return jnp.ones(4)

    samples = time_samples(fn, warmup=2, iters=3)
    assert len(samples) == 3 and all(s >= 0.0 for s in samples)
    assert len(calls) == 2 + 3
    ticks = iter([0.0, 1.0, 10.0, 12.0, 20.0, 29.0])
    import python_ray_tracer_jax.utils.timing as timing
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(ticks))
    assert time_fn(fn, warmup=0, iters=3) == statistics.median([1, 2, 9])


def test_rays_per_image_accounting():
    # no AA: every pixel = (1+depth) traces x (1+lights) sweeps
    assert rays_per_image(10, 10, depth=2, aliasing=False, n_lights=3) == \
        100 * 3 * 4
    # AA: interior 9 samples, border 1
    n = rays_per_image(4, 4, depth=0, aliasing=True, n_lights=0)
    assert n == (4 * 9 + 12 * 1) * 1
    assert rays_per_image(10, 10, depth=2, aliasing=False, n_lights=3,
                          primary_only=True) == 100


def test_profiling_capture(tmp_path):
    d = os.path.join(tmp_path, "trace")
    with capture_trace(d):
        with annotate("scope"):
            img = rt.render_image(rt.default_camera((8, 8)), rt.default_scene(),
                                  depth=0, aliasing=False)
            img.block_until_ready()
    files = [f for _, _, fs in os.walk(d) for f in fs]
    assert files, "no trace files captured"


def test_config_reference_defaults():
    from python_ray_tracer_jax.utils.config import RenderConfig
    cfg = RenderConfig.reference_defaults()
    # main.py:10-12 values
    assert (cfg.width, cfg.height) == (1000, 1000)
    assert (cfg.ambient, cfg.lambert, cfg.reflection) == (0.0, 0.6, 0.3)
    assert cfg.depth == 2 and cfg.aliasing and cfg.fov == 45.0


def test_cli_fit_camera_smoke(tmp_path):
    """fit --mode camera runs end-to-end (pose params, Euler round-trip, PNG)."""
    out = os.path.join(tmp_path, "cam.png")
    assert main(["fit", "--mode", "camera", "--width", "12", "--height", "12",
                 "--depth", "0", "--steps", "2", "--out", out]) == 0
    assert os.path.exists(out)
