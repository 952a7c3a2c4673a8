"""Device selection and start-up: no path hides a missing accelerator.

Covers the compile-cache placement, pick_devices, the driver entry's device
count check, the GPU refusals of bench.py and chip_smoke.py, the per-platform
``aggregation="auto"`` choice, and precision in the sharded aggregation.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from tests.conftest import random_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**kw):
    """The subprocess environment: no JAX settings inherited, and no card
    visible, so a refusal is checked on a host with a GPU too (and the
    test suite never opens one)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS",
                        "JAX_COMPILATION_CACHE_DIR")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.update(kw)
    env["PYTHONPATH"] = ROOT
    return env


def _run(args, cwd=ROOT, timeout=240, **env):
    return subprocess.run([sys.executable] + args, cwd=cwd, env=_env(**env),
                          capture_output=True, text=True, timeout=timeout)


# -- compile cache --------------------------------------------------------
def test_compile_cache_dir_env_set():
    from gnn_mwvc import compilation_cache_dir

    assert compilation_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/cache/elsewhere"}) == "/cache/elsewhere"


def test_compile_cache_dir_default_in_checkout():
    from gnn_mwvc import compilation_cache_dir

    assert compilation_cache_dir({}) == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("set_env", [True, False])
def test_compile_cache_applied_at_import(tmp_path, set_env):
    extra = ({"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "c")}
             if set_env else {})
    out = _run(["-c", "import gnn_mwvc, jax; "
                "print(jax.config.jax_compilation_cache_dir)"],
               JAX_PLATFORMS="cpu", **extra)
    assert out.returncode == 0, out.stderr
    want = str(tmp_path / "c") if set_env else os.path.join(ROOT, ".jax_cache")
    assert out.stdout.strip().splitlines()[-1] == want


# -- device selection -----------------------------------------------------
def test_pick_devices_returns_real_cpu():
    from gnn_mwvc.solver.pipeline import pick_devices

    cpu, accel = pick_devices()
    assert cpu.platform == "cpu"
    assert accel is None  # the test process runs on the CPU backend only


def test_pick_devices_raises_without_cpu_backend(monkeypatch):
    from gnn_mwvc.solver import pipeline

    class _Accel:
        platform = "gpu"

    real = jax.devices

    def devices(backend=None):
        if backend == "cpu":
            raise RuntimeError("Unknown backend cpu")
        return [_Accel()] if backend is None else real(backend)

    monkeypatch.setattr(jax, "devices", devices)
    with pytest.raises(RuntimeError, match="CPU backend"):
        pipeline.pick_devices()


def test_require_gpu_refuses_cpu():
    from gnn_mwvc.utils.device import device_record, require_gpu

    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()
    rec = device_record()
    assert rec["platform"] == "cpu" and rec["count"] == len(jax.devices())


def test_graft_entry_refuses_short_device_count():
    sys.path.insert(0, ROOT)
    import __graft_entry__

    with pytest.raises(RuntimeError, match="need 64 devices"):
        __graft_entry__.dryrun_multichip(64)


def test_graft_entry_refuses_without_explicit_cpu():
    # no JAX_PLATFORMS: the one CPU device is not silently multiplied
    out = _run(["__graft_entry__.py", "multichip", "4"])
    assert out.returncode != 0
    assert "need 4 devices, have 1" in out.stderr


def test_bench_refuses_without_gpu():
    out = _run(["bench.py"], JAX_PLATFORMS="cpu", BENCH_SIDE="8")
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert "gnn_score_edges_per_s" not in out.stdout


# -- chip_smoke.py --------------------------------------------------------
def _no_ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return False
        except (ValueError, AttributeError):
            pass
    return True


def test_chip_smoke_fails_on_cpu_only_host():
    out = _run(["chip_smoke.py"], timeout=300)
    assert out.returncode != 0
    assert _no_ok_line(out.stdout)


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_env(PYTHONPATH=""), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert _no_ok_line(out.stdout)


# -- aggregation choice ---------------------------------------------------
def _grid(side):
    from gnn_mwvc.graph import Graph

    u = np.arange(side * side).reshape(side, side)
    e = np.concatenate([
        np.stack([u[:, :-1].ravel(), u[:, 1:].ravel()], 1),
        np.stack([u[:-1, :].ravel(), u[1:, :].ravel()], 1)])
    return Graph(np.ones(side * side, np.int64), e)


@pytest.mark.parametrize("platform,graph,want", [
    ("gpu", "grid", "ell"),
    ("gpu", "random", "ell"),
    ("cpu", "grid", "blocked"),
    ("cpu", "random", "blocked"),
])
def test_auto_aggregation_per_platform(monkeypatch, platform, graph, want):
    import gnn_mwvc.graph as graph_mod
    from gnn_mwvc.graph import DeviceGraph

    monkeypatch.setattr(graph_mod.jax, "default_backend", lambda: platform)
    g = _grid(40) if graph == "grid" else random_graph(4000, 8, seed=1)
    dg = DeviceGraph.from_graph(g, aggregation="auto")
    got = ("blocked" if dg.blocked is not None
           else "ell" if dg.ell is not None else "scatter")
    assert got == want


def test_explicit_aggregation_not_overridden_on_gpu(monkeypatch):
    """Explicit choices are never overridden by the platform rule."""
    import gnn_mwvc.graph as graph_mod
    from gnn_mwvc.graph import DeviceGraph

    monkeypatch.setattr(graph_mod.jax, "default_backend", lambda: "gpu")
    g = _grid(20)
    dg = DeviceGraph.from_graph(g, aggregation="scatter")
    assert dg.ell is None and dg.blocked is None
    dg = DeviceGraph.from_graph(g, aggregation="blocked")
    assert dg.blocked is not None


# -- sharded aggregation precision ---------------------------------------
def test_sharded_aggregate_passes_precision(monkeypatch):
    """Both blocked calls of the sharded aggregation receive the forward's
    precision (without it a GPU runs the one-hot einsums in TF32)."""
    import gnn_mwvc.ops.blocked as blocked
    from gnn_mwvc.graph import DeviceGraph
    from gnn_mwvc.models import load_pretrained
    from gnn_mwvc.parallel import (
        make_mesh, make_sharded_forward, partition_device_graph)

    seen = []
    real = blocked.blocked_segment_sum

    def spy(*a, **k):
        seen.append(k.get("precision"))
        return real(*a, **k)

    monkeypatch.setattr(blocked, "blocked_segment_sum", spy)
    m = load_pretrained()
    g = random_graph(600, 6, seed=3)
    dg = DeviceGraph.from_graph(g, aggregation="scatter", with_ell=False)
    mesh = make_mesh(8)
    for halo in (True, False):
        sg = partition_device_graph(dg, 8, aggregation="blocked", halo=halo)
        fwd = make_sharded_forward(m.kinds, mesh)
        out = np.asarray(fwd(m.params, sg, float(g.weights.max())))
        assert np.isfinite(out).all()
    assert seen and all(p == jax.lax.Precision.HIGHEST for p in seen)


def test_sharded_scorer_auto_aggregation_is_segment_sum():
    """The sharded scorer defaults to the per-shard sorted segment-sum."""
    from gnn_mwvc.parallel import make_mesh
    from gnn_mwvc.solver import ShardedGnnScorer

    sh = ShardedGnnScorer(mesh=make_mesh(8))
    assert sh.aggregation == "scatter"
    assert sh.stats["aggregation"] == "scatter"


def test_sharded_scorer_rejects_unknown_aggregation():
    from gnn_mwvc.parallel import make_mesh
    from gnn_mwvc.solver import ShardedGnnScorer

    with pytest.raises(ValueError, match="aggregation"):
        ShardedGnnScorer(mesh=make_mesh(8), aggregation="auto")
