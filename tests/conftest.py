"""Test config: force CPU backend with 8 virtual devices.

Must set env vars before jax is imported anywhere, so this sits at the top of
conftest.  Multi-chip sharding tests run on the virtual CPU mesh (SURVEY.md
§4d); the driver separately dry-runs the multichip path.
"""

import io
import os
import subprocess

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

HERE = os.path.dirname(__file__)
EX3 = b"3 2 10\n15 3\n15 3\n20 1 2\n"  # reference README example


@pytest.fixture
def ex3_graph():
    from gnn_mwvc.graphio import read_metis

    return read_metis(io.BytesIO(EX3))


@pytest.fixture(scope="session")
def oracle_dir():
    """Build the reference oracle binaries (skip tests if build fails)."""
    script = os.path.join(HERE, "oracle", "build_oracle.sh")
    try:
        out = subprocess.run(
            ["bash", script], capture_output=True, text=True, timeout=300
        )
    except Exception as e:  # pragma: no cover
        pytest.skip(f"oracle build failed: {e}")
    if out.returncode != 0:
        pytest.skip(f"oracle build failed: {out.stderr[-500:]}")
    return out.stdout.strip().splitlines()[-1]


def random_graph(n, avg_deg, seed=0, wmax=1000):
    """Random weighted graph for tests (Erdos-Renyi-ish via random pairs)."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    u = rng.integers(0, n, size=m * 2)
    v = rng.integers(0, n, size=m * 2)
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    keep = lo != hi
    edges = np.unique(np.stack([lo[keep], hi[keep]], axis=1), axis=0)[:m]
    weights = rng.integers(1, wmax + 1, size=n)
    from gnn_mwvc.graph import Graph

    return Graph(weights, edges)


@pytest.fixture
def rnd_graph():
    return random_graph
