"""Region-solver timing on the GPU: the meet-in-the-middle walk at several
block sizes (and the 2^16 enumeration at n=16), B instances per batch at
n=16 and n=20.

Checks each variant bitwise against the CPU oracle first (the 2^16
enumeration at n=16, the meet-in-the-middle walk on the CPU backend at
n=20), then times ``reps`` batches per variant, each call ending in
``block_until_ready``; reports the median and the minimum per batch in ms.

Usage (on a machine with a card):
    JAX_PLATFORMS=cuda,cpu python tools/smallsolve_bench.py [--batch 1024]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def random_batch(rng, b, n):
    adj = np.zeros((b, n), np.int32)
    w = np.zeros((b, n), np.int32)
    for k in range(b):
        m = int(rng.integers(n // 2, n + 1))
        w[k, :m] = rng.integers(1, 1000, size=m)
        for _ in range(2 * m):
            i, j = rng.integers(0, m, size=2)
            if i != j:
                adj[k, i] |= 1 << j
                adj[k, j] |= 1 << i
    return adj, w


def time_fn(fn, adj, w, reps):
    import jax

    jax.block_until_ready(fn(adj, w))  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(adj, w))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(min(ts))


def variants(n):
    """name -> callable for every variant timed at width n."""
    import functools

    from gnn_mwvc.ops.smallsolve import mitm_small_mwvc

    out = {}
    for blk in (128, 256, 512, 1024, 2048, 8192):
        if blk <= 1 << (n - 7):
            out[f"jnp_block{blk}"] = functools.partial(mitm_small_mwvc,
                                                       block=blk)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/smallsolve_bench.json")
    args = ap.parse_args(argv)

    import jax

    from gnn_mwvc.ops.smallsolve import batched_small_mwvc, mitm_small_mwvc
    from gnn_mwvc.utils.device import card_line, require_gpu

    dev = require_gpu()
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(3)
    rows = {"card": card_line(), "device": dev.device_kind,
            "batch": args.batch}
    for n in (16, 20):
        adj, w = random_batch(rng, args.batch, n)
        with jax.default_device(cpu):
            oracle = (batched_small_mwvc if n == 16 else mitm_small_mwvc)(
                jax.device_put(adj, cpu), jax.device_put(w, cpu))
            oracle = [np.asarray(a) for a in oracle]
        if n == 16:
            t = time_fn(batched_small_mwvc, adj, w, args.reps)
            rows["enum_n16_ms"] = [round(x * 1e3, 4) for x in t]
        for name, fn in variants(n).items():
            try:
                got = [np.asarray(a) for a in fn(adj, w)]
                same = all(np.array_equal(a, b) for a, b in zip(got, oracle))
                t = time_fn(fn, adj, w, args.reps)
                rows[f"{name}_n{n}_ms"] = [round(x * 1e3, 4) for x in t]
                rows[f"{name}_n{n}_bitwise"] = same
            except Exception as exc:  # a variant that does not compile
                rows[f"{name}_n{n}_error"] = repr(exc)[:300]
        print(json.dumps({k: v for k, v in rows.items()
                          if f"n{n}" in k}), flush=True)
    print(json.dumps(rows))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
