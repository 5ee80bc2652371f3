"""Multi-device scaling benchmark (instance-parallel and model-parallel).

Measures iterations/s of (a) the instance-sharded batched Gram FISTA (pure
data parallelism over the ``batch`` mesh axis) and (b) the row-sharded
distributed FISTA step (psum-reduced matvecs over the ``model`` axis) at
increasing device counts, and reports scaling efficiency
``T(n) / (n · T(1))`` per BASELINE.md (target ≥ 80%).

Each device count runs in a fresh subprocess, one at a time, so a card is
only ever opened by one process; the parent never initializes a JAX
backend. ``--platform gpu`` (the default) measures real cards and fails if
the child finds no GPU. ``--platform cpu`` asks for CPU-simulated devices
(``--xla_force_host_platform_device_count``) explicitly: those numbers
validate the correctness and overhead of the sharded path, not physical
speedup (virtual devices share one socket; expect efficiency ≈ 1/n). The
report labels which regime it ran in.

CLI:  python -m fastoptsolver_tpu.bench.scaling --devices 1 2 4
      python -m fastoptsolver_tpu.bench.scaling --platform cpu --devices 1 2 4 8
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD_FLAG = "_FOS_SCALING_CHILD"


def _child(mode: str, n_dev: int, batch: int, m: int, iters: int,
           platform: str) -> None:
    import time

    import numpy as np
    import jax
    import jax.numpy as jnp

    from ..utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    devices = jax.devices()
    if devices[0].platform != platform:
        raise SystemExit(
            f"asked for {platform} devices, JAX found {devices[0].platform}"
        )
    devices = devices[:n_dev]
    if len(devices) != n_dev:
        raise SystemExit(f"need {n_dev} devices, have {len(jax.devices())}")

    from ..batch import make_gram_batch
    from ..batch.fista_gram import BatchFISTAConfig, fista_gram_batch
    from ..parallel import BATCH_AXIS, make_mesh, shard_gram_batch
    from ..parallel.problem import DistributedLeastSquares
    from ..solvers import FISTAConfig, fista

    rng = np.random.default_rng(0)
    if mode == "dp":
        mesh = make_mesh(batch=n_dev, model=1, devices=devices)
        A = jnp.asarray(rng.normal(size=(batch, m, 5)), jnp.float32)
        b = jnp.asarray(rng.normal(size=(batch, m)), jnp.float32)
        gb = shard_gram_batch(
            make_gram_batch(A, b, alpha1=0.5, alpha2=0.0, power_iters=20),
            mesh,
            BATCH_AXIS,
        )
        cfg = BatchFISTAConfig(max_iter=iters, check_every=0)
        run = lambda: fista_gram_batch(gb, cfg).x
        work_units = batch * iters  # instance-iterations
    else:  # "model": one big row-sharded problem
        mesh = make_mesh(batch=1, model=n_dev, devices=devices)
        mrows = m * 64
        A = rng.normal(size=(mrows, 256)).astype(np.float32)
        bb = rng.normal(size=mrows).astype(np.float32)
        dist = DistributedLeastSquares.create(A, bb, mesh, "lasso", 0.5, 0.0)
        cfg = FISTAConfig(max_iter=iters)
        L = jnp.asarray(float(mrows), jnp.float32)
        run = lambda: fista(dist, cfg, L=L).x
        work_units = iters  # solver iterations

    jax.block_until_ready(run())  # compile
    t0 = time.perf_counter()
    jax.block_until_ready(run())
    dt = time.perf_counter() - t0
    print(
        json.dumps(
            {
                "mode": mode,
                "devices": n_dev,
                "seconds": dt,
                "work_per_s": work_units / dt,
                "device_kind": str(devices[0].device_kind),
                "platform": devices[0].platform,
            }
        )
    )


def run_scaling(device_counts, batch=4096, m=200, iters=200, mode="dp",
                platform="gpu"):
    """Spawn one subprocess per device count, one after another; return the
    aggregated report."""
    results = []
    for n in device_counts:
        env = dict(os.environ)
        env[_CHILD_FLAG] = json.dumps(
            {"mode": mode, "n_dev": n, "batch": batch, "m": m, "iters": iters,
             "platform": platform}
        )
        env["JAX_PLATFORMS"] = platform
        flags = env.get("XLA_FLAGS", "")
        if platform == "cpu" and "host_platform_device_count" not in flags:
            env["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={max(device_counts)}"
            ).strip()
        proc = subprocess.run(
            [sys.executable, "-m", "fastoptsolver_tpu.bench.scaling"],
            env=env,
            capture_output=True,
            text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        )
        if proc.returncode != 0:
            raise RuntimeError(f"scaling child (n={n}) failed:\n{proc.stderr[-2000:]}")
        line = [l for l in proc.stdout.splitlines() if l.startswith("{")][-1]
        results.append(json.loads(line))
    base = results[0]
    for r in results:
        r["efficiency_vs_linear"] = round(
            r["work_per_s"] / (base["work_per_s"] * r["devices"] / base["devices"]), 3
        )
    return {
        "mode": mode,
        "simulated_devices": results[0]["platform"] == "cpu",
        "note": (
            "CPU-simulated devices share one socket: expect efficiency ~1/n; "
            "run with --platform gpu for physical scaling"
            if results[0]["platform"] == "cpu"
            else "real devices"
        ),
        "points": results,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--mode", choices=["dp", "model"], default="dp")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--m", type=int, default=200)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                    help="gpu: real cards (fails without them); cpu: "
                         "simulated devices, for correctness only")
    args = ap.parse_args(argv)
    print(json.dumps(run_scaling(args.devices, args.batch, args.m, args.iters,
                                 args.mode, args.platform)))


if __name__ == "__main__":
    if _CHILD_FLAG in os.environ:
        cfg = json.loads(os.environ[_CHILD_FLAG])
        _child(cfg["mode"], cfg["n_dev"], cfg["batch"], cfg["m"], cfg["iters"],
               cfg["platform"])
    else:
        main()
