"""Two-process multi-host simulation test (SURVEY.md §4 "distributed without a
cluster", multi-host half; VERDICT round-1 item 3).

Spawns two fresh Python processes, each with 2 virtual CPU devices, joined
through ``jax.distributed.initialize`` over a local gloo coordinator into a
2-host × 2-chip mesh. Collectives over the "host" axis cross the process
boundary — the closest a single machine gets to a cross-host network. The
worker
(tests/multihost_worker.py) checks row-sharded FISTA, consensus ADMM, and a
host-sharded instance batch assembled from process-local data, each against
a single-process oracle.
"""
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_host_chip_mesh():
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), "2", str(port)],
            env=env,
            cwd=ROOT,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"MULTIHOST_OK pid={i}" in out, out
