"""Multi-host readiness: 2 processes x 4 CPU devices, chain parity.

Spawns two real jax.distributed processes (coordinator on a free local
port), each with 4 virtual CPU devices, and runs the production MCMC
chain over the process-spanning 8-device global mesh. Each worker
asserts its addressable shards are bit-identical to the single-process
chain (tests/_multihost_worker.py). This is the process-spanning
analogue of test_sharded_sample's exact single-host parity.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_chain_parity():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "_multihost_worker.py")
    coord = f"127.0.0.1:{_free_port()}"

    env = dict(os.environ)
    # 4 virtual CPU devices per process
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(pid)],
            env=env,
            cwd=repo,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "multihost chain parity OK" in out, out
        assert "candidate-shard acquisition parity OK" in out, out
        assert "row-sharded LML parity OK" in out, out
