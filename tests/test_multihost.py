"""Multi-host distributed BA: N real processes, 1 CPU device each, Gloo
collectives — the standard JAX pattern for testing multi-node sharding
without a pod (SURVEY §4). Each worker reproduces the single-device
optimum through the map-partitioned shard_map program."""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nproc", [2])
def test_multiprocess_sharded_ba_matches_single_device(nproc):
    port = _free_port()
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="",  # exactly one local device per process
    )
    # no persistent cache: sharing the suite's floods stderr with
    # machine-feature-mismatch warnings that bury real tracebacks
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for i in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"worker {i} output:\n{out}"
