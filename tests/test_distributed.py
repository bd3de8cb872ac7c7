"""Multi-host execution tests: two coordinated `jax.distributed` processes.

The north-star requires scaling to 2+ hosts (SURVEY.md §2.9/§5.8). Real
multi-host hardware isn't available in CI, so this runs the genuine article
at the program level: two OS processes, each with 4 virtual CPU devices,
coordinated through `jax.distributed.initialize` (localhost coordinator),
executing the SPMD sharded kernel over the 8-device global mesh with
per-process data loading (`shard_bounds`) — and asserting the distributed
verdicts equal the single-process goldens row for row.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("n", [256])
def test_two_process_distributed_matches_goldens(tmp_path, n, hard10k):
    port = _free_port()
    outs = [tmp_path / f"v{i}.npy" for i in range(2)]
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "NUM_PROCESSES": "2",
            "PROCESS_ID": str(pid),
        })
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "scripts" / "multihost_worker.py"),
             "--dataset", "hard10k", "--n", str(n), "--out", str(outs[pid])],
            env=env, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    # Both workers saw the full 8-device global mesh from 2 processes.
    assert '"process_count": 2' in logs[0] + logs[1]
    assert '"devices": 8' in logs[0]
    assert '"local_devices": 4' in logs[0]

    valid = np.concatenate([np.load(o) for o in outs])
    assert valid.shape == (n,)
    np.testing.assert_array_equal(valid, hard10k.valid[:n])
