"""Multi-host smoke test: two REAL `jax.distributed`-coordinated
processes over localhost run `sharded_stage1` on a 2-device global mesh
(1 CPU device per process) and must reproduce the single-process score.

This is the modern analogue of the reference's single-machine fake
multi-node backend (`--split` with file:// STEP handoff,
libmasa.cpp:516-527): the full network control plane (`jax.distributed`
init, global mesh, cross-process shard_map + ppermute, allgathered
results) runs for real, with localhost standing in for the network.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(tmp_path, size: int):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    out = tmp_path / "mh.json"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, "2", str(pid), str(out),
             str(size)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=300)
        outs.append((p.returncode, so, se))
    assert all(rc == 0 for rc, _, _ in outs), outs
    res = json.loads(out.read_text())
    assert res["processes"] == 2

    # oracle score for the worker's deterministic pair
    from masa_tpu.ops import oracle
    from masa_tpu.types import ScoreParams

    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    m = n = size
    s0 = rng.choice(bases, m).astype(np.uint8)
    s1 = s0.copy()
    idx = rng.random(n) < 0.1
    s1[idx] = rng.choice(bases, int(idx.sum())).astype(np.uint8)
    ref = oracle.dp_rows(s0, s1, ScoreParams())
    assert res["best"] == ref.best


def test_two_process_distributed_init_tiny(tmp_path):
    """Default-lane smoke: a REAL 2-process `jax.distributed` init +
    global mesh + cross-process shard_map on a tiny pair — the control
    plane exercised on every CI run (the cost is two interpreter
    startups, not compute)."""
    _run_workers(tmp_path, 128)


@pytest.mark.slow
def test_two_process_sharded_stage1(tmp_path):
    _run_workers(tmp_path, 768)
