#!/usr/bin/env python
"""One process of a multi-host sharded stage-1 run (the smoke-test worker).

Launched once per host id by tests/test_multihost.py (or by hand):

    python tools/multihost_worker.py <coordinator> <num_procs> <proc_id> \
        <out.json>

Uses the CPU backend (1 local device per process) so a 2-process run
exercises the REAL `jax.distributed` + global-mesh + shard_map + ppermute
path — the modern analogue of the reference's single-machine fake
multi-node backend (libmasa.cpp:516-527, file:// STEP handoff).

Every process computes the same deterministic pair, builds the global
2-device mesh, runs `sharded_stage1`, and process 0 writes the score
JSON for the test to check against the single-process oracle.
"""

import json
import os
import sys

# one CPU device per process: the global mesh is (num_procs,)
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=1"
)
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# an accelerator plugin on the inherited PYTHONPATH may ignore the env
# var; the config route always wins
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    coordinator, num_procs, proc_id, out_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    size = int(sys.argv[5]) if len(sys.argv) > 5 else 768

    import jax
    import numpy as np

    from masa_tpu.parallel.mesh import initialize_distributed, make_mesh
    from masa_tpu.parallel.sharded import sharded_stage1
    from masa_tpu.ops.wavefront import WavefrontConfig
    from masa_tpu.types import ScoreParams

    initialize_distributed(coordinator, num_procs, proc_id)
    assert jax.process_count() == num_procs, jax.process_count()
    assert len(jax.devices()) == num_procs   # 1 CPU device per process

    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    m = n = size
    s0 = rng.choice(bases, m).astype(np.uint8)
    s1 = s0.copy()
    idx = rng.random(n) < 0.1
    s1[idx] = rng.choice(bases, int(idx.sum())).astype(np.uint8)
    params = ScoreParams()
    cfg = WavefrontConfig(alpha=4, rs=1, chunk=512)

    mesh = make_mesh(num_procs)
    res = sharded_stage1(s0, s1, mesh, cfg=cfg, params=params,
                         route="scan")
    if proc_id == 0:
        with open(out_path, "w") as f:
            json.dump({"best": int(res.best),
                       "processes": jax.process_count()}, f)
    # all processes must exit cleanly (the reference's wait() reaper
    # semantics, libmasa.cpp:605-630)
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
