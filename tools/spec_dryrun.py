#!/usr/bin/env python
"""8-device CPU-mesh dryrun of BASELINE config 4's SHAPE at available
scale: column-sharded stage 1 (parallel/sharded over a virtual 8-device
mesh) + SPECULATIVE traceback, asserting score AND alignment equality
against the monolithic pipeline.

Multi-card hardware is not needed for this check; this is the
largest honest stand-in (the same pjit/shard_map code paths, CPU
devices).  Size via MASA_SPECDRY_M (default 131072 — this host has ONE
CPU core, so wall time scales hard with m^2).

    python tools/spec_dryrun.py
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def main():
    from bench import homolog
    from masa_tpu.parallel.mesh import make_mesh
    from masa_tpu.parallel.sharded import sharded_align
    from masa_tpu.stages import pipeline
    from masa_tpu.types import ScoreParams

    assert len(jax.devices()) == 8, jax.devices()
    params = ScoreParams()
    m = int(os.environ.get("MASA_SPECDRY_M", 131072))
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, size=m).astype(np.uint8)
    s1 = homolog(np.random.default_rng(1), s0)

    mesh = make_mesh(8)
    sd = tempfile.mkdtemp(prefix="masa_specdry_")
    t0 = time.time()
    best, aln_s = sharded_align(s0, s1, mesh, params=params,
                                backend="scan", traceback="speculative",
                                state_dir=sd)
    t1 = time.time()
    print(f"[sharded 8-dev speculative] {t1 - t0:.1f}s score={best}",
          flush=True)

    t2 = time.time()
    aln_m = pipeline.align_pair(
        s0, s1, pipeline.PipelineConfig(params=params, backend="scan"))
    t3 = time.time()
    print(f"[monolithic] {t3 - t2:.1f}s score={aln_m.raw_score}",
          flush=True)

    assert int(best) == aln_m.raw_score, (best, aln_m.raw_score)
    assert aln_s.raw_score == aln_m.raw_score
    assert (aln_s.start, aln_s.end, aln_s.gaps) == \
        (aln_m.start, aln_m.end, aln_m.gaps), "alignments differ"
    import shutil

    shutil.rmtree(sd, ignore_errors=True)
    print(json.dumps({
        "metric": "speculative_8dev_cpu_dryrun",
        "m": m, "n": len(s1), "n_devices": 8,
        "sharded_speculative_s": round(t1 - t0, 2),
        "monolithic_s": round(t3 - t2, 2),
        "score": int(aln_m.raw_score),
        "alignment_equal": True,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
