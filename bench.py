#!/usr/bin/env python
"""Benchmark on the GPU: stage-1 SW wavefront GCUPS on a synthetic 1M x 1M
pair (BASELINE config: CP000051.1 x CP000051.1 class, reference single-GPU
= 25.82 GCUPS, README.md:87 / BASELINE.md), plus the full six-stage
alignment wall clock on a 1M-class homologous pair (the reference's
published number includes traceback: 43 s full run, README.md:87).

Runs only where the platform decision picks the CUDA strip kernel (a GPU);
anywhere else it exits with an error.  Any failure is an error.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.
Set MASA_BENCH_FULL=0 to skip the full-alignment phase.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_GCUPS = 25.82       # 1M x 1M stage 1, GTX 560 Ti (TPDS2013)
BASELINE_FULL_S = 43.0       # 1M x 1M FULL run on the same card


def homolog(rng, seq, sub_rate=0.08, indel_every=1 << 16):
    """Vectorized homolog: point substitutions + sparse short indels."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    out = seq.copy()
    idx = rng.random(len(seq)) < sub_rate
    out[idx] = rng.choice(bases, int(idx.sum())).astype(np.uint8)
    parts = []
    prev = 0
    for cut in range(indel_every, len(out), indel_every):
        parts.append(out[prev:cut])
        if rng.random() < 0.5:
            parts.append(rng.choice(bases, int(rng.integers(1, 8))
                                    ).astype(np.uint8))
            prev = cut
        else:
            prev = cut + int(rng.integers(1, 8))
    parts.append(out[prev:])
    return np.concatenate(parts)


def make_pair(n: int = 1 << 20, seed: int = 0):
    """The 1M-class homologous pair: a random sequence (seed) and its
    homolog (seed + 1)."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = np.random.default_rng(seed).choice(bases, size=n).astype(np.uint8)
    return s0, homolog(np.random.default_rng(seed + 1), s0)


def main():
    import jax
    import numpy as np

    from masa_tpu.utils.devices import (enable_persistent_compile_cache,
                                        kernel_route)

    enable_persistent_compile_cache()
    route = kernel_route()
    if route != "cuda":
        raise SystemExit(f"bench.py measures the GPU; this platform runs "
                         f"the {route!r} route")

    from masa_tpu.ops import strips
    from masa_tpu.stages.core import default_config
    from masa_tpu.types import InitType, ScoreParams

    cfg = default_config()
    m = n = 1 << 20
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, size=m).astype(np.uint8)
    s1 = rng.choice(bases, size=n).astype(np.uint8)
    params = ScoreParams()

    def stage1(rows):
        t0 = time.time()
        res = strips.run_partition(
            cfg, s0[:rows], s1, params, InitType.WITH_ZEROES,
            InitType.WITH_ZEROES, route=route, want_last_row=False)
        return res, time.time() - t0

    stage1(min(cfg.rows, m))              # compile
    res, dt = stage1(m)
    gcups = res.cells / dt / 1e9

    full = {}
    if os.environ.get("MASA_BENCH_FULL", "1") != "0":
        import tempfile

        from masa_tpu.core.job import Job, JobConfig
        from masa_tpu.stages import runner

        a, b = make_pair(m)
        for attempt in ("cold", "warm"):
            with tempfile.TemporaryDirectory() as wd:
                job = Job(JobConfig(work_dir=wd, params=params))
                t0 = time.time()
                aln = runner.align_job(job, a, b, log=lambda *x: None)
                full[f"{attempt}_s"] = round(time.time() - t0, 2)
                full["score"] = aln.raw_score
        full["gcups"] = round(len(a) * len(b) / full["warm_s"] / 1e9, 2)

    d = jax.devices()[0]
    print(json.dumps({
        "metric": "stage1_sw_gcups_1gpu",
        "value": round(gcups, 2),
        "unit": "GCUPS",
        "vs_baseline": round(gcups / BASELINE_GCUPS, 3),
        "detail": {
            "m": m, "n": n, "seconds": round(dt, 3),
            "best_score": res.best, "route": route,
            "device": {"platform": d.platform, "kind": d.device_kind,
                       "count": len(jax.devices())},
            "full_alignment": full or None,
            "full_vs_baseline_s": (round(BASELINE_FULL_S / full["warm_s"],
                                         3) if full else None),
        },
    }))


if __name__ == "__main__":
    main()
