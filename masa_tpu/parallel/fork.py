"""Multi-process column-split driver: the reference's fork_multi_process
(libmasa.cpp:540-642) as real OS processes.

The parent spawns one worker process per vertical slab (fork + wait
reaper, :579-630); neighbors auto-wire over localhost sockets
(socket://127.0.0.1:700x, :585-595) for the stage-1 boundary column, and
the AlignerPool shared directory carries control messages: best scores
rightward during stage 1 (sw_stage1.cpp:421-478), crosspoints leftward
during the pipelined stage-2 traceback with "Not me!" pass-through
routing (sw_stage2.cpp:133-235,197-205), and whole stage-4 crosspoint
files spliced leftward (stage4_pool_wait, sw_stage4.cpp:854-881).  Node 0
finally runs stages 5/6 on the spliced chain and writes the result.

Each worker owns its own JAX runtime (one device per process — the
per-fork GPU selection of CUDAligner.cpp:137-150 maps to a per-fork
default-device index).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

from masa_tpu.types import Crosspoint, CrosspointType, ScoreParams


def _merge_best(a: tuple, b: tuple) -> tuple:
    """(i, j, score) with the engine tie-break (score desc, i asc, j asc)."""
    ka = (a[2], -a[0], -a[1])
    kb = (b[2], -b[0], -b[1])
    return a if ka >= kb else b


def fork_pinning(n_workers: int, platform: str | None) -> list[dict]:
    """Per-worker environment additions.  On the GPU (``platform`` "gpu",
    or unset with cards visible and JAX not held to the CPU) worker k
    sees only card k through CUDA_VISIBLE_DEVICES, and more workers than
    cards is an error; on the CPU nothing is pinned.  Decided without
    touching JAX: the parent must leave every card to its workers."""
    from masa_tpu.utils.devices import visible_gpus

    if platform is None:
        on_cpu = os.environ.get("JAX_PLATFORMS", "").strip() == "cpu"
        platform = "cpu" if on_cpu or not visible_gpus() else "gpu"
    if platform != "gpu":
        return [{} for _ in range(n_workers)]
    cards = visible_gpus()
    if n_workers > len(cards):
        raise ValueError(f"--fork {n_workers}: only {len(cards)} GPU(s) "
                         f"visible; each worker needs a card of its own")
    return [{"CUDA_VISIBLE_DEVICES": cards[k]} for k in range(n_workers)]


def worker_main(config_path: str) -> int:
    """One slab worker (the forked child, libmasa.cpp:556-577)."""
    with open(config_path) as f:
        cfg = json.load(f)
    k = cfg["part"]
    os.environ["MASA_FORK_ID"] = str(k)
    if cfg.get("platform"):
        # the env var alone is not authoritative (out-of-tree platform
        # plugins may ignore it); force in-process
        import jax

        jax.config.update("jax_platforms", cfg["platform"])
    if cfg.get("device") is not None:
        import jax

        jax.config.update("jax_default_device",
                          jax.devices()[cfg["device"]])

    from masa_tpu.parallel.pool import AlignerPool
    from masa_tpu.parallel.split import march_slab, run_part_stage1
    from masa_tpu.ops import myers_miller as mm
    from masa_tpu.ops import wavefront as wf
    from masa_tpu.stages import pipeline, stage6

    seq0 = np.load(cfg["seq0"])
    seq1 = np.load(cfg["seq1"])
    params = ScoreParams(*cfg["params"])
    points = cfg["points"]
    urls = cfg["urls"]
    N = cfg["nparts"]
    kcfg = (wf.WavefrontConfig(**cfg["kernel_cfg"])
            if cfg.get("kernel_cfg") else None)
    pool = AlignerPool(cfg["shared_dir"], k, N,
                       timeout=cfg.get("timeout", 300.0))

    # ---- stage 1: slab wavefront with socket boundary streams ----------
    from masa_tpu.stages.core import default_config

    special_every = (kcfg or default_config()).rows
    part = run_part_stage1(
        seq0, seq1, k, points, params, kcfg,
        load_url=urls[k - 1] if k > 0 else None,
        flush_url=urls[k] if k < N - 1 else None,
        special_every=special_every,
    )

    # best scores flow rightward; the last node knows the global best
    my_best = (part.best_i, part.best_j, part.best)
    if k > 0:
        left = pool.receive_score()
        my_best = _merge_best((left.i, left.j, left.score), my_best)
    from masa_tpu.types import BestScore

    pool.dispatch_score(BestScore(*my_best))

    # ---- stage 2: traceback, right to left -----------------------------
    j0, j1 = points[k], points[k + 1]
    slab = np.ascontiguousarray(seq1[j0:j1])

    # speculative mode (TPDS2016, executeTracebackPredicted,
    # libmasa.cpp:698-757): before blocking on the pipeline, march from
    # the slab-LOCAL best; if the confirmed crosspoint later lands on a
    # speculated one, the chain is spliced instead of recomputed.
    from masa_tpu.parallel.split import speculate_slab, splice_speculation

    spec: list | None = None
    if cfg.get("traceback") == "speculative" and not pool.is_last_node():
        spec = speculate_slab(
            seq0, slab, params, (part.best_i, part.best_j, part.best),
            j0, j1, part.specials, part.first_col if k > 0 else None,
            backend="auto", cfg=kcfg,
        )

    my_cps: list[Crosspoint] = []
    if pool.is_last_node():
        gi, gj, gs = my_best
        cp, final = Crosspoint(gi, gj, gs, CrosspointType.MATCH), False
    else:
        cp, final = pool.receive_crosspoint()
    if not final and j0 < cp.j <= j1:
        local_ep = Crosspoint(cp.i, cp.j - j0, cp.score, cp.type)
        known = {tuple(c) for c in spec} if spec else None
        local = march_slab(
            seq0, slab, params, local_ep, part.specials,
            part.first_col if k > 0 else None,
            sw_anywhere=True, backend="auto", cfg=kcfg,
            known=known,
        )
        local, _ = splice_speculation(local, spec)
        my_cps = [Crosspoint(c.i, c.j + j0, c.score, c.type)
                  for c in local]
        first = my_cps[0]
        done = first.j > j0 or k == 0 or first.score <= 0
        if k > 0:
            pool.dispatch_crosspoint(first, final=done)
    elif k > 0:
        # "Not me!" — route the message onward unchanged
        pool.dispatch_crosspoint(cp, final=final)

    # ---- stages 3/4 on my slab's chain, then splice leftward -----------
    pcfg = pipeline.PipelineConfig(
        params=params, backend="auto",
        max_cells_stage5=cfg.get("max_cells_stage5", 1 << 18),
    )
    my4 = my_cps
    if len(my_cps) >= 2:
        my4 = pipeline.stage3_densify(seq0, seq1, pcfg, my_cps)
        mps = cfg.get("max_partition", 16)
        if mps:
            # engine chosen by this worker's kernel route
            my4 = mm.stage4_reduce(
                seq0, seq1, my4, params, mps,
                stage5_max_cells=pcfg.max_cells_stage5)

    from masa_tpu.core.crosspoints import CrosspointsFile

    node_dir = os.path.join(cfg["shared_dir"], f"node.{k:02d}")
    os.makedirs(node_dir, exist_ok=True)
    chain = my4
    if not pool.is_last_node():
        # stage4_pool_wait: splice the right node's crosspoint file
        rp = pool.receive_file("cps4", node_dir)
        right = CrosspointsFile(rp).load()
        if chain and right and tuple(chain[-1]) == tuple(right[0]):
            right = right[1:]
        chain = chain + right
    if not pool.is_first_node():
        cf = CrosspointsFile(
            os.path.join(node_dir, f"crosspoint_04.{k:02d}"))
        cf.crosspoints = chain
        cf.save()
        pool.dispatch_file(cf.path, "cps4")
        return 0

    # ---- node 0: stages 5/6 on the full spliced chain ------------------
    if not chain:
        raise RuntimeError("fork: empty crosspoint chain at node 0")
    aln = pipeline.stage5_emit(seq0, seq1, pcfg, chain)
    stage6.recheck(aln, seq0, seq1, params)
    out = {
        "score": int(aln.raw_score),
        "matches": int(aln.matches),
        "mismatches": int(aln.mismatches),
        "gap_opens": int(aln.gap_opens),
        "gap_extensions": int(aln.gap_extensions),
        "start": [int(x) for x in aln.start],
        "end": [int(x) for x in aln.end],
        "crosspoints": [[int(x) for x in c] for c in chain],
    }
    with open(os.path.join(cfg["shared_dir"], "result.json"), "w") as f:
        json.dump(out, f)
    with open(os.path.join(cfg["shared_dir"], "alignment.txt"), "w") as f:
        f.write(stage6.render_text(aln, seq0, seq1))

    # the standard work-dir artifact set (same as every other CLI mode:
    # CGFF binary, the requested stage-6 rendering, the final crosspoint
    # file — libmasa.cpp:1351-1394 writes these in all modes)
    wd = os.path.dirname(cfg["shared_dir"]) or "."
    from masa_tpu.biology import alignment as balign

    balign.write_cgff(os.path.join(wd, "alignment.00.cgff"), aln)
    cps_dir = os.path.join(wd, "crosspoints")
    os.makedirs(cps_dir, exist_ok=True)
    cf0 = CrosspointsFile(os.path.join(cps_dir, "crosspoint_04.00"))
    cf0.crosspoints = chain
    cf0.save()
    fmt = cfg.get("output_format", "text")
    render = stage6.FORMATS.get(fmt, stage6.FORMATS["text"])
    text, ext = render(aln, seq0, seq1)
    with open(os.path.join(wd, f"alignment.00.{ext}"), "w") as f:
        f.write(text)
    return 0


def run_fork(
    seq0: np.ndarray,
    seq1: np.ndarray,
    weights: list[float],
    work_dir: str,
    params: ScoreParams = ScoreParams(),
    kernel_cfg=None,
    base_port: int = 7300,
    max_partition: int = 16,
    timeout: float = 600.0,
    devices: list[int] | None = None,
    extra_env: dict | None = None,
    platform: str | None = None,
    traceback: str = "pipelined",
    output_format: str = "text",
):
    """Spawn one worker process per slab and reap them
    (fork_multi_process + the wait loop, libmasa.cpp:540-642).

    On a GPU each worker is pinned to its own card through
    CUDA_VISIBLE_DEVICES (fork_pinning); a JAX process reserves most of
    a card's memory, so two workers cannot share one.

    Returns the node-0 result dict (score, stats, crosspoints)."""
    from masa_tpu.parallel.split import auto_urls, split_points

    N = len(weights)
    pins = fork_pinning(N, platform)
    os.makedirs(work_dir, exist_ok=True)
    shared = os.path.join(work_dir, "shared")
    os.makedirs(shared, exist_ok=True)
    s0p = os.path.join(work_dir, "seq0.npy")
    s1p = os.path.join(work_dir, "seq1.npy")
    np.save(s0p, np.asarray(seq0, np.uint8))
    np.save(s1p, np.asarray(seq1, np.uint8))
    points = split_points(len(seq1), weights)
    urls = auto_urls("", N, use_sockets=True, base_port=base_port)

    procs = []
    for k in range(N):
        cfg = {
            "part": k,
            "nparts": N,
            "seq0": s0p,
            "seq1": s1p,
            "points": points,
            "urls": urls,
            "shared_dir": shared,
            "params": [params.match, params.mismatch, params.gap_open,
                       params.gap_ext],
            "max_partition": max_partition,
            "timeout": timeout,
            "device": devices[k] if devices else None,
            "platform": platform,
            "traceback": traceback,
            "output_format": output_format,
        }
        if kernel_cfg is not None:
            cfg["kernel_cfg"] = {
                "alpha": kernel_cfg.alpha, "rs": kernel_cfg.rs,
                "chunk": kernel_cfg.chunk,
            }
        cpath = os.path.join(work_dir, f"fork.{k:02d}.json")
        with open(cpath, "w") as f:
            json.dump(cfg, f)
        env = dict(os.environ)
        env.update(pins[k])
        if extra_env:
            env.update(extra_env)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "masa_tpu.parallel.fork", cpath],
            env=env,
        ))

    # the wait()-reaper (libmasa.cpp:605-630): any child failure kills
    # the run
    failed = []
    try:
        for k, p in enumerate(procs):
            rc = p.wait(timeout=timeout)
            if rc != 0:
                failed.append((k, rc))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError(f"fork workers failed: {failed}")

    with open(os.path.join(shared, "result.json")) as f:
        return json.load(f)


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1]))
