#!/usr/bin/env python
"""Smoke run of the whole system on one NVIDIA GPU (H100).

Phases, in order; any failure exits non-zero and prints no result line:

  1. device  — platform must be "gpu"; prints the card's name and power
     limit (nvidia-smi).
  2. kernel  — the CUDA strip kernel against the lax.scan twin, exactly
     (int32 DP, tolerance 0), over every variant: SW/NW, each border
     init type, best tracking off/max/position, flush rows, last column,
     partial height, column window — small strips first, then NW with gap
     borders and flush rows, a partial height and a column window at the
     full strip height (524288 rows) and 1,048,576 columns; then one
     full-height stage-1 strip at 1,048,576 columns against the XLA row
     sweep (ops/rowsweep.sweep), timed warm against the scan twin and the
     row sweep.
  3. known pair — the CLI on the 3000 x 3000 seed-42 pair must report
     best=2204 at (3000,3000), stage 5 verified.
  4. full alignment — the CLI on the seed-generated 1M-class homologous
     pair: stage 5 verified, stage 6 re-score equal, stage 1's best and
     endpoint equal to an independent XLA row sweep over the pair; then
     stage 4's GPU route (the device-batched engine) against the native
     C++ pool, each followed by stage 5, on the run's stage-3 chain and
     on a thinned chain whose partitions make stage 4 do real work.

``--cards 4`` runs only the four-card path: the sharded alignment with
stage 4 off against the one-card pipeline on a small pair (equal
alignments), and a ``--split 4`` column-sharded CLI alignment of the 1M
pair against the one-card CLI run (equal stage-1 best and endpoint,
stage 5 verified and stage 6 equal on both).

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage:  python chip_smoke.py [--cards 4]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FULL_N = 1 << 20          # the 1M-class pair (BASELINE config 2)
FULL_COLS = 1 << 20       # phase-2 full-width strip


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------- phase 1


def phase_device(cards: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    if d.platform != "gpu":
        fail(f"platform is {d.platform!r}, not 'gpu'")
    if len(devs) < cards:
        fail(f"{cards} cards asked, {len(devs)} present")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    lines = smi.stdout.strip().splitlines()
    for ln in lines:          # as nvidia-smi gives them, one per card
        log(ln)
    return d, len(devs), lines[0]


# ---------------------------------------------------------------- phase 2


def _kernel_cases():
    """(name, R, P, nj, h_true, sw, track, lastcol, flush, border)."""
    cases = []
    k = 0
    for sw in (True, False):
        for track in (0, 1, 2):
            for lastcol in (False, True):
                border = ("zeroes", "gaps", "opened", "custom")[k % 4]
                cases.append((f"{'sw' if sw else 'nw'}-t{track}"
                              f"-lc{int(lastcol)}-{border}", 2048,
                              4096, 3001 + 37 * k, 2048, sw, track,
                              lastcol, 0, border))
                k += 1
    cases += [
        ("partial-height", 2048, 4096, 2500, 1333, True, 2, True, 0,
         "gaps"),
        ("partial-one-row", 2048, 1024, 700, 1, False, 2, True, 0,
         "custom"),
        ("partial-band-edge", 4096, 2048, 1500, 2304, True, 2, False, 0,
         "zeroes"),
        ("window", 2048, 8192, 1111, 2048, True, 2, False, 0, "zeroes"),
        ("one-column", 2048, 512, 1, 2048, True, 2, True, 0, "custom"),
        ("narrow", 2048, 512, 31, 2048, False, 1, True, 0, "opened"),
        ("flush", 4096, 4096, 3000, 4096, True, 2, False, 1024, "zeroes"),
        ("flush-max", 4096, 4096, 2999, 4096, True, 1, False, 512,
         "custom"),
        ("flush-nw", 8192, 2048, 2047, 8192, False, 0, False, 2048,
         "gaps"),
    ]
    return cases


def _full_cases(R: int, P: int):
    """The variants the full-size strip below does not cover, at the
    full strip height and width."""
    return [
        ("nw-gaps-flush", R, P, P, R, False, 0, True, R // 4, "gaps"),
        ("sw-partial-height", R, P, P - 3, R - 777, True, 2, True, 0,
         "opened"),
        ("sw-window", R, P, 700001, R, True, 1, False, 0, "custom"),
    ]


def _case_inputs(rng, R, P, border, go, ge, a=None, b=None):
    import numpy as np

    from masa_tpu.ops import wavefront as wf

    if a is None:
        a = rng.integers(0, 4, R).astype(np.int32)
        b = rng.integers(0, 4, P).astype(np.int32)
    bus_h = rng.integers(-40, 60, P).astype(np.int32)
    bus_f = (bus_h - rng.integers(3, 30, P)).astype(np.int32)
    k = np.arange(1, R + 1)
    if border == "zeroes":
        ih, corner = np.zeros(R, np.int32), 0
    elif border == "gaps":
        ih, corner = (-go - k * ge).astype(np.int32), 0
    elif border == "opened":
        ih, corner = (-k * ge).astype(np.int32), 0
    else:
        ih = rng.integers(-60, 40, R).astype(np.int32)
        corner = int(rng.integers(-20, 20))
    ie = (ih - rng.integers(3, 30, R)).astype(np.int32) \
        if border == "custom" else np.full(R, wf.NEG, np.int32)
    return a, b, bus_h, bus_f, ih, ie, corner


def _check_cases(cases, rng, seqs=None) -> int:
    """Each case through the CUDA kernel and the scan twin: every output
    must be equal, element for element."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from masa_tpu.ops import wavefront as wf
    from masa_tpu.types import Recurrence

    base = wf.WavefrontConfig(alpha=4, rs=4, chunk=512)
    for (name, R, P, nj, h_true, sw, track, lastcol, flush,
         border) in cases:
        cfg = dataclasses.replace(
            base, rs=R // 512,
            recurrence=(Recurrence.SMITH_WATERMAN if sw
                        else Recurrence.NEEDLEMAN_WUNSCH),
            track_best=track > 0, track_pos=track == 2,
            store_lastcol=lastcol, flush_every=flush)
        a, b = (seqs[0][:R], seqs[1][:P]) if seqs else (None, None)
        ins = _case_inputs(rng, R, P, border, cfg.gap_open, cfg.gap_ext,
                           a, b)
        args = [jnp.asarray(x) for x in ins[:6]] + [jnp.int32(ins[6])]
        t0 = time.time()
        got = jax.device_get(wf.strip(cfg, "cuda", *args, nj=nj,
                                      h_true=h_true))
        t1 = time.time()
        ref = jax.device_get(wf.strip(cfg, "scan", *args, nj=nj,
                                      h_true=h_true))
        if sorted(got) != sorted(ref):
            fail(f"kernel case {name}: outputs {sorted(got)} vs "
                 f"{sorted(ref)}")
        for key in ref:
            g, r = np.asarray(got[key]), np.asarray(ref[key])
            if g.shape != r.shape or not np.array_equal(g, r):
                bad = np.argwhere(g != r) if g.shape == r.shape else None
                fail(f"kernel case {name}: {key} differs "
                     f"(shape {g.shape} vs {r.shape}, first "
                     f"{bad[:3].tolist() if bad is not None else '-'})")
        if seqs:
            log(f"[kernel] {name} {R} x {P} (width {nj}, height "
                f"{h_true}): equal to the scan twin (cold: kernel "
                f"{t1 - t0:.2f} s, scan twin {time.time() - t1:.2f} s)")
    return len(cases)


def phase_kernel() -> None:
    import numpy as np

    n_ok = _check_cases(_kernel_cases(), np.random.default_rng(7))
    log(f"[kernel] {n_ok} variant cases equal the scan twin exactly")


def _sweep_chain(a_rows, b_cols, block: int, lastcol: bool = False,
                 flush_rows=()):
    """The XLA row sweep (ops/rowsweep.sweep, sw=True, track_best=True)
    over a zero-bordered SW matrix, chained in `block`-row calls.
    Returns (best, i, j) in DP coordinates, the last row (h, f) without
    the border, the last column (h, e) if asked, the rows named in
    `flush_rows`, and the seconds the calls took (compiled ahead)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from masa_tpu.ops import rowsweep
    from masa_tpu.ops import wavefront as wf
    from masa_tpu.types import ScoreParams

    p = ScoreParams()
    n1 = len(b_cols) + 1
    block = min(block, len(a_rows))
    # sentinel rows pad the last block: they never match and only lose
    # score, so the best is unchanged (the last row is then not row m)
    m = -(-len(a_rows) // block) * block
    a_rows = np.concatenate([np.asarray(a_rows, np.int32), np.full(
        m - len(a_rows), wf.A_SENTINEL, np.int32)])
    b_row = jnp.asarray(np.concatenate([[0], b_cols]).astype(np.int32))
    h0 = jnp.zeros(block, jnp.int32)
    e0 = jnp.full(block, wf.NEG, jnp.int32)
    rh = jnp.zeros(n1, jnp.int32)
    rf = jnp.full(n1, wf.NEG, jnp.int32)
    a_dev = jnp.asarray(np.asarray(a_rows, np.int32))
    kw = dict(n1=n1, m_steps=block, sw=True, go=p.gap_open, ge=p.gap_ext,
              match=p.match, mismatch=p.mismatch, track_best=True,
              want_lastcol=lastcol)
    comp = rowsweep.sweep.lower(a_dev[:block], b_row, h0, e0, rh, rf,
                                jnp.int32(block), **kw).compile()
    best = (wf.NEG, 0, 0)
    lch, lce, rows = [], [], {}
    t0 = time.time()
    for r0 in range(0, m, block):
        out = comp(a_dev[r0 : r0 + block], b_row, h0, e0, rh, rf,
                   jnp.int32(block))
        rh, rf = out["h"], out["f"]
        v, i, j = (int(x) for x in jax.device_get(out["best"]))
        if v > best[0]:
            best = (v, r0 + i, j)
        if lastcol:
            lch.append(out["lastcol_h"])
            lce.append(out["lastcol_e"])
        if r0 + block in flush_rows:
            rows[r0 + block] = (rh[1:], rf[1:])
    jax.block_until_ready(rh)
    secs = time.time() - t0
    last = (np.asarray(rh)[1:], np.asarray(rf)[1:])
    col = ((np.concatenate([np.asarray(x) for x in lch]),
            np.concatenate([np.asarray(x) for x in lce]))
           if lastcol else None)
    return best, last, col, rows, secs


def phase_kernel_full():
    """The full-size variant cases against the scan twin, then one
    full-height stage-1 strip at 1,048,576 columns: the CUDA kernel
    against the XLA row sweep (bus, interior rows, last column, best and
    endpoint), and warm times of the kernel, the scan twin and the row
    sweep on the same strip."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import make_pair
    from masa_tpu.ops import wavefront as wf
    from masa_tpu.stages.core import default_config

    base = default_config()
    R, nj, flush = base.rows, FULL_COLS, base.rows // 4
    cfg = dataclasses.replace(base, track_best=True, store_lastcol=True,
                              flush_every=flush)
    s0, s1 = make_pair(FULL_N)
    s1 = np.concatenate([s1, s0])[:nj]     # the homolog may be shorter
    _check_cases(_full_cases(R, nj), np.random.default_rng(11),
                 (s0.astype(np.int32), s1.astype(np.int32)))
    a = jnp.asarray(s0[:R].astype(np.int32))
    b = jnp.asarray(s1.astype(np.int32))
    zeros_c = jnp.zeros(nj, jnp.int32)
    neg_c = jnp.full(nj, wf.NEG, jnp.int32)
    zeros_r = jnp.zeros(R, jnp.int32)
    neg_r = jnp.full(R, wf.NEG, jnp.int32)
    args = (a, b, zeros_c, neg_c, zeros_r, neg_r, jnp.int32(0))

    def run(route, c):
        f = jax.jit(lambda *x: wf.strip(c, route, *x, nj=nj, h_true=R))
        comp = f.lower(*args).compile()
        t0 = time.time()
        out = jax.block_until_ready(comp(*args))
        return out, time.time() - t0

    run("cuda", cfg)                                # warm the launch path
    got, t_cuda = run("cuda", cfg)
    cfg_plain = dataclasses.replace(cfg, store_lastcol=False, flush_every=0)
    _, t_cuda_plain = run("cuda", cfg_plain)
    best = tuple(int(x) for x in jax.device_get(wf.merge_best_device(
        (jnp.int32(wf.NEG), jnp.int32(0), jnp.int32(0)),
        got["best_v"], got["best_j"], 0, 0)))
    ref_best, (ref_h, ref_f), (col_h, col_e), rows, t_sweep = _sweep_chain(
        s0[:R], s1[:nj], flush, lastcol=True,
        flush_rows=tuple(range(flush, R, flush)))
    checks = {
        "best": best == ref_best,
        "bus_h": np.array_equal(np.asarray(got["bus_h"]), ref_h),
        "bus_f": np.array_equal(np.asarray(got["bus_f"]), ref_f),
        "lastcol_h": np.array_equal(np.asarray(got["lastcol_h"]), col_h),
        "lastcol_e": np.array_equal(np.asarray(got["lastcol_e"]), col_e),
    }
    for q, r in enumerate(range(flush, R, flush)):
        checks[f"row{r}"] = (
            np.array_equal(np.asarray(got["rows_h"][q]), rows[r][0])
            and np.array_equal(np.asarray(got["rows_f"][q]), rows[r][1]))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"full strip {R} x {nj}: kernel != row sweep on {bad} "
             f"(kernel best {best}, sweep best {ref_best})")
    log(f"[kernel] full strip {R} x {nj}: equal to the XLA row sweep "
        f"(best {best}; bus, {len(rows)} interior rows, last column)")
    _, t_scan = run("scan", cfg_plain)
    cells = R * nj
    for name, t in (("cuda kernel", t_cuda_plain),
                    ("cuda kernel +lastcol +3 rows", t_cuda),
                    ("XLA scan twin", t_scan),
                    ("XLA row sweep (4 chained calls)", t_sweep)):
        log(f"[timing] strip {R} x {nj} {name}: {t:.3f} s "
            f"({cells / t / 1e9:.1f} GCUPS)")
    return {"cuda_s": t_cuda_plain, "scan_s": t_scan, "sweep_s": t_sweep}


# ------------------------------------------------------------ phases 3-4


def _write_fasta(path: str, name: str, seq: bytes) -> None:
    with open(path, "w") as fh:
        fh.write(f">{name} chip_smoke\n")
        for k in range(0, len(seq), 70):
            fh.write(seq[k : k + 70].decode() + "\n")


def _cli(argv: list[str]) -> tuple[str, float]:
    """The CLI in this process (a second JAX process could not get the
    card); returns its stdout and wall seconds."""
    import contextlib
    import io

    from masa_tpu.cli import main as cli_main

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    secs = time.time() - t0
    out = buf.getvalue()
    for ln in out.splitlines():
        if not ln.startswith("stage1: ..."):
            log(f"    | {ln}")
    if rc != 0:
        fail(f"CLI {argv} exited {rc}")
    return out, secs


def _check_cli(out: str, what: str):
    m1 = re.search(r"stage1: best=(-?\d+) at \((\d+),(\d+)\)", out)
    m5 = re.search(r"stage5: score=(-?\d+) verified", out)
    m6 = re.search(r"alignment score: (-?\d+)", out)
    if not (m1 and m5 and m6 and "stage6: wrote" in out):
        fail(f"{what}: stage lines missing from the CLI output")
    s1, s5, s6 = int(m1.group(1)), int(m5.group(1)), int(m6.group(1))
    if not s1 == s5 == s6:
        fail(f"{what}: stage1 {s1}, stage5 {s5}, stage6 {s6} differ")
    stages = {f"stage{k}": float(v) for k, v in re.findall(
        r"stage(\d): [^\n]* in (\d+\.\d+)s", out)}
    return (s1, int(m1.group(2)), int(m1.group(3))), stages


def phase_known_pair(tmp: str) -> None:
    import numpy as np

    rng = np.random.default_rng(42)
    s0 = "".join(rng.choice(list("ACGT"), 3000))
    s1 = list(s0)
    idx = rng.random(3000) < 0.08
    for i in np.nonzero(idx)[0]:
        s1[i] = "ACGT"[rng.integers(4)]
    a, b = os.path.join(tmp, "k0.fa"), os.path.join(tmp, "k1.fa")
    _write_fasta(a, "known0", s0.encode())
    _write_fasta(b, "known1", "".join(s1).encode())
    out, _ = _cli([a, b, "--work-dir", os.path.join(tmp, "known.work")])
    best, _ = _check_cli(out, "known pair")
    if best != (2204, 3000, 3000):
        fail(f"known pair: stage1 {best}, expected (2204, 3000, 3000)")
    log("[known pair] best=2204 at (3000,3000), stage 5 verified, "
        "stage 6 equal")


def phase_full(tmp: str, timing: dict) -> None:
    from bench import make_pair

    s0, s1 = make_pair(FULL_N)
    a, b = os.path.join(tmp, "f0.fa"), os.path.join(tmp, "f1.fa")
    _write_fasta(a, "pair0", s0.tobytes())
    _write_fasta(b, "pair1", s1.tobytes())
    runs = {}
    for name in ("cold", "warm"):
        out, secs = _cli([a, b, "--work-dir",
                          os.path.join(tmp, f"full.{name}")])
        runs[name] = (_check_cli(out, f"1M pair ({name})"), secs)
    (best, stages), warm_s = runs["warm"]
    if runs["cold"][0][0] != best:
        fail(f"1M pair: cold {runs['cold'][0][0]} != warm {best}")
    ref, _, _, _, t_ref = _sweep_chain(s0, s1, 1 << 17)
    if ref != best:
        fail(f"1M pair: stage1 best/endpoint {best} != row sweep {ref}")
    log(f"[full] {len(s0)} x {len(s1)}: best={best[0]} at "
        f"({best[1]},{best[2]}) = XLA row sweep ({t_ref:.1f} s); "
        f"stage 5 verified, stage 6 equal")
    log(f"[full] wall warm {warm_s:.2f} s, cold {runs['cold'][1]:.2f} s; "
        f"stages (warm) " + " ".join(f"{k}={v:.2f}s"
                                     for k, v in sorted(stages.items())))
    log(f"[full] stage-1 strip kernel {timing['cuda_s']:.3f} s vs XLA "
        f"scan twin {timing['scan_s']:.3f} s, row sweep "
        f"{timing['sweep_s']:.3f} s")
    _stage4_routes(s0, s1, os.path.join(tmp, "full.warm"), best[0])


# Stage 4 on a thinned chain: every THIN-th stage-3 crosspoint, so each
# partition spans THIN special rows (65536 rows at the 1M pair's 512-row
# spacing, as a run with a sixteenth of the default SRA budget would
# leave), and stage 4's first level sends its 32768-row halves through
# the strip kernel.
THIN = 128


def _stage4_routes(s0, s1, work: str, score: int) -> None:
    """Stage 4 on the warm run's stage-3 crosspoints, and on a thinned
    chain of them, through the GPU route (stage4_reduce: the device-
    batched engine) and through the native C++ pool it replaced, each
    followed by stage 5: both must give the stage-1 score.  Stage 4 +
    stage 5 is the figure that compares them (the batched engine stops
    splitting at what stage 5 absorbs)."""
    from masa_tpu.core.crosspoints import CrosspointsFile
    from masa_tpu.native import bindings
    from masa_tpu.ops import myers_miller as mm
    from masa_tpu.stages import pipeline
    from masa_tpu.types import ScoreParams

    cps = CrosspointsFile(os.path.join(work, "crosspoints",
                                       "crosspoint_03.00")).load()
    thin = cps[::THIN] + ([cps[-1]] if (len(cps) - 1) % THIN else [])
    pcfg = pipeline.PipelineConfig(params=ScoreParams())
    routes = {
        "batched": lambda c: mm.stage4_reduce(
            s0, s1, c, pcfg.params, 16,
            stage5_max_cells=pcfg.max_cells_stage5),
        "native": lambda c: bindings.reduce_partitions(
            s0, s1, c, pcfg.params, 16),
    }
    # the thinned chain's first batched call compiles its level shapes
    for label, chain, order in (
            ("stage-3 chain", cps, ("batched", "native")),
            (f"every {THIN}th crosspoint", thin,
             ("batched", "batched", "native"))):
        h = max(c1.i - c0.i for c0, c1 in zip(chain, chain[1:]))
        w = max(c1.j - c0.j for c0, c1 in zip(chain, chain[1:]))
        for engine in order:
            t0 = time.time()
            out = routes[engine](chain)
            t1 = time.time()
            aln = pipeline.stage5_emit(s0, s1, pcfg, out)
            t2 = time.time()
            if aln.raw_score != score:
                fail(f"stage 4 via {engine} on the {label}: score "
                     f"{aln.raw_score} != {score}")
            log(f"[stage4] {label} ({len(chain) - 1} partitions, "
                f"largest {h} x {w}) {engine}: stage 4 {t1 - t0:.3f} s "
                f"({len(out)} crosspoints), stage 5 {t2 - t1:.3f} s, "
                f"stage 4+5 {t2 - t0:.3f} s")


def _identity_small(cards: int) -> None:
    """On a pair small enough that its alignment is unique, the sharded
    pipeline with stage 4 off must give the one-card pipeline's
    alignment, byte for byte, and the oracle's score."""
    import numpy as np

    from masa_tpu.ops import oracle
    from masa_tpu.ops.wavefront import WavefrontConfig
    from masa_tpu.parallel.mesh import make_mesh
    from masa_tpu.parallel.sharded import sharded_align
    from masa_tpu.stages import pipeline
    from masa_tpu.types import ScoreParams

    cfg = WavefrontConfig(alpha=4, rs=1, chunk=512, track_best=True,
                          store_lastcol=True)
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, size=600).astype(np.uint8)
    # homologous tail so the optimal path spans several slabs
    s1 = np.concatenate([rng.choice(bases, size=32 * cards)
                         .astype(np.uint8), s0])
    params = ScoreParams()
    ref = oracle.dp_rows(s0, s1, params).best
    best, aln = sharded_align(s0, s1, make_mesh(cards), cfg, params,
                              max_partition=0)
    mono = pipeline.align_pair(s0, s1, pipeline.PipelineConfig(
        params=params, max_partition=0))
    if not best == aln.raw_score == mono.raw_score == ref:
        fail(f"small pair: sharded {best}/{aln.raw_score}, one card "
             f"{mono.raw_score}, oracle {ref}")
    if (aln.gaps, aln.start, aln.end) != (mono.gaps, mono.start, mono.end):
        fail("small pair: sharded alignment != one-card alignment")
    log(f"[cards] small pair {len(s0)} x {len(s1)} over {cards} cards: "
        f"alignment equal to one card (score {best} = oracle)")


def phase_cards(tmp: str, cards: int) -> None:
    """The column-sharded path over `cards` GPUs (shard_map + ppermute).
    On a small pair: the sharded alignment equals the one-card one.  On
    the 1M pair: the CLI's --split run against the one-card CLI run,
    equal stage-1 best and endpoint (they do not depend on how the matrix
    is partitioned), stage 5 verified and stage 6 equal on both.  The two
    1M alignments themselves may differ where the pair has co-optimal
    paths (the slab march and the one-card march cross different rows);
    both are re-scored by stage 6."""
    from bench import make_pair

    _identity_small(cards)
    s0, s1 = make_pair(FULL_N)
    a, b = os.path.join(tmp, "f0.fa"), os.path.join(tmp, "f1.fa")
    _write_fasta(a, "pair0", s0.tobytes())
    _write_fasta(b, "pair1", s1.tobytes())
    out, t_split = _cli([a, b, "--split", str(cards), "--work-dir",
                         os.path.join(tmp, "split.work")])
    if f"sharded over {cards} devices" not in out:
        fail(f"--split {cards} did not run sharded")
    split_best, split_stages = _check_cli(out, f"--split {cards}")
    out, t_one = _cli([a, b, "--work-dir", os.path.join(tmp, "one.work")])
    one_best, _ = _check_cli(out, "one-card run")
    if split_best != one_best:
        fail(f"--split {cards} stage 1 {split_best} != one card {one_best}")
    log(f"[cards] --split {cards}: best={split_best[0]} at "
        f"({split_best[1]},{split_best[2]}) = one card; stage 5 verified, "
        f"stage 6 equal on both; wall {t_split:.2f} s (one card "
        f"{t_one:.2f} s); stages " + " ".join(
            f"{k}={v:.2f}s" for k, v in sorted(split_stages.items())))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card sharded path")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from masa_tpu.utils.devices import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    dev, count, _ = phase_device(args.cards)
    with tempfile.TemporaryDirectory(prefix="chip_smoke.") as tmp:
        if args.cards > 1:
            phase_cards(tmp, args.cards)
        else:
            phase_kernel()
            timing = phase_kernel_full()
            phase_known_pair(tmp)
            phase_full(tmp, timing)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)


if __name__ == "__main__":
    main()
