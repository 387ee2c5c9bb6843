"""Column-split multi-process stage 1: the reference's --split/--part and
--fork modes (libmasa.cpp:497-642).

Sequence #1 is split into weighted vertical slabs; each process computes
its slab, streaming its last column to the right neighbor through a cells
URL (file:// for the serial "fake backend", socket:// for forked
processes).  Best scores flow rightward through the AlignerPool.

This is the host/network-level layer; intra-host multi-device sharding
lives in parallel/sharded.py (ppermute between devices).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from masa_tpu.io import cells as cio
from masa_tpu.ops import strips
from masa_tpu.ops import wavefront as wf
from masa_tpu.types import INF, InitType, Recurrence, ScoreParams


def split_points(n: int, weights: list[float]) -> list[int]:
    """Column boundaries for weighted slabs (split_sequences,
    libmasa.cpp:497-535)."""
    total = sum(weights)
    pts = [0]
    acc = 0.0
    for w in weights[:-1]:
        acc += w
        pts.append(int(round(n * acc / total)))
    pts.append(n)
    return pts


def auto_urls(work_dir: str, nparts: int, use_sockets: bool = False,
              base_port: int = 7000) -> list[str]:
    """Boundary stream URLs between parts k and k+1 (STEP files or
    localhost sockets, libmasa.cpp:516-527, 585-595)."""
    if use_sockets:
        return [f"socket://127.0.0.1:{base_port + k}"
                for k in range(nparts - 1)]
    return [f"file://{work_dir}/STEP-{k:02d}.tmp"
            for k in range(nparts - 1)]


def _best_part(parts) -> int:
    """The slab owning the global endpoint, with the ENGINE tie-break
    (max score, then smallest i, then smallest j) — score-only argmax
    could pick a different co-optimal endpoint than the monolithic
    pipeline on a cross-slab tie."""
    return max(range(len(parts)),
               key=lambda k: (parts[k].best, -parts[k].best_i,
                              -parts[k].best_j))


@dataclasses.dataclass
class PartResult:
    best: int
    best_i: int
    best_j: int
    last_h: np.ndarray  # (width,) the part's final-row H (cells only)
    last_f: np.ndarray
    cells: int
    specials: object | None = None      # SpecialRowStore (slab-local)
    first_col: tuple | None = None      # stored (H, E) boundary column
    j0: int = 0
    j1: int = 0


class _CapturingReader(cio.CellsReader):
    """Tee a border stream into RAM so traceback can re-read it (the
    reference persists the loaded column through the SRA)."""

    def __init__(self, inner):
        self.inner = inner
        self.hs = []
        self.gs = []

    def read(self, n):
        h, g = self.inner.read(n)
        self.hs.append(np.asarray(h))
        self.gs.append(np.asarray(g))
        return h, g

    def column(self, row0_h: int):
        h = np.concatenate([[row0_h]] + self.hs).astype(np.int64)
        g = np.concatenate([[-INF]] + self.gs).astype(np.int64)
        return h, g

    def close(self):
        self.inner.close()


def march_slab(
    seq0: np.ndarray,
    slab: np.ndarray,
    params: ScoreParams,
    endpoint_local,  # Crosspoint in slab-local coordinates
    specials,        # SpecialRowStore protocol, slab-local columns
    first_col,       # (H, E) (m+1,) boundary column arrays, or None
    sw_anywhere: bool,
    backend: str = "auto",
    cfg: wf.WavefrontConfig | None = None,
    known: set | None = None,
):
    """Stage-2 marching confined to one slab: matches at special rows
    inside the slab and, when the optimal path exits through the slab's
    left boundary, against the stored boundary column (the reference's
    loaded-column matching, AlignerManager::findGoalCell semantics for
    vertical cuts).  Returns slab-local crosspoints ascending; the first
    one sits on the boundary (j == 0) if the path continues leftward.

    `known` (speculative traceback): stop as soon as a found crosspoint is
    already in the set — the caller splices the speculated chain (the
    already-computed check of sw_stage2.cpp:151-182)."""
    from masa_tpu.models.scoring import border_cells as _bc
    from masa_tpu.models.scoring import match_column
    from masa_tpu.stages import core
    from masa_tpu.types import (
        AlignmentStart, Crosspoint, CrosspointType, InitType, MatchType,
    )

    n_loc = len(slab)
    cps = [endpoint_local]
    cp = endpoint_local
    rev_seqs = (np.ascontiguousarray(seq0[::-1]),
                np.ascontiguousarray(slab[::-1]))
    row0_h, _ = _bc(n_loc + 1, InitType.WITH_ZEROES, params)
    row0_h = row0_h.astype(np.int64)

    while True:
        if sw_anywhere and cp.score <= 0:
            break
        if cp.i == 0 or cp.j == 0:
            break
        r = specials.next_below(cp.i, 1)
        if r is None or r == 0:
            r = 0
            fh = row0_h
            ff = np.full(n_loc + 1, -INF, np.int64)
        else:
            fh, ff = specials.get(r)
        goal_anywhere = sw_anywhere and core.goal_reachable(
            cp, r, params.match)
        goal = cp.score + (
            params.gap_open if cp.type != CrosspointType.MATCH else 0
        )

        width0 = core.initial_window(cp, r, backend)
        j_low = cp.j - width0
        found = None
        while True:
            at_edge = j_low <= 0
            rm = core.reverse_pass_and_match(
                seq0, slab, params, cp, r, fh, ff, max(j_low, 0),
                goal_anywhere, backend=backend, cfg=cfg,
                want_rev_col=at_edge and first_col is not None,
                rev_seqs=rev_seqs,
            )
            if rm.start_found:
                si, sj = rm.start
                found = Crosspoint(si, sj, 0, CrosspointType.MATCH)
                break
            if rm.crosspoint is not None:
                found = rm.crosspoint
                break
            if not at_edge:
                j_low = cp.j - 2 * (cp.j - j_low)
                continue
            # full slab width failed: the path exits through the boundary
            # column — match against the stored first column over rows
            # [r, cp.i] (reverse row p = cp.i - global row).
            if first_col is None or rm.rev_col is None:
                raise RuntimeError(
                    f"Backtrace lost in slab at row {r}"
                )
            rev_col_h, rev_col_e = rm.rev_col
            hb = cp.i - r
            fwd_h_col = np.asarray(first_col[0], np.int64)[
                r : cp.i + 1][::-1]
            fwd_e_col = np.asarray(first_col[1], np.int64)[
                r : cp.i + 1][::-1]
            mres = match_column(
                np.asarray(rev_col_h, np.int64)[: hb + 1],
                np.asarray(rev_col_e, np.int64)[: hb + 1],
                fwd_h_col, fwd_e_col, goal, params.gap_open,
            )
            if not mres.found:
                raise RuntimeError(
                    f"Backtrace lost at slab boundary (rows {r}..{cp.i})"
                )
            i_star = cp.i - mres.k
            t = (CrosspointType.MATCH if mres.type == MatchType.ALIGNED
                 else CrosspointType.GAP_1)
            found = Crosspoint(i_star, 0, int(mres.score), t)
            break

        cp = found
        cps.append(cp)
        if known and tuple(cp) in known:
            break
        specials.truncate_above(cp.i)
        if cp.j == 0:
            break

    return list(reversed(cps))


def run_part_stage1(
    seq0: np.ndarray,
    seq1: np.ndarray,
    part: int,
    points: list[int],
    params: ScoreParams = ScoreParams(),
    cfg: wf.WavefrontConfig | None = None,
    load_url: str | None = None,
    flush_url: str | None = None,
    route: str | None = None,
    buffered: bool = True,
    special_every: int = 0,
) -> PartResult:
    """Stage 1 over one vertical slab.  load_url supplies the left border
    (from part-1); flush_url receives this part's last column.  With
    special_every set, slab-local special rows and the captured boundary
    column are kept for pipelined traceback."""
    from masa_tpu.stages import core as score

    m = len(seq0)
    j0, j1 = points[part], points[part + 1]
    slab = np.ascontiguousarray(seq1[j0:j1])
    cfg = cfg or score.default_config()
    cfg = dataclasses.replace(
        cfg,
        recurrence=Recurrence.SMITH_WATERMAN,
        track_best=True,
        store_lastcol=flush_url is not None,
        # the kernels score from the config, not the params argument
        match=params.match, mismatch=params.mismatch,
        gap_open=params.gap_open, gap_ext=params.gap_ext,
    )

    reader = None
    writer = None
    capture = None
    if load_url:
        reader = cio.open_reader(load_url)
        if buffered:
            reader = cio.BufferedCellsReader(reader, chunk=cfg.rows,
                                             total=m)
        if special_every:
            reader = capture = _CapturingReader(reader)
    if flush_url:
        writer = cio.open_writer(flush_url)
        if buffered:
            writer = cio.BufferedCellsWriter(writer)

    store = score.SpecialRowStore() if special_every else None

    def on_special(r, bus_h, bus_f):
        h_full = np.empty(len(slab) + 1, np.int64)
        f_full = np.empty(len(slab) + 1, np.int64)
        h_full[0] = (capture.hs and capture.hs[-1][-1]) if capture else 0
        f_full[0] = -INF
        h_full[1:] = bus_h
        f_full[1:] = bus_f
        store.put(r, h_full, f_full)

    res = strips.run_partition(
        cfg, seq0, slab, params,
        InitType.WITH_ZEROES,
        InitType.CUSTOM if reader else InitType.WITH_ZEROES,
        first_col=None,
        route=route,
        first_col_reader=reader,
        lastcol_writer=writer,
        special_every=special_every,
        on_special_row=on_special if special_every else None,
    )
    if writer:
        writer.close()
    if reader:
        reader.close()
    return PartResult(
        best=res.best,
        best_i=res.best_i,
        best_j=j0 + res.best_j,
        last_h=np.asarray(res.last_h[1:]),
        last_f=np.asarray(res.last_f[1:]),
        cells=res.cells,
        specials=store,
        first_col=capture.column(0) if capture else None,
        j0=j0,
        j1=j1,
    )


def run_split_serial(
    seq0: np.ndarray,
    seq1: np.ndarray,
    nparts: int,
    work_dir: str,
    params: ScoreParams = ScoreParams(),
    cfg: wf.WavefrontConfig | None = None,
    route: str | None = None,
) -> list[PartResult]:
    """All parts in sequence with file:// handoff — the reference's
    single-machine distributed test mode."""
    points = split_points(len(seq1), [1.0] * nparts)
    urls = auto_urls(work_dir, nparts)
    out = []
    for k in range(nparts):
        out.append(run_part_stage1(
            seq0, seq1, k, points, params, cfg,
            load_url=urls[k - 1] if k > 0 else None,
            flush_url=urls[k] if k < nparts - 1 else None,
            route=route,
            buffered=False,
        ))
    return out


def pipelined_traceback(
    seq0: np.ndarray,
    seq1: np.ndarray,
    parts: list[PartResult],
    params: ScoreParams = ScoreParams(),
    backend: str = "auto",
    cfg: wf.WavefrontConfig | None = None,
):
    """Stage-2 pipelined across slabs right-to-left
    (executeTracebackPipelined, libmasa.cpp:659-696): each part marches
    within its slab; when the path exits through the slab boundary, the
    boundary crosspoint hands off to the left neighbor.  Returns global
    crosspoints ascending."""
    from masa_tpu.types import Crosspoint, CrosspointType

    best_k = _best_part(parts)
    p = parts[best_k]
    cp = Crosspoint(p.best_i, p.best_j, p.best, CrosspointType.MATCH)
    k = best_k
    all_cps: list = []
    while True:
        part = parts[k]
        local_ep = Crosspoint(cp.i, cp.j - part.j0, cp.score, cp.type)
        slab = np.ascontiguousarray(seq1[part.j0 : part.j1])
        local = march_slab(
            seq0, slab, params, local_ep, part.specials,
            part.first_col if k > 0 else None,
            sw_anywhere=True, backend=backend, cfg=cfg,
        )
        glob = [Crosspoint(c.i, c.j + part.j0, c.score, c.type)
                for c in local]
        all_cps = glob[:-1] + all_cps if all_cps else glob
        first = glob[0]
        if first.j > part.j0 or k == 0 or first.score <= 0:
            break
        cp = first
        k -= 1
    return all_cps


def speculate_slab(
    seq0: np.ndarray,
    slab: np.ndarray,
    params: ScoreParams,
    best: tuple[int, int, int],   # (i, j_global, score)
    j0: int,
    j1: int,
    specials,
    first_col,
    backend: str = "auto",
    cfg: wf.WavefrontConfig | None = None,
):
    """Speculative march from the slab-LOCAL best (the TPDS2016
    prediction).  Returns the slab-local chain, or None when the best
    lies outside the slab or the speculation fails (never fatal)."""
    import copy

    from masa_tpu.types import Crosspoint, CrosspointType

    bi, bj, bs = best
    if bs <= 0 or not (j0 < bj <= j1):
        return None
    ep = Crosspoint(bi, bj - j0, bs, CrosspointType.MATCH)
    try:
        return march_slab(
            seq0, slab, params, ep, copy.deepcopy(specials), first_col,
            sw_anywhere=True, backend=backend, cfg=cfg,
        )
    except RuntimeError:
        return None


def splice_speculation(local: list, spec: list | None):
    """Splice the speculated prefix when the confirmed chain landed on a
    speculated crosspoint (the already-computed check,
    sw_stage2.cpp:151-182).  Returns (chain, reused_count)."""
    if not spec or not local:
        return local, 0
    keys = {tuple(c): i for i, c in enumerate(spec)}
    hit = keys.get(tuple(local[0]))
    if hit is None:
        return local, 0
    return spec[: hit + 1] + local[1:], hit + 1


def speculative_traceback(
    seq0: np.ndarray,
    seq1: np.ndarray,
    parts: list[PartResult],
    params: ScoreParams = ScoreParams(),
    backend: str = "auto",
    cfg: wf.WavefrontConfig | None = None,
):
    """Incremental speculative traceback (TPDS2016;
    executeTracebackPredicted, libmasa.cpp:698-757): every part marches
    speculatively from its own stage-1 best score (in production these run
    concurrently with the confirmed pipeline); the confirmation pass
    marches from the true entry only until it hits a speculated
    crosspoint, then splices the speculated chain.

    Returns (crosspoints, reused_count) — reused_count is the number of
    crosspoints taken from speculation instead of recomputation."""
    from masa_tpu.types import Crosspoint, CrosspointType

    best_k = _best_part(parts)

    # --- speculative phase (parallel across parts in deployment) -------
    spec: dict[int, list] = {}
    for k in range(best_k):
        p = parts[k]
        s = speculate_slab(
            seq0, np.ascontiguousarray(seq1[p.j0 : p.j1]), params,
            (p.best_i, p.best_j, p.best), p.j0, p.j1, p.specials,
            p.first_col if k > 0 else None, backend=backend, cfg=cfg,
        )
        if s is not None:
            spec[k] = s

    # --- confirmation pass ---------------------------------------------
    p = parts[best_k]
    cp = Crosspoint(p.best_i, p.best_j, p.best, CrosspointType.MATCH)
    k = best_k
    all_cps: list = []
    reused = 0
    while True:
        part = parts[k]
        local_ep = Crosspoint(cp.i, cp.j - part.j0, cp.score, cp.type)
        slab = np.ascontiguousarray(seq1[part.j0 : part.j1])
        known = (
            {tuple(c) for c in spec[k]} if k in spec else None
        )
        local = march_slab(
            seq0, slab, params, local_ep, part.specials,
            part.first_col if k > 0 else None,
            sw_anywhere=True, backend=backend, cfg=cfg,
            known=known,
        )
        local, r = splice_speculation(local, spec.get(k))
        reused += r
        glob = [Crosspoint(c.i, c.j + part.j0, c.score, c.type)
                for c in local]
        all_cps = glob[:-1] + all_cps if all_cps else glob
        first = glob[0]
        if first.j > part.j0 or k == 0 or first.score <= 0:
            break
        cp = first
        k -= 1
    return all_cps, reused


def run_split_threads(
    seq0: np.ndarray,
    seq1: np.ndarray,
    nparts: int,
    params: ScoreParams = ScoreParams(),
    cfg: wf.WavefrontConfig | None = None,
    route: str | None = None,
    base_port: int = 7100,
) -> list[PartResult]:
    """All parts as concurrent THREADS in one JAX runtime, wired by real
    localhost sockets — the in-process harness for the socket cell
    streams.  For true one-runtime-per-slab processes (the reference's
    fork_multi_process, libmasa.cpp:540-642) use parallel/fork.run_fork."""
    import threading

    points = split_points(len(seq1), [1.0] * nparts)
    urls = auto_urls("", nparts, use_sockets=True, base_port=base_port)
    results: list = [None] * nparts
    errs: list = [None] * nparts

    def work(k):
        try:
            results[k] = run_part_stage1(
                seq0, seq1, k, points, params, cfg,
                load_url=urls[k - 1] if k > 0 else None,
                flush_url=urls[k] if k < nparts - 1 else None,
                route=route,
            )
        except Exception as e:  # pragma: no cover
            errs[k] = e

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(nparts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errs:
        if e:
            raise e
    return results


def align_oversize(
    seq0: np.ndarray,
    seq1: np.ndarray,
    max_width: int,
    work_dir: str,
    params: ScoreParams = ScoreParams(),
    cfg: wf.WavefrontConfig | None = None,
    route: str | None = None,
    max_cells_stage5: int = 1 << 18,
):
    """Full alignment when seq1 exceeds the aligner's per-run width
    capability: the matrix is tiled into chained column slabs with
    file:// border handoff (the reference's oversize-partition splitting,
    sw_stage1.cpp:362-375 + SpecialRowsArea::createSplittedPartitions,
    sra/SpecialRowsArea.cpp:146-207), then traced back with the pipelined
    slab marcher.  Returns (best, alignment)."""
    from masa_tpu.stages import core as score
    from masa_tpu.stages import pipeline, stage6

    nparts = -(-len(seq1) // max_width)
    points = split_points(len(seq1), [1.0] * nparts)
    urls = auto_urls(work_dir, nparts)
    kcfg = cfg or score.default_config()
    parts = []
    for k in range(nparts):
        parts.append(run_part_stage1(
            seq0, seq1, k, points, params, kcfg,
            load_url=urls[k - 1] if k > 0 else None,
            flush_url=urls[k] if k < nparts - 1 else None,
            route=route, buffered=False,
            special_every=kcfg.rows,
        ))
    cps = pipelined_traceback(seq0, seq1, parts, params,
                              backend="kernel", cfg=cfg)
    pcfg = pipeline.PipelineConfig(
        params=params, kernel_cfg=cfg, backend="kernel",
        max_cells_stage5=max_cells_stage5,
    )
    cps = pipeline.stage3_densify(seq0, seq1, pcfg, cps)
    aln = pipeline.stage5_emit(seq0, seq1, pcfg, cps)
    stage6.recheck(aln, seq0, seq1, params)
    best = max(p.best for p in parts)
    return best, aln
