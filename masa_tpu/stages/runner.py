"""Persistent stage functions: the pipeline wired to Job/SRA/crosspoints
artifacts with crash-safe resume — the equivalents of
stage{1..6}/sw_stage{1..6}.cpp plus the executeTraceback sequencing of
libmasa.cpp:644-655.
"""

from __future__ import annotations

import time

import numpy as np

from masa_tpu.biology import alignment as balign
from masa_tpu.biology.sequence import Sequence
from masa_tpu.core.best_score import BestScoreList
from masa_tpu.core.job import Job
from masa_tpu.models.scoring import border_cells
from masa_tpu.ops import myers_miller as mm
from masa_tpu.stages import core, pipeline, stage6 as st6
from masa_tpu.types import (
    INF,
    AlignmentStart,
    Crosspoint,
    CrosspointType,
    InitType,
    Recurrence,
)

STAGE_1, STAGE_2, STAGE_3, STAGE_4, STAGE_5, STAGE_6 = range(1, 7)


class _NoTruncate:
    """Multi-alignment runs share the stage-1 rows; truncation is
    disabled so later ids can still match."""

    def __init__(self, part):
        self._part = part

    def __getattr__(self, name):
        return getattr(self._part, name)

    def truncate_above(self, i):
        pass


class _OffsetDevCache:
    """DevRowCache shim rebasing partition-frame row indices (a resumed
    stage 1 computes rows r0..m as 0..m-r0) to global ones; reads are
    already global."""

    def __init__(self, cache, offset: int):
        self.cache = cache
        self.offset = offset

    def put_dev(self, r, dev_h, dev_f):
        self.cache.put_dev(self.offset + r, dev_h, dev_f)

    def attach_border(self, r, h0, f0):
        self.cache.attach_border(self.offset + r, h0, f0)

    def get(self, r):
        return self.cache.get(r)

    def truncate_above(self, i):
        self.cache.truncate_above(i)


class _OffsetStore:
    """Adapter translating partition-local row indices to absolute ones and
    mirroring progress into the status file."""

    def __init__(self, part, offset: int, job: Job | None = None):
        self.part = part
        self.offset = offset
        self.job = job

    def put(self, r, h, f):
        self.part.put(self.offset + r, h, f)
        if self.job:
            self.job.status.update(last_special_row=self.offset + r)

    def put_lazy(self, r, lazy):
        if hasattr(self.part, "put_lazy"):
            self.part.put_lazy(self.offset + r, lazy)
        else:
            self.part.put(self.offset + r, *lazy.full_rows())
        if self.job:
            self.job.status.update(last_special_row=self.offset + r)

    def finalize(self):
        if hasattr(self.part, "finalize"):
            self.part.finalize()

    def get(self, r):
        return self.part.get(r)

    def get_window(self, r, lo, hi):
        return self.part.get_window(r, lo, hi)

    def rows(self):
        return self.part.rows()

    def next_below(self, i, min_dist=1):
        return self.part.next_below(i, min_dist)

    def truncate_above(self, i):
        return self.part.truncate_above(i)


def _pcfg(job: Job, kernel_cfg=None) -> pipeline.PipelineConfig:
    return pipeline.PipelineConfig(
        params=job.cfg.params,
        alignment_start=job.cfg.alignment_start,
        alignment_end=job.cfg.alignment_end,
        backend=job.cfg.backend,
        kernel_cfg=kernel_cfg,
        max_cells_stage5=job.cfg.stage5_max_cells,
    )


def stage1(job: Job, seq0: np.ndarray, seq1: np.ndarray,
           kernel_cfg=None, log=print) -> BestScoreList:
    """Forward wavefront over the whole matrix with persisted special rows;
    resumable from the last flushed row (sw_stage1.cpp:210-217)."""
    t0 = time.time()
    m, n = len(seq0), len(seq1)
    pcfg = _pcfg(job, kernel_cfg)
    # the strip and the special-row spacing (the SRA budget's interval
    # snapped to the kernel's flush grain, stage1_plan)
    spacing = None
    if kernel_cfg is not None:
        kcfg = kernel_cfg
    else:
        kcfg, spacing = core.stage1_plan(m, n, job.sra_limit())
    # align_to=spacing lands interval_0 exactly on the planned cadence
    ivs = job.calculate_flush_intervals(m, n,
                                        align_to=spacing or kcfg.rows)
    cpf = job.crosspoints_file(STAGE_1, 0)

    import os

    if os.path.exists(cpf.path):
        try:
            best = BestScoreList(job.cfg.max_alignments)
            loaded = 0
            for aln_id in range(job.cfg.max_alignments):
                f = job.crosspoints_file(STAGE_1, aln_id)
                if not os.path.exists(f.path):
                    break
                cps = f.load()
                if f.complete and cps:
                    best.add(cps[0].i, cps[0].j, cps[0].score)
                    loaded += 1
            if loaded:
                log("stage1: already executed (resume)")
                return best
        except Exception:
            pass

    row_init, col_init = pipeline._mode_inits(pcfg.alignment_start)
    area = job.sra_area(STAGE_1, 0)
    part = area.open_partition(0, 0) or area.create_partition(
        0, 0, m, n, row_init=row_init, col_init=col_init)
    r0 = part.last_row() or 0
    store = _OffsetStore(part, r0, job)

    rec = pipeline._recurrence(pcfg.alignment_start)
    end = pipeline._effective_end(pcfg)
    want_lastcol = end in (AlignmentStart.SEQUENCE_1,
                           AlignmentStart.SEQUENCE_1_OR_2)
    first_row = None
    first_col = None
    if r0:
        log(f"stage1: resuming from special row {r0}")
        rh, rf = part.get(r0)
        first_row = (rh, rf)
        # rebuild init conditions from the partition's recorded border
        # types (the reference encodes them per row/col file,
        # SpecialRowsPartition.cpp:129-175) rather than trusting the
        # resumed run's flags
        saved_col = (InitType(part.col_init)
                     if part.col_init is not None else col_init)
        row_init = InitType.CUSTOM
        if saved_col == InitType.WITH_ZEROES:
            # zero borders are offset-invariant: the sub-partition from
            # r0 synthesizes them, keeping the device-sliced fast path
            # (a CUSTOM column forces the host data path for the WHOLE
            # resumed stage 1 — at 23M that is the difference between a
            # resumed run and a crippled one)
            col_init_eff = saved_col
        else:
            ch, cg = border_cells(m + 1, saved_col, job.cfg.params)
            first_col = (ch[r0:], cg[r0:])
            col_init_eff = InitType.CUSTOM
    else:
        col_init_eff = col_init

    # pinned endpoints (NW/semi-global) may legitimately be negative —
    # the min-score admission filter only applies to SW candidates
    best = BestScoreList(job.cfg.max_alignments,
                         min_score=(0 if rec == Recurrence.SMITH_WATERMAN
                                    else -INF),
                         min_distance=job.cfg.best_score_distance)
    sink = None
    if job.cfg.max_alignments > 1 and rec == Recurrence.SMITH_WATERMAN:
        sink = lambda i, j, s: best.add(r0 + i, j, s)
    blocks = None
    blocks_sink = None
    if job.cfg.dump_blocks:
        from masa_tpu.core.blocks_file import BlocksFile

        blocks = BlocksFile(job.path("blocks.00.bin"))
        blocks_sink = lambda rows_done, maxima: blocks.add_row(maxima)

    # 2-s progress line (the reference's RecurrentTimer,
    # sw_stage1.cpp:315,378) reading the crash-safe status file state
    from masa_tpu.utils.timer import RecurrentTimer, Timer

    def _tick():
        r = max(job.status.last_special_row, 0)
        log(f"stage1: ... flushed row {r}/{m} "
            f"({100.0 * r / max(m, 1):.1f}%)")

    timer = Timer()
    timer.create_event("compute")
    ticker = RecurrentTimer(2.0, _tick)
    ticker.start()
    # device-resident special-row cache for stage 2's on-device matching;
    # survives to stage2() through the (in-process) job object.  Resume
    # offset r0 rebases partition-frame rows to global ones.
    dev_cache = core.DevRowCache()
    job.runtime_dev_rows = _OffsetDevCache(dev_cache, r0)

    # lazy special rows: RAM-destined rows never leave the device (the
    # device cache is what stage 2 matches against); disk checkpoints
    # transfer asynchronously in the device's packed form (no host
    # decode/encode — at 23M the eager path costs ~2.5-4 s of host work
    # per 200 MB row).  HBM safety: only RAM-destined rows pin their
    # snapshots indefinitely, and proportional placement bounds those by
    # the RAM budget; in-flight disk rows are capped by the SRA's
    # pending-bytes drain (core/sra._PENDING_CAP).
    n_specials = (m - r0) // max(ivs[0], 1)
    snap_bytes = n_specials * 2 * (n + 65536) * 4
    ram_pinned = min(snap_bytes, job.cfg.ram_limit)
    lazy_rows = ram_pinned + (2 << 30) <= dev_cache.budget

    try:
        res = core.forward_pass(
            seq0[r0:], seq1, job.cfg.params, rec, row_init, col_init_eff,
            first_row=first_row, first_col=first_col,
            special_every=ivs[0], store=store,
            dev_cache=job.runtime_dev_rows,
            backend=job.cfg.backend, cfg=kcfg,
            prune=job.cfg.block_pruning,
            # endpoint selection from the last row/column needs real
            # (unpadded) final rows
            pad_rows=(rec == Recurrence.SMITH_WATERMAN
                      and end == AlignmentStart.ANYWHERE),
            best_sink=sink,
            blocks_sink=blocks_sink,
            want_lastcol=want_lastcol,
            nw_best=(end == AlignmentStart.ANYWHERE
                     and rec == Recurrence.NEEDLEMAN_WUNSCH),
            lazy_rows=lazy_rows,
        )
        store.finalize()
    finally:
        ticker.stop()
    timer.event_record("compute")
    if blocks is not None:
        blocks.save()
        log(f"stage1: wrote {blocks.path}")
    with job.stats_file(STAGE_1, 0) as fh:
        timer.print_statistics(fh, cells=res.cells)

    if rec == Recurrence.SMITH_WATERMAN and end == AlignmentStart.ANYWHERE:
        best.add(r0 + res.best_i, res.best_j, res.best)
        prev = job.status.best
        if r0 and prev[2] > res.best:
            best.add(*prev)
    else:
        ep = pipeline.select_endpoint(res, m - r0, n, end, rec)
        best.add(r0 + ep.i, ep.j, ep.score)
        if r0 + ep.i == m:
            part.put(m, res.last_h, res.last_f)

    # one endpoint crosspoint file per alignment id (crosspoint_01.II)
    for aln_id, s in enumerate(best):
        f = cpf if aln_id == 0 else job.crosspoints_file(STAGE_1, aln_id)
        f.set_autosave()
        f.write(Crosspoint(s.i, s.j, s.score, CrosspointType.MATCH))
        f.close()
    b = best.best
    job.status.update(stage=STAGE_1, best=(b.i, b.j, b.score))
    dt = time.time() - t0
    log(f"stage1: best={b.score} at ({b.i},{b.j})  "
        f"{res.cells/1e6:.1f} Mcells in {dt:.2f}s "
        f"({res.cells/dt/1e9:.2f} GCUPS)"
        + (f"  pruned={res.pruned_cells/1e6:.1f} Mcells "
           f"({100.0 * res.pruned_cells / max(res.cells + res.pruned_cells, 1):.1f}%)"
           if res.pruned_cells else ""))
    return best


def stage2(job: Job, seq0: np.ndarray, seq1: np.ndarray, aln_id: int = 0,
           kernel_cfg=None, log=print) -> list[Crosspoint]:
    """Reverse goal-score marching at the stage-1 special rows
    (sw_stage2.cpp:237).

    Crosspoints are autosaved incrementally as the march proceeds and the
    stage-1 SRA is truncated behind each one (sw_stage2.cpp:364-366,441 +
    SpecialRowsArea::truncatePartition), so a crash mid-stage resumes from
    the deepest crosspoint already found instead of recomputing the whole
    march.  A partial (END-less) file holds the chain in found order
    (endpoint first, descending i — the reference stores it the same way
    and reverses at stage end); the completed file is ascending."""
    t0 = time.time()
    pcfg = _pcfg(job, kernel_cfg)
    out_cpf = job.crosspoints_file(STAGE_2, aln_id)

    import os

    prior: list[Crosspoint] = []   # descending (found order) on resume
    if os.path.exists(out_cpf.path):
        try:
            cps = out_cpf.load()
            if out_cpf.complete and cps:
                log("stage2: already executed (resume)")
                return cps
            prior = cps
        except Exception:
            pass

    endpoint = job.crosspoints_file(STAGE_1, aln_id).load()[0]
    area = job.sra_area(STAGE_1, 0)
    part = area.open_partition(endpoint.i, endpoint.j)
    if part is None:
        raise RuntimeError("stage2: no stage-1 special rows area")
    if job.cfg.max_alignments > 1:
        part = _NoTruncate(part)
    if prior and tuple(prior[0]) != tuple(endpoint):
        prior = []                 # stale partial from another endpoint
    march_from = prior[-1] if prior else endpoint
    if prior:
        log(f"stage2: resuming mid-stage from crosspoint "
            f"({march_from.i},{march_from.j})")
        part.truncate_above(march_from.i)

    out_cpf.crosspoints = []
    out_cpf.set_autosave()
    for c in prior:
        out_cpf.write(c)
    if not prior:
        out_cpf.write(endpoint)

    row_init, col_init = pipeline._mode_inits(pcfg.alignment_start)
    cps = core.reverse_march(
        seq0, seq1, job.cfg.params, march_from, part,
        row_init, col_init, pcfg.alignment_start,
        backend=job.cfg.backend, cfg=kernel_cfg,
        on_crosspoint=out_cpf.write,
        # multi-alignment runs share the stage-1 rows (no truncation);
        # the truncating device cache only serves the single-id fast path
        dev_cache=(getattr(job, "runtime_dev_rows", None)
                   if job.cfg.max_alignments == 1 else None),
    )
    if out_cpf._fh:                # drop the autosave handle; the
        out_cpf._fh.close()        # authoritative save is ascending
        out_cpf._fh = None
    # full ascending chain: the fresh march + the resumed prefix
    cps = cps + [c for c in reversed(prior)][1:]
    out_cpf.crosspoints = cps
    out_cpf.save()
    job.status.update(stage=STAGE_2)
    with job.stats_file(STAGE_2, aln_id) as fh:
        fh.write(f"  crosspoints: {len(cps)}\n")
        fh.write(f"  total_ms: {(time.time()-t0)*1000:.3f}\n")
    log(f"stage2: {len(cps)} crosspoints in {time.time()-t0:.2f}s")
    return cps


def stage3(job: Job, seq0: np.ndarray, seq1: np.ndarray, aln_id: int = 0,
           kernel_cfg=None, log=print) -> list[Crosspoint]:
    """Recursive densification inside partitions (sw_stage3.cpp:264)."""
    t0 = time.time()
    pcfg = _pcfg(job, kernel_cfg)
    out_cpf = job.crosspoints_file(STAGE_3, aln_id)

    import os

    prior: list[Crosspoint] = []   # ascending partial prefix on resume
    if os.path.exists(out_cpf.path):
        try:
            cps = out_cpf.load()
            if out_cpf.complete and cps:
                log("stage3: already executed (resume)")
                return cps
            prior = cps
        except Exception:
            pass

    cps = job.crosspoints_file(STAGE_2, aln_id).load()
    # Stage 3 only needs to shrink partitions to what stage 4 absorbs
    # quickly (the reference stops stage 3 at memory-fit for the same
    # reason, sw_stage3.cpp:375-382): the device-batched Myers-Miller
    # takes the stage-2 bands whole, so stage 3 is a pass-through there;
    # the native C++ splitter wants <= ~32768^2.
    from masa_tpu.native import bindings as _nb
    from masa_tpu.ops.myers_miller import device_batched

    if device_batched(job.cfg.stage4_strategy):
        max_cells = 1 << 62
    elif _nb.available() and job.cfg.stage4_strategy == "OPTIMIZED":
        max_cells = 1 << 30
    else:
        max_cells = None

    # mid-stage resume: a partial (END-less) file holds an ascending
    # prefix of definitive crosspoints; densification continues from its
    # last element (the reference resumes via per-deep SRA truncation,
    # sra/SpecialRowsArea.cpp:79-93)
    if prior and tuple(prior[0]) != tuple(cps[0]):
        prior = []                  # stale partial from another chain
    work = cps
    if prior:
        last = prior[-1]
        work = [last] + [c for c in cps
                         if (c.i, c.j) > (last.i, last.j)]
        log(f"stage3: resuming mid-stage from ({last.i},{last.j})")
    out_cpf.crosspoints = []
    out_cpf.set_autosave()
    for c in prior:
        out_cpf.write(c)
    if not prior:
        out_cpf.write(cps[0])
    densified = pipeline.stage3_densify(
        seq0, seq1, pcfg, work, max_cells=max_cells,
        on_crosspoint=out_cpf.write,
    )
    if out_cpf._fh:
        out_cpf._fh.close()
        out_cpf._fh = None
    cps = prior + densified[1:] if prior else densified
    out_cpf.crosspoints = cps
    out_cpf.save()
    job.status.update(stage=STAGE_3)
    from masa_tpu.utils.memory import process_vm_size

    with job.stats_file(STAGE_3, aln_id) as fh:
        fh.write(f"  crosspoints: {len(cps)}\n")
        fh.write(f"  total_ms: {(time.time()-t0)*1000:.3f}\n")
        fh.write(f"  vm_size_mb: {process_vm_size() >> 20}\n")
    log(f"stage3: {len(cps)} crosspoints in {time.time()-t0:.2f}s")
    return cps


def stage4(job: Job, seq0: np.ndarray, seq1: np.ndarray, aln_id: int = 0,
           strategy=None, log=print
           ) -> list[Crosspoint]:
    """Myers-Miller mid-splitting until <= maximum-partition
    (sw_stage4.cpp:883)."""
    t0 = time.time()
    if strategy is None:
        strategy = mm.SplitStrategy[job.cfg.stage4_strategy]
    out_cpf = job.crosspoints_file(STAGE_4, aln_id)

    import os

    if os.path.exists(out_cpf.path):
        try:
            cps = out_cpf.load()
            if out_cpf.complete and cps:
                log("stage4: already executed (resume)")
                return cps
        except Exception:
            pass

    cps = job.crosspoints_file(STAGE_3, aln_id).load()
    mps = job.cfg.stage4_max_partition
    if mps:
        cps = mm.stage4_reduce(
            seq0, seq1, cps, job.cfg.params, mps, strategy, log=log,
            stage5_max_cells=job.cfg.stage5_max_cells,
        )
    out_cpf.crosspoints = cps
    out_cpf.save()
    job.status.update(stage=STAGE_4)
    with job.stats_file(STAGE_4, aln_id) as fh:
        fh.write(f"  crosspoints: {len(cps)}\n")
        fh.write(f"  total_ms: {(time.time()-t0)*1000:.3f}\n")
    log(f"stage4: {len(cps)} crosspoints in {time.time()-t0:.2f}s")
    return cps


def stage5(job: Job, seq0: np.ndarray, seq1: np.ndarray,
           sequences: list[Sequence] | None = None, aln_id: int = 0,
           log=print) -> balign.Alignment:
    """Exact traceback per partition + score invariant; writes the CGFF
    binary (sw_stage5.cpp:322,464)."""
    t0 = time.time()
    pcfg = _pcfg(job)
    src = STAGE_4 if job.cfg.stage4_max_partition else STAGE_3
    cps = job.crosspoints_file(src, aln_id).load()
    t1 = time.time()
    aln = pipeline.stage5_emit(seq0, seq1, pcfg, cps, sequences)
    t2 = time.time()
    balign.write_cgff(job.path(f"alignment.{aln_id:02d}.cgff"), aln)
    job.status.update(stage=STAGE_5)
    import os as _os

    if _os.environ.get("MASA_TPU_STAGE2_TRACE"):
        log(f"    [stage5] load={t1-t0:.2f} emit={t2-t1:.2f} "
            f"cgff={time.time()-t2:.2f} parts={len(cps)-1}")
    log(f"stage5: score={aln.raw_score} verified in {time.time()-t0:.2f}s")
    return aln


def stage6(job: Job, seq0: np.ndarray, seq1: np.ndarray,
           aln: balign.Alignment, aln_id: int = 0, fmt: str = "text",
           log=print) -> str:
    """Render via the format registry + independent re-check
    (sw_stage6.cpp:992, stage6_formats[] :50-57)."""
    st6.recheck(aln, seq0, seq1, job.cfg.params)
    blocks = None
    bpath = job.path("blocks.00.bin")
    import os as _os

    if _os.path.exists(bpath):
        from masa_tpu.core.blocks_file import BlocksFile

        blocks = BlocksFile.load(bpath)
    render = st6.FORMATS.get(fmt, st6.FORMATS["text"])
    out, ext = render(aln, seq0, seq1, blocks=blocks)
    path = job.path(f"alignment.{aln_id:02d}.{ext}")
    with open(path, "w") as f:
        f.write(out)
    job.status.update(stage=STAGE_6)
    log(f"stage6: wrote {path}")
    return out


def execute_traceback(job: Job, seq0, seq1, sequences=None,
                      kernel_cfg=None, fmt: str = "text", log=print
                      ) -> balign.Alignment:
    """stages 2..6 for each best-score alignment id
    (executeTraceback, libmasa.cpp:644-655)."""
    import os

    first = None
    for aln_id in range(job.cfg.max_alignments):
        if aln_id and not os.path.exists(
            job.crosspoints_file(STAGE_1, aln_id).path
        ):
            break
        stage2(job, seq0, seq1, aln_id, kernel_cfg, log)
        stage3(job, seq0, seq1, aln_id, kernel_cfg, log)
        stage4(job, seq0, seq1, aln_id, log=log)
        aln = stage5(job, seq0, seq1, sequences, aln_id, log)
        stage6(job, seq0, seq1, aln, aln_id, fmt, log)
        if first is None:
            first = aln
    return first


def align_job(job: Job, seq0, seq1, sequences=None, kernel_cfg=None,
              fmt: str = "text", log=print) -> balign.Alignment:
    """The full run: stage 1 + traceback (libmasa_entry_point sequencing,
    libmasa.cpp:1351-1385)."""
    stage1(job, seq0, seq1, kernel_cfg, log)
    return execute_traceback(job, seq0, seq1, sequences, kernel_cfg, fmt,
                             log)


def finish_alignment(job: Job, seq0, seq1, aln: balign.Alignment,
                     cps=None, aln_id: int = 0, fmt: str = "text",
                     log=print, elapsed: dict | None = None
                     ) -> balign.Alignment:
    """Write the standard work-dir artifact set for an alignment produced
    OUTSIDE the persistent stage runners (sharded / weighted-split /
    oversize / fork modes): the CGFF binary, the stage-6 rendering with
    its independent re-check, crosspoint files and per-stage statistics —
    so every CLI mode leaves the same artifacts the monolithic path does
    (the reference writes these identically in all modes,
    libmasa.cpp:1351-1394)."""
    balign.write_cgff(job.path(f"alignment.{aln_id:02d}.cgff"), aln)
    if cps:
        f = job.crosspoints_file(STAGE_4, aln_id)
        f.crosspoints = list(cps)
        f.save()
    for stage, key in ((STAGE_1, "stage1"), (STAGE_2, "stage2"),
                       (STAGE_3, "stage3"), (STAGE_4, "stage4"),
                       (STAGE_5, "stage5")):
        with job.stats_file(stage, aln_id) as fh:
            if elapsed and key in elapsed:
                fh.write(f"  total_ms: {elapsed[key] * 1000:.3f}\n")
    job.status.update(stage=STAGE_5,
                      best=(aln.end[0], aln.end[1], aln.raw_score))
    stage6(job, seq0, seq1, aln, aln_id, fmt, log)
    return aln
