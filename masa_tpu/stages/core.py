"""Stage-agnostic traceback machinery: forward passes with special rows,
reverse goal-score marching (stage 2/3), and the crosspoint algebra.

Crosspoint/state contract (see ops/smallsw.py): a crosspoint (i, j, s, t)
pins the optimal path to state t at DP cell (i, j) with state value s (gap
states include their single gap_open).  Invariants used everywhere:

  * cut matching at a special row r (AlignerUtils::matchColumn semantics):
      ALIGNED:  fwd_H(r,j) + rev_H == goal
      GAPPED:   fwd_F(r,j) + rev_F + gap_open == goal
    where goal = s + gap_open*[t != MATCH] for the crosspoint being matched
    from (stage2/sw_stage2.cpp:369-372 bookkeeping).
  * constrained segment value between consecutive crosspoints equals the
    raw score difference s_{k+1} - s_k (the stage-5 invariant).

Border gap synthesis: stored rows/columns carry only one gap component
(the reference's union cell), so the vertical-gap value *along a border
column* is synthesized exactly from the border H values:
F(r, border) = max_{r0<r}( H(r0) - open - (r-r0)*ext ), a prefix-max.
This replaces the reference's scattered full-gap special cases
(AlignerManager::findFullGap, common/AlignerManager.cpp:658-718).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from masa_tpu.models.scoring import border_cells, match_column
from masa_tpu.ops import wavefront as wf
from masa_tpu.types import (
    INF,
    AlignmentStart,
    Crosspoint,
    CrosspointType,
    InitType,
    MatchType,
    Recurrence,
    ScoreParams,
)

NEG = -INF

# per-hop phase accumulators, filled under MASA_TPU_STAGE2_TRACE and
# printed by reverse_march's [hop] lines (reset per hop)
_PROF: dict = {}


class SpecialRowStore:
    """RAM special-row store: row index -> ((n+1,) H, (n+1,) F) including
    the border element at k=0.  The SRA disk store implements the same
    protocol."""

    def __init__(self):
        self._rows: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def put(self, r: int, h: np.ndarray, f: np.ndarray) -> None:
        self._rows[r] = (np.asarray(h), np.asarray(f))

    def put_lazy(self, r: int, lazy) -> None:
        """A manager.LazyFullRow: the body stays on device until get()
        (a RAM store is not crash persistence, so nothing is lost by
        never materializing unread rows)."""
        self._rows[r] = lazy

    def get(self, r: int) -> tuple[np.ndarray, np.ndarray]:
        v = self._rows[r]
        if not isinstance(v, tuple):
            v = v.full_rows()
            self._rows[r] = v
        return v

    def get_window(self, r: int, lo: int, hi: int
                   ) -> tuple[np.ndarray, np.ndarray]:
        h, f = self.get(r)
        return h[lo:hi], f[lo:hi]

    def finalize(self) -> None:
        pass

    def rows(self) -> list[int]:
        return sorted(self._rows)

    def next_below(self, i: int, min_dist: int = 1) -> int | None:
        """Largest stored row r with r <= i - min_dist (the reverse-ordered
        consumption of SpecialRowsPartition::nextSpecialRow)."""
        cand = [r for r in self._rows if r <= i - min_dist]
        return max(cand) if cand else None

    def truncate_above(self, i: int) -> None:
        """Drop rows above the found crosspoint
        (SpecialRowsArea::truncatePartition)."""
        for r in [r for r in self._rows if r > i]:
            del self._rows[r]

    def __len__(self):
        return len(self._rows)


def device_row_budget() -> int:
    """Bytes of device memory the special-row cache may hold: a quarter
    of what the device's allocator reports (memory_stats bytes_limit),
    leaving the kernels' working set the rest.  A CPU device reports no
    limit; its memory is the host's RAM."""
    import os

    import jax

    stats = jax.devices()[0].memory_stats() or {}
    limit = int(stats.get("bytes_limit", 0))
    if not limit:
        limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return limit // 4


class DevRowCache:
    """Device-resident special-row cache: the stage-1 bus snapshots that
    the async packed pulls already retain are kept alive here, so stage 2
    can run its goal matching ON DEVICE (wf.goal_match_device) instead of
    re-reading multi-MB rows from the SRA and pulling the reverse pass's
    last row per hop — the dominant stage-2 cost at the 5M+ scale.

    The host SRA store stays authoritative (crash resume); this cache is
    an accelerator.  Budget-bounded in bytes; eviction drops the SMALLEST
    rows first (stage 2 consumes top-down, so high rows are needed
    soonest).  Rows above a found crosspoint are truncated like the SRA
    (SpecialRowsArea::truncatePartition)."""

    def __init__(self, budget_bytes: int | None = None):
        if budget_bytes is None:
            budget_bytes = device_row_budget()
        self.budget = budget_bytes
        self._rows: dict[int, tuple] = {}     # r -> (dev_h, dev_f)
        self._borders: dict[int, tuple] = {}  # r -> (h0, f0)
        self._bytes = 0

    def put_dev(self, r: int, dev_h, dev_f) -> None:
        if r in self._rows:
            return
        sz = 2 * int(np.prod(dev_h.shape)) * 4
        while self._bytes + sz > self.budget and self._rows:
            drop = min(self._rows)
            dh, _ = self._rows.pop(drop)
            self._borders.pop(drop, None)
            self._bytes -= 2 * int(np.prod(dh.shape)) * 4
        if self._bytes + sz > self.budget:
            return
        self._rows[r] = (dev_h, dev_f)
        self._bytes += sz

    def attach_border(self, r: int, h0: int, f0: int) -> None:
        if r in self._rows:
            self._borders[r] = (int(h0), int(f0))

    def get(self, r: int):
        """(dev_h, dev_f, border_h0, border_f0) or None."""
        row = self._rows.get(r)
        bd = self._borders.get(r)
        if row is None or bd is None:
            return None
        return (row[0], row[1], bd[0], bd[1])

    def truncate_above(self, i: int) -> None:
        for r in [r for r in self._rows if r > i]:
            dh, _ = self._rows.pop(r)
            self._borders.pop(r, None)
            self._bytes -= 2 * int(np.prod(dh.shape)) * 4

    def __len__(self):
        return len(self._rows)


def border_gap_values(h_border: np.ndarray, params: ScoreParams) -> np.ndarray:
    """Exact gap-state values along a border: out[k] =
    max_{k0<k}( h[k0] - open - (k-k0)*ext ), out[0] = -INF."""
    n = len(h_border)
    ext = params.gap_ext
    k = np.arange(n, dtype=np.int64)
    g = np.asarray(h_border, np.int64) + k * ext
    run = np.maximum.accumulate(g)
    out = np.empty(n, np.int64)
    out[0] = NEG
    out[1:] = run[:-1] - params.gap_open - k[1:] * ext
    return np.maximum(out, NEG)


def init_types_for(start_type: int) -> tuple[InitType, InitType]:
    """(row_init, col_init) pinning a partition's start state exactly:
    H(0,0)=0 always; the opened-gap border continues the pinned gap without
    re-charging gap_open."""
    if start_type == CrosspointType.GAP_1:
        return InitType.WITH_GAPS_OPENED, InitType.WITH_GAPS
    if start_type == CrosspointType.GAP_2:
        return InitType.WITH_GAPS, InitType.WITH_GAPS_OPENED
    return InitType.WITH_GAPS, InitType.WITH_GAPS


@dataclasses.dataclass
class FwdResult:
    last_h: np.ndarray   # (n+1,) with synthesized border gap at [0] in last_f
    last_f: np.ndarray
    best: int
    best_i: int
    best_j: int
    specials: SpecialRowStore
    cells: int
    col_h: np.ndarray | None = None  # (m+1,) last column H if requested
    col_e: np.ndarray | None = None
    pruned_cells: int = 0


def make_aligner(backend: str, rows: int,
                 cfg: wf.WavefrontConfig | None = None):
    """The production aligner factory: the oracle extension for the numpy
    backend, the wavefront extension otherwise (the role of `new
    CUDAligner()` at the reference's entry point, src/main.cpp:39)."""
    from masa_tpu.core.aligner import CPUAligner, KernelAligner

    if backend == "numpy":
        return CPUAligner()
    return KernelAligner(cfg or adaptive_config(rows))


def forward_pass(
    seq0: np.ndarray,
    seq1: np.ndarray,
    params: ScoreParams,
    recurrence: Recurrence,
    row_init: InitType,
    col_init: InitType,
    first_row=None,
    first_col=None,
    special_every: int = 0,
    store: SpecialRowStore | None = None,
    backend: str = "auto",
    cfg: wf.WavefrontConfig | None = None,
    track_best: bool = True,
    prune: bool = False,
    pad_rows: bool = False,
    best_sink=None,
    blocks_sink=None,
    want_last_row: bool = True,
    want_lastcol: bool = False,
    nw_best: bool = False,
    dev_cache: "DevRowCache | None" = None,
    lazy_rows: bool = False,
) -> FwdResult:
    """Forward DP over a partition; persists special rows (with synthesized
    border gap values) into `store`.

    One code path: builds an AlignerManager + aligner extension and drives
    it, exactly as the reference's stage 1 does
    (stage1/sw_stage1.cpp:255 -> AlignerManager::alignPartition).  The
    manager is the dispatch funnel (rows -> store, scores -> best, block
    maxima -> sink); this function only translates the result frame."""
    from masa_tpu.core.manager import AlignerManager
    from masa_tpu.types import Partition

    m, n = len(seq0), len(seq1)
    store = store if store is not None else SpecialRowStore()
    if backend == "auto":
        backend = "numpy" if m * n < 4_000_000 else "kernel"

    aligner = make_aligner(backend, m, cfg)
    mgr = AlignerManager(aligner, params)
    mgr.set_recurrence_type(recurrence)
    mgr.set_first_row(row_init, first_row)
    mgr.set_first_column(col_init, first_col)
    mgr.set_special_rows_store(store)
    mgr.set_special_row_interval(special_every)
    mgr.set_block_pruning(prune)
    # NW best tracking is opt-in (nw_best): pinned-start runs normally
    # only need the last row/column, but --alignment-end '*' selects the
    # endpoint as the global NW maximum
    mgr.track_best = track_best and (
        recurrence == Recurrence.SMITH_WATERMAN or nw_best)
    mgr.want_all_scores = best_sink is not None
    mgr.score_callback = best_sink
    mgr.pad_rows = pad_rows
    # a padded tail strip makes the final row meaningless anyway — never
    # pay the O(n) pull for it
    mgr.want_last_row = want_last_row and not pad_rows
    mgr.last_column_wanted = want_lastcol
    mgr.blocks_sink = blocks_sink
    mgr.special_dev_sink = dev_cache
    # lazy delivery needs the device snapshots alive: only meaningful
    # with a device sink and a kernel backend
    mgr.lazy_special_rows = (lazy_rows and dev_cache is not None
                             and backend != "numpy")
    aligner.set_sequences(seq0, seq1)
    mgr.align_partition(Partition(0, 0, m, n))
    if mgr.lazy_special_rows and hasattr(store, "finalize"):
        store.finalize()

    if mgr.last_row is not None:
        _, lh, lf = mgr.last_row
    else:
        lh = lf = None
    best, best_i, best_j = mgr.best
    col_h = col_e = None
    if want_lastcol and mgr.last_column is not None:
        _, col_h, col_e = mgr.last_column
    return FwdResult(lh, lf, best, best_i, best_j, store,
                     aligner.stats.cells, col_h=col_h, col_e=col_e,
                     pruned_cells=aligner.stats.pruned_cells)


# The scan twin's strip (CPU: tests and development) and the tallest CUDA
# strip: a band of 256 rows per warp, so 524288 rows keep ~2048 warps in
# flight — enough to fill the H100's 132 SMs (ops/cuda_strip.py).
_SCAN_CFG = wf.WavefrontConfig(alpha=4, rs=1, chunk=512)
_CUDA_MAX_ROWS = 1 << 19
_CUDA_CHUNK = 8192


def _cuda_config(rows: int) -> wf.WavefrontConfig:
    return wf.WavefrontConfig(alpha=4, rs=rows // 512, chunk=_CUDA_CHUNK)


def default_config() -> wf.WavefrontConfig:
    """The route's full-height strip."""
    from masa_tpu.utils.devices import kernel_route

    if kernel_route() == "cuda":
        return _cuda_config(_CUDA_MAX_ROWS)
    return _SCAN_CFG


def adaptive_config(rows: int) -> wf.WavefrontConfig:
    """Strip for a partition of `rows` rows.  CUDA: the tallest power of
    two <= rows (512 .. the full-height strip), so the partition holds at
    least one full strip — mid-strip special rows flush from full strips
    — and the rest is one strip of its true height (call data to the
    kernel); scan: the one small CPU strip."""
    from masa_tpu.utils.devices import kernel_route

    if kernel_route() == "cuda":
        r = 1 << (max(rows, 512).bit_length() - 1)
        return _cuda_config(min(r, _CUDA_MAX_ROWS))
    return _SCAN_CFG


def partition_config(rows: int, width: int) -> wf.WavefrontConfig:
    """Strip for a one-off partition (a stage-2 hop, a stage-4 half):
    the width does not change the choice — see adaptive_config."""
    return adaptive_config(rows)


def stage1_plan(m: int, n: int, sra_limit: int = 17 << 30
                ) -> tuple[wf.WavefrontConfig, int]:
    """Stage-1 strip and special-row spacing for a run that will be
    traced back: the spacing is the SRA budget's interval (the
    reference's rule, Job::calculateFlushIntervals: m*n*8/limit + 1 rows)
    snapped to what the kernel can flush (strips.snap_special_interval:
    a mid-strip multiple of alpha*128, or whole strips)."""
    from masa_tpu.ops.strips import snap_special_interval

    cfg = adaptive_config(m)
    iv = m * n * 8 // max(sra_limit, 1) + 1
    return cfg, snap_special_interval(iv, cfg)


def stage1_config(m: int, n: int,
                  sra_limit: int = 17 << 30) -> wf.WavefrontConfig:
    """The strip of stage1_plan (spacing-agnostic callers)."""
    return stage1_plan(m, n, sra_limit)[0]


def goal_reachable(cp: Crosspoint, cut_row: int, match: int) -> bool:
    """Necessary condition for the SW alignment START to lie within the
    reverse window rows (cut_row, cp.i]: the path consumes at most
    cp.i - cut_row rows and cp.j columns, gaining at most `match` per
    consumed pair — so cp.score <= min(hb, cp.j) * match.  Gating the
    best-cell tracking on this prunes the dense start-search from every
    hop except the final ones (the reference reaches the same effect via
    its goal-score setup, stage2/sw_stage2.cpp:80-88)."""
    return cp.score <= min(cp.i - cut_row, cp.j) * match


def initial_window(cp: Crosspoint, cut_row: int, backend: str) -> int:
    """First reverse-window width for a hop of height hb = cp.i - cut_row.
    The matched column is typically ~hb cells left of cp.j (near-diagonal
    path), so 2*hb succeeds on the first try; misses double and retry
    (geometric, total work <= 2x the final window).  The kernel path keeps
    a 4096 floor to bound the set of compiled width buckets; the numpy
    path retries for free, so a tight floor avoids full-width passes on
    small matrices."""
    hb = cp.i - cut_row
    if backend == "numpy" or (
        backend == "auto"
        and _auto_backend(hb * min(cp.j, max(256, 2 * hb)),
                          16_000_000) == "numpy"
    ):
        floor = 256
    else:
        floor = 4096
    return min(cp.j, max(floor, 2 * hb))


@dataclasses.dataclass
class ReverseMatch:
    crosspoint: Crosspoint | None
    start_found: bool = False
    start: tuple[int, int] | None = None
    # (H, E) of the reverse pass along its far column (the slab boundary),
    # indexed by reverse row p = cp.i - global_row; only when requested.
    rev_col: tuple | None = None


def reverse_pass_and_match(
    seq0: np.ndarray,
    seq1: np.ndarray,
    params: ScoreParams,
    cp: Crosspoint,
    cut_row: int,
    fwd_h: np.ndarray,
    fwd_f: np.ndarray,
    j_low: int,
    goal_anywhere: bool,
    backend: str = "auto",
    cfg: wf.WavefrontConfig | None = None,
    want_rev_col: bool = False,
    rev_seqs: tuple | None = None,
    free_col_start: bool = False,
    dev_cut: tuple | None = None,
    fwd_rows_fn=None,
    dev_cut_off: int = 0,
) -> ReverseMatch:
    """One reverse partition: from crosspoint `cp` up to `cut_row`,
    columns [j_low, cp.j], matched against the stored forward cut.

    fwd_h/fwd_f are the stored (n+1,) special-row arrays of `cut_row`
    (global column indexing).  Returns the next crosspoint, or a
    start-found result (SW), or crosspoint=None when the window was too
    small (caller widens j_low).

    ``rev_seqs = (seq0_reversed, seq1_reversed)``: STABLE full reversed
    arrays (built once per march).  The pass then aligns an offset
    partition of them instead of materializing per-hop slices — the
    aligner's device-resident sequence cache hits on every hop.

    ``dev_cut = (dev_h, dev_f, border_h0, border_f0)``: the stored cut as
    a device-resident bus snapshot (DevRowCache).  When usable (kernel
    backend, window not touching column 0), the whole match runs on
    device and fwd_h/fwd_f may be None — ``fwd_rows_fn()`` lazily loads
    the host row only if the host path is needed after all.

    ``dev_cut_off``: bus index of dev_cut's element 0 (0 for full-row
    DevRowCache snapshots; ``j_low - 1`` for a WINDOWED cut uploaded
    from an SRA window read — the goal match slices with traced
    indices, so only the cj passed to it shifts).
    """
    from masa_tpu.core.manager import AlignerManager
    from masa_tpu.types import Partition

    ci, cj, s, t = cp.i, cp.j, cp.score, cp.type
    hb = ci - cut_row
    assert hb >= 1
    # quantize the window width to a power of two (bounds the number of
    # distinct compiled kernel shapes)
    if j_low > 0:
        want = cj - j_low
        want = 1 << (want - 1).bit_length()
        j_low = max(cj - want, 0)
    width = cj - j_low
    goal = s + (params.gap_open if t != CrosspointType.MATCH else 0)

    # Reverse frame: row border = horizontal moves back from the
    # crosspoint; col border = vertical.  Pin the crosspoint state.
    row_init, col_init = init_types_for(t)

    if backend == "auto":
        backend = _auto_backend(hb * max(width, 1), 16_000_000)

    # device path: cut stays on device, match runs there (j=0 border
    # cases and the numpy oracle keep the host path)
    use_dev = (dev_cut is not None and width > 0 and j_low >= 1
               and backend != "numpy")

    # Matching frame: index k runs j = cj - k for k in [0, width].
    fwd_cut_h = fwd_cut_f = None
    if not use_dev:
        if fwd_h is None:
            import os as _os
            import time as _tm

            if _os.environ.get("MASA_TPU_STAGE2_TRACE"):
                _tg = _tm.time()
                fwd_h, fwd_f = fwd_rows_fn()
                _PROF["get"] = _PROF.get("get", 0.0) + _tm.time() - _tg
            else:
                fwd_h, fwd_f = fwd_rows_fn()
        fwd_cut_h = np.asarray(fwd_h, np.int64)[j_low : cj + 1][::-1]
        fwd_cut_f = np.asarray(fwd_f, np.int64)[j_low : cj + 1][::-1]
    if width == 0:
        # Degenerate window: only the straight-up border column exists.
        rev_h, _ = border_cells(hb + 1, col_init, params)
        rev_h = rev_h.astype(np.int64)
        rev_last_h = rev_h[hb : hb + 1]
        rev_last_f = np.array(
            [_border_f_value(col_init, hb, params)], np.int64
        )
        best = NEG
        best_pq = (0, 0)
        rev_col = None
        mres = match_column(rev_last_h, rev_last_f, fwd_cut_h, fwd_cut_f,
                            goal, params.gap_open)
    else:
        # One code path: the same manager-driven dispatch funnel as the
        # forward passes, with the stored cut installed as the goal base
        # (the manager's findGoalCell machinery,
        # common/AlignerManager.cpp:625-656).
        if cfg is None and backend != "numpy":
            # hop heights are arbitrary (the endpoint row): the strip
            # takes the true height as call data
            cfg = partition_config(hb, width)
        aligner = make_aligner(backend, hb, cfg)
        mgr = AlignerManager(aligner, params)
        mgr.set_recurrence_type(Recurrence.NEEDLEMAN_WUNSCH)
        mgr.set_first_row(row_init)
        mgr.set_first_column(col_init)
        mgr.track_best = goal_anywhere
        mgr.last_column_wanted = want_rev_col
        mgr.reverse_f0 = _border_f_value(col_init, hb, params)
        if use_dev:
            mgr.set_goal_score(goal, base_row=None)
            mgr.goal_base_dev = (dev_cut[0], dev_cut[1], cj - dev_cut_off,
                                 width + 1)
        else:
            mgr.set_goal_score(goal, base_row=(fwd_cut_h, fwd_cut_f))
        if rev_seqs is not None:
            # offset partition of the stable reversed-full arrays
            r0f, r1f = rev_seqs
            part = Partition(len(seq0) - ci, len(seq1) - cj,
                             len(seq0) - cut_row, len(seq1) - j_low)
            aligner.set_sequences(r0f, r1f)
        else:
            part = Partition(0, 0, hb, width)
            aligner.set_sequences(
                np.ascontiguousarray(seq0[cut_row:ci][::-1]),
                np.ascontiguousarray(seq1[j_low:cj][::-1]))
        import os as _os
        import time as _tm

        if _os.environ.get("MASA_TPU_STAGE2_TRACE"):
            _tp = _tm.time()
            mgr.align_partition(part)
            _PROF["align"] = _PROF.get("align", 0.0) + _tm.time() - _tp
            _PROF["align_n"] = _PROF.get("align_n", 0) + 1
        else:
            mgr.align_partition(part)
        best = mgr.best[0]
        best_pq = (mgr.best[1] - part.i0, mgr.best[2] - part.j0)
        rev_col = None
        if want_rev_col and mgr.last_column is not None:
            rev_col = (mgr.last_column[1], mgr.last_column[2])
        mres = mgr.last_match_result

    # SW start detection: the pinned-state reverse matrix is bounded above
    # by the goal; best == goal locates the alignment start.
    if goal_anywhere and best == goal:
        p, q = best_pq
        return ReverseMatch(None, start_found=True,
                            start=(ci - p, cj - q))

    if not mres.found:
        # Free-column-border start (--alignment-start '1'/'+'): the path
        # may START mid-border at (i, 0) between special rows, crossing
        # no cut at all.  The start condition is an exact goal hit in the
        # reverse pass's LAST column (reverse cell (p, width) = original
        # (ci - p, 0) reached with value `goal`) — the column analogue of
        # the virtual row-0 matching that covers free ROW borders.
        if j_low == 0 and rev_col is not None and free_col_start:
            rc = np.asarray(rev_col[0], np.int64)[: hb + 1]
            hits = np.nonzero(rc == goal)[0]
            if len(hits):
                p = int(hits[0])
                return ReverseMatch(None, start_found=True,
                                    start=(ci - p, 0))
        if mres.type in (MatchType.ERROR_SUM_MATCH, MatchType.ERROR_SUM_GAP) \
                and j_low == 0 and not want_rev_col:
            raise RuntimeError(
                f"Backtrace lost at row {cut_row} (match overshoot "
                f"{mres.type})"
            )
        return ReverseMatch(None, rev_col=rev_col)
    j_star = cj - mres.k
    new_type = (
        CrosspointType.MATCH
        if mres.type == MatchType.ALIGNED
        else CrosspointType.GAP_2
    )
    return ReverseMatch(
        Crosspoint(cut_row, j_star, int(mres.score), new_type),
        rev_col=rev_col,
    )


def _border_f_value(col_init: InitType, i: int, params: ScoreParams) -> int:
    """The true gap-state value straight along a synthesized border column
    (continuing pinned gap for GAPS_OPENED, freshly opened for GAPS)."""
    if col_init == InitType.WITH_GAPS_OPENED:
        return -i * params.gap_ext
    return -params.gap_open - i * params.gap_ext


def _auto_backend(cells: int, small: int) -> str:
    """Resolve backend "auto" for a partition of `cells` cells: on the
    CUDA route every partition runs the kernel (a launch costs far less
    than the host oracle on any real hop); on the CPU the NumPy oracle
    beats the scan twin below `small` cells."""
    from masa_tpu.utils.devices import kernel_route

    if kernel_route() == "cuda":
        return "kernel"
    return "numpy" if cells < small else "kernel"


def _windowed_cut_ok(backend: str, hb: int, width: int) -> bool:
    """Would the host path run this hop through the kernel?  (Mirrors
    reverse_pass_and_match's backend resolution; the windowed cut upload
    only pays where the device match engages.)"""
    if backend == "numpy" or width <= 0:
        return False
    return backend != "auto" or _auto_backend(hb * width,
                                              16_000_000) == "kernel"


def _fetch_window_cut(specials, r: int, cj: int, j_low: int):
    """Upload the stored cut's [j_low, cj] column window as a device
    cut buffer (an SRA get_window is O(window) for anchored rows).
    Returns ((dev_h, dev_f, h0, f0), cut_off) or None; cut_off is the
    bus index of the buffer's element 0 (reverse_pass_and_match shifts
    the cj it hands the device matcher by it)."""
    get_window = getattr(specials, "get_window", None)
    if get_window is None:
        return None
    import jax.numpy as jnp

    wh, wf_ = get_window(r, j_low, cj + 1)
    if len(wh) != cj + 1 - j_low:
        return None
    dev_h = jnp.asarray(np.ascontiguousarray(wh, np.int32))
    dev_f = jnp.asarray(np.ascontiguousarray(wf_, np.int32))
    return (dev_h, dev_f, 0, 0), j_low - 1


def reverse_march(
    seq0: np.ndarray,
    seq1: np.ndarray,
    params: ScoreParams,
    endpoint: Crosspoint,
    specials: SpecialRowStore,
    row_init: InitType,
    col_init: InitType,
    alignment_start: AlignmentStart,
    min_dist: int = 1,
    backend: str = "auto",
    cfg: wf.WavefrontConfig | None = None,
    on_crosspoint=None,
    fix_origin: bool = True,
    dev_cache: DevRowCache | None = None,
) -> list[Crosspoint]:
    """The stage-2 loop: march crosspoints from `endpoint` back toward the
    origin, matching at stored special rows (virtual row 0 included).

    Returns crosspoints ordered from start to endpoint (ascending i).
    row_init/col_init describe the *matrix borders* (virtual row 0 / the
    border column), used for the final row-0 matching and origin fixups.
    """
    import os as _os
    import time as _time

    _trace = bool(_os.environ.get("MASA_TPU_STAGE2_TRACE"))
    n = len(seq1)
    sw_anywhere = alignment_start == AlignmentStart.ANYWHERE
    cps: list[Crosspoint] = [endpoint]
    cp = endpoint
    # stable reversed views for the whole march: every hop aligns an
    # offset partition of these, so device-resident uploads happen once
    rev_seqs = (np.ascontiguousarray(seq0[::-1]),
                np.ascontiguousarray(seq1[::-1]))
    if backend != "numpy":
        # build the aligner's device views of the reversed arrays by
        # FLIPPING the stage-1 forward views on device (no re-upload of
        # the multi-MB reversed twins)
        from masa_tpu.core.aligner import dev_pads

        pad0, pad1 = dev_pads(len(seq1))
        wf.dev_seq_seed_reversed(seq0, rev_seqs[0], wf.A_SENTINEL, pad0)
        wf.dev_seq_seed_reversed(seq1, rev_seqs[1], wf.B_SENTINEL, pad1)

    row0_h, _ = (
        border_cells(n + 1, row_init, params)
        if row_init != InitType.CUSTOM
        else (None, None)
    )

    while True:
        if sw_anywhere and cp.score <= 0:
            break
        if cp.i == 0 or (cp.j == 0 and not sw_anywhere):
            break

        _t_hop = _time.time()
        _dist = min_dist
        _row_tries = 0
        while True:
            # row-widen loop: a full-width miss at a special row skips
            # that row and rematches at the next one below (reachable
            # when a caller's min_dist > 1 skips past the start's own
            # row, or when a stored row cannot produce a match); only a
            # full-width miss at virtual row 0 is a genuinely lost
            # backtrace.  The reference aborts on any full-width miss
            # (stage2/sw_stage2.cpp:115-118) because its stage-3
            # min-distance never skips the goal row; ours is
            # caller-configurable (PipelineConfig.min_dist).
            _row_tries += 1
            r = specials.next_below(cp.i, _dist)
            dev_cut = None
            fwd_rows_fn = None
            window_viable = False
            if r is None or r == 0:
                r = 0
                fh = row0_h.astype(np.int64)
                ff = np.full(n + 1, NEG, np.int64)
            else:
                dev_cut = (dev_cache.get(r)
                           if dev_cache is not None else None)
                window_viable = (dev_cut is None
                                 and _windowed_cut_ok(backend, cp.i - r,
                                                      cp.j))
                if dev_cut is None and not window_viable:
                    if _trace:
                        _tg = _time.time()
                        fh, ff = specials.get(r)
                        _PROF["get"] = (_PROF.get("get", 0.0)
                                        + _time.time() - _tg)
                    else:
                        fh, ff = specials.get(r)
                else:
                    # device-resident or windowed cut: load the host row
                    # lazily, only if a window attempt falls back to the
                    # host match
                    fh = ff = None
                    fwd_rows_fn = (lambda r_=r: specials.get(r_))

            goal_anywhere = (sw_anywhere
                             and goal_reachable(cp, r, params.match))
            # free column border: the path may start mid-border at (i, 0)
            free_col = (not sw_anywhere
                        and col_init == InitType.WITH_ZEROES)

            width0 = initial_window(cp, r, backend)
            j_low = cp.j - width0
            _tries = 0
            while True:
                _tries += 1
                at_edge = j_low <= 0
                dev_cut_eff, cut_off = dev_cut, 0
                if window_viable and j_low > 0:
                    # replicate the callee's pow2 window quantization so
                    # the uploaded cut buffer covers exactly the window
                    # it slices
                    want_q = 1 << (cp.j - j_low - 1).bit_length()
                    j_low_q = max(cp.j - want_q, 0)
                    if (j_low_q >= 1
                            and _windowed_cut_ok(backend, cp.i - r,
                                                 cp.j - j_low_q)):
                        if _trace:
                            _tg = _time.time()
                        got = _fetch_window_cut(specials, r, cp.j,
                                                j_low_q)
                        if _trace:
                            _PROF["win"] = (_PROF.get("win", 0.0)
                                            + _time.time() - _tg)
                        if got is not None:
                            dev_cut_eff, cut_off = got
                rm = reverse_pass_and_match(
                    seq0, seq1, params, cp, r, fh, ff, max(j_low, 0),
                    goal_anywhere, backend=backend, cfg=cfg,
                    rev_seqs=rev_seqs,
                    want_rev_col=free_col and at_edge,
                    free_col_start=free_col,
                    dev_cut=dev_cut_eff, fwd_rows_fn=fwd_rows_fn,
                    dev_cut_off=cut_off,
                )
                if rm.start_found:
                    si, sj = rm.start
                    cp = Crosspoint(si, sj, 0, CrosspointType.MATCH)
                    cps.append(cp)
                    if on_crosspoint:
                        on_crosspoint(cp)
                    return list(reversed(cps))
                if rm.crosspoint is not None or j_low <= 0:
                    break
                j_low = cp.j - 2 * (cp.j - j_low)
            if rm.crosspoint is not None:
                break
            if r == 0:
                raise RuntimeError(
                    f"Backtrace lost: no match at special row {r}"
                )
            # full width failed at a stored row: skip it and rematch at
            # the next special row below
            _dist = cp.i - r + 1
            if _trace:
                print(f"    [hop] full-width miss at r={r}; widening "
                      f"over rows (dist={_dist})", flush=True)
        if _trace:
            _ph = " ".join(f"{k}={v:.2f}" if isinstance(v, float) else
                           f"{k}={v}" for k, v in sorted(_PROF.items()))
            _PROF.clear()
            print(f"    [hop] cp=({cp.i},{cp.j}) r={r} hb={cp.i - r} "
                  f"w0={width0} tries={_tries} rows={_row_tries} "
                  f"dev={'y' if dev_cut is not None else 'n'} "
                  f"t={_time.time()-_t_hop:.2f} {_ph}", flush=True)
        cp = rm.crosspoint
        cps.append(cp)
        if on_crosspoint:
            on_crosspoint(cp)
        specials.truncate_above(cp.i)
        if dev_cache is not None:
            dev_cache.truncate_above(cp.i)

    # Origin fixup (stage2/sw_stage2.cpp:461-481): a crosspoint resting on
    # a *gapped* border extends to the origin.
    first = cps[-1]
    gapped = (InitType.WITH_GAPS, InitType.WITH_GAPS_OPENED)
    if fix_origin and not sw_anywhere and (first.i > 0 or first.j > 0):
        if (first.i == 0 and row_init in gapped) or (
            first.j == 0 and col_init in gapped
        ):
            cps.append(Crosspoint(0, 0, 0, CrosspointType.MATCH))

    return list(reversed(cps))
