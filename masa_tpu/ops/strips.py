"""Strip chaining: run a whole partition through the wavefront kernel,
strip by strip, managing buses, borders, best scores and special rows.

This is the compute core under the aligner (the role of
AbstractDiagonalAligner::alignPartition + processNextIteration,
libs/masa-core/src/libmasa/aligners/AbstractDiagonalAligner.cpp:59-159):
the ``on_special_row`` callback is the dispatch funnel the manager hooks
into.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from masa_tpu.core import pruning
from masa_tpu.models.scoring import border_cells
from masa_tpu.ops import wavefront as wf
from masa_tpu.types import INF, InitType, Recurrence, ScoreParams


def pl_cdiv(a: int, b: int) -> int:
    return -(-a // b)


def snap_special_interval(iv: int, cfg: "wf.WavefrontConfig") -> int:
    """Smallest kernel-flushable special-row cadence >= iv.

    The strip kernels flush interior rows mid-strip (wf._flush_interior)
    every k*alpha*128 rows for a power-of-two k that divides the strip,
    so the cadence does not round up to the strip height (the
    reference's any-cadence flush, AbstractDiagonalAligner.cpp:466-478);
    cadences of a strip or more round to whole strips."""
    R = cfg.rows
    grain = cfg.alpha * 128
    if iv < R:
        k = -(-iv // grain)
        k = 1 << (k - 1).bit_length()   # pow2 -> divides rs
        if k < cfg.rs:
            return k * grain
    return max(((iv + R - 1) // R) * R, R)


class RowPull:
    """Deferred host materialization of one special row.

    In lazy mode stage 1 emits THIS instead of pulling the row to the
    host: the buses stay as device snapshots (shared with the
    DevRowCache that stage 2 matches against) and the host transfer
    happens only if/when a consumer actually needs host bytes — the SRA
    for a disk checkpoint (start() overlaps the transfer with later
    strips), or a stage-2 host-fallback read (rows()).  RAM-destined
    rows never leave the device at all."""

    def __init__(self, dev_h, dev_f, nj: int):
        self.dev_h = dev_h
        self.dev_f = dev_f
        self.nj = nj
        self._hh = self._hf = None

    def start(self) -> "RowPull":
        """Begin the async packed transfer (idempotent)."""
        if self._hh is None:
            self._hh = wf.pull_row_delta_start(self.dev_h, self.nj)
            self._hf = wf.pull_row_delta_start(self.dev_f, self.nj)
        return self

    def ready(self) -> bool:
        if self._hh is None:
            return False
        try:
            return self._hh[0].is_ready() and self._hf[0].is_ready()
        except AttributeError:
            return True

    def rows(self) -> tuple[np.ndarray, np.ndarray]:
        """(h, f) int64 host arrays of length nj (no border element)."""
        self.start()
        return (wf.pull_row_delta_finish(self._hh),
                wf.pull_row_delta_finish(self._hf))

    def packed(self):
        """((u, esc_idx, esc_val) for h, same for f): the disk-
        persistable packed form (wf.decode_packed_row reconstructs)."""
        self.start()
        return wf.packed_row_host(self._hh), wf.packed_row_host(self._hf)

    def anchors(self, stride: int):
        """(anc_h, anc_f) int64 absolute values at bus positions
        0, stride, 2*stride, ... < nj, gathered ON DEVICE (a few hundred
        scalars) — the random-access index that lets stage 2 decode just
        a match window out of a disk row instead of all O(n) of it."""
        idx = jnp.asarray(np.arange(0, self.nj, stride, np.int32))
        ah = np.asarray(wf.gather_device(self.dev_h, idx)).astype(np.int64)
        af = np.asarray(wf.gather_device(self.dev_f, idx)).astype(np.int64)
        return ah, af


@dataclasses.dataclass
class PartitionResult:
    last_h: np.ndarray          # (n+1,) DP last row H (index 0 = border)
    last_f: np.ndarray          # (n+1,)
    best: int
    best_i: int                 # DP coordinates
    best_j: int
    col_h: np.ndarray | None    # (m+1,) DP last column H if store_lastcol
    col_e: np.ndarray | None
    specials: dict[int, tuple[np.ndarray, np.ndarray]]
    cells: int = 0
    pruned_cells: int = 0
    dev_last: tuple | None = None  # device (bus_h, bus_f), want_dev_last


def _border_vec(init, params, length, start, custom):
    """(H, gap) border values for DP indices start .. start+length-1."""
    if init == InitType.CUSTOM:
        h, g = custom
        return (
            np.asarray(h[start : start + length], np.int32),
            np.asarray(g[start : start + length], np.int32),
        )
    h, g = border_cells(length, init, params, start=start)
    return h, g


def run_partition(
    cfg: wf.WavefrontConfig,
    seq0: np.ndarray,
    seq1: np.ndarray,
    params: ScoreParams = ScoreParams(),
    row_init: InitType = InitType.WITH_ZEROES,
    col_init: InitType = InitType.WITH_ZEROES,
    first_row: tuple[np.ndarray, np.ndarray] | None = None,
    first_col: tuple[np.ndarray, np.ndarray] | None = None,
    route: str | None = None,
    special_every: int = 0,
    on_special_row: Callable | None = None,
    stop_check: Callable | None = None,
    prune: bool = False,
    first_col_reader=None,
    lastcol_writer=None,
    pad_rows: bool = False,
    blocks_sink: Callable | None = None,
    want_last_row: bool = True,
    dev_slices: tuple | None = None,
    on_special_row_dev: Callable | None = None,
    want_dev_last: bool = False,
    on_special_row_lazy: Callable | None = None,
) -> PartitionResult:
    """Align one partition.  first_row=(H,F) and first_col=(H,E) are DP
    border vectors of length n+1 / m+1 when the init type is CUSTOM.

    ``route`` is the strip kernel (utils.devices.kernel_route: "cuda" on
    a GPU, "scan" on the CPU); every path below runs on either.

    ``special_every`` must be a multiple of the strip height, or a
    kernel-flushable sub-strip cadence (snap_special_interval), or 0;
    ``on_special_row(dp_row_index, bus_h, bus_f)`` fires at that cadence.
    ``blocks_sink(rows_done, chunk_maxima)`` receives the per-chunk bus
    maxima after every strip (--dump-blocks support; forces the per-strip
    host path).  ``stop_check(strip_result_dict, rows_done, strip_rows,
    col_off)`` may return True to halt early (goal-score support); the
    strip covered DP rows (rows_done - strip_rows, rows_done] and its best
    captures are relative to kernel column offset col_off (pruning
    windows).  ``prune`` enables block pruning (SW with best tracking
    only): a strip runs on the power-of-2-quantized chunk window computed
    from the previous bus whenever that window is narrower than the full
    width; pruned columns carry -INF buses.

    ``dev_slices = (seq0x, i0_off, seq1x, j0_off)``: device-resident
    sentinel-padded sequence arrays (wf.dev_seq) with this partition's
    origin offsets.  When given (and the borders are synthesizable, not
    CUSTOM), full strips slice their chars/windows ON DEVICE and borders
    synthesize from init codes — per-strip host->device traffic drops to
    scalars.  Falls back to the host data path otherwise.
    """
    import os as _os

    from masa_tpu.utils.devices import kernel_route

    route = route or kernel_route()
    m, nj = len(seq0), len(seq1)
    assert nj >= 1
    R = cfg.rows
    # pad_rows: iterate whole strips only (sentinel rows in the tail
    # strip); every strip then has the full height.  Sentinel rows never
    # match and only lose score, so SW bests and all specials at rows
    # <= m are exact; the final-row output becomes meaningless.
    m_iter = ((m + R - 1) // R) * R if pad_rows else m
    assert not (pad_rows and first_col_reader), \
        "streamed borders need exact strip heights"
    C = cfg.chunk
    sub_strip = False
    n_int = 0
    cfg_flush = cfg
    if special_every and special_every % R != 0:
        # sub-strip cadence: the kernel emits interior rows mid-strip
        # (wf._flush_interior geometry) on the fused path; windowed and
        # partial strips flush at their boundary only (consumers
        # tolerate gaps — stage 2's next_below takes whatever row exists
        # below).
        grain = cfg.alpha * 128
        assert special_every % grain == 0 and R % special_every == 0, \
            "sub-strip cadence must be alpha*128-aligned and divide R"
        sub_strip = True
        n_int = R // special_every - 1
        cfg_flush = dataclasses.replace(cfg, flush_every=special_every)

    ng = pl_cdiv(nj, C)
    plen = wf.padded_len(cfg, nj)
    # one extra chunk of padding so pruning windows can slice freely
    # (jax.lax.dynamic_slice CLAMPS out-of-range starts — the buffers must
    # cover the largest window slice exactly)
    blen = plen + C
    prune = prune and cfg.track_best and (
        cfg.recurrence == Recurrence.SMITH_WATERMAN
    ) and not cfg.store_lastcol

    # device-resident slicing applies to full strips with synthesizable
    # (non-CUSTOM) column borders; bounds are checked so callers can
    # always pass their arrays and let unsupported cases fall back
    use_sliced = False
    if dev_slices is not None and first_col is None \
            and first_col_reader is None \
            and col_init != InitType.CUSTOM:
        seq0x, i0_off, seq1x, j0_off = dev_slices
        use_sliced = (len(seq0x) >= i0_off + (m_iter // R) * R
                      and len(seq1x) >= j0_off + plen)

    b = None

    def get_b():
        nonlocal b
        if b is None:
            ba = np.full(blen, wf.B_SENTINEL, dtype=np.int32)
            ba[:nj] = np.asarray(seq1, np.int32)
            b = jnp.asarray(ba)
        return b

    row_h, row_f = _border_vec(
        row_init, params, nj + 1, 0, first_row
    )
    if use_sliced and first_row is None and row_init != InitType.CUSTOM:
        # synthesized on device (blen-long, masked beyond nj)
        bus_h, bus_f = wf.init_bus_synth(cfg, np.int32(int(row_init)),
                                         np.int32(nj), blen)
    else:
        bus_ha = np.full(blen, -INF, dtype=np.int32)
        bus_fa = np.full(blen, -INF, dtype=np.int32)
        bus_ha[:nj] = row_h[1:]
        bus_fa[:nj] = row_f[1:]
        bus_h, bus_f = jnp.asarray(bus_ha), jnp.asarray(bus_fa)

    best, best_i, best_j = -INF, 0, 0
    if cfg.track_best:
        # border cells are part of the matrix and must seed the best
        # for NW too (nw_best endpoint selection): the in-kernel
        # tracking covers interior cells only
        best = int(row_h.max())
        best_j = int(np.argmax(row_h))
        best_i = 0
        if first_col_reader is None:
            ch0, _ = _border_vec(col_init, params, m + 1, 0, first_col)
            if int(ch0.max()) > best:
                best = int(ch0.max())
                best_i, best_j = int(np.argmax(ch0)), 0

    col_h = np.empty(m + 1, np.int64) if cfg.store_lastcol else None
    col_e = np.empty(m + 1, np.int64) if cfg.store_lastcol else None
    if cfg.store_lastcol:
        col_h[0] = row_h[nj]
        col_e[0] = -INF

    specials: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    cells = 0
    pruned_cells = 0
    dev_best = None  # on-device (score, i, j) accumulator
    # Two-phase best tracking: phase 1 tracks per-row MAX only; phase 2
    # replays from the nearest bus checkpoint and re-runs the winning
    # strip with full tracking to recover (i, j).  Pays off once the
    # replay cost amortizes (>= 16 strips); checkpoint stride bounds
    # device memory to <= 64 retained bus pairs.
    n_strips_full = m_iter // R
    two_phase = (cfg.track_best
                 and stop_check is None and not prune
                 and not cfg.store_lastcol
                 and first_col_reader is None
                 and n_strips_full >= 16)
    ck_stride = max(1, -(-n_strips_full // 64)) if two_phase else 1
    dev_max = None   # (smax, strip_id) accumulator (phase 1)
    ckpts: dict[int, tuple] = {}  # strip_id -> input buses (phase 2)
    stream_corner = int(row_h[0])  # H(i0, 0) carried between strip reads

    # delta-packed pulls: 8x fewer bytes over PCIe on the GPU route
    # (MASA_TPU_FORCE_PACKED_PULL exercises the path in CPU tests)
    packed_pull = (route == "cuda"
                   or bool(_os.environ.get("MASA_TPU_FORCE_PACKED_PULL")))

    def pull(bus):
        return wf.pull_row_delta(bus, nj) if packed_pull \
            else np.asarray(bus[:nj]).astype(np.int64)

    # Deferred special-row delivery: the packed bytes copy to the host
    # asynchronously while later strips compute.  Completed transfers
    # drain opportunistically (is_ready polling, never blocking the
    # strip loop); the in-flight count stays small so delivery work
    # interleaves with compute instead of piling into a serial drain at
    # loop end, and a device byte cap bounds the retained bus snapshots
    # at chromosome scale.
    deferred = []

    def deliver_one():
        r0_, hh, hf = deferred.pop(0)
        bh = wf.pull_row_delta_finish(hh)
        bf = wf.pull_row_delta_finish(hf)
        if on_special_row:
            on_special_row(r0_, bh, bf)
        else:
            specials[r0_] = (bh, bf)

    def drain_ready():
        while deferred:
            _, hh, hf = deferred[0]
            try:
                ready = hh[0].is_ready() and hf[0].is_ready()
            except AttributeError:
                break
            if not ready:
                break
            deliver_one()

    def deliver_deferred():
        while deferred:
            deliver_one()

    inflight_cap = int(_os.environ.get("MASA_TPU_SPECIAL_INFLIGHT", "2"))
    # each deferred row retains two bus snapshots in device memory; cap
    # the queue by bytes so chromosome-scale runs stay well inside it
    defer_cap = max(1, min(inflight_cap,
                           (2 << 30) // max(blen * 8, 1)))

    def emit_special(r, bus_h, bus_f):
        if on_special_row_lazy is not None:
            # lazy mode: no host transfer here — snapshots go to the
            # device cache and a RowPull lets the store pull on demand
            snap_h = wf._device_copy(bus_h)
            snap_f = wf._device_copy(bus_f)
            if on_special_row_dev is not None:
                on_special_row_dev(r, snap_h, snap_f)
            on_special_row_lazy(r, RowPull(snap_h, snap_f, nj))
            return
        if packed_pull:
            drain_ready()
            while len(deferred) >= defer_cap:
                deliver_one()
            handle_h = wf.pull_row_delta_start(bus_h, nj)
            handle_f = wf.pull_row_delta_start(bus_f, nj)
            if on_special_row_dev is not None:
                # the packed pull already retains device snapshots for
                # escape re-fetches — share them with the device cache
                on_special_row_dev(r, handle_h[1], handle_f[1])
            deferred.append((r, handle_h, handle_f))
        else:
            if on_special_row_dev is not None:
                on_special_row_dev(r, wf._device_copy(bus_h),
                                   wf._device_copy(bus_f))
            bh, bf = pull(bus_h), pull(bus_f)
            if on_special_row:
                on_special_row(r, bh, bf)
            else:
                specials[r] = (bh, bf)

    def strip_rows(s0k, n_rows):
        """Row-major strip chars (R,), A_SENTINEL past the strip."""
        return jnp.asarray(wf.rows_vec(cfg, seq0[s0k : s0k + n_rows],
                                       wf.A_SENTINEL))

    def border_rows(s0k, n_rows):
        ich, ice = _border_vec(col_init, params, n_rows, s0k + 1,
                               first_col)
        return (jnp.asarray(wf.rows_vec(cfg, ich)),
                jnp.asarray(wf.rows_vec(cfg, ice)), ich)

    i0 = 0
    while i0 < m_iter:
        hs = min(R, m_iter - i0)
        fusable = (hs == R and first_col_reader is None
                   and not cfg.store_lastcol and stop_check is None
                   and blocks_sink is None)

        # --- block pruning window (SW): [wa, wa+wn) chunks -----------
        wa, wn = 0, ng
        skip_strip = False
        if prune:
            if dev_best is not None:
                best = int(dev_best[0])
            busmax = np.asarray(wf.chunk_max_device(bus_h, ng, C))
            ich0, _ = _border_vec(col_init, params, 1, i0 + 1, first_col)
            wl, wr = pruning.pruning_window(
                busmax, best, i0, m, nj, C, params,
                border_max=int(ich0.max()),
            )
            if wl == wr:
                skip_strip = True
            else:
                wn = min(1 << (wr - wl - 1).bit_length(), ng)
                wa = max(0, min(wl, ng - wn))
        windowed = prune and not skip_strip and (wa > 0 or wn < ng)

        # ---- fused path: one dispatch per full strip, no host sync ----
        if fusable and not skip_strip and not windowed:
            g = (m_iter - i0) // R
            if special_every and not sub_strip:
                nb = ((i0 // special_every) + 1) * special_every
                g = min(g, (nb - i0) // R)
            if prune:
                g = min(g, 1)   # the window is reconsidered every strip
            if g >= 1:
                if cfg.track_best and not two_phase and dev_best is None:
                    dev_best = (np.int32(best), np.int32(best_i),
                                np.int32(best_j))
                carry = dev_best if (cfg.track_best and not two_phase) \
                    else (np.int32(0), np.int32(0), np.int32(0))
                const_border = col_init == InitType.WITH_ZEROES
                bh_p, bf_p = bus_h[:plen], bus_f[:plen]
                b_p = None if use_sliced else get_b()[:plen]
                ih_c = ie_c = None
                if two_phase and dev_max is None:
                    dev_max = (np.int32(best), np.int32(-1))
                cfg_run = dataclasses.replace(cfg_flush, track_pos=False) \
                    if two_phase else cfg_flush

                def emit_strip(s0k, rows):
                    # interior rows ((n_int, plen) device arrays)
                    # then the strip-boundary row from the fresh bus
                    if rows is not None:
                        for qi in range(n_int):
                            r_abs = s0k + (qi + 1) * special_every
                            if r_abs < m:
                                q = np.int32(qi)
                                emit_special(r_abs, wf.row_of(rows[0], q),
                                             wf.row_of(rows[1], q))
                    if sub_strip and s0k + R < m:
                        emit_special(s0k + R, bh_p, bf_p)

                for k in range(g):
                    s0k = i0 + k * R
                    rows = None
                    if use_sliced:
                        if two_phase:
                            if (s0k // R) % ck_stride == 0:
                                ckpts[s0k // R] = (bh_p, bf_p)
                            bh_p, bf_p, dev_max, *rows = \
                                wf.strip_step_max_sliced(
                                    cfg_run, route, seq0x, seq1x,
                                    np.int32(i0_off + s0k),
                                    np.int32(j0_off),
                                    np.int32(s0k),
                                    np.int32(int(col_init)),
                                    np.int32(nj), bh_p, bf_p,
                                    dev_max, s0k // R,
                                )
                        else:
                            bh_p, bf_p, carry, *rows = \
                                wf.strip_step_sliced(
                                    cfg_flush, route, seq0x, seq1x,
                                    np.int32(i0_off + s0k),
                                    np.int32(j0_off),
                                    np.int32(s0k),
                                    np.int32(int(col_init)),
                                    np.int32(nj), bh_p, bf_p, carry,
                                    s0k, cfg.track_best,
                                )
                        emit_strip(s0k, rows or None)
                        continue
                    a_rows = strip_rows(s0k, R)
                    if ih_c is None or not const_border:
                        ih_c, ie_c, _ = border_rows(s0k, R)
                    corner = int(_border_vec(col_init, params, 1, s0k,
                                             first_col)[0][0])
                    if two_phase:
                        if (s0k // R) % ck_stride == 0:
                            ckpts[s0k // R] = (bh_p, bf_p)
                        bh_p, bf_p, dev_max, *rows = wf.strip_step_max(
                            cfg_run, route, a_rows, ih_c, ie_c, corner,
                            b_p, bh_p, bf_p, dev_max, s0k // R,
                            np.int32(nj),
                        )
                    else:
                        bh_p, bf_p, carry, *rows = wf.strip_step(
                            cfg_flush, route, a_rows, ih_c, ie_c, corner,
                            b_p, bh_p, bf_p, carry, s0k, np.int32(nj),
                            cfg.track_best,
                        )
                    emit_strip(s0k, rows or None)
                fill = jnp.full(blen - plen, -INF, jnp.int32)
                bus_h = jnp.concatenate([bh_p, fill])
                bus_f = jnp.concatenate([bf_p, fill])
                if cfg.track_best and not two_phase:
                    dev_best = carry
                cells += g * R * nj
                i0 += g * R
                if (special_every and not sub_strip
                        and i0 % special_every == 0 and i0 < m):
                    # streamed to the caller's store (keeping copies here
                    # would hold O(m*n/interval) host RAM); the pull is
                    # asynchronous — it lands while the next group runs
                    emit_special(i0, bus_h, bus_f)
                continue

        # ---- per-strip path: windows, partial strips, host consumers --
        out = None
        off = 0
        if skip_strip:
            pruned_cells += hs * nj
            bus_h = jnp.full(blen, -INF, jnp.int32)
            bus_f = jnp.full(blen, -INF, jnp.int32)
        else:
            a_rows = strip_rows(i0, hs)
            if first_col_reader is not None:
                # streamed left border (multi-process column split): one
                # strip's worth of neighbor last-column cells per read
                ich, ice = first_col_reader.read(hs)
                init_h = jnp.asarray(wf.rows_vec(cfg, ich))
                init_e = jnp.asarray(wf.rows_vec(cfg, ice))
                corner = stream_corner
                stream_corner = int(ich[-1])
            else:
                init_h, init_e, _ = border_rows(
                    i0, min(hs, m - i0) if pad_rows else hs)
                corner_h, _ = _border_vec(col_init, params, 1, min(i0, m),
                                          first_col)
                corner = int(corner_h[0])
            if windowed:
                nj_w = wn * C
                off = wa * C
                b_w = jax.lax.dynamic_slice(get_b(), (off,), (nj_w + C,))
                bh_w = jax.lax.dynamic_slice(bus_h, (off,), (nj_w + C,))
                bf_w = jax.lax.dynamic_slice(bus_f, (off,), (nj_w + C,))
                if wa > 0:
                    # -INF wall at the window's left edge
                    # (clearPrunedBlocks semantics)
                    neg = jnp.full(R, -INF, jnp.int32)
                    init_h, init_e, corner = neg, neg, -INF
                pruned_cells += max(0, hs * (nj - nj_w))
            else:
                nj_w = nj
                b_w, bh_w, bf_w = get_b(), bus_h, bus_f
            # the kernel stops at the real width inside the window
            out = wf.strip(cfg, route, a_rows, b_w, bh_w, bf_w, init_h,
                           init_e, corner, nj=np.int32(min(nj_w, nj - off)),
                           h_true=np.int32(hs))
            neg_full = jnp.full(blen, -INF, jnp.int32)
            bus_h = jax.lax.dynamic_update_slice(neg_full, out["bus_h"],
                                                 (off,))
            bus_f = jax.lax.dynamic_update_slice(neg_full, out["bus_f"],
                                                 (off,))
            cells += hs * min(nj_w, nj)

            if cfg.track_best:
                if stop_check is None and not two_phase:
                    # no per-strip host consumer: fold the best on
                    # device; the pruning window only needs the SCALAR
                    # best, pulled per strip above
                    if dev_best is None:
                        dev_best = (np.int32(best), np.int32(best_i),
                                    np.int32(best_j))
                    dev_best = wf.merge_best_device(
                        dev_best, out["best_v"], out["best_j"], i0, off
                    )
                else:
                    s, bi, bj = wf.resolve_best(out["best_v"],
                                                out["best_j"])
                    if s > best:
                        best, best_i, best_j = s, i0 + bi + 1, off + bj + 1
            if cfg.store_lastcol:
                lch = np.asarray(out["lastcol_h"])[:hs]
                lce = np.asarray(out["lastcol_e"])[:hs]
                col_h[i0 + 1 : i0 + 1 + hs] = lch
                col_e[i0 + 1 : i0 + 1 + hs] = lce
                if lastcol_writer is not None:
                    lastcol_writer.write(lch.astype(np.int32),
                                         lce.astype(np.int32))

        i0 += hs
        if blocks_sink is not None:
            blocks_sink(i0, pruning.chunk_maxima(
                np.asarray(bus_h[: ng * C]), ng, C))
        is_special = special_every and i0 % special_every == 0 and i0 < m
        if is_special:
            emit_special(i0, bus_h, bus_f)
        if stop_check and out is not None and stop_check(out, i0, hs, off):
            break

    deliver_deferred()
    if dev_best is not None:
        # the device carry was seeded with the initial host best (border
        # candidates) and tie-breaks on-device — it IS the final answer
        best, best_i, best_j = (int(v) for v in jax.device_get(dev_best))
    if dev_max is not None:
        smax, sidx = (int(v) for v in jax.device_get(dev_max))
        # >= : on a tie with the (later, larger-i) tail strip the phase-1
        # strip wins, preserving the engine-wide smallest-i tie-break
        if smax >= best and sidx >= 0:
            # phase 2: replay max-only from the nearest checkpoint, then
            # re-run the winning strip with full tracking for (i, j)
            k0 = sidx - sidx % ck_stride
            bh_ck, bf_ck = ckpts[k0]

            def strip_inputs(k):
                s0k = k * R
                ihk, iek, _ = border_rows(s0k, R)
                cch = int(_border_vec(col_init, params, 1, s0k,
                                      first_col)[0][0])
                return strip_rows(s0k, R), ihk, iek, cch

            cfg_max = dataclasses.replace(cfg, track_pos=False)
            dummy = (np.int32(-INF), np.int32(-1))
            for k in range(k0, sidx):
                a_l, ihk, iek, cch = strip_inputs(k)
                bh_ck, bf_ck, dummy = wf.strip_step_max(
                    cfg_max, route, a_l, ihk, iek, cch, get_b()[:plen],
                    bh_ck, bf_ck, dummy, k, np.int32(nj),
                )
            a_l, ihk, iek, cch = strip_inputs(sidx)
            seed = (np.int32(-INF), np.int32(0), np.int32(0))
            _, _, carry2 = wf.strip_step(
                cfg, route, a_l, ihk, iek, cch, get_b()[:plen],
                bh_ck, bf_ck, seed, sidx * R, np.int32(nj), True,
            )
            best, best_i, best_j = (int(v) for v in
                                    jax.device_get(carry2))
            assert best == smax, (best, smax)
    if want_last_row:
        last_h = np.empty(nj + 1, np.int64)
        last_f = np.empty(nj + 1, np.int64)
        if first_col_reader is not None:
            last_h[0] = stream_corner
        else:
            ch, ce = _border_vec(col_init, params, 1, i0, first_col)
            last_h[0] = ch[0]
        last_f[0] = -INF
        last_h[1:] = pull(bus_h)
        last_f[1:] = pull(bus_f)
    else:
        # score-only callers (the SW stage-1 hot loop) skip the final
        # 2 x O(n) device->host pull
        last_h = last_f = None

    dev_last = (bus_h, bus_f) if want_dev_last else None

    return PartitionResult(
        last_h=last_h,
        last_f=last_f,
        best=best,
        best_i=best_i,
        best_j=best_j,
        col_h=col_h,
        col_e=col_e,
        specials=specials,
        cells=cells,
        pruned_cells=pruned_cells,
        dev_last=dev_last,
    )
