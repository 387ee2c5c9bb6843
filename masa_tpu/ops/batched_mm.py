"""Stage 4 on the device: level-batched, device-resident Myers-Miller.

The reference runs stage 4 on 4 CPU pthreads (stage4/sw_stage4.cpp:806)
because its GPUs are busy elsewhere.  This module runs it on the
accelerator instead:

  * Every adjacent crosspoint pair at a split level needs one forward and
    one reverse NW half-pass.  All pairs of a level run batched through
    the XLA row-sweep engine (ops/rowsweep); on the CUDA route, levels of
    tall halves run each half through the strip kernel
    (strips.run_partition) instead.
  * **Device-resident data plane**: the four sequence views (seq0, seq1,
    and their reverses) upload ONCE; every half-pass slices its strip
    rows and column window on-device (`lax.dynamic_slice`), synthesizes
    its pinned borders on-device from init-type codes, and the
    Myers-Miller column matching runs on-device too — the only per-pair
    traffic is a handful of scalars.
  * Widths pad to a shared pow2 bucket per level with sentinel columns
    (exact: DP dependencies never flow leftward, so padded columns cannot
    change real-region values; rows below a half's height likewise only
    read upward).
  * The split row snaps to 512-row buckets; crosspoints may differ
    legally from the Python h//2 splitter; every result satisfies the
    stage-5 score invariant.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from masa_tpu.models.scoring import border_cells
from masa_tpu.ops import wavefront as wf
from masa_tpu.stages import core as score
from masa_tpu.types import (
    INF,
    Crosspoint,
    CrosspointType,
    InitType,
    Recurrence,
    ScoreParams,
)

NEG = -INF

_CODE = {
    InitType.WITH_ZEROES: 0,
    InitType.WITH_GAPS: 1,
    InitType.WITH_GAPS_OPENED: 2,
}


# traced border synthesis lives in the kernel module (one copy of the
# border semantics next to the kernels that consume it)
_border_h_dev = wf.border_h_traced


def _split_height(h: int) -> int:
    """Top-half height: ~h/2 rounded DOWN to a 512- or 1024-row multiple
    (in [1, h-1]), so sibling halves share heights."""
    t = h // 2
    if t >= 2048:
        return (t // 1024) * 1024
    if t >= 512:
        return (t // 512) * 512
    return max(t, 1)


@dataclasses.dataclass
class _Half:
    """One half-pass request against the device-resident sequence views:
    rows [i0, i0+h) x columns [j0, j0+w) of (seq0d, seq1d) — for reverse
    halves the offsets index the REVERSED views."""

    i0: int
    h: int
    j0: int
    w: int
    row_code: int
    col_code: int


class _DevSeqs:
    """The four device-resident sequence views, sentinel-padded so any
    (offset, static-size) slice is in bounds.  Views come from the
    shared wf.dev_seq cache: the forward arrays are usually already on
    device from stage 1 (pad-flexible hit) and the reversed views are
    built by on-device flips — warm stage 4 uploads nothing."""

    def __init__(self, seq0: np.ndarray, seq1: np.ndarray,
                 pad0: int, pad1: int):
        self.m, self.n = len(seq0), len(seq1)
        self.s0f = wf.dev_seq(seq0, wf.A_SENTINEL, pad0)
        self.s0r = wf.dev_seq(seq0, wf.A_SENTINEL, pad0, reverse=True)
        self.s1f = wf.dev_seq(seq1, wf.B_SENTINEL, pad1)
        self.s1r = wf.dev_seq(seq1, wf.B_SENTINEL, pad1, reverse=True)
        # host twins (zero-copy views) for the per-half strip engine,
        # which drives strips.run_partition per half
        self._h0 = (seq0, seq0[::-1])
        self._h1 = (seq1, seq1[::-1])

    def views(self, rev: bool):
        return (self.s0r, self.s1r) if rev else (self.s0f, self.s1f)

    def host_views(self, rev: bool):
        return (self._h0[rev], self._h1[rev])


# ---------------------------------------------------------------------------
# engines: both slice on-device and return LOGICAL (B, njq) last-row buses
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _dyn_bus_init(T: int, go: int, ge: int):
    def one(row_code):
        j = jnp.arange(T, dtype=jnp.int32) + 1
        return (_border_h_dev(row_code, j, go, ge),
                jnp.full(T, NEG, jnp.int32))

    return jax.jit(jax.vmap(one))


# the row-sweep chain rung: ONE compiled key per (width, params); small
# enough that deep mixed-height levels chain in a couple of calls
_SWEEP_R = 512

_TRACE = bool(os.environ.get("MASA_TPU_STAGE4_TRACE"))


def _halves_sweep(dev: _DevSeqs, halves: list[_Half], rev: bool,
                  params: ScoreParams, njq: int):
    """All halves through the vmapped row-sweep engine
    (ops/rowsweep.batched_sweep_engine): a (B,) x R-row scan per chained
    rung.  Returns device (B, njq) logical last-row buses."""
    from masa_tpu.ops import rowsweep

    B = len(halves)
    h_max = max(x.h for x in halves)
    go, ge = params.gap_open, params.gap_ext
    s0d, s1d = dev.views(rev)
    Bb = 1 << (B - 1).bit_length()
    grp = list(halves) + [
        dataclasses.replace(halves[0], h=0)] * (Bb - B)
    i0s = jnp.asarray([x.i0 for x in grp], jnp.int32)
    j0s = jnp.asarray([x.j0 for x in grp], jnp.int32)
    ccodes = jnp.asarray([x.col_code for x in grp], jnp.int32)
    rcodes = jnp.asarray([x.row_code for x in grp], jnp.int32)
    heights = jnp.asarray([x.h for x in grp], jnp.int32)
    bh, bf = _dyn_bus_init(njq, go, ge)(rcodes)
    eng = rowsweep.batched_sweep_engine(
        njq + 1, _SWEEP_R, False, go, ge, params.match, params.mismatch)
    for s0r in range(0, h_max, _SWEEP_R):
        bh, bf = eng(s0d, s1d, i0s, j0s,
                     jnp.full(Bb, s0r, jnp.int32), ccodes, bh, bf,
                     heights - s0r)
    return bh[:B], bf[:B]


# Tall halves (CUDA route): one half of at least this many rows puts a
# 256-row warp band on every SM of an H100 (132 SMs, rounded to a power
# of two), so the strip kernel runs it at a useful fill; shorter halves
# batch through the row sweep.
_STRIPS_H_MIN = 1 << 15


def _halves_strips(dev: _DevSeqs, halves: list[_Half], rev: bool,
                   params: ScoreParams, njq: int):
    """Each half through strips.run_partition on the device-resident
    sequence views (stage-1's data path: on-device slicing, synthesized
    borders, zero per-strip host traffic).  All halves dispatch
    asynchronously; nothing here syncs — the level's single pull stays
    in _run_match.  Returns device (B, njq) logical last-row buses."""
    from masa_tpu.stages.core import partition_config
    from masa_tpu.ops import strips as _strips

    s0d, s1d = dev.views(rev)
    s0h, s1h = dev.host_views(rev)
    outs_h, outs_f = [], []
    t0 = time.time()
    for x in halves:
        w1 = max(x.w, 1)    # w == 0 (pure-gap pair): one sentinel-masked
        #                     column; every k >= 1 is masked in the match
        cfg = dataclasses.replace(
            partition_config(x.h, w1),
            recurrence=Recurrence.NEEDLEMAN_WUNSCH,
            track_best=False, store_lastcol=False,
            match=params.match, mismatch=params.mismatch,
            gap_open=params.gap_open, gap_ext=params.gap_ext)
        res = _strips.run_partition(
            cfg, s0h[x.i0 : x.i0 + x.h], s1h[x.j0 : x.j0 + w1], params,
            _code_inv(x.row_code), _code_inv(x.col_code),
            want_last_row=False, want_dev_last=True,
            dev_slices=(s0d, x.i0, s1d, x.j0),
        )
        bh, bf = res.dev_last
        if bh.shape[0] < njq:
            fill = jnp.full(njq - bh.shape[0], NEG, jnp.int32)
            bh = jnp.concatenate([bh, fill])
            bf = jnp.concatenate([bf, fill])
        outs_h.append(bh[:njq])
        outs_f.append(bf[:njq])
    if _TRACE:
        hs = sorted({x.h for x in halves})
        print(f"    [strips B={len(halves)} h={hs[0]}..{hs[-1]} "
              f"njq={njq} dispatch={time.time()-t0:.2f}", flush=True)
    return jnp.stack(outs_h), jnp.stack(outs_f)


# Fixed match tile: every match dispatch pads to this many elements, so
# the XLA trace set stays constant across levels instead of growing with
# each level's pair count.
_B_TILE = 128


def _run_level(dev, halves: list[_Half], rev: bool, params: ScoreParams,
               njq: int):
    """One level's halves -> device (B, njq) logical last-row buses:
    tall halves through the strip kernel on the CUDA route, every other
    level through the batched row sweep."""
    from masa_tpu.utils.devices import kernel_route

    if (kernel_route() == "cuda"
            and max(x.h for x in halves) >= _STRIPS_H_MIN):
        return _halves_strips(dev, halves, rev, params, njq)
    return _halves_sweep(dev, halves, rev, params, njq)


# ---------------------------------------------------------------------------
# on-device Myers-Miller matching (AlignerUtils::matchColumn, vmapped)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _match_engine(njq: int, go: int):
    """Per pair: match the reverse half's last row against the forward
    half's (reversed), exactly reproducing models.scoring.match_column
    over k = 0..w.  Returns int32 (found, k, score, type) with type in
    {0 aligned, 1 gapped, 2 err-sum-match, 3 err-sum-gap}."""
    W1 = njq + 1

    def one(fh, ff, rh, rf, fwd0, rev0, w, goal):
        k = jnp.arange(W1, dtype=jnp.int32)
        # full rev row: k=0 is the rev border element (lh0, lf0)
        rhs = jnp.concatenate([rev0[0:1], rh]).astype(jnp.int32)
        rfs = jnp.concatenate([rev0[1:2], rf]).astype(jnp.int32)
        # full fwd row, then reversed so index k reads fwd[w - k]:
        # pad the flipped row with NEG and take a (W1,) window at njq - w
        fhs = jnp.concatenate([fwd0[0:1], fh]).astype(jnp.int32)
        ffs = jnp.concatenate([fwd0[1:2], ff]).astype(jnp.int32)
        pad = jnp.full(W1, NEG, jnp.int32)
        fh_r = jax.lax.dynamic_slice(
            jnp.concatenate([jnp.flip(fhs), pad]), (W1 - 1 - w,), (W1,))
        ff_r = jax.lax.dynamic_slice(
            jnp.concatenate([jnp.flip(ffs), pad]), (W1 - 1 - w,), (W1,))
        valid = k <= w
        sum_m = fh_r + rhs
        sum_g = ff_r + rfs + go
        hit = ((sum_m == goal) | (sum_g == goal)) & valid
        over = ((sum_m > goal) | (sum_g > goal)) & valid
        stop = hit | over
        big = jnp.int32(W1)
        idx = jnp.where(stop, k, big).min()
        found = idx < big
        idx_c = jnp.clip(idx, 0, W1 - 1)
        m_at = sum_m[idx_c] == goal
        g_at = sum_g[idx_c] == goal
        is_hit = found & (m_at | g_at)
        typ = jnp.where(
            is_hit,
            jnp.where(m_at, 0, 1),
            jnp.where(sum_m[idx_c] > goal, 2, 3),
        )
        scr = jnp.where(m_at, fh_r[idx_c], ff_r[idx_c])
        return (is_hit.astype(jnp.int32), idx_c, scr, typ)

    return jax.jit(jax.vmap(one))


def _run_match(fh, ff, rh, rf, fwd0, rev0, ws, goals, njq: int, go: int
               ) -> np.ndarray:
    """The vmapped match engine, tiled to _B_TILE (one XLA trace per
    njq instead of one per level batch size).  All tiles dispatch
    asynchronously; ONE host pull at the end.  Returns (4, B) host."""
    B = fh.shape[0]
    eng = _match_engine(njq, go)
    outs = []
    for off in range(0, B, _B_TILE):
        end = min(off + _B_TILE, B)
        n = end - off
        # ALWAYS pad to the fixed tile: one XLA trace per njq (a short
        # tile would retrace per distinct level batch size)
        pad = _B_TILE - n
        if pad:
            sl = lambda a: jnp.concatenate(
                [a[off:end], jnp.repeat(a[end - 1 : end], pad, axis=0)])
            npad = lambda a: np.concatenate(
                [a[off:end], np.repeat(a[end - 1 : end], pad, axis=0)])
            out = jnp.stack(eng(
                sl(fh), sl(ff), sl(rh), sl(rf),
                jnp.asarray(npad(fwd0)), jnp.asarray(npad(rev0)),
                jnp.asarray(npad(ws)), jnp.asarray(npad(goals))))[:, :n]
        else:
            out = jnp.stack(eng(
                fh[off:end], ff[off:end], rh[off:end], rf[off:end],
                jnp.asarray(fwd0[off:end]), jnp.asarray(rev0[off:end]),
                jnp.asarray(ws[off:end]), jnp.asarray(goals[off:end])))
        outs.append(out)
    return np.asarray(outs[0] if len(outs) == 1
                      else jnp.concatenate(outs, axis=1))


# ---------------------------------------------------------------------------
# the reduce loop
# ---------------------------------------------------------------------------


def reduce_partitions_batched(
    seq0: np.ndarray,
    seq1: np.ndarray,
    cps: list[Crosspoint],
    params: ScoreParams,
    max_partition: int = 16,
    log=None,
    batch_cap: int = 1024,
) -> list[Crosspoint]:
    """Split every adjacent pair until max(height, width) <= max_partition,
    batching all half-passes of a level into a few device dispatches with
    a device-resident data plane.  `batch_cap` bounds device memory."""
    seq0 = np.asarray(seq0, np.uint8)
    seq1 = np.asarray(seq1, np.uint8)
    go, ge = params.gap_open, params.gap_ext

    w_max0 = max((c1.j - c0.j for c0, c1 in zip(cps, cps[1:])), default=1)
    njq_max = max(128, 1 << (max(w_max0, 1) - 1).bit_length())
    # any engine's slice is j0 + padded_len(cfg, njq<=njq_max) with
    # j0 <= n; 64K covers every strip's chunk padding
    dev = _DevSeqs(seq0, seq1, pad0=131072 + 8, pad1=njq_max + 65536)

    done: list[tuple[Crosspoint, Crosspoint]] = []
    work = list(zip(cps, cps[1:]))
    level = 0
    while True:
        pending = []
        for c0, c1 in work:
            h, w = c1.i - c0.i, c1.j - c0.j
            if max(h, w) <= max_partition or h < 2:
                done.append((c0, c1))
            else:
                pending.append((c0, c1))
        if not pending:
            break
        level += 1

        m, n = dev.m, dev.n
        meta = []
        fwd_halves = []
        rev_halves = []
        for c0, c1 in pending:
            h = c1.i - c0.i
            w = c1.j - c0.j
            rm = c0.i + _split_height(h)
            meta.append((c0, c1, rm))
            ri, ci = score.init_types_for(c0.type)
            fwd_halves.append(_Half(c0.i, rm - c0.i, c0.j, w,
                                    _CODE[ri], _CODE[ci]))
            ri, ci = score.init_types_for(c1.type)
            rev_halves.append(_Half(m - c1.i, c1.i - rm, n - c1.j, w,
                                    _CODE[ri], _CODE[ci]))

        njq = max(128, 1 << (max(x.w for x in fwd_halves) - 1)
                  .bit_length())

        next_work = []
        for off in range(0, len(pending), batch_cap):
            sl = slice(off, off + batch_cap)
            t_f0 = time.time()
            fh, ff = _run_level(dev, fwd_halves[sl], False, params, njq)
            rh, rf = _run_level(dev, rev_halves[sl], True, params, njq)
            t_f1 = time.time()

            mm_meta = meta[sl]
            fwd0 = np.empty((len(mm_meta), 2), np.int32)
            rev0 = np.empty((len(mm_meta), 2), np.int32)
            ws = np.empty(len(mm_meta), np.int32)
            goals = np.empty(len(mm_meta), np.int32)
            for r, ((c0, c1, rm), hf, hr) in enumerate(
                    zip(mm_meta, fwd_halves[sl], rev_halves[sl])):
                cif = InitType(_code_inv(hf.col_code))
                cir = InitType(_code_inv(hr.col_code))
                chf, _ = border_cells(1, cif, params, start=hf.h)
                chr_, _ = border_cells(1, cir, params, start=hr.h)
                fwd0[r] = (chf[0],
                           score._border_f_value(cif, hf.h, params))
                rev0[r] = (chr_[0],
                           score._border_f_value(cir, hr.h, params))
                ws[r] = hf.w
                goals[r] = c1.score - c0.score + (
                    go if c1.type != CrosspointType.MATCH else 0)

            t_m0 = time.time()
            res = _run_match(fh, ff, rh, rf, fwd0, rev0, ws, goals,
                             njq, go)
            if _TRACE:
                print(f"    [level {level}] halves={t_f1-t_f0:.2f} "
                      f"meta={t_m0-t_f1:.2f} match={time.time()-t_m0:.2f}",
                      flush=True)
            found, idxs, scrs, typs = (res[0], res[1], res[2], res[3])
            for r, (c0, c1, rm) in enumerate(mm_meta):
                if not found[r]:
                    raise RuntimeError(
                        f"batched Myers-Miller lost the path in "
                        f"{c0}->{c1} (err type {int(typs[r])})"
                    )
                j_star = c1.j - int(idxs[r])
                t = (CrosspointType.MATCH if int(typs[r]) == 0
                     else CrosspointType.GAP_2)
                cm = Crosspoint(rm, j_star, c0.score + int(scrs[r]), t)
                next_work.append((c0, cm))
                next_work.append((cm, c1))
        if log:
            log(f"stage4[batched]: level {level}: {len(pending)} pairs")
        work = next_work

    # reassemble in path order: emit c1 of every pair sorted by position
    done.sort(key=lambda p: (p[0].i, p[0].j))
    out = [cps[0]] + [c1 for _, c1 in done]
    return out


def _code_inv(code: int) -> InitType:
    for k, v in _CODE.items():
        if v == code:
            return k
    raise ValueError(code)
