"""Stage 4: Myers-Miller midpoint splitting of small partitions.

Reference: stage4/sw_stage4.cpp — split every partition at its middle row
until the largest partition is <= max_partition, with three strategies
(sw_stage4.cpp:146-163):

  * ORIGINAL_MM  — full forward half + full reverse half, match the cut
    (split, sw_stage4.cpp:642-783).
  * ORTHOGONAL   — forward half first, reverse matched within a column
    window around the forward optimum (ort_split, :382).
  * OPTIMIZED    — forward and reverse computed inside a growing band with
    early match exit — the multiple-Fickett-band acceleration of JCB2019
    (ort_split_2, :297-380).

All three are exact (the band variants widen until the goal sum matches),
and mutually redundant — differential testing leverage, like the
reference.  Splitting batches run multithreaded when the native extension
is present.
"""

from __future__ import annotations

import enum

import numpy as np

from masa_tpu.models.scoring import match_column
from masa_tpu.ops import oracle
from masa_tpu.stages import core
from masa_tpu.types import (
    Crosspoint,
    CrosspointType,
    MatchType,
    Recurrence,
    ScoreParams,
)


class SplitStrategy(enum.IntEnum):
    ORIGINAL_MM = 0
    ORTHOGONAL = 1
    OPTIMIZED = 2


def _half_pass(seq0, seq1, params, row_init, col_init):
    """NW forward pass returning the last row (H, F) with the border gap
    value synthesized at k=0."""
    res = oracle.dp_rows(
        seq0, seq1, params, Recurrence.NEEDLEMAN_WUNSCH, row_init, col_init
    )
    lf = res.last_f.copy()
    lf[0] = core._border_f_value(col_init, len(seq0), params)
    return res.last_h, lf


def split_partition(
    seq0: np.ndarray,
    seq1: np.ndarray,
    c0: Crosspoint,
    c1: Crosspoint,
    params: ScoreParams,
    strategy: SplitStrategy = SplitStrategy.OPTIMIZED,
) -> Crosspoint:
    """Find the crosspoint where the optimal c0->c1 path crosses the
    partition's middle row.  Coordinates are global; sequences are full."""
    h = c1.i - c0.i
    w = c1.j - c0.j
    assert h >= 2, "nothing to split"
    rm = c0.i + h // 2
    hb, ht = rm - c0.i, c1.i - rm
    sub0f = np.ascontiguousarray(seq0[c0.i : rm])
    sub0r = np.ascontiguousarray(seq0[rm : c1.i][::-1])
    # Cut-matching goal: the constrained segment value (score difference)
    # plus one gap_open when the c1 pin is gapped (the reverse pass's
    # opened border omits exactly that open) — same convention as stage 2.
    goal = c1.score - c0.score + (
        params.gap_open if c1.type != CrosspointType.MATCH else 0
    )

    fr_init, fc_init = core.init_types_for(c0.type)
    rr_init, rc_init = core.init_types_for(c1.type)

    if strategy == SplitStrategy.ORIGINAL_MM:
        windows = [w]
    else:
        w0 = min(w, max(64, 2 * max(hb, ht)))
        windows = []
        while w0 < w:
            windows.append(w0)
            w0 *= 2
        windows.append(w)

    for win in windows:
        # Windows are clamped inside the partition: monotone paths from c0
        # never leave [c0.j, c1.j].
        fw = np.ascontiguousarray(seq1[c0.j : min(c0.j + win, c1.j)])
        rw = np.ascontiguousarray(
            seq1[max(c1.j - win, c0.j) : c1.j][::-1]
        )
        fh, ff = _half_pass(sub0f, fw, params, fr_init, fc_init)
        rh, rf = _half_pass(sub0r, rw, params, rr_init, rc_init)
        j_lo = max(c0.j, c1.j - win)
        j_hi = min(c1.j, c0.j + win)
        if j_lo > j_hi:
            continue
        js = np.arange(j_lo, j_hi + 1)
        f_idx = js - c0.j
        r_idx = c1.j - js
        # scan from the c1 side (descending j) like stage 2
        mres = match_column(
            rh[r_idx][::-1], rf[r_idx][::-1],
            fh[f_idx][::-1], ff[f_idx][::-1],
            goal,
            params.gap_open,
        )
        if mres.found:
            j_star = int(js[::-1][mres.k])
            t = (CrosspointType.MATCH if mres.type == MatchType.ALIGNED
                 else CrosspointType.GAP_2)
            return Crosspoint(rm, j_star, c0.score + int(mres.score), t)
        if win == w:
            raise RuntimeError(
                f"Myers-Miller split lost the path in {c0}->{c1}"
            )
    raise RuntimeError("unreachable")


def reduce_partitions(
    seq0: np.ndarray,
    seq1: np.ndarray,
    cps: list[Crosspoint],
    params: ScoreParams,
    max_partition: int = 16,
    strategy: SplitStrategy = SplitStrategy.OPTIMIZED,
) -> list[Crosspoint]:
    """Split every adjacent pair until max(height, width) <= max_partition
    (the stage-4 loop, sw_stage4.cpp:926-945)."""
    out = [cps[0]]
    stack = list(zip(cps, cps[1:]))
    # process in order; recursion via explicit stack keeps output sorted
    def emit(c0, c1):
        h, w = c1.i - c0.i, c1.j - c0.j
        if max(h, w) <= max_partition or h < 2:
            out.append(c1)
            return
        cm = split_partition(seq0, seq1, c0, c1, params, strategy)
        emit(c0, cm)
        emit(cm, c1)

    for c0, c1 in stack:
        emit(c0, c1)
    return out


def device_batched(strategy: "SplitStrategy | str") -> bool:
    """Does stage 4 run on the device engine (ops/batched_mm)?  Only the
    OPTIMIZED ladder, and only on the CUDA route: on an H100 it beats the
    native C++ pool by ~10x once stage 4 has real work (PERF.md,
    Findings); the CPU keeps the native/Python splitters."""
    from masa_tpu.utils.devices import kernel_route

    name = strategy.name if isinstance(strategy, SplitStrategy) \
        else str(strategy)
    return name == "OPTIMIZED" and kernel_route() == "cuda"


def stage4_reduce(
    seq0: np.ndarray,
    seq1: np.ndarray,
    cps: list[Crosspoint],
    params: ScoreParams,
    max_partition: int = 16,
    strategy: SplitStrategy = SplitStrategy.OPTIMIZED,
    log=None,
    stage5_max_cells: int | None = None,
) -> list[Crosspoint]:
    """Engine-choosing stage-4 reduction (the sw_stage4.cpp:926-945 loop,
    shared by the monolithic runner, the sharded multi-chip path, and the
    fork workers):

      * the device engine (ops/batched_mm.py) where device_batched says
        so, splitting only down to what stage 5 absorbs directly (its DP
        is dynamic-size, unlike the reference's static 1024^2 buffers
        that force maximum-partition=16);
      * else the native C++ ladder when built;
      * else the Python splitter (any strategy — the differential twin).
    """
    if not max_partition or len(cps) < 2:
        return cps
    if device_batched(strategy):
        import math

        from masa_tpu.ops.batched_mm import reduce_partitions_batched

        mps = max_partition
        if stage5_max_cells:
            mps = max(mps, int(math.isqrt(stage5_max_cells)))
        return reduce_partitions_batched(
            seq0, seq1, cps, params, mps, log=log)
    if strategy == SplitStrategy.OPTIMIZED:
        try:
            from masa_tpu.native import bindings

            # the native path implements the OPTIMIZED ladder bit-exactly;
            # other strategies -> Python (differential twins)
            if bindings.available():
                return bindings.reduce_partitions(
                    seq0, seq1, cps, params, max_partition)
        except ImportError:
            pass
    return reduce_partitions(seq0, seq1, cps, params, max_partition,
                             strategy)
