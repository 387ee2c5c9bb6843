"""Level-batched Myers-Miller (ops/batched_mm.py) — the device-first
re-design of stage 4 (stage4/sw_stage4.cpp runs it on CPU pthreads).

The split rows are bucket-snapped (not h//2), so crosspoints can differ
legally from the Python splitter; correctness is the stage-5 contract:
every consecutive pair's constrained segment value equals its score
delta, the chain sums to the endpoint, and all partitions are <= mps."""

import numpy as np
import pytest

from masa_tpu.ops import batched_mm, myers_miller as mm, oracle
from masa_tpu.types import (
    Crosspoint,
    CrosspointType,
    InitType,
    Recurrence,
    ScoreParams,
)

P = ScoreParams()


def _nw_endpoint(s0, s1):
    ref = oracle.dp_rows(s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
                         InitType.WITH_GAPS, InitType.WITH_GAPS)
    return int(ref.last_h[-1])


def _check_chain(s0, s1, out, total, mps):
    from masa_tpu.ops import smallsw

    assert out[0].score == 0 and out[-1].score == total
    tot = 0
    for c0, c1 in zip(out, out[1:]):
        h, w = c1.i - c0.i, c1.j - c0.j
        assert max(h, w) <= mps or h < 2, (c0, c1)
        seg = smallsw.traceback_segment(
            np.ascontiguousarray(s0[c0.i : c1.i]),
            np.ascontiguousarray(s1[c0.j : c1.j]),
            c0.i, c0.j, c0.type, c1.type, P,
        )
        assert seg == c1.score - c0.score, (c0, c1, seg)
        tot += seg
    assert tot == total


class TestBatchedMM:
    def test_chain_contract(self, dna, homolog):
        s0 = dna(1200, seed=71)
        s1 = homolog(s0, seed=72)
        total = _nw_endpoint(s0, s1)
        cps = [Crosspoint(0, 0, 0, CrosspointType.MATCH),
               Crosspoint(len(s0), len(s1), total, CrosspointType.MATCH)]
        for mps in (16, 64):
            got = batched_mm.reduce_partitions_batched(s0, s1, cps, P, mps)
            _check_chain(s0, s1, got, total, mps)

    def test_gapped_pins_and_multiple_input_pairs(self, dna):
        rng = np.random.default_rng(3)
        bases = np.frombuffer(b"ACGT", np.uint8)
        s0 = rng.choice(bases, 600).astype(np.uint8)
        s1 = np.concatenate([s0[:250], s0[290:]])  # 40-base deletion
        total = _nw_endpoint(s0, s1)
        cps = [Crosspoint(0, 0, 0, CrosspointType.MATCH),
               Crosspoint(len(s0), len(s1), total, CrosspointType.MATCH)]
        got = batched_mm.reduce_partitions_batched(s0, s1, cps, P, 8)
        _check_chain(s0, s1, got, total, 8)
        assert any(c.type != CrosspointType.MATCH for c in got)
        # feed a multi-crosspoint input (stage-2/3-like)
        mid = got[len(got) // 2]
        got2 = batched_mm.reduce_partitions_batched(
            s0, s1, [cps[0], mid, cps[1]], P, 8)
        _check_chain(s0, s1, got2, total, 8)

    def test_score_invariant_chain(self, dna, homolog):
        """Every consecutive pair's constrained segment value equals the
        score delta (the stage-5 invariant, sw_stage5.cpp:446-450), and
        the chain sums to the endpoint score."""
        from masa_tpu.ops import smallsw

        s0 = dna(900, seed=77)
        s1 = homolog(s0, seed=78)
        total = _nw_endpoint(s0, s1)
        cps = [Crosspoint(0, 0, 0, CrosspointType.MATCH),
               Crosspoint(len(s0), len(s1), total, CrosspointType.MATCH)]
        out = batched_mm.reduce_partitions_batched(s0, s1, cps, P, 16)
        tot = 0
        for c0, c1 in zip(out, out[1:]):
            seg = smallsw.traceback_segment(
                np.ascontiguousarray(s0[c0.i : c1.i]),
                np.ascontiguousarray(s1[c0.j : c1.j]),
                c0.i, c0.j, c0.type, c1.type, P,
            )
            assert seg == c1.score - c0.score, (c0, c1)
            tot += seg
        assert tot == total
        assert out[0].score == 0 and out[-1].score == total
