"""Block pruning: the window math and end-to-end safety (pruned run finds
the same best score, with cells actually skipped)."""

import numpy as np
import pytest

from masa_tpu.core import pruning
from masa_tpu.ops import oracle, strips
from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.types import InitType, ScoreParams

P = ScoreParams()
CFG = WavefrontConfig(alpha=4, rs=1, chunk=128, track_best=True)


class TestWindowMath:
    def test_no_best_keeps_all(self):
        busmax = np.zeros(8, np.int64)
        wl, wr = pruning.pruning_window(busmax, 0, 0, 10000, 1024, 128, P)
        assert (wl, wr) == (0, 8)

    def test_high_best_prunes_tail(self):
        # best so high only chunks with big bus values survive
        busmax = np.full(8, -999999999, np.int64)
        busmax[3] = 900
        wl, wr = pruning.pruning_window(
            busmax, 1000, 900, 1024, 1024, 128, P
        )
        # fresh starts can gain at most 124 < 1000; chunk 3 can reach
        # 900 + remaining gains
        assert wl <= 3 < wr
        assert (wl, wr) != (0, 8)

    def test_all_pruned(self):
        busmax = np.full(4, -999999999, np.int64)
        wl, wr = pruning.pruning_window(busmax, 10**6, 0, 512, 512, 128, P)
        assert wl == wr


class TestPrunedAlignment:
    def test_same_best_identical_pair(self, dna):
        # self-alignment: best grows along the diagonal, so pruning bites
        # once best exceeds the remaining diagonal (granularity: 8 strips
        # of 512 rows, pow2-quantized chunk windows)
        s0 = dna(4096, seed=111)
        res_p = strips.run_partition(
            CFG, s0, s0, P, InitType.WITH_ZEROES, InitType.WITH_ZEROES,
            route="scan", prune=True,
        )
        assert res_p.best == 4096
        assert (res_p.best_i, res_p.best_j) == (4096, 4096)
        assert res_p.pruned_cells > 0.15 * res_p.cells

    def test_same_best_homologs(self, dna, homolog):
        s0 = dna(1500, seed=112)
        s1 = homolog(s0, seed=113)
        res_p = strips.run_partition(
            CFG, s0, s1, P, InitType.WITH_ZEROES, InitType.WITH_ZEROES,
            route="scan", prune=True,
        )
        ref = oracle.dp_rows(s0, s1, P)
        assert res_p.best == ref.best
        assert (res_p.best_i, res_p.best_j) == (ref.best_i, ref.best_j)

    def test_unrelated_pair_no_loss(self, dna):
        s0 = dna(800, seed=114)
        s1 = dna(700, seed=115)
        res_p = strips.run_partition(
            CFG, s0, s1, P, InitType.WITH_ZEROES, InitType.WITH_ZEROES,
            route="scan", prune=True,
        )
        ref = oracle.dp_rows(s0, s1, P)
        assert res_p.best == ref.best
