"""The aligner/manager contract layer: both extensions drive identically
through the manager and agree with each other (the MASA portability
architecture's differential check)."""

import numpy as np
import pytest

from masa_tpu.core.aligner import CPUAligner, KernelAligner
from masa_tpu.core.manager import AlignerManager
from masa_tpu.ops import oracle
from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.types import (
    InitType,
    Partition,
    Recurrence,
    ScoreParams,
)

P = ScoreParams()
KCFG = WavefrontConfig(alpha=4, rs=1, chunk=128)


def drive(aligner, s0, s1, rec=Recurrence.SMITH_WATERMAN, interval=0):
    mgr = AlignerManager(aligner, P)
    mgr.set_recurrence_type(rec)
    mgr.set_special_row_interval(interval)
    if rec == Recurrence.NEEDLEMAN_WUNSCH:
        mgr.set_first_row(InitType.WITH_GAPS)
        mgr.set_first_column(InitType.WITH_GAPS)
    if interval:
        from masa_tpu.stages.core import SpecialRowStore

        mgr.set_special_rows_store(SpecialRowStore())
    aligner.initialize()
    aligner.set_sequences(s0, s1)
    mgr.align_partition(Partition(0, 0, len(s0), len(s1)))
    aligner.unset_sequences()
    aligner.finalize()
    return mgr


class TestContracts:
    def test_extensions_agree_sw(self, dna, homolog):
        s0 = dna(600, seed=141)
        s1 = homolog(s0, seed=142)
        m_kern = drive(KernelAligner(KCFG, route="scan"), s0, s1,
                      interval=512)
        m_cpu = drive(CPUAligner(), s0, s1, interval=512)
        assert m_kern.best_scores.best == m_cpu.best_scores.best
        assert m_kern.last_row[0] == m_cpu.last_row[0]
        assert np.array_equal(m_kern.last_row[1], m_cpu.last_row[1])
        for r in m_kern.special_rows.rows():
            th, tf = m_kern.special_rows.get(r)
            ch, cf = m_cpu.special_rows.get(r)
            assert np.array_equal(th, ch)

    def test_nw_last_row(self, dna, homolog):
        s0 = dna(300, seed=143)
        s1 = homolog(s0, seed=144)
        mgr = drive(KernelAligner(KCFG, route="scan"), s0, s1,
                    Recurrence.NEEDLEMAN_WUNSCH)
        ref = oracle.dp_rows(s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
                             InitType.WITH_GAPS, InitType.WITH_GAPS)
        assert mgr.last_row[1][-1] == ref.last_h[-1]

    def test_capabilities(self):
        caps = KernelAligner(KCFG).get_capabilities()
        assert caps.smith_waterman and caps.needleman_wunsch
        assert caps.block_pruning
        assert not CPUAligner().get_capabilities().block_pruning

    def test_goal_stop(self, dna):
        """Goal-score matching through the dispatch funnel stops the
        aligner early (the stage-2 mechanism at the contract level)."""
        s0 = dna(600, seed=145)
        fwd = oracle.dp_rows(s0, s0, P, special_rows=(256,))
        fh, ff = fwd.specials[256]
        aligner = KernelAligner(KCFG, route="scan")
        mgr = AlignerManager(aligner, P)
        mgr.set_recurrence_type(Recurrence.SMITH_WATERMAN)
        mgr.set_special_row_interval(128)
        from masa_tpu.stages.core import SpecialRowStore

        mgr.set_special_rows_store(SpecialRowStore())
        # reverse marching frame: reversed sequences, goal = best score
        rs0 = s0[::-1].copy()
        mgr.set_first_row(InitType.WITH_GAPS)
        mgr.set_first_column(InitType.WITH_GAPS)
        mgr.set_recurrence_type(Recurrence.NEEDLEMAN_WUNSCH)
        mgr.set_goal_score(
            600, base_row=(fh[::-1].copy(), ff[::-1].copy())
        )
        aligner.set_sequences(rs0, rs0)
        # partition ends exactly at the cut: reverse row 600-256
        mgr.align_partition(Partition(0, 0, 600 - 256, len(rs0)))
        assert mgr.is_found_crosspoint()
        cp = mgr.get_next_crosspoint()
        # crosspoint sums certify: fwd + rev == goal at the cut
        assert cp is not None
