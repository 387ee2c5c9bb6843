"""End-to-end pipeline tests: full alignment vs the NumPy oracle, with the
stage-5 invariants and the stage-6 independent re-score."""

import numpy as np
import pytest

from masa_tpu.ops import oracle
from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.stages import pipeline, stage6
from masa_tpu.types import AlignmentStart, InitType, Recurrence, ScoreParams

P = ScoreParams()
KCFG = WavefrontConfig(alpha=4, rs=1, chunk=512)


def run(s0, s1, start=AlignmentStart.ANYWHERE, **kw):
    pcfg = pipeline.PipelineConfig(
        alignment_start=start, kernel_cfg=KCFG, **kw
    )
    aln = pipeline.align_pair(s0, s1, pcfg)
    res = stage6.recheck(aln, s0, s1, P)
    assert res.score == aln.raw_score
    assert res.matches == aln.matches
    assert res.mismatches == aln.mismatches
    assert res.gap_opens == aln.gap_opens
    assert res.gap_extensions == aln.gap_extensions
    return aln


class TestLocalAlignment:
    def test_small_exact(self, dna, homolog):
        s0 = dna(400, seed=51)
        s1 = homolog(s0, seed=52)
        aln = run(s0, s1, flush_interval=64, max_cells_stage5=1 << 10)
        ref = oracle.dp_rows(s0, s1, P)
        assert aln.raw_score == ref.best
        assert aln.end == [ref.best_i, ref.best_j]

    def test_identical(self, dna):
        s0 = dna(300, seed=53)
        aln = run(s0, s0, flush_interval=64)
        assert aln.raw_score == 300
        assert aln.matches == 300
        assert aln.gap_opens == 0

    def test_distant(self, dna, homolog):
        s0 = dna(600, seed=55)
        s1 = homolog(s0, seed=56, sub_rate=0.3, indel_rate=0.15)
        aln = run(s0, s1, flush_interval=128, max_cells_stage5=1 << 12)
        ref = oracle.dp_rows(s0, s1, P)
        assert aln.raw_score == ref.best

    def test_unrelated(self, dna):
        s0 = dna(250, seed=57)
        s1 = dna(260, seed=58)
        aln = run(s0, s1, flush_interval=64)
        ref = oracle.dp_rows(s0, s1, P)
        assert aln.raw_score == ref.best

    def test_multi_strip(self, dna, homolog):
        # forces kernel strips (R=512) in stage 1 + densify recursion
        s0 = dna(1400, seed=59)
        s1 = homolog(s0, seed=60)
        aln = run(s0, s1, backend="kernel", flush_interval=512,
                  max_cells_stage5=1 << 14)
        ref = oracle.dp_rows(s0, s1, P)
        assert aln.raw_score == ref.best


class TestGlobalAlignment:
    def test_global_exact(self, dna, homolog):
        s0 = dna(380, seed=61)
        s1 = homolog(s0, seed=62)
        aln = run(s0, s1, AlignmentStart.SEQUENCE_1_AND_2,
                  flush_interval=64, max_cells_stage5=1 << 10)
        ref = oracle.dp_rows(
            s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
            InitType.WITH_GAPS, InitType.WITH_GAPS,
        )
        assert aln.raw_score == ref.last_h[-1]
        assert aln.start == [1, 1]
        assert aln.end == [len(s0), len(s1)]

    def test_global_leading_gap(self, dna):
        # s1 = s0 with a big prefix deletion: alignment must open with a gap
        s0 = dna(300, seed=63)
        s1 = s0[40:].copy()
        aln = run(s0, s1, AlignmentStart.SEQUENCE_1_AND_2,
                  flush_interval=64)
        ref = oracle.dp_rows(
            s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
            InitType.WITH_GAPS, InitType.WITH_GAPS,
        )
        assert aln.raw_score == ref.last_h[-1]

    def test_global_trailing_gap(self, dna):
        s0 = dna(300, seed=64)
        s1 = s0[:-50].copy()
        aln = run(s0, s1, AlignmentStart.SEQUENCE_1_AND_2,
                  flush_interval=64)
        ref = oracle.dp_rows(
            s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
            InitType.WITH_GAPS, InitType.WITH_GAPS,
        )
        assert aln.raw_score == ref.last_h[-1]

    def test_long_internal_gap(self, dna):
        # a 120-base internal deletion spans several special rows
        s0 = dna(500, seed=65)
        s1 = np.concatenate([s0[:200], s0[320:]])
        aln = run(s0, s1, AlignmentStart.SEQUENCE_1_AND_2,
                  flush_interval=64, max_cells_stage5=1 << 10)
        ref = oracle.dp_rows(
            s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
            InitType.WITH_GAPS, InitType.WITH_GAPS,
        )
        assert aln.raw_score == ref.last_h[-1]


class TestRendering:
    def test_text_roundtrip(self, dna, homolog):
        s0 = dna(150, seed=67)
        s1 = homolog(s0, seed=68)
        aln = run(s0, s1, flush_interval=64)
        text = stage6.render_text(aln, s0, s1)
        assert "Score:" in text
        assert str(aln.raw_score) in text


class TestAlignmentEnd:
    """--alignment-end endpoint control (libmasa.cpp:851): endpoints at
    the last row / last column / corner / anywhere, verified against the
    dense oracle, with the full traceback re-checked by stage 5/6."""

    def _run(self, s0, s1, start, end):
        from masa_tpu.stages import pipeline, stage6
        from masa_tpu.types import AlignmentStart

        pcfg = pipeline.PipelineConfig(
            alignment_start=start, alignment_end=end,
            backend="numpy", max_cells_stage5=1 << 14)
        res, ep = pipeline.stage1_pass(s0, s1, pcfg)
        cps = pipeline.stage2_march(s0, s1, pcfg, ep, res.specials)
        cps = pipeline.stage3_densify(s0, s1, pcfg, cps)
        aln = pipeline.stage5_emit(s0, s1, pcfg, cps)
        stage6.recheck(aln, s0, s1, pcfg.params)
        return ep, aln

    def test_end_last_row_local_start(self, dna, homolog):
        import numpy as np

        from masa_tpu.ops import oracle
        from masa_tpu.types import AlignmentStart, ScoreParams

        s0 = dna(260, seed=121)
        s1 = homolog(s0, seed=122)[: 200]
        ref = oracle.dp_rows(s0, s1, ScoreParams())
        want = int(np.asarray(ref.last_h).max())
        ep, aln = self._run(s0, s1, AlignmentStart.ANYWHERE,
                            AlignmentStart.SEQUENCE_2)
        assert ep.i == len(s0) and ep.score == want
        assert aln.raw_score == want

    def test_end_last_col_local_start(self, dna, homolog):
        import numpy as np

        from masa_tpu.ops import oracle
        from masa_tpu.types import AlignmentStart, ScoreParams

        s0 = dna(260, seed=123)
        s1 = homolog(s0, seed=124)[: 200]
        ref = oracle.dp_rows(s0, s1, ScoreParams())
        want = int(np.asarray(ref.col_h).max())
        ep, aln = self._run(s0, s1, AlignmentStart.ANYWHERE,
                            AlignmentStart.SEQUENCE_1)
        assert ep.j == len(s1) and ep.score == want
        assert aln.raw_score == want

    def test_end_either_pinned_start(self, dna, homolog):
        """start '!', end '+': global alignment of the prefix — path from
        the origin to the best of (last row, last column)."""
        import numpy as np

        from masa_tpu.ops import oracle
        from masa_tpu.types import (
            AlignmentStart,
            InitType,
            Recurrence,
            ScoreParams,
        )

        s0 = dna(200, seed=125)
        s1 = dna(240, seed=126)
        ref = oracle.dp_rows(s0, s1, ScoreParams(),
                             Recurrence.NEEDLEMAN_WUNSCH,
                             InitType.WITH_GAPS, InitType.WITH_GAPS)
        want = max(int(np.asarray(ref.last_h).max()),
                   int(np.asarray(ref.col_h).max()))
        ep, aln = self._run(s0, s1, AlignmentStart.SEQUENCE_1_AND_2,
                            AlignmentStart.SEQUENCE_1_OR_2)
        assert ep.score == want
        assert aln.raw_score == want

    def test_end_anywhere_pinned_start(self, dna, homolog):
        """Pinned start + free end: the endpoint is the global NW
        maximum (prefix alignment)."""
        import numpy as np

        from masa_tpu.ops import oracle
        from masa_tpu.types import (
            AlignmentStart, InitType, Recurrence, ScoreParams,
        )

        core = dna(300, seed=127)
        s0 = np.concatenate([core, dna(200, seed=128)])
        s1 = np.concatenate([homolog(core, seed=129), dna(150, seed=130)])
        ref = oracle.dp_matrix(s0, s1, ScoreParams(),
                               Recurrence.NEEDLEMAN_WUNSCH,
                               InitType.WITH_GAPS, InitType.WITH_GAPS)
        b, bi, bj = ref.best()
        ep, aln = self._run(s0, s1, AlignmentStart.SEQUENCE_1_AND_2,
                            AlignmentStart.ANYWHERE)
        assert aln.raw_score == b == ep.score
        assert tuple(aln.end) == (bi, bj)
        assert tuple(aln.start) == (1, 1)


def test_nw_best_includes_border_cells(dna):
    """Regression (review find): with nw_best, the kernel backend must
    seed border candidates — on dissimilar sequences the global NW
    maximum can be a border cell (e.g. the free origin, score 0), which
    the in-kernel interior tracking alone would miss."""
    import numpy as np

    from masa_tpu.ops import oracle
    from masa_tpu.stages import core
    from masa_tpu.types import InitType, Recurrence, ScoreParams

    P = ScoreParams()
    s0 = dna(700, seed=161)
    s1 = dna(650, seed=162)  # unrelated: interior NW values are negative
    ref = oracle.dp_matrix(s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
                           InitType.WITH_GAPS, InitType.WITH_GAPS)
    b, bi, bj = ref.best()
    res = core.forward_pass(
        s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
        InitType.WITH_GAPS, InitType.WITH_GAPS,
        backend="kernel", nw_best=True)
    assert (res.best, res.best_i, res.best_j) == (b, bi, bj)
    assert b == 0 and (bi, bj) == (0, 0)  # the free origin wins here


class _PoisonStore:
    """SpecialRowStore wrapper that makes ONE row unmatchable (all-NEG):
    every width attempt at it misses, driving reverse_march's full-width
    miss path."""

    def __init__(self, inner, bad_row):
        self.inner = inner
        self.bad = bad_row

    def get(self, r):
        from masa_tpu.stages import core

        h, f = self.inner.get(r)
        if r == self.bad:
            return (np.full_like(h, core.NEG), np.full_like(f, core.NEG))
        return h, f

    def rows(self):
        return self.inner.rows()

    def next_below(self, i, min_dist=1):
        return self.inner.next_below(i, min_dist)

    def truncate_above(self, i):
        return self.inner.truncate_above(i)


def test_reverse_march_widens_over_rows(dna, homolog):
    """A full-width miss at a stored special row must SKIP that row and
    rematch at the next one below (reverse_march's row-widen loop)
    instead of aborting.  The reference aborts on any full-width miss
    (stage2/sw_stage2.cpp:115-118); we recover because min_dist is
    caller-configurable and a skipped row is strictly safe to match
    below."""
    from masa_tpu.stages import core

    s0 = dna(4096, seed=91)
    s1 = homolog(s0, seed=92)
    start = AlignmentStart.SEQUENCE_1_AND_2
    pcfg = pipeline.PipelineConfig(
        alignment_start=start, backend="numpy", flush_interval=512)
    res, endpoint = pipeline.stage1_pass(s0, s1, pcfg)
    row_init, col_init = pipeline._mode_inits(start)
    stored = res.specials.rows()
    assert len(stored) >= 3
    bad = stored[len(stored) // 2]

    def march(store):
        specials = core.SpecialRowStore()
        specials._rows = dict(res.specials._rows)
        return core.reverse_march(
            s0, s1, pcfg.params, endpoint, store(specials), row_init,
            col_init, start, backend="numpy")

    clean = march(lambda s: s)
    poisoned = march(lambda s: _PoisonStore(s, bad))
    # the poisoned march recovers: same path, minus the unmatchable row
    assert any(c.i == bad for c in clean)
    assert not any(c.i == bad for c in poisoned)
    assert ([tuple(c) for c in poisoned]
            == [tuple(c) for c in clean if c.i != bad])


def test_densify_progresses_with_single_strip_partitions(monkeypatch):
    """With strips as tall as a whole partition (the CUDA route's
    strips), the padded tail strip runs the fused path and flushes
    interior special rows, so stage 3 densifies every partition down to
    max_cells (a non-densified partition would reach stage 5's dense DP
    whole)."""
    from masa_tpu.ops.wavefront import WavefrontConfig
    from masa_tpu.stages import core, pipeline
    from masa_tpu.types import ScoreParams

    def one_strip(rows):
        r = 1 << (max(rows, 512) - 1).bit_length()
        return WavefrontConfig(alpha=4, rs=min(r, 4096) // 512, chunk=512)

    monkeypatch.setattr(core, "adaptive_config", one_strip)
    rng = np.random.default_rng(3)
    s0 = rng.choice(np.frombuffer(b"ACGT", np.uint8), 1500)
    s1 = s0.copy()
    idx = rng.random(len(s1)) < 0.08
    s1[idx] = rng.choice(np.frombuffer(b"ACGT", np.uint8), int(idx.sum()))
    pc = pipeline.PipelineConfig(params=ScoreParams(), max_partition=0,
                                 max_cells_stage5=1 << 15)
    res, ep = pipeline.stage1_pass(s0, s1, pc)
    cps = pipeline.stage2_march(s0, s1, pc, ep, res.specials)
    cps3 = pipeline.stage3_densify(s0, s1, pc, cps)
    assert max((c1.i - c0.i) * (c1.j - c0.j)
               for c0, c1 in zip(cps3, cps3[1:])) <= 1 << 15
    aln = pipeline.stage5_emit(s0, s1, pc, cps3)
    assert aln.raw_score == ep.score
