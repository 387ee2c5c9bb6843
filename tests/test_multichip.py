"""Multi-chip column-sharded wavefront on an 8-device virtual CPU mesh."""

import numpy as np
import pytest

from masa_tpu.ops import oracle
from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.parallel.mesh import make_mesh
from masa_tpu.parallel.sharded import (
    sharded_align,
    sharded_stage1,
    sharded_stage1_full,
)
from masa_tpu.types import INF, Recurrence, ScoreParams

P = ScoreParams()


def canon(a):
    a = np.asarray(a, dtype=np.int64)
    return np.where(a <= -INF // 2, -INF, a)


class TestShardedStage1:
    @pytest.mark.parametrize("ndev", [1, 2, 8])
    def test_best_score_parity(self, dna, homolog, ndev):
        s0 = dna(700, seed=71)
        s1 = homolog(s0, seed=72)
        mesh = make_mesh(ndev)
        cfg = WavefrontConfig(
            alpha=4, rs=1, chunk=512,
            recurrence=Recurrence.SMITH_WATERMAN,
            track_best=True, store_lastcol=True,
        )
        res = sharded_stage1(s0, s1, mesh, cfg, P)
        ref = oracle.dp_rows(s0, s1, P)
        assert res.best == ref.best

    def test_last_row_parity(self, dna, homolog):
        """The concatenated slab last rows must equal the monolithic DP
        last row — boundary columns crossed the mesh exactly."""
        s0 = dna(512, seed=73)  # exactly one strip per device round
        s1 = homolog(s0, seed=74)
        mesh = make_mesh(4)
        cfg = WavefrontConfig(
            alpha=4, rs=1, chunk=512,
            recurrence=Recurrence.SMITH_WATERMAN,
            track_best=True, store_lastcol=True,
        )
        res = sharded_stage1(s0, s1, mesh, cfg, P)
        ref = oracle.dp_rows(s0, s1, P)
        n = len(s1)
        assert np.array_equal(canon(res.last_h[:n]), canon(ref.last_h[1:]))
        assert np.array_equal(canon(res.last_f[:n]), canon(ref.last_f[1:]))

    def test_last_row_parity_partial_tail(self, dna, homolog):
        """m % rows != 0: the tail strip must stop at the TRUE last row
        (its own partial-height kernel variant) — without it the bus
        decays through sentinel rows and `last_h` comes back as the
        meaningless padded row m_pad (round-3 slow-lane regression)."""
        s0 = dna(300, seed=75)   # rows=512 -> one partial strip
        s1 = homolog(s0, seed=76)
        mesh = make_mesh(2)
        cfg = WavefrontConfig(
            alpha=4, rs=1, chunk=512,
            recurrence=Recurrence.SMITH_WATERMAN,
            track_best=True, store_lastcol=True,
        )
        res = sharded_stage1(s0, s1, mesh, cfg, P)
        ref = oracle.dp_rows(s0, s1, P)
        n = len(s1)
        assert res.best == ref.best
        assert np.array_equal(canon(res.last_h[:n]), canon(ref.last_h[1:]))
        assert np.array_equal(canon(res.last_f[:n]), canon(ref.last_f[1:]))


class TestShardedResume:
    def test_interrupted_chunk_resumes_identical(self, dna, homolog,
                                                 tmp_path, monkeypatch):
        """Crash mid-stage-1 (after a chunk checkpoint), rerun, and the
        resumed run must produce byte-identical slab artifacts to an
        uninterrupted run — the multi-chip Status-file resume
        (common/Status.cpp:70-89 + sw_stage1.cpp:210-217)."""
        import masa_tpu.parallel.sharded as sh

        s0 = dna(4096, seed=181)
        s1 = homolog(s0, seed=182)
        mesh = make_mesh(4)
        cfg = WavefrontConfig(alpha=4, rs=1, chunk=512,
                              recurrence=Recurrence.SMITH_WATERMAN)

        ref = sh.sharded_stage1_full(s0, s1, mesh, cfg, P,
                                     flush_stride=1)

        state = str(tmp_path / "state")
        calls = {"n": 0}
        orig = sh.ShardedStateSink.chunk_done

        def dying(self, round0):
            orig(self, round0)
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("simulated crash")

        monkeypatch.setattr(sh.ShardedStateSink, "chunk_done", dying)
        with pytest.raises(RuntimeError, match="simulated crash"):
            sh.sharded_stage1_full(s0, s1, mesh, cfg, P, flush_stride=1,
                                   state_dir=state)
        monkeypatch.setattr(sh.ShardedStateSink, "chunk_done", orig)

        import os

        assert os.path.exists(os.path.join(state, "sharded_carry.npz"))
        res = sh.sharded_stage1_full(s0, s1, mesh, cfg, P,
                                     flush_stride=1, state_dir=state)
        assert (res.best, res.best_i, res.best_j) == (
            ref.best, ref.best_i, ref.best_j)
        for pr, pf in zip(res.parts, ref.parts):
            assert np.array_equal(pr.last_h, pf.last_h)
            assert pr.specials.rows() == pf.specials.rows()
            for r in pf.specials.rows():
                a, b = pr.specials.get(r), pf.specials.get(r)
                assert np.array_equal(a[0], b[0])
                assert np.array_equal(a[1], b[1])
            if pf.first_col is not None:
                assert np.array_equal(pr.first_col[0], pf.first_col[0])
                assert np.array_equal(pr.first_col[1], pf.first_col[1])

    def test_stale_carry_invalidated_on_param_change(self, dna, homolog,
                                                     tmp_path):
        """A COMPLETED run's carry checkpoint must not satisfy a rerun
        with different score params in the same state dir: the carry is
        fingerprinted over params/prune/sequences, so the changed rerun
        recomputes instead of returning the stale result (round-3 review
        finding; Status fingerprint semantics, common/Job.cpp:102-146)."""
        import masa_tpu.parallel.sharded as sh

        s0 = dna(2048, seed=191)
        s1 = homolog(s0, seed=192)
        mesh = make_mesh(4)
        cfg = WavefrontConfig(alpha=4, rs=1, chunk=512,
                              recurrence=Recurrence.SMITH_WATERMAN)
        state = str(tmp_path / "state")
        r1 = sh.sharded_stage1_full(s0, s1, mesh, cfg, P, flush_stride=1,
                                    state_dir=state)
        p2 = ScoreParams(match=2, mismatch=-1, gap_open=4, gap_ext=2)
        r2 = sh.sharded_stage1_full(s0, s1, mesh, cfg, p2, flush_stride=1,
                                    state_dir=state)
        ref2 = sh.sharded_stage1_full(s0, s1, mesh, cfg, p2,
                                      flush_stride=1)
        assert (r2.best, r2.best_i, r2.best_j) == (
            ref2.best, ref2.best_i, ref2.best_j)
        assert r2.best != r1.best


class TestScoreSharePruning:
    """Distributed score-share pruning (TPDS2021) — the feature the
    reference DISABLES in multi-GPU runs (libmasa.cpp:1318-1323)."""

    def test_exact_best_with_pruning(self, dna, homolog):
        import numpy as np

        from masa_tpu.ops import oracle
        from masa_tpu.ops.wavefront import WavefrontConfig
        from masa_tpu.parallel.mesh import make_mesh
        from masa_tpu.parallel.sharded import sharded_stage1
        from masa_tpu.types import ScoreParams

        P = ScoreParams()
        cfg = WavefrontConfig(alpha=2, rs=1, chunk=256, track_best=True,
                              store_lastcol=True)
        mesh = make_mesh(8)
        # similar pair: the best lands early, later strips prune
        s0 = dna(2048, seed=61)
        s1 = homolog(s0, seed=62)
        ref = oracle.dp_rows(s0, s1, P)
        res = sharded_stage1(s0, s1, mesh, cfg, P, prune=True)
        assert res.best == ref.best
        assert res.pruned_strips is not None
        assert int(np.sum(res.pruned_strips)) > 0

    def test_exact_best_random_pair_no_overprune(self, dna):
        from masa_tpu.ops import oracle
        from masa_tpu.ops.wavefront import WavefrontConfig
        from masa_tpu.parallel.mesh import make_mesh
        from masa_tpu.parallel.sharded import sharded_stage1
        from masa_tpu.types import ScoreParams

        P = ScoreParams()
        cfg = WavefrontConfig(alpha=2, rs=1, chunk=256, track_best=True,
                              store_lastcol=True)
        mesh = make_mesh(8)
        s0 = dna(1500, seed=63)
        s1 = dna(1700, seed=64)
        ref = oracle.dp_rows(s0, s1, P)
        res = sharded_stage1(s0, s1, mesh, cfg, P, prune=True)
        assert res.best == ref.best


CFG = WavefrontConfig(alpha=4, rs=1, chunk=512, track_best=True,
                      store_lastcol=True)


class TestShardedFullAlignment:
    """The complete multi-chip pipeline (stage 1 over the mesh + slab
    traceback + stages 3/5/6) — the reference's whole multi-GPU claim
    (libmasa.cpp:659-757), oracle-verified end to end."""

    def test_endpoint_parity(self, dna, homolog):
        s0 = dna(700, seed=81)
        s1 = homolog(s0, seed=82)
        mesh = make_mesh(8)
        ref = oracle.dp_rows(s0, s1, P)
        full = sharded_stage1_full(s0, s1, mesh, CFG, P)
        assert (full.best, full.best_i, full.best_j) == (
            ref.best, ref.best_i, ref.best_j)
        # per-device parts carry usable special rows + boundary columns
        assert len(full.parts) >= 2
        assert all(len(p.specials) > 0 for p in full.parts)
        assert all(p.first_col is not None for p in full.parts[1:])

    @pytest.mark.parametrize("ndev", [2, 8])
    def test_full_alignment_matches_single_chip(self, dna, homolog, ndev):
        from masa_tpu.stages import pipeline

        s0 = dna(700, seed=83)
        s1 = homolog(s0, seed=84)
        mesh = make_mesh(ndev)
        ref = oracle.dp_rows(s0, s1, P)
        # Byte-identity holds on march-produced chains (stage 4 off): the
        # Myers-Miller midrow split picks a partitioning-dependent
        # co-optimal representative (DESIGN.md "canonical path"), so the
        # byte-level cross-check pins max_partition=0 on both sides.
        best, aln = sharded_align(s0, s1, mesh, CFG, P, max_partition=0)
        assert best == aln.raw_score == ref.best
        aln1 = pipeline.align_pair(
            s0, s1, pipeline.PipelineConfig(params=P, max_partition=0))
        assert aln.gaps == aln1.gaps
        assert (aln.start, aln.end) == (aln1.start, aln1.end)
        # The production default (stage-4 ladder on) must still be exact:
        # optimal score, stage-5 segment invariants, stage-6 re-check
        # (both run inside sharded_align).
        best4, aln4 = sharded_align(s0, s1, mesh, CFG, P)
        assert best4 == aln4.raw_score == ref.best

    def test_speculative_traceback(self, dna, homolog):
        s0 = dna(700, seed=85)
        s1 = homolog(s0, seed=86)
        mesh = make_mesh(8)
        ref = oracle.dp_rows(s0, s1, P)
        best, aln = sharded_align(s0, s1, mesh, CFG, P,
                                  traceback="speculative")
        assert best == aln.raw_score == ref.best

    def test_full_alignment_with_score_share_pruning(self, dna, homolog):
        s0 = dna(1024, seed=87)
        s1 = homolog(s0, seed=88)
        mesh = make_mesh(8)
        ref = oracle.dp_rows(s0, s1, P)
        best, aln = sharded_align(s0, s1, mesh, CFG, P, prune=True)
        assert best == aln.raw_score == ref.best

    def test_sparse_flush_stride(self, dna, homolog):
        s0 = dna(700, seed=89)
        s1 = homolog(s0, seed=90)
        mesh = make_mesh(4)
        ref = oracle.dp_rows(s0, s1, P)
        best, aln = sharded_align(s0, s1, mesh, CFG, P, flush_stride=8)
        assert best == aln.raw_score == ref.best

    def test_endpoint_in_left_slab(self, dna, homolog):
        """Path confined to early columns: the march never crosses into
        right slabs and right devices hold only sentinel-decayed state."""
        s0 = dna(300, seed=91)
        s1 = np.concatenate([homolog(s0, seed=92), dna(800, seed=93)])
        mesh = make_mesh(8)
        ref = oracle.dp_rows(s0, s1, P)
        best, aln = sharded_align(s0, s1, mesh, CFG, P)
        assert best == aln.raw_score == ref.best


def test_full_alignment_three_devices(dna, homolog):
    """Non-power-of-two mesh with a width not divisible by D: uneven
    slab padding and the last device's short slab must stay exact."""
    s0 = dna(500, seed=95)
    s1 = homolog(s0, seed=96)[:470]
    mesh = make_mesh(3)
    ref = oracle.dp_rows(s0, s1, P)
    best, aln = sharded_align(s0, s1, mesh, CFG, P)
    assert best == aln.raw_score == ref.best
