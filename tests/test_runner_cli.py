"""Persistent stage runner (resume) + CLI end-to-end tests."""

import numpy as np
import pytest

from masa_tpu.core.job import Job, JobConfig
from masa_tpu.ops import oracle
from masa_tpu.stages import runner
from masa_tpu.types import AlignmentStart, ScoreParams

P = ScoreParams()


def write_fasta(path, desc, seq):
    with open(path, "wb") as f:
        f.write(b">" + desc.encode() + b"\n")
        f.write(bytes(seq) + b"\n")


@pytest.fixture
def jobdir(tmp_path):
    return str(tmp_path / "work.tmp")


class TestRunner:
    def test_full_run_and_resume(self, dna, homolog, jobdir):
        s0 = dna(400, seed=101)
        s1 = homolog(s0, seed=102)
        cfg = JobConfig(work_dir=jobdir, ram_limit=1 << 20,
                        disk_limit=1 << 20, stage4_max_partition=0,
                        backend="numpy")
        job = Job(cfg)
        aln = runner.align_job(job, s0, s1, log=lambda *a: None)
        ref = oracle.dp_rows(s0, s1, P)
        assert aln.raw_score == ref.best

        # second run resumes from artifacts without recomputing
        job2 = Job(cfg)
        best = runner.stage1(job2, s0, s1, log=lambda *a: None)
        assert best.best.score == ref.best
        cps = runner.stage2(job2, s0, s1, log=lambda *a: None)
        assert cps[-1].score == ref.best

    def test_stage2_midstage_crash_resume(self, dna, homolog, jobdir,
                                          monkeypatch):
        """Kill stage 2 after two crosspoints: the rerun must resume from
        the partial autosaved chain (not the endpoint) and produce the
        same crosspoints as an uninterrupted run."""
        s0 = dna(600, seed=111)
        s1 = homolog(s0, seed=112)
        cfg = JobConfig(work_dir=jobdir, ram_limit=1 << 20,
                        disk_limit=1 << 20, stage4_max_partition=0,
                        backend="numpy")
        job = Job(cfg)
        runner.stage1(job, s0, s1, log=lambda *a: None)

        from masa_tpu.stages import core as score

        orig = score.reverse_pass_and_match
        calls = {"n": 0}

        def dying(*a, **k):
            calls["n"] += 1
            if calls["n"] > 1:
                raise KeyboardInterrupt("simulated crash")
            return orig(*a, **k)

        monkeypatch.setattr(score, "reverse_pass_and_match", dying)
        with pytest.raises(KeyboardInterrupt):
            runner.stage2(job, s0, s1, log=lambda *a: None)
        monkeypatch.setattr(score, "reverse_pass_and_match", orig)

        # the partial file exists, is END-less, and holds > 1 crosspoint
        cpf = job.crosspoints_file(runner.STAGE_2, 0)
        partial = cpf.load()
        assert not cpf.complete and len(partial) >= 2

        resumed = {"from": None}
        real_march = score.reverse_march

        def spying(seq0, seq1, params, endpoint, *a, **k):
            resumed["from"] = endpoint
            return real_march(seq0, seq1, params, endpoint, *a, **k)

        monkeypatch.setattr(score, "reverse_march", spying)
        job2 = Job(cfg)
        cps = runner.stage2(job2, s0, s1, log=lambda *a: None)
        # marched from the deepest found crosspoint, not the endpoint
        assert tuple(resumed["from"]) == tuple(partial[-1])
        assert resumed["from"].i < partial[0].i

        # equals an uninterrupted run in a fresh work dir
        import os
        clean_cfg = JobConfig(work_dir=jobdir + ".clean",
                              ram_limit=1 << 20, disk_limit=1 << 20,
                              stage4_max_partition=0, backend="numpy")
        cjob = Job(clean_cfg)
        runner.stage1(cjob, s0, s1, log=lambda *a: None)
        clean = runner.stage2(cjob, s0, s1, log=lambda *a: None)
        assert [tuple(c) for c in cps] == [tuple(c) for c in clean]
        # and the completed file round-trips ascending
        reread = job2.crosspoints_file(runner.STAGE_2, 0)
        cps2 = reread.load()
        assert reread.complete
        assert [tuple(c) for c in cps2] == [tuple(c) for c in cps]

    def test_stage3_midstage_crash_resume(self, dna, homolog, jobdir,
                                          monkeypatch):
        """Kill stage 3 after the first pair's densification: the rerun
        must continue from the autosaved prefix and match a clean run."""
        s0 = dna(700, seed=131)
        s1 = homolog(s0, seed=132)
        cfg = JobConfig(work_dir=jobdir, ram_limit=1 << 20,
                        disk_limit=1 << 20, stage4_max_partition=0,
                        backend="numpy", stage5_max_cells=1 << 12)
        job = Job(cfg)
        runner.stage1(job, s0, s1, log=lambda *a: None)
        runner.stage2(job, s0, s1, log=lambda *a: None)

        from masa_tpu.stages import pipeline as pl

        orig = pl._densify_segment
        calls = {"n": 0}

        def dying(seq0, seq1, pcfg, c0, c1, max_cells, depth):
            if depth == 0:
                calls["n"] += 1
                if calls["n"] > 1:
                    raise KeyboardInterrupt("simulated crash")
            return orig(seq0, seq1, pcfg, c0, c1, max_cells, depth)

        monkeypatch.setattr(pl, "_densify_segment", dying)
        with pytest.raises(KeyboardInterrupt):
            runner.stage3(job, s0, s1, log=lambda *a: None)
        monkeypatch.setattr(pl, "_densify_segment", orig)

        cpf = job.crosspoints_file(runner.STAGE_3, 0)
        partial = cpf.load()
        assert not cpf.complete and len(partial) >= 2

        job2 = Job(cfg)
        msgs = []
        cps = runner.stage3(job2, s0, s1, log=msgs.append)
        assert any("resuming mid-stage" in m for m in msgs)

        clean_cfg = JobConfig(work_dir=jobdir + ".clean",
                              ram_limit=1 << 20, disk_limit=1 << 20,
                              stage4_max_partition=0, backend="numpy",
                              stage5_max_cells=1 << 12)
        cjob = Job(clean_cfg)
        runner.stage1(cjob, s0, s1, log=lambda *a: None)
        runner.stage2(cjob, s0, s1, log=lambda *a: None)
        clean = runner.stage3(cjob, s0, s1, log=lambda *a: None)
        assert [tuple(c) for c in cps] == [tuple(c) for c in clean]

    def test_info_mismatch_detected(self, dna, jobdir):
        cfg = JobConfig(work_dir=jobdir)
        Job(cfg, "aaa", "bbb")
        with pytest.raises(RuntimeError, match="different sequence"):
            Job(cfg, "aaa", "ccc")

    def test_stage4_enabled(self, dna, homolog, jobdir):
        s0 = dna(300, seed=103)
        s1 = homolog(s0, seed=104)
        cfg = JobConfig(work_dir=jobdir, stage4_max_partition=16,
                        backend="numpy")
        job = Job(cfg)
        aln = runner.align_job(job, s0, s1, log=lambda *a: None)
        ref = oracle.dp_rows(s0, s1, P)
        assert aln.raw_score == ref.best

    def test_stage4_non_default_strategy(self, dna, homolog, tmp_path):
        """Non-OPTIMIZED strategies must still get densified partitions
        from stage 3 (stage3's pass-through only applies when stage 4
        takes the device-batched/native OPTIMIZED path)."""
        s0 = dna(300, seed=105)
        s1 = homolog(s0, seed=106)
        cfg = JobConfig(work_dir=str(tmp_path / "s4s"),
                        stage4_max_partition=16,
                        stage4_strategy="ORIGINAL_MM", backend="numpy")
        job = Job(cfg)
        aln = runner.align_job(job, s0, s1, log=lambda *a: None)
        ref = oracle.dp_rows(s0, s1, P)
        assert aln.raw_score == ref.best


class TestCLI:
    def test_local(self, dna, homolog, tmp_path, capsys):
        from masa_tpu.cli import main

        s0 = dna(250, seed=105)
        s1 = homolog(s0, seed=106)
        f0, f1 = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
        write_fasta(f0, "seq a", s0)
        write_fasta(f1, "seq b", s1)
        rc = main([f0, f1, "--work-dir", str(tmp_path / "w"),
                   "--backend", "numpy", "--maximum-partition", "0"])
        assert rc == 0
        out = capsys.readouterr().out
        ref = oracle.dp_rows(s0, s1, P)
        assert f"alignment score: {ref.best}" in out

    def test_global_stage1_only(self, dna, tmp_path, capsys):
        from masa_tpu.cli import main

        s0 = dna(200, seed=107)
        f0, f1 = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
        write_fasta(f0, "a", s0)
        write_fasta(f1, "b", s0)
        rc = main([f0, f1, "--work-dir", str(tmp_path / "w"),
                   "--alignment-start", "!", "--stage-1",
                   "--backend", "numpy"])
        assert rc == 0
        assert "best score: 200" in capsys.readouterr().out

    def test_split_traceback_strategy_flag(self, dna, homolog, tmp_path,
                                           capsys):
        """--traceback speculative on the weighted-split path must
        reproduce the pipelined (and oracle) score — the entry-point
        strategy selection of libmasa.cpp:698-757."""
        from masa_tpu.cli import main

        s0 = dna(300, seed=115)
        s1 = homolog(s0, seed=116)
        f0, f1 = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
        write_fasta(f0, "seq a", s0)
        write_fasta(f1, "seq b", s1)
        ref = oracle.dp_rows(s0, s1, P)
        for k, tb in enumerate(["speculative", "pipelined"]):
            rc = main([f0, f1, "--work-dir", str(tmp_path / f"w{k}"),
                       "--split", "1,1", "--traceback", tb,
                       "--maximum-partition", "0"])
            assert rc == 0
            assert f"alignment score: {ref.best}" in capsys.readouterr().out

    def test_reverse_complement(self, dna, tmp_path, capsys):
        from masa_tpu.cli import main

        s0 = dna(150, seed=108)
        comp = dict(zip(b"ACGT", b"TGCA"))
        rc0 = bytes(comp[c] for c in s0[::-1])
        f0, f1 = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
        write_fasta(f0, "a", s0)
        with open(f1, "wb") as f:
            f.write(b">b\n" + rc0 + b"\n")
        ret = main([f0, f1, "--work-dir", str(tmp_path / "w"),
                    "--reverse-complement", "2", "--stage-1",
                    "--backend", "numpy"])
        assert ret == 0
        assert "best score: 150" in capsys.readouterr().out


class TestMultiAlignment:
    def test_two_alignments(self, dna, jobdir):
        """Two well-separated local alignments are both found and traced
        (--max-alignments)."""
        import numpy as np

        r = np.random.default_rng(161)
        bases = np.frombuffer(b"ACGT", np.uint8)
        a = r.choice(bases, size=200).astype(np.uint8)
        b = r.choice(bases, size=150).astype(np.uint8)
        pad = lambda n, seed: np.random.default_rng(seed).choice(
            bases, size=n
        ).astype(np.uint8)
        s0 = np.concatenate([a, pad(200, 1), b])
        s1 = np.concatenate([b, pad(180, 2), a])
        cfg = JobConfig(work_dir=jobdir, max_alignments=2,
                        backend="numpy", stage4_max_partition=0)
        job = Job(cfg)
        runner.align_job(job, s0, s1, log=lambda *a: None)
        import os

        assert os.path.exists(job.path("alignment.00.cgff"))
        assert os.path.exists(job.path("alignment.01.cgff"))
        from masa_tpu.biology.alignment import read_cgff

        a0 = read_cgff(job.path("alignment.00.cgff"))
        a1 = read_cgff(job.path("alignment.01.cgff"))
        assert a0.raw_score == 200  # the longer exact repeat
        assert a1.raw_score == 150


def test_cli_self_test():
    """--test runs the built-in self-check (the reference's --test throws
    'Not Implemented', libmasa.cpp:1195-1199)."""
    from masa_tpu.cli import main

    assert main(["a.fa", "b.fa", "--test"]) == 0


class TestLazySpecialRows:
    """Stage 1's lazy special rows (no host pull for RAM-destined rows;
    disk checkpoints in the device's packed form) must be byte-equivalent
    to the eager path and crash-resumable."""

    def test_forward_pass_lazy_equivalence(self, dna, monkeypatch):
        from masa_tpu.ops.wavefront import WavefrontConfig
        from masa_tpu.stages import core
        from masa_tpu.types import InitType, Recurrence

        monkeypatch.setenv("MASA_TPU_FORCE_PACKED_PULL", "1")
        s0 = dna(4096, seed=31)
        s1 = dna(2048, seed=32)
        cfg = WavefrontConfig(alpha=4, rs=1, chunk=512, track_best=True)

        def run(lazy):
            store = core.SpecialRowStore()
            res = core.forward_pass(
                s0, s1, P, Recurrence.SMITH_WATERMAN,
                InitType.WITH_ZEROES, InitType.WITH_ZEROES,
                special_every=512, store=store, backend="kernel",
                cfg=cfg, dev_cache=core.DevRowCache(), lazy_rows=lazy)
            return res, store

        r0, st0 = run(False)
        r1, st1 = run(True)
        assert (r0.best, r0.best_i, r0.best_j) == (r1.best, r1.best_i,
                                                   r1.best_j)
        assert st0.rows() == st1.rows() and st0.rows()
        for r in st0.rows():
            h0, f0 = st0.get(r)
            h1, f1 = st1.get(r)
            np.testing.assert_array_equal(h0, h1)
            np.testing.assert_array_equal(f0, f1)

    def test_job_pipeline_disk_packed_rows(self, dna, homolog, jobdir,
                                           monkeypatch):
        """ram_limit=0 forces every lazy special row through the packed
        disk format; the full pipeline and a resumed stage 2 must agree
        with the oracle."""
        monkeypatch.setenv("MASA_TPU_FORCE_PACKED_PULL", "1")
        s0 = dna(3000, seed=41)
        s1 = homolog(s0, seed=42)
        cfg = JobConfig(work_dir=jobdir, ram_limit=0,
                        disk_limit=1 << 30, stage4_max_partition=0)
        job = Job(cfg)
        aln = runner.align_job(job, s0, s1, log=lambda *a: None)
        ref = oracle.dp_rows(s0, s1, P)
        assert aln.raw_score == ref.best
        # the SRA directory actually holds packed-format rows
        import glob
        import os
        rows = glob.glob(os.path.join(jobdir, "special_rows", "*", "*",
                                      "row.*.bin"))
        assert rows
        with open(rows[0], "rb") as fh:
            assert fh.read(4) == b"MSRQ"   # anchored packed rows
        # crash-resume: a fresh job re-reads packed rows for stage 2
        job2 = Job(cfg)
        cps = runner.stage2(job2, s0, s1, log=lambda *a: None)
        assert cps[-1].score == ref.best
