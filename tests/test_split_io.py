"""Cells I/O stack + multi-process column split + AlignerPool tests."""

import numpy as np
import pytest

from masa_tpu.io import cells as cio
from masa_tpu.ops import oracle
from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.parallel import split
from masa_tpu.parallel.pool import AlignerPool
from masa_tpu.types import BestScore, Crosspoint, InitType, ScoreParams

P = ScoreParams()
CFG = WavefrontConfig(alpha=4, rs=1, chunk=128, track_best=True)


class TestCellsIO:
    def test_initial_reader(self):
        r = cio.InitialCellsReader(InitType.WITH_GAPS, P, start=1)
        h, g = r.read(3)
        assert list(h) == [-5, -7, -9]

    def test_file_roundtrip(self, tmp_path):
        path = str(tmp_path / "cells.bin")
        w = cio.FileCellsWriter(path)
        w.write(np.arange(5, dtype=np.int32),
                np.arange(5, dtype=np.int32) * -1)
        w.close()
        r = cio.FileCellsReader(path)
        h, g = r.read(5)
        assert list(h) == [0, 1, 2, 3, 4]
        assert list(g) == [0, -1, -2, -3, -4]

    def test_socket_roundtrip(self):
        import threading

        w = cio.SocketCellsWriter(17901)

        def send():
            w.write(np.array([7, 8], np.int32), np.array([9, 10], np.int32))
            w.close()

        t = threading.Thread(target=send)
        t.start()
        r = cio.SocketCellsReader("127.0.0.1", 17901)
        h, g = r.read(2)
        t.join()
        assert list(h) == [7, 8] and list(g) == [9, 10]

    def test_buffered_and_tee(self, tmp_path):
        path = str(tmp_path / "tee.bin")
        src = cio.InitialCellsReader(InitType.WITH_ZEROES, P)
        tee = cio.TeeCellsReader(src, cio.FileCellsWriter(path))
        buf = cio.BufferedCellsReader(tee, chunk=4, total=12)
        h, _ = buf.read(12)
        assert (h == 0).all()
        r = cio.FileCellsReader(path)
        h2, _ = r.read(12)
        assert (h2 == 0).all()

    def test_reversed_split(self):
        src = cio.MemoryCellsReader(np.arange(10), np.zeros(10))
        rev = cio.ReversedCellsReader(src, 10)
        h, _ = rev.read(3)
        assert list(h) == [9, 8, 7]
        src2 = cio.MemoryCellsReader(np.arange(10), np.zeros(10))
        sub = cio.SplitCellsReader(src2, 4, 3)
        h, _ = sub.read(5)
        assert list(h) == [4, 5, 6]

    def test_url_dispatch(self, tmp_path):
        assert isinstance(cio.open_reader("null://"), cio.DummyCellsReader)
        w = cio.open_writer(f"file://{tmp_path}/x.bin")
        assert isinstance(w, cio.FileCellsWriter)


class TestColumnSplit:
    @pytest.mark.parametrize("nparts", [2, 3])
    def test_serial_split_matches_oracle(self, dna, homolog, tmp_path,
                                         nparts):
        s0 = dna(700, seed=121)
        s1 = homolog(s0, seed=122)
        parts = split.run_split_serial(
            s0, s1, nparts, str(tmp_path), P, CFG
        )
        ref = oracle.dp_rows(s0, s1, P)
        assert max(p.best for p in parts) == ref.best
        last = np.concatenate([p.last_h for p in parts])
        assert np.array_equal(last, ref.last_h[1:])

    def test_socket_split_processes(self, dna, homolog):
        s0 = dna(600, seed=123)
        s1 = homolog(s0, seed=124)
        parts = split.run_split_threads(s0, s1, 2, P, CFG,
                                          base_port=17910)
        ref = oracle.dp_rows(s0, s1, P)
        assert max(p.best for p in parts) == ref.best


class TestAlignerPool:
    def test_score_and_crosspoint_flow(self, tmp_path):
        d = str(tmp_path / "shared")
        n0 = AlignerPool(d, 0, 2)
        n1 = AlignerPool(d, 1, 2)
        n0.dispatch_score(BestScore(5, 6, 42))
        assert n1.receive_score() == BestScore(5, 6, 42)
        n1.dispatch_crosspoint(Crosspoint(1, 2, 3, 0), True)
        cp, final = n0.receive_crosspoint()
        assert cp == Crosspoint(1, 2, 3, 0) and final

    def test_file_handoff(self, tmp_path):
        d = str(tmp_path / "shared")
        n0 = AlignerPool(d, 0, 2)
        n1 = AlignerPool(d, 1, 2)
        src = tmp_path / "cps.txt"
        src.write_text("START\n0,1,2,3\nEND\n")
        n1.dispatch_file(str(src), "stage4")
        out = n0.receive_file("stage4", str(tmp_path))
        assert open(out).read().startswith("START")


class TestPipelinedTraceback:
    @pytest.mark.parametrize("nparts", [2, 3])
    def test_full_alignment_across_slabs(self, dna, homolog, tmp_path,
                                         nparts):
        from masa_tpu.parallel.split import (
            auto_urls, pipelined_traceback, run_part_stage1, split_points,
        )
        from masa_tpu.stages import pipeline, stage6

        s0 = dna(800, seed=131)
        s1 = homolog(s0, seed=132)
        points = split_points(len(s1), [1.0] * nparts)
        urls = auto_urls(str(tmp_path), nparts)
        parts = []
        for k in range(nparts):
            parts.append(run_part_stage1(
                s0, s1, k, points, P, CFG,
                load_url=urls[k - 1] if k > 0 else None,
                flush_url=urls[k] if k < nparts - 1 else None,
                route="scan", buffered=False, special_every=512,
            ))
        cps = pipelined_traceback(s0, s1, parts, P)
        ref = oracle.dp_rows(s0, s1, P)
        assert cps[-1].score == ref.best
        assert cps[0].score == 0
        # stages 3+5 on the merged crosspoints produce the exact alignment
        pcfg = pipeline.PipelineConfig(kernel_cfg=CFG,
                                       max_cells_stage5=1 << 14)
        cps = pipeline.stage3_densify(s0, s1, pcfg, cps)
        aln = pipeline.stage5_emit(s0, s1, pcfg, cps)
        stage6.recheck(aln, s0, s1, P)
        assert aln.raw_score == ref.best


class TestSpeculativeTraceback:
    def test_reuses_speculation(self, dna, tmp_path):
        """Near-identical pair: each slab's local best lies on the global
        optimal path, so speculation is confirmed and spliced."""
        from masa_tpu.parallel.split import (
            auto_urls, run_part_stage1, speculative_traceback,
            split_points,
        )
        from masa_tpu.stages import pipeline, stage6

        s0 = dna(900, seed=151)
        s1 = s0.copy()
        nparts = 3
        points = split_points(len(s1), [1.0] * nparts)
        urls = auto_urls(str(tmp_path), nparts)
        parts = []
        for k in range(nparts):
            parts.append(run_part_stage1(
                s0, s1, k, points, P, CFG,
                load_url=urls[k - 1] if k > 0 else None,
                flush_url=urls[k] if k < nparts - 1 else None,
                route="scan", buffered=False, special_every=512,
            ))
        cps, reused = speculative_traceback(s0, s1, parts, P)
        assert reused > 0, "speculation should be confirmed on identity"
        assert cps[-1].score == 900
        assert cps[0].score == 0
        pcfg = pipeline.PipelineConfig(kernel_cfg=CFG,
                                       max_cells_stage5=1 << 14)
        cps2 = pipeline.stage3_densify(s0, s1, pcfg, cps)
        aln = pipeline.stage5_emit(s0, s1, pcfg, cps2)
        stage6.recheck(aln, s0, s1, P)
        assert aln.raw_score == 900

    def test_correct_when_speculation_misses(self, dna, homolog, tmp_path):
        from masa_tpu.parallel.split import (
            auto_urls, run_part_stage1, speculative_traceback,
            split_points,
        )

        s0 = dna(700, seed=153)
        s1 = homolog(s0, seed=154, sub_rate=0.3, indel_rate=0.15)
        nparts = 2
        points = split_points(len(s1), [1.0] * nparts)
        urls = auto_urls(str(tmp_path), nparts)
        parts = []
        for k in range(nparts):
            parts.append(run_part_stage1(
                s0, s1, k, points, P, CFG,
                load_url=urls[k - 1] if k > 0 else None,
                flush_url=urls[k] if k < nparts - 1 else None,
                route="scan", buffered=False, special_every=512,
            ))
        cps, reused = speculative_traceback(s0, s1, parts, P)
        ref = oracle.dp_rows(s0, s1, P)
        assert cps[-1].score == ref.best


class TestOversizeSplitting:
    """Oversize-matrix chaining (sw_stage1.cpp:362-375): when seq1 exceeds
    the per-run width capability, column slabs chain through file://
    borders and the pipelined traceback recovers the exact alignment."""

    def test_align_oversize_matches_oracle(self, dna, homolog, tmp_path):
        from masa_tpu.parallel.split import align_oversize
        from masa_tpu.stages import stage6

        s0 = dna(700, seed=41)
        s1 = homolog(s0, seed=42)
        best, aln = align_oversize(
            s0, s1, max_width=256, work_dir=str(tmp_path), params=P,
            cfg=CFG, max_cells_stage5=1 << 14,
        )
        ref = oracle.dp_rows(s0, s1, P)
        assert best == ref.best
        assert aln.raw_score == ref.best


class TestBufferStats:
    def test_throughput_counters(self, tmp_path):
        """Buffered streams expose Buffer2-style throughput stats
        (io/Buffer2.hpp:55-123, BufferLogger)."""
        import numpy as np

        from masa_tpu.io import cells as cio

        p = str(tmp_path / "c.bin")
        w = cio.BufferedCellsWriter(cio.FileCellsWriter(p))
        h = np.arange(1000, dtype=np.int32)
        w.write(h, h)
        w.close()
        assert w.stats()["cells"] == 1000
        logf = str(tmp_path / "buf.log")
        r = cio.BufferedCellsReader(cio.FileCellsReader(p), chunk=256,
                                    total=1000, log_file=logf)
        got_h, got_g = r.read(1000)
        np.testing.assert_array_equal(got_h, h)
        st = r.stats()
        assert st["cells"] == 1000 and st["cells_per_s"] > 0
        assert "cells" in open(logf).read()
