"""Stage-4 Myers-Miller splitting: all three strategies agree and keep the
stage-5 invariants."""

import numpy as np
import pytest

from masa_tpu.ops import myers_miller as mm
from masa_tpu.ops import oracle
from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.stages import pipeline, stage6
from masa_tpu.types import AlignmentStart, ScoreParams

P = ScoreParams()
KCFG = WavefrontConfig(alpha=4, rs=1, chunk=512)


def march_to_cps(s0, s1, start=AlignmentStart.ANYWHERE):
    pcfg = pipeline.PipelineConfig(alignment_start=start, kernel_cfg=KCFG,
                                   flush_interval=128,
                                   max_cells_stage5=1 << 14)
    res, endpoint = pipeline.stage1_pass(s0, s1, pcfg)
    cps = pipeline.stage2_march(s0, s1, pcfg, endpoint, res.specials)
    cps = pipeline.stage3_densify(s0, s1, pcfg, cps)
    return pcfg, cps


class TestStage4:
    @pytest.mark.parametrize("strategy", list(mm.SplitStrategy))
    def test_strategies_agree_and_verify(self, dna, homolog, strategy):
        s0 = dna(500, seed=81)
        s1 = homolog(s0, seed=82)
        pcfg, cps = march_to_cps(s0, s1)
        reduced = mm.reduce_partitions(s0, s1, cps, P, max_partition=16,
                                       strategy=strategy)
        assert reduced[0] == cps[0] and reduced[-1] == cps[-1]
        for a, b in zip(reduced, reduced[1:]):
            assert max(b.i - a.i, b.j - a.j) <= 16 or b.i - a.i < 2
        # stage 5 over the reduced partitions must still verify
        aln = pipeline.stage5_emit(s0, s1, pcfg, reduced)
        stage6.recheck(aln, s0, s1, P)
        ref = oracle.dp_rows(s0, s1, P)
        assert aln.raw_score == ref.best

    def test_differential(self, dna, homolog):
        s0 = dna(400, seed=83)
        s1 = homolog(s0, seed=84, indel_rate=0.12)
        _, cps = march_to_cps(s0, s1)
        results = [
            mm.reduce_partitions(s0, s1, cps, P, 16, strat)
            for strat in mm.SplitStrategy
        ]
        assert results[0] == results[1] == results[2]

    def test_gap_heavy(self, dna):
        # long internal deletion forces gapped crosspoints through splits
        s0 = dna(400, seed=85)
        s1 = np.concatenate([s0[:150], s0[290:]])
        pcfg, cps = march_to_cps(s0, s1,
                                 AlignmentStart.SEQUENCE_1_AND_2)
        reduced = mm.reduce_partitions(s0, s1, cps, P, max_partition=16)
        aln = pipeline.stage5_emit(s0, s1, pcfg, reduced)
        stage6.recheck(aln, s0, s1, P)


def test_svg_blocks_heatmap():
    """--dump-blocks grid renders as a heatmap layer in the SVG
    (stage6 drawPruningArea analogue)."""
    import numpy as np

    from masa_tpu.biology.alignment import Alignment
    from masa_tpu.stages.svg import render_svg

    aln = Alignment(sequences=[])
    aln.start = (1, 1)
    aln.end = (10, 10)
    aln.raw_score = 10
    grid = np.zeros((4, 8), np.int32)
    grid[1, 2] = 50
    grid[2, :] = -999999999  # pruned row
    out = render_svg(aln, 10, 10, blocks=grid)
    assert out.count("<rect") >= 32  # 4x8 heatmap + frame
    assert "#d9d9d9" in out  # pruned cells gray


def test_stage6_histogram_format():
    """The format registry's histogram renderer: well-formed single-hue
    SVG with one bar per window and the score in the title."""
    import numpy as np

    from masa_tpu.ops import oracle
    from masa_tpu.stages import pipeline, stage6

    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, 400).astype(np.uint8)
    s1 = s0.copy()
    s1[::7] = bases[(np.arange(len(s1[::7])) % 4)]
    aln = pipeline.align_pair(s0, s1)
    out, ext = stage6.FORMATS["histogram"](aln, s0, s1)
    assert ext == "svg"
    assert out.startswith("<svg") and out.rstrip().endswith("</svg>")
    assert out.count('rx="1.5"') == 64          # one bar per bin
    assert f"score {aln.raw_score}" in out
    assert set(stage6.FORMATS) == {"text", "svg", "histogram"}


def test_halves_strips_engine_parity():
    """The per-half strip engine (tall stage-4 halves at the strip
    kernel's rate) must return bus-exact results vs the row-sweep
    ground truth — including reverse halves, pinned-gap borders, a
    width-0 (pure-gap) half, and buses narrower than the level njq."""
    from masa_tpu.ops import batched_mm as bmm

    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, 900).astype(np.uint8)
    s1 = rng.choice(bases, 800).astype(np.uint8)
    njq = 1024
    dev = bmm._DevSeqs(s0, s1, pad0=4096, pad1=njq + 4096)
    halves = [bmm._Half(0, 300, 0, 750, 1, 1),
              bmm._Half(100, 290, 30, 700, 0, 2),
              bmm._Half(40, 128, 200, 64, 2, 0),
              bmm._Half(10, 64, 500, 0, 1, 2)]   # w = 0: pure-gap pair
    for rev in (False, True):
        th, tf = bmm._halves_strips(dev, halves, rev, P, njq)
        sh, sf = bmm._halves_sweep(dev, halves, rev, P, njq)
        for k, x in enumerate(halves):
            w = x.w
            np.testing.assert_array_equal(
                np.asarray(th)[k, :w], np.asarray(sh)[k, :w],
                err_msg=f"half {k} rev={rev} H")
            np.testing.assert_array_equal(
                np.asarray(tf)[k, :w], np.asarray(sf)[k, :w],
                err_msg=f"half {k} rev={rev} F")


def test_partition_config_rung_cost_model(monkeypatch):
    """The per-partition strip follows the platform decision: on the
    CUDA route the tallest power of two <= the partition's rows (at
    least one full strip, whose interior rows can flush; the rest runs
    at its true height, call data to the kernel), capped at the
    full-height strip; the scan route keeps its one CPU strip.  The
    width never changes the choice."""
    from masa_tpu.stages import core
    from masa_tpu.utils import devices

    monkeypatch.setattr(devices, "kernel_route", lambda: "cuda")
    assert core.partition_config(700, 1 << 20).rows == 512
    assert core.partition_config(65536 + 300, 1 << 20).rows == 65536
    assert core.partition_config(131072, 1 << 20).rows == 131072
    assert core.partition_config(1 << 22, 1 << 20).rows == 1 << 19
    assert core.partition_config(1, 7).rows == 512
    for rows in (1, 700, 131072, 1 << 22):
        cfg = core.partition_config(rows, 1 << 20)
        assert cfg == core.partition_config(rows, 64)
        assert cfg.alpha == 4 and cfg.rows % (cfg.alpha * 128) == 0
    assert core.default_config().rows == 1 << 19

    monkeypatch.setattr(devices, "kernel_route", lambda: "scan")
    assert core.partition_config(131072, 1 << 20) is core._SCAN_CFG
    assert core.default_config() is core._SCAN_CFG


def test_stage1_plan_traceback_aware(monkeypatch):
    """Stage-1 planning: the special-row spacing is the SRA budget's
    interval (m*n*8/limit + 1, the reference's rule) snapped to what the
    strip kernel can flush — a power-of-two multiple of alpha*128 inside
    the strip, or whole strips."""
    from masa_tpu.ops.strips import snap_special_interval
    from masa_tpu.stages import core
    from masa_tpu.utils import devices

    monkeypatch.setattr(devices, "kernel_route", lambda: "cuda")
    m = n = 1 << 20
    cfg, spacing = core.stage1_plan(m, n, 17 << 30)
    assert cfg.rows == 1 << 19
    assert spacing == 512           # iv = 483, snapped to the 512 grain
    assert snap_special_interval(spacing, cfg) == spacing

    cfg, spacing = core.stage1_plan(5_000_000, 5_000_000, 17 << 30)
    iv = 5_000_000 * 5_000_000 * 8 // (17 << 30) + 1
    assert spacing >= iv and spacing == 16384
    assert cfg.rows % spacing == 0

    # the budget forces sparse rows: whole strips
    cfg, spacing = core.stage1_plan(23_000_000, 25_000_000, 1 << 30)
    iv = 23_000_000 * 25_000_000 * 8 // (1 << 30) + 1
    assert spacing >= iv and spacing % cfg.rows == 0

    # the scan route: the CPU strip, spacing in whole strips
    monkeypatch.setattr(devices, "kernel_route", lambda: "scan")
    cfg, spacing = core.stage1_plan(m, n)
    assert cfg is core._SCAN_CFG
    assert spacing % cfg.rows == 0 and spacing >= 483
