"""Wavefront strip parity: the lax.scan twin and the strip dispatcher vs
the NumPy oracle, and run_partition's fused/two-phase/sub-strip paths on
the scan route.  (The CUDA kernel itself is checked against the scan twin
on the card: chip_smoke.py phase 2 and the gpu-marked tests.)"""

import numpy as np
import pytest

from masa_tpu.ops import oracle, strips
from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.types import INF, InitType, Recurrence, ScoreParams

P = ScoreParams()
CFG = WavefrontConfig(alpha=4, rs=1, chunk=256, track_best=True,
                      store_lastcol=True)


def canon(a):
    a = np.asarray(a, dtype=np.int64)
    return np.where(a <= -INF // 2, -INF, a)


def check_partition(s0, s1, cfg, rec, init_r, init_c, route="scan",
                    first_row=None, first_col=None, special_every=0):
    import dataclasses

    res = strips.run_partition(
        dataclasses.replace(cfg, recurrence=rec),
        s0, s1, P, init_r, init_c,
        first_row=first_row, first_col=first_col,
        route=route, special_every=special_every,
    )
    ref = oracle.dp_rows(
        s0, s1, P, rec, init_r, init_c,
        first_row=first_row, first_col=first_col,
        special_rows=tuple(res.specials.keys()),
    )
    assert np.array_equal(canon(res.last_h), canon(ref.last_h)), "last H"
    assert np.array_equal(canon(res.last_f), canon(ref.last_f)), "last F"
    if cfg.store_lastcol:
        assert np.array_equal(canon(res.col_h), canon(ref.col_h)), "col H"
        assert np.array_equal(canon(res.col_e), canon(ref.col_e)), "col E"
    if rec == Recurrence.SMITH_WATERMAN and cfg.track_best:
        assert res.best == ref.best
        assert (res.best_i, res.best_j) == (ref.best_i, ref.best_j)
    for r, (sh, sf) in res.specials.items():
        eh, ef = ref.specials[r]
        assert np.array_equal(canon(sh), canon(eh[1:])), f"special H {r}"
        assert np.array_equal(canon(sf), canon(ef[1:])), f"special F {r}"
    return res


class TestScanVsOracle:
    def test_sw_multi_strip_with_partial(self, dna, homolog):
        # R=512: two full strips + a partial strip of 176 rows
        s0 = dna(1200, seed=21)
        s1 = homolog(s0, seed=22)
        check_partition(s0, s1, CFG, Recurrence.SMITH_WATERMAN,
                        InitType.WITH_ZEROES, InitType.WITH_ZEROES,
                        special_every=512)

    def test_sw_single_partial_strip(self, dna, homolog):
        s0 = dna(300, seed=23)
        s1 = homolog(s0, seed=24)
        check_partition(s0, s1, CFG, Recurrence.SMITH_WATERMAN,
                        InitType.WITH_ZEROES, InitType.WITH_ZEROES)

    def test_nw_gaps_init(self, dna, homolog):
        s0 = dna(700, seed=25)
        s1 = homolog(s0, seed=26)
        check_partition(s0, s1, CFG, Recurrence.NEEDLEMAN_WUNSCH,
                        InitType.WITH_GAPS, InitType.WITH_GAPS)

    def test_nw_gaps_opened(self, dna, homolog):
        s0 = dna(520, seed=27)
        s1 = homolog(s0, seed=28)
        check_partition(s0, s1, CFG, Recurrence.NEEDLEMAN_WUNSCH,
                        InitType.WITH_GAPS_OPENED, InitType.WITH_GAPS)

    def test_narrow_matrix(self, dna, homolog):
        # nj < lanes exercises the rampdown-overlapping-rampup path
        s0 = dna(600, seed=29)
        s1 = dna(70, seed=30)
        check_partition(s0, s1, CFG, Recurrence.SMITH_WATERMAN,
                        InitType.WITH_ZEROES, InitType.WITH_ZEROES)

    def test_mid_rung_shape_parity(self, dna, homolog):
        """A wide lane layout (alpha=8, rs=32: sublane carries across 32
        rows of 128 lanes) through the scan twin: its packing/shift math
        gets a direct oracle check."""
        import dataclasses

        s0 = dna(800, seed=61)
        s1 = homolog(s0, seed=62)
        cfg = dataclasses.replace(
            WavefrontConfig(alpha=8, rs=32, chunk=8192),
            track_best=True, store_lastcol=False)
        check_partition(s0, s1, cfg, Recurrence.SMITH_WATERMAN,
                        InitType.WITH_ZEROES, InitType.WITH_ZEROES)
        check_partition(s0, s1, cfg, Recurrence.NEEDLEMAN_WUNSCH,
                        InitType.WITH_GAPS, InitType.WITH_GAPS)

    def test_custom_borders_glue(self, dna, homolog):
        """Kernel-computed bottom band glued onto an oracle top band must
        equal the monolithic oracle (the stage/multichip contract)."""
        from masa_tpu.models.scoring import border_cells

        s0 = dna(900, seed=31)
        s1 = homolog(s0, seed=32)
        mi = 300
        m = len(s0)
        full = oracle.dp_rows(
            s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
            InitType.WITH_GAPS, InitType.WITH_GAPS,
        )
        top = oracle.dp_rows(
            s0[:mi], s1, P, Recurrence.NEEDLEMAN_WUNSCH,
            InitType.WITH_GAPS, InitType.WITH_GAPS,
        )
        colh, cole = border_cells(m - mi + 1, InitType.WITH_GAPS, P,
                                  start=mi)
        res = check_partition(
            s0[mi:], s1, CFG, Recurrence.NEEDLEMAN_WUNSCH,
            InitType.CUSTOM, InitType.CUSTOM,
            first_row=(top.last_h, top.last_f),
            first_col=(colh, cole),
        )
        assert np.array_equal(canon(res.last_h), canon(full.last_h))


class TestStripDispatcher:
    """wf.strip on the scan route: row-major operands, per-row best
    captures, true-height masking, max-only tracking."""

    def _run(self, dna, homolog, cfg, m, nj, h_true, seed):
        import jax.numpy as jnp

        from masa_tpu.ops import wavefront as wf

        s0 = dna(m, seed=seed)
        s1 = homolog(s0, seed=seed + 1)[:nj]
        nj = len(s1)
        R = cfg.rows
        a = wf.rows_vec(cfg, s0[:h_true], wf.A_SENTINEL)
        b = np.full(nj + 64, wf.B_SENTINEL, np.int32)
        b[:nj] = s1
        bus_h = np.zeros(nj + 64, np.int32)
        bus_f = np.full(nj + 64, -INF, np.int32)
        out = wf.strip(cfg, "scan", jnp.asarray(a), jnp.asarray(b),
                       jnp.asarray(bus_h), jnp.asarray(bus_f),
                       jnp.zeros(R, jnp.int32),
                       jnp.full(R, -INF, jnp.int32), jnp.int32(0),
                       nj=nj, h_true=h_true)
        ref = oracle.dp_rows(s0[:h_true], s1, P, row_bests=True)
        return out, ref, nj

    @pytest.mark.parametrize("h_true", [512, 300, 1])
    def test_per_row_best_and_height(self, dna, homolog, h_true):
        cfg = WavefrontConfig(alpha=4, rs=1, chunk=256, track_best=True,
                              store_lastcol=True)
        out, ref, nj = self._run(dna, homolog, cfg, 600, 280, h_true, 91)
        bv = np.asarray(out["best_v"])
        bj = np.asarray(out["best_j"])
        assert bv.shape == bj.shape == (cfg.rows,)
        # rows past the true height hold no best
        assert (bv[h_true:] == -INF).all() and (bj[h_true:] == 0).all()
        np.testing.assert_array_equal(bv[:h_true], ref.row_best_val)
        np.testing.assert_array_equal(bj[:h_true] + 1, ref.row_best_j)
        bh = np.asarray(out["bus_h"])
        np.testing.assert_array_equal(bh[:nj], ref.last_h[1:])
        assert bh.shape == (nj + 64,) and (bh[nj:] == -INF).all()
        lc = np.asarray(out["lastcol_h"])
        np.testing.assert_array_equal(lc[:h_true], ref.col_h[1:])
        assert lc.shape == (cfg.rows,) and (lc[h_true:] == -INF).all()

    def test_width_and_height_are_call_data(self, dna, homolog):
        """One compiled strip serves every width and height that fits its
        buffers; each result equals the oracle, NEG past the width."""
        import jax.numpy as jnp

        from masa_tpu.ops import wavefront as wf

        cfg = WavefrontConfig(alpha=4, rs=1, chunk=256, track_best=True,
                              store_lastcol=True)
        R, W = cfg.rows, 384
        s0 = dna(R, seed=97)
        s1 = homolog(s0, seed=98)[:W]
        wf.strip.clear_cache()
        for nj, h in ((W, R), (200, 300), (1, 1), (383, 511)):
            b = np.full(W, wf.B_SENTINEL, np.int32)
            b[:nj] = s1[:nj]
            out = wf.strip(cfg, "scan", jnp.asarray(wf.rows_vec(
                cfg, s0[:h], wf.A_SENTINEL)), jnp.asarray(b),
                jnp.zeros(W, jnp.int32), jnp.full(W, -INF, jnp.int32),
                jnp.zeros(R, jnp.int32), jnp.full(R, -INF, jnp.int32),
                jnp.int32(0), nj=np.int32(nj), h_true=np.int32(h))
            ref = oracle.dp_rows(s0[:h], s1[:nj], P, row_bests=True)
            bh = np.asarray(out["bus_h"])
            np.testing.assert_array_equal(bh[:nj], ref.last_h[1:])
            assert (bh[nj:] == -INF).all()
            np.testing.assert_array_equal(
                np.asarray(out["lastcol_h"])[:h], ref.col_h[1:])
            np.testing.assert_array_equal(
                np.asarray(out["best_v"])[:h], ref.row_best_val)
        assert wf.strip._cache_size() == 1

    def test_max_only_tracking(self, dna, homolog):
        """track_pos=False (two-phase phase 1): per-row maxima only."""
        cfg = WavefrontConfig(alpha=4, rs=1, chunk=256, track_best=True,
                              track_pos=False)
        out, ref, _ = self._run(dna, homolog, cfg, 600, 250, 512, 93)
        assert "best_j" not in out
        assert int(np.asarray(out["best_v"]).max()) == ref.best

    def test_unknown_route_raises(self):
        import jax.numpy as jnp

        from masa_tpu.ops import wavefront as wf

        cfg = WavefrontConfig(alpha=4, rs=1, chunk=256)
        z = jnp.zeros(cfg.rows, jnp.int32)
        with pytest.raises(ValueError, match="route"):
            wf.strip(cfg, "mosaic", z, z, z, z, z, z, jnp.int32(0), nj=8,
                     h_true=8)

    def test_resolve_and_merge_best_agree(self):
        import jax.numpy as jnp

        from masa_tpu.ops import wavefront as wf

        bv = np.array([3, 7, 7, 1], np.int32)
        bj = np.array([5, 9, 2, 0], np.int32)
        assert wf.resolve_best(bv, bj) == (7, 1, 9)
        carry = (jnp.int32(6), jnp.int32(0), jnp.int32(0))
        s, i, j = (int(x) for x in wf.merge_best_device(
            carry, jnp.asarray(bv), jnp.asarray(bj), 100, 10))
        assert (s, i, j) == (7, 102, 20)
        # ties with the running best keep the earlier strip
        carry = (jnp.int32(7), jnp.int32(5), jnp.int32(5))
        assert tuple(int(x) for x in wf.merge_best_device(
            carry, jnp.asarray(bv), jnp.asarray(bj), 100, 10)) == (7, 5, 5)


def test_quantize_cols_buckets():
    """Bus buffer lengths (wf.padded_len): whole chunks, monotone, <=
    12.5% over the width beyond one chunk, few sizes per octave (bounds
    the number of compiled programs; the width itself is call data)."""
    from masa_tpu.ops import wavefront as wf

    cfg = WavefrontConfig(chunk=128)
    seen = set()
    prev = 0
    for nj in range(1, 300000, 997):
        q = wf.padded_len(cfg, nj)
        assert q >= nj and q % 128 == 0
        assert q <= max(nj * 1.125 + 128, 128)
        assert q >= prev
        prev = q
        seen.add(q)
    # ~8 buckets per octave over ~11 octaves
    assert len(seen) < 100


class TestBorderDiagonalSeed:
    """Regression: each strip's rows 2..alpha at DP column 1 read the left
    border through the scan state seed (lane 0 has no at_border step, and
    lane 1's first diagonal reads the seeded bottom-row chain).  The
    minimal reproducer is TG x GC under NW zeros borders: H(2,1) must be
    +1 (diag from border H(1,0)=0), not a gap path."""

    def test_minimal_tg_gc(self):
        import numpy as np

        from masa_tpu.ops import oracle, strips
        from masa_tpu.ops.wavefront import WavefrontConfig
        from masa_tpu.types import Recurrence, ScoreParams

        s0 = np.frombuffer(b"TG", np.uint8).copy()
        s1 = np.frombuffer(b"GC", np.uint8).copy()
        P = ScoreParams()
        for rec in (Recurrence.SMITH_WATERMAN,
                    Recurrence.NEEDLEMAN_WUNSCH):
            cfg = WavefrontConfig(
                alpha=4, rs=1, chunk=512, recurrence=rec,
                track_best=rec == Recurrence.SMITH_WATERMAN)
            ref = oracle.dp_rows(s0, s1, P, rec)
            got = strips.run_partition(cfg, s0, s1, P, route="scan")
            np.testing.assert_array_equal(got.last_h, ref.last_h)
            if rec == Recurrence.SMITH_WATERMAN:
                assert got.best == ref.best == 1

    def test_all_init_combos_small(self):
        import numpy as np

        from masa_tpu.ops import oracle, strips
        from masa_tpu.ops.wavefront import WavefrontConfig
        from masa_tpu.types import InitType, Recurrence, ScoreParams

        P = ScoreParams()
        bases = np.frombuffer(b"ACGT", np.uint8)
        for rec in (Recurrence.SMITH_WATERMAN,
                    Recurrence.NEEDLEMAN_WUNSCH):
            for ri in (0, 1, 2):
                for ci in (0, 1, 2):
                    rng = np.random.default_rng(ri * 3 + ci)
                    m = int(rng.integers(2, 40))
                    n = int(rng.integers(2, 40))
                    s0 = rng.choice(bases, m).astype(np.uint8)
                    s1 = rng.choice(bases, n).astype(np.uint8)
                    cfg = WavefrontConfig(
                        alpha=4, rs=1, chunk=512, recurrence=rec,
                        track_best=rec == Recurrence.SMITH_WATERMAN)
                    ref = oracle.dp_rows(s0, s1, P, rec, InitType(ri),
                                         InitType(ci))
                    got = strips.run_partition(
                        cfg, s0, s1, P, InitType(ri), InitType(ci),
                        route="scan")
                    np.testing.assert_array_equal(got.last_h, ref.last_h)


def test_strip_scan_dyn_matches_static():
    """Width and height are call data: one compiled scan twin serves
    arbitrary widths/heights under every init, each equal to the
    oracle."""
    import numpy as np

    from masa_tpu.models.scoring import border_cells
    from masa_tpu.ops import oracle
    from masa_tpu.ops import wavefront as wf
    from masa_tpu.types import InitType, Recurrence, ScoreParams

    P = ScoreParams()
    bases = np.frombuffer(b"ACGT", np.uint8)
    cfg = wf.WavefrontConfig(alpha=4, rs=1, chunk=512,
                             recurrence=Recurrence.NEEDLEMAN_WUNSCH,
                             track_best=False, store_lastcol=False)
    W = 512
    wf.strip_scan.clear_cache()
    for seed, (ri, ci) in enumerate([(1, 1), (2, 1), (1, 2)]):
        rng = np.random.default_rng(seed)
        m = int(rng.integers(2, cfg.rows))
        n = int(rng.integers(2, 300))
        s0 = rng.choice(bases, m).astype(np.uint8)
        s1 = rng.choice(bases, n).astype(np.uint8)
        ref = oracle.dp_rows(s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
                             InitType(ri), InitType(ci))
        b = np.full(W, wf.B_SENTINEL, np.int32)
        b[:n] = s1
        rh, _ = border_cells(n + 1, InitType(ri), P)
        bus_h = np.full(W, -wf.INF, np.int32)
        bus_f = np.full(W, -wf.INF, np.int32)
        bus_h[:n] = rh[1:]
        a = wf.pack_strip_rows(cfg, s0.astype(np.int32))
        ch, ce = border_cells(m, InitType(ci), P, start=1)
        ih, ie = wf.pack_border_cols(cfg, ch, ce)
        out = wf.strip_scan(cfg, a, b, bus_h, bus_f, ih, ie,
                            np.int32(rh[0]), np.int32(n), np.int32(m))
        np.testing.assert_array_equal(np.asarray(out["bus_h"])[:n],
                                      ref.last_h[1:])
        np.testing.assert_array_equal(np.asarray(out["bus_f"])[:n],
                                      ref.last_f[1:])
    assert wf.strip_scan._cache_size() == 1


def test_async_packed_special_pulls(dna, homolog, monkeypatch):
    """The deferred delta-packed special-row pulls must deliver exactly
    the rows the synchronous path produces (values, order, and the final
    row after the deferred queue drains)."""
    import numpy as np

    from masa_tpu.ops import oracle, strips
    from masa_tpu.ops.wavefront import WavefrontConfig
    from masa_tpu.types import InitType, ScoreParams

    P = ScoreParams()
    cfg = WavefrontConfig(alpha=4, rs=1, chunk=512, track_best=True,
                          store_lastcol=False)
    R = cfg.rows
    s0 = dna(4 * R + 100, seed=151)
    s1 = homolog(s0, seed=152)

    rows_async = []
    monkeypatch.setenv("MASA_TPU_FORCE_PACKED_PULL", "1")
    res = strips.run_partition(
        cfg, s0, s1, P, InitType.WITH_ZEROES, InitType.WITH_ZEROES,
        route="scan", special_every=R,
        on_special_row=lambda r, h, f: rows_async.append((r, h, f)),
    )
    monkeypatch.delenv("MASA_TPU_FORCE_PACKED_PULL")

    ref = oracle.dp_rows(s0, s1, P,
                         special_rows=tuple(r for r, _, _ in rows_async))
    assert [r for r, _, _ in rows_async] == sorted(ref.specials)
    for r, h, f in rows_async:
        np.testing.assert_array_equal(h, ref.specials[r][0][1:])
        np.testing.assert_array_equal(f, ref.specials[r][1][1:])
    assert res.best == ref.best


class TestMidStripFlush:
    """cfg.flush_every: interior special rows emitted from inside one
    strip (the decoupling of special-row spacing from strip height —
    the reference's any-cadence flush, CUDAligner.cu:502-540)."""

    def _inputs(self, dna, homolog, cfg, m, nj, rec, seed=71):
        from masa_tpu.models.scoring import border_cells
        from masa_tpu.ops import wavefront as wf

        s0 = dna(m, seed=seed)
        s1 = homolog(s0, seed=seed + 1)[:nj]
        nj = len(s1)
        plen = wf.padded_len(cfg, nj)
        b = np.full(plen, wf.B_SENTINEL, np.int32)
        b[:nj] = s1
        init = (InitType.WITH_ZEROES
                if rec == Recurrence.SMITH_WATERMAN
                else InitType.WITH_GAPS)
        rh, rf = border_cells(nj + 1, init, P)
        bus_h = np.full(plen, -INF, np.int32)
        bus_f = np.full(plen, -INF, np.int32)
        bus_h[:nj] = rh[1:]
        bus_f[:nj] = rf[1:]
        ch, ce = border_cells(cfg.rows, init, P, start=1)
        a = wf.pack_strip_rows(cfg, s0.astype(np.int32))
        ih, ie = wf.pack_border_cols(cfg, ch, ce)
        corner = int(border_cells(1, init, P)[0][0])
        ref = oracle.dp_rows(
            s0, s1, P, rec, init, init,
            special_rows=tuple(range(cfg.flush_every, cfg.rows,
                                     cfg.flush_every)))
        return s0, s1, nj, a, b, bus_h, bus_f, ih, ie, corner, ref

    def _check(self, out, ref, nj, cfg):
        rows_h = np.asarray(out["rows_h"])[:, :nj]
        rows_f = np.asarray(out["rows_f"])[:, :nj]
        n_int = cfg.rows // cfg.flush_every - 1
        assert rows_h.shape == (n_int, nj)
        for q in range(n_int):
            r = (q + 1) * cfg.flush_every
            np.testing.assert_array_equal(
                canon(rows_h[q]), canon(ref.specials[r][0][1:]),
                err_msg=f"interior H row {r}")
            np.testing.assert_array_equal(
                canon(rows_f[q]), canon(ref.specials[r][1][1:]),
                err_msg=f"interior F row {r}")
        # the boundary bus must be untouched by the capture rework
        bh = np.asarray(out["bus_h"])[:nj]
        np.testing.assert_array_equal(canon(bh), canon(ref.last_h[1:]))

    def test_scan_interior_rows_vs_oracle(self, dna, homolog):
        from masa_tpu.ops import wavefront as wf

        cfg = WavefrontConfig(alpha=4, rs=8, chunk=1024, track_best=True,
                              flush_every=1024)
        (s0, s1, nj, a, b, bus_h, bus_f, ih, ie, corner,
         ref) = self._inputs(dna, homolog, cfg, cfg.rows, 1500,
                             Recurrence.SMITH_WATERMAN)
        out = wf.strip_scan(cfg, a, b, bus_h, bus_f, ih, ie, corner,
                            nj=nj, h_true=cfg.rows)
        self._check(out, ref, nj, cfg)
        assert ref.best == int(np.asarray(out["best_v"]).max())

    def test_scan_interior_rows_nw(self, dna, homolog):
        from masa_tpu.ops import wavefront as wf

        cfg = WavefrontConfig(
            alpha=4, rs=8, chunk=1024, track_best=False,
            recurrence=Recurrence.NEEDLEMAN_WUNSCH, flush_every=512)
        (s0, s1, nj, a, b, bus_h, bus_f, ih, ie, corner,
         ref) = self._inputs(dna, homolog, cfg, cfg.rows, 1100,
                             Recurrence.NEEDLEMAN_WUNSCH, seed=73)
        out = wf.strip_scan(cfg, a, b, bus_h, bus_f, ih, ie, corner,
                            nj=nj, h_true=cfg.rows)
        self._check(out, ref, nj, cfg)


def test_snap_special_interval():
    from masa_tpu.ops.strips import snap_special_interval

    cfg = WavefrontConfig(alpha=32, rs=32, chunk=8192)  # R=131072
    # sub-strip: pow2 multiples of alpha*128 below R
    assert snap_special_interval(482, cfg) == 4096
    assert snap_special_interval(4097, cfg) == 8192
    assert snap_special_interval(32768, cfg) == 32768
    # k >= rs rounds to strips
    assert snap_special_interval(65537, cfg) == 131072
    assert snap_special_interval(131073, cfg) == 262144
    # the GPU full-height strip: the flush grain is 512 rows
    gcfg = WavefrontConfig(alpha=4, rs=1024, chunk=8192)  # R=524288
    assert snap_special_interval(483, gcfg) == 512
    assert snap_special_interval(11000, gcfg) == 16384
    # a one-sublane strip cannot flush mid-strip
    ccfg = WavefrontConfig(alpha=4, rs=1, chunk=512)
    assert snap_special_interval(100, ccfg) == 512


def test_run_partition_sub_strip_cadence(dna, homolog):
    """End-to-end sub-strip special rows through run_partition's fused
    path: interior + boundary rows from two full strips must match the
    oracle, with the tail partial strip contributing boundary rows only
    (consumers tolerate gaps)."""
    cfg = WavefrontConfig(alpha=4, rs=8, chunk=1024, track_best=True)
    R = cfg.rows  # 4096
    se = 1024
    s0 = dna(2 * R + 500, seed=81)
    s1 = homolog(s0, seed=82)[:1500]
    res = strips.run_partition(
        cfg, s0, s1, P, InitType.WITH_ZEROES, InitType.WITH_ZEROES,
        route="scan", special_every=se,
    )
    # all sub-strip rows of the two fused strips must be present
    fused_rows = [r for r in range(se, 2 * R + 1, se)]
    assert all(r in res.specials for r in fused_rows), \
        sorted(res.specials)
    ref = oracle.dp_rows(s0, s1, P,
                         special_rows=tuple(sorted(res.specials)))
    for r, (sh, sf) in sorted(res.specials.items()):
        np.testing.assert_array_equal(canon(sh),
                                      canon(ref.specials[r][0][1:]),
                                      err_msg=f"row {r} H")
        np.testing.assert_array_equal(canon(sf),
                                      canon(ref.specials[r][1][1:]),
                                      err_msg=f"row {r} F")
    assert res.best == ref.best
    assert (res.best_i, res.best_j) == (ref.best_i, ref.best_j)


def test_run_partition_two_phase_best(dna, homolog):
    """>= 16 full strips engage the two-phase best (max-only phase 1,
    replay of the winning strip from a checkpoint): the endpoint must
    equal the oracle's, tie-break included."""
    cfg = WavefrontConfig(alpha=4, rs=1, chunk=256, track_best=True)
    s0 = dna(16 * cfg.rows + 40, seed=95)
    s1 = homolog(s0, seed=96)[:300]
    res = strips.run_partition(cfg, s0, s1, P, route="scan",
                               want_last_row=False)
    ref = oracle.dp_rows(s0, s1, P)
    assert (res.best, res.best_i, res.best_j) == (
        ref.best, ref.best_i, ref.best_j)


@pytest.mark.parametrize("nj", [1, 2, 999, 1000])
def test_escape_scan_matches_nibble_unpack(nj):
    """The uint8 bit-test escape scan equals the full signed-nibble
    unpack it replaced, including an odd width's padding nibble."""
    from masa_tpu.ops import wavefront as wf

    rng = np.random.default_rng(nj)
    u = rng.integers(0, 256, (nj + 1) // 2).astype(np.uint8)
    lo = (u & 0xF).astype(np.int64)
    hi = (u >> 4).astype(np.int64)
    lo[lo > 7] -= 16
    hi[hi > 7] -= 16
    dh = np.empty(2 * len(u), np.int64)
    dh[0::2], dh[1::2] = lo, hi
    np.testing.assert_array_equal(wf._escapes(u, nj),
                                  np.nonzero(dh[:nj] == -8)[0])


def test_gather_host_and_row_of():
    import jax.numpy as jnp

    from masa_tpu.ops import wavefront as wf

    v = jnp.arange(100, dtype=jnp.int32) * 3
    for idx in ([], [7], [0, 5, 99], list(range(0, 100, 9))):
        got = wf._gather_host(v, np.asarray(idx, np.int64))
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, np.asarray(idx) * 3)
    rows = jnp.arange(12, dtype=jnp.int32).reshape(3, 4)
    for q in range(3):
        np.testing.assert_array_equal(wf.row_of(rows, jnp.int32(q)),
                                      np.asarray(rows)[q])
