"""SRA store: proportional RAM/disk placement, border-type metadata,
crash-visibility semantics, and in-process instance caching.

Reference anchors: sra/SpecialRowsPartition.cpp:316-333 (proportional
counters), :129-175 (border types encoded per file), Job.cpp:202-211
(the job owns its areas).
"""

import numpy as np

from masa_tpu.core.sra import SpecialRowsArea, SpecialRowsPartition
from masa_tpu.types import InitType


def rows_of(n, k, base=0):
    h = np.arange(n, dtype=np.int64) + base
    f = -h - 1
    return h, f


def sizes(tmp_path, n):
    """(ram_bytes, disk_bytes) actually charged for one n-cell row."""
    p = SpecialRowsPartition(str(tmp_path / "probe"), 0, 0, 10, n,
                             ram_limit=1 << 30, disk_limit=0)
    p.put(1, *rows_of(n, 0))
    ram = p._ram_bytes
    p2 = SpecialRowsPartition(str(tmp_path / "probe2"), 0, 0, 10, n,
                              ram_limit=0, disk_limit=1 << 30)
    p2.put(1, *rows_of(n, 0))
    return ram, p2._disk_bytes


class TestPlacement:
    def test_equal_budgets_split_evenly(self, tmp_path):
        """Equal budgets (in each store's own row size): placement keeps
        usage proportional, so 8 rows land 4/4."""
        n = 100
        ram_sz, disk_sz = sizes(tmp_path, n)
        p = SpecialRowsPartition(str(tmp_path / "p"), 0, 0, 10_000, n,
                                 ram_limit=ram_sz * 4,
                                 disk_limit=disk_sz * 4)
        for k in range(8):
            p.put((k + 1) * 10, *rows_of(n, k))
        assert len(p._ram) == 4 and len(p._disk) == 4
        # every row readable regardless of placement
        for k in range(8):
            h, f = p.get((k + 1) * 10)
            assert h[0] == 0 and len(h) == n

    def test_budget_ratio_drives_placement(self, tmp_path):
        """1:3 RAM:disk budget => 1/4 of rows in RAM (the reference's
        proportional counters)."""
        n = 64
        ram_sz, disk_sz = sizes(tmp_path, n)
        p = SpecialRowsPartition(str(tmp_path / "p"), 0, 0, 10_000, n,
                                 ram_limit=ram_sz * 3,
                                 disk_limit=disk_sz * 9)
        for k in range(12):
            p.put((k + 1) * 10, *rows_of(n, k))
        assert len(p._ram) == 3 and len(p._disk) == 9

    def test_dominant_disk_budget_prefers_disk(self, tmp_path):
        """A disk budget far larger than RAM keeps the disk fraction
        lower, so rows stream to disk (persistence-heavy config)."""
        n = 64
        ram_sz, disk_sz = sizes(tmp_path, n)
        p = SpecialRowsPartition(str(tmp_path / "p"), 0, 0, 10_000, n,
                                 ram_limit=ram_sz * 2,
                                 disk_limit=disk_sz * 100)
        for k in range(10):
            p.put((k + 1) * 10, *rows_of(n, k))
        assert len(p._disk) >= 9

    def test_crash_semantics_disk_only_visible(self, tmp_path):
        """A fresh instance (the restarted process) sees only the disk
        rows; last_row() is the resume point."""
        n = 32
        ram_sz, disk_sz = sizes(tmp_path, n)
        p = SpecialRowsPartition(str(tmp_path / "p"), 0, 0, 10_000, n,
                                 ram_limit=ram_sz * 2,
                                 disk_limit=disk_sz * 2)
        for k in range(4):
            p.put((k + 1) * 10, *rows_of(n, k))
        assert p._disk, "expected at least one disk row"
        fresh = SpecialRowsPartition(str(tmp_path / "p"), 0, 0, 10_000, n,
                                     ram_limit=ram_sz * 2,
                                     disk_limit=disk_sz * 2)
        assert set(fresh.rows()) == set(p._disk)
        assert fresh.last_row() == max(p._disk)


class TestAreaCache:
    def test_partition_instances_cached(self, tmp_path):
        """open_partition must return the SAME instance so RAM rows stay
        reachable across stage boundaries within the process."""
        area = SpecialRowsArea(str(tmp_path / "a"), ram_limit=1 << 20,
                               disk_limit=1 << 20)
        part = area.create_partition(0, 0, 1000, 500)
        part.put(100, *rows_of(501, 0))
        again = area.open_partition(50, 50)
        assert again is part
        assert 100 in again.rows()

    def test_border_type_metadata_roundtrip(self, tmp_path):
        area = SpecialRowsArea(str(tmp_path / "a"))
        area.create_partition(
            0, 0, 1000, 500,
            row_init=InitType.WITH_GAPS, col_init=InitType.WITH_ZEROES)
        # a fresh area (restarted process) recovers the border types
        area2 = SpecialRowsArea(str(tmp_path / "a"))
        p = area2.open_partition(10, 10)
        assert InitType(p.row_init) == InitType.WITH_GAPS
        assert InitType(p.col_init) == InitType.WITH_ZEROES


class _FakePull:
    """RowPull stand-in: host arrays masquerading as device snapshots
    (RowPull itself only needs .nj and jnp-compatible buffers)."""

    def __init__(self, h, f):
        import jax.numpy as jnp

        self.nj = len(h)
        self._h = jnp.asarray(np.asarray(h, np.int32))
        self._f = jnp.asarray(np.asarray(f, np.int32))
        self.started = False

    def start(self):
        self.started = True
        return self

    def ready(self):
        return self.started

    def rows(self):
        from masa_tpu.ops import wavefront as wf

        self.start()
        return (wf.pull_row_delta(self._h, self.nj),
                wf.pull_row_delta(self._f, self.nj))

    def packed(self):
        from masa_tpu.ops import wavefront as wf

        self.start()
        return (wf.packed_row_host(
                    (wf.delta_pack_device(self._h, self.nj), self._h,
                     self.nj)),
                wf.packed_row_host(
                    (wf.delta_pack_device(self._f, self.nj), self._f,
                     self.nj)))

    def anchors(self, stride):
        idx = np.arange(0, self.nj, stride)
        return (np.asarray(self._h)[idx].astype(np.int64),
                np.asarray(self._f)[idx].astype(np.int64))


def _lazy_row(n, base=0, spike=None):
    from masa_tpu.core.manager import LazyFullRow

    h, f = rows_of(n, 0, base)
    # DP-like small deltas with optional large escape jumps
    h = (h % 5).cumsum()
    f = -((f % 3)).cumsum() - 7
    if spike is not None:
        h[spike] += 100000       # forces 4-bit escapes
        f[spike] -= 99999
    return LazyFullRow(_FakePull(h, f), border_h=int(-3), border_f=-777), h, f


class TestLazyRows:
    def test_packed_roundtrip_with_escapes(self, tmp_path):
        from masa_tpu.core.sra import read_row, write_row_packed

        lazy, h, f = _lazy_row(1001, base=5, spike=[3, 500, 1000])
        write_row_packed(str(tmp_path), 7, lazy)
        rh, rf = read_row(str(tmp_path), 7)
        assert rh[0] == -3 and rf[0] == -777
        np.testing.assert_array_equal(rh[1:], h)
        np.testing.assert_array_equal(rf[1:], f)

    def test_window_read_matches_full(self, tmp_path):
        """read_row_window (anchored partial decode) == read_row slices,
        across windows that cross anchors and escapes."""
        import masa_tpu.core.sra as sra
        from masa_tpu.core.sra import (read_row, read_row_window,
                                       write_row_packed)

        n = 200_000    # > 3 anchor strides (ANCHOR_STRIDE = 65536)
        lazy, h, f = _lazy_row(n, base=11,
                               spike=[3, 65535, 65536, 150001, n - 1])
        write_row_packed(str(tmp_path), 9, lazy)
        fh, ff = read_row(str(tmp_path), 9)
        for lo, hi in [(0, 64), (1, 64), (65530, 65700), (65536, 65537),
                       (123456, 131073), (149999, 150050),
                       (n - 10, n + 1), (0, n + 1), (70000, 70000)]:
            wh, wf_ = read_row_window(str(tmp_path), 9, lo, hi)
            np.testing.assert_array_equal(wh, fh[lo:hi])
            np.testing.assert_array_equal(wf_, ff[lo:hi])

    def test_partition_get_window_all_placements(self, tmp_path):
        """get_window agrees with get() slices for RAM-tuple, lazy-RAM,
        pending and disk rows."""
        import masa_tpu.core.sra as sra

        d = str(tmp_path / "p")
        p = SpecialRowsPartition(d, 0, 0, 100, 4096,
                                 ram_limit=1 << 30, disk_limit=1 << 30)
        p.put(10, *rows_of(600, 0))                 # RAM tuple
        lazy, _, _ = _lazy_row(600, base=3)
        p._ram[20] = lazy                           # lazy RAM row
        p._ram_bytes += 8 * lazy.count + 20
        lazy2, _, _ = _lazy_row(600, base=5, spike=[7])
        p._disk_bytes += sra.write_row_packed(d, 30, lazy2)  # disk
        p._disk.add(30)
        wins = [(0, 5), (1, 10), (250, 601), (598, 601)]
        for r in (10, 20, 30):
            got = [p.get_window(r, lo, hi) for lo, hi in wins]
            fh, ff = p.get(r)      # AFTER windows: the lazy branch runs
            for (lo, hi), (wh, wf_) in zip(wins, got):
                np.testing.assert_array_equal(wh, fh[lo:hi])
                np.testing.assert_array_equal(wf_, ff[lo:hi])

    def test_ram_lazy_never_transfers_until_read(self, tmp_path):
        p = SpecialRowsPartition(str(tmp_path / "p"), 0, 0, 10, 4096,
                                 ram_limit=1 << 30, disk_limit=0)
        lazy, h, f = _lazy_row(512)
        p.put_lazy(3, lazy)
        assert not lazy.pull.started          # no device-to-host copy
        assert p.rows() == [3]
        rh, rf = p.get(3)
        assert lazy.pull.started
        np.testing.assert_array_equal(rh[1:], h)
        rh2, _ = p.get(3)                     # materialized + cached
        np.testing.assert_array_equal(rh2, rh)

    def test_disk_lazy_persists_packed_and_resumes(self, tmp_path):
        d = str(tmp_path / "p")
        p = SpecialRowsPartition(d, 0, 0, 10, 4096,
                                 ram_limit=0, disk_limit=1 << 30)
        lazy, h, f = _lazy_row(512, spike=[100])
        p.put_lazy(4, lazy)
        assert lazy.pull.started              # async transfer began
        p.finalize()
        assert p.last_row() == 4
        # crash-resume view: a fresh instance reads the packed file
        p2 = SpecialRowsPartition(d, 0, 0, 10, 4096,
                                  ram_limit=0, disk_limit=1 << 30)
        rh, rf = p2.get(4)
        assert rh[0] == -3 and rf[0] == -777
        np.testing.assert_array_equal(rh[1:], h)
        np.testing.assert_array_equal(rf[1:], f)

    def test_truncate_drops_lazy_rows(self, tmp_path):
        p = SpecialRowsPartition(str(tmp_path / "p"), 0, 0, 10, 4096,
                                 ram_limit=1 << 30, disk_limit=0)
        for r in (2, 4, 6):
            lazy, _, _ = _lazy_row(256, base=r)
            p.put_lazy(r, lazy)
        before = p._ram_bytes
        p.truncate_above(4)
        assert p.rows() == [2, 4]
        assert p._ram_bytes == before * 2 // 3

    def test_truncate_refunds_pending_disk_budget(self, tmp_path):
        """Dropping a still-in-flight disk-destined lazy row must refund
        its _pending_bytes charge, or the disk budget stays permanently
        oversubscribed and later rows get dropped."""
        from masa_tpu.core.manager import LazyFullRow

        p = SpecialRowsPartition(str(tmp_path / "p"), 0, 0, 10, 4096,
                                 ram_limit=0, disk_limit=1 << 30)

        class _StuckPull(_FakePull):
            def ready(self):
                return False          # transfer never completes

        for r in (2, 4, 6):
            h, f = rows_of(256, 0, r)
            lazy = LazyFullRow(_StuckPull(h, f), border_h=0, border_f=-1)
            p.put_lazy(r, lazy)
        assert len(p._pending) == 3 and p._pending_bytes > 0
        per_row = p._pending_bytes // 3
        p.truncate_above(4)
        assert [r for r, _ in p._pending] == [2, 4]
        assert p._pending_bytes == 2 * per_row
        p.truncate_above(0)
        assert p._pending == [] and p._pending_bytes == 0
