"""The aligner extension contract and its two implementations.

Mirrors the reference's portability architecture: IAligner
(libmasa/IAligner.hpp:149-387) is what an extension implements; the
manager (core/manager.py) drives it.  Like MASA's CUDAlign/OpenMP/...
extensions, two engines implement the contract here:

  * KernelAligner — the wavefront strip kernel: CUDA on a GPU, the
    lax.scan twin on the CPU (the CUDAligner analogue,
    src/CUDAligner.cpp).
  * CPUAligner — the NumPy oracle (the CPUBlockProcessor analogue,
    processors/CPUBlockProcessor.cpp:113-174), the differential baseline.
"""

from __future__ import annotations

import abc
import dataclasses

import numpy as np

from masa_tpu.core.capabilities import AlignerCapabilities
from masa_tpu.models.scoring import match_column
from masa_tpu.ops import oracle, strips
from masa_tpu.ops import wavefront as wf
from masa_tpu.types import MatchResult, Partition


@dataclasses.dataclass
class AlignerStats:
    cells: int = 0
    pruned_cells: int = 0
    partitions: int = 0


class Aligner(abc.ABC):
    """The IAligner life-cycle: initialize -> set_sequences ->
    align_partition* -> unset_sequences -> finalize."""

    def __init__(self):
        self.manager = None
        self.stats = AlignerStats()
        self._seq0 = None
        self._seq1 = None

    @abc.abstractmethod
    def get_capabilities(self) -> AlignerCapabilities: ...

    def set_manager(self, manager) -> None:
        self.manager = manager

    def get_fork_weights(self, count: int) -> list[float]:
        """Per-fork slab weights (IAligner::getForkWeights): probed
        device throughputs when the mesh is heterogeneous, padded/cycled
        to `count` forks (cuda_util.cpp:191 getGPUWeights)."""
        from masa_tpu.utils.devices import device_weights

        w = device_weights(probe=True)
        return [w[k % len(w)] for k in range(count)]

    def initialize(self) -> None:
        pass

    def finalize(self) -> None:
        pass

    def set_sequences(self, seq0: np.ndarray, seq1: np.ndarray) -> None:
        self._seq0 = np.asarray(seq0, np.uint8)
        self._seq1 = np.asarray(seq1, np.uint8)

    def unset_sequences(self) -> None:
        self._seq0 = self._seq1 = None

    @abc.abstractmethod
    def align_partition(self, partition: Partition) -> None:
        """Compute the partition, dispatching rows/columns/scores through
        the manager."""

    def match_last_column(self, rev_h, rev_g, fwd_h, fwd_g, goal: int
                          ) -> MatchResult:
        """The Myers-Miller matching fallback
        (AbstractAligner::matchLastColumn -> AlignerUtils::matchColumn)."""
        return match_column(rev_h, rev_g, fwd_h, fwd_g, goal,
                            self.manager.params.gap_open)

    def clear_statistics(self) -> None:
        self.stats = AlignerStats()


def dev_pads(n1: int) -> tuple[int, int]:
    """The (pad0, pad1) sentinel paddings KernelAligner uses for its
    device-resident sequence views — shared with the reverse-march
    seeding so flipped views land on the exact cache keys the aligner
    will look up."""
    return 131072 + 8, n1 // 8 + 32768 + 512


class KernelAligner(Aligner):
    """The wavefront extension: strip kernel of the platform's route
    (utils.devices.kernel_route — CUDA on a GPU, scan twin on CPU)."""

    def __init__(self, cfg: wf.WavefrontConfig | None = None,
                 route: str | None = None):
        super().__init__()
        from masa_tpu.stages.core import default_config
        from masa_tpu.utils.devices import kernel_route

        self.cfg = cfg or default_config()
        self.route = route or kernel_route()

    def get_capabilities(self) -> AlignerCapabilities:
        return AlignerCapabilities()

    def align_partition(self, partition: Partition) -> None:
        mgr = self.manager
        p = partition
        sub0 = self._seq0[p.i0 : p.i1]
        sub1 = self._seq1[p.j0 : p.j1]
        cfg = dataclasses.replace(
            self.cfg,
            recurrence=mgr.recurrence,
            track_best=mgr.must_dispatch_scores(),
            store_lastcol=mgr.must_dispatch_last_column(),
            match=mgr.params.match,
            mismatch=mgr.params.mismatch,
            gap_open=mgr.params.gap_open,
            gap_ext=mgr.params.gap_ext,
        )
        iv = mgr.get_special_row_interval()
        if iv:
            # the kernels flush interior rows mid-strip at alpha*128
            # granularity
            iv = strips.snap_special_interval(iv, cfg)

        def on_row(r, bus_h, bus_f):
            mgr.dispatch_row(p.i0 + r, bus_h, bus_f)

        on_row_dev = None
        if mgr.special_dev_sink is not None:
            on_row_dev = lambda r, dh, df: mgr.dispatch_row_dev(
                p.i0 + r, dh, df)
        on_row_lazy = None
        if mgr.lazy_special_rows:
            on_row_lazy = lambda r, pull: mgr.dispatch_row_lazy(
                p.i0 + r, pull)

        def stop(out, rows_done, strip_rows, col_off):
            if cfg.track_best and "best_v" in out:
                s, bi, bj = wf.resolve_best(out["best_v"], out["best_j"])
                strip_top = rows_done - strip_rows
                mgr.dispatch_score(p.i0 + strip_top + bi + 1,
                                   p.j0 + col_off + bj + 1, s)
            return not mgr.must_continue()

        # Per-strip score dispatch when the manager wants every candidate
        # (multi-alignment collection), or for the mid-flight goal stop
        # (stopAligner, AlignerManager.cpp:364) on partitions tall enough
        # that halting early can win back the per-strip host sync the
        # callback costs (the fused-dispatch fast path is disabled when a
        # stop consumer exists).
        goal_stop = (mgr.goal_score is not None and cfg.track_best
                     and p.height >= 8 * cfg.rows)
        if not (mgr.want_all_scores or goal_stop):
            stop = None

        blocks = None
        if mgr.blocks_sink is not None:
            blocks = lambda rows_done, maxima: mgr.dispatch_block_scores(
                p.i0 + rows_done, maxima)

        # device-resident sequences: uploaded once (cached across
        # partitions/hops), sliced on-device per strip — run_partition
        # falls back to the host data path when borders are CUSTOM.
        # Uploads must amortize: take them when cached already, or when
        # the partition spans enough full strips
        dev_slices = None
        pad0, pad1 = dev_pads(len(self._seq1))
        cached = (
            wf.dev_seq_peek(self._seq0, wf.A_SENTINEL, pad0) is not None
            and wf.dev_seq_peek(self._seq1, wf.B_SENTINEL, pad1)
            is not None)
        if cached or p.height >= 4 * cfg.rows:
            s0x = wf.dev_seq(self._seq0, wf.A_SENTINEL, pad0)
            s1x = wf.dev_seq(self._seq1, wf.B_SENTINEL, pad1)
            dev_slices = (s0x, p.i0, s1x, p.j0)

        # device-resident goal matching: the cut stays on device, so the
        # reverse pass's last row must too (no O(n) pull per hop)
        dev_match = mgr.goal_base_dev is not None

        res = strips.run_partition(
            cfg, sub0, sub1, mgr.params,
            mgr.get_first_row_init_type(), mgr.get_first_column_init_type(),
            first_row=mgr.receive_first_row(),
            first_col=mgr.receive_first_column(),
            route=self.route,
            special_every=iv,
            on_special_row=on_row if iv else None,
            stop_check=stop,
            prune=mgr.must_prune_blocks(),
            pad_rows=mgr.pad_rows,
            blocks_sink=blocks,
            want_last_row=mgr.must_dispatch_last_row() and not dev_match,
            dev_slices=dev_slices,
            on_special_row_dev=on_row_dev if iv else None,
            want_dev_last=dev_match,
            on_special_row_lazy=on_row_lazy if iv else None,
        )
        self.stats.cells += res.cells
        self.stats.pruned_cells += res.pruned_cells
        self.stats.partitions += 1
        if dev_match and res.dev_last is not None:
            mgr.dispatch_last_row_device(p.i1, res.dev_last[0],
                                         res.dev_last[1])
        if res.last_h is not None:
            mgr.dispatch_last_row(p.i1, res.last_h, res.last_f)
        if cfg.store_lastcol:
            mgr.dispatch_last_column(p.j1, res.col_h, res.col_e)
        if cfg.track_best:
            mgr.dispatch_score(p.i0 + res.best_i, p.j0 + res.best_j,
                               res.best)


class CPUAligner(Aligner):
    """Scalar oracle extension — the differential baseline."""

    def get_capabilities(self) -> AlignerCapabilities:
        caps = AlignerCapabilities()
        caps.block_pruning = False
        caps.maximum_seq0_len = 1 << 20
        caps.maximum_seq1_len = 1 << 20
        return caps

    def align_partition(self, partition: Partition) -> None:
        from masa_tpu.types import Recurrence

        mgr = self.manager
        p = partition
        sub0 = self._seq0[p.i0 : p.i1]
        sub1 = self._seq1[p.j0 : p.j1]
        iv = mgr.get_special_row_interval()
        rows = tuple(range(iv, p.height + 1, iv)) if iv else ()
        res = oracle.dp_rows(
            sub0, sub1, mgr.params, mgr.recurrence,
            mgr.get_first_row_init_type(), mgr.get_first_column_init_type(),
            first_row=mgr.receive_first_row(),
            first_col=mgr.receive_first_column(),
            special_rows=rows,
            row_bests=mgr.want_all_scores,
        )
        self.stats.cells += p.height * p.width
        self.stats.partitions += 1
        for r in sorted(res.specials):
            h, f = res.specials[r]
            mgr.dispatch_row(p.i0 + r, h[1:], f[1:])
        if mgr.blocks_sink is not None:
            # block maxima from the special rows (the kernel path dumps
            # per-strip chunk maxima; this is the viz analogue)
            n = p.width
            cw = max(1, n // 64)
            ngb = -(-n // cw)
            for r in sorted(res.specials):
                h = np.asarray(res.specials[r][0][1:], np.int64)
                padv = np.full(ngb * cw, h.min(), np.int64)
                padv[:n] = h
                mgr.dispatch_block_scores(
                    p.i0 + r, padv.reshape(ngb, cw).max(axis=1))
        if mgr.must_dispatch_last_row():
            mgr.dispatch_last_row(p.i1, res.last_h, res.last_f)
        if mgr.must_dispatch_last_column():
            mgr.dispatch_last_column(p.j1, res.col_h, res.col_e)
        if mgr.must_dispatch_scores():
            if mgr.want_all_scores and res.row_best_val is not None:
                for i in range(p.height):
                    mgr.dispatch_score(p.i0 + i + 1,
                                       p.j0 + int(res.row_best_j[i]),
                                       int(res.row_best_val[i]))
            if mgr.recurrence == Recurrence.NEEDLEMAN_WUNSCH:
                # dp_rows' SW-style running best is wrong for NW values;
                # recompute densely (the reverse-pass start search)
                dres = oracle.dp_matrix(
                    sub0, sub1, mgr.params, mgr.recurrence,
                    mgr.get_first_row_init_type(),
                    mgr.get_first_column_init_type(),
                    first_row=mgr.receive_first_row(),
                    first_col=mgr.receive_first_column(),
                )
                b, bi, bj = dres.best()
                mgr.dispatch_score(p.i0 + bi, p.j0 + bj, b)
            else:
                mgr.dispatch_score(p.i0 + res.best_i, p.j0 + res.best_j,
                                   res.best)
