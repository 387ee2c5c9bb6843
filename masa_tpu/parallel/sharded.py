"""Column-sharded multi-chip wavefront (the reference's multi-GPU mode).

The DP matrix is column-partitioned across a 1-D device mesh: device d owns
a vertical slab of seq1 (split_sequences, libmasa.cpp:497-535).  Strips
pipeline diagonally: in round r, device d computes strip ``r - d``; the
strip's last column (H, E) flows to device d+1 via ``ppermute`` (NVLink
between GPUs) — replacing the reference's socket cell streams
(io/SocketCellsReader.cpp:33-80) and Buffer2 double-buffering (the compiler
overlaps the collective with the next strip's compute).

Pipeline efficiency is n_strips / (n_strips + D - 1), matching the
reference's block-pipelined multi-GPU wavefront.

Two entry points:

* ``sharded_stage1`` — score-only (the round-1 path): global best + final
  row.
* ``sharded_stage1_full`` / ``sharded_align`` — the full multi-GPU
  pipeline (sw_stage1.cpp:168-196 + libmasa.cpp:659-757): every device
  additionally tracks its slab-local best *endpoint* (engine tie-break),
  accumulates slab-local special rows at a flush cadence, and captures the
  boundary column it received from its left neighbor.  Those per-device
  artifacts become ``PartResult``s and the existing pipelined /
  speculative slab traceback (parallel/split.py) plus stages 3-6 produce
  a full, doubly re-verified alignment.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from masa_tpu.ops import wavefront as wf
from masa_tpu.types import INF, Recurrence, ScoreParams

NEG = -INF


@dataclasses.dataclass
class ShardedResult:
    best: int
    last_h: np.ndarray  # (n_pad,) final-row H across all slabs
    last_f: np.ndarray
    cells: int
    pruned_strips: np.ndarray | None = None  # per-device skip counts


@dataclasses.dataclass
class ShardedFullResult:
    best: int
    best_i: int
    best_j: int
    parts: list          # split.PartResult per non-empty slab
    cells: int
    pruned_strips: np.ndarray | None = None


def _strip_fn(cfg, W, route):
    """Run one strip over a local slab given border state and its true
    height (call data: the partial tail strip, when m % rows != 0, stops
    at the true matrix row, so its bus is the real last row).  Returns
    (bus_h, bus_f, lastcol_h, lastcol_e, best_v, best_j), the last
    column -INF past the true height."""
    blen = wf.padded_len(cfg, W)

    def run(a_strip, b_ext, bus_h, bus_f, init_h, init_e, corner, h):
        out = wf.strip(cfg, route, a_strip, b_ext, bus_h, bus_f, init_h,
                       init_e, corner, nj=W, h_true=h)
        return (out["bus_h"], out["bus_f"], out["lastcol_h"],
                out["lastcol_e"], out["best_v"], out["best_j"])

    return run, blen


def _default_cfg(route: str) -> wf.WavefrontConfig:
    """The slab strip: 131072 rows on CUDA (enough strips per slab for
    the diagonal pipeline to fill, each still 512 warp bands), the
    4096-row default for the scan twin."""
    if route == "cuda":
        return wf.WavefrontConfig(alpha=4, rs=256, chunk=8192,
                                  recurrence=Recurrence.SMITH_WATERMAN)
    return wf.WavefrontConfig(recurrence=Recurrence.SMITH_WATERMAN)


def _sharded_run(
    seq0: np.ndarray,
    seq1: np.ndarray,
    mesh: Mesh,
    cfg: wf.WavefrontConfig | None,
    params: ScoreParams,
    route: str | None,
    prune: bool,
    flush_stride: int,
    capture_cols: bool,
    state_dir: str | None = None,
    chunk_rounds: int = 0,
    sink=None,
):
    """The shared shard_map scan, CHUNKED over pipeline rounds.

    flush_stride > 0 emits a special row every `flush_stride` strips;
    capture_cols emits the received boundary column (the
    _CapturingReader analogue — the reference persists the loaded column
    through the SRA, sra/SpecialRowsPartition.cpp:468-487).

    Unlike a single whole-run scan, each jitted call covers
    ``chunk_rounds`` pipeline rounds and the special rows / boundary
    columns flow to the HOST between chunks: device memory stays bounded
    by O(chunk) regardless of m (the reference's multi-GPU stage 1
    streams through the per-node SRA the same way,
    stage1/sw_stage1.cpp:168-196).  With ``state_dir`` set, the small
    inter-chunk carry checkpoints to disk and an interrupted run RESUMES
    from the last completed chunk (Status-file semantics,
    common/Status.cpp:70-89)."""
    from masa_tpu.utils.devices import kernel_route

    axis = mesh.axis_names[0]
    D = mesh.devices.size
    route = route or kernel_route()
    if cfg is None:
        cfg = _default_cfg(route)
    # the kernels score from the config: ALWAYS bake the caller's params
    # in (a caller-supplied cfg with default scores must not silently
    # override non-default params)
    cfg = dataclasses.replace(
        cfg, track_best=True, store_lastcol=True,
        match=params.match, mismatch=params.mismatch,
        gap_open=params.gap_open, gap_ext=params.gap_ext,
    )
    R = cfg.rows
    m, n = len(seq0), len(seq1)
    n_strips = -(-m // R)
    m_pad = n_strips * R
    W = -(-n // D)
    n_pad = W * D
    rounds = n_strips + D - 1
    n_sp = n_strips // flush_stride if flush_stride else 0

    seq0_pad = np.full(m_pad, wf.A_SENTINEL, np.int32)
    seq0_pad[:m] = seq0
    b_pad = np.full(n_pad, wf.B_SENTINEL, np.int32)
    b_pad[:n] = seq1
    b_sharded = b_pad.reshape(D, W)

    run_strip, blen = _strip_fn(cfg, W, route)
    # the partial tail strip (m % R != 0) stops at the true last row;
    # otherwise the bus decays through the sentinel rows and the emitted
    # "last row" is row m_pad, not row m
    tail_h = m - (n_strips - 1) * R

    # chunk length: cover every device's flush cadence a few times per
    # chunk so the sp buffer stays small but dispatches stay amortized
    c = chunk_rounds or min(rounds, max(flush_stride, 1) * 4)
    n_chunks = -(-rounds // c)
    spc = (c // flush_stride + 2) if flush_stride else 1

    def shard_fn(b_local, seq0_all, r0, bus_h, bus_f, recv_h, recv_e,
                 corner, best3, gbest, npruned):
        d = jax.lax.axis_index(axis)
        b_loc = b_local.reshape(W)
        b_ext = jnp.concatenate(
            [b_loc, jnp.full(blen - W, wf.B_SENTINEL, jnp.int32)]
        )
        bus_h = bus_h.reshape(blen)
        bus_f = bus_f.reshape(blen)
        recv_h = recv_h.reshape(R)
        recv_e = recv_e.reshape(R)
        corner = corner.reshape(())
        best3 = tuple(best3.reshape(3))
        gbest = gbest.reshape(())
        npruned = npruned.reshape(())
        zero_col = jnp.zeros(R, jnp.int32)       # SW zero borders
        neg_col = jnp.full(R, NEG, jnp.int32)

        neg_bus = jnp.full(blen, NEG, jnp.int32)

        def round_body(carry, k):
            (bus_h, bus_f, recv_h, recv_e, corner, best3, gbest, npruned,
             sp_h, sp_f, fc_h, fc_e) = carry
            r = r0 + k
            s = r - d
            active = jnp.logical_and(s >= 0, s < n_strips)
            s_c = jnp.clip(s, 0, n_strips - 1)
            a_strip = jax.lax.dynamic_slice(seq0_all, (s_c * R,), (R,))
            init_h = jnp.where(d == 0, zero_col, recv_h)
            init_e = jnp.where(d == 0, neg_col, recv_e)
            corner_eff = jnp.where(d == 0, 0, corner)

            if prune:
                # score-share pruning bound over the REMAINING GLOBAL
                # matrix from this strip's top-left corner
                entering = jnp.maximum(
                    jnp.maximum(jnp.max(bus_h), jnp.max(init_h)),
                    jnp.int32(0),
                )
                rows_left = jnp.int32(m) - s_c * R
                cols_left = jnp.int32(n) - d * W
                gain = jnp.minimum(rows_left, cols_left) * cfg.match
                prunable = entering + gain <= gbest
                run_it = jnp.logical_and(active, ~prunable)
                npruned = npruned + jnp.where(
                    jnp.logical_and(active, prunable), 1, 0
                )
            else:
                run_it = active

            def do(_):
                h = jnp.where(s_c == n_strips - 1, tail_h, R)
                return run_strip(a_strip, b_ext, bus_h, bus_f, init_h,
                                 init_e, corner_eff, h)

            def skip(_):
                if prune:
                    # pruned strips clear their buses/columns to -INF
                    # (consumed downstream); inactive strips keep state
                    pr = jnp.logical_and(active, True)
                    bh_s = jnp.where(pr, neg_bus, bus_h)
                    bf_s = jnp.where(pr, neg_bus, bus_f)
                    lc = jnp.where(pr, jnp.full(R, NEG, jnp.int32),
                                   zero_col)
                else:
                    bh_s, bf_s, lc = bus_h, bus_f, zero_col
                return (
                    bh_s, bf_s, lc, neg_col,
                    jnp.zeros(R, jnp.int32), jnp.zeros(R, jnp.int32),
                )

            bh, bf, lc_h, lc_e, bv, bt = jax.lax.cond(run_it, do, skip,
                                                      None)
            # slab-local best ENDPOINT with the engine tie-break (skipped
            # strips emit zero captures, which a strict > merge ignores)
            best3 = wf.merge_best_device(best3, bv, bt, s_c * R, 0)
            if prune:
                # circulate the global best every round (the score-share);
                # the bound scalar is separate — best3 stays slab-LOCAL so
                # the host can pick the endpoint's owning device
                gbest = jax.lax.pmax(jnp.maximum(gbest, best3[0]), axis)

            if flush_stride:
                # special row (s+1)*R lands in the chunk-local slot:
                # global flush ordinal (s+1)/stride minus the flushes
                # this device completed before round r0
                do_fl = jnp.logical_and(
                    active, (s_c + 1) % flush_stride == 0)
                q_before = jnp.maximum(r0 - d, 0) // flush_stride
                slot = jnp.clip((s_c + 1) // flush_stride - 1 - q_before,
                                0, spc - 1)
                cur_h = jax.lax.dynamic_slice(sp_h, (slot, 0), (1, W))
                cur_f = jax.lax.dynamic_slice(sp_f, (slot, 0), (1, W))
                sp_h = jax.lax.dynamic_update_slice(
                    sp_h, jnp.where(do_fl, bh[:W][None, :], cur_h),
                    (slot, 0))
                sp_f = jax.lax.dynamic_update_slice(
                    sp_f, jnp.where(do_fl, bf[:W][None, :], cur_f),
                    (slot, 0))
            if capture_cols:
                # the column entering THIS strip covers boundary rows
                # s*R+1 .. (s+1)*R; chunk-local slot k
                fc_h = jax.lax.dynamic_update_slice(
                    fc_h, jnp.where(active, init_h,
                                    fc_h[k]).reshape(1, R), (k, 0))
                fc_e = jax.lax.dynamic_update_slice(
                    fc_e, jnp.where(active, init_e,
                                    fc_e[k]).reshape(1, R), (k, 0))

            new_corner = recv_h[R - 1]
            # exchange: last column -> right neighbor
            perm = [(i, i + 1) for i in range(D - 1)]
            nrecv_h = jax.lax.ppermute(lc_h, axis, perm)
            nrecv_e = jax.lax.ppermute(lc_e, axis, perm)
            return (bh, bf, nrecv_h, nrecv_e, new_corner, best3, gbest,
                    npruned, sp_h, sp_f, fc_h, fc_e), None

        sp0 = jnp.zeros((spc, W), jnp.int32)
        fcc = c if capture_cols else 1
        fc0 = jnp.zeros((fcc, R), jnp.int32)
        init = (bus_h, bus_f, recv_h, recv_e, corner, best3, gbest,
                npruned, sp0, sp0, fc0, fc0)
        (bus_h, bus_f, recv_h, recv_e, corner, best3, gbest, npruned,
         sp_h, sp_f, fc_h, fc_e), _ = jax.lax.scan(
            round_body, init, jnp.arange(c, dtype=jnp.int32)
        )
        return (
            bus_h.reshape(1, blen),
            bus_f.reshape(1, blen),
            recv_h.reshape(1, R),
            recv_e.reshape(1, R),
            corner.reshape(1),
            jnp.stack(best3).reshape(1, 3),
            gbest.reshape(1),
            npruned.reshape(1),
            sp_h.reshape(1, spc, W),
            sp_f.reshape(1, spc, W),
            fc_h.reshape(1, fcc, R),
            fc_e.reshape(1, fcc, R),
        )

    sh1 = P(axis, None)
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(sh1, P(), P(), sh1, sh1, sh1, sh1, P(axis), sh1,
                  P(axis), P(axis)),
        out_specs=(sh1, sh1, sh1, sh1, P(axis), sh1, P(axis), P(axis),
                   P(axis, None, None), P(axis, None, None),
                   P(axis, None, None), P(axis, None, None)),
        check_vma=False,
    )
    jfn = jax.jit(fn)
    multi = jax.process_count() > 1
    if multi:
        # multi-host: each controller only addresses its own devices, so
        # global inputs are assembled per-shard and outputs allgathered
        # over the network (the reference's equivalent control plane is the
        # AlignerPool shared-dir mailbox, common/AlignerPool.cpp:152-215)
        from jax.experimental import multihost_utils as mhu
        from jax.sharding import NamedSharding

        def _glob(arr, spec):
            return jax.make_array_from_callback(
                arr.shape, NamedSharding(mesh, spec),
                lambda idx: arr[idx])

        b_in = _glob(b_sharded, P(axis, None))
        s_in = _glob(seq0_pad, P())

        def pull(v):
            return np.asarray(mhu.process_allgather(v, tiled=True))
    else:
        b_in = jnp.asarray(b_sharded)
        s_in = jnp.asarray(seq0_pad)
        pull = np.asarray

    # ---- carry init / resume -------------------------------------------
    import os

    ck_path = os.path.join(state_dir, "sharded_carry.npz") \
        if state_dir else None
    r_start = 0
    carry_names = ("bus_h", "bus_f", "recv_h", "recv_e", "corner",
                   "best3", "gbest", "npruned")
    # a resumed carry is only valid for the SAME run: geometry alone
    # (W/R/D/c) misses score params, pruning, and the sequences — a
    # rerun with different params in the same work dir must recompute,
    # not return the stale result (Status-file fingerprint semantics,
    # common/Status.cpp:70-89 + common/Job.cpp:102-146)
    import hashlib

    fp_src = repr((m, n, params.match, params.mismatch, params.gap_open,
                   params.gap_ext, prune, flush_stride, capture_cols,
                   cfg.alpha, cfg.rs, cfg.chunk, int(cfg.recurrence),
                   hashlib.sha1(np.ascontiguousarray(seq0)).hexdigest(),
                   hashlib.sha1(np.ascontiguousarray(seq1)).hexdigest()))
    run_fp = hashlib.sha1(fp_src.encode()).hexdigest()
    carry = None
    if ck_path and os.path.exists(ck_path):
        try:
            with np.load(ck_path) as z:
                if (int(z["W"]) == W and int(z["R"]) == R
                        and int(z["D"]) == D and int(z["c"]) == c
                        and str(z["fp"]) == run_fp):
                    r_start = int(z["round0"])
                    carry = [np.asarray(z[k]) for k in carry_names]
        except Exception:
            r_start, carry = 0, None
    if carry is None:
        bus_h0 = np.where(np.arange(blen) < W, 0, NEG).astype(np.int32)
        carry = [
            np.broadcast_to(bus_h0, (D, blen)).copy(),
            np.full((D, blen), NEG, np.int32),
            np.zeros((D, R), np.int32),
            np.full((D, R), NEG, np.int32),
            np.zeros(D, np.int32),
            np.zeros((D, 3), np.int32),
            np.zeros(D, np.int32),
            np.zeros(D, np.int32),
        ]

    carry_specs = (sh1, sh1, sh1, sh1, P(axis), sh1, P(axis), P(axis))
    if multi:
        carry = [_glob(np.asarray(a), sp)
                 for a, sp in zip(carry, carry_specs)]

    # ---- the chunk loop (sink=None accumulates full buffers on host) ---
    if sink is None:
        acc_sp_h = np.zeros((D, max(n_sp, 1), W), np.int32)
        acc_sp_f = np.zeros((D, max(n_sp, 1), W), np.int32)
        fc_len = m_pad if capture_cols else 1
        acc_fc_h = np.zeros((D, fc_len), np.int32)
        acc_fc_e = np.zeros((D, fc_len), np.int32)

    trace = os.environ.get("MASA_SHARDED_TRACE")
    for r0 in range(r_start, rounds, c):
        t_ch = __import__("time").time()
        out = jfn(b_in, s_in, jnp.int32(r0), *carry)
        carry = list(out[:8])
        sp_h_c, sp_f_c, fc_h_c, fc_e_c = (pull(v) for v in out[8:])
        if trace:
            print(f"    [sharded] chunk r0={r0}/{rounds} c={c}: "
                  f"{__import__('time').time() - t_ch:.2f}s", flush=True)
        # demultiplex this chunk's emissions (host knows the diagonal
        # pipeline schedule exactly)
        for d in range(D):
            q_before = max(r0 - d, 0) // flush_stride if flush_stride \
                else 0
            for k in range(c):
                s = r0 + k - d
                if not (0 <= s < n_strips):
                    continue
                if capture_cols and d > 0:
                    if sink is None:
                        acc_fc_h[d][s * R : (s + 1) * R] = fc_h_c[d][k]
                        acc_fc_e[d][s * R : (s + 1) * R] = fc_e_c[d][k]
                    else:
                        sink.boundary_col(d, s, fc_h_c[d][k],
                                          fc_e_c[d][k])
                if flush_stride and (s + 1) % flush_stride == 0:
                    slot = (s + 1) // flush_stride - 1 - q_before
                    if sink is None:
                        gslot = (s + 1) // flush_stride - 1
                        if gslot < max(n_sp, 1):
                            acc_sp_h[d][gslot] = sp_h_c[d][slot]
                            acc_sp_f[d][gslot] = sp_f_c[d][slot]
                    else:
                        sink.special_row(d, (s + 1) * R, sp_h_c[d][slot],
                                         sp_f_c[d][slot])
        if ck_path:
            carry_np = [pull(x) for x in carry]
            tmp = ck_path + ".tmp.npz"   # np.savez appends .npz itself
            np.savez(tmp, round0=r0 + c, W=W, R=R, D=D, c=c, fp=run_fp,
                     **dict(zip(carry_names, carry_np)))
            os.replace(tmp, ck_path)
            if sink is not None:
                sink.chunk_done(r0 + c)

    best3, last_h, last_f, npruned = (
        pull(carry[5]), pull(carry[0]), pull(carry[1]), pull(carry[7]))
    host = {
        "best3": best3,
        "last_h": last_h[:, :W],
        "last_f": last_f[:, :W],
        "npruned": npruned,
    }
    if sink is None:
        host.update(sp_h=acc_sp_h, sp_f=acc_sp_f,
                    fc_h=acc_fc_h, fc_e=acc_fc_e)
    host.update(m=m, n=n, W=W, D=D, R=R, n_strips=n_strips, n_sp=n_sp,
                m_pad=m_pad, n_pad=n_pad, flush_stride=flush_stride)
    return host


class ShardedStateSink:
    """Disk persistence for the chunked sharded stage 1 — the per-node
    SRA analogue (sw_stage1.cpp:168-196): slab special rows and boundary
    columns stream into memmaps as chunks complete, so device memory
    stays bounded and an interrupted run resumes from the carry
    checkpoint with all prior emissions already on disk."""

    def __init__(self, state_dir: str, D: int, W: int, R: int,
                 m_pad: int, n_sp: int):
        import os

        os.makedirs(state_dir, exist_ok=True)
        self.dir = state_dir
        self.D, self.W, self.R = D, W, R
        self.m_pad, self.n_sp = m_pad, n_sp
        shape_sp = (D, max(n_sp, 1), W)
        shape_fc = (D, m_pad)
        self.sp_h = self._mm("sp_h.dat", shape_sp)
        self.sp_f = self._mm("sp_f.dat", shape_sp)
        self.fc_h = self._mm("fc_h.dat", shape_fc)
        self.fc_e = self._mm("fc_e.dat", shape_fc)

    def _mm(self, name, shape):
        import os

        path = os.path.join(self.dir, name)
        mode = "r+" if (os.path.exists(path) and
                        os.path.getsize(path) ==
                        int(np.prod(shape)) * 4) else "w+"
        return np.memmap(path, dtype=np.int32, mode=mode, shape=shape)

    def set_stride(self, stride: int):
        self._stride = max(stride, 1)

    def special_row(self, d, row, h, f):
        # row = (s+1)*R with (s+1) % stride == 0 -> global slot
        slot = min(row // (self.R * self._stride) - 1,
                   self.sp_h.shape[1] - 1)
        self.sp_h[d][slot] = h
        self.sp_f[d][slot] = f

    def boundary_col(self, d, s, h, e):
        self.fc_h[d][s * self.R : (s + 1) * self.R] = h
        self.fc_e[d][s * self.R : (s + 1) * self.R] = e

    def chunk_done(self, round0: int):
        self.sp_h.flush()
        self.sp_f.flush()
        self.fc_h.flush()
        self.fc_e.flush()


def sharded_stage1(
    seq0: np.ndarray,
    seq1: np.ndarray,
    mesh: Mesh,
    cfg: wf.WavefrontConfig | None = None,
    params: ScoreParams = ScoreParams(),
    route: str | None = None,
    prune: bool = False,
) -> ShardedResult:
    """Score-only SW forward pass, column-sharded over the mesh.

    Zeros borders (local alignment).  Returns the global best score and the
    final DP row (concatenated slabs).

    ``prune=True`` enables **score-share block pruning across shards** (the
    TPDS2021 distributed pruning the reference could not do over sockets —
    it disables pruning in multi-GPU runs, libmasa.cpp:1318-1323): the
    global best circulates through a scalar ``pmax`` every round, and a
    device skips a strip when
        max(entering H, 0) + min(rows_left, global cols_right) * match
    cannot beat it (AbstractBlockPruning::isBlockPrunable bound over the
    whole remaining matrix, not just the local slab).  Skipped strips write
    -INF buses/columns (clearPrunedBlocks semantics), which stays exact
    for SW because fresh alignments restart from 0 anywhere.
    """
    h = _sharded_run(seq0, seq1, mesh, cfg, params, route, prune,
                     flush_stride=0, capture_cols=False)
    return ShardedResult(
        best=int(h["best3"][:, 0].max()),
        last_h=h["last_h"].reshape(h["n_pad"]),
        last_f=h["last_f"].reshape(h["n_pad"]),
        cells=h["m_pad"] * h["n_pad"],
        pruned_strips=h["npruned"],
    )


def sharded_stage1_full(
    seq0: np.ndarray,
    seq1: np.ndarray,
    mesh: Mesh,
    cfg: wf.WavefrontConfig | None = None,
    params: ScoreParams = ScoreParams(),
    route: str | None = None,
    prune: bool = False,
    flush_stride: int = 1,
    state_dir: str | None = None,
) -> ShardedFullResult:
    """Stage 1 with everything traceback needs, per device: the slab-local
    best endpoint, special rows every ``flush_stride`` strips, and the
    received boundary column — the multi-GPU stage 1 of
    sw_stage1.cpp:168-196 with ppermute in place of sockets.  The returned
    ``parts`` feed ``pipelined_traceback`` / ``speculative_traceback``
    directly (libmasa.cpp:659-757)."""
    from masa_tpu.stages.core import SpecialRowStore
    from masa_tpu.parallel.split import PartResult

    from masa_tpu.utils.devices import kernel_route

    route = route or kernel_route()
    sink = None
    if state_dir is not None:
        # probe shapes cheaply to size the sink like _sharded_run will
        R_ = (cfg or _default_cfg(route)).rows
        D_ = mesh.devices.size
        n_strips_ = -(-len(seq0) // R_)
        stride_ = max(flush_stride, 1)
        sink = ShardedStateSink(state_dir, D_, -(-len(seq1) // D_), R_,
                                n_strips_ * R_, n_strips_ // stride_)
        sink.set_stride(stride_)
    h = _sharded_run(seq0, seq1, mesh, cfg, params, route, prune,
                     flush_stride=max(flush_stride, 1), capture_cols=True,
                     state_dir=state_dir, sink=sink)
    if sink is not None:
        # reload every emission (incl. pre-resume chunks) from disk
        h["sp_h"], h["sp_f"] = sink.sp_h, sink.sp_f
        h["fc_h"], h["fc_e"] = sink.fc_h, sink.fc_e
    m, n, W, D, R = h["m"], h["n"], h["W"], h["D"], h["R"]
    stride = h["flush_stride"]

    parts: list[PartResult] = []
    for d in range(D):
        j0 = d * W
        if j0 >= n:
            break
        j1 = min(j0 + W, n)
        w_d = j1 - j0
        # boundary column (H, E) for rows 0..m at global column j0
        if d > 0:
            fch = np.empty(m + 1, np.int64)
            fce = np.empty(m + 1, np.int64)
            fch[0] = 0          # SW row-0 border
            fce[0] = NEG
            fch[1:] = h["fc_h"][d][:m]
            fce[1:] = h["fc_e"][d][:m]
            first_col = (fch, fce)
        else:
            first_col = None
        store = SpecialRowStore()
        for slot in range(h["n_sp"]):
            r = (slot + 1) * stride * R
            if r > m:
                break
            h_full = np.empty(w_d + 1, np.int64)
            f_full = np.empty(w_d + 1, np.int64)
            h_full[0] = first_col[0][r] if first_col is not None else 0
            f_full[0] = NEG
            h_full[1:] = h["sp_h"][d][slot][:w_d]
            f_full[1:] = h["sp_f"][d][slot][:w_d]
            store.put(r, h_full, f_full)
        bv, bi, bj = (int(x) for x in h["best3"][d])
        parts.append(PartResult(
            best=bv, best_i=bi, best_j=j0 + bj,
            last_h=h["last_h"][d][:w_d].astype(np.int64),
            last_f=h["last_f"][d][:w_d].astype(np.int64),
            cells=h["m_pad"] * w_d,
            specials=store, first_col=first_col, j0=j0, j1=j1,
        ))

    # global endpoint: max score, then smallest i, then smallest j
    gbest = max(((p.best, -p.best_i, -p.best_j, k)
                 for k, p in enumerate(parts)))
    k = gbest[3]
    return ShardedFullResult(
        best=parts[k].best, best_i=parts[k].best_i,
        best_j=parts[k].best_j, parts=parts,
        cells=h["m_pad"] * h["n_pad"], pruned_strips=h["npruned"],
    )


def sharded_align(
    seq0: np.ndarray,
    seq1: np.ndarray,
    mesh: Mesh,
    cfg: wf.WavefrontConfig | None = None,
    params: ScoreParams = ScoreParams(),
    route: str | None = None,
    prune: bool = False,
    flush_stride: int = 1,
    traceback: str = "pipelined",
    max_cells_stage5: int = 1 << 18,
    state_dir: str | None = None,
    max_partition: int = 16,
    log=None,
):
    """The full multi-chip alignment: sharded stage 1 over the mesh, then
    pipelined or speculative slab traceback (stage 2), densification
    (stage 3), the Myers-Miller stage-4 ladder down to `max_partition`
    (the reference's MPS=16 loop, stage4/sw_stage4.cpp:926-945 — engine
    chosen by route, see ops/myers_miller.stage4_reduce), exact
    per-partition traceback with the score invariant (stage 5) and the
    independent stage-6 re-check.  ``log`` receives one line per stage,
    in the single-device runner's format.

    Returns (best_score, Alignment).  The reference equivalent is the
    whole multi-GPU claim: executeTracebackPipelined / Predicted,
    libmasa.cpp:659-757."""
    import time

    from masa_tpu.parallel.split import (
        pipelined_traceback, speculative_traceback,
    )
    from masa_tpu.stages import pipeline, stage6
    from masa_tpu.utils.devices import kernel_route

    log = log or (lambda *a, **k: None)
    t0 = time.time()
    route = route or kernel_route()
    full = sharded_stage1_full(seq0, seq1, mesh, cfg, params, route,
                               prune, flush_stride, state_dir=state_dir)
    dt = time.time() - t0
    log(f"stage1: best={full.best} at ({full.best_i},{full.best_j})  "
        f"{full.cells/1e6:.1f} Mcells in {dt:.2f}s "
        f"({full.cells/dt/1e9:.2f} GCUPS, sharded over "
        f"{mesh.devices.size} devices)")
    t0 = time.time()
    # the slab marchers follow the stage-1 route: "scan" means the CPU
    # twin everywhere (tests), "cuda" lets the hop-size rule pick the
    # kernel per hop
    tb_backend = "numpy" if route == "scan" else "auto"
    if traceback == "speculative":
        cps, _reused = speculative_traceback(seq0, seq1, full.parts,
                                             params, backend=tb_backend)
    else:
        cps = pipelined_traceback(seq0, seq1, full.parts, params,
                                  backend=tb_backend)
    log(f"stage2: {len(cps)} crosspoints in {time.time()-t0:.2f}s")
    t0 = time.time()
    pcfg = pipeline.PipelineConfig(
        params=params, max_cells_stage5=max_cells_stage5,
    )
    cps = pipeline.stage3_densify(seq0, seq1, pcfg, cps)
    log(f"stage3: {len(cps)} crosspoints in {time.time()-t0:.2f}s")
    if max_partition:
        from masa_tpu.ops import myers_miller as mm

        t0 = time.time()
        cps = mm.stage4_reduce(seq0, seq1, cps, params, max_partition,
                               stage5_max_cells=max_cells_stage5)
        log(f"stage4: {len(cps)} crosspoints in {time.time()-t0:.2f}s")
    t0 = time.time()
    aln = pipeline.stage5_emit(seq0, seq1, pcfg, cps)
    if aln.raw_score != full.best:
        raise RuntimeError(
            f"sharded alignment score {aln.raw_score} != stage-1 best "
            f"{full.best}")
    log(f"stage5: score={aln.raw_score} verified in {time.time()-t0:.2f}s")
    stage6.recheck(aln, seq0, seq1, params)
    return full.best, aln
