"""The anti-diagonal wavefront strip — the engine's hot 99%.

A strip is ``R = cfg.rows`` consecutive DP rows computed left to right
over ``nj`` columns, entering with the row above it (the H/F "bus") and
the left border column, leaving with its last row (the next strip's bus),
per-row best scores, optionally its last column and interior special
rows.  Strip boundaries are the special rows (the SRA persists the bus at
the flush cadence).

Two kernels implement the strip, chosen by the platform decision
(``utils.devices.kernel_route``):

  * ``"cuda"`` — the Hopper kernel (ops/cuda/strip_kernel.cu, called
    through ops/cuda_strip.py): warp bands of rows pipelined along the
    columns, the CUDAlign design (src/CUDAligner.cu:638-1007).
  * ``"scan"`` — ``strip_scan``, the same step math as a ``lax.scan``
    over anti-diagonals (CPU: tests and development; the reference the
    CUDA kernel is checked against).  Lane ``l`` of an ``(RS, 128)``
    vector owns rows ``[ALPHA*l, ALPHA*l+ALPHA)`` and computes column
    ``j = t - l`` at step ``t``.

``strip`` is the one entry point: row-major operands in, the same
outputs from either kernel.

Index conventions (kernel frame vs DP frame):
  kernel column ``j`` in [0, nj)  <->  DP column ``j+1`` (consumes seq1[j])
  kernel row    ``i`` in [0, R)   <->  DP row ``i0+i+1`` (consumes strip char i)
  ``bus[j]``   = DP (H, F) at (strip_top-1, j+1);  the DP border element
                 (column 0) is supplied separately via ``corner``.
  ``init_h/e`` = DP (H, E) of the left border at rows i0+1 .. i0+R.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from masa_tpu.types import INF, Recurrence

NEG = -INF
A_SENTINEL = -2  # padded strip rows: never equal to any real byte or B_SENTINEL
B_SENTINEL = -1  # padded columns


@dataclasses.dataclass(frozen=True)
class WavefrontConfig:
    """Static strip template (the analogue of the 16 precompiled CUDA
    variants, CUDAligner.cu:1261-1332).  ``rows`` is the strip height on
    either route; ``alpha``/``rs`` are the scan twin's lane layout and
    ``chunk`` the column granularity of buses and pruning windows."""

    alpha: int = 4
    rs: int = 8               # sublane rows; lanes L = rs*128
    chunk: int = 16384        # columns per bus chunk (pruning granule)
    recurrence: Recurrence = Recurrence.SMITH_WATERMAN
    match: int = 1
    mismatch: int = -3
    gap_open: int = 3
    gap_ext: int = 2
    track_best: bool = True
    # track_pos=False: per-row MAX only; the best's position is recovered
    # by re-running the winning strip with full tracking (two-phase
    # scheme, see strips.run_partition)
    track_pos: bool = True
    store_lastcol: bool = False
    # Mid-strip special-row flush: emit every flush_every-th row of the
    # strip as an extra output bus, decoupling special-row spacing from
    # the strip height (the reference's kernel flushes any row at the
    # manager's cadence, CUDAligner.cu:502-540).  Must be a multiple of
    # alpha*128 and divide rows; full-height strips only.  0 = strip-
    # boundary flushes only.
    flush_every: int = 0

    @property
    def lanes(self) -> int:
        return self.rs * 128

    @property
    def rows(self) -> int:
        return self.alpha * self.lanes

    def steps(self, nj: int) -> int:
        return nj + self.lanes - 1



def _lane_iota(rs: int) -> jnp.ndarray:
    r = jax.lax.broadcasted_iota(jnp.int32, (rs, 128), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (rs, 128), 1)
    return r * 128 + c


def _shift(x: jnp.ndarray, insert) -> jnp.ndarray:
    """Flat down-shift by one lane over an (RS,128) vector: out[l] = x[l-1],
    out[0] = insert.  One lane roll + a sublane carry fix, expressed with
    rolls and masked selects only (no scatter; everything stays
    2-D)."""
    rs = x.shape[0]
    rolled = jnp.roll(x, 1, axis=1)
    carry = jnp.roll(x[:, -1:], 1, axis=0)  # (RS, 1): carry[r] = x[r-1, -1]
    row0 = jax.lax.broadcasted_iota(jnp.int32, (rs, 1), 0) == 0
    carry = jnp.where(row0, insert, carry)
    col0 = jax.lax.broadcasted_iota(jnp.int32, (rs, 128), 1) == 0
    return jnp.where(col0, carry, rolled)


def _flush_interior(cfg: WavefrontConfig) -> tuple[int, int]:
    """(n_int, stride): interior flush-row count per strip and their
    sublane stride.  Interior row q (0-based) is strip row
    (q+1)*flush_every - 1: sub-row alpha-1, lane column 127, sublane
    (q+1)*stride - 1 — the strip's LAST row is sublane rs-1 of the SAME
    per-step capture, so flush mode replaces the dedicated bus select."""
    if not cfg.flush_every:
        return 0, 0
    grain = cfg.alpha * 128
    assert cfg.flush_every % grain == 0, \
        "flush_every must be a multiple of alpha*128"
    assert cfg.rows % cfg.flush_every == 0 and cfg.flush_every < cfg.rows, \
        "flush_every must divide the strip height"
    stride = cfg.flush_every // grain
    return cfg.rows // cfg.flush_every - 1, stride


def _interior_lane(cfg: WavefrontConfig, q: int) -> int:
    """Flush lane of interior row q: its bus column j lands at physical
    step t = j + lane (the same realignment as the boundary bus)."""
    return (q + 1) * cfg.flush_every // cfg.alpha - 1


def _make_step(cfg: WavefrontConfig, nj, h_true):
    """Build the per-step update.  ``nj`` and ``h_true`` may be traced.

    The state is a flat tuple (scan-friendly):
      hh[0..A-1], ee[0..A-1], r3h1, r3h2, r3f, rb, bus_h_prev,
      [best_v[0..A-1], best_t[0..A-1]], [lc_h[0..A-1], lc_e[0..A-1]]

    Returns step(state, t, b_t, bus_h_t, bus_f_t) -> (state', hs, fs):
    the H and F vectors of the A sub-rows at this step.
    a_lanes/init_h/init_e are closed over.
    """
    go, ge = cfg.gap_open, cfg.gap_ext
    sw = cfg.recurrence == Recurrence.SMITH_WATERMAN
    a = cfg.alpha

    def make(a_lanes, init_h, init_e):
        def step(st, t, b_t, bus_h_t, bus_f_t):
            (hh, ee, r3h1, r3h2, r3f, rb0, bus_h_prev,
             best_v, best_t, lc_h, lc_e) = st
            up_h = _shift(r3h1, bus_h_t)
            up_f = _shift(r3f, bus_f_t)
            dg_h = _shift(r3h2, bus_h_prev)
            rb = _shift(rb0, b_t)

            li = _lane_iota(cfg.rs)
            j_vec = t - li
            at_border = j_vec == -1
            valid_j = jnp.logical_and(j_vec >= 0, j_vec < nj)
            at_lastcol = j_vec == (nj - 1)

            hs, es, fs = [], [], []
            new_bv, new_bt = list(best_v), list(best_t)
            new_lh, new_le = list(lc_h), list(lc_e)
            for k in range(a):
                e_k = jnp.maximum(hh[k] - go, ee[k]) - ge
                uh = up_h if k == 0 else hs[k - 1]
                uf = up_f if k == 0 else fs[k - 1]
                f_k = jnp.maximum(uh - go, uf) - ge
                dg = dg_h if k == 0 else hh[k - 1]
                sub = jnp.where(a_lanes[k] == rb, cfg.match, cfg.mismatch)
                h_k = jnp.maximum(jnp.maximum(dg + sub, e_k), f_k)
                if sw:
                    h_k = jnp.maximum(h_k, 0)
                h_k = jnp.where(at_border, init_h[k], h_k)
                e_k = jnp.where(at_border, init_e[k], e_k)
                hs.append(h_k)
                es.append(e_k)
                fs.append(f_k)
                if cfg.track_best:
                    row_ok = jnp.logical_and(valid_j, (li * a + k) < h_true)
                    upd = jnp.logical_and(h_k > best_v[k], row_ok)
                    new_bv[k] = jnp.where(upd, h_k, best_v[k])
                    if cfg.track_pos:
                        new_bt[k] = jnp.where(upd, t, best_t[k])
                if cfg.store_lastcol:
                    new_lh[k] = jnp.where(at_lastcol, h_k, lc_h[k])
                    new_le[k] = jnp.where(at_lastcol, e_k, lc_e[k])

            nbt = new_bt if (cfg.track_best and cfg.track_pos) else ()
            st2 = (tuple(hs), tuple(es), hs[a - 1], r3h1, fs[a - 1], rb,
                   jnp.asarray(bus_h_t, jnp.int32).reshape(1, 1),
                   tuple(new_bv), tuple(nbt),
                   tuple(new_lh), tuple(new_le))
            return st2, hs, fs

        return step

    return make


def _init_state(cfg: WavefrontConfig, corner, init_h, init_e):
    """Initial scan state.  hh/ee are seeded with the LEFT BORDER values:
    every lane l >= 1 receives its border at its at_border step (t = l-1),
    but lane 0 has no step -1 — its "previous column" IS the border, so
    the initial state must carry init_h/init_e for the in-lane diagonal
    (hh[k-1]) and E chain at kernel column 0 to be correct for rows
    k >= 1.  (Other lanes' seeded values are overwritten at their
    at_border step before first use.)"""
    z = jnp.full((cfg.rs, 128), NEG, jnp.int32)
    zz = jnp.full((cfg.rs, 128), -3, jnp.int32)  # never equals chars/sentinels
    t0 = jnp.zeros((cfg.rs, 128), jnp.int32)
    a = cfg.alpha
    nb = a if cfg.track_best else 0
    nbt = a if (cfg.track_best and cfg.track_pos) else 0
    nl = a if cfg.store_lastcol else 0
    # r3h1 seeds the bottom-row chain: at t=1, lane 1's diagonal reads
    # r3h2 (= this initial r3h1), which must hold lane 0's bottom-row
    # BORDER value (lanes >= 2 get theirs from lane l-1's at_border step).
    return (
        tuple(init_h[k] for k in range(a)),
        tuple(init_e[k] for k in range(a)),
        init_h[a - 1], z, z, zz,
        jnp.asarray(corner, jnp.int32).reshape(1, 1),
        (z,) * nb, (t0,) * nbt, (z,) * nl, (z,) * nl,
    )


def _resolve_outputs(cfg, bus_h, bus_f, st):
    """Reshape best/lastcol captures to row-major engine outputs (the
    last column at the full strip height)."""
    out = {"bus_h": bus_h, "bus_f": bus_f}
    lanes = cfg.lanes
    best_v, best_t, lc_h, lc_e = st[7], st[8], st[9], st[10]
    if cfg.track_best:
        out["best_v"] = jnp.stack([v.reshape(lanes) for v in best_v])
        if cfg.track_pos:
            out["best_t"] = jnp.stack([v.reshape(lanes) for v in best_t])
    if cfg.store_lastcol:
        lh = jnp.stack([v.reshape(lanes) for v in lc_h])  # (A, L)
        le = jnp.stack([v.reshape(lanes) for v in lc_e])
        out["lastcol_h"] = lh.T.reshape(cfg.rows)
        out["lastcol_e"] = le.T.reshape(cfg.rows)
    return out


@jax.jit
def merge_best_device(carry, best_v, best_j, i0, off):
    """Device-side reduction of a strip's per-row best captures (R,) to
    DP-frame (score, i, j), folded into the running carry — no host
    transfer per strip.  Tie-break: smallest i, then smallest j (each
    row's strict-> update already keeps its smallest j); across strips
    the earlier strip wins ties (strict > merge), which is the same order
    because strips advance in i."""
    s, bi, bj = carry
    smax = best_v.max()
    imin = jnp.argmax(best_v).astype(jnp.int32)   # first (smallest) row
    ni = imin + i0 + 1
    nj_ = best_j[imin] + off + 1
    upd = smax > s
    return (jnp.where(upd, smax, s),
            jnp.where(upd, ni, bi),
            jnp.where(upd, nj_, bj))


@jax.jit
def merge_max_device(carry, best_v, strip_id):
    """Phase-1 reduction of max-only captures: carry = (smax, strip_id of
    the EARLIEST strip achieving it) — earliest strip = smallest i, the
    engine-wide tie-break."""
    s, sid = carry
    m = best_v.max()
    upd = m > s
    return (jnp.where(upd, m, s),
            jnp.where(upd, jnp.int32(strip_id), sid))


def resolve_best(best_v, best_j):
    """Host twin of merge_best_device: (score, i, j) in kernel
    coordinates, smallest i then smallest j."""
    bv = np.asarray(best_v)
    i = int(np.argmax(bv))
    return int(bv[i]), i, int(np.asarray(best_j)[i])



def pack_lanes_jnp(cfg: WavefrontConfig, vec) -> jnp.ndarray:
    """Traced variant of the lane packing: (R,) -> (A, RS, 128)."""
    return (
        jnp.asarray(vec, jnp.int32)
        .reshape(cfg.lanes, cfg.alpha)
        .T.reshape(cfg.alpha, cfg.rs, 128)
    )


def pack_strip_rows(cfg: WavefrontConfig, chars: np.ndarray) -> np.ndarray:
    """Rearrange R strip chars (row-major) into the (A, RS, 128) lane layout,
    padding with A_SENTINEL."""
    r = cfg.rows
    out = np.full(r, A_SENTINEL, dtype=np.int32)
    out[: len(chars)] = np.asarray(chars, dtype=np.int32)
    return np.ascontiguousarray(
        out.reshape(cfg.lanes, cfg.alpha).T.reshape(cfg.alpha, cfg.rs, 128)
    )


def pack_border_cols(cfg: WavefrontConfig, h, e) -> tuple[np.ndarray, np.ndarray]:
    """Rearrange left-border (H, E) vectors (length <= R) into (A, RS, 128)."""

    def pack(v):
        out = np.full(cfg.rows, NEG, dtype=np.int32)
        out[: len(v)] = np.asarray(v, dtype=np.int32)
        return np.ascontiguousarray(
            out.reshape(cfg.lanes, cfg.alpha).T.reshape(cfg.alpha, cfg.rs, 128)
        )

    return pack(h), pack(e)


# ---------------------------------------------------------------------------
# lax.scan harness (any backend; the kernel's differential twin)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg",))
def strip_scan(cfg: WavefrontConfig, a_lanes, b, bus_h, bus_f, init_h,
               init_e, corner, nj, h_true):
    """Run one strip with lax.scan.

    a_lanes/init_h/init_e: (A,RS,128) int32; b/bus_h/bus_f: (P,) int32
    (logical index t; padded here to the T = steps(P) steps with
    sentinel/NEG); corner: scalar int32.  ``nj`` <= P and ``h_true`` <= R
    are call data (traced): one program per (cfg, P).
    Returns dict with bus_h/bus_f (P,) = row h_true-1 (meaningful at
    columns < nj), best captures, last column (R,).
    """
    P = bus_h.shape[0]
    T = cfg.steps(P)
    b = _fit(b, T, B_SENTINEL)
    bus_h = _fit(bus_h, T, NEG)
    bus_f = _fit(bus_f, T, NEG)
    nj = jnp.asarray(nj, jnp.int32)
    h_true = jnp.asarray(h_true, jnp.int32)
    step = _make_step(cfg, nj, h_true)(a_lanes, init_h, init_e)
    # the flush (bus) row h_true-1: lane, sub-row, sublane, lane column
    lane, k_fl = (h_true - 1) // cfg.alpha, (h_true - 1) % cfg.alpha
    fr, fc = lane // 128, lane % 128
    n_int, stride = _flush_interior(cfg)

    def body(carry, xs):
        t, b_t, bh_t, bf_t = xs
        st, hs, fs = step(carry, t, b_t, bh_t, bf_t)
        ys = (jnp.stack([h[fr, fc] for h in hs])[k_fl],
              jnp.stack([f[fr, fc] for f in fs])[k_fl])
        if n_int:
            # interior rows sit at sub-row alpha-1, lane column 127
            ys += (jnp.stack([hs[-1][(q + 1) * stride - 1, 127]
                              for q in range(n_int)]),
                   jnp.stack([fs[-1][(q + 1) * stride - 1, 127]
                              for q in range(n_int)]))
        return st, ys

    ts = jnp.arange(T, dtype=jnp.int32)
    st, ys = jax.lax.scan(
        body,
        _init_state(cfg, corner,
                    [init_h[k] for k in range(cfg.alpha)],
                    [init_e[k] for k in range(cfg.alpha)]),
        (ts, b[:T], bus_h[:T], bus_f[:T]),
    )
    bus_h_out = jax.lax.dynamic_slice(ys[0], (lane,), (P,))
    bus_f_out = jax.lax.dynamic_slice(ys[1], (lane,), (P,))
    out = _resolve_outputs(cfg, bus_h_out, bus_f_out, st)
    if n_int:
        rh = ys[2].T  # (n_int, T) physical
        rf = ys[3].T
        out["rows_h"] = jnp.stack([
            jax.lax.dynamic_slice(rh[q], (_interior_lane(cfg, q),), (P,))
            for q in range(n_int)])
        out["rows_f"] = jnp.stack([
            jax.lax.dynamic_slice(rf[q], (_interior_lane(cfg, q),), (P,))
            for q in range(n_int)])
    return out


# ---------------------------------------------------------------------------
# the strip: one entry point, two kernels
# ---------------------------------------------------------------------------


def padded_len(cfg: WavefrontConfig, nj: int) -> int:
    """Bus/column buffer length for a width-nj strip: whole chunks, in
    about eight sizes per octave.  The kernels take the true width as
    call data, so the CUDA kernel never computes the padding; the sizes
    bound the number of buffer shapes, and so of compiled programs."""
    C = cfg.chunk
    q = C * max(1, (1 << max(nj.bit_length() - 4, 0)) // C)
    return -(-nj // q) * q


def _fit(x, n: int, fill: int):
    """x cut or NEG/sentinel-padded to length n (static)."""
    x = jnp.asarray(x, jnp.int32)
    if x.shape[0] >= n:
        return x[:n]
    return jnp.concatenate([x, jnp.full(n - x.shape[0], fill, jnp.int32)])


def rows_vec(cfg: WavefrontConfig, v, fill: int = NEG) -> np.ndarray:
    """A host row vector (length <= R) padded to the strip height."""
    out = np.full(cfg.rows, fill, np.int32)
    out[: len(v)] = np.asarray(v, np.int32)
    return out


def _strip_scan_rows(cfg, a, b, bus_h, bus_f, init_h, init_e, corner,
                     nj, h_true) -> dict:
    """The scan twin behind the row-major interface."""
    out = strip_scan(cfg, pack_lanes_jnp(cfg, a), b, bus_h, bus_f,
                     pack_lanes_jnp(cfg, init_h), pack_lanes_jnp(cfg, init_e),
                     corner, nj=nj, h_true=h_true)
    R, lanes = cfg.rows, cfg.lanes
    if cfg.track_best:
        out["best_v"] = out["best_v"].T.reshape(R)
        if cfg.track_pos:
            lane = jnp.arange(lanes, dtype=jnp.int32)[None, :]
            out["best_j"] = (out.pop("best_t") - lane).T.reshape(R)
    return out


def _strip_cuda(cfg, a, b, bus_h, bus_f, init_h, init_e, corner,
                nj, h_true, n_int: int) -> dict:
    from masa_tpu.ops import cuda_strip

    P = bus_h.shape[0]
    track = (2 if cfg.track_pos else 1) if cfg.track_best else 0
    scal = jnp.stack([jnp.asarray(corner, jnp.int32).reshape(()),
                      jnp.asarray(nj, jnp.int32).reshape(()),
                      jnp.asarray(h_true, jnp.int32).reshape(()),
                      jnp.int32(cfg.flush_every)])
    bh, bf, bv, bj, lh, le, rh, rf = cuda_strip.call(
        jnp.asarray(a, jnp.int32), _fit(b, P, B_SENTINEL),
        jnp.asarray(bus_h, jnp.int32), jnp.asarray(bus_f, jnp.int32),
        jnp.asarray(init_h, jnp.int32), jnp.asarray(init_e, jnp.int32),
        scal, sw=cfg.recurrence == Recurrence.SMITH_WATERMAN, track=track,
        lastcol=cfg.store_lastcol, n_int=n_int, match=cfg.match,
        mismatch=cfg.mismatch, gap_open=cfg.gap_open, gap_ext=cfg.gap_ext)
    out = {"bus_h": bh, "bus_f": bf}
    if track:
        out["best_v"] = bv
    if track == 2:
        out["best_j"] = bj
    if cfg.store_lastcol:
        out["lastcol_h"] = lh
        out["lastcol_e"] = le
    if n_int:
        out["rows_h"] = rh
        out["rows_f"] = rf
    return out


@functools.partial(jax.jit, static_argnames=("cfg", "route"))
def strip(cfg: WavefrontConfig, route: str, a, b, bus_h, bus_f, init_h,
          init_e, corner, nj, h_true) -> dict:
    """One strip through the route's kernel (traceable).  The width
    ``nj`` and true height ``h_true`` are call data, not compile keys:
    one program per (cfg, route, P).

    a, init_h, init_e: (R,) int32 strip chars and left border (rows past
    h_true are ignored); b, bus_h, bus_f: (P,) int32 logical columns,
    P >= nj (b may be longer); corner: scalar.  Returns, NEG wherever a
    column >= nj or a row >= h_true: bus_h/bus_f (P,) = row h_true-1;
    best_v (R,) per-row maxima and, with track_pos, best_j (R,) their
    columns (0 past h_true); lastcol_h/lastcol_e (R,) with store_lastcol;
    rows_h/rows_f (n_int, P) with flush_every (full strips only)."""
    n_int, _ = _flush_interior(cfg)
    if route == "cuda":
        out = _strip_cuda(cfg, a, b, bus_h, bus_f, init_h, init_e, corner,
                          nj, h_true, n_int)
    elif route == "scan":
        out = _strip_scan_rows(cfg, a, b, bus_h, bus_f, init_h, init_e,
                               corner, nj, h_true)
    else:
        raise ValueError(f"unknown kernel route {route!r}")
    # one rule on both routes: nothing past the true width and height
    neg = jnp.int32(NEG)
    col_ok = jnp.arange(bus_h.shape[0], dtype=jnp.int32) < nj
    row_ok = jnp.arange(cfg.rows, dtype=jnp.int32) < h_true
    for k in ("bus_h", "bus_f", "rows_h", "rows_f"):
        if k in out:
            out[k] = jnp.where(col_ok, out[k], neg)
    for k in ("best_v", "lastcol_h", "lastcol_e"):
        if k in out:
            out[k] = jnp.where(row_ok, out[k], neg)
    if "best_j" in out:
        out["best_j"] = jnp.where(row_ok, out["best_j"], 0)
    return out


def _strip_step_body(cfg, route, a, ih, ie, corner, b, bus_h, bus_f,
                     best_carry, i0, nj, track):
    out = strip(cfg, route, a, b, bus_h, bus_f, ih, ie, corner,
                nj=nj, h_true=cfg.rows)
    if track:
        best_carry = merge_best_device(best_carry, out["best_v"],
                                       out["best_j"], i0, 0)
    if cfg.flush_every:
        return (out["bus_h"], out["bus_f"], best_carry, out["rows_h"],
                out["rows_f"])
    return out["bus_h"], out["bus_f"], best_carry


def _strip_max_body(cfg, route, a, ih, ie, corner, b, bus_h, bus_f,
                    max_carry, strip_id, nj):
    out = strip(cfg, route, a, b, bus_h, bus_f, ih, ie, corner,
                nj=nj, h_true=cfg.rows)
    max_carry = merge_max_device(max_carry, out["best_v"], strip_id)
    if cfg.flush_every:
        return (out["bus_h"], out["bus_f"], max_carry, out["rows_h"],
                out["rows_f"])
    return out["bus_h"], out["bus_f"], max_carry


@functools.partial(jax.jit, static_argnames=("cfg", "route"))
def strip_step_max(cfg: WavefrontConfig, route: str, a, ih, ie, corner, b,
                   bus_h, bus_f, max_carry, strip_id, nj):
    """Phase-1 step: max-only tracking, NO donation (the input buses are
    the phase-2 replay checkpoints).  cfg must have track_pos=False."""
    return _strip_max_body(cfg, route, a, ih, ie, corner, b, bus_h, bus_f,
                           max_carry, strip_id, nj)


@functools.partial(jax.jit, static_argnames=("cfg", "route", "track"),
                   donate_argnums=(7, 8))
def strip_step(cfg: WavefrontConfig, route: str, a, ih, ie, corner, b,
               bus_h, bus_f, best_carry, i0, nj, track: bool):
    """One full-height strip as a SINGLE dispatch: kernel + on-device
    best merge fused into one jitted call (no host sync per strip).
    Buses are donated (the kernel updates them in place).

    a/ih/ie: (R,) row-major; b/bus_h/bus_f: (plen,) logical columns; nj
    is call data.  Returns (bus_h', bus_f', best_carry') with the buses
    NEG past nj."""
    return _strip_step_body(cfg, route, a, ih, ie, corner, b, bus_h, bus_f,
                            best_carry, i0, nj, track)


def border_h_traced(code, k, go: int, ge: int):
    """Traced border-H synthesis (models.scoring.border_cells semantics):
    code 0 = WITH_ZEROES, 1 = WITH_GAPS, 2 = WITH_GAPS_OPENED; k may be
    an array of border positions."""
    k = jnp.asarray(k, jnp.int32)
    gaps = jnp.where(k == 0, 0, -go - k * ge)
    return jnp.where(code == 0, 0,
                     jnp.where(code == 1, gaps, -k * ge)).astype(jnp.int32)


# --- device-resident sequence cache ---------------------------------------
# Key: (host pointer, length, sentinel, reversed, pad) + a sampled
# fingerprint (catches pointer reuse after free).  Bounded LRU; entries
# are sentinel-padded so any (offset, static-size) slice stays in bounds.

_DEV_SEQ_CACHE: "OrderedDict[tuple, object]" = None


def _dev_seq_key(arr: np.ndarray, sentinel: int, reverse: bool, pad: int):
    a = np.asarray(arr)
    n = len(a)
    step = max(n // 16, 1)
    fp = bytes(a[::step][:32].tobytes())
    return (a.__array_interface__["data"][0], n, sentinel, reverse, pad,
            fp)


def dev_seq_peek(arr: np.ndarray, sentinel: int, pad: int,
                 reverse: bool = False):
    """A device view of `arr` in the REQUESTED direction if one can be
    produced without a host upload, else None.  A cached same-direction
    entry with enough pad serves directly; a cached opposite-direction
    twin is flipped on device through dev_seq (one fused device op, no
    transfer) — never returned un-flipped."""
    if _DEV_SEQ_CACHE is None:
        return None
    a = np.asarray(arr)
    hit = _dev_seq_find(a, sentinel, reverse, pad)[1]
    if hit is not None:
        return hit
    twin = _dev_seq_find(a, sentinel, not reverse, 0)[1]
    if twin is not None and len(twin) >= len(a):
        return dev_seq(arr, sentinel, pad, reverse)
    return None


@functools.partial(jax.jit, static_argnames=("n", "total", "sentinel",
                                             "flip"))
def _repad_device(fwd, n: int, total: int, sentinel: int, flip: bool):
    body = fwd[:n]
    if flip:
        body = jnp.flip(body)
    return jnp.concatenate(
        [body, jnp.full(total - n, jnp.int32(sentinel))])


def _dev_seq_find(a: np.ndarray, sentinel: int, reverse: bool,
                  min_pad: int):
    """A cached entry for this array/direction with pad >= min_pad
    (callers only need length >= offset + slice; a larger pad serves).
    Returns (key, dev) or (None, None)."""
    if _DEV_SEQ_CACHE is None:
        return None, None
    probe = _dev_seq_key(a, sentinel, reverse, 0)
    for key, dev in _DEV_SEQ_CACHE.items():
        if (key[0], key[1], key[2], key[3], key[5]) == (
                probe[0], probe[1], probe[2], probe[3], probe[5]) \
                and key[4] >= min_pad:
            return key, dev
    return None, None


def dev_seq(arr: np.ndarray, sentinel: int, pad: int,
            reverse: bool = False):
    """Upload (once) a sentinel-padded int32 copy of `arr` (optionally
    reversed) and cache it.  Callers slice it with lax.dynamic_slice at
    per-partition offsets instead of shipping packed strips per call.

    Transfer avoidance: an existing entry with a LARGER pad serves
    directly, and a reversed view builds ON DEVICE by flipping the
    cached forward copy (uploading a multi-MB reversed twin over the
    host link costs time; the flip is one fused device op)."""
    global _DEV_SEQ_CACHE
    from collections import OrderedDict

    if _DEV_SEQ_CACHE is None:
        _DEV_SEQ_CACHE = OrderedDict()
    a = np.asarray(arr)
    n = len(a)
    key = _dev_seq_key(a, sentinel, reverse, pad)
    hitk, hit = _dev_seq_find(a, sentinel, reverse, pad)
    if hit is not None:
        _DEV_SEQ_CACHE.move_to_end(hitk)
        return hit
    _, fwd = _dev_seq_find(a, sentinel, not reverse, 0)
    if fwd is not None and len(fwd) >= n:
        dev = _repad_device(fwd, n, n + pad, sentinel, True)
    else:
        buf = np.full(n + pad, sentinel, np.int32)
        buf[:n] = a[::-1] if reverse else a
        dev = jnp.asarray(buf)
    _DEV_SEQ_CACHE[key] = dev
    # bounded by entries AND bytes (chromosome-scale views are ~4B/char)
    while len(_DEV_SEQ_CACHE) > 10 or sum(
            4 * (k[1] + k[4]) for k in _DEV_SEQ_CACHE) > (2 << 30):
        _DEV_SEQ_CACHE.popitem(last=False)
    return dev


def dev_seq_seed_reversed(fwd_host: np.ndarray, rev_host: np.ndarray,
                          sentinel: int, pad: int) -> None:
    """Seed the cache entry for `rev_host` (a pre-reversed host copy of
    `fwd_host`) by flipping the cached forward device array on device —
    so a consumer that passes the reversed HOST array (stage 2's
    reverse march) hits the cache instead of re-uploading multi-MB."""
    global _DEV_SEQ_CACHE
    from collections import OrderedDict

    if _DEV_SEQ_CACHE is None:
        _DEV_SEQ_CACHE = OrderedDict()
    rev = np.asarray(rev_host)
    n = len(rev)
    if _dev_seq_find(rev, sentinel, False, pad)[1] is not None:
        return
    _, fwd = _dev_seq_find(np.asarray(fwd_host), sentinel, False, 0)
    if fwd is None or len(fwd) < n:
        return
    key = _dev_seq_key(rev, sentinel, False, pad)
    _DEV_SEQ_CACHE[key] = _repad_device(fwd, n, n + pad, sentinel, True)


def _sliced_prep(cfg, seq0x, seq1x, i0_abs, j0_abs, r_local, col_code,
                 nj_real, plen: int):
    """On-device strip preparation: slice the strip chars and the column
    window from the resident sequences, synthesize the pinned column
    border from its init code, and sentinel-mask columns beyond the real
    width (the window slice runs into the next partition's chars)."""
    R = cfg.rows
    go, ge = cfg.gap_open, cfg.gap_ext
    a = jax.lax.dynamic_slice(seq0x, (i0_abs,), (R,))
    kk = jnp.arange(R, dtype=jnp.int32) + r_local + 1
    ih = border_h_traced(col_code, kk, go, ge)
    ie = jnp.full(R, NEG, jnp.int32)
    corner = border_h_traced(col_code, r_local, go, ge)
    b_raw = jax.lax.dynamic_slice(seq1x, (j0_abs,), (plen,))
    jj = jax.lax.iota(jnp.int32, plen)
    b = jnp.where(jj < nj_real, b_raw, jnp.int32(B_SENTINEL))
    return a, ih, ie, corner, b


@functools.partial(jax.jit, static_argnames=("cfg", "route", "track"),
                   donate_argnums=(9, 10))
def strip_step_sliced(cfg: WavefrontConfig, route: str, seq0x, seq1x,
                      i0_abs, j0_abs, r_local, col_code, nj_real, bus_h,
                      bus_f, best_carry, i0_dp, track: bool):
    """strip_step with the device-resident data plane: strip chars and
    the column window slice from resident sequences, borders synthesize
    from the init code — the only per-strip host->device traffic is a
    handful of scalars."""
    a, ih, ie, corner, b = _sliced_prep(
        cfg, seq0x, seq1x, i0_abs, j0_abs, r_local, col_code, nj_real,
        bus_h.shape[0])
    return _strip_step_body(cfg, route, a, ih, ie, corner, b, bus_h, bus_f,
                            best_carry, i0_dp, nj_real, track)


@functools.partial(jax.jit, static_argnames=("cfg", "route"))
def strip_step_max_sliced(cfg: WavefrontConfig, route: str, seq0x, seq1x,
                          i0_abs, j0_abs, r_local, col_code, nj_real, bus_h,
                          bus_f, max_carry, strip_id):
    """strip_step_max (phase-1 max-only tracking) with the
    device-resident data plane.  cfg must have track_pos=False.  NOT
    donated: the two-phase replay keeps checkpoint references to the
    input buses."""
    a, ih, ie, corner, b = _sliced_prep(
        cfg, seq0x, seq1x, i0_abs, j0_abs, r_local, col_code, nj_real,
        bus_h.shape[0])
    return _strip_max_body(cfg, route, a, ih, ie, corner, b, bus_h, bus_f,
                           max_carry, strip_id, nj_real)


@functools.partial(jax.jit, static_argnames=("cfg", "plen"))
def init_bus_synth(cfg: WavefrontConfig, row_code, nj_real, plen: int):
    """Device-synthesized row-border bus (no host upload)."""
    j = jax.lax.iota(jnp.int32, plen) + 1
    bh = jnp.where(j <= nj_real,
                   border_h_traced(row_code, j, cfg.gap_open, cfg.gap_ext),
                   jnp.int32(NEG))
    bf = jnp.full(plen, NEG, jnp.int32)
    return bh, bf



@functools.partial(jax.jit, static_argnames=("nj",))
def delta_pack_device(v, nj: int):
    """Delta-encode the first nj elements to NIBBLES on DEVICE (two
    deltas per byte; -8 escapes out-of-range).  A DP row's deltas lie in
    [-(open+ext), match] (see io/rowcodec.py), so 4 bits almost always
    suffice — an 8x smaller pull over PCIe (the pull, not the compute,
    dominates special-row flushes).  Escaped positions are re-fetched at
    full width by the host."""
    x = v[:nj].astype(jnp.int32)
    dh = jnp.concatenate([x[:1], x[1:] - x[:-1]])
    small = jnp.logical_and(dh >= -7, dh <= 7)
    nib = jnp.where(small, dh, -8) & 0xF
    if nj % 2:
        nib = jnp.concatenate([nib, jnp.zeros(1, jnp.int32)])
    return (nib[0::2] | (nib[1::2] << 4)).astype(jnp.int8)


@jax.jit
def gather_device(v, idx):
    return jnp.take(v, idx)


@jax.jit
def row_of(rows, q):
    """Row q of a stacked (n, P) row array (one compile for every q)."""
    return jax.lax.dynamic_index_in_dim(rows, q, keepdims=False)


def _gather_host(v, idx: np.ndarray) -> np.ndarray:
    """v[idx] pulled to the host as int64; the index vector pads to a
    power of two so the gather compiles once per size class, not once
    per escape count."""
    n = len(idx)
    if n == 0:
        return np.empty(0, np.int64)
    pad = np.zeros(1 << (n - 1).bit_length(), np.int32)
    pad[:n] = idx
    return np.asarray(gather_device(v, jnp.asarray(pad)))[:n].astype(
        np.int64)


def _escapes(u: np.ndarray, nj: int) -> np.ndarray:
    """Positions < nj whose nibble is the -8 escape, from the packed
    bytes alone (bit tests on uint8, no int64 unpacking)."""
    lo = np.flatnonzero((u & 0xF) == 8) * 2
    hi = np.flatnonzero((u >> 4) == 8) * 2 + 1
    mark = np.sort(np.concatenate([lo, hi]))
    return mark[mark < nj]


@functools.partial(jax.jit, static_argnames=("ng", "chunk"))
def chunk_max_device(bus, ng: int, chunk: int):
    """Per-chunk maxima of the bus, reduced ON DEVICE: the pruning window
    needs ng ints, not the 4 MB bus (core/pruning.chunk_maxima's input)."""
    return jnp.max(bus[: ng * chunk].reshape(ng, chunk), axis=1)


def _decode_delta(packed, bus, nj: int) -> np.ndarray:
    u = np.asarray(packed).view(np.uint8)
    lo = (u & 0xF).astype(np.int64)
    hi = (u >> 4).astype(np.int64)
    lo[lo > 7] -= 16
    hi[hi > 7] -= 16
    dh = np.empty(2 * len(u), np.int64)
    dh[0::2] = lo
    dh[1::2] = hi
    b = dh[:nj]
    out = np.cumsum(b)
    mark = np.nonzero(b == -8)[0]
    if len(mark):
        corr = _gather_host(bus, mark) - out[mark]
        add = np.zeros(nj, np.int64)
        add[mark] = np.diff(np.concatenate([[0], corr]))
        out += np.cumsum(add)
    return out


def pull_row_delta(bus, nj: int) -> np.ndarray:
    """Host side of delta_pack_device: pull ceil(nj/2) bytes, reconstruct
    int64 exactly (escaped positions are re-fetched at full width)."""
    return _decode_delta(delta_pack_device(bus, nj), bus, nj)


@jax.jit
def _device_copy(x):
    return x + 0


def pull_row_delta_start(bus, nj: int):
    """Begin an ASYNC delta-packed pull: the packed bytes start copying
    to the host while the caller keeps computing (the next strip's
    compute hides the transfer).  A device-side snapshot of the bus is
    kept so escape re-fetches stay valid even after the caller donates
    the live bus away."""
    packed = delta_pack_device(bus, nj)
    snap = _device_copy(bus)
    try:
        packed.copy_to_host_async()
    except AttributeError:       # backends without async copies
        pass
    return (packed, snap, nj)


def pull_row_delta_finish(handle) -> np.ndarray:
    packed, snap, nj = handle
    return _decode_delta(packed, snap, nj)


def packed_row_host(handle):
    """Self-contained packed form of a pulled row: (packed_u8, esc_idx,
    esc_val).  The escape VALUES are materialized from the device
    snapshot now, so the result reconstructs the row with no device at
    all (decode_packed_row) — the persistable twin of
    pull_row_delta_finish (the SRA writes this form to disk ~16x
    smaller than the int64 pair, with no host re-encode)."""
    packed, snap, nj = handle
    u = np.asarray(packed).view(np.uint8)
    mark = _escapes(u, nj)
    return u, mark.astype(np.int64), _gather_host(snap, mark)


def decode_packed_row(u: np.ndarray, mark: np.ndarray, exact: np.ndarray,
                      nj: int) -> np.ndarray:
    """Host-only inverse of packed_row_host (no device access)."""
    u = np.asarray(u, np.uint8)
    lo = (u & 0xF).astype(np.int64)
    hi = (u >> 4).astype(np.int64)
    lo[lo > 7] -= 16
    hi[hi > 7] -= 16
    dh = np.empty(2 * len(u), np.int64)
    dh[0::2] = lo
    dh[1::2] = hi
    b = dh[:nj]
    out = np.cumsum(b)
    if len(mark):
        corr = np.asarray(exact, np.int64) - out[mark]
        add = np.zeros(nj, np.int64)
        add[mark] = np.diff(np.concatenate([[0], corr]))
        out += np.cumsum(add)
    return out


@functools.partial(jax.jit, static_argnames=("W1", "go"))
def goal_match_device(cut_h, cut_f, rev_h, rev_f, cj, goal, rev0h, rev0f,
                      W1: int, go: int):
    """AlignerUtils::matchColumn ON DEVICE against a device-resident
    stage-1 special row — the hot stage-2 matching without pulling either
    row to the host (the reference's findGoalCell,
    common/AlignerManager.cpp:625-656, chunked through host memory).

    cut_h/cut_f: the stored forward cut, logical index j-1 -> value at
    column j (a retained bus snapshot).  rev_h/rev_f: the reverse pass's
    last-row bus, logical index k-1 -> value at reverse column k.  Match
    index k = 0..W1-1 maps to column j = cj - k; requires
    j_low = cj - (W1-1) >= 1 (the j=0 border case goes via the host
    path).  Returns int32 (status, k, score) with status 0=aligned,
    1=gapped, 2=err-sum-match, 3=err-sum-gap, 4=no-stop — exactly
    models.scoring.match_column's outcome set."""
    W = W1 - 1
    # fwd_k[k] must read H(column cj - k) = cut[(cj - k) - 1]: the flip
    # of the W1-wide window STARTING AT cj - W1 (bus index j-1!)
    fwd_h = jnp.flip(jax.lax.dynamic_slice(cut_h, (cj - W1,), (W1,)))
    fwd_f = jnp.flip(jax.lax.dynamic_slice(cut_f, (cj - W1,), (W1,)))
    rh = jnp.concatenate([rev0h.reshape(1), rev_h[:W]]).astype(jnp.int32)
    rf = jnp.concatenate([rev0f.reshape(1), rev_f[:W]]).astype(jnp.int32)
    sum_m = fwd_h.astype(jnp.int32) + rh
    sum_g = fwd_f.astype(jnp.int32) + rf + jnp.int32(go)
    hit = (sum_m == goal) | (sum_g == goal)
    over = (sum_m > goal) | (sum_g > goal)
    stop = hit | over
    k = jnp.arange(W1, dtype=jnp.int32)
    idx = jnp.where(stop, k, jnp.int32(W1)).min()
    idx_c = jnp.clip(idx, 0, W1 - 1)
    m_at = sum_m[idx_c] == goal
    g_at = sum_g[idx_c] == goal
    is_hit = (idx < W1) & (m_at | g_at)
    status = jnp.where(
        idx >= W1, 4,
        jnp.where(is_hit,
                  jnp.where(m_at, 0, 1),
                  jnp.where(sum_m[idx_c] > goal, 2, 3)))
    score = jnp.where(m_at, fwd_h[idx_c], fwd_f[idx_c]).astype(jnp.int32)
    kout = jnp.where(idx >= W1, -1, idx_c)
    return jnp.stack([status, kout,
                      jnp.where(is_hit, score, 0)]).astype(jnp.int32)
