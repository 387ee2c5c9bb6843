"""Row-sweep DP engine: the affine-gap recurrence as a `lax.scan` over
ROWS with one cumulative max per row — pure XLA, no custom kernel, no
anti-diagonal skew.

Per row (matching ops/oracle.dp_rows' conventions exactly — the bus
convention stores (H, F) where F is the VERTICAL gap):

    F_j  = max(H_prev_j - go, F_prev_j) - ge          (vertical, carried)
    H'_j = max(H_prev_{j-1} + sub_j, F_j) [max 0 for SW]; H'_0 = border
    G_j  = max_{k<j}( max(H'_k - go, G_seed_k) - (j-k)*ge )  (horizontal)
         = (excl-cummax of c)_j - j*ge,  c_k = H'_k - go + k*ge
           (k=0 seeded with the column border's horizontal gap)
    H_j  = max(H'_j, G_j)

Why ONE cummax is exact (Gotoh): a horizontal gap re-opened from a cell
whose H came from G is dominated by extending the same gap (gap_open
>= 0), so substituting the G-free H' in the prefix changes nothing —
the oracle's lazy fixpoint converges in this single pass.

The scan length is m (rows), not m+n (anti-diagonals): for the
traceback stages' odd-height tails, deep stage-4 levels, and partial
strips this replaces second-long wavefront scans with millisecond
sweeps and compiles in seconds as plain XLA.  The stage-1 hot loop
keeps the wavefront strip kernel (the cummax roughly doubles the
per-cell work — a fine trade wherever dispatch/compile dominates, a
poor one for the 99% kernel).

Chaining: the returned (h, f) row IS the next sweep's (row_h, row_f)
input — identical to the wavefront bus contract.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from masa_tpu.ops import wavefront as wf
from masa_tpu.types import INF

NEG = -INF


@functools.partial(
    jax.jit,
    static_argnames=("n1", "m_steps", "sw", "go", "ge", "match",
                     "mismatch", "track_best", "want_lastcol"))
def sweep(a_chars, b_row, h0, e0, row_h, row_f, stop_after,
          n1: int, m_steps: int, sw: bool, go: int, ge: int,
          match: int, mismatch: int,
          track_best: bool = False, want_lastcol: bool = False):
    """Run `m_steps` DP rows over a width-(n1-1) matrix.

    a_chars: (m_steps,) int32 row chars (sentinel rows past the true
        height only decay; callers gate on their own h_rem).
    b_row:   (n1,) int32, b_row[j] = char of column j (b_row[0] unused).
    h0, e0:  (m_steps,) int32 column-border H and HORIZONTAL-gap values
        at rows i0+1..i0+m_steps (e0 is NEG for synthesized borders,
        the stored E for custom column data — oracle.dp_rows:199-200).
    row_h, row_f: (n1,) entering row bus including the corner at 0
        (f = vertical gap, the bus convention).

    stop_after: traced int32 — rows beyond it leave the carry frozen,
    so the returned bus is EXACTLY the row-`stop_after` state (chained
    strips with per-element heights; pass m_steps to run everything).

    Returns dict: h, f (n1,) the final row bus; best (3,) [value,
    i (1-based sweep step), j] if track_best; lastcol_h/lastcol_e
    (m_steps,) if want_lastcol (e = horizontal gap, the column-border
    convention)."""
    j_idx = jnp.arange(n1, dtype=jnp.int32)
    jge = j_idx * jnp.int32(ge)
    b32 = b_row.astype(jnp.int32)

    H0 = row_h.astype(jnp.int32)
    F0 = row_f.astype(jnp.int32)

    def body(carry, xs):
        H_prev, F_prev, best = carry
        a_i, h0_i, e0_i, i_cur = xs
        act = i_cur <= stop_after
        F = jnp.maximum(H_prev - go, F_prev) - ge
        F = F.at[0].set(NEG)
        diag = jnp.concatenate([H_prev[:1], H_prev[:-1]])
        sub = jnp.where(b32 == a_i, jnp.int32(match),
                        jnp.int32(mismatch))
        Hp = jnp.maximum(diag + sub, F)
        if sw:
            Hp = jnp.maximum(Hp, 0)
        Hp = Hp.at[0].set(h0_i)
        c = Hp - jnp.int32(go) + jge
        c = c.at[0].set(jnp.maximum(c[0], e0_i))
        run = jax.lax.cummax(c)
        G = jnp.concatenate([e0_i.reshape(1), run[:-1] - jge[1:]])
        G = jnp.maximum(G, NEG)
        H = jnp.maximum(Hp, G)
        H = jnp.where(act, H, H_prev)
        F = jnp.where(act, F, F_prev)
        if track_best:
            v = jnp.max(H)
            j = jnp.argmax(H).astype(jnp.int32)
            upd = jnp.logical_and(v > best[0], act)
            best = (jnp.where(upd, v, best[0]),
                    jnp.where(upd, i_cur, best[1]),
                    jnp.where(upd, j, best[2]),
                    i_cur)
        ys = (H[n1 - 1], G[n1 - 1]) if want_lastcol else None
        return (H, F, best), ys

    best0 = (jnp.int32(-INF), jnp.int32(0), jnp.int32(0), jnp.int32(0))
    (H, F, best), ys = jax.lax.scan(
        body, (H0, F0, best0),
        (a_chars.astype(jnp.int32), h0.astype(jnp.int32),
         e0.astype(jnp.int32),
         jnp.arange(1, m_steps + 1, dtype=jnp.int32)),
        length=m_steps)
    out = {"h": H, "f": F}
    if track_best:
        out["best"] = jnp.stack(best[:3])
    if want_lastcol:
        out["lastcol_h"], out["lastcol_e"] = ys
    return out


@functools.lru_cache(maxsize=32)
def batched_sweep_engine(n1: int, R: int, sw: bool, go: int, ge: int,
                         match: int, mismatch: int):
    """jit(vmap) row-sweep for half-passes against the device-resident
    sequence views: per element (i0, j0, r0, col_code, bus_h, bus_f,
    h_rem), chaining R rows from a logical (n1-1,)-wide bus.  The
    replacement for the wavefront dyn engine: a (B,) x R-row scan
    instead of a (rows + width)-step one."""

    def one(s0d, s1d, i0, j0, r0, col_code, bus_h, bus_f, h_rem):
        r0 = jnp.asarray(r0, jnp.int32)
        a_vec = jax.lax.dynamic_slice(s0d, (i0 + r0,), (R,))
        kk = jnp.arange(R, dtype=jnp.int32) + r0 + 1
        h0 = wf.border_h_traced(col_code, kk, go, ge)
        e0 = jnp.full(R, NEG, jnp.int32)   # synthesized borders carry
        corner = wf.border_h_traced(col_code, r0, go, ge)  # no E
        b = jnp.concatenate(
            [jnp.zeros(1, jnp.int32),
             jax.lax.dynamic_slice(s1d, (j0,), (n1 - 1,))])
        row_h = jnp.concatenate([corner.reshape(1),
                                 bus_h[: n1 - 1].astype(jnp.int32)])
        row_f = jnp.concatenate([jnp.full(1, NEG, jnp.int32),
                                 bus_f[: n1 - 1].astype(jnp.int32)])
        out = sweep(a_vec, b, h0, e0, row_h, row_f,
                    jnp.clip(h_rem, 0, R),
                    n1=n1, m_steps=R, sw=sw, go=go, ge=ge,
                    match=match, mismatch=mismatch)
        keep = h_rem > 0
        return (jnp.where(keep, out["h"][1:], bus_h[: n1 - 1]),
                jnp.where(keep, out["f"][1:], bus_f[: n1 - 1]))

    return jax.jit(jax.vmap(
        one, in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0)))
