"""Device-resident stage-2 matching: the DevRowCache + goal_match_device
path must reproduce the host match EXACTLY (crosspoints, scores, match
types) — and must actually be TAKEN (a silent fallback to the host path
would hide regressions like a window off-by-one that costs 5x stage-2
time on chip while staying accidentally correct)."""

import numpy as np
import pytest

from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.stages import core
from masa_tpu.types import AlignmentStart, InitType, ScoreParams

P = ScoreParams()
CFG = WavefrontConfig(alpha=4, rs=1, chunk=512, track_best=True,
                      store_lastcol=False)
R = CFG.rows


def _stage1_with_cache(s0, s1):
    cache = core.DevRowCache()
    store = core.SpecialRowStore()
    res = core.forward_pass(
        s0, s1, P, core.Recurrence.SMITH_WATERMAN,
        InitType.WITH_ZEROES, InitType.WITH_ZEROES,
        special_every=R, store=store, backend="scan", cfg=CFG,
        dev_cache=cache,
    )
    return res, store, cache


def test_dev_cache_populated(dna, homolog):
    s0 = dna(4 * R + 77, seed=601)
    s1 = homolog(s0, seed=602)
    res, store, cache = _stage1_with_cache(s0, s1)
    assert len(cache) == len(store.rows()) == 4
    for r in store.rows():
        hit = cache.get(r)
        assert hit is not None
        dev_h, dev_f, h0, f0 = hit
        host_h, host_f = store.get(r)
        assert h0 == host_h[0] and f0 == host_f[0]
        n = len(s1)
        np.testing.assert_array_equal(np.asarray(dev_h[:n]), host_h[1:])
        np.testing.assert_array_equal(np.asarray(dev_f[:n]), host_f[1:])


def test_dev_match_march_parity(dna, homolog, monkeypatch):
    """reverse_march with the device cache (kernel backend) must yield
    the same crosspoint chain as the numpy-oracle march, AND the device
    match must fire (no misses that widen to the host fallback)."""
    s0 = dna(4 * R + 33, seed=603)
    # homologous region far from column 0, so hop windows (4096 floor)
    # do NOT touch the left edge — the device-match precondition
    s1 = np.concatenate([dna(12000, seed=699), homolog(s0, seed=604)])
    res, store, cache = _stage1_with_cache(s0, s1)
    from masa_tpu.types import Crosspoint, CrosspointType

    ep = Crosspoint(res.best_i, res.best_j, res.best,
                    CrosspointType.MATCH)

    import copy

    ref = core.reverse_march(
        s0, s1, P, ep, copy.deepcopy(store),
        InitType.WITH_ZEROES, InitType.WITH_ZEROES,
        AlignmentStart.ANYWHERE, backend="numpy",
    )

    calls = {"dev": 0, "host": 0}
    from masa_tpu.core.manager import AlignerManager

    dev_orig = AlignerManager.dispatch_last_row_device
    host_orig = AlignerManager._match_goal

    def count_dev(self, *a, **k):
        calls["dev"] += 1
        return dev_orig(self, *a, **k)

    def count_host(self, *a, **k):
        calls["host"] += 1
        return host_orig(self, *a, **k)

    monkeypatch.setattr(AlignerManager, "dispatch_last_row_device",
                        count_dev)
    monkeypatch.setattr(AlignerManager, "_match_goal", count_host)

    got = core.reverse_march(
        s0, s1, P, ep, store,
        InitType.WITH_ZEROES, InitType.WITH_ZEROES,
        AlignmentStart.ANYWHERE, backend="scan", cfg=CFG,
        dev_cache=cache,
    )
    assert [tuple(c) for c in got] == [tuple(c) for c in ref]
    # the device path must have fired, and misses must not have pushed
    # every hop to a full-width host fallback
    assert calls["dev"] >= 2, calls
    assert calls["host"] <= calls["dev"], calls


def test_windowed_cut_march_parity(dna, homolog, monkeypatch):
    """With NO DevRowCache (the 23M eviction / crash-resume regime), the
    march must take the WINDOWED device-cut path — an O(window) SRA read
    uploaded as a cut buffer, matched on device — and produce the exact
    host-path crosspoint chain."""
    s0 = dna(4 * R + 33, seed=603)
    s1 = np.concatenate([dna(12000, seed=699), homolog(s0, seed=604)])
    res, store, cache = _stage1_with_cache(s0, s1)
    from masa_tpu.types import Crosspoint, CrosspointType

    ep = Crosspoint(res.best_i, res.best_j, res.best,
                    CrosspointType.MATCH)

    import copy

    ref = core.reverse_march(
        s0, s1, P, ep, copy.deepcopy(store),
        InitType.WITH_ZEROES, InitType.WITH_ZEROES,
        AlignmentStart.ANYWHERE, backend="numpy",
    )

    calls = {"win": 0, "dev": 0}
    fetch_orig = core._fetch_window_cut

    def count_fetch(*a, **k):
        out = fetch_orig(*a, **k)
        if out is not None:
            calls["win"] += 1
        return out

    from masa_tpu.core.manager import AlignerManager

    dev_orig = AlignerManager.dispatch_last_row_device

    def count_dev(self, *a, **k):
        calls["dev"] += 1
        return dev_orig(self, *a, **k)

    monkeypatch.setattr(core, "_fetch_window_cut", count_fetch)
    monkeypatch.setattr(AlignerManager, "dispatch_last_row_device",
                        count_dev)

    got = core.reverse_march(
        s0, s1, P, ep, store,
        InitType.WITH_ZEROES, InitType.WITH_ZEROES,
        AlignmentStart.ANYWHERE, backend="scan", cfg=CFG,
        dev_cache=None,
    )
    assert [tuple(c) for c in got] == [tuple(c) for c in ref]
    assert calls["win"] >= 2 and calls["dev"] >= 2, calls


def test_dev_match_verdicts_match_host(dna, homolog):
    """goal_match_device against the host match_column on the same cut:
    identical (found, k, score, type) across windows including misses."""
    import jax.numpy as jnp

    from masa_tpu.models.scoring import match_column
    from masa_tpu.ops import wavefront as wf

    s0 = dna(2 * R + 11, seed=605)
    s1 = homolog(s0, seed=606)
    res, store, cache = _stage1_with_cache(s0, s1)
    r = store.rows()[0]
    host_h, host_f = store.get(r)
    dev_h, dev_f, h0, f0 = cache.get(r)
    n = len(s1)
    rng = np.random.default_rng(7)
    for _ in range(12):
        cj = int(rng.integers(10, n))
        width = int(rng.integers(1, cj))
        goal = int(rng.integers(-50, 400))
        # synthetic reverse row (values in a plausible range)
        rev_h = rng.integers(-200, 200, width).astype(np.int64)
        rev_f = rng.integers(-200, 200, width).astype(np.int64)
        rev0h, rev0f = -5, -17
        fwd_cut_h = np.asarray(host_h)[cj - width : cj + 1][::-1]
        fwd_cut_f = np.asarray(host_f)[cj - width : cj + 1][::-1]
        rh_full = np.concatenate([[rev0h], rev_h])
        rf_full = np.concatenate([[rev0f], rev_f])
        ref = match_column(rh_full, rf_full, fwd_cut_h, fwd_cut_f,
                           goal, P.gap_open)
        out = np.asarray(wf.goal_match_device(
            dev_h, dev_f, jnp.asarray(rev_h, jnp.int32),
            jnp.asarray(rev_f, jnp.int32), jnp.int32(cj),
            jnp.int32(goal), jnp.int32(rev0h), jnp.int32(rev0f),
            W1=width + 1, go=P.gap_open))
        status, k, score = (int(x) for x in out)
        if ref.found:
            assert status in (0, 1)
            assert (k, score) == (ref.k, ref.score)
            assert (status == 0) == (ref.type.name == "ALIGNED")
        elif ref.k >= 0:
            assert status in (2, 3) and k == ref.k
        else:
            assert status == 4 and k == -1
