"""The platform decision and what surrounds the CUDA strip kernel, on the
CPU: the route, the compile-cache path, the kernel wrapper's operands and
slicing (checked against the scan twin through a host emulator of the
kernel's call contract), the launch geometry and build, fork card
pinning, and stage 4's choice of route.  The kernel itself runs only on
the card (the gpu-marked test below, and chip_smoke.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from masa_tpu.ops import cuda_strip
from masa_tpu.ops import wavefront as wf
from masa_tpu.types import INF, Recurrence
from masa_tpu.utils import devices

NEG = -INF


# ---------------------------------------------------------------- route


@pytest.mark.parametrize("platform,route", [("gpu", "cuda"),
                                            ("cpu", "scan")])
def test_kernel_route(monkeypatch, platform, route):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert devices.kernel_route() == route


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_kernel_route_refuses_other_platforms(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match="no strip kernel"):
        devices.kernel_route()


# ---------------------------------------------------------- compile cache


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert devices.compile_cache_dir() == str(tmp_path / "cc")


def test_compile_cache_dir_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert devices.compile_cache_dir() == os.path.join(repo, ".jax_cache")


def test_enable_cache_sets_no_dir_when_env_set(monkeypatch, tmp_path):
    calls = {}
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    assert devices.enable_persistent_compile_cache() == str(tmp_path / "cc")
    assert "jax_compilation_cache_dir" not in calls
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    monkeypatch.setattr(devices, "_REPO", str(tmp_path))
    path = devices.enable_persistent_compile_cache()
    assert calls["jax_compilation_cache_dir"] == path
    assert path == str(tmp_path / ".jax_cache") and os.path.isdir(path)


# ------------------------------------------------- kernel wrapper (CPU)


def _emulate(a, b, bus_h, bus_f, init_h, init_e, scal, sw, track,
             lastcol, n_int, match, mismatch, go, ge):
    """Host reference of the kernel's call contract (strip_kernel.cu
    header): row by row, the same recurrence, outputs in the kernel's
    layout (buses in place, per-row bests, last column, interior rows)."""
    corner, nj, h_true, flush = (int(x) for x in scal)
    R, P = len(a), len(bus_h)
    bh, bf = np.array(bus_h), np.array(bus_f)
    bv = np.full(R, NEG, np.int32)
    bj = np.zeros(R, np.int32)
    lh = np.zeros(R, np.int32)
    le = np.zeros(R, np.int32)
    rh = np.zeros((max(n_int, 1), P), np.int32)
    rf = np.zeros((max(n_int, 1), P), np.int32)
    up_h, up_f = bh[:nj].astype(np.int64), bf[:nj].astype(np.int64)
    for i in range(h_true):
        d = corner if i == 0 else int(init_h[i - 1])
        hl, el = int(init_h[i]), int(init_e[i])
        H = np.empty(nj, np.int64)
        F = np.empty(nj, np.int64)
        for j in range(nj):
            e = max(hl - go, el) - ge
            f = max(int(up_h[j]) - go, int(up_f[j])) - ge
            s = match if a[i] == b[j] else mismatch
            h = max(d + s, e, f, 0) if sw else max(d + s, e, f)
            if h > bv[i]:
                bv[i], bj[i] = h, j
            d, hl, el = int(up_h[j]), h, e
            H[j], F[j] = h, f
        lh[i], le[i] = H[nj - 1], el
        if flush and (i + 1) % flush == 0 and i + 1 < R:
            q = (i + 1) // flush - 1
            rh[q, :nj], rf[q, :nj] = H, F
        up_h, up_f = H, F
    bh[:nj], bf[:nj] = up_h, up_f
    return bh, bf, bv, bj, lh, le, rh, rf


def _fake_call(a, b, bus_h, bus_f, init_h, init_e, scal, *, sw, track,
               lastcol, n_int, match, mismatch, gap_open, gap_ext):
    """cuda_strip.call's shapes and aliasing, computed on the host."""
    rows, width = a.shape[0], bus_h.shape[0]
    types = cuda_strip.out_types(rows, width, track, lastcol, n_int)[:8]

    def host(*xs):
        full = _emulate(*(np.asarray(x) for x in xs), sw, track, lastcol,
                        n_int, match, mismatch, gap_open, gap_ext)
        return tuple(np.asarray(v.reshape(-1)[: t.size] if t.ndim == 1
                                else v[: t.shape[0], : t.shape[1]],
                                np.int32)
                     for v, t in zip(full, types))

    return jax.pure_callback(host, tuple(types), a, b, bus_h, bus_f,
                             init_h, init_e, scal)


CASES = [
    # (name, R, P, nj, h_true, sw, track, lastcol, flush)
    ("sw-full", 512, 300, 200, 512, True, 2, True, 0),
    ("nw-partial", 1024, 260, 257, 700, False, 2, True, 0),
    ("window", 512, 512, 100, 512, True, 1, False, 0),
    ("one-row", 512, 64, 40, 1, True, 2, True, 0),
    ("flush", 2048, 128, 90, 2048, True, 0, False, 512),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cuda_wrapper_matches_scan_twin(monkeypatch, case):
    """The CUDA route's wrapper (operand padding, the scalar block of
    call data, output slicing to the width, height and interior rows)
    around an emulated kernel equals the scan route exactly."""
    name, R, P, nj, h_true, sw, track, lastcol, flush = case
    monkeypatch.setattr(cuda_strip, "call", _fake_call)
    cfg = wf.WavefrontConfig(
        alpha=4, rs=R // 512, chunk=256,
        recurrence=(Recurrence.SMITH_WATERMAN if sw
                    else Recurrence.NEEDLEMAN_WUNSCH),
        track_best=track > 0, track_pos=track == 2,
        store_lastcol=lastcol, flush_every=flush)
    rng = np.random.default_rng(R + nj)
    a = jnp.asarray(rng.integers(0, 4, R), jnp.int32)
    b = jnp.asarray(rng.integers(0, 4, P), jnp.int32)
    bh = jnp.asarray(rng.integers(-30, 30, P), jnp.int32)
    bf = jnp.asarray(rng.integers(-60, -10, P), jnp.int32)
    ih = jnp.asarray(rng.integers(-30, 30, R), jnp.int32)
    ie = jnp.asarray(rng.integers(-60, -10, R), jnp.int32)
    corner = jnp.int32(-4)
    got = wf.strip(cfg, "cuda", a, b, bh, bf, ih, ie, corner, nj=nj,
                   h_true=h_true)
    ref = wf.strip(cfg, "scan", a, b, bh, bf, ih, ie, corner, nj=nj,
                   h_true=h_true)
    wf.strip.clear_cache()   # the patched trace must not outlive the test
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(ref[k]), err_msg=k)


def test_launch_geometry():
    """One warp per 256-row band, four bands per block; the ticket
    counter and per-band progress flags size the sync buffer."""
    assert cuda_strip.BAND == 256
    assert cuda_strip.launch_geometry(256) == (1, 1)
    assert cuda_strip.launch_geometry(512) == (2, 1)
    assert cuda_strip.launch_geometry(1024 + 1) == (5, 2)
    assert cuda_strip.launch_geometry(1 << 19) == (2048, 512)
    types = cuda_strip.out_types(1 << 19, 1000, 2, True, 3)
    assert [t.shape for t in types] == [
        (1000,), (1000,), (1 << 19,), (1 << 19,), (1 << 19,), (1 << 19,),
        (3, 1000), (3, 1000), (2049,)]
    # untracked outputs shrink to one element
    types = cuda_strip.out_types(512, 64, 0, False, 0)
    assert [t.shape for t in types][2:8] == [(1,)] * 6


def test_kernel_build_command(monkeypatch, tmp_path):
    """The library builds from the tracked .cu source for sm_90a into
    the ignored build directory, named by a hash of source and flags; a
    failed build raises."""
    import subprocess

    monkeypatch.setattr(cuda_strip, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_strip, "_nvcc", lambda: "fake-nvcc")
    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"] = cmd
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(subprocess, "run", fake_run)
    path = cuda_strip.library_path()
    assert os.path.dirname(path) == str(tmp_path) and os.path.exists(path)
    cmd = seen["cmd"]
    assert cmd[0] == "fake-nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith(os.path.join("ops", "cuda", "strip_kernel.cu"))
    seen.clear()
    assert cuda_strip.library_path() == path and not seen   # cached

    os.remove(path)
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 1, "", "boom"))
    with pytest.raises(RuntimeError, match="build failed"):
        cuda_strip.library_path()


def test_build_dir_is_ignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as fh:
        ignored = fh.read().split()
    assert "masa_tpu/ops/cuda/_build/" in ignored
    assert ".jax_cache/" in ignored


# ---------------------------------------------------------- fork pinning


def test_fork_pins_one_card_per_worker(monkeypatch):
    from masa_tpu.parallel import fork

    monkeypatch.setattr(devices, "visible_gpus", lambda: ["0", "1", "2"])
    pins = fork.fork_pinning(2, "gpu")
    assert pins == [{"CUDA_VISIBLE_DEVICES": "0"},
                    {"CUDA_VISIBLE_DEVICES": "1"}]
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    assert fork.fork_pinning(3, None)[2] == {"CUDA_VISIBLE_DEVICES": "2"}


def test_fork_refuses_more_workers_than_cards(monkeypatch):
    from masa_tpu.parallel import fork

    monkeypatch.setattr(devices, "visible_gpus", lambda: ["0"])
    with pytest.raises(ValueError, match="only 1 GPU"):
        fork.fork_pinning(2, "gpu")


def test_fork_cpu_is_not_pinned(monkeypatch):
    from masa_tpu.parallel import fork

    monkeypatch.setattr(devices, "visible_gpus", lambda: ["0"])
    assert fork.fork_pinning(4, "cpu") == [{}] * 4
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert fork.fork_pinning(4, None) == [{}] * 4
    monkeypatch.delenv("JAX_PLATFORMS")
    monkeypatch.setattr(devices, "visible_gpus", lambda: [])
    assert fork.fork_pinning(2, None) == [{}, {}]


def test_visible_gpus_reads_env(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3, 5,")
    assert devices.visible_gpus() == ["3", "5"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert devices.visible_gpus() == []


# ------------------------------------------------------ stage-4 route


def test_stage4_device_engine_only_on_cuda(monkeypatch):
    from masa_tpu.ops import myers_miller as mm

    monkeypatch.setattr(devices, "kernel_route", lambda: "cuda")
    assert mm.device_batched(mm.SplitStrategy.OPTIMIZED)
    assert mm.device_batched("OPTIMIZED")
    assert not mm.device_batched(mm.SplitStrategy.ORIGINAL_MM)
    monkeypatch.setattr(devices, "kernel_route", lambda: "scan")
    assert not mm.device_batched(mm.SplitStrategy.OPTIMIZED)


def test_stage4_reduce_dispatch(monkeypatch):
    """On the CUDA route stage4_reduce hands the chain to the device
    engine with the stage-5 absorbable partition size."""
    from masa_tpu.ops import batched_mm, myers_miller as mm
    from masa_tpu.types import Crosspoint, ScoreParams

    seen = {}

    def spy(s0, s1, cps, params, mps, log=None):
        seen["mps"] = mps
        return cps

    monkeypatch.setattr(batched_mm, "reduce_partitions_batched", spy)
    monkeypatch.setattr(devices, "kernel_route", lambda: "cuda")
    cps = [Crosspoint(0, 0, 0, 0), Crosspoint(100, 100, 100, 0)]
    s = np.zeros(100, np.uint8)
    mm.stage4_reduce(s, s, cps, ScoreParams(), 16, stage5_max_cells=1024)
    assert seen["mps"] == 32


def test_stage4_level_engine_choice(monkeypatch):
    """Levels of tall halves go to the strip kernel on the CUDA route;
    every other level batches through the row sweep."""
    from masa_tpu.ops import batched_mm as bmm

    used = []
    monkeypatch.setattr(bmm, "_halves_strips",
                        lambda *a, **k: used.append("strips"))
    monkeypatch.setattr(bmm, "_halves_sweep",
                        lambda *a, **k: used.append("sweep"))
    tall = [bmm._Half(0, bmm._STRIPS_H_MIN, 0, 10, 1, 1)]
    short = [bmm._Half(0, bmm._STRIPS_H_MIN - 1, 0, 10, 1, 1)]
    monkeypatch.setattr(devices, "kernel_route", lambda: "cuda")
    bmm._run_level(None, tall, False, None, 16)
    bmm._run_level(None, short, False, None, 16)
    monkeypatch.setattr(devices, "kernel_route", lambda: "scan")
    bmm._run_level(None, tall, False, None, 16)
    assert used == ["strips", "sweep", "sweep"]


# ------------------------------------------------------------ the card


@pytest.mark.gpu
def test_cuda_kernel_matches_scan_twin(gpu):
    """The compiled kernel against the scan twin over every variant
    (chip_smoke.py phase 2)."""
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.phase_kernel()
