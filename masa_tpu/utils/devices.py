"""Device enumeration/selection — the cuda_util analogue
(src/cuda_util.cpp:191-305): list accelerators, derive fork weights, pick
a device per process id."""

from __future__ import annotations

import os


def list_devices() -> list[dict]:
    import jax

    out = []
    for d in jax.devices():
        out.append({
            "id": d.id,
            "platform": d.platform,
            "kind": getattr(d, "device_kind", "unknown"),
            "process": d.process_index,
        })
    return out


_BURST = None


def _probe_burst():
    """Module-level jitted probe (a fresh jit per call would retrace and
    recompile on every invocation)."""
    global _BURST
    if _BURST is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def burst(x):
            # int32 burst matching the DP op mix (the wavefront cell
            # update is max/add/select chains on int32, not f32 matmul —
            # weighting an int32-bound workload by matmul throughput
            # mis-ranks heterogeneous devices)
            y = x
            for _ in range(48):
                y = jnp.maximum(y + 3, x - y)
                y = jnp.where(y > 0, y - 2, y + 1)
            return y

        _BURST = burst
    return _BURST


def device_weights(probe: bool = False, reps: int = 3) -> list[float]:
    """Relative throughput weights for column splitting (getGPUWeights
    feeding --fork, src/cuda_util.cpp:191).  Uniform by default (a
    homogeneous slice); ``probe=True`` times a small matmul burst on
    every device and weights by measured min-of-N throughput — the
    analogue of the reference's per-GPU bandwidth probe.  The timing
    includes dispatch jitter; use explicit weights when exactness
    matters."""
    import jax

    devs = jax.devices()
    if not probe or len(devs) < 2:
        return [1.0] * len(devs)

    import time

    import jax.numpy as jnp

    burst = _probe_burst()
    weights = []
    for d in devs:
        x = jax.device_put(jnp.ones((256, 512), jnp.int32), d)
        float(burst(x)[0, 0])                 # compile/warm (the scalar
        best = None                           # pull forces completion)
        for _ in range(reps):
            t0 = time.time()
            float(burst(x)[0, 0])
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        weights.append(1.0 / max(best, 1e-9))
    lo = min(weights)
    return [w / lo for w in weights]


def select_device(fork_id: int):
    """Device for process `fork_id` (selectGPU, cuda_util.cpp:287)."""
    import jax

    devs = jax.devices()
    return devs[fork_id % len(devs)]


def format_device_list() -> str:
    lines = ["available devices:"]
    for d in list_devices():
        lines.append(
            f"  [{d['id']}] {d['platform']} {d['kind']} "
            f"(process {d['process']})"
        )
    return "\n".join(lines)


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def kernel_route() -> str:
    """THE platform decision: which strip kernel this process runs.

    ``"cuda"`` on a GPU (the Hopper kernel, ops/cuda/strip_kernel.cu),
    ``"scan"`` on the CPU (the lax.scan twin: tests and development).
    Any other platform is an error — there is no silent fallback."""
    import jax

    platform = jax.default_backend()
    if platform == "gpu":
        return "cuda"
    if platform == "cpu":
        return "scan"
    raise RuntimeError(f"no strip kernel for platform {platform!r}")


def visible_gpus() -> list[str]:
    """The GPU ids this process may hand to children, without touching
    JAX: CUDA_VISIBLE_DEVICES when set, else one id per card nvidia-smi
    lists (none where there is no nvidia-smi)."""
    import subprocess

    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [x.strip() for x in env.split(",") if x.strip()]
    try:
        r = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if r.returncode != 0:
        return []
    n = sum(1 for ln in r.stdout.splitlines() if ln.startswith("GPU "))
    return [str(k) for k in range(n)]


def compile_cache_dir() -> str:
    """Where JAX's persistent compilation cache lives:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``
    (a fixed path — the path is part of the cache key)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO, ".jax_cache"))


def enable_persistent_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache (compile_cache_dir).
    When JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and no
    other directory is set here.  Returns the directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
