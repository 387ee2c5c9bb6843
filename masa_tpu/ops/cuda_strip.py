"""Build, load and call the CUDA wavefront strip kernel
(ops/cuda/strip_kernel.cu) through the XLA foreign function interface.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, from
the tracked source only, into ``ops/cuda/_build/`` (listed in
``.gitignore``); the file name carries a hash of the source and flags, so
an edited kernel is never served from a stale build.  A failed build is an
error: there is no fallback.

The operand contract (see the kernel's header comment):

  a, init_h, init_e : (R,) int32 strip rows (row-major)
  b, bus_h, bus_f   : (P,) int32 columns; P >= nj
  scal              : (4,) int32 [corner, nj, h_true, flush_every]

``nj``, ``h_true`` and the corner are call data: one compiled kernel
serves every width and height.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

# mirrors of the kernel's compile-time geometry (strip_kernel.cu)
ALPHA = 8             # rows per thread
WARP = 32
BAND = WARP * ALPHA   # rows per warp band
WARPS_PER_BLOCK = 4

TARGET = "masa_strip"

_SRC = os.path.join(os.path.dirname(__file__), "cuda", "strip_kernel.cu")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "cuda", "_build")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")
_REGISTERED = False


def launch_geometry(rows: int) -> tuple[int, int]:
    """(bands, blocks) the kernel launches for a strip of `rows` rows:
    one warp per band of BAND rows, WARPS_PER_BLOCK bands per block."""
    bands = -(-rows // BAND)
    return bands, -(-bands // WARPS_PER_BLOCK)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("CUDA route: nvcc not found (PATH, /usr/local/cuda)")


def library_path() -> str:
    """Build the kernel library if needed; return its path."""
    import jax.ffi

    inc = jax.ffi.include_dir()
    with open(_SRC, "rb") as fh:
        key = hashlib.sha1(fh.read() + repr(_FLAGS).encode()).hexdigest()
    out = os.path.join(_BUILD_DIR, f"libmasa_strip-{key[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_FLAGS, "-I", inc, "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(
            f"CUDA route: kernel build failed ({' '.join(cmd)}):\n"
            f"{r.stderr[-4000:]}")
    os.replace(tmp, out)     # atomic: concurrent fork workers share it
    return out


def register() -> None:
    """Load the library and register the FFI target (idempotent)."""
    global _REGISTERED
    if _REGISTERED:
        return
    import jax.ffi

    lib = ctypes.cdll.LoadLibrary(library_path())
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.MasaStrip),
                                platform="CUDA")
    _REGISTERED = True


def out_types(rows: int, width: int, track: int, lastcol: bool,
              n_int: int):
    """Result shapes of one call, in the handler's order."""
    import jax
    import jax.numpy as jnp

    def s(*shape):
        return jax.ShapeDtypeStruct(shape, jnp.int32)

    bands, _ = launch_geometry(rows)
    return [
        s(width), s(width),                                  # bus_h, bus_f
        s(rows if track else 1), s(rows if track == 2 else 1),  # best
        s(rows if lastcol else 1), s(rows if lastcol else 1),   # lastcol
        s(n_int, width) if n_int else s(1),                  # rows_h
        s(n_int, width) if n_int else s(1),                  # rows_f
        s(bands + 1),                                        # sync
    ]


def call(a, b, bus_h, bus_f, init_h, init_e, scal, *, sw: bool, track: int,
         lastcol: bool, n_int: int, match: int, mismatch: int,
         gap_open: int, gap_ext: int):
    """One kernel launch.  Returns (bus_h, bus_f, best_v, best_j,
    lastcol_h, lastcol_e, rows_h, rows_f); the bus is updated in place
    (aliased to the input, which XLA copies first if it is still live)."""
    import jax

    register()
    rows, width = a.shape[0], bus_h.shape[0]
    outs = jax.ffi.ffi_call(
        TARGET, out_types(rows, width, track, lastcol, n_int),
        input_output_aliases={2: 0, 3: 1},
    )(a, b, bus_h, bus_f, init_h, init_e, scal,
      sw=np.int32(sw), track=np.int32(track), lastcol=np.int32(lastcol),
      match=np.int32(match), mismatch=np.int32(mismatch),
      gap_open=np.int32(gap_open), gap_ext=np.int32(gap_ext))
    return tuple(outs[:8])
