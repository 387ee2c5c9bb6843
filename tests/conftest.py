"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated on CPU.  Tests marked ``gpu`` need the
card: they skip here and run on a GPU machine with
``MASA_TEST_GPU=1 python -m pytest -m gpu tests/`` (MASA_TEST_GPU leaves
the platform to JAX instead of forcing the CPU).
"""

import os

ON_GPU = bool(os.environ.get("MASA_TEST_GPU"))
if not ON_GPU:
    # tests never claim an accelerator unless asked to
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """The GPU for a gpu-marked test; skips when this run has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with MASA_TEST_GPU=1 on "
                    "the card)")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def random_dna(rng, n, alphabet=b"ACGT"):
    return np.frombuffer(
        bytes(rng.choice(list(alphabet), size=n).astype(np.uint8)),
        dtype=np.uint8,
    ).copy()


@pytest.fixture
def dna():
    def make(n, seed=0, alphabet=b"ACGT"):
        r = np.random.default_rng(seed)
        return r.choice(np.frombuffer(alphabet, np.uint8), size=n).astype(
            np.uint8
        )

    return make


def mutate(rng, seq, sub_rate=0.1, indel_rate=0.05):
    """Derive a homologous sequence: substitutions + short indels."""
    out = []
    bases = np.frombuffer(b"ACGT", np.uint8)
    i = 0
    n = len(seq)
    while i < n:
        r = rng.random()
        if r < indel_rate / 2:
            out.extend(rng.choice(bases, size=rng.integers(1, 5)))
        elif r < indel_rate:
            i += int(rng.integers(1, 5))
        elif r < indel_rate + sub_rate:
            out.append(rng.choice(bases))
            i += 1
        else:
            out.append(seq[i])
            i += 1
    return np.array(out, dtype=np.uint8)


@pytest.fixture
def homolog():
    def make(seq, seed=1, sub_rate=0.1, indel_rate=0.05):
        r = np.random.default_rng(seed)
        return mutate(r, seq, sub_rate, indel_rate)

    return make
