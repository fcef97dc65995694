"""The JAX package's fused write transform on shared inputs, computed once.

The reference compiles one program per batch shape and mode (a few
seconds in store mode, about ten in compress mode on one CPU core), so
each (shape, bytes, mode) is run once per process and shared by every
test that compares the port with it. Inputs come from a numpy seed.
"""

import functools

import jax
import numpy as np

from ceph_tpu import registry as jregistry
from ceph_tpu.osd import fused_transform as jft
from ceph_tpu_torch import registry


def profile(k: int, m: int) -> dict:
    return {"technique": "reed_sol_van", "k": str(k), "m": str(m), "w": "8"}


def make_batch(shape, kind: str, seed: int = 0) -> np.ndarray:
    """Low-entropy bytes (values 0..3, the bench's own data) or random."""
    rng = np.random.default_rng(seed)
    high = 4 if kind == "low" else 256
    return rng.integers(0, high, size=shape, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def jax_codec(k: int, m: int):
    return jregistry.factory("jax_tpu", profile(k, m))


@functools.lru_cache(maxsize=None)
def port_codec(k: int, m: int):
    return registry.factory("torch_cuda", profile(k, m), device="cpu")


@functools.lru_cache(maxsize=None)
def reference(m: int, shape: tuple, kind: str, mode: str,
              seed: int = 0) -> dict:
    """Host dict of the JAX package's run_fused (do not mutate)."""
    codec = jax_codec(shape[1], m)
    return jax.device_get(jft.run_fused(codec, make_batch(shape, kind, seed),
                                        mode=mode))
