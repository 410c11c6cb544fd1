"""Deterministic, order-independent named random streams (the port's copy
of multi_spatialmllm_tpu/core/rng.py `stream`): every (seed, *names) gets
its own numpy PCG64 generator seeded from a SHA-256 of the names, so the
mixture's epoch order is the JAX package's, draw for draw."""

from __future__ import annotations

import hashlib

import numpy as np


def _digest(seed: int, names: tuple) -> bytes:
    h = hashlib.sha256()
    h.update(str(int(seed)).encode())
    for name in names:
        h.update(b"\x00")
        h.update(str(name).encode())
    return h.digest()


def stream(seed: int, *names) -> np.random.Generator:
    """A numpy Generator unique to (seed, *names)."""
    return np.random.Generator(
        np.random.PCG64(int.from_bytes(_digest(seed, names)[:8], "little"))
    )
