"""Deterministic, order-independent named random streams (the port's copy
of multi_spatialmllm_tpu/core/rng.py without `jax_key`): every (seed,
*names) gets its own numpy PCG64 generator seeded from a SHA-256 of the
names, so the mixture's epoch order and the QA engines' draws are the JAX
package's, draw for draw."""

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


# Engine seeds preserved from the reference as canonical defaults:
#   camera_movement: 0 (camera_movement_engine_train_val.py:17-18)
#   object_perception: 1 (single_object_perception_engine.py:14-15)
#   visual_correspondence: 2 (…dot_2_multichoice.py:11-12)
#   depth_perception: 4 (depth_estimation_coor_engine.py:15-16)
#   object_movement: 0 (single_object_movement_engine_coord.py:21-23)
ENGINE_SEEDS = {
    "camera_movement": 0,
    "object_perception": 1,
    "visual_correspondence": 2,
    "depth_perception": 4,
    "object_movement": 0,
    "frame_relations": 0,
    "coverage": 0,
}
