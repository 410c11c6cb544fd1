"""The port's threefry streams (multi_spatialmllm_tpu_torch.models.prng)
against `jax.random` (JAX 0.9, partitionable threefry, x64 on as
tests/conftest.py sets it).

Keys, folds, splits, bits and uniforms are compared bit for bit. The
port's Gumbel noise is -log(-log(u)) in float64 rounded to float32, JAX's
is two float32 logs: they must agree within GUMBEL_ULP float32 ulp of
max(1, |g|). `categorical` must draw JAX's token, or else the top two of
`logits + gumbel` lie within twice that bound (asserted, never skipped)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu_torch.models import prng
from test_torch_generate import one_torch_thread  # noqa: F401 (autouse)

GUMBEL_ULP = 4
EPS32 = float(np.finfo(np.float32).eps)
SEEDS = [0, 1, 7, 123, 65535, 2**31 - 1, 2**32, 2**32 + 5, 2**40 + 3, -5,
         2**63 - 1]


def jax_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bit_equal(seed):
    want = jax_words(jax.random.key(seed))
    got = prng.key(seed)
    np.testing.assert_array_equal(got.numpy(), want)
    positions = np.r_[0:300, 2**31 - 1, 2**20 + 7]
    jf = jax.vmap(lambda p: jax.random.key_data(
        jax.random.fold_in(jax.random.key(seed), p)))(
            jnp.asarray(positions, jnp.uint32))
    np.testing.assert_array_equal(
        prng.fold_in(got, torch.as_tensor(positions)).numpy(),
        np.asarray(jf).astype(np.int64))
    np.testing.assert_array_equal(
        prng.split(got, 5).numpy(),
        jax_words(jax.random.split(jax.random.key(seed), 5)))


def test_int32_seed_rule():
    """A batcher's int32 seed slots: the high word is 0 whatever the sign,
    as JAX's `key` gives for an int32 seed inside jit."""
    seeds = np.asarray([0, 5, -3, -2**31, 2**31 - 1], np.int32)
    want = jax.vmap(lambda s: jax.random.key_data(jax.random.key(s)))(
        jnp.asarray(seeds))
    np.testing.assert_array_equal(
        prng.key(torch.from_numpy(seeds)).numpy(),
        np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_bits_and_uniform_bit_equal(seed):
    k = jax.random.key(seed)
    want = jax.random.bits(k, (7, 33), jnp.uint32)
    np.testing.assert_array_equal(prng.bits(prng.key(seed), (7, 33)).numpy(),
                                  np.asarray(want).astype(np.int64))
    u = jax.random.uniform(k, (5000,), jnp.float32)
    np.testing.assert_array_equal(prng.uniform(prng.key(seed), (5000,)),
                                  np.asarray(u))
    tiny = float(np.finfo(np.float32).tiny)
    u = jax.random.uniform(k, (5000,), jnp.float32, minval=tiny, maxval=1.0)
    np.testing.assert_array_equal(
        prng.uniform(prng.key(seed), (5000,), minval=tiny), np.asarray(u))


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_gumbel_within_ulp_bound(seed):
    want = np.asarray(jax.random.gumbel(jax.random.key(seed), (20000,),
                                        jnp.float32))
    got = prng.gumbel(prng.key(seed), (20000,)).numpy()
    bound = GUMBEL_ULP * EPS32 * np.maximum(1.0, np.abs(want))
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def assert_draws_equal(got, want, z):
    """Equal tokens, or a near tie of the port's perturbed logits `z`."""
    for r in np.flatnonzero(got != want):
        top = np.sort(z[r])[-2:]
        assert top[1] - top[0] <= 2 * GUMBEL_ULP * EPS32 * max(
            1.0, abs(top[1])), (r, got[r], want[r], top)


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1, 2**33 + 1])
def test_categorical_equals_jax(seed):
    rng = np.random.default_rng(seed % 1000)
    logits = (3 * rng.standard_normal((16, 700))).astype(np.float32)
    logits[:, ::7] = -np.inf                       # masked entries
    want = np.asarray(jax.random.categorical(jax.random.key(seed), logits))
    got = prng.categorical(prng.key(seed), torch.from_numpy(logits)).numpy()
    z = logits + prng.gumbel(prng.key(seed), logits.shape).numpy()
    assert_draws_equal(got, want, z)
    # one key a row, as the batchers draw: fold(key(seed), position)
    pos = np.arange(40, 56)
    keys = jax.vmap(lambda p: jax.random.fold_in(jax.random.key(seed), p))(
        jnp.asarray(pos))
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    tkeys = prng.fold_in(prng.key(seed), torch.as_tensor(pos))
    got = prng.categorical(tkeys, torch.from_numpy(logits)).numpy()
    z = logits + prng.gumbel(tkeys, (700,)).numpy()
    assert_draws_equal(got, want, z)
