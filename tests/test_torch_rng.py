"""paddle_tpu_torch.core.rng (threefry2x32 port) against jax.random.

PRNGKey, fold_in, the 32-bit bits, uniform and categorical must equal JAX
bit for bit (jax_threefry_partitionable=True layout). gumbel goes through
log, which XLA's CPU backend and torch round differently in the last bit:
it is held to 4 float32 ulp (or 1e-6 absolute where -log(u) is near 1 and
the outer log cancels); the categorical draws built on it are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import rng


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = [0, 1, 42, 123456, 2 ** 31 - 1]


def _np(a):
    return np.asarray(a).astype(np.int64)


def test_partitionable_mode_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in(seed):
    kj = jax.random.PRNGKey(seed)
    kt = rng.PRNGKey(seed)
    assert np.array_equal(_np(kj), kt.numpy())
    for data in (0, 1, 7, 1023, 2 ** 31 - 1):
        assert np.array_equal(_np(jax.random.fold_in(kj, data)),
                              rng.fold_in(kt, data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (37,), (3, 5), (2, 3, 129)])
def test_bits_and_uniform(seed, shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    kt = rng.fold_in(rng.PRNGKey(seed), 3)
    assert np.array_equal(_np(jax.random.bits(kj, shape)),
                          rng.random_bits(kt, shape).numpy())
    assert np.array_equal(np.asarray(jax.random.uniform(kj, shape)),
                          rng.uniform(kt, shape).numpy())


def test_gumbel_within_a_few_ulp():
    kj = jax.random.PRNGKey(5)
    g_j = np.asarray(jax.random.gumbel(kj, (4096,)))
    g_t = rng.gumbel(rng.PRNGKey(5), (4096,)).numpy()
    ulp = np.spacing(np.abs(g_j).astype(np.float32))
    assert np.all(np.abs(g_j - g_t) <= 4 * ulp + 1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_shared_and_per_row(seed):
    logits = np.random.RandomState(seed % 997).randn(4, 300).astype(np.float32)
    logits[1, ::3] = -np.inf                    # masked entries, as top-k does
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 9)
    kt = rng.fold_in(rng.PRNGKey(seed), 9)
    assert np.array_equal(
        np.asarray(jax.random.categorical(kj, jnp.asarray(logits))),
        rng.categorical(kt, torch.from_numpy(logits)).numpy())
    seeds = np.arange(4, dtype=np.uint32) + np.uint32(seed)
    rows_j = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    rows_j = jax.vmap(jax.random.fold_in, in_axes=(0, None))(rows_j, 11)
    rows_t = rng.fold_in(rng.PRNGKey(torch.from_numpy(seeds.astype(np.int64))),
                         11)
    assert np.array_equal(_np(rows_j), rows_t.numpy())
    cj = jax.vmap(lambda k, l: jax.random.categorical(k, l))(
        rows_j, jnp.asarray(logits))
    assert np.array_equal(np.asarray(cj),
                          rng.categorical(rows_t, torch.from_numpy(logits))
                          .numpy())


def test_global_seed_streams_are_reproducible():
    rng.seed(3)
    a = [rng.next_generator("cpu").initial_seed() for _ in range(3)]
    rng.seed(3)
    b = [rng.next_generator("cpu").initial_seed() for _ in range(3)]
    assert a == b and len(set(a)) == 3
