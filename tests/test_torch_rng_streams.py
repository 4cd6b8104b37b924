"""The named RNG streams of paddle_tpu_torch against paddle_tpu.

``core.rng``'s global generator (``global_key``, ``get_rng_state`` /
``set_rng_state``), the stream frames of ``rng_guard`` / ``next_rng_key``
/ ``has_rng``, the TP rng-state tracker and ``bernoulli`` are held to the
JAX package's ``paddle_tpu/core/rng.py`` and ``jax.random``: every key and
every mask bit for bit. Keys cross between the packages as int64 numpy
arrays of their two uint32 words.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.core import rng as jrng
from paddle_tpu_torch.core import rng as trng


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _seed_both():
    """Both global generators start from seed 0, and this test leaves no
    stream frame behind."""
    paddle_tpu.seed(0)
    trng.seed(0)
    yield
    assert not trng.has_rng("dropout") and not jrng.has_rng("dropout")


def _k(key):
    return np.asarray(key).astype(np.int64)


def _t(key):
    return torch.from_numpy(_k(key))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1])
def test_global_key_sequence(seed):
    """seed(s) then global_key() five times: the reference's keys; the
    state (seed, count) reads and restores alike."""
    paddle_tpu.seed(seed)
    trng.seed(seed)
    for _ in range(5):
        assert np.array_equal(_k(jrng.global_key()),
                              trng.global_key().numpy())
    assert trng.get_rng_state() == jrng.get_rng_state() == (seed, 5)
    trng.set_rng_state((seed, 2))
    jrng.set_rng_state((seed, 2))
    assert np.array_equal(_k(jrng.global_key()), trng.global_key().numpy())


def test_fold_in_host_path_equals_tensor_path():
    """fold_in of a host key (2,) by an int runs in Python integers; it
    gives the tensor path's words (data as a tensor) and the reference's."""
    key = trng.fold_in(trng.PRNGKey(7), 3)
    for data in (0, 1, 12345, 2 ** 32 - 1):
        fast = trng.fold_in(key, data)
        slow = trng.fold_in(key, torch.tensor(data))
        assert torch.equal(fast, slow)
        assert np.array_equal(
            fast.numpy(), _k(jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(7), 3), data)))


def test_nested_guards_counters_and_fallback():
    """Keys pulled through nested frames: each stream from the innermost
    frame that binds it, fold_in(frame key, counter), the counters per
    frame; outside every frame the global generator's next key. Every key
    and every counter equals the reference's."""
    a, b = jax.random.PRNGKey(11), jax.random.PRNGKey(12)

    def pulls(r, ka, kb):
        got = []
        with r.rng_guard(dropout=ka, default=ka) as outer:
            got.append(r.next_rng_key("dropout"))
            got.append(r.next_rng_key("default"))
            with r.rng_guard({"dropout": kb}) as inner:
                assert r.has_rng("dropout") and r.has_rng("default")
                assert not r.has_rng("noise")
                got += [r.next_rng_key("dropout") for _ in range(3)]
                got.append(r.next_rng_key("default"))
                inner_c = dict(inner.counters)
            got.append(r.next_rng_key("dropout"))
            outer_c = dict(outer.counters)
        got.append(r.next_rng_key("dropout"))     # no frame: the global one
        got.append(r.global_key())
        return [_k(g) for g in got], inner_c, outer_c

    kj, ij, oj = pulls(jrng, a, b)
    kt, it, ot = pulls(trng, _t(a), _t(b))
    assert ij == it == {"dropout": 3}
    assert oj == ot == {"dropout": 2, "default": 2}
    for x, y in zip(kj, kt):
        assert np.array_equal(x, y)


def test_stream_state_restores_frames_and_counters():
    """stream_state() and restore_stream_state(): a replay from a saved
    state draws the same keys, with the saved frames as the stack even
    after their guard has exited."""
    with trng.rng_guard(dropout=trng.PRNGKey(5)):
        trng.next_rng_key("dropout")
        state = trng.stream_state()
        first = [trng.next_rng_key("dropout") for _ in range(2)]
        g1 = trng.global_key()
    trng.restore_stream_state(state)
    again = [trng.next_rng_key("dropout") for _ in range(2)]
    g2 = trng.global_key()
    trng.restore_stream_state(([], [], trng.get_rng_state()))
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert torch.equal(g1, g2)


@pytest.mark.parametrize("mp_rank", [0, 3])
def test_tracker_and_model_parallel_seed(mp_rank):
    """model_parallel_random_seed registers 'global_seed' and 'local_seed'
    as Fleet TP does; under rng_state(name) the 'dropout' and 'default'
    streams draw the reference's keys. The global generator is reseeded."""
    trng.model_parallel_random_seed(2024, mp_rank)
    jrng.model_parallel_random_seed(2024, mp_rank)
    for name in ("global_seed", "local_seed"):
        with trng.get_rng_state_tracker().rng_state(name):
            kt = [trng.next_rng_key("dropout"), trng.next_rng_key("default"),
                  trng.next_rng_key("dropout")]
        with jrng.get_rng_state_tracker().rng_state(name):
            kj = [jrng.next_rng_key("dropout"), jrng.next_rng_key("default"),
                  jrng.next_rng_key("dropout")]
        for x, y in zip(kj, kt):
            assert np.array_equal(_k(x), y.numpy())
    assert trng.get_rng_state() == (2024, 0)
    assert np.array_equal(_k(jrng.global_key()), trng.global_key().numpy())
    with pytest.raises(KeyError):
        with trng.get_rng_state_tracker().rng_state("nope"):
            pass
    with pytest.raises(ValueError):
        trng.get_rng_state_tracker().add("global_seed", 1)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("shape", [(7,), (3, 5, 33)])
def test_bernoulli(p, shape):
    """bernoulli(key, p, shape) is jax.random.bernoulli's mask bit for
    bit."""
    key = jax.random.fold_in(jax.random.PRNGKey(1), 17)
    got = trng.bernoulli(_t(key), p, shape)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(),
                          np.asarray(jax.random.bernoulli(key, p, shape)))
