"""``nn.functional_call`` of paddle_tpu_torch against paddle_tpu's, on the
CPU (the reference's functional bridge, ``paddle_tpu/nn/layer.py:369``).

A small layer written alike in both packages (a Linear, a Dropout, a
buffer that each call reassigns, a second method) runs with an explicit
state made with numpy from a seed: the output, a named method, a bound
rng stream and the mutable buffers against the reference's, and the
gradient with respect to the state against ``jax.grad``. fp32 products of
at most 6 terms agree to ~1e-7; atol 1e-6. With the same "dropout" key
bound on both sides the masks are the reference's bit for bit
(``tests/test_torch_dropout.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu.nn.layer import functional_call as jcall
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional_call as tcall

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(6, 4)
        self.drop = jnn.Dropout(0.5)
        self.register_buffer("seen", jnp.zeros(()))

    def forward(self, x):
        self.seen = self.seen + jnp.sum(x)
        return self.drop(self.fc(x))

    def energy(self, x, scale=1.0):
        return scale * jnp.mean(self(x) ** 2)


class TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(6, 4, device="cpu")
        self.drop = tnn.Dropout(0.5)
        self.register_buffer("seen", torch.zeros(()))

    def forward(self, x):
        self.seen = self.seen + torch.sum(x)
        return self.drop(self.fc(x))

    def energy(self, x, scale=1.0):
        return scale * torch.mean(self(x) ** 2)


def _pair(train):
    paddle_tpu.seed(0)
    jm, tm = JNet(), TNet()
    for m in (jm, tm):
        m.train() if train else m.eval()
    r = np.random.RandomState(0)
    state = {"fc.weight": r.randn(6, 4).astype(np.float32),
             "fc.bias": r.randn(4).astype(np.float32),
             "seen": np.float32(0.5)}
    x = r.randn(3, 6).astype(np.float32)
    return jm, tm, state, x


def _jstate(state):
    return {k: jnp.asarray(v) for k, v in state.items()}


def _tstate(state, grad=False):
    return {k: torch.tensor(v, requires_grad=grad and k != "seen")
            for k, v in state.items()}


def test_output_and_gradient_match_the_reference():
    """eval: the output with the state bound, and the gradient of its sum
    of squares with respect to the state's parameters (jax.grad against
    torch's autograd through functional_call); the layer's own tensors
    are back in place afterwards, and the state's untouched."""
    jm, tm, state, x = _pair(train=False)
    own = {k: v.clone() for k, v in tm.state_dict().items()}
    ref = jcall(jm, _jstate(state), jnp.asarray(x))
    ts = _tstate(state, grad=True)
    out = tcall(tm, ts, torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    (out ** 2).sum().backward()
    grads = jax.grad(lambda s: jnp.sum(jcall(jm, s, jnp.asarray(x)) ** 2))(
        _jstate(state))
    for k in ("fc.weight", "fc.bias"):
        np.testing.assert_allclose(ts[k].grad.numpy(), np.asarray(grads[k]),
                                   atol=1e-5, err_msg=k)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, own[k]), k
    assert float(ts["seen"]) == 0.5
    with pytest.raises(KeyError, match="nope"):
        tcall(tm, {"nope": torch.zeros(())}, torch.from_numpy(x))
    with pytest.raises(KeyError, match="nope"):
        jcall(jm, {"nope": jnp.zeros(())}, jnp.asarray(x))


def test_method_and_its_arguments():
    """method= runs the named method (here one that calls forward) with its
    positional and keyword arguments, against the reference's."""
    jm, tm, state, x = _pair(train=False)
    ref = jcall(jm, _jstate(state), jnp.asarray(x), scale=3.0,
                method="energy")
    out = tcall(tm, _tstate(state), torch.from_numpy(x), scale=3.0,
                method="energy")
    np.testing.assert_allclose(out.item(), float(ref), atol=ATOL)


@pytest.mark.parametrize("seed", [1, 7])
def test_rngs_bind_the_dropout_stream(seed):
    """train mode, rngs={"dropout": key}: the same key on both sides gives
    the reference's dropped output (the mask bit for bit: the zeros fall
    on the same entries), another key another mask; two calls with one
    key give the same output."""
    jm, tm, state, x = _pair(train=True)
    key = jax.random.PRNGKey(seed)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    ref = np.asarray(jcall(jm, _jstate(state), jnp.asarray(x),
                           rngs={"dropout": key}))
    out = tcall(tm, _tstate(state), torch.from_numpy(x),
                rngs={"dropout": tkey}).numpy()
    np.testing.assert_array_equal(out == 0, ref == 0)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    again = tcall(tm, _tstate(state), torch.from_numpy(x),
                  rngs={"dropout": tkey}).numpy()
    np.testing.assert_array_equal(again, out)
    other = tcall(tm, _tstate(state), torch.from_numpy(x),
                  rngs={"dropout": tkey + 1}).numpy()
    assert not np.array_equal(other == 0, out == 0)


def test_mutable_returns_the_new_buffers():
    """mutable=True: (out, new_buffers), the buffer as the call left it
    (the state's 0.5 plus the input's sum), as the reference returns it;
    the layer's own buffer stays 0."""
    jm, tm, state, x = _pair(train=False)
    ref, jb = jcall(jm, _jstate(state), jnp.asarray(x), mutable=True)
    out, tb = tcall(tm, _tstate(state), torch.from_numpy(x), mutable=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert set(tb) == set(jb) == {"seen"}
    np.testing.assert_allclose(float(tb["seen"]), float(jb["seen"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(tb["seen"]), 0.5 + x.sum(), atol=1e-5)
    assert float(tm.seen) == 0.0
