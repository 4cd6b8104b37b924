"""K8 and K9's CPU side: paddle_tpu_torch.ops.rms_norm against
paddle_tpu.ops.rms_norm, and the shared-memory probe's refusals.

* The plain ``rms_norm`` (the default path, and what ``rms_norm_cuda``
  runs on CPU tensors) against the JAX ``_rms_norm_ref`` — the contract
  ``tests_tpu/test_pallas_parity.py`` holds ``_rms_norm_pallas`` to — on the
  same numpy input, bf16 and fp32, with and without a weight, (…, d)
  inputs, at the widths of K8's two kernels (up to 4096 the one-pass
  kernel's, 8192 the two-pass kernel's on bf16 rows). fp32: atol 1e-6,
  rtol 1e-6 (the mean's sum in another order).
  bf16: within two bf16 ulp (rtol 2^-6; one ulp is up to 2^-7 of the
  value): the fp32 normalised value may round to bf16 on either side of a
  boundary, and the weight product rounds that difference again.
* ``probe_usable_smem_bytes`` raises off a CUDA device, as the reference's
  probe raises off a TPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.rms_norm import _rms_norm_ref
from paddle_tpu_torch.ops import rms_norm as trn
from paddle_tpu_torch.ops import smem_probe
from paddle_tpu_torch.utils.convert import array_to_tensor


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("with_weight", [True, False])
@pytest.mark.parametrize("shape", [(4, 8, 256), (12, 1024), (8, 4096),
                                   (2, 8192)])
def test_rms_norm_matches_jax_reference(dtype, with_weight, shape):
    r = np.random.RandomState(shape[-1])
    xj = jnp.asarray(r.randn(*shape) * 3 + 0.5, dtype)
    wj = (jnp.asarray(1 + 0.2 * r.randn(shape[-1]), dtype) if with_weight
          else None)
    ref = np.asarray(_rms_norm_ref(xj, wj, 1e-5), np.float32)
    xt = array_to_tensor(np.asarray(xj))
    wt = None if wj is None else array_to_tensor(np.asarray(wj))
    trn.rms_norm_cuda.launches = 0
    for fn in (trn.rms_norm, trn.rms_norm_cuda):
        out = fn(xt, wt, 1e-5)
        assert out.dtype == xt.dtype and tuple(out.shape) == shape
        if dtype == jnp.float32:
            np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)
        else:
            np.testing.assert_allclose(out.float().numpy(), ref, atol=0,
                                       rtol=2 ** -6)
    assert trn.rms_norm_cuda.launches == 0


def test_smem_probe_refuses_non_cuda_devices():
    with pytest.raises(RuntimeError, match="CUDA device"):
        smem_probe.probe_usable_smem_bytes("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            smem_probe.probe_usable_smem_bytes()
    assert smem_probe.smem_probe_cuda.launches == 0
