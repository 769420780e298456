"""The port's inference MLP (gavit_tpu_torch.ops.mlp) against the JAX
package's ``fused_mlp_inference`` (off the TPU it runs ``_chain_infer``, the
function tests/test_mlp_fused.py holds the TPU kernel to), on the same numpy
inputs: tanh GELU in bf16, erf GELU in fp32.

Tolerances: 1e-5 in fp32 (fp32 products, summation order only); 2e-2 in
bf16 (h and y are rounded to bf16, one ulp is 2^-8 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.ops import mlp as jmlp
from gavit_tpu_torch.ops import mlp as tmlp

D, F = 64, 256


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 17, D)).astype(np.float32)
    w1 = (rng.standard_normal((D, F)) * 0.1).astype(np.float32)  # [in, out]
    b1 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((F, D)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(D) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("dtype,approximate,tol", [
    ("fp32", False, 1e-5),
    ("bf16", True, 2e-2),
])
def test_fused_mlp_inference_matches_jax(dtype, approximate, tol):
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    x, w1, b1, w2, b2 = _inputs()
    want = jmlp.fused_mlp_inference(
        *(jnp.asarray(a, jdt) for a in (x, w1, b1, w2, b2)), approximate)
    # the port takes nn.Linear's [out, in] weights
    t = [torch.from_numpy(a).to(tdt) for a in (x, w1.T.copy(), b1,
                                                w2.T.copy(), b2)]
    got = tmlp.fused_mlp_inference(*t, approximate=approximate)
    assert got.shape == x.shape and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


def test_gelu_form_follows_approximate():
    """tanh and erf GELU differ by up to ~3e-4 per element; the chain must
    apply the one it is asked for (fp32, so the difference is visible)."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(1))
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    x2 = x.reshape(-1, D)
    h = x2 @ w1t.t() + b1
    for approximate, form in ((True, "tanh"), (False, "none")):
        want = torch.nn.functional.gelu(h, approximate=form) @ w2t.t() + b2
        got = tmlp._chain_infer(x2, w1t, b1, w2t, b2, approximate)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert not torch.allclose(tmlp._chain_infer(x2, w1t, b1, w2t, b2, True),
                              tmlp._chain_infer(x2, w1t, b1, w2t, b2, False),
                              atol=1e-6)


def test_cpu_bf16_takes_plain_version_and_kernel_refuses_cpu():
    x, w1, b1, w2, b2 = (torch.from_numpy(a).bfloat16() for a in _inputs(2))
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    before = tmlp.KERNEL_LAUNCHES
    tmlp.fused_mlp_inference(x, w1t, b1, w2t, b2)
    assert tmlp.KERNEL_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tmlp.mlp_inference_kernel(x.reshape(-1, D), w1t, b1, w2t, b2, True)
    with pytest.raises(TypeError, match="bfloat16"):
        tmlp.mlp_inference_kernel(x.reshape(-1, D).float(), w1t, b1, w2t,
                                  b2, True)
