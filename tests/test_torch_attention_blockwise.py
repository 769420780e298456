"""The plain versions of the blockwise attention kernels L and L′
(``gavit_tpu_torch.ops.attention.blockwise_attention_reference`` and
``blockwise_attention_backward_reference``) against the TPU kernels they
replace: the JAX package's ``flash_attention_large`` (``_fwd_kernel_v5``,
and through ``jax.vjp`` ``_dq_kernel_v5`` and ``_dkv_kernel_v5``), run in
interpret mode on the CPU as ``tests/test_ops_attention.py`` runs it, on the
same numpy inputs: o, the fp32 log-sum-exp and dq, dk, dv, in fp32 at a
ragged N (300 pads to two 256-key blocks there) and at an exact block
multiple. Then the port's route boundaries in bf16 and fp32 and what route
'L' saves for the backward.

Tolerances: 2e-5 (o, lse) and 5e-5 (gradients), the JAX package's own for
v5 against its reference: fp32 on both sides, sums in another order (the
blockwise online softmax against one pass over the row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.ops import attention as jattn
from gavit_tpu_torch.ops import attention as tattn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FWD_TOL, GRAD_TOL = 2e-5, 5e-5
# bf16 gradients of the blockwise and the exact plain versions: each rounds
# p and ds to bf16 at other points (2^-8 relative a rounding), relative to
# the largest gradient, as the card's checks hold bf16 gradients
BF16_GRAD_REL_TOL = 2e-2


def test_route_boundaries_and_fp32_refusal():
    """bf16 rows go to K up to 749 tokens and to L from 750 at any length,
    fp32 rows past kernel A's 416 to K up to 708 and to L from 709: where
    the JAX dispatcher leaves the exact v3 kernels for v5 at each itemsize.
    Off the card the plain versions switch at the same N. fp32 is no longer
    refused: L's wrapper takes fp32 rows up to its device check."""
    bf, f32 = torch.bfloat16, torch.float32
    assert tattn.attention_route(749, bf) == "K"
    assert tattn.attention_route(750, bf) == "L"
    assert tattn.attention_route(4097, bf) == "L"
    assert jattn._v3_fits(749, 64, 2) and not jattn._v3_fits(750, 64, 2)
    assert tattn.plain_route(749, bf) == "A"
    assert tattn.plain_route(750, bf) == "L"
    assert tattn.attention_route(417, f32) == "K"
    assert tattn.attention_route(708, f32) == "K"
    assert tattn.attention_route(709, f32) == "L"
    assert tattn.attention_route(4097, f32) == "L"
    assert jattn._v3_fits(708, 64, 4) and not jattn._v3_fits(709, 64, 4)
    assert tattn.plain_route(708, f32) == "A"
    assert tattn.plain_route(709, f32) == "L"
    for dtype in (bf, f32):
        with pytest.raises(ValueError, match="CUDA"):
            tattn.qkv_attention_large_kernel(
                torch.zeros(1, 750, 3 * 64, dtype=dtype), 0.125, 1)


@pytest.mark.parametrize("n,saved,dtype", [
    pytest.param(749, 1, torch.bfloat16, id="749-1"),
    pytest.param(750, 3, torch.bfloat16, id="750-3"),
    pytest.param(708, 1, torch.float32, id="708-1-fp32"),
    pytest.param(709, 3, torch.float32, id="709-3-fp32")])
def test_route_l_saves_o_and_lse(n, saved, dtype):
    """Past K_MAX_N of the dtype (749 in bf16, 708 in fp32) the autograd
    node keeps the rows, o and the fp32 lse (as ``_fa5_fwd``), and its
    backward reads them: the same gradients as autograd through the exact
    plain forward (in bf16 within its rounding, 2e-2 of the largest
    gradient, as on the card). Below, only the rows."""
    b, h, d = 1, 1, 16
    rng = np.random.default_rng(n)
    qkv = torch.from_numpy(rng.standard_normal(
        (b, n, 3 * h * d)).astype(np.float32)).to(dtype).requires_grad_(True)
    out = tattn.fused_qkv_attention(qkv.view(b, n, 3, h, d), d ** -0.5,
                                    merge_heads=False)
    held = out.grad_fn.saved_tensors
    assert len(held) == saved
    if saved == 3:
        assert torch.equal(held[1], out)
        assert held[2].shape == (b, h, n) and held[2].dtype == torch.float32
    g = torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
    (got,) = torch.autograd.grad(out, qkv, g)
    leaf = qkv.detach().requires_grad_(True)
    exact = tattn.attention_reference(*tattn._split_heads(leaf, h),
                                      d ** -0.5)
    (want,) = torch.autograd.grad(exact, leaf, g)
    assert got.dtype == want.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GRAD_TOL,
                                   rtol=0)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_GRAD_REL_TOL * want.float().abs().max().item()
