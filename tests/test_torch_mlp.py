"""The port's inference MLP (gavit_tpu_torch.ops.mlp) against the JAX
package's ``fused_mlp_inference`` (off the TPU it runs ``_chain_infer``, the
function tests/test_mlp_fused.py holds the TPU kernel to), on the same numpy
inputs: tanh GELU in bf16, erf GELU in fp32. The training MLP's route: the
row-block rule against the JAX package's ``pick_block``, and the chain (fc1,
H, fc2, F) against the megakernel's plain version, mask for mask.

Tolerances: 1e-5 in fp32 (fp32 products, summation order only); 2e-2 in
bf16 (h and y are rounded to bf16, one ulp is 2^-8 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.ops import mlp as jmlp
from gavit_tpu_torch.ops import mlp as tmlp
from gavit_tpu_torch.ops import philox


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# (embed, hidden) of ViT-S, ViT-B and ViT-L
WIDTHS = [(384, 1536), (768, 3072), (1024, 4096)]


@pytest.mark.parametrize("d,f", WIDTHS)
def test_row_block_rule_matches_pick_block(d, f):
    """bf16 rows of b·197 (224 px) and b·577 (384 px) tokens."""
    for b in (1, 8, 16, 32, 64, 128):
        for n in (197, 577):
            m = b * n
            assert tmlp.has_row_block(m, d, f, 2) == (
                jmlp.pick_block(m, d, f, 2) is not None), (m, d, f)
    # the cases that set the routes of the shipped configurations
    bf = torch.bfloat16
    assert tmlp.mlp_route(16 * 577, 768, 3072, bf) == "chain"
    assert tmlp.mlp_route(16 * 197, 768, 3072, bf) == "chain"
    assert tmlp.mlp_route(32 * 197, 768, 3072, bf) == "fused"
    assert tmlp.mlp_route(128 * 197, 768, 3072, bf) == "fused"
    assert tmlp.mlp_route(128 * 197, 768, 3072, torch.float32) == "chain"


@pytest.mark.parametrize("rate", [0.1, 0.0])
def test_chain_equals_megakernel_plain_version(rate):
    """fc1 → H → fc2 → F (the chain's plain versions) against
    ``mlp_train_reference`` with the same seed and sites, fp32: the same
    zeros, values within 1e-6."""
    rng = np.random.default_rng(5)
    m, d, f = 51, 64, 256
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    w1 = torch.from_numpy((rng.standard_normal((f, d)) * 0.1).astype(
        np.float32))
    b1 = torch.from_numpy((rng.standard_normal(f) * 0.1).astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((d, f)) * 0.1).astype(
        np.float32))
    b2 = torch.from_numpy((rng.standard_normal(d) * 0.1).astype(np.float32))
    seed, sites = philox.step_seed(3, 1), (14, 15)
    chain = tmlp.mlp_train_chain(x, w1, b1, w2, b2, seed, sites, rate, rate)
    fused, _ = tmlp.mlp_train_reference(x, w1, b1, w2, b2, seed, sites, rate,
                                        rate)
    assert torch.equal(chain == 0, fused == 0)
    if rate:
        keep = philox.keep_mask((m, d), seed, sites[1], rate)
        assert bool((chain[~keep] == 0).all()) and bool(keep.any())
    torch.testing.assert_close(chain, fused, rtol=0, atol=1e-6)
