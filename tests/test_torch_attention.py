"""The port's attention (gavit_tpu_torch.ops.attention) against the JAX
package's: the v4 fused kernel ``_fused_qkv_flat`` (Pallas, interpret mode on
the CPU) and ``attention_reference``, the v3 pair ``_fused_qkv5`` (kernels K
and K′, forward and ``jax.vjp``) against the port's plain versions, and the
port's route against the JAX dispatcher's choice at ViT-B's shapes, on the
same numpy inputs.

Tolerances: 1e-5 in fp32, where both sides take fp32 products and differ
only in summation order; 2e-2 in bf16, where the outputs are rounded to bf16
(one ulp is 2^-8 relative) and a sum in another order can land an ulp away.
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


TOL = {"fp32": 1e-5, "bf16": 2e-2}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, H, D = 2, 4, 16


def _qkv(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, n, 3 * H * D)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n", [17, 13])
def test_fused_qkv_attention_matches_jax(n, dtype):
    jdt, tdt = DTYPES[dtype]
    qkv = _qkv(n, n)
    scale = D ** -0.5
    jq = jnp.asarray(qkv, jdt)
    want_kernel = np.asarray(jattn._fused_qkv_flat(jq, scale, H, D),
                             np.float32)
    q5 = jq.reshape(B, n, 3, H, D).transpose(2, 0, 3, 1, 4)
    want_ref = np.asarray(jattn.attention_reference(q5[0], q5[1], q5[2],
                                                    scale), np.float32)
    tq = torch.from_numpy(qkv).to(tdt).view(B, n, 3, H, D)
    got = tattn.fused_qkv_attention(tq, scale, merge_heads=False)
    assert got.shape == (B, H, n, D) and got.dtype == tdt
    got = got.float().numpy()
    np.testing.assert_allclose(got, want_kernel, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=TOL[dtype], rtol=0)


def test_merge_heads_layout_and_reference_impl():
    qkv = torch.from_numpy(_qkv(17, 0)).view(B, 17, 3, H, D)
    out4 = tattn.fused_qkv_attention(qkv, 0.25, merge_heads=False)
    merged = tattn.fused_qkv_attention(qkv, 0.25)
    assert merged.shape == (B, 17, H, D)
    torch.testing.assert_close(merged, out4.transpose(1, 2), rtol=0, atol=0)
    ref = tattn.fused_qkv_attention(qkv, 0.25, merge_heads=False,
                                    impl="reference")
    torch.testing.assert_close(ref, out4, rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        tattn.fused_qkv_attention(qkv, 0.25, impl="pallas")


def test_cpu_tensor_takes_plain_version_and_kernel_refuses_it():
    """A CPU tensor goes to the plain version without counting a launch;
    the kernel wrapper itself raises on it rather than computing."""
    before = tattn.KERNEL_LAUNCHES
    qkv = torch.from_numpy(_qkv(13, 1))
    tattn.fused_qkv_attention(qkv.view(B, 13, 3, H, D), 0.25)
    assert tattn.KERNEL_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tattn.qkv_attention_kernel(
            torch.zeros(1, 13, 3 * H * 64), 0.125, H)


@pytest.mark.parametrize("dtype,n,error,match", [
    # fp32 rows past A′'s 416 tokens take K′ or L′ (their id kept from
    # when the route refused them)
    pytest.param(torch.float32, 417, NotImplementedError, "K′ or L′",
                 id="dtype0-417-NotImplementedError-Queue 1 item 10"),
    (torch.bfloat16, 225, NotImplementedError, "N <= 224"),
    (torch.bfloat16, 577, NotImplementedError, "K′ or L′"),
    (torch.bfloat16, 197, ValueError, "CUDA"),
    (torch.float32, 13, ValueError, "CUDA"),
])
def test_attention_bwd_kernel_refuses_before_the_card(dtype, n, error, match):
    """Kernel A′'s wrapper refuses what its kernels do not take (rows past
    ``A_MAX_N`` of their dtype: fp32 past 416 tokens, bf16 past 224, which
    take K′ or L′) before
    it looks at the device or builds anything, so a CPU tensor meets the
    same error as a CUDA one; rows it takes, in either dtype, are refused
    on the CPU for their device rather than computed. No launch is
    counted."""
    before = (tattn.BWD_KERNEL_LAUNCHES, tattn.BWD_F32_KERNEL_LAUNCHES)
    qkv = torch.zeros(1, n, 3 * 64, dtype=dtype)
    with pytest.raises(error, match=match):
        tattn.qkv_attention_bwd_kernel(qkv, torch.zeros(1, 1, n, 64,
                                                        dtype=dtype),
                                       0.125, 1)
    assert (tattn.BWD_KERNEL_LAUNCHES,
            tattn.BWD_F32_KERNEL_LAUNCHES) == before


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n", [40, 33])
def test_long_attention_plain_versions_match_jax_v3(n, dtype):
    """K's and K′'s plain versions against the TPU kernels they replace
    (``_fused_qkv5``: ``_fwd_kernel_v3`` and, through ``jax.vjp``,
    ``_bwd_kernel_v3``), B 1, H 2, d 16, on the v3 layout [B, 3, H, N, d]."""
    jdt, tdt = DTYPES[dtype]
    b, h, d = 1, 2, 16
    scale = d ** -0.5
    rng = np.random.default_rng(n)
    qkv = rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)
    dout = rng.standard_normal((b, h, n, d)).astype(np.float32)
    q5 = jnp.asarray(qkv, jdt).reshape(b, n, 3, h, d).transpose(0, 2, 3, 1, 4)
    want, vjp = jax.vjp(lambda x: jattn._fused_qkv5(x, scale), q5)
    (dq5,) = vjp(jnp.asarray(dout, jdt))

    tq = torch.from_numpy(qkv).to(tdt)
    got = tattn.attention_reference(*tattn._split_heads(tq, h), scale)
    dgot = tattn.attention_backward_reference(
        tq, torch.from_numpy(dout).to(tdt), scale, h)
    assert got.dtype == dgot.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype],
                               rtol=0)
    # dqkv rows [B, N, 3·H·d] → [B, 3, H, N, d]
    dgot5 = dgot.float().reshape(b, n, 3, h, d).permute(0, 2, 3, 1, 4)
    np.testing.assert_allclose(dgot5.numpy(), np.asarray(dq5, np.float32),
                               atol=TOL[dtype], rtol=0)


def test_route_picks_the_jax_dispatchers_family():
    """At ViT-B's shapes (12 heads, d 64, bf16) the JAX dispatcher takes v4
    at 224 px (N=197), v3 at 384 px (N=577) and the blockwise v5 past v3's
    bound (512 px, N=1025), where the port takes A, K and L; in fp32 the
    same families, A up to 416 tokens, K up to v3's fp32 bound (708), L
    past it."""
    bf = torch.bfloat16
    assert jattn._v4_fits(12, 197, 64, 2)
    assert tattn.attention_route(197, bf) == "A"
    assert not jattn._v4_fits(12, 577, 64, 2) and jattn._v3_fits(577, 64, 2)
    assert tattn.attention_route(577, bf) == "K"
    k_max = tattn.K_MAX_N[bf]
    assert jattn._v3_fits(k_max, 64, 2) and not jattn._v3_fits(k_max + 1,
                                                              64, 2)
    assert tattn.attention_route(k_max, bf) == "K"
    assert tattn.attention_route(k_max + 1, bf) == "L"
    assert not jattn._v3_fits(1025, 64, 2)
    assert tattn.attention_route(1025, bf) == "L"
    assert tattn.attention_route(225, bf) == "K"
    f32 = torch.float32
    assert tattn.attention_route(416, f32) == "A"
    assert tattn.attention_route(417, f32) == "K"
    assert tattn.attention_route(577, f32) == "K"
    k_max = tattn.K_MAX_N[f32]
    assert jattn._v3_fits(k_max, 64, 4) and not jattn._v3_fits(k_max + 1,
                                                              64, 4)
    assert tattn.attention_route(k_max, f32) == "K"
    assert tattn.attention_route(k_max + 1, f32) == "L"
    assert tattn.attention_route(1025, f32) == "L"
