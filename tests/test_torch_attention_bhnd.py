"""The port's MHSA over separate q, k, v ``[B, H, N, d]`` on the CPU, where
kernels I/I′ and J/J′ take their plain versions (``attention_reference``
and ``attention_bhnd_backward_reference``), against the TPU kernels they
replace: the JAX package's ``attention_pallas`` (v1, tokens padded to 128)
and ``fused_attention_v2`` (v2, unpadded), run in interpret mode on the CPU
as ``tests/test_ops_attention.py`` runs them, on the same numpy inputs: the
output and dq, dk, dv through ``jax.vjp``, in fp32 at ragged N (130 pads to
256 in v1). Then the dispatch: ``multi_head_attention`` against the JAX
one for each ``impl``, with and without dropout, and ``attention_pallas``'s
switch to the blockwise kernels L/L′ between 640 and 641 tokens at
head_dim 64, read off the routing function with no large tensors.

Tolerance 1e-5: fp32 on both sides, the same products summed in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.ops import attention as jattn
from gavit_tpu_torch.ops import attention as tattn
from gavit_tpu_torch.ops import philox


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5
B, H, D = 2, 2, 16
ENTRY = {"v1": (jattn.attention_pallas, tattn.attention_pallas),
         "v2": (jattn.fused_attention_v2, tattn.fused_attention_v2)}


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed + n)
    return [rng.standard_normal((B, H, n, D)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("entry", ["v1", "v2"])
@pytest.mark.parametrize("n", [7, 37, 130])
def test_plain_versions_match_jax_kernels(entry, n):
    jfn, tfn = ENTRY[entry]
    scale = D ** -0.5
    q, k, v, g = _inputs(n)
    want, vjp = jax.vjp(lambda q, k, v: jfn(q, k, v, scale),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = tfn(tq, tk, tv, scale)
    got.backward(torch.from_numpy(g))
    assert got.shape == (B, H, n, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)
    for t, w, name in zip((tq, tk, tv), want_grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla", "reference"])
def test_multi_head_attention_matches_jax_for_every_impl(monkeypatch, impl):
    """Each ``impl`` against the JAX package's ``multi_head_attention`` with
    the same ``impl`` on the same fp32 inputs ('auto' and 'pallas' reach
    ``attention_pallas`` in interpret mode, 'xla' jax.nn's attention), with
    no dropout; then at dropout 0.5, the port armed with the keep mask
    ``jax.random.bernoulli`` draws from the JAX call's key: 'auto' and
    'reference' drop the same probabilities, 'pallas' and 'xla' raise on
    both sides."""
    q, k, v, _ = _inputs(9)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = jattn.multi_head_attention(q, k, v, impl=impl)
    got = tattn.multi_head_attention(tq, tk, tv, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)

    rate, drng = 0.5, jax.random.key(5)
    keep = np.array(jax.random.bernoulli(drng, 1.0 - rate, (B, H, 9, 9)))
    monkeypatch.setattr(tattn.philox, "keep_mask",
                        lambda shape, *a, **kw: torch.from_numpy(keep))
    if impl in ("pallas", "xla"):
        with pytest.raises(ValueError, match="does not support"):
            jattn.multi_head_attention(q, k, v, 0.3, impl=impl,
                                       dropout_rate=rate, dropout_rng=drng)
        with pytest.raises(ValueError, match="does not support"):
            tattn.multi_head_attention(tq, tk, tv, 0.3, impl=impl,
                                       dropout_rate=rate, seed=11, site=4)
        return
    want = jattn.multi_head_attention(q, k, v, 0.3, impl=impl,
                                      dropout_rate=rate, dropout_rng=drng)
    got = tattn.multi_head_attention(tq, tk, tv, 0.3, impl=impl,
                                     dropout_rate=rate, seed=11, site=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_multi_head_attention_routes_every_impl(monkeypatch):
    """As attention.py:1138-1148: 'reference', and 'auto' with dropout, go
    to the plain attention with the Philox mask of (seed, site); 'xla' to
    the plain attention; 'pallas' with dropout raises; the rest to
    ``attention_pallas``; without a seed there is no dropout."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(9))
    calls = []
    real = tattn.attention_pallas
    monkeypatch.setattr(tattn, "attention_pallas",
                        lambda *a: calls.append(a) or real(*a))
    plain = tattn.attention_reference(q, k, v, D ** -0.5)
    for impl in ("auto", "pallas", "xla", "reference"):
        out = tattn.multi_head_attention(q, k, v, impl=impl)
        torch.testing.assert_close(out, plain, rtol=0, atol=TOL)
    assert len(calls) == 2  # 'auto' and 'pallas'

    calls.clear()
    keep = philox.keep_mask((B, H, 9, 9), 11, 4, 0.5)
    want = tattn.attention_reference(q, k, v, 0.3, 0.5, keep)
    for impl in ("auto", "reference"):
        out = tattn.multi_head_attention(q, k, v, 0.3, impl=impl,
                                         dropout_rate=0.5, seed=11, site=4)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert not calls
    assert not torch.allclose(want, tattn.attention_reference(q, k, v, 0.3))
    with pytest.raises(ValueError, match="does not support"):
        tattn.multi_head_attention(q, k, v, impl="pallas", dropout_rate=0.5,
                                   seed=11, site=4)
    with pytest.raises(ValueError, match="site"):
        tattn.multi_head_attention(q, k, v, dropout_rate=0.5, seed=11)
    # a rate with no seed is no dropout, as a rate with no rng in JAX
    out = tattn.multi_head_attention(q, k, v, impl="pallas",
                                     dropout_rate=0.5)
    torch.testing.assert_close(out, plain, rtol=0, atol=TOL)


def test_pallas_route_switches_where_jax_does():
    """N up to 640 at head_dim 64 takes I (its 128-padded length fits the
    exact kernels' budget), 641 on the blockwise L, in bf16 and fp32; the
    port's copy of ``_v3_fits`` is the JAX package's."""
    for dtype, itemsize in ((torch.bfloat16, 2), (torch.float32, 4)):
        assert tattn.pallas_route(1, 64, dtype) == "I"
        assert tattn.pallas_route(640, 64, dtype) == "I"
        assert tattn.pallas_route(641, 64, dtype) == "L"
        for n in (128, 640, 768, 1024):
            assert tattn._v3_fits(n, 64, itemsize) == jattn._v3_fits(
                n, 64, itemsize)
    assert tattn._round_up(641, 128) == jattn._round_up(641, 128) == 768


def test_route_l_takes_the_blockwise_plain_versions():
    """Past the switch ``attention_pallas`` packs q, k, v into L's rows and
    saves o and lse (the blockwise plain versions on the CPU); its gradients
    agree with the exact ones; J stays on the exact pair at any N."""
    n, d = 641, 64
    rng = np.random.default_rng(1)
    qkv = [torch.from_numpy(rng.standard_normal((1, 1, n, d)).astype(
        np.float32)).requires_grad_(True) for _ in range(3)]
    out = tattn.attention_pallas(*qkv, d ** -0.5)
    assert type(out.grad_fn).__name__ == "_FusedQkvAttentionBackward"
    assert len(out.grad_fn.saved_tensors) == 3  # rows, o, lse
    g = torch.from_numpy(rng.standard_normal((1, 1, n, d)).astype(np.float32))
    got = torch.autograd.grad(out, qkv, g)
    out2 = tattn.fused_attention_v2(*qkv, d ** -0.5)
    assert type(out2.grad_fn).__name__ == "_BhndAttentionBackward"
    want = torch.autograd.grad(out2, qkv, g)
    torch.testing.assert_close(out, out2, rtol=0, atol=TOL)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-5)


def test_entry_points_refuse_mismatched_operands():
    q = torch.zeros(1, 2, 5, 16)
    with pytest.raises(ValueError, match="one"):
        tattn.attention_pallas(q, q[:, :1], q, 0.25)
    with pytest.raises(ValueError, match="one"):
        tattn.fused_attention_v2(q, q, q.double(), 0.25)
    for entry in ("v1", "v2"):
        with pytest.raises(ValueError, match="CUDA"):
            tattn.bhnd_kernel(entry, False, q.bfloat16(), q.bfloat16(),
                              q.bfloat16(), 0.25)
