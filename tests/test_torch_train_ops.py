"""The port's training ops against the JAX package's on the same numpy
inputs, on the CPU: the attention VJP (``_fused_qkv_flat``, the Pallas v4
kernels in interpret mode), the training MLP (``fused_mlp``, its XLA path
off the TPU) at rate 0, the graph op's closed-form backward (``_fga_bwd``
through ``_fused_small``, whose forward is the Pallas kernel in interpret
mode) and ``train_preprocess`` with the same draws.

Tolerances: fp32 products on both sides differ only in summation order, so
1e-5 of the largest magnitude of each compared tensor (1e-6 for
preprocessing); the bf16 attention gradients are rounded to bf16 on both
sides (one ulp is 2^-8 relative) and get 2e-2 of the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.ops import attention as jattn
from gavit_tpu.ops import graph_ops as jg
from gavit_tpu.ops import mlp as jmlp
from gavit_tpu.ops import preprocess as jpre
from gavit_tpu_torch.ops import attention as tattn
from gavit_tpu_torch.ops import graph_ops as tg
from gavit_tpu_torch.ops import mlp as tmlp
from gavit_tpu_torch.ops import preprocess as tpre


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max err {err:.3e} > {rel} x {scale:.3e}"


B, H, D = 2, 2, 32


@pytest.mark.parametrize("dtype,rel", [("fp32", 1e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("n", [17, 13])
def test_attention_vjp_matches_jax(n, dtype, rel):
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(n)
    qkv = rng.standard_normal((B, n, 3 * H * D)).astype(np.float32)
    g = rng.standard_normal((B, H, n, D)).astype(np.float32)
    scale = D ** -0.5
    out, vjp = jax.vjp(lambda q: jattn._fused_qkv_flat(q, scale, H, D),
                       jnp.asarray(qkv, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))

    got = tattn.attention_backward_reference(
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(g).to(tdt), scale, H)
    assert got.dtype == tdt
    _close(got.float().numpy(), want, rel)

    # the same through autograd and the module-level op
    q = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    o = tattn.fused_qkv_attention(q.view(B, n, 3, H, D), scale,
                                  merge_heads=False)
    _close(o.detach().float().numpy(), out, rel)
    o.backward(torch.from_numpy(g).to(tdt))
    _close(q.grad.float().numpy(), want, rel)


def test_training_mlp_matches_jax_fused_mlp():
    """fp32, rate 0: y and every gradient (the weights in nn.Linear's
    layout against the JAX [in, out] kernels)."""
    rng = np.random.default_rng(0)
    d, f = 64, 256
    x = rng.standard_normal((2, 17, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    seed = jnp.asarray([3], jnp.int32)
    y, vjp = jax.vjp(
        lambda *a: jmlp.fused_mlp(*a, seed, 0.0, 0.0),
        *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    want = vjp(jnp.asarray(gy))

    args = [torch.from_numpy(a.copy()).requires_grad_(True)
            for a in (x, w1.T, b1, w2.T, b2)]
    got = tmlp.fused_mlp(*args, None, (0, 1), 0.0, 0.0)
    _close(got.detach().numpy(), y, 1e-5)
    got.backward(torch.from_numpy(gy))
    for a, w, transpose in zip(args, want, (False, True, False, True, False)):
        grad = a.grad.numpy()
        _close(grad.T if transpose else grad, w, 1e-5)


MODES = [("knn", 4, 0.0, 1.0), ("threshold", 8, 0.1, 0.5),
         ("dense", 8, 0.0, 2.0)]


@pytest.mark.parametrize("mode,k,thr,temp", MODES)
def test_graph_backward_matches_jax_and_autograd(mode, k, thr, temp):
    rng = np.random.default_rng(1)
    t = rng.standard_normal((2, 16, 32)).astype(np.float32)
    v = rng.standard_normal((2, 16, 32)).astype(np.float32)
    g = rng.standard_normal((2, 16, 32)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jg._fused_small(a, b, mode, k, thr, temp),
                     jnp.asarray(t), jnp.asarray(v))
    want_t, want_v = vjp(jnp.asarray(g))

    tt, tv, tgr = (torch.from_numpy(a) for a in (t, v, g))
    adj = tg.build_adjacency(tt, mode=mode, k=k, threshold=thr,
                             temperature=temp)
    got_t, got_v = tg.graph_backward(tt, tv, adj, tgr, temp)
    _close(got_t.numpy(), want_t, 1e-5)
    _close(got_v.numpy(), want_v, 1e-5)

    # torch.autograd through the plain forward with the selection fixed
    a = tt.clone().requires_grad_(True)
    b = tv.clone().requires_grad_(True)
    mask = adj > 0
    logits = torch.where(mask, tg.cosine_similarity(a) / temp, tg._NEG_INF)
    out = tg.graph_aggregate(torch.softmax(logits, -1), b)
    out.backward(tgr)
    _close(got_t.numpy(), a.grad.numpy(), 1e-5)
    _close(got_v.numpy(), b.grad.numpy(), 1e-5)

    # and through the op's own autograd function
    a2 = tt.clone().requires_grad_(True)
    b2 = tv.clone().requires_grad_(True)
    tg.fused_graph_aggregate(a2, b2, mode, k, thr, temp).backward(tgr)
    _close(a2.grad.numpy(), want_t, 1e-5)
    _close(b2.grad.numpy(), want_v, 1e-5)


def test_train_preprocess_matches_jax():
    """JAX's ``train_preprocess(use_affine=False)`` against the port's with
    the draws JAX made (the same key splits as gavit_tpu/ops/preprocess.py),
    and the port's own draws from a generator are in range."""
    imgs = np.random.default_rng(2).integers(0, 256, (6, 32, 32, 3),
                                             np.uint8)
    key = jax.random.key(11)
    want = np.asarray(jpre.train_preprocess(jnp.asarray(imgs), key,
                                            use_affine=False))
    kf, _, kj = jax.random.split(key, 3)
    flip = jax.random.bernoulli(kf, 0.5, (6, 1, 1, 1))
    kb, kc = jax.random.split(kj)
    bf = jax.random.uniform(kb, (6, 1, 1, 1), minval=0.8, maxval=1.2)
    cf = jax.random.uniform(kc, (6, 1, 1, 1), minval=0.8, maxval=1.2)
    got = tpre.train_preprocess_with(
        torch.from_numpy(imgs), torch.from_numpy(np.array(flip).ravel()),
        torch.from_numpy(np.array(bf).ravel()),
        torch.from_numpy(np.array(cf).ravel()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert np.asarray(flip).any() and not np.asarray(flip).all()

    gen = torch.Generator().manual_seed(0)
    x = tpre.train_preprocess(torch.from_numpy(imgs), gen)
    lo = (0 - np.array(tpre.IMAGENET_MEAN)) / np.array(tpre.IMAGENET_STD)
    hi = (1 - np.array(tpre.IMAGENET_MEAN)) / np.array(tpre.IMAGENET_STD)
    assert x.shape == (6, 32, 32, 3) and x.dtype == torch.float32
    assert (x.numpy() >= lo - 1e-6).all() and (x.numpy() <= hi + 1e-6).all()
    # with RandomAffine: in range (zero fill normalises to the bottom of
    # it), and not the transform without it from the same generator state
    warped = tpre.train_preprocess(torch.from_numpy(imgs),
                                   torch.Generator().manual_seed(0),
                                   use_affine=True)
    plain = tpre.train_preprocess(torch.from_numpy(imgs),
                                  torch.Generator().manual_seed(0))
    assert warped.shape == (6, 32, 32, 3) and warped.dtype == torch.float32
    assert (warped.numpy() >= lo - 1e-6).all()
    assert (warped.numpy() <= hi + 1e-6).all()
    assert not torch.equal(warped, plain)
