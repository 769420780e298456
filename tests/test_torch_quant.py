"""The port's int8 quantisation against gavit_tpu's on the CPU.

* The ops bit-equal to the JAX ones on the same inputs (``assert_array_equal``
  on int8 codes, scales and fp32 outputs): ``quantize_rowwise`` along each
  axis, ``quantize_activation_static`` with exact .5 ties (round half to
  even), all-zero rows (the 1e-8 scale floor), ``static_int8_matmul`` and
  ``int8_matmul``, in fp32 and from bf16 inputs; the int8 GEMM's padding
  (M ≤ 16, N = 14) exact against the unpadded sum; the fake-quant forward
  and straight-through gradients within 1e-7.
* The bridge round-trips a quant tree and a model's quant state.
* ``jax_site_inputs`` and ``site_codes``: each quantised site's input on
  the JAX side and its int8 codes against the port's, for
  ``tests/test_torch_quant_parity.py`` (the int8 model against the JAX one)
  and ``tests/test_torch_qat.py``.

Tiny model: 32 px, patch 8, embed 32, one block and a kNN graph block
after it (k 4, gate 0.5), 2 heads; one torch thread.
"""

from __future__ import annotations

import contextlib

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.models.layers import HeadMergeProj as JaxHeadMergeProj
from gavit_tpu.models.layers import QDense
from gavit_tpu.ops import quant as jq
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models.layers import HeadMergeProj
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.ops import quant as q
from gavit_tpu_torch.utils.convert import (flatten_tree, load_flax_params,
                                           load_quant_state, quant_from_flax,
                                           quant_sites, quant_state,
                                           quant_to_flax, to_flax_tree)

GATE = 0.5

# one block and the graph block after it: every kind of quantised site, at
# half the compile time of two blocks
TINY = {
    "model": {"name": "custom", "img_size": 32, "patch_size": 8,
              "embed_dim": 32, "depth": 1, "num_heads": 2, "num_classes": 14,
              "graph": {"enabled": True, "num_blocks": 1, "adjacency": "knn",
                        "k": 4, "insert_after": [0]}},
    "data": {"image_size": 32},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_model(precision="fp32", qat=False, raw=TINY):
    model = init_params(build_model(from_dict(raw).model,
                                    precision=precision, qat=qat),
                        torch.Generator().manual_seed(0))
    with torch.no_grad():
        for gb in model.graphs:
            gb.gate.fill_(GATE)
    return model


def images(n=3, seed=1, size=32):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _ties(rng, shape, scale):
    """Values on exact half steps of ``scale`` (a power of two), so x/scale
    lands on .5 ties, with some whole-step values and an all-zero row."""
    x = (rng.integers(-300, 300, shape) + 0.5 * rng.integers(0, 2, shape)) \
        * scale
    x[0] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_ops_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    x = _ties(rng, (5, 3, 64), 2.0 ** -6)
    x[1, 2] = 0.0                                      # an all-zero row
    w = rng.standard_normal((64, 24)).astype(np.float32)  # JAX [K, N]
    w[:, 3] = 0.0                                      # an all-zero column
    act_scale = np.float32(2.0 ** -6)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert np.array_equal(np.asarray(jx.astype(jnp.float32)),
                          tx.float().numpy())

    for axis in (-1, 0):
        jqx, js = jq.quantize_rowwise(jx, axis=axis)
        tqx, ts = q.quantize_rowwise(tx, axis=axis)
        np.testing.assert_array_equal(tqx.numpy(), np.asarray(jqx))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    codes = q.quantize_activation_static(tx, torch.tensor(act_scale))
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jq.quantize_activation_static(jx,
                                                                act_scale)))
    halves = np.abs(x / act_scale - np.trunc(x / act_scale)) == 0.5
    assert halves.sum() > 100  # the ties are exercised

    # the static product: w quantised once (the port's w_q is [N, K])
    jwq, jws = jq.quantize_rowwise(jnp.asarray(w), axis=0)
    tw = torch.from_numpy(w.T.copy())
    twq, tws = q.quantize_rowwise(tw, axis=-1)
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq).T)
    tws = tws.reshape(1, -1)
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
    want = jq.static_int8_matmul(jx, jwq, jws, act_scale)
    got = q.static_int8_matmul(tx, twq, tws, torch.tensor(act_scale))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # dynamic PTQ
    np.testing.assert_array_equal(
        q.int8_matmul(tx, tw).numpy(),
        np.asarray(jq.int8_matmul(jx, jnp.asarray(w))))


@pytest.mark.parametrize("m,n", [(1, 14), (16, 14), (17, 24), (40, 16)])
def test_int8_gemm_padding_is_exact(m, n):
    """The card wrapper's zero padding (M to 17, K and N to multiples of
    8) and slice give the unpadded sums: held on the CPU through the same
    padding the wrapper applies, against the plain version."""
    rng = np.random.default_rng(m)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, 36)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (n, 36)).astype(np.int8))
    mp, kp, np_ = max(m, 17), 40, -(-n // 8) * 8
    xp = torch.nn.functional.pad(xq, (0, kp - 36, 0, mp - m))
    wp = torch.nn.functional.pad(wq, (0, kp - 36, 0, np_ - n))
    padded = q.int8_mm_reference(xp, wp)[:m, :n]
    exact = xq.long() @ wq.long().t()
    np.testing.assert_array_equal(padded.numpy(), exact.numpy())
    np.testing.assert_array_equal(q.int8_mm(xq, wq).numpy(), exact.numpy())
    with pytest.raises(TypeError, match="int8"):
        q.int8_mm(xq.float(), wq)


def test_fake_quant_forward_and_ste_match_jax():
    rng = np.random.default_rng(3)
    s = np.float32(0.1)  # range ±12.7
    x = (rng.standard_normal((4, 33)) * 8).astype(np.float32)
    x[0, :4] = [0.05, -0.15, 12.7, -12.75]  # ties and the clip edge
    g = rng.standard_normal(x.shape).astype(np.float32)
    y, vjp = jax.vjp(lambda v: jq.fake_quant_act(v, s), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    ty = q.fake_quant_act(tx, torch.tensor(s))
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), atol=1e-7,
                               rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(g)[0]),
                               atol=1e-7, rtol=0)
    assert (tx.grad.numpy() == 0).any()  # the clipped STE is exercised

    w = rng.standard_normal((16, 8)).astype(np.float32)  # JAX [K, N]
    yw, vjpw = jax.vjp(jq.fake_quant_weight, jnp.asarray(w))
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    tyw = q.fake_quant_weight(tw)
    gw = rng.standard_normal((8, 16)).astype(np.float32)
    tyw.backward(torch.from_numpy(gw))
    np.testing.assert_allclose(tyw.detach().numpy(), np.asarray(yw).T,
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(),
                               np.asarray(vjpw(gw.T)[0]).T, atol=1e-7, rtol=0)


# --- the int8 model against the JAX one -----------------------------------

def jax_site_inputs(jmodel, variables, x, **kw):
    """``jmodel.apply(variables, x, **kw)`` with the input of every
    quantised site recorded (heads merged for ``HeadMergeProj``, as its
    quant path merges them): ``(output, {flax path: input})``. Traceable:
    call it under ``jax.jit``."""
    seen = {}

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and isinstance(
                mod, (QDense, JaxHeadMergeProj)):
            a = args[0]
            if isinstance(mod, JaxHeadMergeProj):
                b, h, n, d = a.shape
                a = a.transpose(0, 2, 1, 3).reshape(b, n, h * d)
            seen["/".join(mod.path)] = a
        return next_fun(*args, **kwargs)

    with flax_nn.intercept_methods(intercept):
        out = jmodel.apply(variables, x, **kw)
    return out, seen


@contextlib.contextmanager
def site_codes(model, jax_inputs, scales, pin: bool):
    """While active, each quantised site of the port's ``model`` compares
    the int8 codes of its input (against its act scale) with the codes of
    the JAX model's input to the same site (``jax_inputs``, merged heads
    for the attention projection) and counts the ones that differ in the
    dict it yields, ``{path: (flips, codes, gap)}``, ``gap`` the largest
    distance between the two inputs in codes (each clipped to ±127). With ``pin`` it takes the
    JAX input's value where a code flips (the gradient still flows through
    its own input): as chip_smoke.py replays MoE expert choices, the
    comparison then holds the arithmetic, and the counts say how many
    codes the port would have taken otherwise."""
    counts, hooks = {}, []

    def hook(mod, args, path):
        x = args[0]
        want = torch.from_numpy(np.array(jax_inputs[path], np.float32))
        if isinstance(mod, HeadMergeProj):
            b, h, n, d = x.shape
            want = want.reshape(b, n, h, d).transpose(1, 2)
        s = torch.as_tensor(np.float32(scales[path]))

        def code(v):
            return torch.clamp(torch.round(v.detach().float() / s), -127,
                               127)
        flip = code(x) != code(want)
        gap = (torch.clamp(x.detach().float() / s, -127, 127)
               - torch.clamp(want / s, -127, 127)).abs().max()
        counts[path] = (int(flip.sum()), flip.numel(), float(gap))
        if pin and flip.any():
            x = torch.where(flip, x + (want.to(x.dtype) - x).detach(), x)
        return (x,)

    for path, mod in quant_sites(model).items():
        hooks.append(mod.register_forward_pre_hook(
            lambda m, args, path=path: hook(m, args, path)))
    try:
        yield counts
    finally:
        for h in hooks:
            h.remove()


def test_quant_bridge_round_trips():
    rng = np.random.default_rng(9)
    model = tiny_model("int8")
    flat = {}
    for path, mod in quant_sites(model).items():
        n, k = mod.weight.shape
        flat[path] = {
            "act_scale": np.float32(rng.uniform(0.01, 1.0)),
            "w_q": rng.integers(-127, 128, (k, n)).astype(np.int8),
            "w_scale": rng.uniform(0.01, 1, (1, n)).astype(np.float32)}
    tree = {}
    for path, node in flat.items():
        parent = tree
        for key in path.split("/"):
            parent = parent.setdefault(key, {})
        parent.update(node)
    state = quant_from_flax(tree)
    load_quant_state(model, state)
    back = flatten_tree(quant_to_flax(quant_state(model)))
    assert back.keys() == flatten_tree(tree).keys()
    for key, val in flatten_tree(tree).items():
        assert back[key].dtype == val.dtype
        np.testing.assert_array_equal(back[key], val)
    with pytest.raises(KeyError, match="no such quantised site"):
        load_quant_state(model, {"blocks_9/attn/qkv": {}})
    with pytest.raises(ValueError, match="shape"):
        load_quant_state(model, {"head": {"w_scale": np.zeros((1, 3))}})
    # the state stays out of state_dict: checkpoints keep their keys
    plain = tiny_model("fp32")
    assert model.state_dict().keys() == plain.state_dict().keys()
    load_flax_params(plain, to_flax_tree(model))
