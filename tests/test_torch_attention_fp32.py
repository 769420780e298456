"""fp32 attention at every length: the routes the port takes for fp32 rows
against the JAX dispatcher's, the kernels' wrappers and entry points taking
fp32 up to the device check, and a tiny fp32 model past the exact
attention's fp32 bound against the JAX package.

* ``attention_route`` and ``plain_route`` in fp32 and bf16 at every N up to
  1200 against ``gavit_tpu.ops.attention._v3_fits`` at head_dim 64 (the
  JAX ``fused_qkv_attention`` leaves its exact v3 kernels for the
  blockwise v5 where it fails): fp32 A up to 416, K 417-708, L from 709;
  bf16 A up to 224, K up to 749, L past it;
* K, K′, L and L′ (``qkv_attention_long_kernel``, ``..._long_bwd_kernel``,
  ``..._large_kernel``, ``..._large_bwd_kernel``) and I/J, I′/J′
  (``bhnd_kernel``) take fp32 rows and stop at the CPU tensor; on fake
  CUDA tensors ``fused_qkv_attention`` routes fp32 rows of 577 and 709
  tokens to K's and L's custom ops, and the ``[B, H, N, d]`` entry points
  take fp32 at head_dim 64 and refuse other widths naming the ROADMAP
  item;
* ViT with one fp32 block at 432 px (N = 730: past the fp32 bound, inside
  bf16's): loss, logits and every gradient against ``jax.value_and_grad``
  within 1e-4, both packages on their blockwise attention (JAX
  ``flash_attention_large`` in interpret mode, the port the plain versions
  of L/L′).

The card holds the fp32 kernels themselves to these plain versions
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). At most 3 tests a file
(``.claude/skills/verify/SKILL.md``).
"""

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.ops import attention as jattn
from gavit_tpu.training import losses as jlosses
from gavit_tpu_torch.ops import attention as tattn
from gavit_tpu_torch.training.losses import DynamicWeightedLoss
from gavit_tpu_torch.utils.convert import flax_layout
from test_torch_model_large import _spy, inputs, seeded_params
from test_torch_train_step import (_assert_tree_close, jax_loss_fn,
                                   port_model)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fp32_routes_hold_the_jax_exact_bound():
    for dtype, itemsize, a_max, k_max in ((torch.float32, 4, 416, 708),
                                          (torch.bfloat16, 2, 224, 749)):
        assert tattn.A_MAX_N[dtype] == a_max
        assert tattn.K_MAX_N[dtype] == k_max
        for n in range(1, 1201):
            exact = jattn._v3_fits(n, 64, itemsize)
            want = "A" if n <= a_max else "K" if exact else "L"
            assert tattn.attention_route(n, dtype) == want, (dtype, n)
            assert tattn.plain_route(n, dtype) == ("A" if exact else "L"), (
                dtype, n)
        assert jattn._v3_fits(k_max, 64, itemsize)
        assert not jattn._v3_fits(k_max + 1, 64, itemsize)


class _Ops(TorchDispatchMode):
    """The names of the operators a call dispatches."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def test_fp32_wrappers_and_entry_points_take_fp32():
    f32, d = torch.float32, 64
    scale = d ** -0.5
    for n in (577, 709):
        qkv = torch.zeros(1, n, 3 * d)
        do = torch.zeros(1, 1, n, d)
        lse = torch.zeros(1, 1, n)
        large = n > tattn.K_MAX_N[f32]
        calls = [lambda: tattn.qkv_attention_large_kernel(qkv, scale, 1),
                 lambda: tattn.qkv_attention_large_bwd_kernel(
                     qkv, do, lse, do, scale, 1)]
        if not large:
            calls += [lambda: tattn.qkv_attention_long_kernel(qkv, scale, 1),
                      lambda: tattn.qkv_attention_long_bwd_kernel(
                          qkv, do, scale, 1)]
        q = torch.zeros(1, 1, n, d)
        calls += [lambda e=e: tattn.bhnd_kernel(e, False, q, q, q, scale)
                  for e in ("v1", "v2")]
        calls += [lambda e=e: tattn.bhnd_kernel(e, True, q, q, q, q, scale)
                  for e in ("v1", "v2")]
        for call in calls:
            with pytest.raises(ValueError, match="CUDA"):
                call()
    # on fake CUDA tensors: the route's custom op for fp32 rows of 577
    # (K) and 709 (L) tokens, and the [B, H, N, d] entry points' check
    with FakeTensorMode():
        for n, op in ((577, "attention_long_fwd"),
                      (709, "attention_large_fwd")):
            qkv = torch.empty(2, n, 3, 2, d, device="cuda")
            with _Ops() as ops:
                out = tattn.fused_qkv_attention(qkv, scale)
            assert f"gavit_tpu_torch.{op}.default" in ops.seen
            assert not any("matmul" in f or "softmax" in f for f in ops.seen)
            assert out.shape == (2, n, 2, d) and out.dtype == f32
        q = torch.empty(1, 2, 50, d, device="cuda")
        assert tattn._card_kernels(q, q, q, "attention_pallas")
        narrow = torch.empty(1, 2, 50, 32, device="cuda")
        with pytest.raises(NotImplementedError, match="Queue 2 item 10.7"):
            tattn._card_kernels(narrow, narrow, narrow, "attention_pallas")


def raw_config():
    """ViT with one block at 432 px, patch 16 (N = 27² + 1 = 730), head_dim
    64, no graph block, fp32."""
    return {
        "model": {"name": "custom", "img_size": 432, "patch_size": 16,
                  "embed_dim": 64, "depth": 1, "num_heads": 1,
                  "num_classes": 14, "drop_rate": 0.0,
                  "graph": {"enabled": False}},
        "data": {"image_size": 432, "batch_size": 1},
        "training": {"precision": "fp32"},
    }


def test_fp32_model_past_the_exact_bound_matches_jax(monkeypatch):
    raw = raw_config()
    params = seeded_params(raw)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 432, 432, 3)).astype(np.float32)
    _, labels, pos_weight = inputs()
    calls = []
    for module, name in ((jattn, "flash_attention_large"),
                         (tattn, "blockwise_attention_reference"),
                         (tattn, "blockwise_attention_backward_reference"),
                         (tattn, "attention_reference")):
        _spy(monkeypatch, module, name, calls)
    jmodel = jax_build_model(jax_from_dict(raw).model, precision="fp32")
    jparams = {"model": params,
               "criterion": jlosses.init_criterion_params()}
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jax_loss_fn(jmodel, x, labels, pos_weight), has_aux=True))(jparams)
    assert calls == ["flash_attention_large"]

    calls.clear()
    model = port_model(raw, params)
    logits = model(torch.from_numpy(x), seed=0)
    loss, _ = DynamicWeightedLoss()(logits, torch.from_numpy(labels),
                                    torch.from_numpy(pos_weight))
    loss.backward()
    assert calls == ["blockwise_attention_reference",
                     "blockwise_attention_backward_reference"]
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jlogits), atol=1e-4, rtol=0)
    assert abs(loss.item() - float(jloss)) <= 1e-4
    grads: dict = {}
    for path, (p, transpose) in flax_layout(model).items():
        node = grads
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = p.grad.numpy().T if transpose else p.grad.numpy()
    _assert_tree_close(grads, jax.tree.map(np.asarray, jgrads["model"]),
                       rel=1e-4)
