"""The port's unfused grouped MoE engine against gavit_tpu's, fp32 on the CPU
at a tiny size (E=4, D=16, F=32, 4 images of 12 tokens, k=2: T=96 pairs),
the same inputs made with numpy:

* ``group_by_expert``: dest, src and sizes equal to the JAX package's, with
  a hot and an empty expert;
* ``ragged_matmul`` (the plain version of kernel N-gmm and its VJP: N-gmm
  transposed for dx, tgmm for dW) against ``ragged_matmul(impl='megablox',
  interpret=True)`` and its ``jax.grad``, with groups that straddle the
  kernel's 128-row tile boundaries of a longer buffer, an empty expert and
  row counts no tile divides (T = 96 and 300), within 1e-5 of the largest
  value; the transposed form against megablox ``gmm(transpose_rhs=True)``;
* ``tgmm_reference`` (the plain version of kernel tgmm) against megablox
  ``tgmm`` in interpret mode on two packed groupings (an empty expert,
  boundaries inside megablox's row tile, rows past every group) and one
  padded to a row tile;
* ``grouped_moe_mlp`` against the JAX engine with ``matmul_impl=
  'ragged_dot'`` at rate 0: the output and the gradients of x, the gates
  and every weight within 1e-4, erf and tanh GELU; and against the port's
  own fused engine (the plain versions of M, M′, tgmm);
* the unfused engine's masks: kernel F's Philox masks at the MLP's two
  sites, over the ``[T, F]`` and ``[T, D]`` buffers;
* ``model.moe.grouped_remat`` on and off bit-equal (loss and gradients, at
  dropout 0.1), on both engines;
* ``upcycle_params``: the JAX package's, then the bridge, equals the port's
  on the bridged dense tree; the upcycled forward equals the dense one
  within 1e-5 on both engines;
* the ``GAVIT_MOE_FUSED`` / ``GAVIT_MOE_MATMUL`` / ``GAVIT_MOE_AUTO_PAIRS``
  switches pick the engines as the JAX package's gate and crossover do.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.megablox.ops import gmm as jax_gmm

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.models import moe as jmoe
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.ops import moe_grouped as jgrouped
from gavit_tpu_torch.config import MoEConfig, from_dict
from gavit_tpu_torch.models import moe as tmoe
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.ops import gmm as tgmm
from gavit_tpu_torch.ops import moe_fused as tfused
from gavit_tpu_torch.ops import moe_grouped as tgrouped
from gavit_tpu_torch.ops import philox
from gavit_tpu_torch.utils.convert import (flatten_tree, load_flax_params,
                                           to_flax_tree)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


G, S, D, F, E, K = 4, 12, 16, 32, 4, 2


def _idx(case, seed=0):
    """gate_idx [G, S, K] int32: distinct random choices, or every first
    choice on expert 1 ('hot'), or none on experts 0 and 3 ('empty')."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(E)[:K] for _ in range(G * S)])
    if case == "hot":
        idx[:, 0] = 1
        idx[:, 1] = np.where(idx[:, 1] == 1, 2, idx[:, 1])
    elif case == "empty":
        idx[:, 0], idx[:, 1] = 1, 2
    return idx.reshape(G, S, K).astype(np.int32)


def _weights(seed=1, scale=0.2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in ((E, D, F), (E, F), (E, F, D), (E, D))]


def _max_close(got, want, rel, name):
    want = np.asarray(want, np.float32)
    tol = rel * max(np.abs(want).max(), 1e-12)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol, f"{name}: max err {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("case", ["random", "hot", "empty"])
def test_group_by_expert_matches_jax(case):
    idx = _idx(case)
    jd, js, jsz = jgrouped.group_by_expert(jnp.asarray(idx), E)
    td, ts, tsz = tgrouped.group_by_expert(torch.from_numpy(idx), E)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tsz.numpy(), np.asarray(jsz))
    # the kernels take contiguous group sizes as they come
    assert tsz.dtype == torch.int32 and tsz.is_contiguous()
    assert td.shape == idx.shape
    if case == "empty":
        assert tsz[0] == 0 and tsz[3] == 0


# group sizes of T rows: ragged (every boundary inside a 128-row tile of
# the 300-row case), one empty expert, and T not a multiple of the tile
GMM_CASES = {"ragged_empty_pad": (300, [37, 0, 190, 73]),
             "hot_pad": (96, [0, 96, 0, 0]),
             "straddle": (96, [5, 41, 17, 33])}


@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_ragged_matmul_matches_megablox(case):
    t, sizes = GMM_CASES[case]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((t, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) * 0.3).astype(np.float32)
    r = rng.standard_normal((t, F)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)

    def loss(x, w):
        out = jgrouped.ragged_matmul(x, w, jnp.asarray(gs), impl="megablox",
                                     interpret=True)
        return jnp.sum(out * r), out

    (_, jout), (jdx, jdw) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = tgmm.ragged_matmul(tx, tw, torch.from_numpy(gs))
    (out * torch.from_numpy(r)).sum().backward()
    assert out.shape == (t, F)
    _max_close(out.detach().numpy(), jout, 1e-5, "out")
    _max_close(tx.grad.numpy(), jdx, 1e-5, "dx")
    _max_close(tw.grad.numpy(), jdw, 1e-5, "dw")
    # an empty expert gets an exactly zero weight gradient
    for e in np.flatnonzero(gs == 0):
        assert not tw.grad[e].any()


def test_transposed_form_matches_megablox():
    t, sizes = GMM_CASES["ragged_empty_pad"]
    pad = -t % 128
    rng = np.random.default_rng(4)
    y = rng.standard_normal((t + pad, F)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) * 0.3).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    gs[-1] += pad
    want = jax.jit(lambda a, b, g: jax_gmm(
        a, b, g, preferred_element_type=jnp.float32, transpose_rhs=True,
        interpret=True))(jnp.asarray(y), jnp.asarray(w), jnp.asarray(gs))
    got = tgmm.gmm_reference(torch.from_numpy(y), torch.from_numpy(w),
                             torch.from_numpy(gs), transpose_rhs=True)
    _max_close(got.numpy(), want, 1e-5, "gmm transpose_rhs")


# tgmm's groupings: the packed ones above (rows past every group in
# "straddle"), with megablox's row tile inside the groups, and one padded to
# the fused engine's row tile (every group a multiple of tm = 16)
TGMM_CASES = {"ragged_empty_pad": (*GMM_CASES["ragged_empty_pad"], 4),
              "straddle": (*GMM_CASES["straddle"], 8),
              "tm_padded": (128, [32, 16, 0, 80], 16)}


@pytest.mark.parametrize("case", sorted(TGMM_CASES))
def test_plain_tgmm_matches_megablox(case):
    """The plain grouped dW (tgmm_reference, what kernel tgmm is held to on
    the card) against megablox ``tgmm`` in interpret mode: each group's
    ``aᵀ·b`` over its rows, an empty group's exactly zero."""
    t, sizes, tm = TGMM_CASES[case]
    rng = np.random.default_rng(5)
    a = rng.standard_normal((t, D)).astype(np.float32)
    b = rng.standard_normal((t, F)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    backend = importlib.import_module(
        "jax.experimental.pallas.ops.tpu.megablox.gmm")
    want = jax.jit(lambda a, b, g: backend.tgmm(
        a.T, b, g, jnp.float32, (tm, D, F), interpret=True))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(gs))
    got = tgmm.tgmm_reference(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(gs), torch.float32)
    assert got.shape == (E, D, F)
    _max_close(got.numpy(), want, 1e-5, "tgmm")
    for e in np.flatnonzero(gs == 0):
        assert not got[e].any()


def test_plain_gmm_zeroes_rows_past_the_groups():
    x = torch.randn(20, D)
    w = torch.randn(E, D, F)
    out = tgmm.gmm_reference(x, w, torch.tensor([3, 0, 5, 4], dtype=torch.int32))
    assert not out[12:].any()
    torch.testing.assert_close(out[3:8], x[3:8] @ w[2])


def _engine_inputs(case="random", seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, S, D)).astype(np.float32)
    r = rng.standard_normal((G, S, D)).astype(np.float32)
    gv = rng.uniform(0.1, 1.0, (G, S, K)).astype(np.float32)
    return x, r, gv, _idx(case, seed), _weights()


def _torch_engine(engine, x, r, gv, idx, w, **kw):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in [x, gv, *w]]
    out = engine(leaves[0], leaves[1], torch.from_numpy(idx).long(),
                 *leaves[2:], kw.pop("seed", None), (2, 3), **kw)
    (out * torch.from_numpy(r)).sum().backward()
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("case", ["random", "hot"])
def test_unfused_engine_matches_jax(approx, case):
    x, r, gv, idx, w = _engine_inputs(case)

    def loss(x, gv, w):
        out = jgrouped.grouped_moe_mlp(
            x, gv, jnp.asarray(idx), *w, jax.random.PRNGKey(0),
            approx_gelu=approx, matmul_impl="ragged_dot")
        return jnp.sum(out * r), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), jnp.asarray(gv), tuple(jnp.asarray(a) for a in w))
    out, grads = _torch_engine(tgrouped.grouped_moe_mlp, x, r, gv, idx, w,
                               approx_gelu=approx)
    _max_close(out.numpy(), jout, 1e-4, "out")
    want = [jgrads[0], jgrads[1], *jgrads[2]]
    for name, got, ref in zip(("x", "gates", "w1", "b1", "w2", "b2"), grads,
                              want):
        _max_close(got.numpy(), ref, 1e-4, name)


def test_unfused_engine_matches_fused_plain_engine():
    x, r, gv, idx, w = _engine_inputs("random", seed=8)
    got = _torch_engine(tgrouped.grouped_moe_mlp, x, r, gv, idx, w)
    want = _torch_engine(tfused.grouped_moe_mlp_fused, x, r, gv, idx, w)
    _max_close(got[0].numpy(), want[0].numpy(), 1e-4, "out")
    for name, a, b in zip(("x", "gates", "w1", "b1", "w2", "b2"), got[1],
                          want[1]):
        _max_close(a.numpy(), b.numpy(), 1e-4, name)


def test_unfused_engine_masks_are_kernel_f_sites():
    """At rate 0.3 the hidden mask is Philox element row·F + col of the
    [T, F] buffer at the hidden site, the output mask row·D + col of
    [T, D] at the output site: the engine's output equals a hand chain
    with those masks."""
    x, _, gv, idx, w = _engine_inputs("random", seed=9)
    rate, seed = 0.3, philox.step_seed(0, 3)
    tx, tgv = torch.from_numpy(x), torch.from_numpy(gv)
    tidx = torch.from_numpy(idx).long()
    w1, b1, w2, b2 = (torch.from_numpy(a) for a in w)
    out = tgrouped.grouped_moe_mlp(tx, tgv, tidx, w1, b1, w2, b2, seed,
                                   (2, 3), drop=rate)
    dest, src, sizes = tgrouped.group_by_expert(tidx, E)
    xs = tx.reshape(-1, D)[src // K]
    e_row = torch.repeat_interleave(torch.arange(E), sizes.long())
    h = torch.nn.functional.gelu(
        torch.einsum("td,tdf->tf", xs, w1[e_row]) + b1[e_row])
    h = torch.where(philox.keep_mask(h.shape, seed, 2, rate), h / (1 - rate),
                    0.0)
    y = torch.einsum("tf,tfd->td", h, w2[e_row]) + b2[e_row]
    y = torch.where(philox.keep_mask(y.shape, seed, 3, rate), y / (1 - rate),
                    0.0)
    want = (tgv[..., None] * y[dest.reshape(-1)].reshape(G, S, K, D)).sum(2)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)


def tiny_raw(depth=2, every=1, **moe):
    return {
        "model": {"name": "custom", "img_size": 32, "patch_size": 8,
                  "embed_dim": 32, "depth": depth, "num_heads": 2,
                  "num_classes": 14, "drop_rate": 0.1,
                  "graph": {"enabled": True, "num_blocks": 1,
                            "insert_after": [0], "adjacency": "knn",
                            "k": 4},
                  "moe": {"enabled": True, "num_experts": E, "k": 2,
                          "every": every, "impl": "grouped", **moe}},
        "data": {"image_size": 32, "batch_size": 3},
        "training": {"precision": "fp32"},
    }


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "unfused"])
def test_grouped_remat_is_bit_equal(fused, monkeypatch):
    """The engine runs again in the backward of each of the 2 MoE blocks
    (4 calls a step, 2 without remat), with the same bits."""
    monkeypatch.setenv("GAVIT_MOE_FUSED", fused)
    name = "grouped_moe_mlp_fused" if fused == "1" else "grouped_moe_mlp"
    engine, calls = getattr(tmoe, name), []
    monkeypatch.setattr(tmoe, name, lambda *a, **kw: (
        calls.append(1), engine(*a, **kw))[1])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 32, 32, 3)).astype(np.float32))
    out = {}
    for remat in (False, True):
        calls.clear()
        model = init_params(build_model(from_dict(
            tiny_raw(grouped_remat=remat)).model),
            torch.Generator().manual_seed(0)).train()
        assert model.blocks[0].moe.cfg.grouped_remat is remat
        loss = model(x, seed=philox.step_seed(0, 1)).square().sum() \
            + model.moe_aux_loss()
        loss.backward()
        assert len(calls) == (4 if remat else 2)
        out[remat] = (loss.detach(), [p.grad.clone() for p in
                                      model.parameters()])
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


def test_upcycle_matches_jax_and_equals_dense_forward(monkeypatch):
    raw = tiny_raw(depth=4, every=2)
    raw["model"]["drop_rate"] = 0.0
    cfg = from_dict(raw).model
    dense_cfg = dataclasses.replace(cfg, moe=MoEConfig(enabled=False))
    dense = build_model(dense_cfg)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():  # every weight drawn, the biases too
        for p in dense.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    moe_model = init_params(build_model(cfg), torch.Generator().manual_seed(1))
    dense_tree, moe_tree = to_flax_tree(dense), to_flax_tree(moe_model)
    got = tmoe.upcycle_params(dense_tree, moe_tree, cfg)
    want = jmoe.upcycle_params(jax.tree.map(jnp.asarray, dense_tree),
                               jax.tree.map(jnp.asarray, moe_tree),
                               jax_from_dict(raw).model)
    got_flat = flatten_tree(got)
    want_flat = flatten_tree(jax.tree.map(np.asarray, want))
    assert set(got_flat) == set(want_flat)
    for key, val in want_flat.items():
        np.testing.assert_array_equal(got_flat[key], val, err_msg=key)
    assert not got_flat["blocks_1/moe/router"].any()
    assert got_flat["blocks_3/moe/fc1_kernel"].shape == (E, 32, 128)
    # the JAX models build from the same configs (the trees' structure)
    jax_build_model(jax_from_dict(raw).model, precision="fp32")

    up = load_flax_params(build_model(cfg), got)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        ref = dense(x)
        for fused in ("1", "0"):
            monkeypatch.setenv("GAVIT_MOE_FUSED", fused)
            torch.testing.assert_close(up(x), ref, rtol=0, atol=1e-5)


def test_env_switches_pick_engines_as_jax(monkeypatch):
    calls = []
    monkeypatch.setattr(tmoe, "grouped_moe_mlp_fused",
                        lambda *a, **k: calls.append("fused") or a[0])
    monkeypatch.setattr(tmoe, "grouped_moe_mlp",
                        lambda *a, **k: calls.append("unfused") or a[0])
    mod = tmoe.MoEMlp(from_dict(tiny_raw()).model.moe, 32, 64)
    x = torch.randn(2, 5, 32)
    for fused, matmul, want in (("1", "", "fused"), ("0", "", "unfused"),
                                ("1", "ragged_dot", "unfused"),
                                ("1", "megablox", "fused")):
        monkeypatch.setenv("GAVIT_MOE_FUSED", fused)
        monkeypatch.setenv("GAVIT_MOE_MATMUL", matmul)
        assert tfused.use_fused() is (want == "fused")
        assert tgrouped.resolve_matmul_impl() == (matmul or "megablox")
        mod(x)
        assert calls[-1] == want
    monkeypatch.setenv("GAVIT_MOE_MATMUL", "bad")
    with pytest.raises(ValueError, match="bad"):
        tfused.use_fused()
    monkeypatch.delenv("GAVIT_MOE_MATMUL")
    # the crossover: the fused threshold where the kernels run, the unfused
    # one elsewhere, GAVIT_MOE_AUTO_PAIRS over both (moe.py:98-109)
    pairs = (tmoe.FUSED_MIN_PAIRS + tmoe.GROUPED_MIN_PAIRS) // 2
    assert tmoe.resolve_moe_impl("auto", pairs, True) == "grouped"
    assert tmoe.resolve_moe_impl("auto", pairs, False) == "dense"
    monkeypatch.setenv("GAVIT_MOE_AUTO_PAIRS", str(pairs + 1))
    assert tmoe.resolve_moe_impl("auto", pairs, True) == "dense"
    monkeypatch.setenv("GAVIT_MOE_AUTO_PAIRS", str(pairs))
    assert tmoe.resolve_moe_impl("auto", pairs, False) == "grouped"
    assert tmoe.resolve_moe_impl("dense", pairs, True) == "dense"
    assert jmoe.resolve_moe_impl("auto", pairs) == "grouped"
