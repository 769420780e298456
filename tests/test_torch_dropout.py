"""The port's dropout contract on the CPU (the plain versions that kernels F,
D and D′ are held to bit for bit on the card): Philox4x32-10 against
Random123's known-answer vectors, the keep fraction at rate 0.1, forward
and backward masks identical, distinct masks for distinct sites and steps,
the TPU kernels' keep rule and scale rounding, the model's site ids, and the
training MLP's plain version against a hand-written chain with the same
explicit masks; the GELU + dropout's masks and backward (at rate 0 against
the JAX kernel H: ``tests/test_torch_gelu_dropout_parity.py``).

The masks cannot match the JAX package's bits (its kernels draw from the
TPU core's generator; its CPU fallback from threefry), so the JAX side is
compared by distribution.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from gavit_tpu.ops import dropout as jdrop
from gavit_tpu_torch.models.vit import dropout_sites
from gavit_tpu_torch.ops import dropout as tdrop
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


RATE = 0.1


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    got = philox.philox4x32(*counter, *key)
    assert tuple(int(w) for w in got) == want


def test_bits_follow_the_counter_contract():
    """Element e takes word e % 4 of the block at counter (e // 4, site)."""
    seed, site = 0x1234_5678_9ABC_DEF0, 7
    bits = philox.bits(10, seed, site)
    k0, k1 = philox.split_seed(seed)
    for e in (0, 3, 5, 9):
        words = philox.philox4x32(e // 4, site, 0, 0, k0, k1)
        assert int(bits[e]) == int(words[e % 4])
    assert philox.threshold(RATE) == int(RATE * 0xFFFFFFFF)


def test_keep_fraction_and_jax_distribution():
    keep = philox.keep_mask((1000, 1000), philox.step_seed(0, 0), 3, RATE)
    frac = keep.float().mean().item()
    assert abs(frac - (1 - RATE)) < 0.005 * (1 - RATE)
    # the JAX package's dropout keeps the same share
    x = jnp.ones((1000, 1000), jnp.float32)
    y = jdrop.fused_dropout(x, jnp.asarray([5], jnp.int32), RATE)
    jfrac = float(jnp.mean(y != 0))
    assert abs(frac - jfrac) < 0.005


def test_forward_and_backward_masks_match():
    x = torch.randn(4, 17, 64, generator=torch.Generator().manual_seed(0))
    x.requires_grad_(True)
    seed = philox.step_seed(42, 3)
    y = tdrop.fused_dropout(x, seed, 5, RATE)
    w = torch.randn_like(x)
    (y * w).sum().backward()
    scale = 1.0 / (1.0 - RATE)
    kept = y != 0
    torch.testing.assert_close(y, torch.where(kept, x * scale, 0.0).detach(),
                               rtol=0, atol=0)
    torch.testing.assert_close(x.grad, torch.where(kept, w * scale, 0.0),
                               rtol=0, atol=0)
    # the same (seed, site) again gives the same mask
    again = tdrop.fused_dropout(x.detach(), seed, 5, RATE)
    assert torch.equal(again != 0, kept)


def test_sites_and_steps_give_distinct_masks():
    shape = (64, 197)
    base = philox.keep_mask(shape, philox.step_seed(0, 1), 4, RATE)
    for seed, site in ((philox.step_seed(0, 2), 4),
                       (philox.step_seed(0, 1), 5),
                       (philox.step_seed(1, 1), 4)):
        other = philox.keep_mask(shape, seed, site, RATE)
        assert (other != base).float().mean() > 0.1
    assert len({philox.step_seed(0, s) for s in range(1000)}) == 1000


def test_bf16_scale_is_rounded_to_the_dtype():
    """y = x * bf16(1/(1-rate)), the TPU kernel's rounding (1.109375, not
    1.1111)."""
    x = torch.ones(1000, dtype=torch.bfloat16)
    y = tdrop.dropout_reference(x, 9, 0, RATE)
    vals = set(y.float().unique().tolist())
    assert vals <= {0.0, float(torch.tensor(1 / 0.9).bfloat16())}
    assert float(torch.tensor(1 / 0.9).bfloat16()) == 1.109375


def test_rate_zero_is_identity_and_seed_is_required():
    x = torch.randn(3, 5)
    assert tdrop.fused_dropout(x, None, 0, 0.0) is x
    with pytest.raises(ValueError, match="seed"):
        tdrop.fused_dropout(x, None, 0, RATE)


def test_model_sites_are_distinct():
    sites = dropout_sites(12, 2)
    flat = []
    for v in sites.values():
        flat += list(v) if isinstance(v, tuple) else [v]
    assert len(flat) == len(set(flat)) == 1 + 3 * 12 + 2
    assert sites["embed"] == 0 and sites["graphs.1"] == 1 + 36 + 1


def _mlp_inputs(seed=0, m=34, d=64, f=256):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, d, generator=g)
    w1 = torch.randn(f, d, generator=g) * d ** -0.5
    b1 = torch.randn(f, generator=g) * 0.1
    w2 = torch.randn(d, f, generator=g) * f ** -0.5
    b2 = torch.randn(d, generator=g) * 0.1
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("rate,out_rate", [(RATE, RATE), (0.0, RATE),
                                           (RATE, 0.0)])
def test_training_mlp_plain_version_equals_hand_chain(rate, out_rate):
    """fp32: the plain versions of both MLP routes (D/D′, and the chain
    through H/H′ and F) against F.gelu (exact erf) and the explicit masks,
    forward and through torch.autograd (the A&S erf of the TPU kernels is
    within 1.5e-7 of erf)."""
    x, w1, b1, w2, b2 = _mlp_inputs()
    seed, sites = philox.step_seed(7, 0), (11, 12)
    m, f = x.shape[0], w1.shape[0]
    keep_h = philox.keep_mask((m, f), seed, sites[0], rate) if rate else \
        torch.ones(m, f, dtype=torch.bool)
    keep_o = philox.keep_mask((m, 64), seed, sites[1], out_rate) \
        if out_rate else torch.ones(m, 64, dtype=torch.bool)
    sh = 1 / (1 - rate)
    so = 1 / (1 - out_rate)

    leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    lx, lw1, lb1, lw2, lb2 = leaves
    g = torch.where(keep_h, F.gelu(lx @ lw1.t() + lb1) * sh, 0.0)
    want = torch.where(keep_o, (g @ lw2.t() + lb2) * so, 0.0)
    dy = torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
    want.backward(dy)

    # both routes: fp32 takes the chain (H/H′'s and F's plain versions);
    # the megakernel's plain versions (D/D′) through their autograd op
    routes = (
        lambda *a: tmlp.fused_mlp(*a, seed, sites, rate, out_rate),
        lambda *a: tmlp._FusedMlp.apply(*a, seed, sites, rate, out_rate,
                                        False),
    )
    for route in routes:
        args = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        got = route(*args)
        got.backward(dy)
        torch.testing.assert_close(got, want.detach(), rtol=0, atol=2e-6)
        for a, b in zip(args, leaves):
            torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-5)
        # the masks are the Philox ones: dropped outputs are exactly 0
        assert torch.equal(got.detach() == 0, ~keep_o | (want.detach() == 0))


def _tiny_model(drop_rate=RATE, drop_path_rate=0.0):
    from gavit_tpu_torch.config import from_dict
    from gavit_tpu_torch.models.vit import build_model, init_params

    cfg = from_dict({"model": {
        "name": "custom", "img_size": 32, "patch_size": 8, "embed_dim": 64,
        "depth": 2, "num_heads": 2, "drop_rate": drop_rate,
        "drop_path_rate": drop_path_rate,
        "graph": {"enabled": True, "num_blocks": 1, "k": 4}}})
    model = init_params(build_model(cfg.model),
                        torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.graphs[0].gate.fill_(0.5)
    return model


def test_model_dropout_follows_the_step_seed():
    model = _tiny_model()
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    assert not model.training  # build_model hands out the eval forward
    with torch.no_grad():
        det = model(x)
        assert torch.equal(model(x, seed=5), det)  # eval ignores the seed
        model.train()
        a, b = model(x, seed=5), model(x, seed=5)
        c = model(x, seed=6)
    assert torch.equal(a, b)
    assert (a - c).abs().max() > 1e-4 and (a - det).abs().max() > 1e-4
    with pytest.raises(ValueError, match="seed"):
        model(x)


def test_drop_path_draws_from_the_generator():
    from gavit_tpu_torch.models.layers import drop_path

    x = torch.ones(1000, 3, 4)
    y = drop_path(x, 0.25, True, torch.Generator().manual_seed(0))
    per_sample = y[:, 0, 0]
    assert set(per_sample.unique().tolist()) == {
        0.0, torch.tensor(1 / 0.75).item()}
    assert abs((per_sample == 0).float().mean().item() - 0.25) < 0.05
    z = drop_path(x, 0.25, True, torch.Generator().manual_seed(0))
    assert torch.equal(y, z)
    assert drop_path(x, 0.25, False) is x
    model = _tiny_model(drop_rate=0.0, drop_path_rate=0.5).train()
    img = torch.randn(4, 32, 32, 3)
    with torch.no_grad():
        outs = {tuple(model(img, generator=torch.Generator().manual_seed(s))
                      .flatten().tolist()) for s in range(4)}
    assert len(outs) > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_dropout_masks_and_backward(dtype):
    """At rate 0.1 the plain version is keep·GELU·(1/(1-rate)) under
    ``philox.keep_mask`` of its (seed, site) (the JAX CPU path draws
    jax.random masks, so bits cannot be compared there), and autograd's
    gradient is H′'s plain version, whose zeros are the same mask."""
    x = torch.randn(5, 33, 40, generator=torch.Generator().manual_seed(2))
    x = x.to(dtype).requires_grad_(True)
    seed, site = philox.step_seed(11, 2), 8
    y = tdrop.fused_gelu_dropout(x, seed, site, RATE)
    keep = philox.keep_mask(x.shape, seed, site, RATE)
    gelu, _ = tdrop.gelu_and_grad(x.detach().float())
    want = torch.where(keep, gelu * (1 / (1 - RATE)), 0.0).to(dtype)
    assert torch.equal(y.detach(), want)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    y.backward(g.to(dtype))
    dx = tdrop.gelu_dropout_bwd_reference(x.detach(), g.to(dtype), seed, site,
                                          RATE)
    assert torch.equal(x.grad, dx)
    assert bool((dx[~keep] == 0).all()) and bool((y.detach()[~keep] == 0).all())
    # another site draws another mask
    other = tdrop.gelu_dropout_reference(x.detach(), seed, site + 1, RATE)
    assert not torch.equal(other == 0, y.detach() == 0)
    with pytest.raises(ValueError, match="seed"):
        tdrop.fused_gelu_dropout(x, None, site, RATE)
