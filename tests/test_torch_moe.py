"""The port's MoE routing and grouped engine against gavit_tpu's, fp32 on
the CPU at a tiny size (D=32, F=64, E=4, k=2, 3 images of 17 tokens), the
same inputs made with numpy:

* ``router_topk`` and ``router_dispatch``: gates, choices (ties to the lower
  expert, as ``jax.lax.top_k``: a zero router ties all of them), the
  capacity drops at ``capacity_factor=0.5`` and both auxiliary losses;
* ``group_by_expert_tiled``: every output equal to the JAX package's at row
  tiles 8 and 16, with a hot and an empty expert;
* the plain versions of kernels M, M′ and tgmm, through
  ``grouped_moe_mlp_fused``: the forward and the gradient of every input
  against the JAX package's fused engine in interpret mode at rate 0, erf
  and tanh GELU, within 1e-4 (fp32 products summed in other orders);
* the masks of the plain versions: the hidden mask is element row·F + col
  of the ``[cap, F]`` buffer at its site, the output mask element
  row·D + col of ``[cap, D]`` at its site (``ops/philox.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.models import moe as jmoe
from gavit_tpu.ops import moe_fused as jfused
from gavit_tpu_torch.models import moe as tmoe
from gavit_tpu_torch.ops import moe_fused as tfused
from gavit_tpu_torch.ops import philox


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


G, S, D, F, E, K = 3, 17, 32, 64, 4, 2


def _logits(seed=0, hot=None, empty=(), zero=False):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((G, S, E)).astype(np.float32)
    if zero:
        lg[:] = 0.0
    # ±20: saturated, with every probability far above fp32's denormals
    # (which XLA's CPU backend flushes to zero and PyTorch keeps)
    if hot is not None:
        lg[..., hot] = 20.0
    for e in empty:
        lg[..., e] = -20.0
    return lg


def _weights(seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.1).astype(np.float32)
            for s in ((E, D, F), (E, F), (E, F, D), (E, D))]


@pytest.mark.parametrize("case", [
    dict(), dict(zero=True), dict(hot=2), dict(empty=(0, 3))],
    ids=["random", "zero_router", "hot", "empty"])
@pytest.mark.parametrize("normalize", [True, False])
def test_router_topk_matches_jax(case, normalize):
    lg = _logits(**case)
    jv, ji, jaux = jmoe.router_topk(jnp.asarray(lg), K,
                                    normalize_gates=normalize)
    tv, ti, taux = tmoe.router_topk(torch.from_numpy(lg), K,
                                    normalize_gates=normalize)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    for key in ("load_balance", "router_z"):
        assert abs(taux[key].item() - float(jaux[key])) <= 1e-5
    if case.get("zero"):
        assert (ti[..., 0] == 0).all() and (ti[..., 1] == 1).all()


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_router_dispatch_matches_jax(cf):
    lg = _logits(seed=3)
    cap = tmoe.expert_capacity(S, E, K, cf)
    assert cap == jmoe.expert_capacity(S, E, K, cf)
    jc, _ = jmoe.router_dispatch(jnp.asarray(lg), K, cap)
    tc, _ = tmoe.router_dispatch(torch.from_numpy(lg), K, cap)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-7, rtol=0)
    kept = (tc > 0).sum().item()
    # every pair fits at 1.25 here; at 0.5 the queue past capacity drops
    assert (kept < G * S * K) == (cf < 1.0)


@pytest.mark.parametrize("tm", [8, 16])
@pytest.mark.parametrize("case", [dict(), dict(hot=1), dict(empty=(0, 3))],
                         ids=["random", "hot", "empty"])
def test_group_by_expert_tiled_matches_jax(tm, case):
    lg = _logits(seed=5, **case)
    _, ji, _ = jmoe.router_topk(jnp.asarray(lg), K)
    want = jfused.group_by_expert_tiled(ji, E, tm)
    got = tfused.group_by_expert_tiled(torch.from_numpy(np.array(ji)),
                                       E, tm)
    for name, a, b in zip(("dest", "src", "used", "tile_group",
                           "group_sizes"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert got[3].dtype == torch.int32 and got[4].dtype == torch.int32
    assert got[1].shape[0] == tfused.fused_cap(G * S * K, E, tm)


@pytest.mark.parametrize("tm", [8, 16])
@pytest.mark.parametrize("case", [dict(), dict(hot=1), dict(empty=(0, 3))],
                         ids=["random", "hot", "empty"])
def test_tile_group_sizes_match_the_grouping(tm, case):
    """Kernel M's group sizes, derived on the device from the tile map when
    a caller passes none: the JAX grouping's padded rows per expert (the
    tail booked to the last), summing to cap."""
    lg = _logits(seed=6, **case)
    _, ji, _ = jmoe.router_topk(jnp.asarray(lg), K)
    want = jfused.group_by_expert_tiled(ji, E, tm)[4]
    tile_group = tfused.group_by_expert_tiled(
        torch.from_numpy(np.array(ji)), E, tm)[3]
    got = tfused.tile_group_sizes(tile_group, E, tm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum().item() == tile_group.numel() * tm


def _jax_fused_vjp(approx):
    """value_and_grad of Σ out·r through the JAX fused engine (interpret
    mode), jitted once per GELU form."""
    key = jax.random.PRNGKey(0)

    def loss(x, gv, w, gi, r):
        out = jfused.grouped_moe_mlp_fused(x, gv, gi, *w, key,
                                           approx_gelu=approx, interpret=True)
        return jnp.sum(out * r), out

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))


@pytest.mark.parametrize("approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("case", [dict(), dict(hot=0)], ids=["random", "hot"])
def test_fused_grouped_mlp_matches_jax(approx, case):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((G, S, D)).astype(np.float32)
    r = rng.standard_normal((G, S, D)).astype(np.float32)
    lg = _logits(seed=9, **case)
    jv, ji, _ = jmoe.router_topk(jnp.asarray(lg), K)
    w = _weights()
    (_, jout), jgrads = _jax_fused_vjp(approx)(
        jnp.asarray(x), jv, tuple(jnp.asarray(a) for a in w), ji,
        jnp.asarray(r))

    tx = torch.from_numpy(x).requires_grad_(True)
    tv = torch.from_numpy(np.array(jv)).requires_grad_(True)
    tw = [torch.from_numpy(a).requires_grad_(True) for a in w]
    out = tfused.grouped_moe_mlp_fused(
        tx, tv, torch.from_numpy(np.array(ji)).long(), *tw, None, (2, 3),
        approx_gelu=approx)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-4, rtol=0)
    jx, jgv, jw = jgrads
    for name, got, want in [("x", tx.grad, jx), ("gates", tv.grad, jgv)] + [
            (n, t.grad, g) for n, t, g in zip(
                ("w1", "b1", "w2", "b2"), tw, jw)]:
        want = np.asarray(want)
        tol = 1e-4 * max(np.abs(want).max(), 1e-12)
        err = np.abs(got.numpy() - want).max()
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


def test_plain_versions_mask_contract():
    """At rate 0.3 the plain forward drops exactly the hidden elements whose
    Philox bits at (seed; row·F + col, hidden site) fall below the
    threshold, and the output elements at (seed; row·D + col, output site);
    the backward regenerates both."""
    rng = np.random.default_rng(11)
    tm, seed, sites, rate = 8, philox.step_seed(0, 4), (5, 6), 0.3
    _, ji, _ = jmoe.router_topk(jnp.asarray(_logits(seed=2)), K)
    _, _, _, tg, _ = tfused.group_by_expert_tiled(
        torch.from_numpy(np.array(ji)), E, tm)
    cap = tg.shape[0] * tm
    x = torch.from_numpy(rng.standard_normal((cap, D)).astype(np.float32))
    w1, b1, w2, b2 = (torch.from_numpy(a) for a in _weights())
    y, h1 = tfused.moe_fwd_reference(x, w1, b1, w2, b2, tg, tm, seed, sites,
                                     rate, rate, False)
    y0, _ = tfused.moe_fwd_reference(x, w1, b1, w2, b2, tg, tm, seed, sites,
                                     rate, 0.0, False)
    keep_o = philox.keep_mask((cap, D), seed, sites[1], rate)
    torch.testing.assert_close(y, torch.where(keep_o, y0 / (1 - rate), 0.0),
                               rtol=1e-6, atol=0)
    dy = torch.ones(cap, D)
    _, go, _, _, _, dye = tfused.moe_bwd_reference(
        dy, h1, w1, w2, tg, tm, seed, sites, rate, rate, False)
    keep_h = philox.keep_mask((cap, F), seed, sites[0], rate)
    assert torch.equal(go == 0, ~keep_h | (h1 == 0))
    assert torch.equal(dye == 0, ~keep_o)
    kept = keep_h.float().mean().item()
    assert 0.6 < kept < 0.8


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_moe_kernels_check_group_sizes_before_the_card(bad):
    """Kernels M and M′ walk the grouping's ``group_sizes`` (int32 ``[E]``):
    a wrong dtype or shape raises ValueError naming it on tiny CPU tensors,
    before the wrappers ask for a card, which right ones then do."""
    bf = torch.bfloat16
    cap, tm, e, d, f = 16, 8, 2, 8, 16
    tg = torch.tensor([0, 1], dtype=torch.int32)
    good = torch.tensor([8, 8], dtype=torch.int32)
    wrong = good.long() if bad == "dtype" else torch.tensor(
        [8, 8, 0], dtype=torch.int32)
    x, dy = torch.zeros(cap, d, dtype=bf), torch.zeros(cap, d, dtype=bf)
    h1 = torch.zeros(cap, f, dtype=bf)
    w1, w2 = torch.zeros(e, d, f, dtype=bf), torch.zeros(e, f, d, dtype=bf)
    b1, b2 = torch.zeros(e, f, dtype=bf), torch.zeros(e, d, dtype=bf)
    fwd = (x, w1, b1, w2, b2, tg, tm, 0, (5, 6), 0.0, 0.0, False)
    bwd = (dy, h1, w1, w2, tg, tm, 0, (5, 6), 0.0, 0.0, False)
    for kernel, args in ((tfused.moe_fwd_kernel, fwd),
                         (tfused.moe_bwd_kernel, bwd)):
        with pytest.raises(ValueError, match="group_sizes"):
            kernel(*args, wrong)
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernel(*args, good)
