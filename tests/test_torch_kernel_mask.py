"""The port's ``kernel_mask`` on the CPU, where kernel E takes its plain
version ``philox.keep_mask``, against the JAX package's ``kernel_mask`` run
as ``tests/test_kernels_interpret.py`` runs it (TPU interpret mode, the
core's PRNG emulated) at the same (m, f, d, rate, out_rate): the same
return structure (hidden ``[m, f]`` and output ``[m, d]`` masks, fp32, the
output mask None at ``out_rate`` 0), 0/1 values, all ones at rate 0, and
keep rates within 0.02 of ``1 - rate`` on both sides. The bits cannot be
compared (Philox against the TPU core's generator); the port's bits are
the masks kernels D and D′ draw at the two sites: the Philox keep masks,
and a plain MLP armed with them gives the bits of ``mlp_train_reference``
(the plain version of D) and its backward drops what D′'s plain version
drops.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gavit_tpu.ops import mlp as jmlp
from gavit_tpu_torch.ops import mlp as tmlp
from gavit_tpu_torch.ops import philox
from gavit_tpu_torch.ops.dropout import gelu_and_grad
from test_kernels_interpret import _make_prng_emulation

SEED = philox.step_seed(3, 11)
SITES = (8, 9)
M, D, F = 40, 24, 64
RATE, OUT_RATE = 0.1, 0.2
KEEP_TOL = 0.02


@pytest.fixture
def tpu_interpret(monkeypatch):
    seed_fn, bits_fn = _make_prng_emulation()
    monkeypatch.setattr(pltpu, "prng_seed", seed_fn)
    monkeypatch.setattr(pltpu, "prng_random_bits", bits_fn)
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("rate,out_rate", [(0.1, 0.1), (0.1, 0.0),
                                           (0.0, 0.2), (0.0, 0.0)])
def test_masks_match_jax_kernel_mask(tpu_interpret, rate, out_rate):
    """m = 64 in two TPU row blocks of 32, f = 256 in two hidden chunks."""
    m, f, d = 64, 256, 128
    want = jmlp.kernel_mask(np.asarray([777], np.int32), m, f, rate, 32, d=d,
                            out_rate=out_rate)
    got = tmlp.kernel_mask(SEED, SITES, m, f, rate, d=d, out_rate=out_rate,
                           device="cpu")
    assert (got[1] is None) == (want[1] is None) == (out_rate == 0.0)
    for g, w, r in zip(got, want, (rate, out_rate)):
        if w is None:
            continue
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32 \
            and w.dtype == np.float32
        assert set(np.unique(w)) <= {0.0, 1.0}
        assert set(g.unique().tolist()) <= {0.0, 1.0}
        if r == 0.0:
            assert w.all() and bool(g.all())
        for mask in (w, g.numpy()):
            assert abs(mask.mean() - (1.0 - r)) < KEEP_TOL


def test_masks_are_the_philox_keep_masks_at_both_sites():
    hidden, out = tmlp.kernel_mask(SEED, SITES, M, F, RATE, d=D,
                                   out_rate=OUT_RATE, device="cpu")
    assert hidden.shape == (M, F) and out.shape == (M, D)
    assert hidden.dtype == out.dtype == torch.float32
    assert set(hidden.unique().tolist()) == {0.0, 1.0}
    assert torch.equal(hidden.bool(),
                       philox.keep_mask((M, F), SEED, SITES[0], RATE))
    assert torch.equal(out.bool(),
                       philox.keep_mask((M, D), SEED, SITES[1], OUT_RATE))
    assert abs(hidden.mean().item() - (1 - RATE)) < 0.03


def test_out_mask_is_none_at_out_rate_zero():
    hidden, out = tmlp.kernel_mask(SEED, SITES, M, F, RATE, device="cpu")
    assert out is None and hidden.shape == (M, F)
    hidden0, _ = tmlp.kernel_mask(SEED, SITES, M, F, 0.0, device="cpu")
    assert torch.equal(hidden0, torch.ones(M, F))


def test_mlp_armed_with_the_masks_is_the_training_mlp():
    rng = np.random.default_rng(0)

    def t(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            np.float32))

    x, w1, b1 = t(M, D), t(F, D, s=0.2), t(F, s=0.1)
    w2, b2, dy = t(D, F, s=0.2), t(D, s=0.1), t(M, D)
    hidden, out = tmlp.kernel_mask(SEED, SITES, M, F, RATE, d=D,
                                   out_rate=OUT_RATE, device="cpu")

    h1 = torch.matmul(x, w1.t()) + b1
    g, _ = gelu_and_grad(h1)
    g = torch.where(hidden > 0.5, g * (1.0 / (1.0 - RATE)), 0.0)
    y = torch.matmul(g, w2.t()) + b2
    y = torch.where(out > 0.5, y * (1.0 / (1.0 - OUT_RATE)), 0.0)

    want, h1_ref = tmlp.mlp_train_reference(x, w1, b1, w2, b2, SEED, SITES,
                                            RATE, OUT_RATE)
    assert torch.equal(h1, h1_ref)
    assert torch.equal(y, want)
    dh1, go, _, _, dye = tmlp.mlp_train_bwd_reference(
        dy, h1_ref, w2, SEED, SITES, RATE, OUT_RATE)
    assert torch.equal(dye != 0, (out > 0.5) & (dy != 0))
    assert torch.equal(go, g)
    assert not dh1[hidden < 0.5].any()
