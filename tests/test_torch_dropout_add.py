"""The port's dropout + residual add on the CPU, where kernel G takes its
plain version.

* Against the JAX package's ``fused_dropout_add`` run as
  ``tests/test_kernels_interpret.py`` runs it (TPU interpret mode, the
  core's PRNG emulated), at rate 0.1 in bf16 and fp32 on the same numpy
  inputs: the TPU kernel's keep mask is read from its dropout kernel F on
  ones with the same seed (G draws F's mask), the port is armed with it in
  place of its Philox mask, and then its output ``r + y·scale`` (scale
  rounded to y's dtype) and its gradients ``(dropout(g), g)`` equal
  ``jax.vjp``'s bit for bit.
* On its own mask: ``fused_dropout_add(y, r, seed, site, rate)`` gives the
  bits of ``r + fused_dropout(y, seed, site, rate)`` and its gradients are
  ``(fused_dropout(g), g)``, in bf16 and fp32.
* At rate 0 it is the JAX package's ``fused_dropout_add`` within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gavit_tpu.ops import dropout as jdrop
from gavit_tpu_torch.ops import dropout as tdrop
from gavit_tpu_torch.ops import philox
from test_kernels_interpret import _make_prng_emulation

RATE = 0.1
SEED = philox.step_seed(7, 2)
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "fp32": (torch.float32, jnp.float32)}


def _pair(dtype, shape=(3, 17, 40), seed=0):
    rng = np.random.default_rng(seed)
    y, r = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(2))
    return y, r


def _np32(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.detach().float().numpy()


@pytest.mark.parametrize("dtypes", DTYPES.values(), ids=DTYPES.keys())
def test_matches_jax_kernel_armed_with_its_mask(monkeypatch, dtypes):
    tdtype, jdtype = dtypes
    monkeypatch.setattr(jdrop, "_on_tpu", lambda: True)
    seed_fn, bits_fn = _make_prng_emulation()
    monkeypatch.setattr(pltpu, "prng_seed", seed_fn)
    monkeypatch.setattr(pltpu, "prng_random_bits", bits_fn)
    y, r, g = (a.to(tdtype) for a in _pair(torch.float32, (2, 8, 128), 4)
               + _pair(torch.float32, (2, 8, 128), 5)[:1])
    jy, jr, jg = (jnp.asarray(_np32(a), jdtype) for a in (y, r, g))
    seed = jnp.asarray([99], jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(
            lambda y, r: jdrop.fused_dropout_add(y, r, seed, RATE), jy, jr)
        want_dy, want_dr = vjp(jg)
        keep = _np32(jdrop.fused_dropout(jnp.ones_like(jy), seed, RATE)) != 0
    assert abs(keep.mean() - (1 - RATE)) < 0.03

    def jax_mask(shape, *args, **kwargs):
        assert tuple(shape) == keep.shape
        return torch.from_numpy(keep)

    monkeypatch.setattr(tdrop.philox, "keep_mask", jax_mask)
    y.requires_grad_(True)
    r.requires_grad_(True)
    got = tdrop.fused_dropout_add(y, r, SEED, 5, RATE)
    dy, dr = torch.autograd.grad(got, (y, r), g)
    assert got.dtype == dy.dtype == dr.dtype == tdtype
    for a, w in ((got, want), (dy, want_dy), (dr, want_dr)):
        np.testing.assert_array_equal(_np32(a), _np32(w))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_equals_residual_plus_dropout_bit_for_bit(dtype):
    y, r = _pair(dtype)
    got = tdrop.fused_dropout_add(y, r, SEED, 5, RATE)
    want = r + tdrop.fused_dropout(y, SEED, 5, RATE)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(got, tdrop.dropout_add_reference(y, r, SEED, 5, RATE))
    # some elements dropped (out == r), the rest moved
    dropped = (tdrop.fused_dropout(y, SEED, 5, RATE) == 0).float().mean()
    assert 0.05 < dropped.item() < 0.15


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_gradients_are_dropout_of_g_and_g(dtype):
    y, r = _pair(dtype, seed=1)
    y.requires_grad_(True)
    r.requires_grad_(True)
    out = tdrop.fused_dropout_add(y, r, SEED, 9, RATE)
    g = _pair(dtype, seed=2)[0]
    dy, dr = torch.autograd.grad(out, (y, r), g)
    assert torch.equal(dy, tdrop.fused_dropout(g, SEED, 9, RATE))
    assert torch.equal(dr, g)


def test_rate_zero_matches_jax():
    y, r = _pair(torch.float32, seed=3)
    want = jdrop.fused_dropout_add(jnp.asarray(y.numpy()),
                                   jnp.asarray(r.numpy()),
                                   jnp.asarray([5], jnp.int32), 0.0)
    got = tdrop.fused_dropout_add(y, r, None, 5, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_refuses_what_it_does_not_take():
    y, r = _pair(torch.float32)
    with pytest.raises(ValueError, match="differ"):
        tdrop.fused_dropout_add(y, r[:, :3], SEED, 1, RATE)
    with pytest.raises(ValueError, match="differ"):
        tdrop.fused_dropout_add(y, r.double(), SEED, 1, RATE)
    with pytest.raises(ValueError, match="seed"):
        tdrop.fused_dropout_add(y, r, None, 1, RATE)
    with pytest.raises(ValueError, match="CUDA"):
        tdrop.dropout_add_kernel(y, r, SEED, 1, RATE)
