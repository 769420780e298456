"""``fused_dropout_add`` against the JAX kernel G (interpret mode) armed with
the port's mask, and at rate 0 (the rest: ``tests/test_torch_dropout_add.py``).

At most 3 tests a file: with ``--dist loadfile`` pytest-xdist hands out the
files with the most tests first, so a file of 3 or fewer runs beside
``tests/test_evaluate_mesh.py`` instead of ahead of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gavit_tpu.ops import dropout as jdrop
from gavit_tpu_torch.ops import dropout as tdrop

from test_kernels_interpret import _make_prng_emulation
from test_torch_dropout_add import DTYPES, RATE, SEED, _np32, _pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_rate_zero_matches_jax():
    y, r = _pair(torch.float32, seed=3)
    want = jdrop.fused_dropout_add(jnp.asarray(y.numpy()),
                                   jnp.asarray(r.numpy()),
                                   jnp.asarray([5], jnp.int32), 0.0)
    got = tdrop.fused_dropout_add(y, r, None, 5, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
