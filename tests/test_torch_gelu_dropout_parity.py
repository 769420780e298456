"""The fused GELU + dropout at rate 0 against the JAX kernel H in interpret
mode (the rest of dropout: ``tests/test_torch_dropout.py``).

At most 3 tests a file: with ``--dist loadfile`` pytest-xdist hands out the
files with the most tests first, so a file of 3 or fewer runs beside
``tests/test_evaluate_mesh.py`` instead of ahead of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gavit_tpu.ops import dropout as jdrop
from gavit_tpu_torch.ops import dropout as tdrop


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gelu_dropout_at_rate_zero_matches_jax():
    """H's and H′'s plain versions against the JAX package's
    ``fused_gelu_dropout`` (its CPU path: the A&S erf in another order of
    operations) and its ``jax.vjp``, fp32, within 1e-6."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 17, 48)) * 2).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jseed = jnp.asarray([3], jnp.int32)
    want, vjp = jax.vjp(lambda a: jdrop.fused_gelu_dropout(a, jseed, 0.0),
                        jnp.asarray(x))
    (dwant,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tdrop.fused_gelu_dropout(tx, None, 9, 0.0)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dwant), atol=1e-6,
                               rtol=0)
    # the exact GELU, not tanh's
    torch.testing.assert_close(got.detach(), F.gelu(tx.detach()), rtol=0,
                               atol=1e-6)
