"""The plain versions of kernels L and L′ against the JAX package's
``flash_attention_large`` in interpret mode, forward, lse and ``jax.vjp``
(the set-up of ``tests/test_torch_attention_blockwise.py``). At most 3
tests a file (see ``tests/test_torch_trainer_parity.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.ops import attention as jattn
from gavit_tpu_torch.ops import attention as tattn

from test_torch_attention_blockwise import FWD_TOL, GRAD_TOL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("b,h,n,d", [(1, 2, 300, 32), (2, 1, 256, 64)])
def test_blockwise_plain_versions_match_jax_v5(b, h, n, d):
    scale = d ** -0.5
    rng = np.random.default_rng(n)
    qkv = rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)
    dout = rng.standard_normal((b, h, n, d)).astype(np.float32)
    q5 = jnp.asarray(qkv).reshape(b, n, 3, h, d).transpose(2, 0, 3, 1, 4)
    want_o, lse_pad = jattn._run_fwd_v5_impl(q5[0], q5[1], q5[2], scale)
    # [B·H, N_pad, 128] with the 128 lanes equal → [B, H, N]
    want_lse = np.asarray(lse_pad)[:, :n, 0].reshape(b, h, n)
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention_large(q, k, v,
                                                                 scale),
                     q5[0], q5[1], q5[2])
    want_d = np.stack([np.asarray(x) for x in vjp(jnp.asarray(dout))])

    tq = torch.from_numpy(qkv)
    o, lse = tattn.blockwise_attention_reference(tq, scale, h)
    assert o.shape == (b, h, n, d) and lse.shape == (b, h, n)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=FWD_TOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=FWD_TOL, rtol=0)
    dqkv = tattn.blockwise_attention_backward_reference(
        tq, o, lse, torch.from_numpy(dout), scale, h)
    # packed rows [B, N, 3·H·d] → [3, B, H, N, d]
    got_d = dqkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).numpy()
    np.testing.assert_allclose(got_d, want_d, atol=GRAD_TOL, rtol=0)
