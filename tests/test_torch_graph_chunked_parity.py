"""The row-chunked graph path against the JAX package's
``graph_aggregate_chunked`` and the materialised plain version, forward
and gradients, in each adjacency mode (the set-up of
``tests/test_torch_graph_chunked.py``). At most 3 tests a file (see
``tests/test_torch_trainer_parity.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.ops import graph_ops as jgraph
from gavit_tpu_torch.ops import graph_ops as tgraph

from test_torch_graph_chunked import MODES, TOL, _inputs, _port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode,kw", MODES, ids=[m for m, _ in MODES])
def test_chunked_matches_jax_and_the_materialised_plain_version(mode, kw):
    t, v, g = _inputs(2, 37, 16, seed=len(mode))
    temp = 0.7
    want, vjp = jax.vjp(
        lambda a, b: jgraph.graph_aggregate_chunked(
            a, b, mode, temperature=temp, chunk=16, **kw),
        jnp.asarray(t), jnp.asarray(v))
    want_dt, want_dv = vjp(jnp.asarray(g))
    got = _port(lambda a, b: tgraph.graph_aggregate_chunked(
        a, b, mode, temperature=temp, chunk=16, **kw), t, v, g)
    plain = _port(lambda a, b: tgraph.fused_graph_aggregate(
        a, b, mode, temperature=temp, impl="reference", **kw), t, v, g)
    for x, w, p in zip(got, (want, want_dt, want_dv), plain):
        np.testing.assert_allclose(x, np.asarray(w), atol=TOL, rtol=0)
        np.testing.assert_allclose(x, p, atol=TOL, rtol=0)
