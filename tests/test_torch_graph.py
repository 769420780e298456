"""The port's graph ops (gavit_tpu_torch.ops.graph_ops) against the JAX
package's: ``fused_graph_aggregate`` (the Pallas kernel, interpret mode on
the CPU) and ``build_adjacency``, for knn, threshold and dense, and the kNN
tie rule on duplicate tokens (exactly k edges; lower indices win).

Tolerance 1e-5 in fp32: both sides take fp32 products and differ only in
summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.ops import graph_ops as jg
from gavit_tpu_torch.ops import graph_ops as tg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODES = [("knn", {"k": 4}), ("threshold", {"threshold": 0.1}),
         ("dense", {"temperature": 0.5})]


def _inputs(b=2, n=16, d=32, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((b, n, d)).astype(np.float32)
    v = rng.standard_normal((b, n, d)).astype(np.float32)
    return t, v


@pytest.mark.parametrize("mode,kw", MODES)
def test_fused_graph_aggregate_matches_jax(mode, kw):
    t, v = _inputs()
    want = jg.fused_graph_aggregate(jnp.asarray(t), jnp.asarray(v), mode,
                                    **kw)
    got = tg.fused_graph_aggregate(torch.from_numpy(t), torch.from_numpy(v),
                                   mode, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    adj_j = np.asarray(jg.build_adjacency(jnp.asarray(t), mode=mode, **kw))
    adj_t = tg.build_adjacency(torch.from_numpy(t), mode=mode, **kw).numpy()
    np.testing.assert_array_equal(adj_t > 0, adj_j > 0)
    np.testing.assert_allclose(adj_t, adj_j, atol=1e-5, rtol=0)


def test_threshold_row_without_edges_falls_back_to_self():
    t, _ = _inputs(b=1, n=6)
    adj = tg.build_adjacency(torch.from_numpy(t), mode="threshold",
                             threshold=1.5).numpy()
    np.testing.assert_allclose(adj[0], np.eye(6), atol=0)


def _duplicate_tokens(b=2, n=16, d=8, n_dup=6, seed=5):
    """The first n_dup rows identical (black-border patches on real X-rays
    do this), so many similarities tie exactly."""
    t = np.random.default_rng(seed).standard_normal((b, n, d)).astype(
        np.float32)
    t[:, :n_dup] = t[:, :1]
    return t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_knn_exactly_k_edges_with_duplicate_tokens(dtype):
    k = 3
    t = torch.from_numpy(_duplicate_tokens()).to(dtype)
    adj = tg.build_adjacency(t, mode="knn", k=k).numpy()
    assert ((adj > 1e-6).sum(-1) == k).all()
    np.testing.assert_allclose(adj.sum(-1), 1.0, atol=1e-5)


def test_knn_ties_prefer_lower_indices_like_jax():
    """All tokens identical: every off-diagonal similarity ties, so the k
    neighbours are the lowest non-self indices, in the port and in JAX."""
    b, n, d, k = 1, 8, 4, 3
    t = np.broadcast_to(np.random.default_rng(1).standard_normal(d),
                        (b, n, d)).astype(np.float32).copy()
    adj = tg.build_adjacency(torch.from_numpy(t), mode="knn", k=k).numpy()
    for i in range(n):
        assert list(np.nonzero(adj[0, i] > 1e-9)[0]) == [
            j for j in range(n) if j != i][:k]
    v = np.random.default_rng(2).standard_normal((b, n, d)).astype(np.float32)
    want = jg.fused_graph_aggregate(jnp.asarray(t), jnp.asarray(v), "knn", k)
    got = tg.fused_graph_aggregate(torch.from_numpy(t), torch.from_numpy(v),
                                   "knn", k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_duplicate_token_ties_match_jax_kernel():
    t = _duplicate_tokens()
    v = np.random.default_rng(9).standard_normal(t.shape).astype(np.float32)
    want = jg.fused_graph_aggregate(jnp.asarray(t), jnp.asarray(v), "knn", 3)
    got = tg.fused_graph_aggregate(torch.from_numpy(t), torch.from_numpy(v),
                                   "knn", 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_kernel_wrapper_refuses_cpu_and_bad_arguments():
    t = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tg.graph_aggregate_kernel(t, t, "knn", 3, 0.0, 1.0)
    with pytest.raises(ValueError, match="mode"):
        tg.graph_aggregate_kernel(t, t, "learned_static", 3, 0.0, 1.0)
    with pytest.raises(ValueError, match="impl"):
        tg.fused_graph_aggregate(t, t, impl="pallas")
