"""The port's large-N graph path (``gavit_tpu_torch.ops.graph_ops``:
``graph_aggregate_chunked``, ``needs_chunked``, ``_pick_chunk`` and the size
dispatch of ``fused_graph_aggregate``) against the JAX package's
``graph_aggregate_chunked`` (row-chunked XLA under ``jax.checkpoint``, no
Pallas) and against the port's materialised plain version, on the same
numpy inputs: forward and the gradients of both inputs in knn, threshold and
dense mode, at chunks that do not divide N; duplicate tokens, whose exact
ties must select the lower indices as ``jax.lax.top_k`` does; and the size
rule and chunk choice, held to the JAX package's over a list of N.

Tolerance 1e-5: fp32 on every side, the same products summed in other
orders (a chunk's slice against the whole ``[N, N]`` similarity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.ops import graph_ops as jgraph
from gavit_tpu_torch.ops import graph_ops as tgraph


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5
MODES = [("knn", {"k": 4}), ("threshold", {"threshold": 0.1}),
         ("dense", {})]


def _inputs(b, n, d, seed):
    rng = np.random.default_rng(seed)
    t, v, g = (rng.standard_normal((b, n, d)).astype(np.float32)
               for _ in range(3))
    return t, v, g


def _port(fn, t, v, g):
    """(out, d tokens, d values) of ``fn`` through torch autograd."""
    tt, tv = (torch.from_numpy(a).requires_grad_(True) for a in (t, v))
    out = fn(tt, tv)
    dt, dv = torch.autograd.grad(out, (tt, tv), torch.from_numpy(g))
    return out.detach().numpy(), dt.numpy(), dv.numpy()


def test_chunked_duplicate_token_ties_take_lower_indices():
    """All tokens equal: every similarity ties, and each row's k neighbours
    are its lowest non-self indices on every path (the JAX package's
    chunked and materialised ones, the port's chunked and plain)."""
    rng = np.random.default_rng(3)
    t = np.tile(rng.standard_normal((1, 1, 8)), (1, 24, 1)).astype(np.float32)
    v = rng.standard_normal((1, 24, 8)).astype(np.float32)
    want = np.asarray(jgraph.graph_aggregate_chunked(
        jnp.asarray(t), jnp.asarray(v), mode="knn", k=5, chunk=7))
    want_plain = np.asarray(jgraph.graph_aggregate(
        jgraph.build_adjacency(jnp.asarray(t), mode="knn", k=5),
        jnp.asarray(v)))
    got = tgraph.graph_aggregate_chunked(torch.from_numpy(t),
                                         torch.from_numpy(v), "knn", k=5,
                                         chunk=7).numpy()
    # row i averages v over its lowest five non-self indices (equal logits)
    lowest = np.stack([v[0, [j for j in range(24) if j != i][:5]].mean(0)
                       for i in range(24)])
    for x in (want, want_plain, got):
        np.testing.assert_allclose(x[0], lowest, atol=TOL, rtol=0)


def test_size_rule_and_chunk_choice_match_jax(monkeypatch):
    monkeypatch.delenv("GAVIT_GRAPH_CHUNK", raising=False)
    ns = [2, 37, 64, 65, 196, 197, 576, 686, 687, 768, 769, 1024, 1025,
          2048, 4096, 4097, 8192]
    for n in ns:
        assert tgraph._pick_chunk(n) == jgraph._pick_chunk(n), n
        for d, itemsize in ((768, 2), (768, 4), (32, 4), (1024, 2)):
            assert tgraph.needs_chunked(n, d, itemsize) == \
                jgraph.needs_chunked(n, d, itemsize), (n, d, itemsize)
    # the graph blocks' patch tokens at 512 and 1024 px
    assert tgraph._pick_chunk(1024) == 512 and tgraph._pick_chunk(4096) == 128


def test_dispatch_takes_the_chunked_path_past_the_switch(monkeypatch):
    """``impl='auto'`` takes the chunked path where ``needs_chunked`` says
    so, on the CPU as on the card, with the JAX package's chunk; under
    ``'reference'`` the adjacency is materialised whatever N."""
    calls = []
    real = tgraph.graph_aggregate_chunked

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tgraph, "graph_aggregate_chunked", spy)
    t, v, _ = _inputs(1, 800, 8, seed=5)
    tt, tv = torch.from_numpy(t), torch.from_numpy(v)
    assert tgraph.needs_chunked(800, 8, 4)
    got = tgraph.fused_graph_aggregate(tt, tv, "knn", 8)
    assert calls == [(1, 800, 8)]
    want = tgraph.fused_graph_aggregate(tt, tv, "knn", 8, impl="reference")
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    small = tgraph.fused_graph_aggregate(tt[:, :100], tv[:, :100], "knn", 8)
    assert len(calls) == 1 and small.shape == (1, 100, 8)
