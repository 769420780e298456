"""Token merging for serving (counterpart of ``gavit_tpu/models/tome.py``).

After every transformer block the ``r`` most similar (A, B) token pairs of
a bipartite split are merged by size-weighted averaging
(:func:`bipartite_merge`), so block i runs on N − i·r tokens: a
training-free throughput dial with no new parameters. The CLS token never
merges; token sizes are tracked and weight the merge; proportional
attention is not applied (the attention kernels take no bias), as in the
JAX package.

:func:`tome_forward` runs a built ``VisionTransformer``'s own modules
(its blocks, graph blocks, norm and head, and whatever int8 quant state
they hold) with the merge between blocks, in eval mode. So kernel A runs
at N = 197 − i·r tokens, kernel B on ``b·N`` rows and kernel C on the
merged tokens' N − 1 patches. The graph must be dynamic and not the
learned-static one (an ``[N, N]`` table has no meaning after merging), and
the trunk dense (MoE capacity is sized to the unmerged count).
"""

from __future__ import annotations

import torch


def bipartite_merge(x, sizes, r: int):
    """Merge the ``r`` most similar A→B token pairs (token 0 protected).

    ``x [B, N, C]`` tokens (CLS first), ``sizes [B, N, 1]`` fp32 counts of
    the patches each token holds; ``r`` is clamped to ⌊(N−1)/2⌋ − 1.
    Returns ``(x', sizes')`` with N − r tokens: CLS, the kept A tokens in
    order of falling similarity, then the B tokens with the merged A
    tokens averaged in. Every consumer downstream is permutation-invariant.

    As in the JAX package: cosine similarity in fp32 over ``a / (‖a‖ +
    1e-6)``, each A token's best B token (the first on a tie), A tokens
    ordered by falling best similarity with a stable sort (near-ties decide
    which pairs merge), and the merged B token ``(s_b·b + Σ s_a·a) / (s_b +
    Σ s_a)`` in fp32, rounded to x's dtype.
    """
    n_tok = x.shape[1] - 1
    r = min(r, n_tok // 2 - 1)
    if r <= 0:
        return x, sizes
    cls_x, t = x[:, :1], x[:, 1:]
    cls_s, s = sizes[:, :1], sizes[:, 1:]
    a, b = t[:, 0::2], t[:, 1::2]
    sa, sb = s[:, 0::2], s[:, 1::2]

    af, bf = a.float(), b.float()
    an = af / (torch.linalg.vector_norm(af, dim=-1, keepdim=True) + 1e-6)
    bn = bf / (torch.linalg.vector_norm(bf, dim=-1, keepdim=True) + 1e-6)
    sim = torch.matmul(an, bn.transpose(1, 2))
    best_idx = sim.argmax(dim=-1)                           # [B, na]
    best_val = torch.gather(sim, -1, best_idx[..., None])[..., 0]
    order = torch.argsort(-best_val, dim=-1, stable=True)   # most similar first
    merge_i, keep_i = order[:, :r], order[:, r:]

    def take(v, idx):
        return torch.gather(v, 1, idx[..., None].expand(-1, -1, v.shape[-1]))

    a_keep, sa_keep = take(a, keep_i), take(sa, keep_i)
    a_m, sa_m = take(af, merge_i), take(sa, merge_i)        # [B, r, C], [B, r, 1]
    dst = torch.gather(best_idx, 1, merge_i)                # [B, r]
    num = (sb * bf).scatter_add(
        1, dst[..., None].expand(-1, -1, bf.shape[-1]), sa_m * a_m)
    den = sb.scatter_add(1, dst[..., None], sa_m)
    b_new = (num / den).to(b.dtype)
    return (torch.cat([cls_x, a_keep, b_new], dim=1),
            torch.cat([cls_s, sa_keep, den], dim=1))


def check_tome(cfg) -> None:
    """Raise where the model cannot merge tokens (tome.py:119-131)."""
    g = cfg.graph
    if g.enabled and (not g.dynamic or g.adjacency == "learned_static"):
        raise ValueError(
            "token merging requires graph.dynamic=true with a rebuilt "
            "adjacency (a learned-static [N, N] table has no meaning after "
            "merging) or graph.enabled=false")
    if cfg.moe.enabled:
        raise ValueError(
            "token merging supports the dense trunk only (MoE expert "
            "capacity is sized to the unmerged token count); set "
            "model.moe.enabled=false or tome_r=0")


def tome_forward(model, images, r: int):
    """The deterministic forward of ``model`` (a ``VisionTransformer`` in
    eval mode) on normalised NHWC ``images`` with ``r`` tokens merged after
    every block → fp32 logits. At ``r = 0`` it is ``model(images)`` bit for
    bit."""
    check_tome(model.cfg)
    if model.training:
        raise ValueError("token merging is a serving forward: call "
                         "model.eval() first")
    dt = model.dtype
    x = model.patch_embed(images.to(dt))
    b, _, d = x.shape
    cls = model.cls_token.to(dt).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + model.pos_embed.to(dt)
    sizes = torch.ones((b, x.shape[1], 1), dtype=torch.float32,
                       device=x.device)
    graphs = dict(zip(model.graph_sites, model.graphs))
    for i, block in enumerate(model.blocks):
        x = block(x)
        x, sizes = bipartite_merge(x, sizes, r)
        if i in graphs:
            x, _ = graphs[i](x)
    x = model.norm(x)
    return model.head(x[:, 0]).float()
