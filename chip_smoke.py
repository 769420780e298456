#!/usr/bin/env python3
"""Bring-up check of the PyTorch port's bf16 serving and training paths on
one CUDA card: ViT-B/16 with two kNN graph blocks at 224 px
(``configs/vit_b16_graph2.yaml``), the same model at 512 and 1024 px
(``--set model.img_size=... --set data.image_size=...``; 1024 px trains
with ``model.remat``), its 384-px fine-tune with a learned-static graph
block (``configs/finetune_384.yaml``), and ViT-B/16 with 8-expert top-2 MoE
MLPs in blocks 1, 3, ..., 11 and two kNN graph blocks
(``configs/examples/vit_b16_moe.yaml``, one card: its mesh is read and not
used), on its fused grouped engine and, with ``GAVIT_MOE_FUSED=0``, on
its unfused one.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits nonzero
before the last line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the Hopper kernels from ``gavit_tpu_torch/csrc`` (one nvcc per
   source, all at once, sm_90a);
3. kernel checks against their plain PyTorch versions, each within a stated
   tolerance: A (attention), B (inference MLP) and C (graph aggregate) at
   the serving shapes of ViT-B/16 at 224 px; F (dropout), D and D′ (training
   MLP) and A′ (attention backward) at the training shapes (batch 128); K
   and K′ (long-sequence attention) at 384 px (N=577, b1 and b16), H and H′
   (GELU + dropout) at the 384 fine-tune's hidden rows [16·577, 3072]; M,
   M′ and tgmm (the MoE expert MLP forward, backward and grouped dW) at the
   b128 routing (T = 50432 pairs, tm = 256) of a seeded router, with a
   hot and an empty expert, and at b8 (T = 3152, tm = 32), M's reruns
   bit-equal; L and L′ (blockwise attention) at N = 750, 1025 (b32), 1088
   and 4097, each run twice for the same bits, and the chunked graph path
   (tensor ops) at 1024 and 4096 patch tokens; N-gmm (the unfused engine's ragged grouped GEMM)
   in both forms at the b128 routing, with a hot and an empty expert and
   at b127 (T = 50038, no multiple of the row tile), the same bits again
   (B too), and tgmm's two dW on the same packed rows as well as on the
   fused engine's cap-padded ones (empty experts zero, the same bits
   again);
   then the JAX package's op-level entry points, counts zeroed before and
   read after: ``multi_head_attention`` and ``fused_attention_v2`` forward
   and backward at b128 × 12 × 197 × 64 (I, I′ and J, J′), ``fused_dropout_add``
   at [128, 197, 768] (G, F in its backward), ``kernel_mask`` (E, both
   masks in one launch) at the b128 MLP rows and the training MLP (D, D′)
   held to a plain MLP armed with E's masks, bench.py's self-check; I/I′ and J/J′ again at N = 1, 50,
   197, 577, 640 (J also 1025), bit-equal on a rerun, and N = 641 through
   ``attention_pallas`` on L/L′;
4. slice: each configuration in bf16 from a seed, graph gates set to 0.5
   (and the learned adjacency logits drawn from a normal), through the
   kernels (``impl='auto'``) and through the plain versions
   (``impl='reference'``) on the same weights: 8 images at 224 px, 16 at
   384 px, 8 at 512 px, 2 at 1024 px, 64 (grouped engine) and 1 (dense
   engine) of the MoE model, 128 with the fused gate off (the unfused
   engine), with the launch counts of that forward; the upcycled MoE model
   against the dense one through both grouped engines;
5. serve: ``scripts/serve_torch.py``'s HTTP server in-process with a warmed
   224-px Predictor; every response must be 200 and match the plain-version
   Predictor; the kernels' launch counters, zeroed just before, must show
   that the requests went through every serving kernel; the 512- and
   1024-px Predictors (buckets 1 and 8, 1 and 4) against their plain
   versions, with the launches of their warm-up;
6. train: each configuration through ``scripts/train_torch.py``'s trainer
   (preprocess → forward with dropout 0.1 → loss → backward → AdamW),
   vit_b16_graph2 and the MoE model at batch 128 (the MoE objective with
   its auxiliary loss), finetune_384 at its batch 16 and vit_b16_graph2 at
   512 px b32: 5 steps through the kernels against 5 through the plain
   versions from the same start (losses, and every gradient of the first
   step), the launch counts of one step, then 30 steps through the kernels
   that must lower the loss; vit_b16_graph2 again with drop_path 0.1 (3
   compared steps, 20 that must lower the loss) and at b32 with
   attn_drop 0.1 (A and A′ not launched; 3 compared steps, 15 that must
   lower the loss); at 1024 px b4 with remat
   3 compared steps and their launches, then one step with remat on
   against one with it off; the MoE model again with the fused gate off,
   then one such step with ``model.moe.grouped_remat`` on against one with
   it off (bit-equal, lower peak memory); the unfused MoE engine against
   the fused one at drop 0;
7. times: each kernel against its plain version and a library call (CUDA
   events, median), for B, C, D, D′, E, F, G, H, H′, L, L′, M, M′, N-gmm, tgmm
   (both dW, cap-padded and packed rows, and one hot expert), A′, K′, I′
   and J′ also the device time alone (20 launches between two events)
   beside the library call's (D′'s: the chain's backward from y to the
   fc1 output, with the whole chain's backward beside it; A′ also beside
   the backward pair under K′'s entry at A′'s shape; L's beside
   its tensor bound and the floor of its exponentials on the SFUs), the host time
   of one kernel-A call and one kernel-B call at b1 (tensor-map encodes
   included) beside sdpa's and the cuBLAS chain's, Predictor p50 for one image
   at 224 and 384 px,
   images/s of the bf16 forward (224 px b64, 384 px b16) and of the train
   step (224 px b128, 384 px b16), and the 384 MLP's two routes (kernels
   D/D′ against the chain of H/H′ and F) at M = 9232; the MoE kernels at
   b128, its b64 forward, b128 train step and b1 p50; L and L′ at 512 px
   b32, the chunked graph op at both sizes' training shapes, the 512-px b32
   forward, the 512-px b32 and 1024-px b4 train steps, the b1 p50 at 512
   and 1024 px; N-gmm in both forms at b128 against ``torch._grouped_mm``,
   the two MoE engines alone, the MoE b128 forward and train step on each;
   I, I′, J, J′ at b128 against sdpa, G and E against their plain versions
   and alone on the device beside their byte bounds; H's issue floor (the
   instructions its SASS gives an element, ``tools/sass_issue.py``) beside
   its byte bound.

The last two lines are one JSON object describing the kernels and then
``{"ok": true, "device": {...}}``. No CUDA device: exit 1, no result.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "vit_b16_graph2.yaml"
CONFIG_384 = ROOT / "configs" / "finetune_384.yaml"
CONFIG_MOE = ROOT / "configs" / "examples" / "vit_b16_moe.yaml"
SEED = 0
GATE = 0.5
HEADS, HEAD_DIM, N_TOKENS, DIM, HIDDEN = 12, 64, 197, 768, 3072
N_384, BATCH_384 = 577, 16  # tokens at 384 px, the fine-tune's batch
N_512, BATCH_512 = 1025, 32  # tokens at 512 px, the config's own batch
N_1024, BATCH_1024 = 4097, 4  # tokens at 1024 px, a batch that trains
EXPERTS, TOP_K = 8, 2  # the MoE example's experts and choices per token
DTYPES = {"bf16": "bfloat16", "fp32": "float32"}  # names of torch dtypes

# tolerances, with why:
# fp32: both sides sum fp32 products in different orders (~1e-7 relative).
# bf16: outputs are rounded to bf16 (one ulp is 2^-8 relative), so a sum
# taken in another order can land one ulp away.
ATTN_TOL = {"fp32": 1e-5, "bf16": 2e-2}
MLP_TOL = 2e-2  # bf16, |y| ~ 1: one ulp is ~4e-3
GRAPH_TOL = {"fp32": 1e-5, "bf16": 2e-2}
# share of rows whose neighbour set must match the plain version's: every
# row in fp32; in bf16 a near-tie summed in another order may pick another
# neighbour, which changes that whole row, so those rows are counted, not
# compared
GRAPH_SAME_ROWS = {"fp32": 1.0, "bf16": 0.99}
PROB_TOL = 2e-2  # bf16 model end to end, probabilities in [0, 1]
# training kernels (bf16): D′'s and A′'s outputs are rounded to bf16 from
# fp32 sums taken in another order; relative to the tensor's largest value
GRAD_REL_TOL = 2e-2
BIAS_REL_TOL = 1e-3  # D′'s fp32 bias gradients: summation order only
DROP_RATE = 0.1
TRAIN_BATCH = 128
LOSS_REL_TOL = 2e-2  # per-step loss, kernels vs plain versions, bf16
GRAD_COSINE = 0.99  # each parameter's first gradient, kernels vs plain
# L's fp32 log-sum-exp: the same terms summed in another order (the online
# softmax over 64-key tiles against one pass over the row), up to 4097 keys
LSE_TOL = 1e-3
# a kNN selection decided by less than this may go either way between two
# summation orders of the same fp32 products: such rows are counted, and
# left out of the comparison (as in tests/test_torch_cuda.py)
TIE_MARGIN = 1e-5
# one 1024-px step with remat on against one with it off, from the same
# start: the recompute runs the same operations on the same inputs, so the
# same bits are expected; each gradient is held within this share of its
# tensor's largest value (fp32 reassociation), and bit-equality is reported
REMAT_REL_TOL = 1e-6
# the H100 SXM's published dense peaks (the bound of each kernel's work)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# exponentials an SM's special-function units issue a clock (ex2, fp32)
SFU_EX2_PER_CLOCK = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, launches: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()`` in ms: ``launches`` calls back to back
    between two CUDA events, so the host's gap between calls is not inside
    (``cuda_ms`` times each call between its own events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call of ``fn`` in us: ``calls`` back to back,
    with no synchronisation in between."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def log_issue_floor(elements: int, rows, card) -> None:
    """H's and H′'s issue floors (``tools/sass_issue.py``: the instructions
    their SASS gives an element, by ``cuobjdump -sass`` on the built
    library) beside their byte bounds; "not measured" without cuobjdump."""
    from gavit_tpu_torch.ops import _build
    from tools import sass_issue

    try:
        counts = sass_issue.per_element(_build.library_path())
    except (OSError, subprocess.CalledProcessError) as err:
        log(f"[time] H and H′ issue floors: not measured ({err})")
        return
    for key in ("H", "H′"):
        per, how = counts[key]
        log(f"[time] {key} at [{elements}] bf16: {per:.2f} instructions an "
            f"element ({how}): issue floor "
            f"{sass_issue.issue_floor_ms(per, elements):.4f} ms beside the "
            f"byte bound {rows[key][3]:.4f} ms ({card})")


def sfu_floor_ms(exps: float) -> float:
    """The least time the card's special-function units take for ``exps``
    fp32 exponentials: SFU_EX2_PER_CLOCK a clock on every SM at the card's
    highest SM clock (``nvidia-smi``'s clocks.max.sm)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    hz = float(out.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps / (SFU_EX2_PER_CLOCK * sms * hz) * 1e3


# ---------------------------------------------------------------------------


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check runs only on a CUDA card")
    card = card_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    log(f"[env] nvidia-smi name, power.limit: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from gavit_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {_build.library_path().name} ready in "
        f"{time.perf_counter() - t0:.1f} s (nvcc "
        f"{'%.1f s' % _build.build_seconds if _build.build_seconds else 'cached'})")
    for line in (_build.build_log or "").splitlines():
        if ("Compiling entry" in line or "Used" in line or "spill" in line
                or "Performance Loss" in line):
            log(f"[build] {line.strip()}")


def check_attention(dev, results):
    import torch

    from gavit_tpu_torch.ops import attention as A

    scale = HEAD_DIM ** -0.5
    cases = [(name, b, N_TOKENS) for name in DTYPES for b in (1, 8, 64)]
    for dtype_name, b, n in cases:
        g = torch.Generator(device=dev).manual_seed(SEED + b)
        dtype = getattr(torch, DTYPES[dtype_name])
        qkv = torch.randn(b, n, 3 * HEADS * HEAD_DIM, device=dev,
                          generator=g).to(dtype)
        got = A.qkv_attention_kernel(qkv, scale, HEADS)
        want = A.attention_reference(*A._split_heads(qkv, HEADS), scale)
        torch.cuda.synchronize()
        err = max_err(got, want)
        tol = ATTN_TOL[dtype_name]
        ok = torch.isfinite(got).all().item() and err <= tol
        log(f"[check] A attention {dtype_name} B={b} N={n} H={HEADS} "
            f"d={HEAD_DIM}: max_abs_err {err:.3e} (tol {tol:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("kernel A disagrees with its plain version")
        results["A"]["errs"].append(err)
        if n == N_TOKENS:
            results["A"]["cases"].append((dtype_name, b, qkv))


def check_long_attention(dev, results):
    """K at 384 px (b1: serving one image; b16: the fine-tune's batch) and
    K′ at b16, dO as the output projection's backward hands it over."""
    import torch

    from gavit_tpu_torch.ops import attention as A

    scale = HEAD_DIM ** -0.5
    for b in (1, BATCH_384):
        g = torch.Generator(device=dev).manual_seed(SEED + 31 + b)
        qkv = torch.randn(b, N_384, 3 * HEADS * HEAD_DIM, device=dev,
                          generator=g).to(torch.bfloat16)
        got = A.qkv_attention_long_kernel(qkv, scale, HEADS)
        want = A.attention_reference(*A._split_heads(qkv, HEADS), scale)
        torch.cuda.synchronize()
        err, tol = max_err(got, want), ATTN_TOL["bf16"]
        check("K long attention", torch.isfinite(got).all().item()
              and err <= tol,
              f"bf16 B={b} N={N_384} H={HEADS} d={HEAD_DIM}: max_abs_err "
              f"{err:.3e} (tol {tol:.0e})")
        results["K"]["errs"].append(err)
        results["K"]["cases"].append((b, qkv))
    do = torch.randn(BATCH_384, N_384, HEADS, HEAD_DIM, device=dev,
                     generator=g).to(torch.bfloat16).transpose(1, 2)
    got = A.qkv_attention_long_bwd_kernel(qkv, do, scale, HEADS)
    want = A.attention_backward_reference(qkv, do, scale, HEADS)
    rel, err = rel_err(got, want), max_err(got, want)
    check("K′ long attention bwd", rel <= GRAD_REL_TOL
          and torch.isfinite(got).all().item(),
          f"bf16 B={BATCH_384} N={N_384} H={HEADS} d={HEAD_DIM}: dqkv rel to "
          f"max {rel:.3e} (tol {GRAD_REL_TOL:.0e}), max_abs_err {err:.3e}")
    results["K′"]["errs"].append(err)
    results["K′"]["cases"].append((qkv, do))


def check_blockwise_attention(dev, results,
                              cases=((750, 1), (N_512, BATCH_512), (1088, 2),
                                     (N_1024, 2))):
    """L and L′ against their plain versions: at the route's boundary (N =
    750, b1), 512 px at the training batch (b32; its tensors are kept for
    the times), an exact tile multiple (1088 = 17·64) and 1024 px (b2); dO
    as the output projection's backward hands it over; L and L′ twice
    each, for the same bits; lse finite on every row."""
    import torch

    from gavit_tpu_torch.ops import attention as A

    scale = HEAD_DIM ** -0.5
    bf = torch.bfloat16
    routes = tuple(A.attention_route(n, bf) for n in (A.K_MAX_N,
                                                      A.K_MAX_N + 1))
    check("L route", routes == ("K", "L"),
          f"bf16 N={A.K_MAX_N} takes {routes[0]}, N={A.K_MAX_N + 1} takes "
          f"{routes[1]}")
    for n, b in cases:
        g = torch.Generator(device=dev).manual_seed(SEED + 61 + n)
        qkv = torch.randn(b, n, 3 * HEADS * HEAD_DIM, device=dev,
                          generator=g).to(bf)
        o, lse = A.qkv_attention_large_kernel(qkv, scale, HEADS)
        o2, lse2 = A.qkv_attention_large_kernel(qkv, scale, HEADS)
        want_o, want_lse = A.blockwise_attention_reference(qkv, scale, HEADS)
        torch.cuda.synchronize()
        err, lerr = max_err(o, want_o), max_err(lse, want_lse)
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        finite = (torch.isfinite(o).all().item()
                  and torch.isfinite(lse).all().item())
        del want_o, want_lse, o2, lse2
        check("L blockwise attention", finite and same
              and err <= ATTN_TOL["bf16"] and lerr <= LSE_TOL,
              f"bf16 B={b} N={n} H={HEADS} d={HEAD_DIM}: o max_abs_err "
              f"{err:.3e} (tol {ATTN_TOL['bf16']:.0e}), lse max_abs_err "
              f"{lerr:.3e} (tol {LSE_TOL:.0e}), o and lse finite {finite}; "
              f"a second run bit-equal {same}")
        results["L"]["errs"].append(err)
        do = torch.randn(b, n, HEADS, HEAD_DIM, device=dev,
                         generator=g).to(bf).transpose(1, 2)
        got = A.qkv_attention_large_bwd_kernel(qkv, o, lse, do, scale, HEADS)
        again = A.qkv_attention_large_bwd_kernel(qkv, o, lse, do, scale,
                                                 HEADS)
        want = A.blockwise_attention_backward_reference(qkv, o, lse, do,
                                                        scale, HEADS)
        torch.cuda.synchronize()
        rel, err = rel_err(got, want), max_err(got, want)
        same = torch.equal(got, again)
        del want
        check("L′ blockwise attention bwd", rel <= GRAD_REL_TOL and same
              and torch.isfinite(got).all().item(),
              f"bf16 B={b} N={n} H={HEADS} d={HEAD_DIM}: dqkv rel to max "
              f"{rel:.3e} (tol {GRAD_REL_TOL:.0e}), max_abs_err {err:.3e}; "
              f"a second run bit-equal {same}")
        results["L′"]["errs"].append(err)
        if n == N_512:
            results["L"]["cases"].append(qkv)
            results["L′"]["cases"].append((qkv, o, lse, do))
        torch.cuda.empty_cache()


def near_tie_rows(tokens, k):
    """Rows whose k-th and (k+1)-th non-self cosine similarity lie within
    TIE_MARGIN: their neighbour set may differ between two summation
    orders."""
    import torch

    from gavit_tpu_torch.ops import graph_ops as G

    sim = G.cosine_similarity(tokens)
    eye = torch.eye(sim.shape[-1], dtype=torch.bool, device=sim.device)
    top = torch.topk(sim.masked_fill(eye, -1e30), k + 1, dim=-1).values
    return top[..., k - 1] - top[..., k] < TIE_MARGIN


def check_graph_chunked(dev, cases=((8, 1024), (1, 4096))):
    """The large-N graph path (tensor ops, no kernel: the JAX package writes
    it in XLA) on the card, bf16 kNN at ViT-B width, against the
    materialised plain version: the 512-px graph (1024 patch tokens, b8)
    and the 1024-px one (4096, b1). Rows at a near-tie are counted and left
    out: the upstream gradient is zero there, so they move no gradient."""
    import torch

    from gavit_tpu_torch.ops import graph_ops as G

    bf = torch.bfloat16
    for b, n in cases:
        g = torch.Generator(device=dev).manual_seed(SEED + 71 + n)
        t, v, up = (torch.randn(b, n, DIM, device=dev, generator=g).to(bf)
                    for _ in range(3))
        near = near_tie_rows(t, 8)
        share = 1.0 - near.float().mean().item()
        up = up * (~near)[..., None]
        outs, grads = {}, {}
        for impl in ("auto", "reference"):
            tt, tv = (a.detach().clone().requires_grad_(True) for a in (t, v))
            before = G.KERNEL_LAUNCHES
            out = G.fused_graph_aggregate(tt, tv, "knn", 8, impl=impl)
            if G.KERNEL_LAUNCHES != before:
                raise AssertionError(f"kernel C launched at N = {n}")
            grads[impl] = torch.autograd.grad(out, (tt, tv), up)
            outs[impl] = out.detach()
        torch.cuda.synchronize()
        row_err = (outs["auto"].float() - outs["reference"].float()).abs() \
            .amax(-1)
        err = row_err[~near].max().item()
        rels = [rel_err(a, r) for a, r in zip(grads["auto"],
                                               grads["reference"])]
        check("chunked graph (tensor ops)", share >= GRAPH_SAME_ROWS["bf16"]
              and err <= GRAPH_TOL["bf16"] and max(rels) <= GRAD_REL_TOL
              and torch.isfinite(outs["auto"]).all().item(),
              f"bf16 knn B={b} N={n} D={DIM} chunk {G._pick_chunk(n)}: "
              f"{share:.4%} of rows clear of a near-tie (need "
              f"{GRAPH_SAME_ROWS['bf16']:.0%}); max_abs_err on those rows "
              f"{err:.3e} (tol {GRAPH_TOL['bf16']:.0e}); d tokens, d values "
              f"rel to max {rels[0]:.3e}, {rels[1]:.3e} (tol "
              f"{GRAD_REL_TOL:.0e}); kernel C launched 0 times")
        del outs, grads
        torch.cuda.empty_cache()


def gelu_inputs(dev, dtype):
    """x = 2·N(0, 1) and dy = N(0, 1) at the 384 fine-tune's hidden rows
    [16·577, 3072], from seed SEED + 41: the inputs H and H′ are checked and
    timed on (``tools/time_small_kernels.py`` times them too)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    m = BATCH_384 * N_384
    x = (torch.randn(m, HIDDEN, device=dev, generator=g) * 2).to(dtype)
    return x, torch.randn(m, HIDDEN, device=dev, generator=g).to(dtype)


def gelu_dropout_bwd_library(x, dy):
    """H′'s yardstick: the backward of ``F.dropout(F.gelu(x), 0.1)`` on dy,
    as the two aten calls autograd makes for it (``native_dropout_backward``
    with the forward's mask, then ``gelu_backward``), without autograd's
    host work, which made ``torch.autograd.grad`` of that chain host-bound
    (0.3174 ms alone here and 0.1115-0.1178 in tools/time_small_kernels.py,
    PERF.md §6)."""
    import torch
    import torch.nn.functional as F

    _, mask = torch.ops.aten.native_dropout(F.gelu(x), DROP_RATE, True)
    scale = 1.0 / (1.0 - DROP_RATE)
    return lambda: torch.ops.aten.gelu_backward(
        torch.ops.aten.native_dropout_backward(dy, mask, scale), x)


def check_gelu_dropout(dev, results):
    """H and H′ at the 384 fine-tune's hidden rows, bf16 and fp32: the
    masks (zero patterns) bit-exact, values within one ulp of the dtype."""
    import torch

    from gavit_tpu_torch.ops import dropout as DR
    from gavit_tpu_torch.ops import philox

    seed, site, m = philox.step_seed(SEED, 5), 6, BATCH_384 * N_384
    for dtype_name in ("bf16", "fp32"):
        dtype = getattr(torch, DTYPES[dtype_name])
        x, dy = gelu_inputs(dev, dtype)
        for key, got, want in (
                ("H", DR.gelu_dropout_kernel(x, seed, site, DROP_RATE),
                 DR.gelu_dropout_reference(x, seed, site, DROP_RATE)),
                ("H′", DR.gelu_dropout_bwd_kernel(x, dy, seed, site,
                                                  DROP_RATE),
                 DR.gelu_dropout_bwd_reference(x, dy, seed, site,
                                               DROP_RATE))):
            u = ulps(got, want, floor=torch.finfo(dtype).tiny)
            zeros = torch.equal(got == 0, want == 0)
            err = max_err(got, want)
            check(f"{key} gelu dropout{' bwd' if key == 'H′' else ''}",
                  zeros and u <= 1 and torch.isfinite(got).all().item(),
                  f"{dtype_name} [{m}, {HIDDEN}] rate {DROP_RATE}: zeros "
                  f"identical {zeros}, within {u:.0f} ulp (tol 1), bit-exact "
                  f"{torch.equal(got, want)}, max_abs_err {err:.3e}, kept "
                  f"{(want != 0).float().mean().item():.4%}")
            results[key]["errs"].append(err)
            if dtype_name == "bf16":
                results[key]["cases"].append((x, dy, seed, site))


def mlp_inputs(dev, m, dim=DIM, hidden=HIDDEN):
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + m)
    bf = torch.bfloat16
    x = torch.randn(m, dim, device=dev, generator=g).to(bf)
    w1 = (torch.randn(hidden, dim, device=dev, generator=g) * 0.02).to(bf)
    b1 = (torch.randn(hidden, device=dev, generator=g) * 0.02).to(bf)
    w2 = (torch.randn(dim, hidden, device=dev, generator=g) * 0.02).to(bf)
    b2 = (torch.randn(dim, device=dev, generator=g) * 0.02).to(bf)
    return x, w1, b1, w2, b2


def check_mlp(dev, results):
    import torch

    from gavit_tpu_torch.ops import mlp as M

    for m in (N_TOKENS, 8 * N_TOKENS, 64 * N_TOKENS):
        args = mlp_inputs(dev, m)
        got = M.mlp_inference_kernel(*args, True)
        again = M.mlp_inference_kernel(*args, True)
        want = M._chain_infer(*args, True)
        torch.cuda.synchronize()
        err, same = max_err(got, want), torch.equal(got, again)
        ok = torch.isfinite(got).all().item() and err <= MLP_TOL and same
        log(f"[check] B mlp bf16 tanh M={m} D={DIM} F={HIDDEN}: "
            f"max_abs_err {err:.3e} (tol {MLP_TOL:.0e}), the same bits "
            f"again {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("kernel B disagrees with its plain version")
        results["B"]["errs"].append(err)
        results["B"]["cases"].append(("bf16", m, args))


GRAPH_MODES = (("knn", dict(k=8)), ("threshold", dict(threshold=0.0)),
               ("dense", {}))


def check_graph(dev, results):
    import torch

    from gavit_tpu_torch.ops import graph_ops as G

    n_patch = N_TOKENS - 1
    cases = [(name, b, n_patch, GRAPH_MODES) for name in DTYPES
             for b in (1, 64)]
    # bf16 past 256 keys takes the CUDA-core body (384 px: N=576)
    cases.append(("bf16", 2, 576, GRAPH_MODES[:1]))
    for dtype_name, b, n, modes in cases:
        g = torch.Generator(device=dev).manual_seed(SEED + 7 * b)
        dtype = getattr(torch, DTYPES[dtype_name])
        t = torch.randn(b, n, DIM, device=dev, generator=g).to(dtype)
        v = torch.randn(b, n, DIM, device=dev, generator=g).to(dtype)
        for mode, kw in modes:
            k, thr = kw.get("k", 8), kw.get("threshold", 0.0)
            got, adj = G.graph_aggregate_kernel(t, v, mode, k, thr, 1.0,
                                                return_adjacency=True)
            ref_adj = G.build_adjacency(t, mode=mode, k=k, threshold=thr)
            want = G.graph_aggregate(ref_adj, v)
            torch.cuda.synchronize()
            same = ((adj > 0) == (ref_adj > 0)).all(-1)  # [b, n]
            frac = same.float().mean().item()
            row_err = (got.float() - want.float()).abs().amax(-1)
            err = row_err[same].max().item()
            tol, need = GRAPH_TOL[dtype_name], GRAPH_SAME_ROWS[dtype_name]
            ok = (frac >= need and torch.isfinite(got).all().item()
                  and err <= tol)
            log(f"[check] C graph {dtype_name} {mode} B={b} N={n} D={DIM}: "
                f"same neighbour set on {frac:.4%} of rows (need "
                f"{need:.0%}); max_abs_err on those rows {err:.3e} "
                f"(tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    "kernel C disagrees with its plain version")
            results["C"]["errs"].append(err)
        if n == n_patch:
            results["C"]["cases"].append((dtype_name, b, (t, v)))


def rel_err(a, b) -> float:
    return max_err(a, b) / max(b.float().abs().max().item(), 1e-30)


def ulps(got, want, floor: float = 2.0 ** -10) -> float:
    """Largest distance in ulps of want's dtype (bf16 or fp32) at |want|,
    floored at ``floor`` (by default 2^-10, below which fp32 cancellation,
    not rounding, sets the difference of two GEMMs)."""
    import torch

    bits = {torch.bfloat16: 7, torch.float32: 23}[want.dtype]
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(w.abs(), min=floor)))
                     - bits)
    return ((got.float() - w).abs() / ulp).max().item()


def check(name, ok, line):
    log(f"[check] {name}: {line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel {name} disagrees with its plain version")


def check_dropout(dev, results, n_tokens=N_TOKENS, dim=DIM,
                  batch=TRAIN_BATCH):
    import torch

    from gavit_tpu_torch.ops import dropout as DR
    from gavit_tpu_torch.ops import philox

    seed = philox.step_seed(SEED, 3)
    for dtype_name in ("bf16", "fp32"):
        g = torch.Generator(device=dev).manual_seed(SEED + 11)
        x = torch.randn(batch, n_tokens, dim, device=dev, generator=g).to(
            getattr(torch, DTYPES[dtype_name]))
        got = DR.dropout_kernel(x, seed, 5, DROP_RATE)
        want = DR.dropout_reference(x, seed, 5, DROP_RATE)
        err = max_err(got, want)
        kept = (want != 0).float().mean().item()
        check("F dropout", torch.equal(got, want),
              f"{dtype_name} [{batch}, {n_tokens}, {dim}] rate {DROP_RATE}: "
              f"bit-exact {torch.equal(got, want)} (max_abs_err {err:.3e}), "
              f"kept {kept:.4%}")
        results["F"]["errs"].append(err)
        if dtype_name == "bf16":
            results["F"]["cases"].append((x, seed))


def check_mlp_train(dev, results, m=TRAIN_BATCH * N_TOKENS, dim=DIM,
                    hidden=HIDDEN):
    import torch

    from gavit_tpu_torch.ops import mlp as M
    from gavit_tpu_torch.ops import philox

    x, w1, b1, w2, b2 = mlp_inputs(dev, m, dim, hidden)
    seed, sites = philox.step_seed(SEED, 4), (2, 3)
    y, h1 = M.mlp_train_kernel(x, w1, b1, w2, b2, seed, sites, DROP_RATE,
                               DROP_RATE)
    y_ref, h1_ref = M.mlp_train_reference(x, w1, b1, w2, b2, seed, sites,
                                          DROP_RATE, DROP_RATE)
    y_fc2 = M.mlp_train_fc2_reference(h1, w2, b2, seed, sites, DROP_RATE,
                                      DROP_RATE)
    uh, uy = ulps(h1, h1_ref), ulps(y, y_fc2)
    err = max(max_err(h1, h1_ref), max_err(y, y_ref))
    check("D mlp train fwd", uh <= 1 and uy <= 1 and torch.isfinite(y).all()
          and rel_err(y, y_ref) <= GRAD_REL_TOL,
          f"bf16 M={m} D={dim} F={hidden} rate {DROP_RATE}: h1 within "
          f"{uh:.0f} ulp, y within {uy:.0f} ulp of the plain fc2 on the "
          f"kernel's h1 (tol 1 ulp); y vs plain chain rel "
          f"{rel_err(y, y_ref):.3e}; max_abs_err {err:.3e}")
    results["D"]["errs"].append(err)
    results["D"]["cases"].append((x, w1, b1, w2, b2, seed, sites))

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    dy = (torch.randn(m, dim, device=dev, generator=g) * 0.01).to(
        torch.bfloat16)
    got = M.mlp_train_bwd_kernel(dy, h1_ref, w2, seed, sites, DROP_RATE,
                                 DROP_RATE)
    want = M.mlp_train_bwd_reference(dy, h1_ref, w2, seed, sites, DROP_RATE,
                                     DROP_RATE)
    names = ("dh1", "go", "db1", "db2", "dye")
    rels = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
    ok = (all(rels[n] <= GRAD_REL_TOL for n in ("dh1", "go", "dye"))
          and all(rels[n] <= BIAS_REL_TOL for n in ("db1", "db2")))
    err = max(max_err(a, b) for a, b in zip(got, want))
    check("D′ mlp train bwd", ok,
          f"bf16 M={m}: rel to max " + ", ".join(
              f"{n} {v:.3e}" for n, v in rels.items())
          + f" (tol {GRAD_REL_TOL:.0e}; db1, db2 {BIAS_REL_TOL:.0e}); "
          f"dye bit-exact {torch.equal(got[4], want[4])}, go bit-exact "
          f"{torch.equal(got[1], want[1])}; max_abs_err {err:.3e}")
    results["D′"]["errs"].append(err)
    results["D′"]["cases"].append((dy, h1_ref, w2, seed, sites))


def check_attention_bwd(dev, results, batch=TRAIN_BATCH, n=N_TOKENS,
                        heads=HEADS):
    import torch

    from gavit_tpu_torch.ops import attention as A

    scale = HEAD_DIM ** -0.5
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    qkv = torch.randn(batch, n, 3 * heads * HEAD_DIM, device=dev,
                      generator=g).to(torch.bfloat16)
    # dO as the output projection's backward hands it over: [B, N, H, d]
    # memory behind the [B, H, N, d] view
    do = torch.randn(batch, n, heads, HEAD_DIM, device=dev,
                     generator=g).to(torch.bfloat16).transpose(1, 2)
    got = A.qkv_attention_bwd_kernel(qkv, do, scale, heads)
    again = A.qkv_attention_bwd_kernel(qkv, do, scale, heads)
    want = A.attention_backward_reference(qkv, do, scale, heads)
    rel, err = rel_err(got, want), max_err(got, want)
    same = torch.equal(got, again)
    check("A′ attention bwd", rel <= GRAD_REL_TOL and same
          and torch.isfinite(got).all().item(),
          f"bf16 B={batch} N={n} H={heads} d={HEAD_DIM}: dqkv rel to max "
          f"{rel:.3e} (tol {GRAD_REL_TOL:.0e}), max_abs_err {err:.3e}; a "
          f"second run bit-equal {same}")
    results["A′"]["errs"].append(err)
    results["A′"]["cases"].append((qkv, do))


def routed_tokens(dev, g, routing, batch, n, dim):
    """``batch·n`` random bf16 tokens and their top-2 of EXPERTS from
    ``g``: by a seeded fp32 router (``'router'``), all on expert 5
    (``'hot'``), or never on experts 0 and 7 (``'empty'``)."""
    import torch

    from gavit_tpu_torch.models.moe import router_topk

    tokens = torch.randn(batch * n, dim, device=dev, generator=g).to(
        torch.bfloat16)
    router = torch.randn(dim, EXPERTS, device=dev, generator=g) * 0.02
    _, idx, _ = router_topk((tokens.float() @ router).reshape(batch, n, -1),
                            TOP_K)
    if routing == "hot":
        idx = torch.full_like(idx, 5)
    elif routing == "empty":
        idx = 1 + idx % (EXPERTS - 2)
    return tokens, idx


def moe_case(dev, routing="router", batch=TRAIN_BATCH, n=N_TOKENS,
             dim=DIM, hidden=HIDDEN):
    """The MoE expert MLP's inputs at the b128 training shapes: T = batch·n·2
    pairs routed by a seeded fp32 router over random tokens (``'router'``),
    all on expert 5 (``'hot'``), or never on experts 0 and 7 (``'empty'``);
    the tiled grouping at ``fused_tm(T)``; x_sorted gathered from the
    tokens (pad rows hold token 0); bf16 weights; dy zero on pad rows, as
    the combine's backward gives it."""
    import torch

    from gavit_tpu_torch.ops import moe_fused as MF

    g = torch.Generator(device=dev).manual_seed(SEED + 51)
    bf = torch.bfloat16
    tokens, idx = routed_tokens(dev, g, routing, batch, n, dim)
    t = idx.numel()
    tm = MF.fused_tm(t, EXPERTS)
    _, src, used, tg, gs = MF.group_by_expert_tiled(idx, EXPERTS, tm)
    x = tokens[src // TOP_K]
    w1, b1, w2, b2 = ((torch.randn(*shape, device=dev, generator=g) * 0.02)
                      .to(bf) for shape in ((EXPERTS, dim, hidden),
                                            (EXPERTS, hidden),
                                            (EXPERTS, hidden, dim),
                                            (EXPERTS, dim)))
    dy = (torch.randn(x.shape, device=dev, generator=g) * 0.01).to(bf) \
        * used[:, None]
    return dict(x=x, w=(w1, b1, w2, b2), dy=dy, tg=tg, gs=gs, tm=tm, t=t,
                used=used)


def mask_applied(got, want, keep):
    """Whether ``got`` applies exactly the Philox mask ``keep``: zero at
    every dropped element; at a kept one zero only where the value is zero
    within the rounding noise of the comparison (the largest difference of
    the two on kept elements: h1 one bf16 ulp apart moves y by ~1e-4, and at
    10^7-10^8 elements a sum cancels to exactly 0 on one side now and then),
    and at most one kept element in a million. A mask that dropped a kept
    element at random would miss both. Returns (ok, a summary)."""
    dropped_nonzero = int((got[~keep] != 0).sum())
    kept_zero = keep & ((got == 0) | (want == 0))
    n = int(kept_zero.sum())
    noise = torch_max_abs(got.float() - want.float(), keep & ~kept_zero)
    at = max(torch_max_abs(want, kept_zero), torch_max_abs(got, kept_zero))
    ok = (dropped_nonzero == 0 and n <= max(1, keep.numel() // 10 ** 6)
          and at <= noise)
    return ok, (f"{n} kept elements zero on one side, |value| there at most "
                f"{at:.3e} against a rounding noise of {noise:.3e}; "
                f"{dropped_nonzero} dropped elements not zero")


def torch_max_abs(t, where) -> float:
    sel = t.float()[where]
    return sel.abs().max().item() if sel.numel() else 0.0


def check_tgmm(results, what, a, b, gs):
    """Kernel tgmm on ``a [R, K]ᵀ · b [R, N]`` grouped by ``gs`` against
    tgmm_reference: within GRAD_REL_TOL of the largest value (one fp32 sum
    rounded once, in another order), finite, an empty expert's dW exactly
    zero, the same bits when run again."""
    import torch

    from gavit_tpu_torch.ops import gmm as GM

    k = GM.tgmm_kernel(a, b, gs)
    again = GM.tgmm_kernel(a, b, gs)
    r = GM.tgmm_reference(a, b, gs, torch.bfloat16)
    torch.cuda.synchronize()
    rel, same = rel_err(k, r), torch.equal(k, again)
    empty = gs == 0
    zeros = not k[empty].any().item()
    check("tgmm grouped dW", rel <= GRAD_REL_TOL and same and zeros
          and torch.isfinite(k).all().item(),
          f"bf16 {what} [{EXPERTS}, {a.shape[1]}, {b.shape[1]}], groups "
          f"{gs.tolist()}: rel to max {rel:.3e} (tol {GRAD_REL_TOL:.0e}), "
          f"the same bits again {same}, empty experts "
          f"{empty.nonzero().flatten().tolist()} zero {zeros}; max_abs_err "
          f"{max_err(k, r):.3e}")
    results["tgmm"]["errs"].append(max_err(k, r))


def check_moe(dev, results):
    """M (erf with dropout 0.1, and tanh at rate 0), M′ and tgmm against
    their plain versions at the b128 routing, with a hot and an empty
    expert, and at b8 (T = 3152 pairs, where ``fused_tm`` gives tm = 32 and
    a 128-row tile straddles experts): the masks (zero patterns)
    bit-exact, h1 within 1 ulp, y, dx, go and dh1 within the bf16
    tolerance of D and D′ relative to the tensor's largest, M's and M′'s
    reruns bit-equal, M′'s dh1 and dx zero on pad rows, dye bit-exact, db1
    and db2 within BIAS_REL_TOL, dW1 and dW2 (rounded to bf16 once from
    fp32 sums) within GRAD_REL_TOL. The masks:
    y and dye hold the output mask and go the hidden one exactly
    (``mask_applied`` against ``ops/philox.py``'s bits)."""
    import torch

    from gavit_tpu_torch.ops import gmm as GM
    from gavit_tpu_torch.ops import moe_fused as MF
    from gavit_tpu_torch.ops import philox

    seed, sites = philox.step_seed(SEED, 6), (5, 6)
    f = HIDDEN
    for routing, batch in (("router", TRAIN_BATCH), ("hot", TRAIN_BATCH),
                           ("empty", TRAIN_BATCH), ("router", 8)):
        c = moe_case(dev, routing, batch)
        x, (w1, b1, w2, b2), dy, tg, tm = (c["x"], c["w"], c["dy"], c["tg"],
                                           c["tm"])
        cap = x.shape[0]
        keep_h = philox.keep_mask((cap, f), seed, sites[0], DROP_RATE,
                                  device=dev)
        keep_o = philox.keep_mask((cap, DIM), seed, sites[1], DROP_RATE,
                                  device=dev)
        for rate, approx in ((DROP_RATE, False), (0.0, True)):
            y, h1 = MF.moe_fwd_kernel(x, w1, b1, w2, b2, tg, tm, seed, sites,
                                      rate, rate, approx)
            y2, h12 = MF.moe_fwd_kernel(x, w1, b1, w2, b2, tg, tm, seed,
                                        sites, rate, rate, approx)
            y_ref, h1_ref = MF.moe_fwd_reference(x, w1, b1, w2, b2, tg, tm,
                                                 seed, sites, rate, rate,
                                                 approx)
            torch.cuda.synchronize()
            same = torch.equal(y, y2) and torch.equal(h1, h12)
            del y2, h12
            masked, how = mask_applied(y, y_ref, keep_o if rate else
                                       torch.ones_like(keep_o))
            uh = ulps(h1, h1_ref)
            ry = rel_err(y, y_ref)
            err = max(max_err(y, y_ref), max_err(h1, h1_ref))
            check("M moe expert mlp fwd", masked and uh <= 1 and same
                  and ry <= GRAD_REL_TOL and torch.isfinite(y).all().item(),
                  f"bf16 {routing} b{batch} T={c['t']} cap={cap} tm={tm} "
                  f"{'tanh' if approx else 'erf'} rate {rate}: y holds the "
                  f"output mask exactly {masked} ({how}), h1 within "
                  f"{uh:.0f} ulp (tol 1), y rel "
                  f"to max {ry:.3e} (tol {GRAD_REL_TOL:.0e}), a second run "
                  f"bit-equal {same}; max_abs_err {err:.3e}")
            results["M"]["errs"].append(err)
            if routing == "router" and batch == TRAIN_BATCH and not approx:
                results["M"]["cases"].append(c)
        got, again = (MF.moe_bwd_kernel(dy, h1_ref, w1, w2, tg, tm, seed,
                                        sites, DROP_RATE, DROP_RATE, False,
                                        c["gs"]) for _ in range(2))
        want = MF.moe_bwd_reference(dy, h1_ref, w1, w2, tg, tm, seed, sites,
                                    DROP_RATE, DROP_RATE, False)
        torch.cuda.synchronize()
        same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
        del again
        names = ("dx", "go", "dh1", "db1", "db2", "dye")
        rels = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
        pad = ~c["used"]
        pads = ((got[2][pad] == 0).all() and (got[0][pad] == 0).all()).item()
        masked, how = mask_applied(got[1], want[1], keep_h)
        ok = (all(rels[n] <= GRAD_REL_TOL for n in ("dx", "go", "dh1"))
              and all(rels[n] <= BIAS_REL_TOL for n in ("db1", "db2"))
              and torch.equal(got[5], want[5]) and pads and masked and same
              and all(torch.isfinite(a).all().item() for a in got))
        err = max(max_err(a, b) for a, b in zip(got, want))
        check("M′ moe expert mlp bwd", ok,
              f"bf16 {routing} b{batch} tm={tm} rate {DROP_RATE}: rel to "
              f"max " + ", ".join(
                  f"{n} {v:.3e}" for n, v in rels.items())
              + f" (tol {GRAD_REL_TOL:.0e}; db1, db2 {BIAS_REL_TOL:.0e}); "
              f"dye bit-exact {torch.equal(got[5], want[5])}, go holds the "
              f"hidden mask exactly {masked} ({how}), dh1 and dx zero on "
              f"pad rows {pads}, a second run bit-equal {same}; max_abs_err "
              f"{err:.3e}")
        results["M′"]["errs"].append(err)
        _, go, dh1, _, _, dye = got
        for what, a, b in (("dW1", x, dh1), ("dW2", go, dye)):
            check_tgmm(results, f"{routing} {what} over the {cap} cap-padded "
                       f"rows", a, b, c["gs"])
        if routing == "router" and batch == TRAIN_BATCH:
            results["M′"]["cases"].append((dy, h1_ref, go, dh1, dye))


def gmm_case(dev, routing="router", batch=TRAIN_BATCH, n=N_TOKENS, dim=DIM,
             hidden=HIDDEN):
    """Kernel N-gmm's inputs as the unfused engine gives them: the pairs of
    ``batch`` images routed as in ``moe_case`` (T = batch·n·2), grouped by
    expert with no padding (``group_by_expert``), x the pairs' token rows
    [T, D], bf16 W1 [E, D, F] and W2 [E, F, D], the group sizes on the
    card; random h [T, F] (fc2's input), dh [T, F] (fc1's dx = dh·W1ᵀ) and
    dy [T, D] (fc2's dh = dy·W2ᵀ)."""
    import torch

    from gavit_tpu_torch.ops import moe_grouped as MG

    g = torch.Generator(device=dev).manual_seed(SEED + 52)
    tokens, idx = routed_tokens(dev, g, routing, batch, n, dim)
    _, src, sizes = MG.group_by_expert(idx, EXPERTS)
    t = src.numel()

    def draw(*shape, scale):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(
            torch.bfloat16)

    w1 = draw(EXPERTS, dim, hidden, scale=0.02)
    dh = draw(t, hidden, scale=0.01)
    w2 = draw(EXPERTS, hidden, dim, scale=0.02)
    h = draw(t, hidden, scale=0.5)
    dy = draw(t, dim, scale=0.01)
    return dict(x=tokens[src // TOP_K], w1=w1, w2=w2, h=h, dh=dh, dy=dy,
                gs=sizes, t=t, routing=routing)


def check_gmm(dev, results):
    """N-gmm in both forms at each of the unfused engine's four GEMMs (fc1
    x·W1 and its dx dh·W1ᵀ, fc2 h·W2 and its dh dy·W2ᵀ) against its plain
    version at the b128 routing, with a hot and an empty expert, and at
    b127 (T = 50038, no multiple of the 128-row tile): within GRAD_REL_TOL
    of the largest value (bf16 outputs of fp32 sums taken in another
    order), the same bits when run again; tgmm's two dW on the same packed
    rows (``check_tgmm``); and the differentiable op, forward and both
    gradients, on the b127 rows as they are."""
    import torch

    from gavit_tpu_torch.ops import gmm as GM

    for routing, batch in (("router", TRAIN_BATCH), ("hot", TRAIN_BATCH),
                           ("empty", TRAIN_BATCH),
                           ("router", TRAIN_BATCH - 1)):
        c = gmm_case(dev, routing, batch)
        gs = c["gs"]
        for form, a, w, tr in (("fwd", c["x"], c["w1"], False),
                               ("transposed", c["dh"], c["w1"], True),
                               ("fwd", c["h"], c["w2"], False),
                               ("transposed", c["dy"], c["w2"], True)):
            got = GM.gmm_kernel(a, w, gs, tr)
            again = GM.gmm_kernel(a, w, gs, tr)
            want = GM.gmm_reference(a, w, gs, tr)
            torch.cuda.synchronize()
            rel, same = rel_err(got, want), torch.equal(got, again)
            err = max_err(got, want)
            check(f"N-gmm {form}", rel <= GRAD_REL_TOL and same
                  and torch.isfinite(got).all().item(),
                  f"bf16 {routing} T={c['t']} groups {gs.tolist()} "
                  f"[{a.shape[1]}] x {list(w.shape)}{'ᵀ' if tr else ''} → "
                  f"{list(got.shape)}: rel to max {rel:.3e} (tol "
                  f"{GRAD_REL_TOL:.0e}), the same bits again {same}; "
                  f"max_abs_err {err:.3e}")
            results["N-gmm"]["errs"].append(err)
        # tgmm on the same packed rows, as the unfused engine's backward
        # takes them: dW1 = xᵀ·dh and dW2 = hᵀ·dy
        for what, a, b in (("dW1", c["x"], c["dh"]), ("dW2", c["h"], c["dy"])):
            check_tgmm(results, f"{routing} {what} over the T={c['t']} packed "
                       f"rows", a, b, gs)
        if routing == "router" and batch == TRAIN_BATCH:  # for the times
            results["N-gmm"]["cases"].append(
                {k: c[k] for k in ("x", "w1", "h", "dh", "dy", "gs", "t")})
    x, w1, dh, gs = c["x"], c["w1"], c["dh"], c["gs"]
    got, refs = {}, {}
    for impl, out in (("auto", got), ("reference", refs)):
        xi, wi = (a.detach().clone().requires_grad_(True) for a in (x, w1))
        y = GM.ragged_matmul(xi, wi, gs, impl=impl)
        y.backward(dh)
        out.update(y=y.detach(), dx=xi.grad, dw=wi.grad)
    rels = {k: rel_err(got[k], refs[k]) for k in got}
    check("N-gmm op", got["y"].shape == (c["t"], HIDDEN)
          and max(rels.values()) <= GRAD_REL_TOL,
          f"ragged_matmul on T={c['t']} rows (no multiple of the tile, not "
          f"padded) against impl='reference': rel to max " + ", ".join(
              f"{k} {v:.3e}" for k, v in rels.items())
          + f" (tol {GRAD_REL_TOL:.0e})")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the JAX package's op-level entry points: kernels I/I′, J/J′, G and E
# ---------------------------------------------------------------------------


def bhnd_inputs(dev, b, n, seed, heads=HEADS):
    """q, k, v and dO ``[b, heads, n, 64]`` bf16, each contiguous."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, heads, n, HEAD_DIM, device=dev,
                        generator=g).to(torch.bfloat16) for _ in range(4)]


def phase_ops(dev, results, batch=TRAIN_BATCH, n=N_TOKENS):
    """The slice's main path, through the entry points a user of the JAX
    package's ops calls, at the 224-px step's shapes: counts zeroed, then
    ``multi_head_attention`` (impl 'auto': kernels I, I′) and
    ``fused_attention_v2`` (J, J′) forward and backward at b128 × 12 heads
    × 197 × 64; ``fused_dropout_add`` (G, and F in its backward) at the
    block's residual sites [128, 197, 768]; and the self-check bench.py
    runs on the TPU: ``kernel_mask`` (E at both sites) at the b128 MLP rows,
    then the training MLP (D, D′) held to a plain MLP armed with E's masks.
    The counts are read just after; then every output is held to its plain
    version. Returns those counts."""
    import torch
    import torch.nn.functional as F

    from gavit_tpu_torch.ops import attention as A
    from gavit_tpu_torch.ops import dropout as DR
    from gavit_tpu_torch.ops import mlp as M
    from gavit_tpu_torch.ops import philox

    m = batch * n
    bf, scale = torch.bfloat16, HEAD_DIM ** -0.5
    q, k, v, do = bhnd_inputs(dev, batch, n, SEED + 81)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    g = torch.Generator(device=dev).manual_seed(SEED + 82)
    y, r, gy = (torch.randn(batch, n, DIM, device=dev, generator=g).to(bf)
                for _ in range(3))
    y, r = y.requires_grad_(True), r.requires_grad_(True)
    gseed, gsite = philox.step_seed(SEED, 8), 7
    x, w1, b1, w2, b2 = mlp_inputs(dev, m)
    mseed, sites = philox.step_seed(SEED, 9), (2, 3)
    mleaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]

    reset_counts()
    outs = {}
    for key, fn in (("I", lambda *a: A.multi_head_attention(*a, impl="auto")),
                    ("J", A.fused_attention_v2)):
        o = fn(*leaves, scale)
        outs[key] = (o.detach(), torch.autograd.grad(o, leaves, do))
    out_g = DR.fused_dropout_add(y, r, gseed, gsite, DROP_RATE)
    grads_g = torch.autograd.grad(out_g, (y, r), gy)
    hm, om = M.kernel_mask(mseed, sites, m, HIDDEN, DROP_RATE, d=DIM,
                           out_rate=DROP_RATE)
    y_mlp = M.fused_mlp(*mleaves, mseed, sites, DROP_RATE, DROP_RATE)
    grads_mlp = torch.autograd.grad((y_mlp.float() ** 2).sum(), mleaves)
    torch.cuda.synchronize()
    counts = read_counts()
    want = expected({"I": 1, "I′": 1, "J": 1, "J′": 1, "G": 1, "F": 1,
                     "E": 1, "D": 1, "D′": 1})
    if counts != want:
        raise AssertionError(f"ops: launches {counts}, expected {want}")
    log(f"[ops] multi_head_attention, fused_attention_v2, fused_dropout_add, "
        f"kernel_mask + fused_mlp launched {counts}")

    want_o = A.attention_reference(q, k, v, scale)
    want_d = A.attention_bhnd_backward_reference(q, k, v, do, scale)
    for key, (o, grads) in outs.items():
        rels = [rel_err(o, want_o)] + [rel_err(a, w)
                                       for a, w in zip(grads, want_d)]
        check(f"{key}/{key}′ attention [B, H, N, d]", max(rels) <= ATTN_TOL[
            "bf16"] and torch.isfinite(o).all().item(),
              f"bf16 B={batch} H={HEADS} N={n} d={HEAD_DIM}: o, dq, dk, dv "
              f"rel to max " + ", ".join(f"{x:.3e}" for x in rels)
              + f" (tol {ATTN_TOL['bf16']:.0e})")
        results[key]["errs"].append(max_err(o, want_o))
        results[f"{key}′"]["errs"].append(max(max_err(a, w) for a, w in zip(
            grads, want_d)))
    del want_d, outs

    want_g = r.detach() + DR.dropout_reference(y.detach(), gseed, gsite,
                                               DROP_RATE)
    same = (torch.equal(out_g, want_g),
            torch.equal(grads_g[0], DR.dropout_reference(gy, gseed, gsite,
                                                         DROP_RATE)),
            torch.equal(grads_g[1], gy))
    check("G dropout add", all(same),
          f"bf16 [{batch}, {n}, {DIM}] rate {DROP_RATE}: out bit-equal to "
          f"r + F(y) {same[0]}; d_y bit-equal to F(g) {same[1]}, d_r to g "
          f"{same[2]} (max_abs_err {max_err(out_g, want_g):.3e})")
    results["G"]["errs"].append(max_err(out_g, want_g))
    results["G"]["cases"].append((y.detach(), r.detach(), gseed, gsite))

    same = [torch.equal(mk, philox.keep_mask(
        mk.shape, mseed, s, DROP_RATE, device=dev).float())
        for mk, s in ((hm, sites[0]), (om, sites[1]))]
    rates = [mk.mean().item() for mk in (hm, om)]
    check("E kernel_mask", all(same) and all(
        abs(x - (1 - DROP_RATE)) <= 0.02 for x in rates),
          f"[{m}, {HIDDEN}] site {sites[0]} and [{m}, {DIM}] site "
          f"{sites[1]} rate {DROP_RATE}: bit-equal to keep_mask {same}, "
          f"keep rates {rates[0]:.5f}, {rates[1]:.5f} (within 0.02 of "
          f"{1 - DROP_RATE})")
    results["E"]["errs"].append(0.0)
    results["E"]["cases"].append((mseed, sites, m))

    def armed(x, w1, b1, w2, b2):
        """The plain MLP with E's masks, in tensor ops (fp32 products)."""
        h1 = (torch.matmul(x.float(), w1.float().t()) + b1.float()).to(bf)
        hid = torch.where(hm > 0.5, F.gelu(h1.float()) / (1 - DROP_RATE),
                          0.0)
        out = torch.matmul(hid.to(bf).float(), w2.float().t()) + b2.float()
        return torch.where(om > 0.5, out / (1 - DROP_RATE), 0.0).to(bf)

    ref_leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    y_ref = armed(*ref_leaves)
    grads_ref = torch.autograd.grad((y_ref.float() ** 2).sum(), ref_leaves)
    rels = [rel_err(y_mlp, y_ref)] + [rel_err(a, w) for a, w in zip(
        grads_mlp, grads_ref)]
    check("D/D′ against E's masks", max(rels) <= GRAD_REL_TOL,
          f"bf16 M={m} D={DIM} F={HIDDEN}: y, dx, dw1, db1, dw2, db2 rel to "
          f"max " + ", ".join(f"{x:.3e}" for x in rels)
          + f" (tol {GRAD_REL_TOL:.0e})")
    return counts


def check_bhnd_attention(dev, results, cases=((1, 2), (50, 8), (197, 4),
                                               (577, 4), (640, 4),
                                               (N_512, 2))):
    """I/I′ and J/J′ against their plain versions within 2e-2 of the
    largest value (o, dq, dk, dv) at one token, a partial tile, 224 px (the
    forward's single pass), 384 px and I's last length (its streamed pass),
    each rerun for the same bits (J alone at 512 px, 1025 tokens, past I's
    range); then 641 tokens through ``attention_pallas``: L and L′
    launched, no I."""
    import torch

    from gavit_tpu_torch.ops import attention as A

    scale = HEAD_DIM ** -0.5
    entries = {"I": "v1", "J": "v2"}
    for n, b in cases:
        q, k, v, do = bhnd_inputs(dev, b, n, SEED + 83 + n)
        want_o = A.attention_reference(q, k, v, scale)
        want_d = A.attention_bhnd_backward_reference(q, k, v, do, scale)
        for key in ("I", "J") if A.pallas_route(n, HEAD_DIM, q.dtype) == "I" \
                else ("J",):
            e = entries[key]
            o, o2 = (A.bhnd_kernel(e, False, q, k, v, scale)
                     for _ in range(2))
            grads, grads2 = (A.bhnd_kernel(e, True, q, k, v, do, scale)
                             for _ in range(2))
            torch.cuda.synchronize()
            rels = [rel_err(o, want_o)] + [rel_err(a, w) for a, w in zip(
                grads, want_d)]
            same = torch.equal(o, o2) and all(
                torch.equal(a, a2) for a, a2 in zip(grads, grads2))
            check(f"{key}/{key}′ attention [B, H, N, d]",
                  max(rels) <= ATTN_TOL["bf16"] and same
                  and torch.isfinite(o).all().item(),
                  f"bf16 B={b} H={HEADS} N={n}: o, dq, dk, dv rel to max "
                  + ", ".join(f"{x:.3e}" for x in rels)
                  + f" (tol {ATTN_TOL['bf16']:.0e}); a rerun bit-equal "
                  f"{same}")
            results[key]["errs"].append(max_err(o, want_o))
            results[f"{key}′"]["errs"].append(max(
                max_err(a, w) for a, w in zip(grads, want_d)))
        del want_d

    n, b = 641, 2
    q, k, v, do = bhnd_inputs(dev, b, n, SEED + 84)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    before = read_counts()
    o = A.attention_pallas(*leaves, scale)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    moved = {key: c - before[key] for key, c in read_counts().items()}
    want_o = A.attention_reference(q, k, v, scale)
    want_d = A.attention_bhnd_backward_reference(q, k, v, do, scale)
    rels = [rel_err(o, want_o)] + [rel_err(a, w) for a, w in zip(grads,
                                                                  want_d)]
    launched = {key: c for key, c in moved.items() if c}
    check("attention_pallas past I", moved == expected({"L": 1, "L′": 1})
          and max(rels) <= ATTN_TOL["bf16"],
          f"bf16 B={b} H={HEADS} N={n} takes route "
          f"{A.pallas_route(n, HEAD_DIM, o.dtype)}: launched {launched}; o, "
          f"dq, dk, dv rel to max " + ", ".join(f"{x:.3e}" for x in rels))


def phase_op_times(dev, results, card, batch=TRAIN_BATCH, n=N_TOKENS):
    """I, I′, J, J′ at b128 × 12 × 197 × 64 against the plain versions and
    sdpa (forward; forward and backward), G at [128, 197, 768] and E at
    the b128 MLP rows (both sites) against their plain versions (no one
    PyTorch call computes either)."""
    import torch
    import torch.nn.functional as F

    from gavit_tpu_torch.ops import attention as A
    from gavit_tpu_torch.ops import dropout as DR
    from gavit_tpu_torch.ops import mlp as M
    from gavit_tpu_torch.ops import philox

    rows = {}
    h, d, scale = HEADS, HEAD_DIM, HEAD_DIM ** -0.5
    q, k, v, do = bhnd_inputs(dev, batch, n, SEED + 81)
    lq, lk, lv = (t.clone().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(lq, lk, lv)
        torch.autograd.grad(out, (lq, lk, lv), do)

    fwd_bound = bound(4 * batch * h * n * n * d, 4 * batch * h * n * d * 2)
    bwd_bound = bound(10 * batch * h * n * n * d, 7 * batch * h * n * d * 2)
    p_fwd = cuda_ms(lambda: A.attention_reference(q, k, v, scale), iters=5)
    p_bwd = cuda_ms(lambda: A.attention_bhnd_backward_reference(
        q, k, v, do, scale), iters=5)
    l_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    l_bwd = cuda_ms(sdpa_fwd_bwd)
    for key, e in (("I", "v1"), ("J", "v2")):
        rows[key] = (cuda_ms(lambda: A.bhnd_kernel(e, False, q, k, v, scale)),
                     p_fwd, l_fwd) + fwd_bound
        rows[f"{key}′"] = (cuda_ms(lambda: A.bhnd_kernel(
            e, True, q, k, v, do, scale)), p_bwd, l_bwd) + bwd_bound

    y, r, gseed, gsite = results["G"]["cases"][0]
    rows["G"] = (cuda_ms(lambda: DR.dropout_add_kernel(y, r, gseed, gsite,
                                                       DROP_RATE)),
                 cuda_ms(lambda: DR.dropout_add_reference(
                     y, r, gseed, gsite, DROP_RATE), iters=5),
                 None) + bound(0, 3 * y.numel() * y.element_size())

    mseed, sites, m = results["E"]["cases"][0]
    rows["E"] = (cuda_ms(lambda: M.kernel_mask(mseed, sites, m, HIDDEN,
                                               DROP_RATE, d=DIM,
                                               out_rate=DROP_RATE)),
                 cuda_ms(lambda: [philox.keep_mask(
                     shape, mseed, s, DROP_RATE, device=dev).float()
                     for shape, s in (((m, HIDDEN), sites[0]),
                                      ((m, DIM), sites[1]))], iters=5),
                 None) + bound(0, m * (HIDDEN + DIM) * 4)
    for key in ("I", "I′", "J", "J′", "G", "E"):
        km, pm, lm, bms, by = rows[key]
        log(f"[time] {key}: kernel {km:.4f} ms, plain {pm:.4f} ms, library "
            f"{'n/a' if lm is None else f'{lm:.4f} ms'}, bound {bms:.4f} ms "
            f"({by}) ({card})")
    # G and E alone on the device (no one PyTorch call computes either)
    results["G"]["device"] = (device_ms(lambda: DR.dropout_add_kernel(
        y, r, gseed, gsite, DROP_RATE)), None)
    results["E"]["device"] = (device_ms(lambda: M.kernel_mask(
        mseed, sites, m, HIDDEN, DROP_RATE, d=DIM, out_rate=DROP_RATE)), None)
    log(f"[time] G on [{batch}, {n}, {DIM}] bf16 and E at both sites of "
        f"M={m} alone on the device (20 launches between two events): G "
        f"{results['G']['device'][0]:.4f} ms (bound {rows['G'][3]:.4f}), E "
        f"{results['E']['device'][0]:.4f} ms (bound {rows['E'][3]:.4f}) "
        f"({card})")
    # I′ and J′ alone on the device, beside sdpa's forward and backward
    lib_alone = device_ms(sdpa_fwd_bwd)
    for key, e in (("I′", "v1"), ("J′", "v2")):
        results[key]["device"] = (device_ms(lambda: A.bhnd_kernel(
            e, True, q, k, v, do, scale)), lib_alone)
        log(f"[time] {key} at b{batch} alone on the device (20 launches "
            f"between two events): kernel {results[key]['device'][0]:.4f} "
            f"ms, sdpa fwd+bwd {lib_alone:.4f} ms ({card})")
    return rows


def gated_weights(cfg) -> dict:
    """Weights from SEED with the graph gates at GATE and learned adjacency
    logits drawn from a standard normal, keyed by '/'-joined Flax paths as
    an ``.npz`` would hold them. Gates and logits are zero at init, which
    would hide the graph branch from the logits (or make its adjacency
    uniform)."""
    import torch

    from gavit_tpu_torch.models.vit import build_model, init_params
    from gavit_tpu_torch.utils.convert import flax_layout

    model = init_params(build_model(cfg.model),
                        torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 5)
    with torch.no_grad():
        for gb in model.graphs:
            gb.gate.fill_(GATE)
            if gb.adj_logits is not None:
                gb.adj_logits.copy_(torch.randn(gb.adj_logits.shape,
                                                generator=g))
    out = {}
    for path, (p, transpose) in flax_layout(model).items():
        arr = p.detach().numpy()
        out[path] = arr.T if transpose else arr
    return out


class PinnedRouting:
    """Records the expert choices of the MoE blocks in one forward and hands
    them to later forwards: ``models.moe.router_topk`` wrapped, its gates
    taken from each forward's own fp32 probabilities at the recorded
    choices. A router at init (σ 0.02) ties experts to within bf16 noise,
    so a forward through other but equally right roundings flips some top-2
    choices, and each flip changes a token's branch outright; with the
    choices pinned the comparison holds the kernels' arithmetic, and
    ``flips`` counts the choices the replayed forwards would have made
    otherwise."""

    def __init__(self):
        from gavit_tpu_torch.models import moe

        self.moe, self.original = moe, moe.router_topk
        self.recorded, self.replay, self.i = [], False, 0
        self.choices, self.flips = 0, []  # per replayed forward

    def __enter__(self):
        self.moe.router_topk = self.topk
        return self

    def __exit__(self, *exc):
        self.moe.router_topk = self.original

    def start_record(self):
        self.recorded, self.replay = [], False

    def start_replay(self):
        self.replay, self.i, self.choices = True, 0, 0
        self.flips.append(0)

    def topk(self, logits, k, *, normalize_gates=True):
        import torch

        vals, idx, aux = self.original(logits, k,
                                       normalize_gates=normalize_gates)
        if not self.replay:
            self.recorded.append(idx)
            return vals, idx, aux
        pinned = self.recorded[self.i]
        self.i += 1
        self.choices += idx.numel()
        self.flips[-1] += int((torch.sort(idx, -1).values
                               != torch.sort(pinned, -1).values).sum())
        vals = torch.gather(torch.softmax(logits.float(), -1), -1, pinned)
        if normalize_gates:
            vals = vals / vals.sum(-1, keepdim=True)
        return vals, pinned, aux


def phase_slice(cfg, weights, dev, name, n_images=8, expect=None,
                ref_cfg=None):
    """The bf16 forward of ``n_images`` through the kernels against the
    plain versions (and fp32 plain versions, for scale). ``expect``: the
    nonzero launch counts of the kernels' forward, asserted. ``ref_cfg``:
    the plain versions' config, where it must pin what ``cfg`` resolves on
    the card (the MoE engine: 'auto' takes another threshold without the
    kernels)."""
    import numpy as np
    import torch

    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.serving import Predictor

    s = cfg.data.image_size
    imgs = np.random.default_rng(SEED).integers(
        0, 256, (n_images, s, s, 3), np.uint8)
    x = val_preprocess(torch.from_numpy(imgs).to(dev))
    probs, counts = {}, None
    pinned = PinnedRouting() if cfg.model.moe.enabled else None
    with pinned or contextlib.nullcontext():
        for precision, impl in (("bf16", "auto"), ("bf16", "reference"),
                                ("fp32", "reference")):
            model = Predictor(cfg if impl == "auto" else (ref_cfg or cfg),
                              weights, precision=precision, device=dev,
                              impl=impl).model
            if impl == "auto":
                torch.cuda.synchronize()
                reset_counts()
            elif pinned is not None:
                pinned.start_replay()
            with torch.inference_mode():
                logits = model(x)
            if impl == "auto":
                torch.cuda.synchronize()
                counts = read_counts()
            if logits.shape != (n_images, cfg.model.num_classes) or \
                    not torch.isfinite(logits).all():
                raise AssertionError(f"{precision}/{impl} logits: bad shape "
                                     f"{tuple(logits.shape)} or non-finite")
            probs[(precision, impl)] = torch.sigmoid(logits.float())
            del model
    err = max_err(probs[("bf16", "auto")], probs[("bf16", "reference")])
    err32 = max_err(probs[("bf16", "auto")], probs[("fp32", "reference")])
    ok = err <= PROB_TOL
    pin = ("" if pinned is None else
           f" (the plain forwards on the kernels' expert choices: without "
           f"them the bf16 and fp32 ones would have made "
           f"{' and '.join(map(str, pinned.flips))} of {pinned.choices} "
           f"choices otherwise)")
    log(f"[slice] {name} {s} px bf16, gates {GATE}, {n_images} images: "
        f"kernels vs plain versions max |dp| {err:.3e} (tol {PROB_TOL:.0e}) "
        f"{'ok' if ok else 'FAIL'}; bf16 kernels vs fp32 plain max |dp| "
        f"{err32:.3e}{pin}")
    if not ok:
        raise AssertionError("the slice through the kernels disagrees with "
                             "the plain versions")
    log(f"[slice] kernel launches in that forward: "
        + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if expect is not None and counts != expected(expect):
        raise AssertionError(f"launch counts {counts}, expected "
                             f"{expected(expect)}")
    return counts


# each kernel's launch counter: (module, attribute)
COUNTERS = {"A": ("attention", "KERNEL_LAUNCHES"),
            "A′": ("attention", "BWD_KERNEL_LAUNCHES"),
            "B": ("mlp", "KERNEL_LAUNCHES"),
            "C": ("graph_ops", "KERNEL_LAUNCHES"),
            "D": ("mlp", "TRAIN_FWD_LAUNCHES"),
            "D′": ("mlp", "TRAIN_BWD_LAUNCHES"),
            "F": ("dropout", "KERNEL_LAUNCHES"),
            "K": ("attention", "LONG_KERNEL_LAUNCHES"),
            "K′": ("attention", "LONG_BWD_KERNEL_LAUNCHES"),
            "L": ("attention", "LARGE_KERNEL_LAUNCHES"),
            "L′": ("attention", "LARGE_BWD_KERNEL_LAUNCHES"),
            "H": ("dropout", "GELU_LAUNCHES"),
            "H′": ("dropout", "GELU_BWD_LAUNCHES"),
            "M": ("moe_fused", "KERNEL_LAUNCHES"),
            "M′": ("moe_fused", "BWD_KERNEL_LAUNCHES"),
            "tgmm": ("gmm", "TGMM_LAUNCHES"),
            "N-gmm": ("gmm", "KERNEL_LAUNCHES"),
            "I": ("attention", "V1_KERNEL_LAUNCHES"),
            "I′": ("attention", "V1_BWD_KERNEL_LAUNCHES"),
            "J": ("attention", "V2_KERNEL_LAUNCHES"),
            "J′": ("attention", "V2_BWD_KERNEL_LAUNCHES"),
            "G": ("dropout", "ADD_LAUNCHES"),
            "E": ("mlp", "MASK_LAUNCHES")}


def expected(nonzero: dict) -> dict:
    """Every counter at 0 but those named."""
    return {k: nonzero.get(k, 0) for k in COUNTERS}


def reset_counts():
    import importlib

    for mod, attr in COUNTERS.values():
        setattr(importlib.import_module(f"gavit_tpu_torch.ops.{mod}"), attr, 0)


def read_counts():
    import importlib

    return {k: getattr(importlib.import_module(f"gavit_tpu_torch.ops.{mod}"),
                       attr) for k, (mod, attr) in COUNTERS.items()}


def phase_serve(cfg, weights, dev):
    import numpy as np
    from PIL import Image

    sys.path.insert(0, str(ROOT / "scripts"))
    import serve_torch
    from gavit_tpu_torch.serving import Predictor

    predictor = Predictor(cfg, weights, precision="bf16", device=dev)
    reference = Predictor(cfg, weights, precision="bf16", device=dev,
                          impl="reference")
    predictor.warmup()
    s = cfg.data.image_size
    server = serve_torch.GavitHTTPServer(
        ("127.0.0.1", 0),
        serve_torch.build_handler(predictor, s, serve_torch.model_desc(cfg)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(SEED + 1)

    def request(path, body=None, ctype="application/json"):
        req = urllib.request.Request(base + path, data=body, method=(
            "POST" if body is not None else "GET"))
        if body is not None:
            req.add_header("Content-Type", ctype)
        with urllib.request.urlopen(req, timeout=300) as r:
            if r.status != 200:
                raise AssertionError(f"{path}: HTTP {r.status}")
            return json.loads(r.read())

    def predict_check(name, images, body, ctype="application/json"):
        out = request("/predict", body, ctype)
        probs = np.asarray(out["probabilities"], np.float32)
        want = reference.predict_proba(images)
        n = images.shape[0] if images.ndim == 4 else 1
        ok = (probs.shape == (n, cfg.model.num_classes)
              and np.isfinite(probs).all()
              and (probs >= 0).all() and (probs <= 1).all())
        err = float(np.abs(probs - want).max()) if ok else float("inf")
        ok = ok and err <= PROB_TOL
        log(f"[serve] POST /predict {name}: 200, probabilities "
            f"{list(probs.shape)}, max |dp| vs plain-version Predictor "
            f"{err:.3e} (tol {PROB_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"served {name} disagrees with the plain "
                                 "versions")

    try:
        reset_counts()
        health = request("/healthz")
        log(f"[serve] GET /healthz: 200 {health}")
        one = rng.integers(0, 256, (s, s, 3), np.uint8)
        predict_check("1 image as JSON", one,
                      json.dumps(one.tolist()).encode())
        png = rng.integers(0, 256, (s, s, 3), np.uint8)
        buf = io.BytesIO()
        Image.fromarray(png).save(buf, format="PNG")
        predict_check("1 PNG", png, buf.getvalue(), "image/png")
        for n in (8, 64):
            batch = rng.integers(0, 256, (n, s, s, 3), np.uint8)
            predict_check(f"batch of {n} as JSON", batch,
                          json.dumps(batch.tolist()).encode())
        stats = request("/stats")
        log(f"[serve] GET /stats: 200 {stats}")
        counts = read_counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    device_calls = 4  # 1 image, 1 PNG, bucket 8, bucket 128
    log(f"[serve] kernel launches over {device_calls} device calls: "
        + ", ".join(f"{k} {v}" for k, v in counts.items()))
    depth, n_graph = cfg.model.depth, len(set(cfg.model.graph_insert_after()))
    expect = expected({"A": depth * device_calls, "B": depth * device_calls,
                       "C": n_graph * device_calls})
    if counts != expect:
        raise AssertionError(f"launch counts {counts}, expected {expect}")
    return predictor, reference, counts


def train_config(overrides=()):
    """vit_b16_graph2 at batch 128 with a warmup of 5 steps (5 steps an
    epoch of a 640-image synthetic set with learnable class stripes)."""
    from gavit_tpu_torch import load_config

    return load_config(str(CONFIG), [
        f"data.batch_size={TRAIN_BATCH}", "data.synthetic_size=640",
        "data.synthetic_learnable=true", "training.warmup_epochs=1",
        f"training.seed={SEED}", *overrides])


def train_config_384():
    """finetune_384 at its batch 16 with a warmup of 5 steps (an 80-image
    synthetic set) and the 224-px run's lr of 1e-4: the file's 3e-5 is a
    fine-tune's, from pretrained weights, and moves random weights too
    little for 30 steps to show learning."""
    from gavit_tpu_torch import load_config

    return load_config(str(CONFIG_384), [
        "data.synthetic_size=80", "data.synthetic_learnable=true",
        "training.warmup_epochs=1", "training.learning_rate=1e-4",
        f"training.seed={SEED}"])


def large_config(size: int, overrides=()):
    """vit_b16_graph2 at ``size`` px (512 or 1024), as a user selects it:
    ``model.img_size`` and ``data.image_size`` set on the command line."""
    from gavit_tpu_torch import load_config

    return load_config(str(CONFIG), [f"model.img_size={size}",
                                     f"data.image_size={size}", *overrides])


def train_config_large(size: int, batch: int, remat: bool):
    """vit_b16_graph2 at ``size`` px and ``batch`` with a warmup of 5 steps
    (5 steps an epoch of a synthetic set with learnable class stripes)."""
    return large_config(size, [
        f"data.batch_size={batch}", f"data.synthetic_size={5 * batch}",
        "data.synthetic_learnable=true", "training.warmup_epochs=1",
        f"training.seed={SEED}", f"model.remat={str(remat).lower()}"])


def held_loss(trainer, batches) -> float:
    """The mean loss of the trainer's model over ``batches`` in eval mode
    (no dropout) on the validation preprocessing: the same number for the
    same weights, so it can show learning where a b16 training loss is
    too noisy to."""
    import torch

    from gavit_tpu_torch.ops.preprocess import val_preprocess

    trainer.model.eval()
    total = 0.0
    with torch.no_grad():
        for images, labels in batches:
            x = val_preprocess(torch.from_numpy(images).to(trainer.device))
            loss, _ = trainer.criterion(
                trainer.model(x), torch.from_numpy(labels).to(trainer.device),
                trainer.pos_weight)
            total += loss.item()
    trainer.model.train()
    return total / len(batches)


def phase_train(cfg, dev, name, expect, steps_compare=5, steps_learn=30):
    """The training step through scripts/train_torch.py's entry points;
    ``expect``: the nonzero launch counts of one step, asserted. The
    learning check (``steps_learn`` steps must lower the held loss) is left
    out when ``steps_learn`` is not past ``steps_compare``."""
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import train_torch

    dataset = train_torch.create_dataset(cfg)
    bs = cfg.data.batch_size
    trainers = {impl: train_torch.build_trainer(cfg, dataset, dev, impl=impl,
                                                gate=GATE)
                for impl in ("auto", "reference")}
    data = list(itertools.islice(
        train_torch.batches(dataset, bs, cfg.training.seed),
        max(steps_compare, steps_learn)))
    losses = {impl: [] for impl in trainers}
    aux = {impl: [] for impl in trainers}  # MoE: the loss's aux part
    first_grads = {}
    counts = None
    held = data[:5]  # the learning check's fixed batches
    learn = steps_learn > steps_compare
    before = held_loss(trainers["auto"], held) if learn else None
    # an MoE model's plain step replays the kernels' step's expert choices
    pinned = PinnedRouting() if cfg.model.moe.enabled else None
    with pinned or contextlib.nullcontext():
        for i in range(steps_compare):
            images, labels = (torch.from_numpy(a) for a in data[i])
            for impl, tr in trainers.items():
                if pinned is not None:
                    (pinned.start_record if impl == "auto"
                     else pinned.start_replay)()
                if impl == "auto" and i == 1:
                    torch.cuda.synchronize()
                    reset_counts()
                m = tr.train_step(images, labels)
                if impl == "auto" and i == 1:
                    torch.cuda.synchronize()
                    counts = read_counts()
                loss = m["loss"].item()
                if not math.isfinite(loss):
                    raise AssertionError(f"{impl} step {i}: loss {loss}")
                losses[impl].append(loss)
                if "moe_aux" in m:
                    aux[impl].append(m["moe_aux"].item())
                if i == 0:
                    first_grads[impl] = [
                        (n, p.grad.detach().float().flatten())
                        for n, p in tr.model.named_parameters()]
    if pinned is not None:
        log(f"[train] {name}: each plain step on the kernels' step's expert "
            f"choices; without them it would have made "
            f"{', '.join(map(str, pinned.flips))} of {pinned.choices} "
            f"choices otherwise")
    rels = [abs(a - b) / abs(b) for a, b in zip(losses["auto"],
                                                 losses["reference"])]
    ok = max(rels) <= LOSS_REL_TOL
    log(f"[train] {name} {cfg.training.precision} b{bs}, dropout "
        f"{cfg.model.drop_rate}, "
        f"gates {GATE}: losses through the kernels "
        f"{[round(v, 5) for v in losses['auto']]}, through the plain versions "
        f"{[round(v, 5) for v in losses['reference']]}; max rel diff "
        f"{max(rels):.3e} (tol {LOSS_REL_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("training through the kernels disagrees with "
                             "the plain versions")
    if aux["auto"]:
        rels = [abs(a - b) / abs(b) for a, b in zip(aux["auto"],
                                                     aux["reference"])]
        ok = max(rels) <= LOSS_REL_TOL
        log(f"[train] {name}: the losses' MoE aux part through the kernels "
            f"{[round(v, 6) for v in aux['auto']]}, through the plain "
            f"versions {[round(v, 6) for v in aux['reference']]}; max rel "
            f"diff {max(rels):.3e} (tol {LOSS_REL_TOL:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the MoE aux loss through the kernels "
                                 "disagrees with the plain versions")
    cos = []
    for (param, a), (_, b) in zip(first_grads["auto"],
                                  first_grads["reference"]):
        if b.abs().max() == 0 and a.abs().max() == 0:
            continue
        cos.append((torch.nn.functional.cosine_similarity(a, b, dim=0)
                    .item(), param))
    worst = min(cos)
    ok = worst[0] >= GRAD_COSINE
    graph = [f"{p} {c:.6f}" for c, p in cos if p.startswith("graphs.")]
    moe = [c for c, p in cos if ".moe." in p]
    log(f"[train] first-step gradients, kernels vs plain versions: lowest "
        f"cosine {worst[0]:.6f} ({worst[1]}) over {len(cos)} parameters "
        f"(need {GRAD_COSINE}) {'ok' if ok else 'FAIL'}; the graph blocks': "
        + ", ".join(graph) + (f"; the MoE routers' and banks' lowest "
                              f"{min(moe):.6f} over {len(moe)}" if moe
                              else ""))
    if not ok:
        raise AssertionError("a gradient through the kernels points away "
                             "from the plain version's")
    log(f"[train] {name}: kernel launches in one train step: "
        + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if counts != expected(expect):
        raise AssertionError(f"launch counts {counts}, expected "
                             f"{expected(expect)}")

    # keep training through the kernels: the loss must come down
    del trainers["reference"]
    tr = trainers["auto"]
    if not learn:
        return tr, data[0], counts
    for i in range(steps_compare, steps_learn):
        images, labels = (torch.from_numpy(a) for a in data[i])
        losses["auto"].append(tr.train_step(images, labels)["loss"].item())
    run = losses["auto"][:steps_learn]
    after = held_loss(tr, held)
    ok = all(math.isfinite(v) for v in run) and after < before
    log(f"[train] {name}: {steps_learn} steps through the kernels (warmup 5 "
        f"steps, lr {cfg.training.learning_rate}): mean loss of the first 5 "
        f"batches, without dropout or augmentation, {before:.5f} before and "
        f"{after:.5f} after; training losses {[round(v, 4) for v in run]} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("30 steps through the kernels did not lower "
                             "the loss")
    return tr, data[0], counts


def p50_ms(predictor, calls: int = 50) -> float:
    """Predictor.predict_proba's median host time for one image."""
    import numpy as np

    s = predictor.image_size
    img = np.random.default_rng(SEED + 2).integers(0, 256, (s, s, 3),
                                                   np.uint8)
    for _ in range(5):
        predictor.predict_proba(img)
    lat = []
    for _ in range(calls):
        t0 = time.perf_counter()
        predictor.predict_proba(img)
        lat.append((time.perf_counter() - t0) * 1000)
    return statistics.median(lat)


def phase_serve_large(cfg, weights, dev, buckets, card):
    """``Predictor`` at 512 or 1024 px over ``buckets`` (the default top
    bucket, 128, is more than a 1024-px server batches): warmed, then one
    image and a full top bucket, each against the plain-version Predictor;
    the launches of the warm-up (L and B in every block, C never: the graph
    blocks take the chunked path); the b1 p50."""
    import numpy as np

    from gavit_tpu_torch.serving import Predictor

    predictor = Predictor(cfg, weights, precision="bf16", device=dev,
                          buckets=buckets)
    reference = Predictor(cfg, weights, precision="bf16", device=dev,
                          buckets=buckets, impl="reference")
    import torch

    torch.cuda.synchronize()
    reset_counts()
    predictor.warmup()
    torch.cuda.synchronize()
    counts = read_counts()
    depth, s = cfg.model.depth, cfg.data.image_size
    want = expected({"L": depth * len(buckets), "B": depth * len(buckets)})
    log(f"[serve] {s} px Predictor buckets {buckets}: kernel launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items())
        + f" {'ok' if counts == want else 'FAIL'}")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    rng = np.random.default_rng(SEED + 4)
    for n in (1, buckets[-1]):
        imgs = rng.integers(0, 256, (n, s, s, 3), np.uint8)
        got, ref = predictor.predict_proba(imgs), reference.predict_proba(imgs)
        err = float(np.abs(got - ref).max())
        ok = (got.shape == (n, cfg.model.num_classes)
              and np.isfinite(got).all() and err <= PROB_TOL)
        log(f"[serve] {s} px Predictor {n} image(s): probabilities "
            f"{list(got.shape)}, max |dp| vs plain-version Predictor "
            f"{err:.3e} (tol {PROB_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the {s}-px Predictor disagrees with the "
                                 "plain versions")
    del reference
    p50 = p50_ms(predictor)
    log(f"[time] Predictor.predict_proba 1 image bf16 at {s} px: p50 "
        f"{p50:.3f} ms over 50 calls ({card})")
    return predictor


def phase_remat(cfg, dev, batch, card):
    """One 1024-px step with ``model.remat`` on and one with it off, from
    the same weights, generator and batch: losses and every gradient (after
    clipping, before the update reads them) within REMAT_REL_TOL of the
    tensor's largest value; bit-equality reported."""
    import dataclasses

    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import train_torch

    dataset = train_torch.create_dataset(cfg)
    images, labels = (torch.from_numpy(a) for a in batch)
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, remat=remat))
        tr = train_torch.build_trainer(c, dataset, dev, gate=GATE)
        torch.cuda.reset_peak_memory_stats()
        loss = tr.train_step(images, labels)["loss"]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[remat] = (loss, [(n, p.grad.detach().clone())
                             for n, p in tr.model.named_parameters()], peak)
        del tr
        torch.cuda.empty_cache()
    (l1, g1, m1), (l0, g0, m0) = out[True], out[False]
    rel = max(rel_err(a, b) for (_, a), (_, b) in zip(g1, g0))
    bits = torch.equal(l1, l0) and all(torch.equal(a, b)
                                       for (_, a), (_, b) in zip(g1, g0))
    ok = (torch.equal(l1, l0) or abs(l1.item() - l0.item())
          <= REMAT_REL_TOL * abs(l0.item())) and rel <= REMAT_REL_TOL
    log(f"[train] 1024 px b{cfg.data.batch_size} one step remat on vs off: "
        f"loss {l1.item():.6f} vs {l0.item():.6f}, every gradient within "
        f"{rel:.3e} of its largest (tol {REMAT_REL_TOL:.0e}), bit-equal "
        f"{bits}; peak memory {m1:.2f} GiB with remat, {m0:.2f} GiB without "
        f"({card}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("remat changed the training step")


def phase_large_times(cfg512, weights512, dev, results, predictor512,
                      trainers, card):
    """L and L′ at 512 px b32 against their plain versions, the library's
    attention and the bound; the chunked graph op (tensor ops) at the
    training shapes of both sizes; the 512-px b32 forward through the
    kernels and the plain versions; the 512-px b32 and 1024-px b4 train
    steps. ``trainers``: {name: (trainer, batch, cfg)} through the
    kernels."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT / "scripts"))
    import train_torch
    from gavit_tpu_torch.ops import attention as A
    from gavit_tpu_torch.ops import graph_ops as G
    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.serving import Predictor

    rows = {}
    b, n, h, d = BATCH_512, N_512, HEADS, HEAD_DIM
    scale = d ** -0.5
    qkv, o, lse, do = results["L′"]["cases"][0]
    q, k, v = (t.detach().clone().requires_grad_(True)
               for t in A._split_heads(qkv, h))
    do_c = do.contiguous()

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(q, k, v)
        torch.autograd.grad(out, (q, k, v), do_c)

    rows["L"] = (cuda_ms(lambda: A.qkv_attention_large_kernel(qkv, scale, h)),
                 cuda_ms(lambda: A.blockwise_attention_reference(
                     qkv, scale, h), iters=3, warmup=1),
                 cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
                 ) + bound(4 * b * h * n * n * d,
                           4 * b * n * h * d * 2 + b * h * n * 4)
    # L alone on the device, beside sdpa timed the same way
    results["L"]["device"] = (
        device_ms(lambda: A.qkv_attention_large_kernel(qkv, scale, h)),
        device_ms(lambda: F.scaled_dot_product_attention(q, k, v)))
    rows["L′"] = (cuda_ms(lambda: A.qkv_attention_large_bwd_kernel(
                      qkv, o, lse, do, scale, h)),
                  cuda_ms(lambda: A.blockwise_attention_backward_reference(
                      qkv, o, lse, do, scale, h), iters=3, warmup=1),
                  cuda_ms(sdpa_fwd_bwd)
                  ) + bound(10 * b * h * n * n * d,
                            8 * b * n * h * d * 2 + b * h * n * 4)
    # L′ alone on the device, beside sdpa's forward and backward timed the
    # same way
    results["L′"]["device"] = (
        device_ms(lambda: A.qkv_attention_large_bwd_kernel(
            qkv, o, lse, do, scale, h)),
        device_ms(sdpa_fwd_bwd))
    del q, k, v
    for key in ("L", "L′"):
        km, pm, lm, bms, by = rows[key]
        log(f"[time] {key} at 512 px b{b} (N={n}): kernel {km:.4f} ms, "
            f"plain {pm:.4f} ms, library (sdpa{' fwd+bwd' if key == 'L′' else ''}) "
            f"{lm:.4f} ms, bound {bms:.4f} ms ({by}) ({card})")
    scores = b * h * n * n
    dk, dl = results["L"]["device"]
    log(f"[time] L alone on the device (20 launches between two events): "
        f"kernel {dk:.4f} ms, sdpa {dl:.4f} ms; {scores} scores, one "
        f"exponential each: SFU floor {sfu_floor_ms(scores):.4f} ms "
        f"({SFU_EX2_PER_CLOCK} ex2 a clock an SM) beside the tensor bound "
        f"{rows['L'][3]:.4f} ms ({card})")
    dk, dl = results["L′"]["device"]
    log(f"[time] L′ alone on the device (20 launches between two events): "
        f"kernel {dk:.4f} ms, sdpa fwd+bwd {dl:.4f} ms; two exponentials a "
        f"score: SFU floor {sfu_floor_ms(2 * scores):.4f} ms beside the "
        f"tensor bound {rows['L′'][3]:.4f} ms ({card})")

    g = torch.Generator(device=dev).manual_seed(SEED + 81)
    for gb, gn in ((BATCH_512, N_512 - 1), (BATCH_1024, N_1024 - 1)):
        t, vals, up = (torch.randn(gb, gn, DIM, device=dev, generator=g)
                       .to(torch.bfloat16) for _ in range(3))
        tt, tv = (a.clone().requires_grad_(True) for a in (t, vals))
        with torch.no_grad():
            fwd = cuda_ms(lambda: G.graph_aggregate_chunked(t, vals, "knn", 8),
                          iters=5)
        both = cuda_ms(lambda: torch.autograd.grad(
            G.graph_aggregate_chunked(tt, tv, "knn", 8), (tt, tv), up),
            iters=5)
        log(f"[time] chunked graph (tensor ops, no kernel) bf16 knn B={gb} "
            f"N={gn} chunk {G._pick_chunk(gn)}: forward {fwd:.3f} ms, "
            f"forward + backward {both:.3f} ms ({card})")
        del t, vals, up, tt, tv

    s = cfg512.data.image_size
    plain = Predictor(cfg512, weights512, precision="bf16", device=dev,
                      impl="reference")
    imgs = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, 256, (b, s, s, 3), np.uint8)).to(dev)
    xb = val_preprocess(imgs)
    for impl, model in (("auto", predictor512.model),
                        ("reference", plain.model)):
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(xb), iters=5 if impl == "auto" else 2,
                         warmup=1)
        log(f"[time] bf16 forward at {s} px b{b} impl={impl}: {ms:.3f} ms, "
            f"{b / (ms / 1000):.1f} img/s ({card})")
    del plain, xb

    for name, (trainer, batch, tcfg) in trainers.items():
        dataset = train_torch.create_dataset(tcfg)
        ref = train_torch.build_trainer(tcfg, dataset, dev, impl="reference",
                                        gate=GATE)
        images, labels = (torch.from_numpy(a) for a in batch)
        bs = tcfg.data.batch_size
        step_ms = {"auto": [], "reference": []}
        for tr in (trainer, ref):
            tr.train_step(images, labels)
        torch.cuda.synchronize()
        for i in range(5):
            for impl, tr in (("auto", trainer), ("reference", ref)):
                if impl == "reference" and i % 3:
                    continue  # the plain versions' step: 2 samples
                t0 = time.perf_counter()
                tr.train_step(images, labels)
                torch.cuda.synchronize()
                step_ms[impl].append((time.perf_counter() - t0) * 1000)
        for impl, ts in step_ms.items():
            ms = statistics.median(ts)
            log(f"[time] train step {name} b{bs} bf16 impl={impl}: {ms:.3f} "
                f"ms (median of {len(ts)}), {bs / (ms / 1000):.1f} img/s "
                f"({card})")
        del ref
        torch.cuda.empty_cache()
    return rows


def phase_times(cfg, dev, results, predictors, card):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gavit_tpu_torch.ops import attention as A
    from gavit_tpu_torch.ops import graph_ops as G
    from gavit_tpu_torch.ops import mlp as M
    from gavit_tpu_torch.ops.preprocess import val_preprocess

    scale = HEAD_DIM ** -0.5
    for dtype_name, b, qkv in results["A"]["cases"]:
        q, k_, v = A._split_heads(qkv, HEADS)
        k = cuda_ms(lambda: A.qkv_attention_kernel(qkv, scale, HEADS))
        p = cuda_ms(lambda: A.attention_reference(q, k_, v, scale))
        # a library rung to measure against, not a replacement
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k_, v))
        bms, by = bound(4 * b * HEADS * N_TOKENS ** 2 * HEAD_DIM,
                        4 * b * N_TOKENS * HEADS * HEAD_DIM * qkv.element_size())
        log(f"[time] A attention {dtype_name} B={b}: kernel {k:.4f} ms, "
            f"plain {p:.4f} ms, torch sdpa {sdpa:.4f} ms, bound {bms:.4f} ms "
            f"({by}) ({card})")
        if dtype_name == "bf16" and b == 1:
            # the host's share of a b1 call: the wrapper, four tensor-map
            # encodes and the launch, against sdpa's
            log(f"[time] A attention bf16 B=1 host: "
                f"{host_us(lambda: A.qkv_attention_kernel(qkv, scale, HEADS)):.1f}"
                f" us a call, torch sdpa "
                f"{host_us(lambda: F.scaled_dot_product_attention(q, k_, v)):.1f}"
                f" us ({card})")
    for dtype_name, m, args in results["B"]["cases"]:
        x, w1, b1, w2, b2 = args
        k = cuda_ms(lambda: M.mlp_inference_kernel(*args, True))
        p = cuda_ms(lambda: M._chain_infer(*args, True))
        # bf16 cuBLAS chain: rounds x.W1 before the bias, so not the same
        # function, but the speed reference for kernel B
        blas = cuda_ms(lambda: F.linear(F.gelu(F.linear(x, w1, b1),
                                               approximate="tanh"), w2, b2))
        bms, by = bound(4 * m * DIM * HIDDEN,
                        (2 * m * DIM + 2 * DIM * HIDDEN + HIDDEN + DIM) * 2)
        log(f"[time] B mlp {dtype_name} M={m}: kernel {k:.4f} ms, plain "
            f"{p:.4f} ms, bf16 cuBLAS chain {blas:.4f} ms, bound {bms:.4f} "
            f"ms ({by}) ({card})")
        if m == N_TOKENS:
            # the host's share of a b1 call: the wrapper, the tensor maps
            # (cached) and two launches, against the chain's three calls
            hk = host_us(lambda: M.mlp_inference_kernel(*args, True))
            hl = host_us(lambda: F.linear(F.gelu(F.linear(x, w1, b1),
                                                 approximate="tanh"), w2, b2))
            log(f"[time] B mlp bf16 M={m} host: {hk:.1f} us a call, bf16 "
                f"cuBLAS chain {hl:.1f} us ({card})")
    for dtype_name, b, (t, v) in results["C"]["cases"]:
        for mode, kw in GRAPH_MODES:
            k_, thr = kw.get("k", 8), kw.get("threshold", 0.0)
            k = cuda_ms(lambda: G.graph_aggregate_kernel(t, v, mode, k_, thr,
                                                         1.0))
            p = cuda_ms(lambda: G.graph_aggregate(G.build_adjacency(
                t, mode=mode, k=k_, threshold=thr), v))
            n = t.shape[1]
            bms, by = bound(4 * b * n * n * DIM,
                            3 * t.numel() * t.element_size())
            log(f"[time] C graph {dtype_name} {mode} B={b}: kernel {k:.4f} "
                f"ms, plain {p:.4f} ms, bound {bms:.4f} ms ({by}) ({card})")

    predictor, reference = predictors
    s = cfg.data.image_size
    log(f"[time] Predictor.predict_proba 1 image bf16: p50 "
        f"{p50_ms(predictor):.3f} ms over 50 calls ({card})")

    batch = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, 256, (64, s, s, 3), np.uint8)).to(dev)
    x = val_preprocess(batch)
    for impl, model in (("auto", predictor.model),
                        ("reference", reference.model)):
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(x), iters=10, warmup=2)
        log(f"[time] bf16 forward b64 impl={impl}: {ms:.3f} ms, "
            f"{64 / (ms / 1000):.1f} img/s ({card})")


def bound(flops: float, nbytes: float):
    """(least ms, what bounds it): the larger of the operations at the
    card's bf16 tensor-core peak and the bytes at its memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def phase_train_times(cfg, dev, results, trainer, batch, card):
    """Each training-path kernel at the b128 shapes against its plain
    version and a library call; A, B and C at their main-path shapes; the
    train step through the kernels and through the plain versions."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT / "scripts"))
    import train_torch
    from gavit_tpu_torch.ops import attention as A
    from gavit_tpu_torch.ops import dropout as DR
    from gavit_tpu_torch.ops import graph_ops as G
    from gavit_tpu_torch.ops import mlp as M

    rows = {}
    bf = torch.bfloat16
    b, n, h, d = TRAIN_BATCH, N_TOKENS, HEADS, HEAD_DIM
    scale = d ** -0.5
    g = torch.Generator(device=dev).manual_seed(SEED + 21)

    # A and A′ at b128
    qkv, do = results["A′"]["cases"][0]
    q, k, v = (t.detach().clone().requires_grad_(True)
               for t in A._split_heads(qkv, h))
    do_c = do.contiguous()

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(q, k, v)
        torch.autograd.grad(out, (q, k, v), do_c)

    ka = cuda_ms(lambda: A.qkv_attention_kernel(qkv, scale, h))
    pa = cuda_ms(lambda: A.attention_reference(*A._split_heads(qkv, h),
                                               scale), iters=5)
    la = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    rows["A"] = (ka, pa, la) + bound(4 * b * h * n * n * d,
                                     4 * b * n * h * d * 2)
    kb = cuda_ms(lambda: A.qkv_attention_bwd_kernel(qkv, do, scale, h))
    pb = cuda_ms(lambda: A.attention_backward_reference(qkv, do, scale, h),
                 iters=5)
    lb = cuda_ms(sdpa_fwd_bwd)
    rows["A′"] = (kb, pb, lb) + bound(10 * b * h * n * n * d,
                                      7 * b * n * h * d * 2)
    # A′ alone on the device, beside the backward pair under K′'s entry
    # (the generic pair) and sdpa's forward and backward timed the same way
    alone = device_ms(lambda: A.qkv_attention_bwd_kernel(qkv, do, scale, h))
    pair = device_ms(lambda: A.qkv_attention_long_bwd_kernel(qkv, do, scale,
                                                              h))
    lib_alone = device_ms(sdpa_fwd_bwd)
    results["A′"]["device"] = (alone, lib_alone)
    log(f"[time] A′ at b{b} N={n} alone on the device (20 launches between "
        f"two events): kernel {alone:.4f} ms, the generic pair (K′'s entry) "
        f"{pair:.4f} ms, sdpa fwd+bwd {lib_alone:.4f} ms ({card})")

    # B at the serving b64 shape (its main path), against a bf16 cuBLAS chain
    m64 = 64 * N_TOKENS
    (_, _, args_b), = [c for c in results["B"]["cases"] if c[1] == m64]
    x, w1, b1, w2, b2 = args_b
    kB = cuda_ms(lambda: M.mlp_inference_kernel(*args_b, True))
    pB = cuda_ms(lambda: M._chain_infer(*args_b, True), iters=5)
    lB = cuda_ms(lambda: F.linear(F.gelu(F.linear(x, w1, b1),
                                         approximate="tanh"), w2, b2))
    rows["B"] = (kB, pB, lB) + bound(4 * m64 * DIM * HIDDEN,
                                     (2 * m64 * DIM + 2 * DIM * HIDDEN
                                      + HIDDEN + DIM) * 2)
    results["B"]["device"] = (
        device_ms(lambda: M.mlp_inference_kernel(*args_b, True)),
        device_ms(lambda: F.linear(F.gelu(F.linear(x, w1, b1),
                                          approximate="tanh"), w2, b2)))
    log(f"[time] B at M={m64}, device alone (20 launches between two "
        f"events): kernel {results['B']['device'][0]:.4f} ms, bf16 cuBLAS "
        f"chain {results['B']['device'][1]:.4f} ms ({card})")

    # C at b128 with the adjacency kept for the backward, as training runs it
    t = torch.randn(b, n - 1, DIM, device=dev, generator=g).to(bf)
    vals = torch.randn(b, n - 1, DIM, device=dev, generator=g).to(bf)
    kc = cuda_ms(lambda: G.graph_aggregate_kernel(t, vals, "knn", 8, 0.0, 1.0,
                                                  return_adjacency=True))
    pc = cuda_ms(lambda: G.graph_aggregate(G.build_adjacency(t, k=8), vals),
                 iters=5)
    rows["C"] = (kc, pc, None) + bound(4 * b * (n - 1) ** 2 * DIM,
                                       3 * b * (n - 1) * DIM * 2
                                       + b * (n - 1) ** 2 * 4)
    results["C"]["device"] = (device_ms(lambda: G.graph_aggregate_kernel(
        t, vals, "knn", 8, 0.0, 1.0, return_adjacency=True)), None)
    log(f"[time] C at b{b} N={n - 1} knn with the adjacency, alone on the "
        f"device (20 launches between two events): kernel "
        f"{results['C']['device'][0]:.4f} ms ({card})")

    # D and D′ at M = 128 x 197, against F.linear → gelu → dropout → F.linear
    # → dropout in bf16 (its forward, and its backward alone)
    x, w1, b1, w2, b2, seed, sites = results["D"]["cases"][0]
    m = x.shape[0]
    dy, h1, _, _, _ = results["D′"]["cases"][0]
    leaves = [a.detach().clone().requires_grad_(True)
              for a in (x, w1, b1, w2, b2)]

    def chain():
        lx, lw1, lb1, lw2, lb2 = leaves
        hid = F.dropout(F.gelu(F.linear(lx, lw1, lb1)), DROP_RATE)
        return F.dropout(F.linear(hid, lw2, lb2), DROP_RATE)

    y_chain = chain()
    kd = cuda_ms(lambda: M.mlp_train_kernel(x, w1, b1, w2, b2, seed, sites,
                                            DROP_RATE, DROP_RATE))
    pd = cuda_ms(lambda: M.mlp_train_reference(
        x, w1, b1, w2, b2, seed, sites, DROP_RATE, DROP_RATE), iters=5)
    ld = cuda_ms(chain)
    rows["D"] = (kd, pd, ld) + bound(
        4 * m * DIM * HIDDEN,
        (m * DIM + 2 * DIM * HIDDEN + HIDDEN + DIM + m * HIDDEN + m * DIM) * 2)
    with torch.no_grad():  # the chain's forward alone, as the kernel's
        results["D"]["device"] = (
            device_ms(lambda: M.mlp_train_kernel(x, w1, b1, w2, b2, seed,
                                                 sites, DROP_RATE,
                                                 DROP_RATE)),
            device_ms(chain))
    log(f"[time] D at M={m} rate {DROP_RATE}, device alone (20 launches "
        f"between two events): kernel {results['D']['device'][0]:.4f} ms, "
        f"bf16 chain F.linear → F.gelu → F.dropout → F.linear → F.dropout "
        f"{results['D']['device'][1]:.4f} ms ({card})")
    kd2 = cuda_ms(lambda: M.mlp_train_bwd_kernel(dy, h1, w2, seed, sites,
                                                 DROP_RATE, DROP_RATE))
    pd2 = cuda_ms(lambda: M.mlp_train_bwd_reference(
        dy, h1, w2, seed, sites, DROP_RATE, DROP_RATE), iters=5)
    # D′'s yardstick: the chain's backward from y to the fc1 output (D′'s
    # dh1: one GEMM and the elementwise passes); the whole chain's backward
    # onto x, W1, b1, W2, b2 (four GEMMs) beside it
    h_pre = h1.detach().clone().requires_grad_(True)
    y_tail = F.dropout(F.linear(F.dropout(F.gelu(h_pre), DROP_RATE), w2, b2),
                       DROP_RATE)

    def tail_bwd():
        return torch.autograd.grad(y_tail, h_pre, dy, retain_graph=True)

    ld2 = cuda_ms(tail_bwd)
    ld2_full = cuda_ms(lambda: torch.autograd.grad(y_chain, leaves, dy,
                                                   retain_graph=True))
    rows["D′"] = (kd2, pd2, ld2) + bound(
        2 * m * DIM * HIDDEN,
        (2 * m * DIM + 3 * m * HIDDEN + DIM * HIDDEN) * 2
        + (HIDDEN + DIM) * 4)
    results["D′"]["device"] = (
        device_ms(lambda: M.mlp_train_bwd_kernel(dy, h1, w2, seed, sites,
                                                 DROP_RATE, DROP_RATE)),
        device_ms(tail_bwd))
    results["D′"]["full bwd"] = ld2_full
    log(f"[time] D′ at M={m} rate {DROP_RATE}: per call kernel {kd2:.4f} ms, "
        f"the chain's backward to the fc1 output {ld2:.4f} ms, the whole "
        f"chain's backward {ld2_full:.4f} ms; alone on the device (20 "
        f"launches between two events): kernel "
        f"{results['D′']['device'][0]:.4f} ms, the chain's backward to the "
        f"fc1 output {results['D′']['device'][1]:.4f} ms ({card})")

    # F on one [128, 197, 768] bf16 site
    xf, fseed = results["F"]["cases"][0]
    kf = cuda_ms(lambda: DR.dropout_kernel(xf, fseed, 5, DROP_RATE))
    pf = cuda_ms(lambda: DR.dropout_reference(xf, fseed, 5, DROP_RATE),
                 iters=5)
    lf = cuda_ms(lambda: F.dropout(xf, DROP_RATE))
    rows["F"] = (kf, pf, lf) + bound(0, 2 * xf.numel() * 2)
    results["F"]["device"] = (
        device_ms(lambda: DR.dropout_kernel(xf, fseed, 5, DROP_RATE)),
        device_ms(lambda: F.dropout(xf, DROP_RATE)))
    log(f"[time] F on [128, 197, 768] bf16 alone on the device (20 launches "
        f"between two events): kernel {results['F']['device'][0]:.4f} ms, "
        f"F.dropout {results['F']['device'][1]:.4f} ms ({card})")

    for key, (km, pm, lm, bms, by) in rows.items():
        log(f"[time] {key}: kernel {km:.4f} ms, plain {pm:.4f} ms, library "
            f"{'n/a' if lm is None else f'{lm:.4f} ms'}, bound {bms:.4f} ms "
            f"({by}) ({card})")

    # the train step at b128, through the kernels and the plain versions
    dataset = train_torch.create_dataset(cfg)
    plain = train_torch.build_trainer(cfg, dataset, dev, impl="reference",
                                      gate=GATE)
    images, labels = (torch.from_numpy(a) for a in batch)
    step_ms = {"auto": [], "reference": []}
    for tr in (trainer, plain):
        tr.train_step(images, labels)
    torch.cuda.synchronize()
    for _ in range(5):
        for impl, tr in (("auto", trainer), ("reference", plain),
                         ("auto", trainer)):
            t0 = time.perf_counter()
            tr.train_step(images, labels)
            torch.cuda.synchronize()
            step_ms[impl].append((time.perf_counter() - t0) * 1000)
    steps = {}
    for impl, ts in step_ms.items():
        ms = statistics.median(ts)
        steps[impl] = ms
        log(f"[time] train step b{TRAIN_BATCH} {cfg.training.precision} "
            f"impl={impl}: {ms:.3f} ms "
            f"(median of {len(ts)}), {TRAIN_BATCH / (ms / 1000):.1f} img/s "
            f"({card})")
    return rows, steps


def phase_384_times(cfg, tcfg, dev, results, weights, trainer, batch, card):
    """The 384 fine-tune's kernels (K, K′ at b16; H, H′ at [16·577, 3072]
    bf16) against their plain versions and a library call; the MLP's two
    routes at M = 9232; Predictor p50 at 384 px; the b16 forward and the
    b16 train step through the kernels and the plain versions."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT / "scripts"))
    import train_torch
    from gavit_tpu_torch.ops import attention as A
    from gavit_tpu_torch.ops import dropout as DR
    from gavit_tpu_torch.ops import mlp as M
    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.serving import Predictor

    rows = {}
    b, n, h, d = BATCH_384, N_384, HEADS, HEAD_DIM
    scale = d ** -0.5
    qkv, do = results["K′"]["cases"][0]
    q, k, v = (t.detach().clone().requires_grad_(True)
               for t in A._split_heads(qkv, h))
    do_c = do.contiguous()

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(q, k, v)
        torch.autograd.grad(out, (q, k, v), do_c)

    rows["K"] = (cuda_ms(lambda: A.qkv_attention_long_kernel(qkv, scale, h)),
                 cuda_ms(lambda: A.attention_reference(
                     *A._split_heads(qkv, h), scale), iters=5),
                 cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
                 ) + bound(4 * b * h * n * n * d, 4 * b * n * h * d * 2)
    rows["K′"] = (cuda_ms(lambda: A.qkv_attention_long_bwd_kernel(
                      qkv, do, scale, h)),
                  cuda_ms(lambda: A.attention_backward_reference(
                      qkv, do, scale, h), iters=5),
                  cuda_ms(sdpa_fwd_bwd)
                  ) + bound(10 * b * h * n * n * d, 7 * b * n * h * d * 2)

    x, dy, seed, site = results["H"]["cases"][0]
    bwd_lib = gelu_dropout_bwd_library(x, dy)
    rows["H"] = (cuda_ms(lambda: DR.gelu_dropout_kernel(x, seed, site,
                                                        DROP_RATE)),
                 cuda_ms(lambda: DR.gelu_dropout_reference(x, seed, site,
                                                           DROP_RATE),
                         iters=5),
                 cuda_ms(lambda: F.dropout(F.gelu(x), DROP_RATE))
                 ) + bound(0, 2 * x.numel() * 2)
    rows["H′"] = (cuda_ms(lambda: DR.gelu_dropout_bwd_kernel(
                      x, dy, seed, site, DROP_RATE)),
                  cuda_ms(lambda: DR.gelu_dropout_bwd_reference(
                      x, dy, seed, site, DROP_RATE), iters=5),
                  cuda_ms(bwd_lib)) + bound(0, 3 * x.numel() * 2)
    # H and H′ alone on the device, beside F.dropout(F.gelu) and its
    # backward timed the same way
    results["H"]["device"] = (
        device_ms(lambda: DR.gelu_dropout_kernel(x, seed, site, DROP_RATE)),
        device_ms(lambda: F.dropout(F.gelu(x), DROP_RATE)))
    results["H′"]["device"] = (
        device_ms(lambda: DR.gelu_dropout_bwd_kernel(x, dy, seed, site,
                                                     DROP_RATE)),
        device_ms(bwd_lib))
    log(f"[time] H and H′ on [{x.shape[0]}, {x.shape[1]}] bf16 alone on the "
        f"device (20 launches between two events): H "
        f"{results['H']['device'][0]:.4f} ms, F.dropout(F.gelu) "
        f"{results['H']['device'][1]:.4f} ms; H′ "
        f"{results['H′']['device'][0]:.4f} ms, that chain's backward "
        f"(native_dropout_backward, gelu_backward) "
        f"{results['H′']['device'][1]:.4f} ms ({card})")
    log_issue_floor(x.numel(), rows, card)
    for key in ("K", "K′", "H", "H′"):
        km, pm, lm, bms, by = rows[key]
        log(f"[time] {key} at 384 px b{b}: kernel {km:.4f} ms, plain "
            f"{pm:.4f} ms, library {lm:.4f} ms, bound {bms:.4f} ms ({by}) "
            f"({card})")
    # K′ alone on the device, beside sdpa's forward and backward
    results["K′"]["device"] = (
        device_ms(lambda: A.qkv_attention_long_bwd_kernel(qkv, do, scale, h)),
        device_ms(sdpa_fwd_bwd))
    log(f"[time] K′ at 384 px b{b} alone on the device (20 launches between "
        f"two events): kernel {results['K′']['device'][0]:.4f} ms, sdpa "
        f"fwd+bwd {results['K′']['device'][1]:.4f} ms ({card})")

    # the MLP's two routes at M = 9232: D/D′ against fc1 → H → fc2 → F
    m = b * n
    args = mlp_inputs(dev, m, DIM, HIDDEN)
    sites = (2, 3)
    leaves = {r: [a.detach().clone().requires_grad_(True) for a in args]
              for r in ("fused", "chain")}
    run = {"fused": lambda t: M._FusedMlp.apply(*t, seed, sites, DROP_RATE,
                                                DROP_RATE, True),
           "chain": lambda t: M.mlp_train_chain(*t, seed, sites, DROP_RATE,
                                                DROP_RATE)}
    gy = torch.randn(m, DIM, device=dev).to(torch.bfloat16)
    for route in ("fused", "chain", "chain", "fused"):
        t = leaves[route]
        with torch.no_grad():
            fwd = cuda_ms(lambda: run[route](t), iters=10)
        both = cuda_ms(lambda: torch.autograd.grad(run[route](t), t, gy),
                       iters=10)
        log(f"[time] 384 MLP b{b} (M={m}) route {route}: forward {fwd:.4f} "
            f"ms, forward + backward {both:.4f} ms, backward {both - fwd:.4f} "
            f"ms ({card})")

    predictor = Predictor(cfg, weights, precision="bf16", device=dev)
    s = cfg.data.image_size
    log(f"[time] Predictor.predict_proba 1 image bf16 at {s} px: p50 "
        f"{p50_ms(predictor):.3f} ms over 50 calls ({card})")
    plain = Predictor(cfg, weights, precision="bf16", device=dev,
                      impl="reference")
    imgs = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, 256, (b, s, s, 3), np.uint8)).to(dev)
    xb = val_preprocess(imgs)
    for impl, model in (("auto", predictor.model), ("reference", plain.model)):
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(xb), iters=10, warmup=2)
        log(f"[time] bf16 forward at {s} px b{b} impl={impl}: {ms:.3f} ms, "
            f"{b / (ms / 1000):.1f} img/s ({card})")
    del predictor, plain

    dataset = train_torch.create_dataset(tcfg)
    ref = train_torch.build_trainer(tcfg, dataset, dev, impl="reference",
                                    gate=GATE)
    images, labels = (torch.from_numpy(a) for a in batch)
    step_ms = {"auto": [], "reference": []}
    for tr in (trainer, ref):
        tr.train_step(images, labels)
    torch.cuda.synchronize()
    for _ in range(5):
        for impl, tr in (("auto", trainer), ("reference", ref),
                         ("auto", trainer)):
            t0 = time.perf_counter()
            tr.train_step(images, labels)
            torch.cuda.synchronize()
            step_ms[impl].append((time.perf_counter() - t0) * 1000)
    for impl, ts in step_ms.items():
        ms = statistics.median(ts)
        log(f"[time] train step at {s} px b{b} {tcfg.training.precision} "
            f"impl={impl}: {ms:.3f} ms (median of {len(ts)}), "
            f"{b / (ms / 1000):.1f} img/s ({card})")
    return rows


def moe_library(c):
    """The library yardsticks of M, M′ and tgmm on a moe_case, and the name
    of what they call: ``torch._grouped_mm`` (bf16 grouped GEMMs over the
    expert row offsets, no bias: it takes none) where this torch has it and
    it runs on these inputs, else a loop of one ``torch.matmul`` per
    expert. M: GEMM, GELU, dropout, GEMM, dropout; M′: that chain's
    backward to x; tgmm: one dW, ``lib["tgmm"](a, b)`` as the kernel's
    ``tgmm_kernel(a, b, group_sizes)``."""
    import torch
    import torch.nn.functional as F

    x, (w1, _, w2, _), dy = c["x"], c["w"], c["dy"]
    offs = torch.cumsum(c["gs"], 0, dtype=torch.int32)
    bounds = [0] + offs.tolist()
    grouped = getattr(torch, "_grouped_mm", None)

    def gmm(a, w):
        if grouped is not None:
            return grouped(a, w, offs=offs)
        return torch.cat([a[lo:hi] @ w[e] for e, (lo, hi) in
                          enumerate(zip(bounds[:-1], bounds[1:]))])

    def tgmm(a, b):
        if grouped is not None:
            return grouped(a.t(), b, offs=offs)
        return torch.stack([a[lo:hi].t() @ b[lo:hi] for lo, hi in
                            zip(bounds[:-1], bounds[1:])])

    xg = x.detach().clone().requires_grad_(True)

    def chain():
        h = F.dropout(F.gelu(gmm(xg, w1)), DROP_RATE)
        return F.dropout(gmm(h, w2), DROP_RATE)

    name = "torch._grouped_mm"
    if grouped is not None:
        try:
            chain()
            tgmm(x, x)
            torch.cuda.synchronize()
        except (RuntimeError, TypeError) as e:  # a yardstick, not the port
            log(f"[time] torch._grouped_mm does not take these inputs ({e}); "
                f"the library yardstick is a loop of matmuls")
            grouped, name = None, "a loop of 8 torch.matmul"
    else:
        name = "a loop of 8 torch.matmul"
    y = chain()
    return {"M": chain,
            "M′": lambda: torch.autograd.grad(y, xg, dy, retain_graph=True),
            "tgmm": tgmm, "name": name}


def phase_moe_times(cfg, tcfg, dev, results, weights, trainer, batch, card):
    """M, M′ and tgmm at the b128 routing against their plain versions, a
    library call and the bound; the MoE model's bf16 forward at b64 through
    the kernels and the plain versions (CUDA events), its b128 train step
    (host clock, median of 10) and the b1 Predictor p50."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import train_torch
    from gavit_tpu_torch.ops import gmm as GM
    from gavit_tpu_torch.ops import moe_fused as MF
    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.serving import Predictor

    c = results["M"]["cases"][0]
    x, (w1, b1, w2, b2), tg, tm, gs = c["x"], c["w"], c["tg"], c["tm"], c["gs"]
    dy, h1, go, dh1, dye = results["M′"]["cases"][0]
    seed, sites = 1, (5, 6)
    cap, e, t = x.shape[0], EXPERTS, c["t"]
    lib = moe_library(c)
    log(f"[time] MoE library yardstick: {lib['name']}")
    # the work this routing needs: T real rows (the kernels also run cap - T
    # pad rows)
    wbytes = 2 * e * DIM * HIDDEN * 2
    rows = {
        "M": (cuda_ms(lambda: MF.moe_fwd_kernel(x, w1, b1, w2, b2, tg, tm,
                                                seed, sites, DROP_RATE,
                                                DROP_RATE, False, gs)),
              cuda_ms(lambda: MF.moe_fwd_reference(
                  x, w1, b1, w2, b2, tg, tm, seed, sites, DROP_RATE,
                  DROP_RATE, False), iters=3, warmup=1),
              cuda_ms(lib["M"])) + bound(
            4 * t * DIM * HIDDEN, (2 * t * DIM + t * HIDDEN) * 2 + wbytes),
        "M′": (cuda_ms(lambda: MF.moe_bwd_kernel(dy, h1, w1, w2, tg, tm,
                                                 seed, sites, DROP_RATE,
                                                 DROP_RATE, False, gs)),
               cuda_ms(lambda: MF.moe_bwd_reference(
                   dy, h1, w1, w2, tg, tm, seed, sites, DROP_RATE, DROP_RATE,
                   False), iters=3, warmup=1),
               cuda_ms(lib["M′"])) + bound(
            4 * t * DIM * HIDDEN,
            (3 * t * DIM + 3 * t * HIDDEN) * 2 + wbytes
            + e * (HIDDEN + DIM) * 4),
        "tgmm": (cuda_ms(lambda: GM.tgmm_kernel(x, dh1, gs)),
                 cuda_ms(lambda: GM.tgmm_reference(x, dh1, gs,
                                                   torch.bfloat16),
                         iters=3, warmup=1),
                 cuda_ms(lambda: lib["tgmm"](x, dh1))) + bound(
            2 * t * DIM * HIDDEN,
            (t * DIM + t * HIDDEN) * 2 + e * DIM * HIDDEN * 2),
    }
    for key, (km, pm, lm, bms, by) in rows.items():
        log(f"[time] {key} at b{TRAIN_BATCH} (T={t}, cap={cap}, tm={tm}): "
            f"kernel {km:.4f} ms, plain {pm:.4f} ms, library {lm:.4f} ms, "
            f"bound {bms:.4f} ms ({by}) ({card})")
    # M alone on the device, beside the library chain timed the same way
    results["M"]["device"] = (
        device_ms(lambda: MF.moe_fwd_kernel(x, w1, b1, w2, b2, tg, tm, seed,
                                            sites, DROP_RATE, DROP_RATE,
                                            False, gs)),
        device_ms(lib["M"]))
    log(f"[time] M at b{TRAIN_BATCH} alone on the device (20 launches "
        f"between two events): kernel {results['M']['device'][0]:.4f} ms, "
        f"{lib['name']} chain {results['M']['device'][1]:.4f} ms ({card})")
    # M′ alone, beside the chain's backward to x timed the same way
    results["M′"]["device"] = (
        device_ms(lambda: MF.moe_bwd_kernel(dy, h1, w1, w2, tg, tm, seed,
                                            sites, DROP_RATE, DROP_RATE,
                                            False, gs)),
        device_ms(lib["M′"]))
    log(f"[time] M′ at b{TRAIN_BATCH} alone on the device (20 launches "
        f"between two events): kernel {results['M′']['device'][0]:.4f} ms, "
        f"{lib['name']} chain's backward to x "
        f"{results['M′']['device'][1]:.4f} ms ({card})")
    # tgmm alone on the device over the cap-padded rows, both dW
    device = results["tgmm"].setdefault("device", {})
    for what, a, b in (("dW1", x, dh1), ("dW2", go, dye)):
        device[f"{what} cap-padded"] = (
            device_ms(lambda: GM.tgmm_kernel(a, b, gs)),
            device_ms(lambda: lib["tgmm"](a, b)))
        log(f"[time] tgmm {what} over the {cap} cap-padded rows, device "
            f"alone (20 launches between two events): kernel "
            f"{device[f'{what} cap-padded'][0]:.4f} ms, {lib['name']} "
            f"{device[f'{what} cap-padded'][1]:.4f} ms ({card})")

    s = cfg.data.image_size
    predictor = Predictor(cfg, weights, precision="bf16", device=dev)
    # every bucket once: the dense engine at 1, 8 and 32, the grouped one
    # (kernel M) at 128
    torch.cuda.synchronize()
    reset_counts()
    predictor.warmup()
    torch.cuda.synchronize()
    counts = read_counts()
    depth, n = cfg.model.depth, len(predictor.buckets)
    want = expected({"A": depth * n, "B": depth // 2 * n, "C": 2 * n,
                     "M": depth // 2})
    log(f"[serve] MoE Predictor buckets {predictor.buckets}: kernel launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items())
        + f" {'ok' if counts == want else 'FAIL'}")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    log(f"[time] MoE Predictor.predict_proba 1 image bf16 (dense engine): "
        f"p50 {p50_ms(predictor):.3f} ms over 50 calls ({card})")
    plain = Predictor(grouped_engine(cfg), weights, precision="bf16",
                      device=dev, impl="reference")
    imgs = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, 256, (64, s, s, 3), np.uint8)).to(dev)
    xb = val_preprocess(imgs)
    for impl, model in (("auto", predictor.model), ("reference", plain.model)):
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(xb), iters=10, warmup=2)
        log(f"[time] MoE bf16 forward b64 (grouped engine) impl={impl}: "
            f"{ms:.3f} ms, {64 / (ms / 1000):.1f} img/s ({card})")
    del predictor, plain

    dataset = train_torch.create_dataset(tcfg)
    ref = train_torch.build_trainer(tcfg, dataset, dev, impl="reference",
                                    gate=GATE)
    images, labels = (torch.from_numpy(a) for a in batch)
    step_ms = {"auto": [], "reference": []}
    for tr in (trainer, ref):
        tr.train_step(images, labels)
    torch.cuda.synchronize()
    for i in range(10):
        for impl, tr in (("auto", trainer), ("reference", ref)):
            if impl == "reference" and i % 5:
                continue  # the plain versions' step: 2 samples
            t0 = time.perf_counter()
            tr.train_step(images, labels)
            torch.cuda.synchronize()
            step_ms[impl].append((time.perf_counter() - t0) * 1000)
    for impl, ts in step_ms.items():
        ms = statistics.median(ts)
        log(f"[time] MoE train step b{TRAIN_BATCH} "
            f"{tcfg.training.precision} impl={impl}: {ms:.3f} ms (median of "
            f"{len(ts)}), {TRAIN_BATCH / (ms / 1000):.1f} img/s ({card})")
    return rows


@contextlib.contextmanager
def fused_gate(value: str):
    """``GAVIT_MOE_FUSED`` set to ``value`` ('0': the MoE model's grouped
    engine is the unfused one, through N-gmm) for the block, as a user sets
    it; the gate reads it at every forward."""
    import os

    old = os.environ.get("GAVIT_MOE_FUSED")
    os.environ["GAVIT_MOE_FUSED"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["GAVIT_MOE_FUSED"]
        else:
            os.environ["GAVIT_MOE_FUSED"] = old


def phase_grouped_remat(cfg, dev, batch, card):
    """One MoE b128 step with ``model.moe.grouped_remat`` on and one with it
    off, the fused gate off, from the same weights, generator and batch:
    the loss and every gradient bit-equal (the recompute runs the same
    kernels on the same inputs, its masks drawn again from their sites),
    the launches of the remat step (N-gmm 36: the forward's 12 again in
    the backward, then its 12), and the peak memory of each."""
    import dataclasses

    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import train_torch

    dataset = train_torch.create_dataset(cfg)
    images, labels = (torch.from_numpy(a) for a in batch)
    out = {}
    depth = cfg.model.depth
    for remat in (True, False):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, moe=dataclasses.replace(cfg.model.moe,
                                               grouped_remat=remat)))
        tr = train_torch.build_trainer(c, dataset, dev, gate=GATE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        loss = tr.train_step(images, labels)["loss"]
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[remat] = (loss, [p.grad.detach().clone()
                             for p in tr.model.parameters()], peak, counts)
        del tr
        torch.cuda.empty_cache()
    (l1, g1, m1, c1), (l0, g0, m0, _) = out[True], out[False]
    bits = torch.equal(l1, l0) and all(torch.equal(a, b)
                                       for a, b in zip(g1, g0))
    want = expected({"A": depth, "A′": depth, "C": 2, "D": depth // 2,
                     "D′": depth // 2, "N-gmm": 3 * depth, "tgmm": depth,
                     "F": 2 * (1 + depth + 2) + 6 * (depth // 2)})
    ok = bits and m1 < m0 and c1 == want
    log(f"[train] vit_b16_moe unfused b{cfg.data.batch_size} one step "
        f"grouped_remat on vs off: loss {l1.item():.6f} vs {l0.item():.6f}, "
        f"loss and every gradient bit-equal {bits}; peak memory {m1:.2f} GiB "
        f"with grouped_remat, {m0:.2f} GiB without ({card}); launches with "
        f"it: " + ", ".join(f"{k} {v}" for k, v in c1.items())
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"grouped_remat changed the step, did not lower "
                             f"the peak, or launched {c1} (expected {want})")


def engine_case(dev):
    """The b128 MoE engine's inputs: tokens [128, 197, 768] routed by a
    seeded router (moe_case's), fp32 gates, bf16 expert banks."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 53)
    tokens, idx = routed_tokens(dev, g, "router", TRAIN_BATCH, N_TOKENS, DIM)
    gv = torch.rand(idx.shape, device=dev, generator=g)
    w = [(torch.randn(*shape, device=dev, generator=g) * 0.02).to(
        torch.bfloat16) for shape in ((EXPERTS, DIM, HIDDEN),
                                      (EXPERTS, HIDDEN),
                                      (EXPERTS, HIDDEN, DIM), (EXPERTS, DIM))]
    return tokens.reshape(TRAIN_BATCH, N_TOKENS, DIM), gv, idx, w


def phase_engines(dev, card):
    """The unfused engine (N-gmm, tgmm, F) against the fused one (M, M′,
    tgmm) on the same b128 routing at drop 0: the output and the gradients
    of x, the gates and every weight within GRAD_REL_TOL of the largest
    (the two round at other points, and M's GELU is the A&S erf); then each
    engine's forward and forward + backward at drop 0.1 (CUDA events)."""
    import torch

    from gavit_tpu_torch.ops import moe_fused as MF
    from gavit_tpu_torch.ops import moe_grouped as MG
    from gavit_tpu_torch.ops import philox

    x, gv, idx, w = engine_case(dev)
    seed, sites = philox.step_seed(SEED, 9), (5, 6)
    engines = {"fused": MF.grouped_moe_mlp_fused,
               "unfused": MG.grouped_moe_mlp}
    dy = torch.randn(x.shape, device=dev).to(torch.bfloat16)
    got = {}
    for name, fn in engines.items():
        leaves = [t.detach().clone().requires_grad_(True) for t in
                  [x, gv, *w]]
        out = fn(leaves[0], leaves[1], idx, *leaves[2:], seed, sites)
        out.backward(dy)
        got[name] = [out.detach()] + [t.grad for t in leaves]
    torch.cuda.synchronize()
    names = ("out", "dx", "dgates", "dw1", "db1", "dw2", "db2")
    rels = {n: rel_err(a, b) for n, a, b in zip(names, got["unfused"],
                                                 got["fused"])}
    check("unfused vs fused MoE engine", max(rels.values()) <= GRAD_REL_TOL,
          f"bf16 b{TRAIN_BATCH} (T={idx.numel()}) drop 0, rel to max "
          + ", ".join(f"{n} {v:.3e}" for n, v in rels.items())
          + f" (tol {GRAD_REL_TOL:.0e})")
    leaves = [t.detach().clone().requires_grad_(True) for t in [x, gv, *w]]
    for name in ("fused", "unfused", "unfused", "fused"):
        fn = engines[name]

        def run():
            return fn(leaves[0], leaves[1], idx, *leaves[2:], seed, sites,
                      drop=DROP_RATE)

        with torch.no_grad():
            fwd = cuda_ms(run, iters=10)
        both = cuda_ms(lambda: run().backward(dy), iters=10)
        log(f"[time] MoE {name} engine b{TRAIN_BATCH} bf16 drop "
            f"{DROP_RATE}: forward {fwd:.4f} ms, forward + backward "
            f"{both:.4f} ms ({card})")


def phase_upcycle(cfg, dev, n_images=32):
    """``upcycle_params`` of a dense ViT-B/16 (the MoE config with MoE off,
    random weights from SEED, graph gates at GATE, the MLP biases drawn
    from a normal: at init they are zero) into the MoE model, the grouped
    engine pinned: its bf16 forward through the fused engine (M) and
    through the unfused one (N-gmm) against the dense model's forward
    (kernels B in every block), probabilities within PROB_TOL. The zero
    router ties all experts: each token takes experts 0 and 1, which hold
    the same weights, so the gate-weighted sum is the dense MLP."""
    import dataclasses

    import numpy as np
    import torch

    from gavit_tpu_torch.config import MoEConfig
    from gavit_tpu_torch.models import moe
    from gavit_tpu_torch.models.vit import build_model, init_params
    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.utils.convert import load_flax_params, to_flax_tree

    mcfg = grouped_engine(cfg).model
    dense = init_params(build_model(dataclasses.replace(
        mcfg, moe=MoEConfig(enabled=False)), precision="bf16"),
        torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 7)
    with torch.no_grad():
        for gb in dense.graphs:
            gb.gate.fill_(GATE)
        for blk in dense.blocks:
            for fc in (blk.mlp.fc1, blk.mlp.fc2):
                fc.bias.copy_(torch.randn(fc.bias.shape, generator=g) * 0.02)
    sparse = build_model(mcfg, precision="bf16")
    tree = moe.upcycle_params(to_flax_tree(dense), to_flax_tree(init_params(
        sparse, torch.Generator().manual_seed(SEED + 1))), mcfg)
    load_flax_params(sparse, tree)
    dense, sparse = dense.to(dev), sparse.to(dev)
    s = cfg.data.image_size
    x = val_preprocess(torch.from_numpy(np.random.default_rng(SEED + 6)
                                        .integers(0, 256, (n_images, s, s, 3),
                                                  np.uint8)).to(dev))
    choices = []
    topk = moe.router_topk

    def record(logits, k, **kw):
        vals, idx, aux = topk(logits, k, **kw)
        choices.append(idx)
        return vals, idx, aux

    with torch.inference_mode():
        want = torch.sigmoid(dense(x).float())
        for gate, kernel in (("1", "M"), ("0", "N-gmm")):
            with fused_gate(gate):
                torch.cuda.synchronize()
                reset_counts()
                moe.router_topk = record
                try:
                    got = torch.sigmoid(sparse(x).float())
                finally:
                    moe.router_topk = topk
                torch.cuda.synchronize()
                counts = read_counts()
            err = max_err(got, want)
            ties = all((c[..., 0] == 0).all().item()
                       and (c[..., 1] == 1).all().item() for c in choices)
            ok = err <= PROB_TOL and counts[kernel] > 0 and ties
            log(f"[slice] upcycled vit_b16_moe ({'fused' if gate == '1' else 'unfused'} "
                f"engine, {kernel} launched {counts[kernel]} times) against "
                f"the dense model, {n_images} images bf16: max |dp| "
                f"{err:.3e} (tol {PROB_TOL:.0e}); every token on experts 0 "
                f"and 1 {ties} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("the upcycled MoE model does not compute "
                                     "the dense model's function")
            choices.clear()


def phase_unfused_times(cfg, dev, results, weights, trainers, batch, card):
    """N-gmm in both forms at the b128 routing against its plain version,
    ``torch._grouped_mm`` and the bound; the MoE model's bf16 forward at
    b128 with the fused gate on and off (the same model, CUDA events); its
    b128 train step through the fused and the unfused engine (``trainers``,
    host clock, alternating, median of 10)."""
    import numpy as np
    import torch

    from gavit_tpu_torch.ops import gmm as GM
    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.serving import Predictor

    c = results["N-gmm"]["cases"][0]
    x, w1, dh, gs, t = c["x"], c["w1"], c["dh"], c["gs"], c["t"]
    h, dy = c["h"], c["dy"]
    grouped = getattr(torch, "_grouped_mm", None)
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    rows = {}
    for key, a, tr in (("N-gmm", x, False), ("N-gmm transposed", dh, True)):
        b = w1.transpose(1, 2) if tr else w1
        lib = (None if grouped is None  # a yardstick the port never calls
               else cuda_ms(lambda: grouped(a, b, offs=offs)))
        rows[key] = (cuda_ms(lambda: GM.gmm_kernel(a, w1, gs, tr)),
                     cuda_ms(lambda: GM.gmm_reference(a, w1, gs, tr), iters=3,
                             warmup=1), lib) + bound(
            2 * t * DIM * HIDDEN,
            (t * a.shape[1] + EXPERTS * DIM * HIDDEN
             + t * (DIM + HIDDEN - a.shape[1])) * 2)
        dk = device_ms(lambda: GM.gmm_kernel(a, w1, gs, tr))
        dl = None if grouped is None else device_ms(
            lambda: grouped(a, b, offs=offs))
        results["N-gmm"][key.replace("N-gmm", "device")] = (dk, dl)
        km, pm, lm, bms, by = rows[key]
        log(f"[time] {key} at b{TRAIN_BATCH} (T={t}, groups {gs.tolist()}): "
            f"kernel {km:.4f} ms, plain {pm:.4f} ms, torch._grouped_mm "
            f"{'n/a' if lm is None else f'{lm:.4f} ms'}, bound {bms:.4f} ms "
            f"({by}); device alone (20 launches between two events): kernel "
            f"{dk:.4f} ms, torch._grouped_mm "
            f"{'n/a' if dl is None else f'{dl:.4f} ms'} ({card})")
    # tgmm alone on the device over the packed rows, both dW, and dW1 with
    # every row on expert 5 (96 of its 768 tiles have work)
    device = results["tgmm"].setdefault("device", {})
    for what, a, b in (("dW1", x, dh), ("dW2", h, dy)):
        device[f"{what} packed"] = (
            device_ms(lambda: GM.tgmm_kernel(a, b, gs)),
            None if grouped is None
            else device_ms(lambda: grouped(a.t(), b, offs=offs)))
    hot = torch.zeros_like(gs)
    hot[5] = t
    device["dW1 one hot expert"] = (
        device_ms(lambda: GM.tgmm_kernel(x, dh, hot)), None)
    for what, (dk, dl) in device.items():
        log(f"[time] tgmm {what}, device alone: kernel {dk:.4f} ms, "
            f"torch._grouped_mm {'n/a' if dl is None else f'{dl:.4f} ms'} "
            f"({card})")

    s = cfg.data.image_size
    model = Predictor(cfg, weights, precision="bf16", device=dev).model
    xb = val_preprocess(torch.from_numpy(np.random.default_rng(SEED + 3)
                                         .integers(0, 256, (TRAIN_BATCH, s, s,
                                                            3), np.uint8)
                                         ).to(dev))
    for gate in ("1", "0", "0", "1"):
        with fused_gate(gate), torch.inference_mode():
            ms = cuda_ms(lambda: model(xb), iters=10, warmup=2)
        log(f"[time] MoE bf16 forward b{TRAIN_BATCH} (grouped engine, "
            f"{'fused' if gate == '1' else 'unfused'}): {ms:.3f} ms, "
            f"{TRAIN_BATCH / (ms / 1000):.1f} img/s ({card})")
    del model, xb

    images, labels = (torch.from_numpy(a) for a in batch)
    step_ms = {name: [] for name in trainers}
    for i in range(11):
        for name, tr in trainers.items():
            with fused_gate("1" if name == "fused" else "0"):
                t0 = time.perf_counter()
                tr.train_step(images, labels)
                torch.cuda.synchronize()
            if i:  # the first of each: warm-up
                step_ms[name].append((time.perf_counter() - t0) * 1000)
    for name, ts in step_ms.items():
        ms = statistics.median(ts)
        log(f"[time] MoE train step b{TRAIN_BATCH} bf16 {name} engine: "
            f"{ms:.3f} ms (median of {len(ts)}), "
            f"{TRAIN_BATCH / (ms / 1000):.1f} img/s ({card})")
    return rows


def grouped_engine(cfg):
    """``cfg`` with the MoE engine pinned to 'grouped': the plain versions'
    Predictor at b64 then runs the engine that 'auto' picks with the
    kernels."""
    import dataclasses

    model = dataclasses.replace(cfg.model, moe=dataclasses.replace(
        cfg.model.moe, impl="grouped"))
    return dataclasses.replace(cfg, model=model)


def train_config_moe():
    """The MoE example at its batch 128 with a warmup of 5 steps (5 steps an
    epoch of a 640-image synthetic set with learnable class stripes)."""
    from gavit_tpu_torch import load_config

    return load_config(str(CONFIG_MOE), [
        f"data.batch_size={TRAIN_BATCH}", "data.synthetic_size=640",
        "data.synthetic_learnable=true", "training.warmup_epochs=1",
        f"training.seed={SEED}"])


def kernels_json(results, serve_counts, train_counts, rows):
    """One row per kernel. ``launches``: from a training step for the
    kernels on its path (224 px b128 for A, A′, C, D, D′, F; 384 px b16 for
    K, K′, H, H′; 512 px b32 for L, L′; the MoE model at b128 for M, M′,
    tgmm; the MoE model at b128 with the fused gate off for N-gmm, both
    forms counted), from the served requests for B, from the op-level
    phase for I, I′, J, J′, G and E (no training or serving path launches
    them). N-gmm's times are its
    forward form's; ``transposed`` holds the transposed form's. B, D, M,
    N-gmm, tgmm, M′ and D′, redesigned on the TMA-fed wgmma mainloop, C, L,
    A′, K′, I′, J′ and L′, redesigned as TMA-fed wgmma kernels, and E, F,
    G, H and H′ also carry ``device_ms`` and ``library_device_ms``: 20
    launches between two events, no host gap (E's and G's library figures
    null) (tgmm's: dW1 over the cap-padded rows,
    its ``device`` both dW over the cap-padded and the packed rows and dW1
    with one hot expert; C's library figure null). D′'s ``library_ms`` is
    the chain's backward from y to the fc1 output; its
    ``library_full_bwd_ms`` the whole chain's backward onto x and the
    weights."""
    spec = [
        ("A", "fused_qkv_attention",
         "gavit_tpu_torch/csrc/attention_fwd_sm90.cu",
         "gavit_tpu/ops/attention.py:583"),
        ("A′", "fused_qkv_attention_bwd",
         "gavit_tpu_torch/csrc/attention_bwd_sm90.cu",
         "gavit_tpu/ops/attention.py:608"),
        ("B", "fused_mlp_inference", "gavit_tpu_torch/csrc/mlp.cu",
         "gavit_tpu/ops/mlp.py:582"),
        ("C", "fused_graph_aggregate", "gavit_tpu_torch/csrc/graph.cu",
         "gavit_tpu/ops/graph_ops.py:129"),
        ("D", "fused_mlp_train_fwd", "gavit_tpu_torch/csrc/mlp.cu",
         "gavit_tpu/ops/mlp.py:145"),
        ("D′", "fused_mlp_train_bwd", "gavit_tpu_torch/csrc/mlp.cu",
         "gavit_tpu/ops/mlp.py:192"),
        ("F", "fused_dropout", "gavit_tpu_torch/csrc/dropout.cu",
         "gavit_tpu/ops/dropout.py:33"),
        ("K", "fused_qkv_attention_long",
         "gavit_tpu_torch/csrc/attention_fwd_sm90.cu",
         "gavit_tpu/ops/attention.py:453"),
        ("K′", "fused_qkv_attention_long_bwd",
         "gavit_tpu_torch/csrc/attention_bwd_sm90.cu",
         "gavit_tpu/ops/attention.py:475"),
        ("L", "fused_qkv_attention_large",
         "gavit_tpu_torch/csrc/attention_fwd_sm90.cu",
         "gavit_tpu/ops/attention.py:803"),
        ("L′", "fused_qkv_attention_large_bwd",
         "gavit_tpu_torch/csrc/attention_bwd_sm90.cu",
         "gavit_tpu/ops/attention.py:852"),
        ("H", "fused_gelu_dropout", "gavit_tpu_torch/csrc/dropout.cu",
         "gavit_tpu/ops/dropout.py:252"),
        ("H′", "fused_gelu_dropout_bwd", "gavit_tpu_torch/csrc/dropout.cu",
         "gavit_tpu/ops/dropout.py:261"),
        ("M", "fused_grouped_mlp", "gavit_tpu_torch/csrc/moe.cu",
         "gavit_tpu/ops/moe_fused.py:116"),
        ("M′", "fused_grouped_mlp_bwd", "gavit_tpu_torch/csrc/moe.cu",
         "gavit_tpu/ops/moe_fused.py:167"),
        ("tgmm", "grouped_dw_tgmm", "gavit_tpu_torch/csrc/moe.cu",
         "gavit_tpu/ops/moe_fused.py:411"),
        ("N-gmm", "grouped_gemm_gmm", "gavit_tpu_torch/csrc/moe.cu",
         "gavit_tpu/ops/moe_grouped.py:138"),
        ("I", "attention_pallas",
         "gavit_tpu_torch/csrc/attention_fwd_sm90.cu",
         "gavit_tpu/ops/attention.py:102"),
        ("I′", "attention_pallas_bwd",
         "gavit_tpu_torch/csrc/attention_bwd_sm90.cu",
         "gavit_tpu/ops/attention.py:125"),
        ("J", "fused_attention_v2",
         "gavit_tpu_torch/csrc/attention_fwd_sm90.cu",
         "gavit_tpu/ops/attention.py:301"),
        ("J′", "fused_attention_v2_bwd",
         "gavit_tpu_torch/csrc/attention_bwd_sm90.cu",
         "gavit_tpu/ops/attention.py:321"),
        ("G", "fused_dropout_add", "gavit_tpu_torch/csrc/dropout.cu",
         "gavit_tpu/ops/dropout.py:115"),
        ("E", "kernel_mask", "gavit_tpu_torch/csrc/dropout.cu",
         "gavit_tpu/ops/mlp.py:340"),
    ]
    out = []
    for key, name, src, rep in spec:
        km, pm, lm, bms, by = rows[key]
        counts = serve_counts if key == "B" else train_counts[
            "384" if key in ("K", "K′", "H", "H′") else
            "512" if key in ("L", "L′") else
            "moe" if key in ("M", "M′", "tgmm") else
            "moe_unfused" if key == "N-gmm" else
            "ops" if key in ("I", "I′", "J", "J′", "G", "E") else "224"]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": counts[key],
                    "max_abs_err": max(results[key]["errs"]), "ms": km,
                    "plain_ms": pm, "bound_ms": bms, "bound_by": by,
                    "library_ms": lm})
    row = dict(zip([key for key, _, _, _ in spec], out))
    km, pm, lm, bms, by = rows["N-gmm transposed"]
    row["N-gmm"]["transposed"] = {"ms": km, "plain_ms": pm, "bound_ms": bms,
                                  "bound_by": by, "library_ms": lm}
    tgmm_device = results["tgmm"]["device"]
    for key in ("A′", "B", "C", "D", "D′", "E", "F", "G", "H", "H′", "K′",
                "I′", "J′", "L", "L′", "M", "M′", "N-gmm"):
        row[key]["device_ms"], row[key]["library_device_ms"] = \
            results[key]["device"]
    (row["N-gmm"]["transposed"]["device_ms"],
     row["N-gmm"]["transposed"]["library_device_ms"]) = \
        results["N-gmm"]["device transposed"]
    row["tgmm"]["device_ms"], row["tgmm"]["library_device_ms"] = \
        tgmm_device["dW1 cap-padded"]
    row["tgmm"]["device"] = {what: {"ms": dk, "library_ms": dl}
                             for what, (dk, dl) in tgmm_device.items()}
    row["D′"]["library_full_bwd_ms"] = results["D′"]["full bwd"]
    for key in ("B", "N-gmm", "D", "D′", "tgmm", "M", "M′"):
        row[key]["redesigned"] = "TMA-fed wgmma, csrc/gemm_sm90.cuh"
    for key in ("A′", "K′", "I′", "J′", "L′"):
        row[key]["redesigned"] = ("TMA-fed wgmma, query-major and key-major "
                                  "launches, csrc/attention_bwd_sm90.cu"
                                  + (" (lse mode)" if key == "L′" else ""))
    row["L"]["redesigned"] = ("TMA-fed wgmma, one-pass online softmax, "
                              "csrc/attention_fwd_sm90.cu")
    row["C"]["redesigned"] = ("TMA-fed wgmma, one kernel a 128-row tile, "
                              "csrc/graph.cu")
    for key in ("F", "H", "H′"):
        row[key]["redesigned"] = ("persistent walk, next units loaded first, "
                                  "csrc/dropout.cu")
    row["G"]["redesigned"] = "one 16-byte unit a thread, csrc/dropout.cu"
    row["E"]["redesigned"] = ("both masks in one launch, 16-byte stores, "
                              "csrc/dropout.cu")
    return {"kernels": out}


def main():
    card = phase_environment()
    import torch

    from gavit_tpu_torch import load_config

    dev = torch.device("cuda", 0)
    phase_build()
    results = {k: {"errs": [], "cases": []} for k in COUNTERS}
    check_attention(dev, results)
    check_mlp(dev, results)
    check_graph(dev, results)
    check_dropout(dev, results)
    check_mlp_train(dev, results)
    check_attention_bwd(dev, results)
    check_long_attention(dev, results)
    check_gelu_dropout(dev, results)
    # the JAX package's op-level entry points (the counts of their own run),
    # then I/I′ and J/J′ at other lengths, and their times
    counts_ops = phase_ops(dev, results)
    check_bhnd_attention(dev, results)
    op_rows = phase_op_times(dev, results, card)

    # 224 px: vit_b16_graph2 (12 blocks, 2 kNN graph blocks)
    cfg = load_config(str(CONFIG))
    weights = gated_weights(cfg)
    depth = cfg.model.depth
    phase_slice(cfg, weights, dev, "vit_b16_graph2")
    predictor, reference, serve_counts = phase_serve(cfg, weights, dev)
    tcfg = train_config()
    # per block A, A′, D, D′; C at 2 graph blocks; F forward and backward at
    # the embedding, 12 attention projections and 2 graph projections
    trainer, batch, counts_224 = phase_train(
        tcfg, dev, "vit_b16_graph2",
        {"A": depth, "A′": depth, "C": 2, "D": depth, "D′": depth,
         "F": 2 * (1 + depth + 2)})
    # the same with stochastic depth at 0.1 (no shipped config sets it): the
    # kernels' step against the plain versions' (the same generator draws
    # the same per-sample masks), launches as above, and fewer steps that
    # must lower the loss
    phase_train(train_config(["model.drop_path_rate=0.1"]), dev,
                "vit_b16_graph2 drop_path 0.1",
                {"A": depth, "A′": depth, "C": 2, "D": depth, "D′": depth,
                 "F": 2 * (1 + depth + 2)}, steps_compare=3, steps_learn=20)
    # attention-probability dropout at 0.1 (no shipped config sets it): the
    # attention leaves kernels A/A′ for the plain attention with a Philox
    # mask in both trainers; b32 over a 160-image set (a warmup of 5 steps)
    # keeps its [B, 12, 197, 197] fp32 probabilities small
    phase_train(train_config(["model.attn_drop_rate=0.1", "data.batch_size=32",
                              "data.synthetic_size=160"]), dev,
                "vit_b16_graph2 attn_drop 0.1",
                {"C": 2, "D": depth, "D′": depth, "F": 2 * (1 + depth + 2)},
                steps_compare=3, steps_learn=15)

    # 384 px: finetune_384 (12 blocks, 1 learned-static graph block): K and
    # B in the forward; in training K, K′, H, H′ per block (M = 16·577 has
    # no row block) and F at the embedding, 12 attention projections, 12
    # MLP outputs and the graph projection, forward and backward
    cfg384 = load_config(str(CONFIG_384))
    weights384 = gated_weights(cfg384)
    phase_slice(cfg384, weights384, dev, "finetune_384", n_images=BATCH_384,
                expect={"K": depth, "B": depth})
    tcfg384 = train_config_384()
    trainer384, batch384, counts_384 = phase_train(
        tcfg384, dev, "finetune_384",
        {"K": depth, "K′": depth, "H": depth, "H′": depth,
         "F": 2 * (1 + 2 * depth + 1)})

    phase_times(cfg, dev, results, (predictor, reference), card)
    del predictor, reference
    rows, _ = phase_train_times(tcfg, dev, results, trainer, batch, card)
    rows.update(op_rows)
    del trainer
    rows.update(phase_384_times(cfg384, tcfg384, dev, results, weights384,
                                trainer384, batch384, card))
    del trainer384, weights384

    # 512 and 1024 px: vit_b16_graph2 with model.img_size and
    # data.image_size set; attention through L (L′ in training), the graph
    # blocks through the chunked tensor ops (kernel C never). At 512 px b32
    # M = 32·1025 has a row block: the MLP trains through D/D′; at 1024 px
    # b4 M = 4·4097 has none: fc1, H, fc2, F.
    check_blockwise_attention(dev, results)
    check_graph_chunked(dev)
    cfg512 = large_config(512)
    weights512 = gated_weights(cfg512)
    phase_slice(cfg512, weights512, dev, "vit_b16_graph2", n_images=8,
                expect={"L": depth, "B": depth})
    predictor512 = phase_serve_large(cfg512, weights512, dev, (1, 8), card)
    tcfg512 = train_config_large(512, BATCH_512, remat=False)
    # per step L, L′, D, D′ in 12 blocks; F as at 224 px
    trainer512, batch512, counts_512 = phase_train(
        tcfg512, dev, "vit_b16_graph2 512 px",
        {"L": depth, "L′": depth, "D": depth, "D′": depth,
         "F": 2 * (1 + depth + 2)})
    cfg1024 = large_config(1024)
    weights1024 = gated_weights(cfg1024)
    phase_slice(cfg1024, weights1024, dev, "vit_b16_graph2", n_images=2,
                expect={"L": depth, "B": depth})
    phase_serve_large(cfg1024, weights1024, dev, (1, BATCH_1024), card)
    del weights1024
    tcfg1024 = train_config_large(1024, BATCH_1024, remat=True)
    # remat recomputes each block in the backward: per block L and H twice
    # (forward, recompute), L′ and H′ once, F at the attention and MLP
    # outputs 3 times each (forward, recompute, backward); F at the
    # embedding and the 2 graph projections forward and backward
    trainer1024, batch1024, _ = phase_train(
        tcfg1024, dev, "vit_b16_graph2 1024 px remat",
        {"L": 2 * depth, "L′": depth, "H": 2 * depth, "H′": depth,
         "F": 2 * (1 + 2) + 6 * depth}, steps_compare=3, steps_learn=0)
    phase_remat(tcfg1024, dev, batch1024, card)
    rows.update(phase_large_times(
        cfg512, weights512, dev, results, predictor512,
        {"512 px": (trainer512, batch512, tcfg512),
         "1024 px remat": (trainer1024, batch1024, tcfg1024)}, card))
    del trainer512, trainer1024, predictor512, weights512

    # the MoE example (12 blocks, MoE MLPs in blocks 1, 3, ..., 11, 2 kNN
    # graph blocks): at b64 the grouped engine (M in 6 blocks, B in the
    # other 6), at b1 the dense one (einsums, no M)
    check_moe(dev, results)
    cfg_moe = load_config(str(CONFIG_MOE))
    weights_moe = gated_weights(cfg_moe)
    phase_slice(cfg_moe, weights_moe, dev, "vit_b16_moe", n_images=64,
                expect={"A": depth, "B": depth // 2, "C": 2, "M": depth // 2},
                ref_cfg=grouped_engine(cfg_moe))
    phase_slice(cfg_moe, weights_moe, dev, "vit_b16_moe", n_images=1,
                expect={"A": depth, "B": depth // 2, "C": 2})
    # per step A, A′ in 12 blocks; D, D′ in the 6 dense ones; M, M′ in the 6
    # MoE ones with two tgmm each; C at 2 graph blocks; F as vit_b16_graph2
    tcfg_moe = train_config_moe()
    trainer_moe, batch_moe, counts_moe = phase_train(
        tcfg_moe, dev, "vit_b16_moe",
        {"A": depth, "A′": depth, "C": 2, "D": depth // 2,
         "D′": depth // 2, "M": depth // 2, "M′": depth // 2,
         "tgmm": depth, "F": 2 * (1 + depth + 2)})
    rows.update(phase_moe_times(cfg_moe, tcfg_moe, dev, results, weights_moe,
                                trainer_moe, batch_moe, card))

    # the MoE example with the fused kernels switched off
    # (GAVIT_MOE_FUSED=0): the unfused grouped engine, N-gmm for the expert
    # GEMMs and, transposed, for their input gradients, tgmm for dW, F for
    # the MLP's dropout. auto picks it past GROUPED_MIN_PAIRS: at b128, not
    # at b64. Per step as the fused engine's, with N-gmm 4 and tgmm 2 in
    # each of the 6 MoE blocks in place of M, M′ and tgmm 2, and F at their
    # two sites, forward and backward.
    check_gmm(dev, results)
    with fused_gate("0"):
        phase_slice(cfg_moe, weights_moe, dev, "vit_b16_moe unfused",
                    n_images=TRAIN_BATCH,
                    expect={"A": depth, "B": depth // 2, "C": 2,
                            "N-gmm": depth})
        trainer_unf, _, counts_unfused = phase_train(
            tcfg_moe, dev, "vit_b16_moe unfused",
            {"A": depth, "A′": depth, "C": 2, "D": depth // 2,
             "D′": depth // 2, "N-gmm": 2 * depth, "tgmm": depth,
             "F": 2 * (1 + depth + 2) + 2 * 2 * (depth // 2)})
        phase_grouped_remat(tcfg_moe, dev, batch_moe, card)
    phase_engines(dev, card)
    phase_upcycle(cfg_moe, dev)
    rows.update(phase_unfused_times(
        cfg_moe, dev, results, weights_moe,
        {"fused": trainer_moe, "unfused": trainer_unf}, batch_moe, card))
    del trainer_moe, trainer_unf
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "flax", "gavit_tpu")]
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    log(f"[env] nothing of jax, flax or gavit_tpu imported; {card}")
    print(card)
    print(json.dumps(kernels_json(results, serve_counts,
                                  {"224": counts_224, "384": counts_384,
                                   "512": counts_512, "moe": counts_moe,
                                   "moe_unfused": counts_unfused,
                                   "ops": counts_ops},
                                  rows), ensure_ascii=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
