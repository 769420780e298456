#!/usr/bin/env python3
"""Bring-up check of the PyTorch port's bf16 serving and training paths,
its fp32 Grad-CAM and training at every length and of the MoE example, and
its MAE pretraining,
on one CUDA card,
from synthetic batches and from image files: ViT-B/16
with two kNN graph blocks at 224 px (``configs/vit_b16_graph2.yaml``),
the same model at 512 and 1024 px
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
   MLP) and A′ (attention backward) at the training shapes (batch 128), A′
   in fp32 at N = 50, 197 (b64) and 416 with its reruns bit-equal; K
   and K′ (long-sequence attention) at 384 px (N=577, b1 and b16), H and H′
   (GELU + dropout) at the 384 fine-tune's hidden rows [16·577, 3072]; M,
   M′ and tgmm (the MoE expert MLP forward, backward and grouped dW) at the
   b128 routing (T = 50432 pairs, tm = 256) of a seeded router, with a
   hot and an empty expert, and at b8 (T = 3152, tm = 32), M's reruns
   bit-equal; L and L′ (blockwise attention) at N = 750, 1025 (b32), 1088
   and 4097, each run twice for the same bits, and the chunked graph path
   (tensor ops) at 1024 and 4096 patch tokens; K, K′, L and L′ in fp32
   (``csrc/attention_f32.cu``) at N = 417, 577 (b16), 708 and 709, 1025
   (b32), 4097 with 1 to 12 heads, each run twice for the same bits, and
   I/J fp32 through ``multi_head_attention`` and ``fused_attention_v2``
   (b8 × 12 × 577, forward and backward) and ``attention_pallas`` at 1025
   on L fp32; N-gmm (the unfused engine's ragged grouped GEMM)
   in both forms at the b128 routing, with a hot and an empty expert and
   at b127 (T = 50038, no multiple of the row tile), the same bits again
   (B too), and tgmm's two dW on the same packed rows as well as on the
   fused engine's cap-padded ones (empty experts zero, the same bits
   again); M, M′, tgmm and N-gmm again in fp32 (``csrc/moe_f32.cu``, the
   CUDA cores) at the same routings, each output within 2e-5 of its
   largest magnitude, every rerun bit-equal;
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
5. serve: ``scripts/serve_torch.py``'s HTTP server in-process with a
   224-px Predictor, warmed as the CLI warms it (each bucket's eager run
   and its CUDA-graph capture); every response must be 200 and match the
   plain-version Predictor; the kernels' launch counters, zeroed just
   before the warm-up, must show every serving kernel's wrapper launched
   there, and a ``torch.profiler`` trace of the requests must show the
   replays running on the device the port's kernels that the eager path
   runs on the same images; the 512- and
   1024-px Predictors (buckets 1 and 8, 1 and 4) against their plain
   versions, with the launches of their warm-up; then ``serve_quant``:
   the int8 GEMM (cuBLASLt through ``torch._int_mm``) at every quantised
   site's shape at b1, b8 and b64 bit-equal to its plain version; the
   224-px int8 ``Predictor`` calibrated on 8 images, warmed over buckets
   1/8/64 (A, C and the int8 GEMMs counted, never B), against the same
   Predictor on the plain versions under the same scales and against the
   bf16 one, its rerun bit-equal; ToMe at r = 8 in bf16 (A, B, C) and
   int8 (A, C, int8 GEMMs) against the plain versions, ``tome_forward``
   at r = 0 bit-equal to the model; the b1 p50 and b64 images/s of each;
   then ``serve_graphs``: the CUDA Predictor serves each bucket from one
   captured CUDA graph, and for bf16, int8 and ToMe r = 8 at buckets 1
   and 64 each replay is bit-equal to the eager kernel path and runs the
   port's kernels it runs (a ``torch.profiler`` trace of each; a replay
   runs no wrapper and moves no counter), with b1 p50, b64 images/s and
   the b1 idle share eager and captured;
   then ``export``: ``export_serving`` at 224 px over buckets 1 and 8 in
   bf16 and int8, the artifact loaded by ``ExportedPredictor`` (one CUDA
   graph a bucket) launching the kernels' custom ops, against its own
   eager path, the Predictor and the plain versions;
   and, after the 224-px training phase, QAT (``training.qat=true``) at
   b128, 3 steps against the plain versions on the same scales (A, A′, C,
   H, H′, F; never D or D′), its checkpoint served by
   ``scripts/serve_torch.py --checkpoint ... --precision int8
   --coalesce-ms 2 --max-queue-rows 64`` in a process of its own:
   concurrent requests against the in-process Predictor, ``/metrics``,
   one 503 with Retry-After, one 413, and SIGTERM (exit 0, ``shutdown
   complete``), under ``build/chip_serve/``, removed at its end;
6. train: each configuration through ``scripts/train_torch.py``'s trainer
   (preprocess → forward with dropout 0.1 → loss → backward → AdamW),
   vit_b16_graph2 and the MoE model at batch 128 (the MoE objective with
   its auxiliary loss), finetune_384 at its batch 16 and vit_b16_graph2 at
   512 px b32: 5 steps through the kernels against 5 through the plain
   versions from the same start (3 for the MoE model on each engine;
   losses, and every gradient of the first step), the launch counts of
   one step, then 30 steps through the kernels
   that must lower the loss; vit_b16_graph2 again with drop_path 0.1 (3
   compared steps, 20 that must lower the loss) and at b32 with
   attn_drop 0.1 (A and A′ not launched; 3 compared steps, 15 that must
   lower the loss); at 1024 px b4 with remat
   3 compared steps and their launches, then one step with remat on
   against one with it off; the MoE model again with the fused gate off,
   then one such step with ``model.moe.grouped_remat`` on against one with
   it off (bit-equal, lower peak memory); the unfused MoE engine against
   the fused one at drop 0; then ``gradcam``: vit_b16_graph2 in fp32 (as
   ``scripts/gradcam_torch.py`` builds it) on 8 images, Grad-CAM at block
   -1 and at block 6 (its backward through A′ in fp32 in blocks 7-11) and
   the attention rollout through the kernels against the plain versions
   (1e-4), each call's launches counted; A′ in fp32 alone at b64 N = 197
   beside sdpa's fp32 forward and backward (TF32 off) and its bound;
   three fp32 training steps at b32 against the plain versions' (losses
   within 1e-4, the launches of one step), their checkpoint, and
   ``scripts/gradcam_torch.py`` on it in a process of its own (exit 0, its
   figures drawn or, without matplotlib, each skipped with a log line),
   under ``build/chip_gradcam/``, removed at its end; then, after the
   384-px training phase, ``fp32_long``: finetune_384 in fp32 (N = 577)
   on 8 images, Grad-CAM at blocks -1 and 6 through K and K′ fp32 against
   the plain versions (1e-4), three fp32 steps at its b16 against the
   plain versions' (losses within 1e-4, K fp32 12, K′ fp32 12), their
   checkpoint through ``scripts/gradcam_torch.py --config
   configs/finetune_384.yaml`` (exit 0; under ``build/chip_gradcam_384/``,
   removed), three fp32 steps of vit_b16_graph2 at 512 px b32 (N = 1025)
   at full width and 4 of its 12 blocks (L fp32 4, L′ fp32 4), and the
   four fp32 bodies' times; after the MoE phases, ``fp32_moe``: three
   fp32 training steps of the MoE example at b64 with 4 of its 12 blocks
   on the fused grouped engine (M, M′, tgmm in fp32) and on the unfused
   one (N-gmm, tgmm in fp32) against the plain versions' (losses within
   1e-4, the plain steps on the kernels' expert choices, the flips
   counted, the launches of one step), fp32 Grad-CAM of the whole model
   on 8 images at blocks -1 and 6 on the grouped engine and its attention
   rollout against the plain versions (1e-4), and the four fp32 bodies'
   times beside a loop of fp32 ``torch.matmul`` per expert;
7. times: each kernel against its plain version and a library call (CUDA
   events, median), for B, C, D, D′, E, F, G, H, H′, L, L′, M, M′, N-gmm, tgmm
   (and K, K′, L, L′ in fp32 at b16 N = 577 and b32 N = 1025 beside sdpa
   in fp32 with TF32 off, in the ``fp32_long`` phase)
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
   its byte bound;
8. run: the training run as a user starts it, through
   ``scripts/train_torch.py``'s and ``scripts/evaluate_torch.py``'s mains:
   one accumulated step at 2 x b128, 2 x b64 (D/D′) and 8 x b16 (H/H′, F)
   against the plain versions; ``configs/v5e8_dp.yaml`` at its global
   batch 1024 as 8 micro-batches of 128, two epochs of two steps with
   validation at b1024, the metric battery and checkpoints, its launches
   counted (zeroed just before); images/s per epoch and of validate;
   ``predict`` at b1024 and a ragged tail of 100 against the plain
   forward; two identical accumulated steps (bit-equal, or the spread
   that resume is held to, named); ``--resume auto`` from the epoch-1
   checkpoint in a fresh Trainer bit-equal to the uninterrupted run; a
   SIGTERM mid-epoch, its incomplete checkpoint and its resume; the
   evaluation of the best checkpoint; a reference-layout ``.pth`` of a
   224-px model loaded into finetune_384 (position embeddings 14 → 24,
   the head fresh) and 3 steps that lower the loss; the static graph
   (``model.graph.dynamic=false``) forward and 10 steps. Its checkpoints
   go under ``build/chip_run/`` and are removed at its end;
9. data: training and evaluation from image files, through the same
   mains: 512 train and 128 val grayscale 1024 x 1024 PNGs (NIH
   ChestX-ray14's format) and their label files written from SEED, the
   train split packed at 224 px by ``scripts/prepare_dataset_torch.py``
   (3 rows bit-equal to the PNGs' decode), vit_b16_graph2 at b128 from
   the pack with RandomAffine through the checkpointable loader
   (``data.loader=grain``) and the PNG val split decoded on
   ``os.cpu_count()`` threads, 2 epochs of 4 steps (images/s an epoch,
   the step's wait on the loader, validate's images/s, its launches
   counted); SIGTERM after step 3 and ``--resume auto`` (the two runs
   train each epoch-1 sample exactly once and end bit-equal to the
   uninterrupted run, or within the rerun's spread); the affine train
   preprocess on the card against the CPU at b128 (1e-5) and its cost;
   the threaded loader's images/s over the 512 train PNGs at 4, 8 and
   16 threads and over the pack (``tools/time_loader_torch.py`` takes the
   same measurement in a process of its own); ``evaluate_torch`` with ``--dataset nih`` and
   ``chexpert``. The corpus goes under ``build/chip_data/`` and is
   removed at the end;
10. mae: MAE pretraining of ViT-B/16 at 224 px (vit_b16_graph2's trunk)
   with ``scripts/pretrain_mae_torch.py``'s 512 x 4 x 8 decoder, mask 0.75,
   bf16, b256: A, A′ and B at the step's encoder (N = 50, 12 heads) and
   decoder (N = 197, 8 heads) shapes against their plain versions, and B's
   gradient (the chain's VJP behind it) against autograd through the plain
   chain; 3 steps through the kernels against 3 through the plain versions
   on the same draws (losses, every first gradient, every MLP weight's
   gradient nonzero), the launches of one step (A, A′ and B 16 each,
   nothing else), 30 steps that lower the loss on 5 fixed batches, the
   step's images/s, A, A′ and B alone at those shapes beside their bounds
   and library calls; then the CLIs: ``pretrain_mae_torch`` for one epoch
   of 2 steps, its ``.pth`` loaded by ``train_torch --set
   model.pretrained_path=...`` (2 steps), ``convert_checkpoint_torch``
   (the ``.pth`` into the port's checkpoint and into vit_b16_moe's model
   with MoE off, that one upcycled, its forward held to the dense one's),
   ``inspect_checkpoint_torch`` on the ``.pth`` and the upcycled
   checkpoint; under ``build/chip_mae/``, removed at its end.

The last two lines are one JSON object describing the kernels and then
``{"ok": true, "device": {...}}``. No CUDA device: exit 1, no result.
"""

from __future__ import annotations

import contextlib
import functools
import io
import itertools
import json
import math
import re
import shutil
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
CONFIG_DP = ROOT / "configs" / "v5e8_dp.yaml"
# the run phase's checkpoints and logs (several GB, removed at its end)
RUN_DIR = ROOT / "build" / "chip_run"
DP_ACCUM = 8  # global batch 1024 as 8 micro-batches of 128 on one card
RUN_DEVICE = "cuda"  # the CLIs' --device in the run and data phases
DATA_DIR = ROOT / "build" / "chip_data"
# the data phase's PNG corpus: train and val images, each NIH's 1024 x 1024
DATA_TRAIN, DATA_VAL, DATA_PNG = 512, 128, 1024
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
# M, M′, tgmm and N-gmm in fp32 against their plain versions: every output
# (y, h1, dx, go, dh1, db1, db2, dW1, dW2, both N-gmm forms) within this
# share of the tensor's largest magnitude (fp32 sums in another order)
MOE_F32_TOL = 2e-5
DROP_RATE = 0.1
TRAIN_BATCH = 128
LOSS_REL_TOL = 2e-2  # per-step loss, kernels vs plain versions, bf16
# the plain versions' int8 forward against the kernels' (PinnedCodes), as
# (codes apart, share of rows, share of codes): a quantised site's input
# may lie this many codes (units of its act scale) from the kernels', a
# bf16 rounding or two at the top of the range; this share of the graph
# projections' token rows may take another kNN neighbour set (a near-tie
# between kernel C's similarities and the plain version's); and this share
# of all codes may differ, where an input sits on a rounding boundary.
# Measured on vit_b16_graph2, the int8 Predictor at b64 and the QAT step
# at b128 (NVIDIA H100 80GB HBM3): at most 0.894 codes, 1 row of the two
# projections' 25,088 and 2.3e-6 of the codes
PIN_BOUNDS = (2.0, 1e-3, 1e-4)
# the same in a QAT step after the two trainers' first different update:
# their weights differ by bf16 roundings of it, and so do more inputs
# (measured 1.910 codes, 322 rows of 50,176, 1.7e-3 of the codes)
PIN_BOUNDS_UPDATED = (4.0, 2e-2, 1e-2)
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
# the affine train preprocess, card vs CPU (fp32, normalised values ~2)
AFFINE_TOL = 1e-5
# A′ in fp32 against its plain version, relative to the largest gradient:
# fp32 products summed in another order (up to 416 keys a row)
ATTN_BWD_F32_TOL = 1e-5
# the gradcam phase: the fp32 model through the kernels against the plain
# versions. Its logits agree to ~1e-5; the CAMs (min-max normalised sums
# of tokens times gradients), the rollout maps and the probabilities are
# held within this, absolute, in [0, 1]
GRADCAM_TOL = 1e-4
# its fp32 training steps: per-step loss, relative (fp32 sums in other
# orders, three AdamW updates)
FP32_LOSS_REL_TOL = 1e-4
GRADCAM_BATCH, FP32_TRAIN_BATCH = 8, 32
GRADCAM_BLOCKS = (-1, 6)  # the last block, and one 5 blocks before it
GRADCAM_DIR = ROOT / "build" / "chip_gradcam"
# K, K′, L and L′ in fp32 (csrc/attention_f32.cu) against their plain
# versions: fp32 products summed in other orders (the online softmax over
# 64-key tiles against one pass over the row); o and the lse absolute,
# dqkv relative to its largest value
ATTN_F32_TOL = 1e-5
# their checks: (batch, tokens, heads), K up to its fp32 bound 708 and L
# from 709 to 1024 px; the 384- and 512-px shapes are kept for the times
F32_LONG_CASES = ((2, 417, 1), (BATCH_384, N_384, HEADS), (1, 708, 5))
F32_LARGE_CASES = ((1, 709, 3), (BATCH_512, N_512, HEADS), (1, N_1024, HEADS))
# the fp32 training steps at 512 px: vit_b16_graph2 at full width with 4
# of its 12 blocks (its two graph blocks after blocks 0 and 2)
FP32_DEPTH_512 = 4
# the fp32 MoE training steps: the MoE example at full width, b64, its
# first 4 blocks (MoE MLPs in blocks 1 and 3)
FP32_MOE_BATCH, FP32_MOE_DEPTH = 64, 4
GRADCAM_384_DIR = ROOT / "build" / "chip_gradcam_384"
# MAE pretraining: scripts/pretrain_mae_torch.py's defaults (decoder dim,
# depth, heads; mask ratio) at b256; 3 steps compared, 30 that must lower
# the loss, 6 timed; the CLI chain's files (removed at its end)
MAE_BATCH, MAE_DECODER, MAE_MASK = 256, (512, 4, 8), 0.75
MAE_STEPS_COMPARE, MAE_STEPS_LEARN, MAE_STEPS_TIMED = 3, 30, 6
MAE_DIR = ROOT / "build" / "chip_mae"
# the H100 SXM's published dense peaks (the bound of each kernel's work)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores (TF32 stays off)
PEAK_INT8_OPS = 1979e12
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
    k_max = A.K_MAX_N[bf]
    routes = tuple(A.attention_route(n, bf) for n in (k_max, k_max + 1))
    check("L route", routes == ("K", "L"),
          f"bf16 N={k_max} takes {routes[0]}, N={k_max + 1} takes "
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


def check_attention_bwd_f32(dev, results, heads=HEADS):
    """A′ in fp32 (``csrc/attention.cu``) at N = 50, 197 (b64, kept for
    its times) and 416, its bound, dO as the output projection's backward
    hands it over; each run twice for the same bits."""
    import torch

    from gavit_tpu_torch.ops import attention as A

    scale = HEAD_DIM ** -0.5
    for b, n in ((8, 50), (64, N_TOKENS), (4, 416)):
        g = torch.Generator(device=dev).manual_seed(SEED + n)
        qkv = torch.randn(b, n, 3 * heads * HEAD_DIM, device=dev,
                          generator=g)
        do = torch.randn(b, n, heads, HEAD_DIM, device=dev,
                         generator=g).transpose(1, 2)
        got = A.qkv_attention_bwd_kernel(qkv, do, scale, heads)
        again = A.qkv_attention_bwd_kernel(qkv, do, scale, heads)
        want = A.attention_backward_reference(qkv, do, scale, heads)
        rel, err = rel_err(got, want), max_err(got, want)
        same = torch.equal(got, again)
        check("A′ fp32 attention bwd", rel <= ATTN_BWD_F32_TOL and same
              and torch.isfinite(got).all().item(),
              f"fp32 B={b} N={n} H={heads} d={HEAD_DIM}: dqkv rel to max "
              f"{rel:.3e} (tol {ATTN_BWD_F32_TOL:.0e}), max_abs_err "
              f"{err:.3e}; a second run bit-equal {same}")
        results["A′ fp32"]["errs"].append(err)
        if n == N_TOKENS:
            results["A′ fp32"]["cases"].append((qkv, do))


def check_attention_f32(dev, results):
    """K, K′, L and L′ in fp32 (``csrc/attention_f32.cu``) alone against
    their plain versions: K and K′ at N = 417, 577 (b16, the 384-px
    fine-tune; kept for the times) and 708, L and L′ at 709, 1025 (b32, 512
    px; kept) and 4097 (1024 px), 1 to 12 heads, dO as the output
    projection's backward hands it over; each run twice for the same bits,
    o and the lse finite. Then I/J in fp32 through their entry points
    (``multi_head_attention`` on I/I′, ``fused_attention_v2`` on J/J′, at
    b8 × 12 × 577 and through autograd) and ``attention_pallas`` at 1025
    tokens on L, each entry point's counters only."""
    import torch

    from gavit_tpu_torch.ops import attention as A

    scale = HEAD_DIM ** -0.5
    for b, n, h in F32_LONG_CASES:
        g = torch.Generator(device=dev).manual_seed(SEED + 91 + n)
        qkv = torch.randn(b, n, 3 * h * HEAD_DIM, device=dev, generator=g)
        do = torch.randn(b, n, h, HEAD_DIM, device=dev,
                         generator=g).transpose(1, 2)
        o, o2 = (A.qkv_attention_long_kernel(qkv, scale, h) for _ in range(2))
        got, again = (A.qkv_attention_long_bwd_kernel(qkv, do, scale, h)
                      for _ in range(2))
        want_o = A.attention_reference(*A._split_heads(qkv, h), scale)
        want = A.attention_backward_reference(qkv, do, scale, h)
        torch.cuda.synchronize()
        err, rel, gerr = (max_err(o, want_o), rel_err(got, want),
                          max_err(got, want))
        same = torch.equal(o, o2) and torch.equal(got, again)
        ident = torch.equal(got, want)
        finite = (torch.isfinite(o).all().item()
                  and torch.isfinite(got).all().item())
        del want_o, want, o2, again
        check("K and K′ fp32", finite and same and err <= ATTN_F32_TOL
              and rel <= ATTN_F32_TOL,
              f"fp32 B={b} N={n} H={h} d={HEAD_DIM}: o max_abs_err "
              f"{err:.3e}, dqkv rel to max {rel:.3e} (tol "
              f"{ATTN_F32_TOL:.0e}; max_abs_err {gerr:.3e}, bit-equal to "
              f"the plain version {ident}); a second run of each bit-equal "
              f"{same}")
        results["K fp32"]["errs"].append(err)
        results["K′ fp32"]["errs"].append(gerr)
        if n == N_384:
            results["K fp32"]["cases"].append(qkv)
            results["K′ fp32"]["cases"].append((qkv, do))
    for b, n, h in F32_LARGE_CASES:
        g = torch.Generator(device=dev).manual_seed(SEED + 93 + n)
        qkv = torch.randn(b, n, 3 * h * HEAD_DIM, device=dev, generator=g)
        do = torch.randn(b, n, h, HEAD_DIM, device=dev,
                         generator=g).transpose(1, 2)
        o, lse = A.qkv_attention_large_kernel(qkv, scale, h)
        o2, lse2 = A.qkv_attention_large_kernel(qkv, scale, h)
        got, again = (A.qkv_attention_large_bwd_kernel(qkv, o, lse, do,
                                                       scale, h)
                      for _ in range(2))
        want_o, want_lse = A.blockwise_attention_reference(qkv, scale, h)
        want = A.blockwise_attention_backward_reference(qkv, o, lse, do,
                                                        scale, h)
        torch.cuda.synchronize()
        err, lerr = max_err(o, want_o), max_err(lse, want_lse)
        rel, gerr = rel_err(got, want), max_err(got, want)
        same = (torch.equal(o, o2) and torch.equal(lse, lse2)
                and torch.equal(got, again))
        ident = torch.equal(got, want)
        finite = all(torch.isfinite(t).all().item() for t in (o, lse, got))
        del want_o, want_lse, want, o2, lse2, again
        check("L and L′ fp32", finite and same and err <= ATTN_F32_TOL
              and lerr <= ATTN_F32_TOL and rel <= ATTN_F32_TOL,
              f"fp32 B={b} N={n} H={h} d={HEAD_DIM}: o max_abs_err "
              f"{err:.3e}, lse max_abs_err {lerr:.3e}, dqkv rel to max "
              f"{rel:.3e} (tol {ATTN_F32_TOL:.0e}; max_abs_err "
              f"{gerr:.3e}, bit-equal to the plain version {ident}); o, lse "
              f"and dqkv finite {finite}; a second run of each bit-equal "
              f"{same}")
        results["L fp32"]["errs"].append(err)
        results["L′ fp32"]["errs"].append(gerr)
        if n == N_512:
            results["L fp32"]["cases"].append(qkv)
            results["L′ fp32"]["cases"].append((qkv, o, lse, do))
        torch.cuda.empty_cache()

    # the [B, H, N, d] entry points in fp32, forward and backward
    b, n, h = 8, N_384, HEADS
    g = torch.Generator(device=dev).manual_seed(SEED + 97)
    q, k, v, gout = (torch.randn(b, h, n, HEAD_DIM, device=dev, generator=g)
                     for _ in range(4))
    want = A.attention_reference(q, k, v, scale)
    dwant = A.attention_bhnd_backward_reference(q, k, v, gout, scale)
    for fn, entry in ((A.multi_head_attention, "I"),
                      (A.fused_attention_v2, "J")):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        torch.cuda.synchronize()
        reset_counts()
        out = fn(*leaves, scale)
        grads = torch.autograd.grad(out, leaves, gout)
        torch.cuda.synchronize()
        counts = read_counts()
        err = max_err(out, want)
        rel = max(rel_err(a, w) for a, w in zip(grads, dwant))
        check(f"{entry} and {entry}′ fp32 entry point",
              counts == expected({entry: 1, f"{entry}′": 1})
              and err <= ATTN_F32_TOL and rel <= ATTN_F32_TOL,
              f"{fn.__name__} fp32 B={b} H={h} N={n}: o max_abs_err "
              f"{err:.3e}, dq, dk, dv rel to max {rel:.3e} (tol "
              f"{ATTN_F32_TOL:.0e}); launches "
              + ", ".join(f"{key} {val}" for key, val in counts.items()
                          if val))
    n = N_512
    q, k, v = (torch.randn(1, h, n, HEAD_DIM, device=dev, generator=g)
               for _ in range(3))
    reset_counts()
    out = A.attention_pallas(q, k, v, scale)
    torch.cuda.synchronize()
    counts = read_counts()
    err = max_err(out, A.attention_reference(q, k, v, scale))
    check("attention_pallas fp32 on L", counts == expected({"L fp32": 1})
          and err <= ATTN_F32_TOL,
          f"fp32 B=1 H={h} N={n}: max_abs_err {err:.3e} (tol "
          f"{ATTN_F32_TOL:.0e}); L fp32 launched {counts['L fp32']}")


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
             dim=DIM, hidden=HIDDEN, dtype="bf16"):
    """The MoE expert MLP's inputs at the b128 training shapes: T = batch·n·2
    pairs routed by a seeded fp32 router over random tokens (``'router'``),
    all on expert 5 (``'hot'``), or never on experts 0 and 7 (``'empty'``);
    the tiled grouping at ``fused_tm(T)``; x_sorted gathered from the
    tokens (pad rows hold token 0); weights in ``dtype`` (the tokens are
    drawn in bf16 either way, so both dtypes route alike); dy zero on pad
    rows, as the combine's backward gives it."""
    import torch

    from gavit_tpu_torch.ops import moe_fused as MF

    g = torch.Generator(device=dev).manual_seed(SEED + 51)
    dt = getattr(torch, DTYPES[dtype])
    tokens, idx = routed_tokens(dev, g, routing, batch, n, dim)
    t = idx.numel()
    tm = MF.fused_tm(t, EXPERTS)
    _, src, used, tg, gs = MF.group_by_expert_tiled(idx, EXPERTS, tm)
    x = tokens[src // TOP_K].to(dt)
    w1, b1, w2, b2 = ((torch.randn(*shape, device=dev, generator=g) * 0.02)
                      .to(dt) for shape in ((EXPERTS, dim, hidden),
                                            (EXPERTS, hidden),
                                            (EXPERTS, hidden, dim),
                                            (EXPERTS, dim)))
    dy = (torch.randn(x.shape, device=dev, generator=g) * 0.01).to(dt) \
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
    tgmm_reference in the operands' dtype: within GRAD_REL_TOL of the
    largest value in bf16 (one fp32 sum rounded once, in another order),
    MOE_F32_TOL in fp32, finite, an empty expert's dW exactly zero, the
    same bits when run again."""
    import torch

    from gavit_tpu_torch.ops import gmm as GM

    f32 = a.dtype == torch.float32
    tol, key = (MOE_F32_TOL, "tgmm fp32") if f32 else (GRAD_REL_TOL, "tgmm")
    k = GM.tgmm_kernel(a, b, gs)
    again = GM.tgmm_kernel(a, b, gs)
    r = GM.tgmm_reference(a, b, gs, a.dtype)
    torch.cuda.synchronize()
    rel, same = rel_err(k, r), torch.equal(k, again)
    empty = gs == 0
    zeros = not k[empty].any().item()
    check(f"{key} grouped dW", rel <= tol and same and zeros
          and k.dtype == a.dtype and torch.isfinite(k).all().item(),
          f"{'fp32' if f32 else 'bf16'} {what} [{EXPERTS}, {a.shape[1]}, "
          f"{b.shape[1]}], groups {gs.tolist()}: rel to max {rel:.3e} (tol "
          f"{tol:.0e}), the same bits again {same}, empty experts "
          f"{empty.nonzero().flatten().tolist()} zero {zeros}; max_abs_err "
          f"{max_err(k, r):.3e}")
    results[key]["errs"].append(max_err(k, r))


def check_moe(dev, results):
    """M (erf with dropout 0.1, and tanh at rate 0), M′ and tgmm against
    their plain versions at the b128 routing, with a hot and an empty
    expert, and at b8 (T = 3152 pairs, where ``fused_tm`` gives tm = 32 and
    a 128-row tile straddles experts), in bf16 (``csrc/moe.cu``) and in
    fp32 (``csrc/moe_f32.cu``): the masks (zero patterns) bit-exact, h1
    within 1 ulp in bf16, y, dx, go and dh1 within the bf16 tolerance of D
    and D′ relative to the tensor's largest (MOE_F32_TOL in fp32, h1 and
    the bias gradients too), M's and M′'s reruns bit-equal, M′'s dh1 and
    dx zero on pad rows, dye bit-exact, db1 and db2 within BIAS_REL_TOL in
    bf16, dW1 and dW2 (rounded to bf16 once from fp32 sums) within
    GRAD_REL_TOL. The masks: y and dye hold the output mask and go the
    hidden one exactly (``mask_applied`` against ``ops/philox.py``'s
    bits)."""
    import torch

    from gavit_tpu_torch.ops import moe_fused as MF
    from gavit_tpu_torch.ops import philox

    seed, sites = philox.step_seed(SEED, 6), (5, 6)
    f = HIDDEN
    for dtype, routing, batch in itertools.product(
            ("bf16", "fp32"), ("router", "hot", "empty", "router 8"),
            (TRAIN_BATCH,)):
        if routing == "router 8":
            routing, batch = "router", 8
        f32 = dtype == "fp32"
        sfx = " fp32" if f32 else ""
        tol, bias_tol = ((MOE_F32_TOL, MOE_F32_TOL) if f32
                         else (GRAD_REL_TOL, BIAS_REL_TOL))
        c = moe_case(dev, routing, batch, dtype=dtype)
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
            ry = rel_err(y, y_ref)
            if f32:
                uh = rel_err(h1, h1_ref)
                h1_ok, h1_how = uh <= tol, f"h1 rel to max {uh:.3e}"
            else:
                uh = ulps(h1, h1_ref)
                h1_ok, h1_how = uh <= 1, f"h1 within {uh:.0f} ulp (tol 1)"
            err = max(max_err(y, y_ref), max_err(h1, h1_ref))
            check(f"M{sfx} moe expert mlp fwd", masked and h1_ok and same
                  and ry <= tol and y.dtype == x.dtype
                  and torch.isfinite(y).all().item(),
                  f"{dtype} {routing} b{batch} T={c['t']} cap={cap} tm={tm} "
                  f"{'tanh' if approx else 'erf'} rate {rate}: y holds the "
                  f"output mask exactly {masked} ({how}), {h1_how}, y rel "
                  f"to max {ry:.3e} (tol {tol:.0e}), a second run "
                  f"bit-equal {same}; max_abs_err {err:.3e}")
            results[f"M{sfx}"]["errs"].append(err)
            if routing == "router" and batch == TRAIN_BATCH and not approx:
                results[f"M{sfx}"]["cases"].append(c)
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
        ok = (all(rels[n] <= tol for n in ("dx", "go", "dh1"))
              and all(rels[n] <= bias_tol for n in ("db1", "db2"))
              and torch.equal(got[5], want[5]) and pads and masked and same
              and all(torch.isfinite(a).all().item() for a in got))
        err = max(max_err(a, b) for a, b in zip(got, want))
        check(f"M′{sfx} moe expert mlp bwd", ok,
              f"{dtype} {routing} b{batch} tm={tm} rate {DROP_RATE}: rel to "
              f"max " + ", ".join(
                  f"{n} {v:.3e}" for n, v in rels.items())
              + f" (tol {tol:.0e}; db1, db2 {bias_tol:.0e}); "
              f"dye bit-exact {torch.equal(got[5], want[5])}, go holds the "
              f"hidden mask exactly {masked} ({how}), dh1 and dx zero on "
              f"pad rows {pads}, a second run bit-equal {same}; max_abs_err "
              f"{err:.3e}")
        results[f"M′{sfx}"]["errs"].append(err)
        _, go, dh1, _, _, dye = got
        for what, a, b in (("dW1", x, dh1), ("dW2", go, dye)):
            check_tgmm(results, f"{routing} {what} over the {cap} cap-padded "
                       f"rows", a, b, c["gs"])
        if routing == "router" and batch == TRAIN_BATCH:
            results[f"M′{sfx}"]["cases"].append((dy, h1_ref, go, dh1, dye))
        del c, got, want, x, y, h1, y_ref, h1_ref, dy, go, dh1, dye
        torch.cuda.empty_cache()


def gmm_case(dev, routing="router", batch=TRAIN_BATCH, n=N_TOKENS, dim=DIM,
             hidden=HIDDEN, dtype="bf16"):
    """Kernel N-gmm's inputs as the unfused engine gives them: the pairs of
    ``batch`` images routed as in ``moe_case`` (T = batch·n·2), grouped by
    expert with no padding (``group_by_expert``), x the pairs' token rows
    [T, D], W1 [E, D, F] and W2 [E, F, D] in ``dtype``, the group sizes on
    the card; random h [T, F] (fc2's input), dh [T, F] (fc1's dx = dh·W1ᵀ)
    and dy [T, D] (fc2's dh = dy·W2ᵀ)."""
    import torch

    from gavit_tpu_torch.ops import moe_grouped as MG

    g = torch.Generator(device=dev).manual_seed(SEED + 52)
    dt = getattr(torch, DTYPES[dtype])
    tokens, idx = routed_tokens(dev, g, routing, batch, n, dim)
    _, src, sizes = MG.group_by_expert(idx, EXPERTS)
    t = src.numel()

    def draw(*shape, scale):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(dt)

    w1 = draw(EXPERTS, dim, hidden, scale=0.02)
    dh = draw(t, hidden, scale=0.01)
    w2 = draw(EXPERTS, hidden, dim, scale=0.02)
    h = draw(t, hidden, scale=0.5)
    dy = draw(t, dim, scale=0.01)
    return dict(x=tokens[src // TOP_K].to(dt), w1=w1, w2=w2, h=h, dh=dh,
                dy=dy, gs=sizes, t=t, routing=routing)


def check_gmm(dev, results):
    """N-gmm in both forms at each of the unfused engine's four GEMMs (fc1
    x·W1 and its dx dh·W1ᵀ, fc2 h·W2 and its dh dy·W2ᵀ) against its plain
    version at the b128 routing, with a hot and an empty expert, and at
    b127 (T = 50038, no multiple of the 128-row tile), in bf16 and in fp32:
    within GRAD_REL_TOL of the largest value in bf16 (bf16 outputs of fp32
    sums taken in another order), MOE_F32_TOL in fp32, the same bits when
    run again; tgmm's two dW on the same packed rows (``check_tgmm``); and
    the differentiable op, forward and both gradients, on the b127 rows as
    they are, in each dtype."""
    import torch

    from gavit_tpu_torch.ops import gmm as GM

    for dtype, (routing, batch) in itertools.product(
            ("bf16", "fp32"), (("router", TRAIN_BATCH), ("hot", TRAIN_BATCH),
                               ("empty", TRAIN_BATCH),
                               ("router", TRAIN_BATCH - 1))):
        f32 = dtype == "fp32"
        key, tol = ("N-gmm fp32", MOE_F32_TOL) if f32 else ("N-gmm",
                                                           GRAD_REL_TOL)
        c = gmm_case(dev, routing, batch, dtype=dtype)
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
            check(f"{key} {form}", rel <= tol and same
                  and got.dtype == a.dtype
                  and torch.isfinite(got).all().item(),
                  f"{dtype} {routing} T={c['t']} groups {gs.tolist()} "
                  f"[{a.shape[1]}] x {list(w.shape)}{'ᵀ' if tr else ''} → "
                  f"{list(got.shape)}: rel to max {rel:.3e} (tol "
                  f"{tol:.0e}), the same bits again {same}; "
                  f"max_abs_err {err:.3e}")
            results[key]["errs"].append(err)
        # tgmm on the same packed rows, as the unfused engine's backward
        # takes them: dW1 = xᵀ·dh and dW2 = hᵀ·dy
        for what, a, b in (("dW1", c["x"], c["dh"]), ("dW2", c["h"], c["dy"])):
            check_tgmm(results, f"{routing} {what} over the T={c['t']} packed "
                       f"rows", a, b, gs)
        if routing == "router" and batch == TRAIN_BATCH:  # for the times
            results[key]["cases"].append(
                {k: c[k] for k in ("x", "w1", "h", "dh", "dy", "gs", "t")})
        if batch != TRAIN_BATCH - 1:
            continue
        x, w1, dh = c["x"], c["w1"], c["dh"]
        got, refs = {}, {}
        for impl, out in (("auto", got), ("reference", refs)):
            xi, wi = (a.detach().clone().requires_grad_(True)
                      for a in (x, w1))
            y = GM.ragged_matmul(xi, wi, gs, impl=impl)
            y.backward(dh)
            out.update(y=y.detach(), dx=xi.grad, dw=wi.grad)
        rels = {k: rel_err(got[k], refs[k]) for k in got}
        check(f"{key} op", got["y"].shape == (c["t"], HIDDEN)
              and max(rels.values()) <= tol,
              f"{dtype} ragged_matmul on T={c['t']} rows (no multiple of the "
              f"tile, not padded) against impl='reference': rel to max "
              + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
              + f" (tol {tol:.0e})")


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


class PinnedCodes:
    """The int8 counterpart of :class:`PinnedRouting`: records the input of
    every quantised site of ``auto`` (the kernels' model) at each of its
    calls and, in the same calls of ``plain`` (the plain versions' model,
    on the same scales), compares its own input there with the recorded one
    in codes, units of the site's act scale, each clipped to ±127.

    Rounding to int8 is discontinuous: a bf16 rounding the kernels place
    otherwise moves a code, and a moved code moves everything after it
    (the CPU tests count 6% of codes between the port and the JAX
    package). So where the codes differ and the inputs lie within the
    bound's distance (``PIN_BOUNDS``), the plain forward takes the
    recorded value (the gradient still flows through its own input), and
    the comparison after it holds the arithmetic. A kNN neighbour set decided
    by a near-tie may go either way between the kernel's similarities and
    the plain version's, and changes that token's row of the graph
    projection's input outright: such rows are taken whole and counted, as
    :class:`PinnedRouting` takes expert choices. Any other input farther
    away is left as it is and fails :meth:`check`.

    Every kernel of the quantised paths writes into a quantised site (A
    into the attention projection, C into the graph projection, H into fc2,
    F into the residual that qkv, fc1 or the head reads next), so
    :meth:`check` holds each kernel's output to the plain version's at the
    scale the model quantises it to: a wrong kernel moves inputs by more
    than a rounding, or moves more codes or rows than rounding does."""

    def __init__(self, auto, plain):
        from gavit_tpu_torch.utils.convert import quant_sites

        self.hooks = [mod.register_forward_pre_hook(
            functools.partial(self.record, path))
            for path, mod in quant_sites(auto).items()]
        self.hooks += [mod.register_forward_pre_hook(
            functools.partial(self.replay, path))
            for path, mod in quant_sites(plain).items()]
        self.recorded, self.i = {}, {}
        # per replayed forward: {path: [codes taken, codes, far, kNN rows
        # taken, rows, largest distance in codes]}
        self.sites, self.bounds = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()

    def start_record(self):
        self.recorded = {}

    def start_replay(self, bounds=PIN_BOUNDS):
        """The next forward of ``plain`` replays, held to ``bounds``
        (``PIN_BOUNDS``' layout)."""
        self.i = {}
        self.sites.append({})
        self.bounds.append(bounds)

    def record(self, path, mod, args):
        self.recorded.setdefault(path, []).append(args[0].detach().clone())

    def replay(self, path, mod, args):
        import torch

        i = self.i[path] = self.i.get(path, -1) + 1
        x, want = args[0], self.recorded[path][i]

        def codes(v):
            return torch.clamp(v.detach().float() / mod.act_scale, -127, 127)
        u, v = codes(x), codes(want)
        gap = (u - v).abs()
        far = gap > self.bounds[-1][0]
        take = (torch.round(u) != torch.round(v)) & ~far
        rows = torch.zeros_like(far[..., :0])
        if path.startswith("graph_") and path.endswith("/proj"):
            rows = far.any(-1, keepdim=True)
            take, far = take | rows, far & ~rows
            gap = gap.masked_fill(rows, 0.0)
        site = self.sites[-1].setdefault(path, [0, 0, 0, 0, 0, 0.0])
        for j, n in enumerate((take.sum(), take.numel(), far.sum(),
                               rows.sum(), rows.numel())):
            site[j] += int(n)
        site[5] = max(site[5], float(gap.max()))
        # the recorded value exactly, the gradient through x
        return (torch.where(take, want + (x - x.detach()), x),)

    def check(self, i):
        """``(ok, text)`` of the ``i``-th replayed forward against its
        bounds: no input farther from the kernels' than the bound outside
        the kNN rows taken, and at most the bounds' shares of the graph
        projections' rows and of all codes taken."""
        sites, (gap_tol, row_frac, code_frac) = self.sites[i], self.bounds[i]
        taken, codes, far, rows, n_rows = (
            sum(s[j] for s in sites.values()) for j in range(5))
        gap = max(s[5] for s in sites.values())
        knn = [p for p, s in sites.items() if s[3]]
        ok = (far == 0 and rows <= row_frac * n_rows
              and taken <= code_frac * codes)
        return ok, (
            f"{taken} of {codes} int8 codes taken from the kernels' inputs "
            f"(at most {code_frac:.0e}), {rows} of {n_rows} graph-projection "
            f"rows among them (a kNN set on a near-tie; at most "
            f"{row_frac:.0e}{': ' + ', '.join(knn) if knn else ''}); "
            f"inputs elsewhere at most {gap:.3f} codes apart, {far} past "
            f"{gap_tol}")


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
            "A′ fp32": ("attention", "BWD_F32_KERNEL_LAUNCHES"),
            "B": ("mlp", "KERNEL_LAUNCHES"),
            "C": ("graph_ops", "KERNEL_LAUNCHES"),
            "D": ("mlp", "TRAIN_FWD_LAUNCHES"),
            "D′": ("mlp", "TRAIN_BWD_LAUNCHES"),
            "F": ("dropout", "KERNEL_LAUNCHES"),
            "K": ("attention", "LONG_KERNEL_LAUNCHES"),
            "K′": ("attention", "LONG_BWD_KERNEL_LAUNCHES"),
            "L": ("attention", "LARGE_KERNEL_LAUNCHES"),
            "L′": ("attention", "LARGE_BWD_KERNEL_LAUNCHES"),
            "K fp32": ("attention", "LONG_F32_KERNEL_LAUNCHES"),
            "K′ fp32": ("attention", "LONG_BWD_F32_KERNEL_LAUNCHES"),
            "L fp32": ("attention", "LARGE_F32_KERNEL_LAUNCHES"),
            "L′ fp32": ("attention", "LARGE_BWD_F32_KERNEL_LAUNCHES"),
            "H": ("dropout", "GELU_LAUNCHES"),
            "H′": ("dropout", "GELU_BWD_LAUNCHES"),
            "M": ("moe_fused", "KERNEL_LAUNCHES"),
            "M′": ("moe_fused", "BWD_KERNEL_LAUNCHES"),
            "tgmm": ("gmm", "TGMM_LAUNCHES"),
            "N-gmm": ("gmm", "KERNEL_LAUNCHES"),
            "M fp32": ("moe_fused", "F32_KERNEL_LAUNCHES"),
            "M′ fp32": ("moe_fused", "BWD_F32_KERNEL_LAUNCHES"),
            "tgmm fp32": ("gmm", "F32_TGMM_LAUNCHES"),
            "N-gmm fp32": ("gmm", "F32_KERNEL_LAUNCHES"),
            "I": ("attention", "V1_KERNEL_LAUNCHES"),
            "I′": ("attention", "V1_BWD_KERNEL_LAUNCHES"),
            "J": ("attention", "V2_KERNEL_LAUNCHES"),
            "J′": ("attention", "V2_BWD_KERNEL_LAUNCHES"),
            "G": ("dropout", "ADD_LAUNCHES"),
            "E": ("mlp", "MASK_LAUNCHES")}


def expected(nonzero: dict) -> dict:
    """Every counter at 0 but those named."""
    return {k: nonzero.get(k, 0) for k in COUNTERS}


def expected_quant(nonzero: dict) -> dict:
    """:func:`expected` and the int8 GEMM's calls (``int8``), which no
    kernel row carries: the JAX package leaves that GEMM to XLA."""
    return {**expected(nonzero), "int8": nonzero.get("int8", 0)}


def reset_counts():
    import importlib

    for mod, attr in COUNTERS.values():
        setattr(importlib.import_module(f"gavit_tpu_torch.ops.{mod}"), attr, 0)


def read_counts():
    import importlib

    return {k: getattr(importlib.import_module(f"gavit_tpu_torch.ops.{mod}"),
                       attr) for k, (mod, attr) in COUNTERS.items()}


def phase_serve(cfg, weights, dev):
    """The 224-px server as ``scripts/serve_torch.py`` starts it: the
    Predictor's warm-up (each bucket's eager run and its capture, where the
    wrappers launch: the counters, zeroed just before), then 4 requests
    answered by replays, which run no wrapper: a ``torch.profiler`` trace
    of them must show the port's kernels that the eager path runs on the
    same images. Returns the Predictor, its plain-version twin and the
    counts of the run."""
    import numpy as np
    import torch
    from PIL import Image

    sys.path.insert(0, str(ROOT / "scripts"))
    import serve_torch
    from gavit_tpu_torch.serving import Predictor

    predictor = Predictor(cfg, weights, precision="bf16", device=dev)
    reference = Predictor(cfg, weights, precision="bf16", device=dev,
                          impl="reference")
    reference.warmup()
    s = cfg.data.image_size
    server = serve_torch.GavitHTTPServer(
        ("127.0.0.1", 0),
        serve_torch.build_handler(predictor, s, serve_torch.model_desc(cfg)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
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

    one = rng.integers(0, 256, (s, s, 3), np.uint8)
    png = rng.integers(0, 256, (s, s, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(png).save(buf, format="PNG")
    sent = [("1 image as JSON", one, json.dumps(one.tolist()).encode(),
             "application/json"),
            ("1 PNG", png, buf.getvalue(), "image/png")]
    for n in (8, 64):
        batch = rng.integers(0, 256, (n, s, s, 3), np.uint8)
        sent.append((f"batch of {n} as JSON", batch,
                     json.dumps(batch.tolist()).encode(), "application/json"))
    answers = []

    def serve_all():
        health = request("/healthz")
        log(f"[serve] GET /healthz: 200 {health}")
        for _, _, body, ctype in sent:
            answers.append(np.asarray(
                request("/predict", body, ctype)["probabilities"], np.float32))
        log(f"[serve] GET /stats: 200 {request('/stats')}")

    try:
        torch.cuda.synchronize()
        reset_counts()
        predictor.warmup()
        thread.start()
        _, moved, replayed = traced(serve_all)
        counts = read_counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    for (name, images, _, _), probs in zip(sent, answers):
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
    _, _, eager = traced(lambda: [predictor._predict_proba_eager(x)
                                  for _, x, _, _ in sent])
    nb = len(predictor.buckets)
    depth, n_graph = cfg.model.depth, len(set(cfg.model.graph_insert_after()))
    # per bucket one eager run and one capture; the requests, replays only
    expect = expected({"A": 2 * depth * nb, "B": 2 * depth * nb,
                       "C": 2 * n_graph * nb})
    ok = (counts == expect and not moved and bool(replayed)
          and replayed == eager)
    log(f"[serve] kernel launches of the warm-up over {nb} buckets: "
        + ", ".join(f"{k} {v}" for k, v in counts.items())
        + f"; the 4 requests moved {'no counter' if not moved else moved}; "
        f"the device ran {sum(replayed.values())} launches of the port's "
        f"kernels in them ({kernel_list(replayed)}), the eager path on the "
        f"same images {'the same' if replayed == eager else kernel_list(eager)}"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"launch counts {counts}, expected {expect}; "
                             f"requests moved {moved}; replays ran "
                             f"{replayed}, the eager path {eager}")
    return predictor, reference, counts


# (K, N) of every int8 GEMM of vit_b16_graph2: the patch projection and
# the graph blocks' value and projection (768, 768) on b·196 rows, qkv
# (768, 2304), the attention projection (768, 768), fc1 (768, 3072) and fc2
# (3072, 768) on b·197, the head (768, 14) on b
INT8_SITES = ((768, 768), (768, 2304), (768, 3072), (3072, 768), (768, 14))
SERVE_QUANT_BUCKETS = (1, 8, 64)
TOME_R = 8
SERVE_DIR = ROOT / "build" / "chip_serve"


def check_int8_gemm(dev):
    """The int8 GEMM (cuBLASLt through ``torch._int_mm``, zero-padded where
    it refuses a shape) at every site's shape at b1, b8 and b64 against the
    plain float64 sum, bit for bit, and the static product's fp32 output
    bit for bit."""
    import torch

    from gavit_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = 0
    for k, n in INT8_SITES:
        w_q = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                            dtype=torch.int8)
        w_scale = torch.rand(1, n, device=dev, generator=g) * 1e-3
        for b in SERVE_QUANT_BUCKETS:
            for m in ([b] if n == 14 else [b * N_TOKENS, b * (N_TOKENS - 1)]):
                xq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                                   dtype=torch.int8)
                same = torch.equal(Q.int8_mm(xq, w_q),
                                   Q.int8_mm_reference(xq, w_q))
                x = torch.randn(m, k, device=dev, generator=g).to(
                    torch.bfloat16)
                s = torch.tensor(0.02, device=dev)
                same = same and torch.equal(
                    Q.static_int8_matmul(x, w_q, w_scale, s),
                    Q.static_int8_matmul(x, w_q, w_scale, s,
                                         impl="reference"))
                torch.cuda.synchronize()
                if not same:
                    raise AssertionError(f"int8 GEMM M={m} K={k} N={n}: "
                                         "not bit-equal to the plain sum")
                cases += 1
    log(f"[serve_quant] int8 GEMM at {cases} shapes (every site, b1/b8/b64, "
        f"the head's N = 14 and M ≤ 16 padded): int32 sums and static "
        f"products bit-equal to the plain versions ok")


def phase_quant_times(dev, card, batch: int = 64):
    """At the b64 serving shapes, each alone on the device (20 launches
    between two events): the int8 GEMM of each site (cuBLASLt through
    ``torch._int_mm``; the JAX package leaves it to XLA, so it is a
    library row) against the same product in bf16 (``F.linear``) and its
    bound, and one whole static-int8 site (quantise, GEMM, rescale, cast,
    bias) against the bf16 ``F.linear`` with its bias; then kernels A, B
    and C at the token counts ToMe at r = 8 leaves (A and B at N = 197,
    149, 109: the first, seventh and last block; C at 196 patches and at
    the graph blocks' 164 and 132), each beside its bound."""
    import torch
    import torch.nn.functional as F

    from gavit_tpu_torch.ops import attention as A
    from gavit_tpu_torch.ops import graph_ops as G
    from gavit_tpu_torch.ops import mlp as M
    from gavit_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    bf = torch.bfloat16
    total = {"int8": 0.0, "bf16": 0.0, "bound": 0.0}
    # (K, N, rows, calls a forward) of every site at b64
    rows_b, rows_p = batch * N_TOKENS, batch * (N_TOKENS - 1)
    sites = ((768, 768, rows_p, 5), (768, 2304, rows_b, 12),
             (768, 768, rows_b, 12), (768, 3072, rows_b, 12),
             (3072, 768, rows_b, 12), (768, 14, batch, 1))
    for k, n, m, calls in sites:
        xq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                           dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                            dtype=torch.int8)
        x = torch.randn(m, k, device=dev, generator=g).to(bf)
        w = torch.randn(n, k, device=dev, generator=g).to(bf)
        ki = device_ms(lambda: Q.int8_mm(xq, w_q))
        kb = device_ms(lambda: F.linear(x, w))
        bms, by = bound(2 * m * k * n, m * k + k * n + 4 * m * n,
                        PEAK_INT8_OPS)
        for key, val in (("int8", ki), ("bf16", kb), ("bound", bms)):
            total[key] += calls * val
        log(f"[time] int8 GEMM (cuBLASLt, torch._int_mm) M={m} K={k} N={n} "
            f"alone: {ki:.4f} ms, bf16 F.linear {kb:.4f} ms, bound "
            f"{bms:.4f} ms "
            f"({by}, int8 at {PEAK_INT8_OPS / 1e12:.0f} TOP/s, int32 out) "
            f"({card})")
    log(f"[time] int8 GEMMs of one b{batch} forward (54 calls): "
        f"{total['int8']:.4f} ms against bf16 {total['bf16']:.4f} ms, bound "
        f"{total['bound']:.4f} ms ({card})")
    # one whole fc1 site: the quantise pass, the GEMM, the rescale, the
    # cast and the bias, against bf16 F.linear with its bias
    x = torch.randn(rows_b, DIM, device=dev, generator=g).to(bf)
    w_q = torch.randint(-127, 128, (HIDDEN, DIM), device=dev, generator=g,
                        dtype=torch.int8)
    w_scale = torch.rand(1, HIDDEN, device=dev, generator=g) * 1e-3
    bias = torch.randn(HIDDEN, device=dev, generator=g).to(bf)
    s = torch.tensor(0.02, device=dev)
    w = torch.randn(HIDDEN, DIM, device=dev, generator=g).to(bf)
    site = device_ms(lambda: Q.static_int8_matmul(x, w_q, w_scale, s)
                     .to(bf) + bias)
    lin = device_ms(lambda: F.linear(x, w, bias))
    log(f"[time] one static-int8 fc1 site at M={rows_b} (quantise, GEMM, "
        f"rescale, cast, bias) alone: {site:.4f} ms, bf16 F.linear with its "
        f"bias {lin:.4f} ms ({card})")

    # ToMe's shapes
    scale = HEAD_DIM ** -0.5
    for n in (N_TOKENS, N_TOKENS - 6 * TOME_R, N_TOKENS - 11 * TOME_R):
        qkv = torch.randn(batch, n, 3 * DIM, device=dev, generator=g).to(bf)
        ka = device_ms(lambda: A.qkv_attention_kernel(qkv, scale, HEADS))
        ams, aby = bound(4 * batch * HEADS * n * n * HEAD_DIM,
                         4 * batch * n * DIM * 2)
        m = batch * n
        args = (torch.randn(m, DIM, device=dev, generator=g).to(bf),
                *(t.to(bf) for t in (
                    torch.randn(HIDDEN, DIM, device=dev, generator=g) * 0.02,
                    torch.zeros(HIDDEN, device=dev),
                    torch.randn(DIM, HIDDEN, device=dev, generator=g) * 0.02,
                    torch.zeros(DIM, device=dev))))
        kb = device_ms(lambda: M.mlp_inference_kernel(*args, True))
        bms, bby = bound(4 * m * DIM * HIDDEN,
                         (2 * m * DIM + 2 * DIM * HIDDEN + HIDDEN + DIM) * 2)
        log(f"[time] ToMe r={TOME_R} shapes at b{batch} N={n}, alone: A "
            f"{ka:.4f} ms "
            f"(bound {ams:.4f}, {aby}), B at M={m} {kb:.4f} ms (bound "
            f"{bms:.4f}, {bby}) ({card})")
    for n in (N_TOKENS - 1, N_TOKENS - 4 * TOME_R - 1,
              N_TOKENS - 8 * TOME_R - 1):
        t, v = (torch.randn(batch, n, DIM, device=dev, generator=g).to(bf)
                for _ in range(2))
        kc = device_ms(lambda: G.graph_aggregate_kernel(t, v, "knn", 8, 0.0,
                                                        1.0))
        cms, cby = bound(4 * batch * n * n * DIM, 3 * batch * n * DIM * 2)
        log(f"[time] ToMe r={TOME_R} shapes at b{batch}, alone: C knn at {n} "
            f"patches "
            f"{kc:.4f} ms (bound {cms:.4f}, {cby}) ({card})")


def imgs_per_s(predictor, n: int = 64, calls: int = 10) -> float:
    """Images/s of ``predict_proba`` on ``n`` images, median of ``calls``."""
    import numpy as np

    s = predictor.image_size
    imgs = np.random.default_rng(SEED + 6).integers(0, 256, (n, s, s, 3),
                                                    np.uint8)
    for _ in range(3):
        predictor.predict_proba(imgs)
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        predictor.predict_proba(imgs)
        times.append(time.perf_counter() - t0)
    return n / statistics.median(times)


def phase_serve_quant(cfg, weights, dev, card):
    """int8 and ToMe serving of vit_b16_graph2 at 224 px: the int8
    ``Predictor`` calibrated on 8 images, warmed over buckets 1/8/64 (its
    launches counted: each bucket's eager run and its capture), against
    the same Predictor on the plain versions under the same scales and
    against the bf16 one; ToMe at r = 8 in bf16 and int8 against the plain
    versions; each held on the eager paths, with the launches of one b64
    forward there, and its replay bit-equal to its eager path;
    ``tome_forward`` at r = 0 bit-equal to the model; the b1 p50 and b64
    images/s of bf16, int8 and ToMe r = 8."""
    import numpy as np
    import torch

    from gavit_tpu_torch.models.tome import tome_forward
    from gavit_tpu_torch.ops import quant as Q
    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.serving import Predictor
    from gavit_tpu_torch.utils.convert import quant_state

    check_int8_gemm(dev)
    depth = cfg.model.depth
    n_graph = len(set(cfg.model.graph_insert_after()))
    sites = 2 + 4 * depth + 2 * n_graph  # int8 GEMMs a forward
    s = cfg.data.image_size
    rng = np.random.default_rng(SEED + 3)
    calib = rng.integers(0, 256, (8, s, s, 3), np.uint8)
    imgs = rng.integers(0, 256, (64, s, s, 3), np.uint8)

    def make(precision, impl="auto", tome_r=0):
        return Predictor(cfg, weights, precision=precision, device=dev,
                         buckets=SERVE_QUANT_BUCKETS, impl=impl,
                         tome_r=tome_r)

    def counted(fn):
        torch.cuda.synchronize()
        reset_counts()
        Q.INT8_MM_LAUNCHES = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {**read_counts(), "int8": Q.INT8_MM_LAUNCHES}

    def held(name, pred, plain, expect):
        """``pred``'s b64 probabilities against the plain-version
        ``plain``'s, both on their eager paths (where the wrappers run and
        count, and the pins, forward hooks, run too), int8 ones on the
        kernels' codes; ``pred``'s replay bit-equal to its eager path."""
        int8 = pred.model.quant == "int8"
        pin = (PinnedCodes(pred.model, plain.model) if int8
               else contextlib.nullcontext())
        with pin:
            if int8:
                pin.start_record()
            got, counts = counted(lambda: pred._predict_proba_eager(imgs))
            if int8:
                pin.start_replay()
            want = plain._predict_proba_eager(imgs)
        if not np.array_equal(got, pred.predict_proba(imgs)):
            raise AssertionError(f"{name}: the captured replay differs from "
                                 "the eager kernel path")
        err = float(np.abs(got - want).max())
        want_counts = expected_quant(expect)
        ok = (np.isfinite(got).all() and err <= PROB_TOL
              and counts == want_counts)
        pinned = ""
        if int8:
            pin_ok, text = pin.check(0)
            ok = ok and pin_ok
            pinned = f", the plain forward on the kernels' codes: {text}"
        log(f"[serve_quant] {name}: max |dp| vs the plain versions "
            f"{err:.3e} (tol {PROB_TOL:.0e}){pinned}; launches of one "
            f"forward " + ", ".join(f"{k} {v}" for k, v in counts.items()
                                   if v)
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: {err}, launches {counts} "
                                 f"(expected {want_counts}){pinned}")
        return got

    int8 = make("int8")
    int8.calibrate(calib)
    state = quant_state(int8.model)
    nb = len(SERVE_QUANT_BUCKETS)
    _, counts = counted(int8.warmup)
    # each bucket's eager run and its capture
    want = {"A": 2 * depth * nb, "C": 2 * n_graph * nb,
            "int8": 2 * sites * nb}
    held_counts = expected_quant(want)
    log(f"[serve_quant] int8 Predictor calibrated on 8 images, warm-up over "
        f"buckets {SERVE_QUANT_BUCKETS}: launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        + f" {'ok' if counts == held_counts else 'FAIL'}")
    if counts != held_counts:
        raise AssertionError(f"int8 warm-up launches {counts}, expected "
                             f"{held_counts}")
    ref = make("int8", "reference")
    ref.use_quant_state(state)
    bf16 = make("bf16")
    got = held("int8 Predictor b64", int8, ref,
               {"A": depth, "C": n_graph, "int8": sites})
    rerun = int8.predict_proba(imgs)
    dev_bf16 = float(np.abs(got - bf16.predict_proba(imgs)).max())
    log(f"[serve_quant] int8 rerun bit-equal "
        f"{'ok' if np.array_equal(rerun, got) else 'FAIL'}; int8 vs bf16 "
        f"Predictor max |dp| {dev_bf16:.4f} (recorded)")
    if not np.array_equal(rerun, got):
        raise AssertionError("the int8 Predictor's rerun differs")
    del ref

    # ToMe at r = 8: blocks at 197, 189, ..., 109 tokens
    x = val_preprocess(torch.from_numpy(imgs[:8]).to(dev))
    with torch.inference_mode():
        same = torch.equal(tome_forward(bf16.model, x, 0), bf16.model(x))
    log(f"[serve_quant] tome_forward r=0 bit-equal to the model "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("tome_forward at r=0 differs from the model")
    tome = make("bf16", tome_r=TOME_R)
    tome.warmup()
    held(f"ToMe r={TOME_R} bf16 b64", tome, make("bf16", "reference", TOME_R),
         {"A": depth, "B": depth, "C": n_graph})
    tome8 = make("int8", tome_r=TOME_R)
    tome8.use_quant_state(state)
    tome8.warmup()
    tref = make("int8", "reference", TOME_R)
    tref.use_quant_state(state)
    held(f"ToMe r={TOME_R} int8 b64", tome8, tref,
         {"A": depth, "C": n_graph, "int8": sites})
    del tref
    phase_quant_times(dev, card)
    for name, pred in (("bf16", bf16), ("int8", int8),
                       (f"ToMe r={TOME_R} bf16", tome),
                       (f"ToMe r={TOME_R} int8", tome8)):
        log(f"[time] Predictor {name} at {s} px: b1 p50 "
            f"{p50_ms(pred):.3f} ms over 50 calls, b64 "
            f"{imgs_per_s(pred):.1f} images/s ({card})")


class EagerPath:
    """A predictor's private eager path behind ``predict_proba`` (the
    yardstick of its captured graphs), for the timers that take a
    predictor."""

    def __init__(self, predictor):
        self.image_size = predictor.image_size
        self.predict_proba = predictor._predict_proba_eager


def launches_of(fn):
    """``fn()``'s result and every launch counter it moved (the kernels'
    and the int8 GEMM's), read after a synchronise."""
    import torch

    from gavit_tpu_torch.ops import _build

    torch.cuda.synchronize()
    before = _build.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = _build.launch_counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def by_kernel(moved) -> dict:
    """:func:`launches_of`'s counters by kernel row (every row of
    ``COUNTERS``)."""
    return {k: moved.get(key, 0) for k, key in COUNTERS.items()}


# the port's kernels (gavit_tpu_torch/csrc), each in an anonymous namespace
# of its file, by the heads of their names; a few of PyTorch's kernels sit
# in an anonymous namespace too
PORT_KERNEL = re.compile(
    r"^(void )?\(anonymous namespace\)::(attn_|gemm90::|graph_|moe_|"
    r"colsum_reduce|bwd_prologue|keep_mask_kernel|elementwise_kernel<)")


def traced(fn):
    """``fn()``'s result, the launch counters it moved (:func:`launches_of`)
    and the port's kernels that ran on the device, ``{name: launches}``,
    from a ``torch.profiler`` trace: a replayed CUDA graph runs no wrapper
    and moves no counter, but its kernels show in the trace. Nothing may
    be captured inside ``fn``."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, moved = launches_of(fn)
        torch.cuda.synchronize()
    kernels = Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and PORT_KERNEL.match(e.key):
            kernels[e.key] += e.count
    return out, moved, dict(kernels)


def kernel_list(kernels: dict) -> str:
    """``{name: launches}`` as short names (the demangled name up to its
    template or argument list) with their launches."""
    short = {}
    for name, n in kernels.items():
        key = name.replace("(anonymous namespace)::", "")
        key = key.removeprefix("void ").split("(")[0][:70]
        short[key] = short.get(key, 0) + n
    return ", ".join(f"{k} {n}" for k, n in sorted(short.items()))


def idle_share(predictor, calls: int = 20):
    """The device's idle share of the wall time over ``calls`` one-image
    requests under ``torch.profiler`` (1 - busy / wall; device-side events
    only), and the device time a request: ``(idle, busy_ms)``."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s = predictor.image_size
    img = np.random.default_rng(SEED + 8).integers(0, 256, (s, s, 3),
                                                   np.uint8)
    predictor.predict_proba(img)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            predictor.predict_proba(img)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith(("Command Buffer", "Activity")))
    busy_ms /= 1000
    return 1 - busy_ms / wall_ms, busy_ms / calls


SERVE_GRAPH_BUCKETS = (1, 64)


def phase_serve_graphs(cfg, weights, dev, card):
    """The captured serve path at 224 px: bf16, int8 (calibrated on 8
    images) and ToMe r = 8 bf16 Predictors over buckets 1 and 64, each
    bucket one CUDA graph captured at warm-up. Each bucket's replay is held
    bit for bit to the eager kernel path on the same images, and to run on
    the device the port's kernels it runs, launch for launch (a
    ``torch.profiler`` trace of each: the replay runs no wrapper and moves
    no counter, the eager path's wrappers count their launches); then b1
    p50 and b64 images/s, eager and captured, beside the device's idle
    share of b1 requests under ``torch.profiler`` and the b1 graph's
    replay alone on the device (CUDA events)."""
    import numpy as np

    from gavit_tpu_torch.serving import Predictor

    s = cfg.data.image_size
    rng = np.random.default_rng(SEED + 9)
    calib = rng.integers(0, 256, (8, s, s, 3), np.uint8)
    for name, kw in (("bf16", {"precision": "bf16"}),
                     ("int8", {"precision": "int8"}),
                     (f"ToMe r={TOME_R} bf16",
                      {"precision": "bf16", "tome_r": TOME_R})):
        t0 = time.perf_counter()
        pred = Predictor(cfg, weights, device=dev,
                         buckets=SERVE_GRAPH_BUCKETS, **kw)
        pred.calibrate(calib)
        pred.warmup()
        if sorted(pred._graphs) != list(SERVE_GRAPH_BUCKETS):
            raise AssertionError(f"{name}: captured buckets "
                                 f"{sorted(pred._graphs)}")
        warm_s = time.perf_counter() - t0
        eager = EagerPath(pred)
        for b in SERVE_GRAPH_BUCKETS:
            imgs = rng.integers(0, 256, (b, s, s, 3), np.uint8)
            want, c_eager, k_eager = traced(lambda: eager.predict_proba(imgs))
            got, c_graph, k_graph = traced(lambda: pred.predict_proba(imgs))
            same = np.array_equal(got, want)
            ok = (same and not c_graph and bool(c_eager) and bool(k_eager)
                  and k_graph == k_eager and np.isfinite(got).all())
            log(f"[serve_graphs] {name} b{b}: replay vs eager kernel path "
                f"{'bit-equal' if same else f'max |dp| {np.abs(got - want).max():.3e}'}"
                f"; the eager path's wrappers launched "
                + ", ".join(f"{k[1]}/{k[0]} {v}" for k, v in
                            sorted(c_eager.items()))
                + f", the replay moved {'no counter' if not c_graph else c_graph}"
                f"; on the device (trace) the eager path ran "
                f"{kernel_list(k_eager)}, the replay "
                f"{'the same' if k_graph == k_eager else kernel_list(k_graph)}"
                f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} b{b}: the captured replay "
                                     "differs from the eager path")
        replay_ms = cuda_ms(pred._graphs[1].graph.replay, iters=50)
        times = {}
        for path, p in (("eager", eager), ("captured", pred)):
            idle, busy = idle_share(p)
            times[path] = (p50_ms(p), imgs_per_s(p), idle, busy)
        log(f"[time] Predictor {name} at {s} px, warm-up with capture "
            f"{warm_s:.1f} s; b1 graph replay alone {replay_ms:.4f} ms on "
            f"the device; "
            + "; ".join(f"{path}: b1 p50 {p50:.3f} ms, b64 {rate:.1f} "
                        f"images/s, b1 idle share {idle:.3f} (device busy "
                        f"{busy:.4f} ms a request, under the profiler)"
                        for path, (p50, rate, idle, busy) in times.items())
            + f" ({card})")
        del pred, eager


EXPORT_DIR = ROOT / "build" / "chip_export"
EXPORT_BUCKETS = (1, 8)


def phase_export(cfg, weights, dev, card):
    """``export_serving`` on the card at 224 px over buckets 1 and 8, bf16
    and int8 (calibrated on 8 images): the artifact loaded by
    ``ExportedPredictor`` runs the kernels' custom ops (counted in its
    warm-up, each bucket's eager run and its capture: A and C, and B in
    bf16; the int8 GEMM is an aten op in the program, uncounted); one b8
    request's replay is bit-equal to the artifact's eager path and runs
    the same port kernels on the device (a ``torch.profiler`` trace of
    each), and its probabilities are held to the Predictor's (bit-equality
    recorded) and to the plain-version Predictor's within PROB_TOL. The
    artifacts go under ``build/chip_export`` and are removed."""
    import numpy as np

    from gavit_tpu_torch.serving import (ExportedPredictor, Predictor,
                                         export_serving)
    from gavit_tpu_torch.utils.convert import quant_state

    s = cfg.data.image_size
    depth = cfg.model.depth
    n_graph = len(set(cfg.model.graph_insert_after()))
    rng = np.random.default_rng(SEED + 10)
    calib = rng.integers(0, 256, (8, s, s, 3), np.uint8)
    imgs = rng.integers(0, 256, (8, s, s, 3), np.uint8)
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    try:
        for precision, want in (
                ("bf16", {"A": depth, "B": depth, "C": n_graph}),
                ("int8", {"A": depth, "C": n_graph})):
            out = EXPORT_DIR / precision
            t0 = time.perf_counter()
            manifest = export_serving(
                cfg, str(out), weights=weights, precision=precision,
                buckets=EXPORT_BUCKETS, device=dev,
                calibration_images=calib if precision == "int8" else None)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = ExportedPredictor(str(out))
            _, counts = launches_of(loaded.warmup)
            load_s = time.perf_counter() - t0
            counts = by_kernel(counts)
            warm = expected({k: 2 * n * len(EXPORT_BUCKETS)
                             for k, n in want.items()})
            eager, c_eager, k_eager = traced(
                lambda: loaded._predict_proba_eager(imgs))
            got, c_graph, k_graph = traced(lambda: loaded.predict_proba(imgs))
            replayed = (np.array_equal(got, eager) and not c_graph
                        and by_kernel(c_eager) == expected(want)
                        and bool(k_eager) and k_graph == k_eager)
            replay_text = (
                "bit-equal to it, no counter moved, the same port kernels "
                f"on the device (trace: {kernel_list(k_graph)})" if replayed
                else f"differs: counters {c_graph}, kernels "
                f"{kernel_list(k_graph)} against {kernel_list(k_eager)}")
            pred = Predictor(cfg, weights, precision=precision, device=dev,
                             buckets=EXPORT_BUCKETS)
            plain = Predictor(cfg, weights, precision=precision, device=dev,
                              buckets=EXPORT_BUCKETS, impl="reference")
            if precision == "int8":
                pred.calibrate(calib)
                plain.use_quant_state(quant_state(pred.model))
            mine = pred.predict_proba(imgs)
            err_pred = float(np.abs(got - mine).max())
            err_plain = float(np.abs(got - plain.predict_proba(imgs)).max())
            sizes = sum(f.stat().st_size for f in out.iterdir())
            ok = (counts == warm and replayed and np.isfinite(got).all()
                  and err_pred <= PROB_TOL and err_plain <= PROB_TOL
                  and manifest["device"] == "cuda"
                  and sorted(loaded._graphs) == list(EXPORT_BUCKETS))
            log(f"[export] {precision} at {s} px, buckets {EXPORT_BUCKETS}: "
                f"exported in {export_s:.1f} s ({manifest['n_weights']} "
                f"weights, {sizes / 2**20:.1f} MiB on disk), loaded, warm "
                f"and captured in {load_s:.1f} s, the warm-up launching "
                + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
                + f"; one b8 request: the eager path's wrappers launched "
                + ", ".join(f"{k} {v}" for k, v in
                            by_kernel(c_eager).items() if v)
                + f", the replay {replay_text}; vs the Predictor "
                f"{'bit-equal' if np.array_equal(got, mine) else f'max |dp| {err_pred:.3e}'}"
                f", vs the plain versions max |dp| {err_plain:.3e} (tol "
                f"{PROB_TOL:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the {precision} artifact: warm-up "
                                     f"launches {counts} (expected {warm}),"
                                     f" replay ok {replayed}, {err_pred}, "
                                     f"{err_plain}")
            log(f"[time] ExportedPredictor {precision} at {s} px: b1 p50 "
                f"{p50_ms(loaded):.3f} ms over 50 calls ({card})")
            del loaded, pred, plain
    finally:
        shutil.rmtree(EXPORT_DIR, ignore_errors=True)


def phase_qat_serve(dev, card):
    """QAT: vit_b16_graph2 with ``training.qat=true`` at b128, 3 steps
    through the kernels against 3 through the plain versions on the same
    scales (the launches of one step: A, A′, C, H, H′ and F, never D or
    D′), its checkpoint written, then served by ``scripts/serve_torch.py
    --checkpoint ... --precision int8 --coalesce-ms 2 --max-queue-rows 64``
    in a process of its own: concurrent requests against the in-process
    Predictor on that checkpoint, ``/metrics``, one 503 (65 rows while
    others are pending) and one 413 (a Content-Length past the default
    128 MB), then SIGTERM: exit 0 and ``shutdown complete``."""
    import shutil
    import socket

    import numpy as np

    from gavit_tpu_torch.serving import Predictor

    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    tcfg = train_config(["training.qat=true", f"paths.save_dir={SERVE_DIR}"])
    depth = tcfg.model.depth
    n_graph = len(set(tcfg.model.graph_insert_after()))
    # per block A, A′, H, H′ (the MLP's chain), never D or D′; F forward and
    # backward at the embedding, each attention projection and MLP output,
    # and each graph projection
    trainer, _, _ = phase_train(
        tcfg, dev, "vit_b16_graph2 QAT",
        {"A": depth, "A′": depth, "C": n_graph, "H": depth, "H′": depth,
         "F": 2 * (1 + 2 * depth + n_graph)}, steps_compare=3,
        steps_learn=0)
    trainer.save_checkpoint({"mean_auc": 0.5}, is_best=True)
    best = SERVE_DIR / "best_model"
    del trainer
    cfg = tcfg
    s = cfg.data.image_size
    pred = Predictor(cfg, checkpoint_path=str(best), precision="int8",
                     device=dev)
    if not pred.calibrated:
        raise AssertionError("the QAT checkpoint's scales were not served")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    log_path = SERVE_DIR / "serve.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "scripts" / "serve_torch.py"),
             "--config", str(CONFIG), "--checkpoint", str(best),
             "--precision", "int8", "--coalesce-ms", "2",
             "--max-queue-rows", "64", "--port", str(port),
             "--device", RUN_DEVICE],
            cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
    try:
        def get(path, body=None, timeout=300, ctype="application/json"):
            req = urllib.request.Request(base + path, data=body, headers=(
                {"Content-Type": ctype} if body else {}))
            with urllib.request.urlopen(req, timeout=timeout) as r:
                raw = r.read()
            return raw.decode() if path == "/metrics" else json.loads(raw)

        deadline = time.monotonic() + 300
        while True:
            try:
                get("/healthz", timeout=5)
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError("the server did not come up: "
                                         + log_path.read_text()[-2000:])
                time.sleep(0.5)
        log(f"[serve_quant] scripts/serve_torch.py --checkpoint (QAT) "
            f"--precision int8 up in {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(SEED + 7)
        singles = rng.integers(0, 256, (16, s, s, 3), np.uint8)
        batch = rng.integers(0, 256, (8, s, s, 3), np.uint8)
        want = pred.predict_proba(np.concatenate([singles, batch]))
        answers = {}

        def post(i, arr):
            answers[i] = get("/predict", json.dumps(arr.tolist()).encode())

        threads = [threading.Thread(target=post, args=(i, img))
                   for i, img in enumerate(singles)]
        threads.append(threading.Thread(target=post, args=(16, batch)))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        got = np.concatenate([np.asarray(answers[i]["probabilities"])
                              for i in range(17)])
        err = float(np.abs(got - want).max())
        stats = get("/stats")
        ok = err <= 1e-4 and len(answers) == 17
        log(f"[serve_quant] 16 concurrent single-image requests and one of "
            f"8: max |dp| vs the in-process int8 Predictor on the checkpoint "
            f"{err:.2e} (tol 1e-4; the JSON keeps 5 decimals) "
            f"{'ok' if ok else 'FAIL'}; /stats microbatch "
            f"{stats['microbatch']}")
        if not ok:
            raise AssertionError("the served answers disagree")
        metrics = get("/metrics")
        kinds = sorted(line.split()[2] for line in metrics.splitlines()
                       if line.startswith("# TYPE"))
        if len(kinds) != 11:
            raise AssertionError(f"/metrics: {metrics}")
        log(f"[serve_quant] GET /metrics: {len(kinds)} metrics ok")

        # 503: 65 rows past the bound of 64 while single PNG requests (a
        # cheap decode) keep rows pending
        from PIL import Image

        big = json.dumps(np.zeros((65, s, s, 3), np.uint8).tolist()).encode()
        buf = io.BytesIO()
        Image.fromarray(singles[0]).save(buf, format="PNG")
        one = buf.getvalue()
        shed, stop, errors = None, threading.Event(), []

        def keep_busy():
            while not stop.is_set():
                try:
                    get("/predict", one, ctype="image/png")
                except urllib.error.HTTPError as e:
                    if e.code != 503:  # shed too while the 65 rows pend
                        errors.append(e)
                        return
                except Exception as e:  # noqa: BLE001 - raised below
                    errors.append(e)
                    return

        for _ in range(3):
            busy = [threading.Thread(target=keep_busy) for _ in range(8)]
            for t in busy:
                t.start()
            try:
                get("/predict", big)
            except urllib.error.HTTPError as e:
                shed = e
            stop.set()
            for t in busy:
                t.join(timeout=120)
            stop.clear()
            if shed is not None:
                break
        if errors:
            raise AssertionError(f"a request beside the 503 failed: "
                                 f"{errors[0]!r}")
        if shed is None or shed.code != 503 or \
                shed.headers["Retry-After"] != "1":
            raise AssertionError(f"no 503 with Retry-After: {shed}")
        log("[serve_quant] 65 rows while others pend: 503, Retry-After 1 ok")
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(129 << 20))
        conn.endheaders()
        status = conn.getresponse().status
        conn.close()
        if status != 413:
            raise AssertionError(f"a 129 MB Content-Length: HTTP {status}")
        log("[serve_quant] a 129 MB Content-Length: 413 before the body ok")
        proc.send_signal(15)
        code = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    text = log_path.read_text()
    ok = code == 0 and "shutdown complete" in text and \
        "int8 predictor using QAT-trained scales" in text
    log(f"[serve_quant] SIGTERM: exit {code}, 'shutdown complete' logged "
        f"{'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError("the server did not stop cleanly: "
                             + text[-2000:])
    shutil.rmtree(SERVE_DIR, ignore_errors=True)


def train_config(overrides=()):
    """vit_b16_graph2 at batch 128 with a warmup of 5 steps (5 steps an
    epoch of a 640-image synthetic set with learnable class stripes)."""
    from gavit_tpu_torch import load_config

    return load_config(str(CONFIG), [
        f"data.batch_size={TRAIN_BATCH}", "data.synthetic_size=640",
        "data.synthetic_learnable=true", "training.warmup_epochs=1",
        f"training.seed={SEED}", *overrides])


def train_config_384(overrides=()):
    """finetune_384 at its batch 16 with a warmup of 5 steps (an 80-image
    synthetic set) and the 224-px run's lr of 1e-4: the file's 3e-5 is a
    fine-tune's, from pretrained weights, and moves random weights too
    little for 30 steps to show learning."""
    from gavit_tpu_torch import load_config

    return load_config(str(CONFIG_384), [
        "data.synthetic_size=80", "data.synthetic_learnable=true",
        "training.warmup_epochs=1", "training.learning_rate=1e-4",
        f"training.seed={SEED}", *overrides])


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


def phase_train(cfg, dev, name, expect, steps_compare=5, steps_learn=30,
                count_step=1, loss_tol=LOSS_REL_TOL, routing=None):
    """The training step through scripts/train_torch.py's entry points;
    ``expect``: the nonzero launch counts of step ``count_step``, asserted.
    The learning check (``steps_learn`` steps must lower the held loss) is
    left out when ``steps_learn`` is not past ``steps_compare``.
    ``loss_tol``: each step's loss, kernels against plain versions,
    relative. ``routing``, a dict, gets an MoE model's expert-choice flips
    (``flips``, one count a replayed step, of ``choices``)."""
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import train_torch

    dataset = train_torch.create_dataset(cfg)
    bs = cfg.data.batch_size
    trainers = {impl: train_torch.build_trainer(cfg, dataset, dev, impl=impl,
                                                gate=GATE)
                for impl in ("auto", "reference")}
    if trainers["auto"].quant:
        # QAT: the plain versions' trainer on the kernels' trainer's
        # scales, so the comparison holds the arithmetic and not two
        # calibrations in bf16
        from gavit_tpu_torch.utils.convert import load_quant_state

        trainers["reference"].quant = trainers["auto"].quant
        load_quant_state(trainers["reference"].model, trainers["auto"].quant)
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
    # an MoE model's plain step replays the kernels' step's expert choices,
    # a QAT model's the kernels' step's int8 codes
    pinned = (PinnedRouting() if cfg.model.moe.enabled else
              PinnedCodes(trainers["auto"].model, trainers["reference"].model)
              if cfg.training.qat else None)
    same_weights = []  # QAT: whether step i's two models start equal
    with pinned or contextlib.nullcontext():
        for i in range(steps_compare):
            images, labels = (torch.from_numpy(a) for a in data[i])
            if isinstance(pinned, PinnedCodes):
                same_weights.append(all(
                    torch.equal(a, b) for a, b in zip(
                        trainers["auto"].model.parameters(),
                        trainers["reference"].model.parameters())))
            for impl, tr in trainers.items():
                if impl == "auto" and pinned is not None:
                    pinned.start_record()
                elif isinstance(pinned, PinnedCodes):
                    pinned.start_replay(PIN_BOUNDS if same_weights[i]
                                        else PIN_BOUNDS_UPDATED)
                elif pinned is not None:
                    pinned.start_replay()
                if impl == "auto" and i == count_step:
                    torch.cuda.synchronize()
                    reset_counts()
                m = tr.train_step(images, labels)
                if impl == "auto" and i == count_step:
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
    if isinstance(pinned, PinnedCodes):
        for i, same in enumerate(same_weights):
            ok, text = pinned.check(i)
            log(f"[train] {name} step {i} ("
                f"{'equal' if same else 'updated'} weights), the plain "
                f"step on the kernels' codes: {text} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} step {i}: the plain forward's "
                                     f"int8 codes: {text}")
    elif pinned is not None:
        log(f"[train] {name}: each plain step on the kernels' step's expert "
            f"choices; without them it would have made "
            f"{', '.join(map(str, pinned.flips))} of {pinned.choices} "
            f"choices otherwise")
        if routing is not None:
            routing.update(flips=list(pinned.flips), choices=pinned.choices)
    rels = [abs(a - b) / abs(b) for a, b in zip(losses["auto"],
                                                 losses["reference"])]
    ok = max(rels) <= loss_tol
    log(f"[train] {name} {cfg.training.precision} b{bs}, dropout "
        f"{cfg.model.drop_rate}, "
        f"gates {GATE}: losses through the kernels "
        f"{[round(v, 5) for v in losses['auto']]}, through the plain versions "
        f"{[round(v, 5) for v in losses['reference']]}; max rel diff "
        f"{max(rels):.3e} (tol {loss_tol:.0e}) {'ok' if ok else 'FAIL'}")
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
    if not ok:
        norms = {impl: dict(g)[worst[1]].norm().item()
                 for impl, g in first_grads.items()}
        log(f"[train] {worst[1]}'s gradient norm through the kernels "
            f"{norms['auto']:.6e}, through the plain versions "
            f"{norms['reference']:.6e}")
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


def gradcam_times(dev, results, card) -> dict:
    """A′ in fp32 at b64 N = 197 against its plain version and sdpa's fp32
    forward and backward (TF32 off), per call and alone on the device (20
    launches between two events); its bound: 10·B·H·N²·d operations at
    the card's fp32 rate (no tensor cores) against 7 fp32 [B, N, H, d]
    tensors moved."""
    import torch
    import torch.nn.functional as F

    from gavit_tpu_torch.ops import attention as A

    qkv, do = results["A′ fp32"]["cases"][0]
    b, n, h, d = qkv.shape[0], qkv.shape[1], HEADS, HEAD_DIM
    scale = d ** -0.5
    q, k, v = (t.detach().clone().requires_grad_(True)
               for t in A._split_heads(qkv, h))
    do_c = do.contiguous()

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(q, k, v)
        torch.autograd.grad(out, (q, k, v), do_c)

    assert not torch.backends.cuda.matmul.allow_tf32
    kernel = lambda: A.qkv_attention_bwd_kernel(qkv, do, scale, h)  # noqa: E731
    row = (cuda_ms(kernel),
           cuda_ms(lambda: A.attention_backward_reference(qkv, do, scale, h),
                   iters=5),
           cuda_ms(sdpa_fwd_bwd)) + bound(10 * b * h * n * n * d,
                                          7 * b * n * h * d * 4,
                                          PEAK_FP32_FLOPS)
    results["A′ fp32"]["device"] = (device_ms(kernel), device_ms(sdpa_fwd_bwd))
    alone, lib_alone = results["A′ fp32"]["device"]
    log(f"[time] A′ fp32 at b{b} N={n}: per call {row[0]:.4f} ms, alone on "
        f"the device (20 launches between two events) {alone:.4f} ms; plain "
        f"{row[1]:.4f} ms; sdpa fp32 fwd+bwd, TF32 off, {row[2]:.4f} ms, "
        f"alone {lib_alone:.4f} ms; bound {row[3]:.4f} ms ({row[4]}) "
        f"({card})")
    return {"A′ fp32": row}


def gradcam_vs_plain(cfg, weights, dev, forward: dict, backward: dict,
                     tag: str, what: str, seed: int, pinned=None):
    """fp32 Grad-CAM of ``cfg``'s model on GRADCAM_BATCH images drawn from
    ``seed``, as ``scripts/gradcam_torch.py`` builds it (``load_model``'s
    fp32 at dropout 0), at each block of GRADCAM_BLOCKS, class 0, through
    the kernels against the plain versions on the same weights (CAM and
    probabilities within GRADCAM_TOL). Each call's launches are held to
    ``forward`` and, for each kernel of ``backward``, to its launches in
    each block (a tuple over the blocks) summed over the blocks after the
    probe's; the plain versions launch nothing. ``pinned``, a
    :class:`PinnedRouting` (entered), hands each plain forward the kernels'
    forward's expert choices. Returns (the two models, the preprocessed
    images, the launches at the first probed block before the last)."""
    import numpy as np
    import torch

    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.serving import Predictor
    from gavit_tpu_torch.utils.gradcam import VisionTransformerGradCAM

    s, patch = cfg.data.image_size, cfg.model.patch_size
    depth = cfg.model.depth
    imgs = np.random.default_rng(seed).integers(
        0, 256, (GRADCAM_BATCH, s, s, 3), np.uint8)
    x = val_preprocess(torch.from_numpy(imgs).to(dev))
    models = {impl: Predictor(cfg, weights, precision="fp32", device=dev,
                              impl=impl).model
              for impl in ("auto", "reference")}
    gradcam_counts = None
    for block in GRADCAM_BLOCKS:
        out = {}
        for impl, model in models.items():
            if pinned is not None:
                (pinned.start_record if impl == "auto"
                 else pinned.start_replay)()
            torch.cuda.synchronize()
            reset_counts()
            out[impl] = VisionTransformerGradCAM(model, block)(x, 0)
            torch.cuda.synchronize()
            counts = read_counts()
            if impl == "auto":
                after = block % depth + 1  # the blocks the backward runs
                want = expected({**forward, **{
                    k: sum(per_block[after:])
                    for k, per_block in backward.items()}})
                if counts != want:
                    raise AssertionError(f"{what} Grad-CAM at block {block}: "
                                         f"launches {counts}, expected "
                                         f"{want}")
                launched = counts
                if block % depth != depth - 1:
                    gradcam_counts = counts
            elif any(counts.values()):
                raise AssertionError(f"the plain versions launched {counts}")
        (cam, prob), (cam_p, prob_p) = out["auto"], out["reference"]
        err_cam = float(np.abs(cam - cam_p).max())
        err_p = float(np.abs(prob - prob_p).max())
        ok = (err_cam <= GRADCAM_TOL and err_p <= GRADCAM_TOL
              and np.isfinite(cam).all() and cam.shape == (
                  GRADCAM_BATCH, s // patch, s // patch))
        log(f"[{tag}] fp32 Grad-CAM of {what} (N={(s // patch) ** 2 + 1}) "
            f"at block {block}, class 0, {GRADCAM_BATCH} images: kernels vs "
            f"plain versions max |dCAM| {err_cam:.3e}, max |dp| {err_p:.3e} "
            f"(tol {GRADCAM_TOL:.0e}) {'ok' if ok else 'FAIL'}; CAM > 0 in "
            f"{(cam > 0).mean():.1%} of the patches"
            + (" (the head reads CLS alone, so the last block's patch "
               "tokens get no gradient)" if block % depth == depth - 1
               else "") + "; launches "
            + ", ".join(f"{k} {v}" for k, v in launched.items() if v))
        if not ok:
            raise AssertionError(f"{what} Grad-CAM through the kernels "
                                 "disagrees with the plain versions")
    return models, x, gradcam_counts


def phase_gradcam(cfg, weights, dev, results, card):
    """The interpretability path in fp32, as ``scripts/gradcam_torch.py``
    builds it (``load_model``'s fp32 at dropout 0): vit_b16_graph2 at full
    width on GRADCAM_BATCH images, Grad-CAM at each block of GRADCAM_BLOCKS
    (at block 6 its backward runs A′ in fp32 in blocks 7-11, past the
    second graph block) and the attention rollout, through the kernels
    against the plain versions on the same weights, each forward's
    launches counted; then FP32_TRAIN_BATCH training at 224 px in fp32
    (three steps against the plain versions', the launches of one step),
    its checkpoint, and ``scripts/gradcam_torch.py`` on it in a process of
    its own. Returns (the fp32 step's launches, Grad-CAM's at block 6, the
    timing rows)."""
    import shutil

    import numpy as np
    import torch

    from gavit_tpu_torch.utils.gradcam import attention_rollout

    t0 = time.perf_counter()
    depth = cfg.model.depth
    # A′ fp32 runs in the blocks after the probe's; C at both graph blocks
    models, x, gradcam_counts = gradcam_vs_plain(
        cfg, weights, dev, {"A": depth, "C": 2}, {"A′ fp32": (1,) * depth},
        "gradcam", "vit_b16_graph2", SEED + 7)
    maps = {}
    for impl, model in models.items():
        torch.cuda.synchronize()
        reset_counts()
        maps[impl] = {f: attention_rollout(model, x, f)[0]
                      for f in ("mean", "max")}
        torch.cuda.synchronize()
        counts = read_counts()
        if impl == "auto" and counts != expected({"C": 4}):
            raise AssertionError(f"rollout launches {counts}: expected C "
                                 "4 (the capture takes the plain attention)")
    err = max(float(np.abs(maps["auto"][f] - maps["reference"][f]).max())
              for f in ("mean", "max"))
    ok = err <= GRADCAM_TOL
    log(f"[gradcam] fp32 attention rollout (mean, max) over {GRADCAM_BATCH} "
        f"images: kernels vs plain versions max |d| {err:.3e} (tol "
        f"{GRADCAM_TOL:.0e}) {'ok' if ok else 'FAIL'}; launches C 4 (two "
        f"forwards; the capture's attention is the plain one, as JAX's)")
    if not ok:
        raise AssertionError("the rollout through the kernels disagrees "
                             "with the plain versions")
    del models
    rows = gradcam_times(dev, results, card)

    # fp32 training at 224 px, then its checkpoint through the Grad-CAM CLI
    shutil.rmtree(GRADCAM_DIR, ignore_errors=True)
    tcfg = train_config([
        "training.precision=fp32", f"data.batch_size={FP32_TRAIN_BATCH}",
        f"data.synthetic_size={5 * FP32_TRAIN_BATCH}",
        f"paths.save_dir={GRADCAM_DIR / 'ckpt'}", "wandb.mode=disabled"])
    trainer, _, counts_fp32 = phase_train(
        tcfg, dev, "vit_b16_graph2 fp32",
        {"A": depth, "A′ fp32": depth, "C": 2, "H": depth, "H′": depth,
         "F": 2 * (1 + 2 * depth + 2)}, steps_compare=3, steps_learn=0,
        loss_tol=FP32_LOSS_REL_TOL)
    trainer.save_checkpoint({"mean_auc": 0.5}, is_best=True)
    del trainer
    torch.cuda.empty_cache()
    out_dir = GRADCAM_DIR / "gradcam"
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "gradcam_torch.py"),
         "--config", str(CONFIG), "--checkpoint",
         str(GRADCAM_DIR / "ckpt" / "best_model"), "--dataset", "synthetic",
         "--num-images", str(GRADCAM_BATCH), "--out", str(out_dir),
         "--device", RUN_DEVICE, "--set", "wandb.mode=disabled"],
        capture_output=True, text=True, timeout=600)
    text = proc.stdout + proc.stderr
    skipped = [ln for ln in text.splitlines() if "figure skipped:" in ln]
    cams = [ln for ln in text.splitlines() if ln.startswith("Grad-CAM for ")]
    figures = sorted(str(p.relative_to(out_dir))
                     for p in out_dir.rglob("*") if p.is_file())
    try:
        import matplotlib  # noqa: F401
        drawn = True
    except ImportError:
        drawn = False
    # drawn: every figure written (the rollout, a map a block, one a
    # predicted disease, the grid) and none skipped; else each skipped,
    # the per-block maps in one line
    ok = proc.returncode == 0 and "Artifacts in" in text and (
        (not skipped and len(figures) == 2 + depth + len(cams))
        if drawn else (not figures and len(skipped) == 3 + len(cams)))
    log(f"[gradcam] scripts/gradcam_torch.py on the fp32 checkpoint: exit "
        f"{proc.returncode} in {time.perf_counter() - t1:.1f} s, "
        f"{len(cams)} diseases predicted above 0.5, {len(figures)} figures "
        f"written, {len(skipped)} skipped (matplotlib "
        f"{'present' if drawn else 'absent'}) {'ok' if ok else 'FAIL'}")
    for line in skipped[:2]:
        log(f"[gradcam]   {line.strip()}")
    if not ok:
        log(text[-3000:])
        raise AssertionError("scripts/gradcam_torch.py failed")
    shutil.rmtree(GRADCAM_DIR)
    log(f"[gradcam] phase done in {time.perf_counter() - t0:.1f} s")
    return counts_fp32, gradcam_counts, rows


def fp32_long_times(dev, results, card) -> dict:
    """K, K′, L and L′ in fp32 at the table's shapes (K, K′ at b16 N = 577;
    L, L′ at b32 N = 1025, L′ from L's o and lse) against their plain
    versions and sdpa in fp32 with TF32 off (its forward for K and L, its
    forward and backward for K′ and L′), per call and alone on the device
    (20 launches between two events); bounds: 4·B·H·N²·d operations
    forward and 10·B·H·N²·d backward at the card's fp32 rate (no tensor
    cores), against the fp32 bytes the call moves."""
    import torch
    import torch.nn.functional as F

    from gavit_tpu_torch.ops import attention as A

    assert not torch.backends.cuda.matmul.allow_tf32
    rows = {}
    h, d = HEADS, HEAD_DIM
    scale = d ** -0.5
    qkv_k, do_k = results["K′ fp32"]["cases"][0]
    qkv_l, o_l, lse_l, do_l = results["L′ fp32"]["cases"][0]
    for key, qkv, do in (("K", qkv_k, do_k), ("L", qkv_l, do_l)):
        b, n = qkv.shape[0], qkv.shape[1]
        q, k, v = (t.detach().clone().requires_grad_(True)
                   for t in A._split_heads(qkv, h))
        do_c = do.contiguous()

        def sdpa_fwd(q=q, k=k, v=v):
            with torch.no_grad():
                return F.scaled_dot_product_attention(q, k, v)

        def sdpa_fwd_bwd(q=q, k=k, v=v, do_c=do_c):
            out = F.scaled_dot_product_attention(q, k, v)
            torch.autograd.grad(out, (q, k, v), do_c)

        if key == "K":
            fwd = lambda: A.qkv_attention_long_kernel(qkv, scale, h)  # noqa: E731
            plain = lambda: A.attention_reference(  # noqa: E731
                *A._split_heads(qkv, h), scale)
            bwd = lambda: A.qkv_attention_long_bwd_kernel(  # noqa: E731
                qkv, do, scale, h)
            plain_bwd = lambda: A.attention_backward_reference(  # noqa: E731
                qkv, do, scale, h)
        else:
            fwd = lambda: A.qkv_attention_large_kernel(qkv, scale, h)  # noqa: E731
            plain = lambda: A.blockwise_attention_reference(  # noqa: E731
                qkv, scale, h)
            bwd = lambda: A.qkv_attention_large_bwd_kernel(  # noqa: E731
                qkv, o_l, lse_l, do, scale, h)
            plain_bwd = lambda: A.blockwise_attention_backward_reference(  # noqa: E731
                qkv, o_l, lse_l, do, scale, h)
        tensor = b * n * h * d * 4  # one fp32 [B, N, H, d] tensor
        for name, fn, ref, lib, flops, nbytes in (
                (f"{key} fp32", fwd, plain, sdpa_fwd,
                 4 * b * h * n * n * d, 4 * tensor
                 + (b * h * n * 4 if key == "L" else 0)),
                (f"{key}′ fp32", bwd, plain_bwd, sdpa_fwd_bwd,
                 10 * b * h * n * n * d, (8 if key == "L" else 7) * tensor
                 + (b * h * n * 4 if key == "L" else 0))):
            rows[name] = (cuda_ms(fn), cuda_ms(ref, iters=5), cuda_ms(lib)
                          ) + bound(flops, nbytes, PEAK_FP32_FLOPS)
            results[name]["device"] = (device_ms(fn), device_ms(lib))
            alone, lib_alone = results[name]["device"]
            km, pm, lm, bms, by = rows[name]
            log(f"[time] {name} at b{b} N={n} H={h}: per call {km:.4f} ms, "
                f"alone on the device (20 launches between two events) "
                f"{alone:.4f} ms; plain {pm:.4f} ms; sdpa fp32 "
                f"{'fwd' if name == key + ' fp32' else 'fwd+bwd'}, TF32 "
                f"off, {lm:.4f} ms, alone {lib_alone:.4f} ms; bound "
                f"{bms:.4f} ms ({by}; {alone / bms:.1f}x it alone) ({card})")
        torch.cuda.empty_cache()
    return rows


def phase_fp32_long(cfg384, weights384, dev, results, card):
    """fp32 attention past kernel A's 416 tokens, on the paths that reach
    it: Grad-CAM of the 384-px fine-tune (N = 577) in fp32, as
    ``scripts/gradcam_torch.py`` builds it, at GRADCAM_BLOCKS on
    GRADCAM_BATCH images through the kernels (K fp32 in the forward, K′
    fp32 in the blocks after the probe's) against the plain versions;
    three fp32 training steps at 384 px b16 against the plain versions'
    (K and K′ fp32), their checkpoint and ``scripts/gradcam_torch.py
    --config configs/finetune_384.yaml`` on it in a process of its own;
    three fp32 steps at 512 px b32 (N = 1025, FP32_DEPTH_512 blocks, L and
    L′ fp32); then the four fp32 bodies' times. Returns (the 384 step's
    launches, the 512 step's, Grad-CAM's at block 6, the timing rows)."""
    import torch

    t0 = time.perf_counter()
    depth = cfg384.model.depth
    # the learned-static graph block aggregates in tensor ops (no C); the
    # fp32 MLP takes the GEMM chain (no B)
    models, _, gradcam_counts = gradcam_vs_plain(
        cfg384, weights384, dev, {"K fp32": depth},
        {"K′ fp32": (1,) * depth}, "fp32_long", "finetune_384", SEED + 11)
    del models
    torch.cuda.empty_cache()

    # fp32 training at 384 px b16, then its checkpoint through the CLI
    shutil.rmtree(GRADCAM_384_DIR, ignore_errors=True)
    tcfg = train_config_384([
        "training.precision=fp32",
        f"paths.save_dir={GRADCAM_384_DIR / 'ckpt'}", "wandb.mode=disabled"])
    trainer, _, counts_384 = phase_train(
        tcfg, dev, "finetune_384 fp32",
        {"K fp32": depth, "K′ fp32": depth, "H": depth, "H′": depth,
         "F": 2 * (1 + 2 * depth + 1)}, steps_compare=3, steps_learn=0,
        loss_tol=FP32_LOSS_REL_TOL)
    trainer.save_checkpoint({"mean_auc": 0.5}, is_best=True)
    del trainer
    torch.cuda.empty_cache()
    # the CLI in a process of its own, beside the 512-px steps (which time
    # nothing)
    out_dir = GRADCAM_384_DIR / "gradcam"
    cli_log = GRADCAM_384_DIR / "cli.log"
    t1 = time.perf_counter()
    with open(cli_log, "w") as sink:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "scripts" / "gradcam_torch.py"),
             "--config", str(CONFIG_384), "--checkpoint",
             str(GRADCAM_384_DIR / "ckpt" / "best_model"), "--dataset",
             "synthetic", "--num-images", str(GRADCAM_BATCH), "--out",
             str(out_dir), "--device", RUN_DEVICE, "--set",
             "wandb.mode=disabled"],
            stdout=sink, stderr=subprocess.STDOUT)
    try:
        # fp32 training at 512 px b32 (N = 1025) at full width, cut in depth
        d512 = FP32_DEPTH_512
        tcfg512 = large_config(512, [
            f"data.batch_size={BATCH_512}",
            f"data.synthetic_size={5 * BATCH_512}",
            "data.synthetic_learnable=true", "training.warmup_epochs=1",
            f"training.seed={SEED}", "training.precision=fp32",
            f"model.depth={d512}"])
        trainer, _, counts_512 = phase_train(
            tcfg512, dev, f"vit_b16_graph2 512 px fp32 depth {d512}",
            {"L fp32": d512, "L′ fp32": d512, "H": d512, "H′": d512,
             "F": 2 * (1 + 2 * d512 + 2)}, steps_compare=3, steps_learn=0,
            loss_tol=FP32_LOSS_REL_TOL)
        del trainer
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = cli_log.read_text()
    cams = [ln for ln in text.splitlines() if ln.startswith("Grad-CAM for ")]
    ok = proc.returncode == 0 and "Artifacts in" in text
    log(f"[fp32_long] scripts/gradcam_torch.py --config "
        f"configs/finetune_384.yaml on the fp32 384-px checkpoint, beside "
        f"the 512-px steps: exit {proc.returncode} {time.perf_counter() - t1:.1f} "
        f"s after its start ({time.perf_counter() - t2:.1f} s after the "
        f"steps), {len(cams)} diseases predicted above 0.5 "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        log(text[-3000:])
        raise AssertionError("scripts/gradcam_torch.py failed at 384 px")
    shutil.rmtree(GRADCAM_384_DIR)
    rows = fp32_long_times(dev, results, card)
    log(f"[fp32_long] phase done in {time.perf_counter() - t0:.1f} s")
    return counts_384, counts_512, gradcam_counts, rows


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
    the launches of the warm-up (each bucket's eager run and its capture:
    L and B in every block, C never: the graph blocks take the chunked
    path); the b1 p50."""
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
    want = expected({"L": 2 * depth * len(buckets),
                     "B": 2 * depth * len(buckets)})
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
        # fp32 GEMMs over [c, N] chunks: the similarity and the dense
        # aggregation forward (4·B·N²·D), the recompute and both GEMMs'
        # gradients in the backward (12·B·N²·D more); 3 bf16 [B, N, D]
        # tensors forward, 5 more backward
        unit = gb * gn * gn * DIM
        io = gb * gn * DIM * 2
        fb, wf = bound(4 * unit, 3 * io, PEAK_FP32_FLOPS)
        bb, wb = bound(16 * unit, 8 * io, PEAK_FP32_FLOPS)
        log(f"[time] chunked graph (tensor ops, no kernel) bf16 knn B={gb} "
            f"N={gn} chunk {G._pick_chunk(gn)}: forward {fwd:.3f} ms (bound "
            f"{fb:.4f} ms, {wf}, fp32 at {PEAK_FP32_FLOPS / 1e12:.0f} "
            f"TFLOP/s), forward + backward {both:.3f} ms (bound {bb:.4f} "
            f"ms, {wb}) ({card})")
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


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(least ms, what bounds it): the larger of the operations at the
    card's peak for their type (bf16 tensor cores unless ``peak`` says
    otherwise) and the bytes at its memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
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
    # C's backward, _fga_bwd's tensor ops (no kernel, as in the JAX
    # package): four fp32 GEMMs of 2·B·N²·D over the saved adjacency; the
    # tokens, values, gradient and both results bf16, the adjacency fp32
    _, adj = G.graph_aggregate_kernel(t, vals, "knn", 8, 0.0, 1.0,
                                      return_adjacency=True)
    up = torch.randn(t.shape, device=dev, generator=g).to(bf)
    kb = cuda_ms(lambda: G.graph_backward(t, vals, adj, up), iters=5)
    cb, wb = bound(8 * b * (n - 1) ** 2 * DIM,
                   5 * b * (n - 1) * DIM * 2 + b * (n - 1) ** 2 * 4,
                   PEAK_FP32_FLOPS)
    log(f"[time] C's backward (tensor ops) at b{b} N={n - 1}: {kb:.4f} ms, "
        f"bound {cb:.4f} ms ({wb}, fp32 at "
        f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s) ({card})")

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


def moe_library(c, loop=False):
    """The library yardsticks of M, M′ and tgmm on a moe_case, and the name
    of what they call: ``torch._grouped_mm`` (bf16 grouped GEMMs over the
    expert row offsets, no bias: it takes none) where this torch has it, it
    runs on these inputs and ``loop`` is off, else a loop of one
    ``torch.matmul`` per expert (fp32: ``torch._grouped_mm`` takes none).
    M: GEMM, GELU, dropout, GEMM, dropout; M′: that chain's backward to x;
    tgmm: one dW, ``lib["tgmm"](a, b)`` as the kernel's ``tgmm_kernel(a,
    b, group_sizes)``."""
    import torch
    import torch.nn.functional as F

    x, (w1, _, w2, _), dy = c["x"], c["w"], c["dy"]
    offs = torch.cumsum(c["gs"], 0, dtype=torch.int32)
    bounds = [0] + offs.tolist()
    grouped = None if loop else getattr(torch, "_grouped_mm", None)

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
    # every bucket's eager run and its capture: the dense engine at 1, 8 and
    # 32, the grouped one (kernel M) at 128
    torch.cuda.synchronize()
    reset_counts()
    predictor.warmup()
    torch.cuda.synchronize()
    counts = read_counts()
    depth, n = cfg.model.depth, len(predictor.buckets)
    want = expected({"A": 2 * depth * n, "B": 2 * (depth // 2) * n,
                     "C": 2 * 2 * n, "M": 2 * (depth // 2)})
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


def train_config_moe_f32(overrides=()):
    """The MoE example in fp32 at FP32_MOE_BATCH, full width, its first
    FP32_MOE_DEPTH blocks (MoE MLPs in blocks 1 and 3), the grouped engine
    pinned ('auto' would take the dense one for the unfused engine at b64),
    a 5-step epoch of a synthetic set with learnable class stripes."""
    from gavit_tpu_torch import load_config

    return load_config(str(CONFIG_MOE), [
        "training.precision=fp32", f"data.batch_size={FP32_MOE_BATCH}",
        f"data.synthetic_size={5 * FP32_MOE_BATCH}",
        "data.synthetic_learnable=true", "training.warmup_epochs=1",
        f"training.seed={SEED}", f"model.depth={FP32_MOE_DEPTH}",
        "model.moe.impl=grouped", "wandb.mode=disabled", *overrides])


def moe_f32_times(dev, results, card) -> dict:
    """M, M′, tgmm and N-gmm in fp32 at the b128 routing (T = 50432 pairs;
    M, M′ and tgmm over the cap-padded rows at tm 256, N-gmm over the
    packed rows) against their plain versions and a loop of one fp32
    ``torch.matmul`` per expert with TF32 off (no single PyTorch call
    computes the grouped function in fp32: ``torch._grouped_mm`` takes
    none), per call and alone on the device (20 launches between two
    events); bounds: the FLOPs over the T real rows at the card's fp32 rate
    (no tensor cores) against the fp32 bytes the call moves."""
    import torch

    from gavit_tpu_torch.ops import gmm as GM
    from gavit_tpu_torch.ops import moe_fused as MF

    assert not torch.backends.cuda.matmul.allow_tf32
    c = results["M fp32"]["cases"][0]
    x, (w1, b1, w2, b2), tg, tm, gs = c["x"], c["w"], c["tg"], c["tm"], c["gs"]
    dy, h1, go, dh1, dye = results["M′ fp32"]["cases"][0]
    seed, sites = 1, (5, 6)
    cap, e, t = x.shape[0], EXPERTS, c["t"]
    lib = moe_library(c, loop=True)
    wbytes = 2 * e * DIM * HIDDEN * 4
    fwd = lambda: MF.moe_fwd_kernel(  # noqa: E731
        x, w1, b1, w2, b2, tg, tm, seed, sites, DROP_RATE, DROP_RATE, False,
        gs)
    bwd = lambda: MF.moe_bwd_kernel(  # noqa: E731
        dy, h1, w1, w2, tg, tm, seed, sites, DROP_RATE, DROP_RATE, False, gs)
    n = results["N-gmm fp32"]["cases"][0]
    nx, nw1, ndh, ngs, nt = n["x"], n["w1"], n["dh"], n["gs"], n["t"]
    nb = [0] + torch.cumsum(ngs.long(), 0).tolist()

    def loop_gmm(a, w):
        return torch.cat([a[lo:hi] @ w[i] for i, (lo, hi) in
                          enumerate(zip(nb[:-1], nb[1:]))])

    w1t = nw1.transpose(1, 2)
    cases = {
        "M fp32": (fwd, lambda: MF.moe_fwd_reference(
            x, w1, b1, w2, b2, tg, tm, seed, sites, DROP_RATE, DROP_RATE,
            False), lib["M"], 4 * t * DIM * HIDDEN,
            (2 * t * DIM + t * HIDDEN) * 4 + wbytes),
        "M′ fp32": (bwd, lambda: MF.moe_bwd_reference(
            dy, h1, w1, w2, tg, tm, seed, sites, DROP_RATE, DROP_RATE,
            False), lib["M′"], 4 * t * DIM * HIDDEN,
            (3 * t * DIM + 3 * t * HIDDEN) * 4 + wbytes
            + e * (HIDDEN + DIM) * 4),
        "tgmm fp32": (lambda: GM.tgmm_kernel(x, dh1, gs),
                      lambda: GM.tgmm_reference(x, dh1, gs, torch.float32),
                      lambda: lib["tgmm"](x, dh1), 2 * t * DIM * HIDDEN,
                      (t * DIM + t * HIDDEN) * 4 + e * DIM * HIDDEN * 4),
        "N-gmm fp32": (lambda: GM.gmm_kernel(nx, nw1, ngs),
                       lambda: GM.gmm_reference(nx, nw1, ngs),
                       lambda: loop_gmm(nx, nw1), 2 * nt * DIM * HIDDEN,
                       (nt * DIM + e * DIM * HIDDEN + nt * HIDDEN) * 4),
        "N-gmm fp32 transposed": (
            lambda: GM.gmm_kernel(ndh, nw1, ngs, True),
            lambda: GM.gmm_reference(ndh, nw1, ngs, True),
            lambda: loop_gmm(ndh, w1t), 2 * nt * DIM * HIDDEN,
            (nt * HIDDEN + e * DIM * HIDDEN + nt * DIM) * 4),
    }
    rows = {}
    for key, (fn, ref, libf, flops, nbytes) in cases.items():
        rows[key] = (cuda_ms(fn), cuda_ms(ref, iters=3, warmup=1),
                     cuda_ms(libf)) + bound(flops, nbytes, PEAK_FP32_FLOPS)
        dev_times = (device_ms(fn), device_ms(libf))
        if key.endswith("transposed"):
            results["N-gmm fp32"]["device transposed"] = dev_times
        else:
            results[key]["device"] = dev_times
        km, pm, lm, bms, by = rows[key]
        log(f"[time] {key} at b{TRAIN_BATCH} (T={nt if 'N-gmm' in key else t}"
            f"{'' if 'N-gmm' in key else f', cap={cap}, tm={tm}'}): kernel "
            f"{km:.4f} ms, alone on the device (20 launches between two "
            f"events) {dev_times[0]:.4f} ms; plain {pm:.4f} ms; a loop of "
            f"{e} fp32 torch.matmul, TF32 off, {lm:.4f} ms, alone "
            f"{dev_times[1]:.4f} ms; bound {bms:.4f} ms ({by}; "
            f"{dev_times[0] / bms:.1f}x it alone) ({card})")
    torch.cuda.empty_cache()
    return rows


def phase_fp32_moe(cfg_moe, weights_moe, dev, results, card):
    """The MoE example in fp32 on the card (``csrc/moe_f32.cu``): three
    fp32 training steps at FP32_MOE_BATCH and FP32_MOE_DEPTH blocks on the
    fused grouped engine (M fp32, M′ fp32, tgmm fp32) and, with the fused
    gate off, on the unfused one (N-gmm fp32, tgmm fp32), each against the
    plain versions (losses within FP32_LOSS_REL_TOL, the plain steps on
    the kernels' expert choices, the choices they would have flipped
    counted) with the launches of one step; fp32 Grad-CAM of the whole
    model on GRADCAM_BATCH images on the grouped engine at GRADCAM_BLOCKS
    and its attention rollout against the plain versions (GRADCAM_TOL),
    each call's launches counted; then the four fp32 bodies' times.
    Returns (the fused step's launches, the unfused step's, Grad-CAM's at
    block 6, the timing rows)."""
    import torch

    t0 = time.perf_counter()
    d = FP32_MOE_DEPTH
    moe, dense = d // 2, d - d // 2  # MoE MLPs in blocks 1, 3, ...
    # A (fp32 body), A′ fp32 and, in the dense blocks, the fp32 MLP chain
    # with H/H′; F at the embedding, every attention output, the dense MLP
    # outputs and the 2 graph projections, forward and backward
    base = {"A": d, "A′ fp32": d, "C": 2, "H": dense, "H′": dense,
            "F": 2 * (1 + d + dense + 2)}
    tcfg = train_config_moe_f32()
    routing = {}
    _, _, counts_fused = phase_train(
        tcfg, dev, f"vit_b16_moe fp32 depth {d}",
        {**base, "M fp32": moe, "M′ fp32": moe, "tgmm fp32": 2 * moe},
        steps_compare=3, steps_learn=0, loss_tol=FP32_LOSS_REL_TOL,
        routing=routing)
    flips = {"fused": routing}
    torch.cuda.empty_cache()
    routing = {}
    with fused_gate("0"):
        # the unfused engine: N-gmm fp32 for both GEMMs and, transposed,
        # their input gradients, tgmm fp32 for dW, F at both of its
        # dropout sites forward and backward
        _, _, counts_unfused = phase_train(
            tcfg, dev, f"vit_b16_moe unfused fp32 depth {d}",
            {**base, "N-gmm fp32": 4 * moe, "tgmm fp32": 2 * moe,
             "F": base["F"] + 2 * 2 * moe},
            steps_compare=3, steps_learn=0, loss_tol=FP32_LOSS_REL_TOL,
            routing=routing)
    flips["unfused"] = routing
    torch.cuda.empty_cache()

    # fp32 Grad-CAM and rollout of the whole model on the grouped engine
    cfg = grouped_engine(cfg_moe)
    depth = cfg.model.depth
    per_moe = tuple(i % 2 for i in range(depth))  # MoE MLPs in odd blocks
    from gavit_tpu_torch.utils.gradcam import attention_rollout

    maps = {}
    with PinnedRouting() as pinned:
        models, x, gradcam_counts = gradcam_vs_plain(
            cfg, weights_moe, dev, {"A": depth, "C": 2, "M fp32": depth // 2},
            {"A′ fp32": (1,) * depth, "M′ fp32": per_moe,
             "tgmm fp32": tuple(2 * m for m in per_moe)},
            "fp32_moe", "vit_b16_moe (grouped engine)", SEED + 13,
            pinned=pinned)
        for impl, model in models.items():
            (pinned.start_record if impl == "auto" else pinned.start_replay)()
            torch.cuda.synchronize()
            reset_counts()
            maps[impl] = {f: attention_rollout(model, x, f)[0]
                          for f in ("mean", "max")}
            torch.cuda.synchronize()
            counts = read_counts()
            # two forwards; the capture's attention is the plain one
            want = expected({"C": 4, "M fp32": 2 * (depth // 2)}
                            if impl == "auto" else {})
            if counts != want:
                raise AssertionError(f"rollout launches {counts}, expected "
                                     f"{want}")
    flips["gradcam and rollout"] = {"flips": list(pinned.flips),
                                    "choices": pinned.choices}
    err = max(float(abs(maps["auto"][f] - maps["reference"][f]).max())
              for f in ("mean", "max"))
    ok = err <= GRADCAM_TOL
    log(f"[fp32_moe] fp32 attention rollout (mean, max) of vit_b16_moe "
        f"over {GRADCAM_BATCH} images: kernels vs plain versions max |d| "
        f"{err:.3e} (tol {GRADCAM_TOL:.0e}) {'ok' if ok else 'FAIL'}; "
        f"launches C 4, M fp32 {2 * (depth // 2)}")
    if not ok:
        raise AssertionError("the MoE rollout through the kernels disagrees "
                             "with the plain versions")
    del models, x
    torch.cuda.empty_cache()
    log("[fp32_moe] expert choices the plain versions would have flipped "
        "without the kernels' (fp32): " + "; ".join(
            f"{k} {', '.join(map(str, v['flips']))} of {v['choices']}"
            for k, v in flips.items()))
    rows = moe_f32_times(dev, results, card)
    log(f"[fp32_moe] phase done in {time.perf_counter() - t0:.1f} s")
    return counts_fused, counts_unfused, gradcam_counts, rows


# ---------------------------------------------------------------------------
# the training run as a user starts it


def run_sets(save: str) -> list:
    """The run's overrides of configs/v5e8_dp.yaml: its global batch of
    1024 as DP_ACCUM micro-batches of 128, two epochs of two optimizer steps
    (a 2048-image synthetic set with learnable class stripes; its val set
    1024 images), checkpoints and logs under RUN_DIR/save, wandb off (its
    metrics go to the JSONL sink there)."""
    return [f"training.grad_accum_steps={DP_ACCUM}", "training.epochs=2",
            "training.warmup_epochs=1", f"training.seed={SEED}",
            "data.synthetic_size=2048", "data.synthetic_learnable=true",
            f"paths.save_dir={RUN_DIR / save}",
            f"paths.log_dir={RUN_DIR / save / 'logs'}", "wandb.mode=disabled"]


def run_args(save: str) -> list:
    """scripts/train_torch.py's arguments for the run."""
    return ["--config", str(CONFIG_DP), "--synthetic", "--device", RUN_DEVICE,
            *[a for kv in run_sets(save) for a in ("--set", kv)]]


@contextlib.contextmanager
def gated_cli(train_torch):
    """scripts/train_torch.py's main with the graph gates at GATE (zero at
    init would hide the graph branch)."""
    build = train_torch.build_trainer
    train_torch.build_trainer = functools.partial(build, gate=GATE)
    try:
        yield
    finally:
        train_torch.build_trainer = build


def train_state(trainer) -> dict:
    """Every parameter, λ and AdamW moment of a trainer, copied."""
    params = {**dict(trainer.model.named_parameters()),
              **{f"criterion.{n}": p
                 for n, p in trainer.criterion.named_parameters()}}
    st = trainer.optimizer.state
    out = {}
    for name, p in params.items():
        out[name] = p.detach().clone()
        out[f"{name} exp_avg"] = st[p]["exp_avg"].clone()
        out[f"{name} exp_avg_sq"] = st[p]["exp_avg_sq"].clone()
    return out


def state_diff(a: dict, b: dict):
    """(largest |a - b| over every tensor, the five tensors that differ
    most)."""
    diffs = sorted(((max_err(a[k], b[k]), k) for k in a), reverse=True)
    return diffs[0][0], [(k, v) for v, k in diffs[:5] if v > 0]


def steps_spread(cfg, dataset, dev, train_torch):
    """Two identical runs of two steps of ``cfg`` from one start on the
    first batch of ``dataset``: (their largest difference over every
    parameter and moment, 0 where the step reruns bit for bit; the tensors
    it is in)."""
    import torch

    images, labels = (torch.from_numpy(a) for a in next(
        train_torch.batches(dataset, cfg.data.batch_size, SEED)))
    states = []
    for _ in range(2):
        tr = train_torch.build_trainer(cfg, dataset, dev, gate=GATE)
        tr.train_step(images, labels)
        tr.train_step(images, labels)
        states.append(train_state(tr))
        del tr
    return state_diff(*states)


def rerun_spread(dev, train_torch) -> float:
    """Two identical accumulated steps (the run's shape: b1024 as 8 x 128)
    from one start on one batch: their largest difference over every
    parameter and moment, 0 where the step reruns bit for bit. A nonzero
    spread names the tensors it is in."""
    from gavit_tpu_torch import load_config

    cfg = load_config(str(CONFIG_DP), run_sets("rerun"))
    spread, where = steps_spread(cfg, train_torch.create_dataset(cfg), dev,
                                 train_torch)
    log(f"[run] two identical accumulated steps (b1024 as {DP_ACCUM} x 128) "
        f"from one start: " + ("bit-equal" if spread == 0 else
                              f"NOT bit-equal: largest difference {spread:.3e}"
                              f" in {where}; resume is held to that spread"))
    return spread


def check_run_counts(counts, depth, steps, vals, accum=DP_ACCUM, tag="run"):
    """The run's launches: per optimizer step ``accum`` micro-batches of the
    224-px b128 step, per validation batch one forward."""
    micro = steps * accum
    want = expected({"A": depth * (micro + vals), "A′": depth * micro,
                     "B": depth * vals, "C": 2 * (micro + vals),
                     "D": depth * micro, "D′": depth * micro,
                     "F": 2 * (1 + depth + 2) * micro})
    log(f"[{tag}] kernel launches in the run: "
        + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")


def phase_accumulated_steps(dev, depth):
    """One accumulated step through the kernels against the plain versions
    from the same state, at the micro-batches the routes switch on: 2 x
    b128 and 2 x b64 (D/D′ at M = 25216 and 12608), 8 x b16 (M = 3152: the
    chain of H/H′ and F)."""
    fused = {"A": depth, "A′": depth, "C": 2, "D": depth, "D′": depth,
             "F": 2 * (1 + depth + 2)}
    chain = {"A": depth, "A′": depth, "C": 2, "H": depth, "H′": depth,
             "F": 2 * (1 + 2 * depth + 2)}
    for batch, accum, per in ((256, 2, fused), (128, 2, fused),
                              (128, 8, chain)):
        phase_train(train_config([f"data.batch_size={batch}",
                                  f"training.grad_accum_steps={accum}"]),
                    dev, f"vit_b16_graph2 accum {accum} x b{batch // accum}",
                    {k: v * accum for k, v in per.items()},
                    steps_compare=1, steps_learn=0, count_step=0)


def phase_pretrained(dev, depth, card):
    """A reference-layout .pth written from a 224-px port model, loaded as
    finetune_384's model.pretrained_path through scripts/train_torch.py's
    build_trainer: the position embeddings go 14 → 24 as
    ``interpolate_pos_embed`` gives them, every other entry of the file
    that the 384-px model has is the file's, the head keeps its init;
    then 3 steps (K, K′, H, H′, F) lower the held loss (K and B)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import train_torch
    from gavit_tpu_torch import load_config
    from gavit_tpu_torch.models.vit import build_model, init_params
    from gavit_tpu_torch.utils.convert import flatten_tree, to_flax_tree
    from gavit_tpu_torch.utils.torch_convert import (
        interpolate_pos_embed, params_to_torch_state_dict,
        torch_state_dict_to_params)

    src = init_params(build_model(load_config(str(CONFIG)).model),
                      torch.Generator().manual_seed(SEED + 7))
    with torch.no_grad():
        for gb in src.graphs:
            gb.gate.fill_(GATE)
    sd = params_to_torch_state_dict(src)
    path = RUN_DIR / "mae_224.pth"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    # a fine-tune's small lr from the first step on: at 1e-4 the first two
    # AdamW updates of the loaded weights raised the loss (PR 16)
    cfg = train_config_384([f"model.pretrained_path={path}",
                            "training.warmup_epochs=0",
                            "training.learning_rate=1e-5"])
    dataset = train_torch.create_dataset(cfg)
    tr = train_torch.build_trainer(cfg, dataset, dev)
    got = flatten_tree(to_flax_tree(tr.model))
    want = flatten_tree(torch_state_dict_to_params(sd, depth))
    same = [k for k in want if k in got and k not in ("pos_embed", "head/kernel",
                                                      "head/bias")]
    pos = interpolate_pos_embed(sd["pos_embed"], cfg.model.num_patches)
    fresh = init_params(build_model(cfg.model),
                        torch.Generator().manual_seed(cfg.training.seed))
    ok = (all(np.array_equal(got[k], want[k]) for k in same)
          and np.array_equal(got["pos_embed"], pos.numpy())
          and tuple(pos.shape) == (1, cfg.model.num_patches + 1,
                                   cfg.model.embed_dim)
          and torch.equal(tr.model.head.weight.cpu(), fresh.head.weight)
          and not np.array_equal(got["head/kernel"], want["head/kernel"]))
    log(f"[run] finetune_384 from a reference-layout .pth of a 224-px "
        f"model: {len(same)} entries the file's, pos_embed "
        f"{tuple(sd['pos_embed'].shape)} -> {tuple(pos.shape)}, head kept fresh, {len(want) - len(same) - 3} "
        f"entries of the file not in the model skipped "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the pretrained weights did not load as the "
                             "file holds them")
    data = list(itertools.islice(train_torch.batches(
        dataset, cfg.data.batch_size, SEED), 3))
    before = held_loss(tr, data)
    counts = None
    for i, (images, labels) in enumerate(data):
        if i == 1:
            torch.cuda.synchronize()
            reset_counts()
        tr.train_step(torch.from_numpy(images), torch.from_numpy(labels))
        if i == 1:
            torch.cuda.synchronize()
            counts = read_counts()
    after = held_loss(tr, data)
    want_counts = expected({"K": depth, "K′": depth, "H": depth, "H′": depth,
                            "F": 2 * (1 + 2 * depth + 1)})
    ok = after < before and counts == want_counts
    log(f"[run] finetune_384 from it, 3 steps at b16 (K, K′, H, H′, F: "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        + f"): held loss {before:.5f} -> {after:.5f} "
        f"{'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError("the fine-tune from pretrained weights did not "
                             "lower the loss or missed a kernel")


def phase_static_graph(dev, depth):
    """vit_b16_graph2 with graph.dynamic false: one adjacency built by the
    first graph block in tensor ops, reused by the second (no kernel C);
    the forward through the kernels against the plain versions, then the
    step (2 compared) and 10 steps that lower the loss."""
    from gavit_tpu_torch import load_config

    cfg = load_config(str(CONFIG), ["model.graph.dynamic=false"])
    phase_slice(cfg, gated_weights(cfg), dev, "vit_b16_graph2 static graph",
                n_images=8, expect={"A": depth, "B": depth})
    phase_train(train_config(["model.graph.dynamic=false",
                              "data.batch_size=32", "data.synthetic_size=160"]),
                dev, "vit_b16_graph2 static graph",
                {"A": depth, "A′": depth, "D": depth, "D′": depth,
                 "F": 2 * (1 + depth + 2)}, steps_compare=2, steps_learn=10)


def phase_run(dev, card):
    """The training run as a user starts it, through scripts/train_torch.py's
    and scripts/evaluate_torch.py's mains: configs/v5e8_dp.yaml at global
    batch 1024 as 8 x 128 (epochs, validation at b1024, the metric battery,
    best-AUC checkpoints), its launches; validate's probabilities at b1024
    and a ragged tail of 100 against the plain forward; --resume auto from
    the epoch-1 checkpoint against the uninterrupted run, bit for bit (or
    to the rerun's own spread); a SIGTERM mid-epoch and its resume; then
    the 224-px → 384-px pretrained load, the static graph and the
    evaluation. The checkpoints are removed at the end."""
    import os
    import shutil
    import signal

    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import evaluate_torch
    import train_torch
    from gavit_tpu_torch.data.dataset import SyntheticChestXrayDataset
    from gavit_tpu_torch.data.loader import DataLoader
    from gavit_tpu_torch.training import trainer as trainer_mod
    from gavit_tpu_torch.utils import checkpoint as ckpt_lib

    from gavit_tpu_torch import load_config

    shutil.rmtree(RUN_DIR, ignore_errors=True)
    depth = load_config(str(CONFIG_DP)).model.depth
    t_phase = time.perf_counter()
    phase_accumulated_steps(dev, depth)
    spread = rerun_spread(dev, train_torch)

    # the run, uninterrupted: counts zeroed just before, read just after
    with gated_cli(train_torch):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        straight = train_torch.main(run_args("straight"))
        torch.cuda.synchronize()
        counts = read_counts()
        wall = time.perf_counter() - t0
    hist = straight.train_metrics_history
    check_run_counts(counts, depth, steps=4, vals=2)
    for e, (m, v) in enumerate(zip(hist, straight.val_metrics_history)):
        log(f"[run] v5e8_dp epoch {e + 1}: b1024 as {DP_ACCUM} x 128, "
            f"{m['images_per_sec']:.1f} train images/s, train loss "
            f"{m['loss']:.5f}, val loss {v['loss']:.5f}, val mean AUC "
            f"{v['mean_auc']:.4f} ({card})")
    if len(hist) != 2 or straight.step != 4 or not all(
            math.isfinite(m["loss"]) for m in hist):
        raise AssertionError(f"the run took {straight.step} steps over "
                             f"{len(hist)} epochs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    straight.validate()
    dt = time.perf_counter() - t0
    n_val = len(straight.val_loader.dataset)
    log(f"[run] validate: {n_val} images at b1024 in {dt * 1e3:.1f} ms, "
        f"{n_val / dt:.1f} images/s, the metric battery included ({card}); "
        f"the whole run {wall:.1f} s")

    # validate's forward at b1024 and a ragged tail against the plain one
    bs, size = straight.config.data.batch_size, straight.config.data.image_size
    n_tokens = straight.config.model.num_patches + 1
    val = DataLoader(SyntheticChestXrayDataset(
        size=bs + 100, image_size=size, seed=SEED + 1, learnable=True), bs)
    plain = train_torch.build_trainer(straight.config,
                                      straight.train_loader.dataset, dev,
                                      impl="reference")
    plain.model.load_state_dict(straight.model.state_dict())
    plain.criterion.load_state_dict(straight.criterion.state_dict())
    probs, _, loss = straight.predict(val)
    want, _, want_loss = plain.predict(val)
    err = max_err(probs, want)
    ok = probs.shape == (bs + 100, 14) and err <= PROB_TOL and bool(
        torch.isfinite(loss).all())
    log(f"[run] predict at b{bs} plus a tail of 100 (M = {bs * n_tokens} and "
        f"{100 * n_tokens} rows through B): kernels vs plain versions max "
        f"|dp| {err:.3e} "
        f"(tol {PROB_TOL:.0e}), mean loss {loss.mean().item():.5f} vs "
        f"{want_loss.mean().item():.5f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("validation through the kernels disagrees with "
                             "the plain versions")
    del plain

    # resume: the uninterrupted run's epoch-1 checkpoint, --resume auto
    [first] = [p for p in (RUN_DIR / "straight").iterdir()
               if p.name.startswith("checkpoint_epoch_0_auc_")]
    shutil.copytree(first, RUN_DIR / "resumed" / first.name)
    with gated_cli(train_torch):
        resumed = train_torch.main(run_args("resumed") + ["--resume", "auto"])
    worst, where = state_diff(train_state(straight), train_state(resumed))
    gen_same = torch.equal(straight.generator.get_state(),
                           resumed.generator.get_state())
    ok = (resumed.step == straight.step and worst <= spread and gen_same
          and len(resumed.train_metrics_history) == 1)
    log(f"[run] --resume auto from {first.name} in a fresh Trainer, then "
        f"epoch 2: parameters, λ and AdamW moments vs the uninterrupted run "
        f"largest |d| {worst:.3e} (held to the rerun spread {spread:.3e}"
        f"{'; bit-equal' if worst == 0 else f'; at {where}'}), generator "
        f"{'equal' if gen_same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the resumed run does not continue the "
                             "uninterrupted one")
    del resumed

    # preemption: SIGTERM after the first step of epoch 2
    step = trainer_mod.Trainer._step
    sent = []

    def step_then_sigterm(self, images, labels):
        out = step(self, images, labels)
        if self.current_epoch == 1 and not sent:
            sent.append(self.step)
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer_mod.Trainer._step = step_then_sigterm
    try:
        with gated_cli(train_torch):
            pre = train_torch.main(run_args("preempted"))
    finally:
        trainer_mod.Trainer._step = step
    latest = ckpt_lib.latest_checkpoint(str(RUN_DIR / "preempted"))
    _, meta = ckpt_lib.restore(latest)
    with gated_cli(train_torch):
        after = train_torch.main(run_args("preempted") + ["--resume", "auto"])
    # the loader's position is saved with it: the resume trains epoch 2's
    # one unseen step
    ok = (sent == [3] and pre.step == 3 and meta["epoch_completed"] is False
          and meta["next_epoch"] == 1 and meta.get("has_loader_state")
          and after.step == 4 and after.current_epoch == 1
          and len(after.train_metrics_history) == 1)
    log(f"[run] SIGTERM after step {sent} (epoch 2 of 2): the run stopped "
        f"at step {pre.step} and saved {os.path.basename(latest)} (epoch "
        f"completed: {meta['epoch_completed']}, loader position: "
        f"{bool(meta.get('has_loader_state'))}); --resume auto trained the "
        f"rest of epoch 2 to step {after.step} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the preempted run did not save and resume")
    del pre, after

    # evaluate the best checkpoint
    torch.cuda.synchronize()
    reset_counts()
    res = evaluate_torch.main([
        "--config", str(CONFIG_DP), "--checkpoint",
        str(RUN_DIR / "straight" / "best_model"), "--dataset", "synthetic",
        "--set", "data.synthetic_size=512",
        "--set", f"paths.save_dir={RUN_DIR / 'eval'}", "--device",
        RUN_DEVICE])
    torch.cuda.synchronize()
    ev = read_counts()
    on_disk = json.loads((RUN_DIR / "eval" / "evaluation" /
                          "evaluation_results.json").read_text())
    # the eval forward, then the Predictor's two buckets (1 + 50 one-image
    # calls, 1 + 10 calls of 64 images in the b128 bucket): each bucket's
    # first call runs it eagerly and captures it, the rest are replays
    calls = 1 + (1 + 1) + (1 + 1)
    ok = (math.isfinite(on_disk["metrics"]["mean_auc"])
          and on_disk["p50_single_image_latency_ms"] > 0
          and "confidence_intervals" in on_disk
          and ev == expected({"A": depth * calls, "B": depth * calls,
                              "C": 2 * calls}))
    log(f"[run] evaluate_torch on best_model: 512 images, mean AUC "
        f"{res['metrics']['mean_auc']:.4f}, p50 one image "
        f"{res['p50_single_image_latency_ms']:.3f} ms ({card}); launches A "
        f"{ev['A']}, B {ev['B']}, C {ev['C']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the evaluation wrote no finite result")
    del straight

    phase_pretrained(dev, depth, card)
    phase_static_graph(dev, depth)
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    log(f"[run] the run phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def write_corpus(root: Path, n: int, seed: int, side: int):
    """``n`` grayscale ``side`` x ``side`` 8-bit PNGs (NIH ChestX-ray14's
    format) under ``root/images`` and their label file in the reference
    format (a file name, then 14 labels; every class two-valued), written
    on a thread pool at PNG compress level 1. Each image is a smooth field
    (a 16 x 16 grid of random greys resized by PIL's BICUBIC) plus 0-3
    grey levels of noise: neither constant nor noise, so that its decode
    costs what a radiograph's does. Returns (image dir, label file)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    img_dir = root / "images"
    img_dir.mkdir(parents=True)
    labels = (np.random.default_rng(seed).random((n, 14)) < 0.3).astype(
        np.float32)
    labels[0], labels[1] = 1.0, 0.0
    names = [f"{seed:03d}_{i:05d}.png" for i in range(n)]

    def write(i):
        r = np.random.default_rng((seed, i))
        field = Image.fromarray(r.integers(0, 256, (16, 16), np.uint8))
        img = (np.asarray(field.resize((side, side), Image.BICUBIC),
                          np.int16) + r.integers(0, 4, (side, side), np.int16))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            img_dir / names[i], compress_level=1)

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(write, range(n)))
    label_file = root / "labels.txt"
    label_file.write_text("".join(
        name + " " + " ".join(f"{v:.0f}" for v in row) + "\n"
        for name, row in zip(names, labels)))
    return img_dir, label_file


def loader_rates(train_dir: Path, train_labels: Path, packed, size: int,
                 card: str) -> str:
    """A line of the threaded loader's images/s alone at b TRAIN_BATCH: over
    the DATA_TRAIN train PNGs (decoded and resized to ``size``) at 4, 8
    and 16 decode threads, each a fresh loader, and over the packed split
    ``packed``; ``os.cpu_count()`` beside them. Also run in a process of
    its own by tools/time_loader_torch.py."""
    import os

    from gavit_tpu_torch.data.dataset import ChestXrayDataset
    from gavit_tpu_torch.data.loader import DataLoader

    rates = []
    raw = ChestXrayDataset(str(train_dir), str(train_labels), size)
    for n_threads in (4, 8, 16):
        loader = DataLoader(raw, TRAIN_BATCH, shuffle=True,
                            num_workers=n_threads)
        t0 = time.perf_counter()
        n = sum(len(b[1]) for b in loader)
        rates.append(f"{n_threads} threads {n / (time.perf_counter() - t0):.1f}")
    t0 = time.perf_counter()
    n = sum(len(b[1]) for b in DataLoader(packed, TRAIN_BATCH, shuffle=True))
    return (f"[data] the threaded loader alone at b{TRAIN_BATCH}, images/s "
            f"over {len(raw)} train PNGs at " + ", ".join(rates) + "; over "
            f"the {len(packed)}-image packed split (warm page cache) "
            f"{n / (time.perf_counter() - t0):.1f}; os.cpu_count() "
            f"{os.cpu_count()} ({card})")


def data_sets(save: str, packed: Path, train_labels: Path, val_dir: Path,
              val_labels: Path, workers: int) -> list:
    """The data phase's overrides of configs/vit_b16_graph2.yaml: b128 from
    files (the packed train split, the PNG val split decoded on
    ``workers`` threads), RandomAffine on, the checkpointable loader, 2
    epochs (8 steps each: 1024 images, drop_last), a warmup of one epoch,
    checkpoints under DATA_DIR/save, wandb off."""
    return [f"data.batch_size={TRAIN_BATCH}", "training.epochs=2",
            "training.warmup_epochs=1", f"training.seed={SEED}",
            "data.augment_affine=true", "data.loader=grain",
            f"data.num_workers={workers}", f"data.train_dir={packed}",
            f"data.train_labels={train_labels}", f"data.val_dir={val_dir}",
            f"data.val_labels={val_labels}",
            f"paths.save_dir={DATA_DIR / save}",
            f"paths.log_dir={DATA_DIR / save / 'logs'}", "wandb.mode=disabled"]


def phase_data(dev, card):
    """Training and evaluation from image files at full width, through the
    CLIs' mains: a PNG corpus of NIH's format written from SEED, the train
    split packed by scripts/prepare_dataset_torch.py (3 rows held to the
    PNGs' decode), vit_b16_graph2 at b128 with RandomAffine through the
    checkpointable loader (images/s an epoch, the step's wait on the
    loader, validate over the decoded val PNGs, its launches), SIGTERM
    after step 3 and ``--resume auto`` (each epoch-0 sample trained once,
    the end state the uninterrupted run's), the affine preprocess on the
    card against the CPU and its cost, the threaded loader's images/s on
    PNGs and on the pack, and evaluate_torch on ``--dataset nih`` and
    ``chexpert``. The corpus is removed at the end."""
    import hashlib
    import os
    import shutil
    import signal

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import evaluate_torch
    import prepare_dataset_torch
    import train_torch
    from gavit_tpu_torch import load_config
    from gavit_tpu_torch.data.dataset import (ChestXrayDataset,
                                              PackedChestXrayDataset)
    from gavit_tpu_torch.ops.preprocess import (affine_draws,
                                                train_preprocess_with)
    from gavit_tpu_torch.training import trainer as trainer_mod
    from gavit_tpu_torch.utils import checkpoint as ckpt_lib

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    workers = os.cpu_count()
    size = load_config(str(CONFIG)).data.image_size
    depth = load_config(str(CONFIG)).model.depth

    t0 = time.perf_counter()
    train_dir, train_labels = write_corpus(DATA_DIR / "train", DATA_TRAIN,
                                           SEED, DATA_PNG)
    val_dir, val_labels = write_corpus(DATA_DIR / "val", DATA_VAL, SEED + 1,
                                       DATA_PNG)
    dt = time.perf_counter() - t0
    mb = sum(f.stat().st_size for d in (train_dir, val_dir)
             for f in d.iterdir()) / 1e6
    log(f"[data] wrote {DATA_TRAIN} train and {DATA_VAL} val grayscale "
        f"{DATA_PNG}x{DATA_PNG} PNGs ({mb:.1f} MB) on {workers} threads in "
        f"{dt:.2f} s")

    packed_dir = DATA_DIR / "packed"
    t0 = time.perf_counter()
    prepare_dataset_torch.main(["--image-dir", str(train_dir), "--labels",
                                str(train_labels), "--out", str(packed_dir),
                                "--image-size", str(size), "--workers",
                                str(workers)])
    dt = time.perf_counter() - t0
    packed = PackedChestXrayDataset(str(packed_dir))
    raw = ChestXrayDataset(str(train_dir), str(train_labels), size)
    rows = (0, DATA_TRAIN // 2, DATA_TRAIN - 1)
    ok = (packed.images.shape == (DATA_TRAIN, size, size, 3)
          and all(np.array_equal(packed[i][0], raw[i][0])
                  and np.array_equal(packed[i][1], raw[i][1]) for i in rows))
    log(f"[data] packed the train split at {size} px with "
        f"scripts/prepare_dataset_torch.py on {workers} threads: "
        f"{DATA_TRAIN / dt:.1f} images/s ({dt:.2f} s, "
        f"{packed.images.nbytes / 1e6:.1f} MB of memmap); rows {rows} "
        f"bit-equal to the PNGs' decode {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the packed split differs from the PNGs")

    # the run, uninterrupted: counts zeroed just before, read just after
    sets = functools.partial(data_sets, packed=packed_dir,
                             train_labels=train_labels, val_dir=val_dir,
                             val_labels=val_labels, workers=workers)

    def args(save):
        return ["--config", str(CONFIG), "--device", RUN_DEVICE,
                *[a for kv in sets(save) for a in ("--set", kv)]]

    with gated_cli(train_torch):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        straight = train_torch.main(args("straight"))
        torch.cuda.synchronize()
        counts = read_counts()
        wall = time.perf_counter() - t0
    steps = DATA_TRAIN // TRAIN_BATCH
    hist = straight.train_metrics_history
    vals = len(straight.val_metrics_history) * -(-DATA_VAL // TRAIN_BATCH)
    check_run_counts(counts, depth, steps=2 * steps, vals=vals, accum=1,
                     tag="data")
    for e, (m, v) in enumerate(zip(hist, straight.val_metrics_history)):
        log(f"[data] vit_b16_graph2 from the packed split, RandomAffine, "
            f"checkpointable loader, epoch {e + 1}: b{TRAIN_BATCH}, "
            f"{m['images_per_sec']:.1f} train images/s, the step waited "
            f"{m['loader_wait_ms']:.3f} ms a step on the loader; train loss "
            f"{m['loss']:.5f}, val loss {v['loss']:.5f} over {DATA_VAL} "
            f"PNGs ({card})")
    if len(hist) != 2 or straight.step != 2 * steps or not all(
            math.isfinite(m["loss"]) for m in hist):
        raise AssertionError(f"the data run took {straight.step} steps over "
                             f"{len(hist)} epochs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    straight.validate()
    dt = time.perf_counter() - t0
    log(f"[data] validate: {DATA_VAL} {DATA_PNG}x{DATA_PNG} PNGs decoded on "
        f"{workers} threads at b{TRAIN_BATCH} in {dt * 1e3:.1f} ms, "
        f"{DATA_VAL / dt:.1f} images/s, the metric battery included "
        f"({card}); the whole run {wall:.1f} s")

    # SIGTERM after step 3 and --resume auto: every epoch-0 sample once
    spread, where = steps_spread(load_config(str(CONFIG), sets("rerun")),
                                 packed, dev, train_torch)
    log(f"[data] two identical b{TRAIN_BATCH} steps with RandomAffine from "
        f"one start: " + ("bit-equal" if spread == 0 else
                          f"largest difference {spread:.3e} in {where}"))
    id_of = {hashlib.blake2b(packed.images[i].tobytes(),
                             digest_size=16).digest(): i
             for i in range(DATA_TRAIN)}
    seen = {0: [], 1: []}  # run → (epoch, sample) of each trained image
    step = trainer_mod.Trainer._step
    sent = []

    def record_step(self, images, labels):
        run = 0 if not sent else 1
        for row in images.cpu().numpy():
            key = hashlib.blake2b(row.tobytes(), digest_size=16).digest()
            seen[run].append((self.current_epoch, id_of[key]))
        out = step(self, images, labels)
        if not sent and self.step == 3:
            sent.append(self.step)
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer_mod.Trainer._step = record_step
    try:
        with gated_cli(train_torch):
            pre = train_torch.main(args("preempted"))
            latest = ckpt_lib.latest_checkpoint(str(DATA_DIR / "preempted"))
            _, meta = ckpt_lib.restore(latest)
            after = train_torch.main(args("preempted") + ["--resume", "auto"])
    finally:
        trainer_mod.Trainer._step = step
    epoch0 = sorted(i for run in seen.values() for e, i in run if e == 0)
    worst, where = state_diff(train_state(straight), train_state(after))
    gen_same = torch.equal(straight.generator.get_state(),
                           after.generator.get_state())
    ok = (sent == [3] and pre.step == 3 and meta["epoch_completed"] is False
          and meta.get("has_loader_state") is True
          and len(seen[0]) == 3 * TRAIN_BATCH
          and epoch0 == list(range(DATA_TRAIN))
          and after.step == straight.step and worst <= spread and gen_same)
    log(f"[data] SIGTERM after step {sent}: saved {os.path.basename(latest)} "
        f"with the loader's position (has_loader_state "
        f"{meta.get('has_loader_state')}); --resume auto trained "
        f"{sum(e == 0 for e, _ in seen[1])} more samples of epoch 1, and the "
        f"two runs trained each of its {DATA_TRAIN} samples "
        f"{'exactly once' if epoch0 == list(range(DATA_TRAIN)) else 'NOT once'}"
        f"; then epoch 2 to step {after.step}: parameters, λ and AdamW "
        f"moments vs the uninterrupted run largest |d| {worst:.3e} (held to "
        f"the rerun spread {spread:.3e}"
        f"{'; bit-equal' if worst == 0 else f'; at {where}'}), generator "
        f"{'equal' if gen_same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the mid-epoch resume did not continue on the "
                             "next unseen sample")
    del pre, after

    # the affine preprocess on the card against the CPU, and its cost
    images = torch.from_numpy(packed.batch(np.arange(TRAIN_BATCH))[0])
    g = torch.Generator().manual_seed(SEED)
    draws = (torch.rand(TRAIN_BATCH, generator=g) < 0.5,
             0.8 + 0.4 * torch.rand(TRAIN_BATCH, generator=g),
             0.8 + 0.4 * torch.rand(TRAIN_BATCH, generator=g),
             *affine_draws(TRAIN_BATCH, g, "cpu"))
    want = train_preprocess_with(images, *draws)
    x = images.to(dev)
    on_dev = [d.to(dev) for d in draws]
    err = max_err(train_preprocess_with(x, *on_dev).cpu(), want)
    with_affine = cuda_ms(lambda: train_preprocess_with(x, *on_dev))
    without = cuda_ms(lambda: train_preprocess_with(x, *on_dev[:3]))
    ok = err <= AFFINE_TOL
    log(f"[data] train_preprocess_with at b{TRAIN_BATCH} x {size}^2 on the "
        f"card vs the CPU, the same batch and draws: max |d| {err:.3e} (tol "
        f"{AFFINE_TOL:.0e}) {'ok' if ok else 'FAIL'}; {with_affine:.4f} ms "
        f"with RandomAffine, {without:.4f} ms without (median of 20, CUDA "
        f"events; {card})")
    if not ok:
        raise AssertionError("the affine preprocess on the card disagrees "
                             "with the CPU")

    # the threaded loader alone: the train PNGs at 4, 8, 16 decode threads;
    # the packed train split
    log(loader_rates(train_dir, train_labels, packed, size, card))

    # evaluate_torch on the val PNGs as the NIH and the CheXpert split
    best = DATA_DIR / "straight" / "best_model"
    for name in ("nih", "chexpert"):
        res = evaluate_torch.main([
            "--config", str(CONFIG), "--checkpoint", str(best), "--dataset",
            name, "--set", f"data.val_dir={val_dir}", "--set",
            f"data.val_labels={val_labels}", "--set",
            f"data.chexpert_dir={val_dir}", "--set",
            f"data.chexpert_labels={val_labels}", "--set",
            f"data.batch_size={TRAIN_BATCH}", "--set",
            f"data.num_workers={workers}", "--set",
            f"paths.save_dir={DATA_DIR / ('eval_' + name)}", "--device",
            RUN_DEVICE])
        on_disk = json.loads((DATA_DIR / f"eval_{name}" / "evaluation" /
                              "evaluation_results.json").read_text())
        auc = on_disk["metrics"]["mean_auc"]
        ok = math.isfinite(auc) and auc == res["metrics"]["mean_auc"]
        log(f"[data] evaluate_torch --dataset {name} on {DATA_VAL} PNGs: "
            f"mean AUC {auc:.4f}, p50 one image "
            f"{res['p50_single_image_latency_ms']:.3f} ms ({card}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"evaluate_torch --dataset {name} wrote no "
                                 "finite mean AUC")
    del straight
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    log(f"[data] the data phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# MAE pretraining: ViT-B/16 at 224 px with the 512 x 4 x 8 decoder, mask
# 0.75, bf16, b256 (scripts/pretrain_mae_torch.py)
# ---------------------------------------------------------------------------


def mae_config(overrides=()):
    """vit_b16_graph2's ViT-B/16 at b256 over a 1280-image synthetic set
    with learnable class stripes (5 steps an epoch, a warmup of 5 steps)."""
    from gavit_tpu_torch import load_config

    return load_config(str(CONFIG), [
        f"data.batch_size={MAE_BATCH}", f"data.synthetic_size={5 * MAE_BATCH}",
        "data.synthetic_learnable=true", "training.warmup_epochs=1",
        f"training.seed={SEED}", *overrides])


def mae_shapes(cfg):
    """((what, batch, tokens, heads, dim, hidden), ...) of the MAE step's
    encoder (CLS + the visible patches) and decoder (every token)."""
    m = cfg.model
    n = m.num_patches
    keep = max(1, int(round(n * (1.0 - MAE_MASK))))
    dec_dim, _, dec_heads = MAE_DECODER
    hidden = int(m.embed_dim * m.mlp_ratio)
    return (("encoder", MAE_BATCH, keep + 1, m.num_heads, m.embed_dim, hidden),
            ("decoder", MAE_BATCH, n + 1, dec_heads, dec_dim,
             int(dec_dim * m.mlp_ratio)))


def mae_held_loss(pre, batches) -> float:
    """The MAE loss of ``pre``'s model over ``batches`` on the validation
    preprocessing and fixed noise (SEED + 30): the same number for the same
    weights."""
    import torch

    from gavit_tpu_torch.models.mae import mae_loss
    from gavit_tpu_torch.ops.preprocess import val_preprocess

    g = torch.Generator(device=pre.device).manual_seed(SEED + 30)
    total = 0.0
    with torch.no_grad():
        for images, _ in batches:
            x = val_preprocess(torch.from_numpy(images).to(pre.device))
            noise = torch.rand((x.shape[0], pre.config.model.num_patches),
                               generator=g, device=pre.device)
            pred, mask = pre.model(x, noise)
            total += mae_loss(pred, x, mask,
                              pre.config.model.patch_size).item()
    return total / len(batches)


def check_mae_kernels(dev, results, shapes):
    """A, A′ and B at the MAE step's shapes against their plain versions
    (A and B within ATTN_TOL / MLP_TOL, A′ within GRAD_REL_TOL of the
    largest gradient), and B's gradient, the chain's VJP behind
    ``fused_mlp_inference``, against autograd through the plain chain
    (GRAD_REL_TOL), every one nonzero. Returns the inputs, for the
    times."""
    import torch

    from gavit_tpu_torch.ops import attention as A
    from gavit_tpu_torch.ops import mlp as M

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    cases = {}
    for what, b, n, h, d, f in shapes:
        scale = HEAD_DIM ** -0.5
        qkv = torch.randn(b, n, 3 * h * HEAD_DIM, device=dev,
                          generator=g).to(bf)
        do = torch.randn(b, n, h, HEAD_DIM, device=dev,
                         generator=g).to(bf).transpose(1, 2)
        out = A.qkv_attention_kernel(qkv, scale, h)
        want = A.attention_reference(*A._split_heads(qkv, h), scale)
        err = max_err(out, want)
        check(f"A attention (MAE {what})", err <= ATTN_TOL["bf16"]
              and torch.isfinite(out).all().item(),
              f"bf16 B={b} N={n} H={h}: max_abs_err {err:.3e} (tol "
              f"{ATTN_TOL['bf16']:.0e})")
        results["A"]["errs"].append(err)
        dq = A.qkv_attention_bwd_kernel(qkv, do, scale, h)
        dq_want = A.attention_backward_reference(qkv, do, scale, h)
        rel, err = rel_err(dq, dq_want), max_err(dq, dq_want)
        check(f"A′ attention bwd (MAE {what})", rel <= GRAD_REL_TOL
              and torch.isfinite(dq).all().item(),
              f"bf16 B={b} N={n} H={h}: dqkv rel to max {rel:.3e} (tol "
              f"{GRAD_REL_TOL:.0e}), max_abs_err {err:.3e}")
        results["A′"]["errs"].append(err)

        m = b * n
        args = mlp_inputs(dev, m, d, f)
        y = M.mlp_inference_kernel(*args, True)
        err = max_err(y, M._chain_infer(*args, True))
        check(f"B mlp (MAE {what})", err <= MLP_TOL
              and torch.isfinite(y).all().item(),
              f"bf16 tanh M={m} D={d} F={f}: max_abs_err {err:.3e} (tol "
              f"{MLP_TOL:.0e})")
        results["B"]["errs"].append(err)
        dy = torch.randn(m, d, device=dev, generator=g).to(bf)
        grads = {}
        for what_, fn in (("kernel", M.fused_mlp_inference),
                          ("plain", lambda *a: M._chain_infer(*a, True))):
            leaves = [t.detach().clone().requires_grad_(True) for t in args]
            fn(*leaves).backward(dy)
            grads[what_] = [t.grad for t in leaves]
        rels = [rel_err(a, w) for a, w in zip(*grads.values())]
        nonzero = all(a.abs().max().item() > 0 for a in grads["kernel"])
        check(f"B mlp backward (MAE {what})",
              max(rels) <= GRAD_REL_TOL and nonzero,
              f"M={m} D={d} F={f}, kernel B and the chain's VJP against "
              f"autograd through the plain chain: dx, dW1, db1, dW2, db2 "
              f"rel to max "
              + ", ".join(f"{r:.3e}" for r in rels)
              + f" (tol {GRAD_REL_TOL:.0e}), each nonzero {nonzero}")
        cases[what] = (qkv, do, args, dy)
    return cases


def mae_times(dev, results, shapes, cases, card) -> dict:
    """A, A′ and B alone at the MAE step's shapes (per call, and alone on
    the device: 20 launches between two events) beside their plain
    versions, their bounds and their library calls (sdpa's forward, its
    forward and backward; the bf16 cuBLAS chain), and B's backward (the
    chain's VJP) beside the chain's own autograd; ``{key: {what: row}}``."""
    import torch
    import torch.nn.functional as F

    from gavit_tpu_torch.ops import attention as A
    from gavit_tpu_torch.ops import mlp as M

    out = {"A": {}, "A′": {}, "B": {}}
    for what, b, n, h, d, f in shapes:
        qkv, do, args, dy = cases[what]
        scale = HEAD_DIM ** -0.5
        q, k, v = (t.detach().clone().requires_grad_(True)
                   for t in A._split_heads(qkv, h))
        do_c = do.contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (q, k, v), do_c)

        shape = f"bf16 b{b} N={n} H={h}"
        rows = {
            "A": (lambda: A.qkv_attention_kernel(qkv, scale, h),
                  lambda: A.attention_reference(*A._split_heads(qkv, h),
                                                scale),
                  sdpa, bound(4 * b * h * n * n * HEAD_DIM,
                              4 * b * n * h * HEAD_DIM * 2)),
            "A′": (lambda: A.qkv_attention_bwd_kernel(qkv, do, scale, h),
                   lambda: A.attention_backward_reference(qkv, do, scale, h),
                   sdpa_fwd_bwd, bound(10 * b * h * n * n * HEAD_DIM,
                                       7 * b * n * h * HEAD_DIM * 2))}
        x, w1, b1, w2, b2 = args
        m = b * n
        rows["B"] = (
            lambda: M.mlp_inference_kernel(*args, True),
            lambda: M._chain_infer(*args, True),
            lambda: F.linear(F.gelu(F.linear(x, w1, b1), approximate="tanh"),
                             w2, b2),
            bound(4 * m * d * f, (2 * m * d + 2 * d * f + f + d) * 2))
        for key, (kern, plain, lib, (bms, by)) in rows.items():
            row = {"shape": f"{shape} M={m} D={d} F={f}" if key == "B"
                   else shape,
                   "ms": cuda_ms(kern), "device_ms": device_ms(kern),
                   "plain_ms": cuda_ms(plain, iters=5),
                   "library_ms": cuda_ms(lib),
                   "library_device_ms": device_ms(lib),
                   "bound_ms": bms, "bound_by": by}
            out[key][what] = row
            log(f"[time] {key} at the MAE {what} ({row['shape']}): kernel "
                f"{row['ms']:.4f} ms, alone {row['device_ms']:.4f}; plain "
                f"{row['plain_ms']:.4f}; library {row['library_ms']:.4f}, "
                f"alone {row['library_device_ms']:.4f}; bound {bms:.4f} ms "
                f"({by}) ({card})")
        leaves = [t.detach().clone().requires_grad_(True) for t in args]

        def b_bwd():
            y = M.fused_mlp_inference(*leaves)
            torch.autograd.grad(y, leaves, dy)

        def chain_bwd():
            y = F.linear(F.gelu(F.linear(leaves[0], leaves[1], leaves[2]),
                                approximate="tanh"), leaves[3], leaves[4])
            torch.autograd.grad(y, leaves, dy)

        fb, cb = device_ms(b_bwd), device_ms(chain_bwd)
        out["B"][what]["fwd_bwd_device_ms"] = fb
        out["B"][what]["library_fwd_bwd_device_ms"] = cb
        log(f"[time] B forward + backward (the chain's VJP) at the MAE "
            f"{what} M={m}: alone {fb:.4f} ms; the bf16 cuBLAS chain's "
            f"forward and autograd backward {cb:.4f} ms ({card})")
    return out


def mae_cli_chain(dev, card):
    """The artifact chain through the CLIs' mains: pretrain_mae_torch for
    one epoch of 2 steps at b256 → the reference-layout .pth → train_torch
    --steps 2 at b32 with model.pretrained_path (its log line "Loaded MAE
    pre-trained weights", the encoder's weights those of the file) →
    convert_checkpoint_torch --to-jax (the .pth into the port's checkpoint;
    also into vit_b16_moe's model with MoE off) → --upcycle-moe into
    vit_b16_moe, whose bf16 forward on 32 images is the dense one's within
    PROB_TOL on its grouped engine → inspect_checkpoint_torch on the .pth
    and the upcycled checkpoint. Its files go under MAE_DIR, removed at
    the end."""
    import logging
    import shutil

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import convert_checkpoint_torch
    import inspect_checkpoint_torch
    import pretrain_mae_torch
    import train_torch
    from gavit_tpu_torch import load_config
    from gavit_tpu_torch.models.vit import build_model
    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.utils import checkpoint as ckpt_lib

    shutil.rmtree(MAE_DIR, ignore_errors=True)
    pth = MAE_DIR / "mae_encoder.pth"
    t0 = time.perf_counter()
    pretrain_mae_torch.main([
        "--config", str(CONFIG), "--synthetic", "--device", RUN_DEVICE,
        "--out", str(pth), "--set", f"data.batch_size={MAE_BATCH}", "--set",
        f"data.synthetic_size={2 * MAE_BATCH}", "--set", "training.epochs=1",
        "--set", f"paths.save_dir={MAE_DIR / 'ckpt'}"])
    state, meta = ckpt_lib.restore(str(MAE_DIR / "ckpt" / "mae_epoch_0"))
    ok = state["step"] == 2 and math.isfinite(meta["loss"]) and pth.exists()
    log(f"[mae] pretrain_mae_torch: 1 epoch of 2 steps at b{MAE_BATCH}, "
        f"loss {meta['loss']:.5f}, mae_epoch_0 at step {state['step']}, "
        f"{pth.name} {pth.stat().st_size / 2**20:.1f} MiB in "
        f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the MAE pretraining CLI did not write its "
                             "checkpoint and .pth")

    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    loader_log = logging.getLogger("gavit_tpu_torch.utils.torch_convert")
    level = loader_log.level
    loader_log.setLevel(logging.INFO)
    loader_log.addHandler(handler)
    try:
        trainer = train_torch.main([
            "--config", str(CONFIG), "--synthetic", "--device", RUN_DEVICE,
            "--steps", "2", "--set", f"model.pretrained_path={pth}", "--set",
            "data.batch_size=32", "--set", "data.synthetic_size=64", "--set",
            "wandb.mode=disabled"])
    finally:
        loader_log.removeHandler(handler)
        loader_log.setLevel(level)
    sd = torch.load(pth, map_location="cpu", weights_only=True)["model"]
    loaded = any("Loaded MAE pre-trained weights" in s for s in lines)
    # the fine-tune stepped twice from the file's weights: they moved, but
    # the file's norm weights are still within the 2 updates' reach
    moved = (trainer.model.blocks[0].norm1.weight.detach().float().cpu()
             - sd["blocks.0.norm1.weight"]).abs().max().item()
    ok = loaded and trainer.step == 2 and moved < 1e-2
    log(f"[mae] train_torch --steps 2 with model.pretrained_path: "
        f"\"Loaded MAE pre-trained weights\" logged {loaded}; blocks.0.norm1 "
        f"within {moved:.2e} of the file's after 2 steps "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the fine-tune did not load the MAE .pth")
    del trainer

    port, dense, upc = (MAE_DIR / s for s in ("port", "dense", "moe"))
    convert_checkpoint_torch.main(["--to-jax", str(pth), str(port),
                                   "--config", str(CONFIG)])
    convert_checkpoint_torch.main(["--to-jax", str(pth), str(dense),
                                   "--config", str(CONFIG_MOE), "--set",
                                   "model.moe.enabled=false"])
    convert_checkpoint_torch.main(["--upcycle-moe", str(dense), str(upc),
                                   "--config", str(CONFIG_MOE)])
    # the grouped engine (dropless), as phase_upcycle pins it: the dense
    # engine's capacity drops tokens when the zero router ties every expert
    cfg_moe = grouped_engine(load_config(str(CONFIG_MOE)))
    dense_cfg = load_config(str(CONFIG_MOE), ["model.moe.enabled=false"])
    models = []
    for cfg, path in ((dense_cfg, dense), (cfg_moe, upc)):
        model = build_model(cfg.model, precision="bf16")
        model.load_state_dict(ckpt_lib.restore(str(path),
                                               map_location="cpu")[0]["model"])
        models.append(model.to(dev))
    s = cfg_moe.data.image_size
    x = val_preprocess(torch.from_numpy(np.random.default_rng(SEED + 32)
                                        .integers(0, 256, (32, s, s, 3),
                                                  np.uint8)).to(dev))
    with torch.inference_mode():
        want, got = (torch.sigmoid(m(x).float()) for m in models)
    err = max_err(got, want)
    ok = err <= PROB_TOL
    log(f"[mae] convert_checkpoint_torch: .pth → {port.name}/ and "
        f"{dense.name}/ (vit_b16_moe with MoE off), --upcycle-moe → "
        f"{upc.name}/: its bf16 forward against the dense one on 32 "
        f"images max |dp| {err:.3e} (tol {PROB_TOL:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the upcycled checkpoint does not compute the "
                             "dense one's function")
    del models
    counts = {}
    for path, stats in ((pth, ["--stats"]), (upc, [])):
        with contextlib.redirect_stdout(io.StringIO()) as text:
            counts[path.name] = inspect_checkpoint_torch.main(
                [str(path), *stats])
        finite = "finite=False" not in text.getvalue()
        log(f"[mae] inspect_checkpoint_torch {path.name} {' '.join(stats)}: "
            f"{counts[path.name]:,} elements"
            + (f", every tensor finite {finite}" if stats else ""))
        if not finite or not counts[path.name]:
            raise AssertionError(f"inspect_checkpoint_torch on {path}")
    shutil.rmtree(MAE_DIR, ignore_errors=True)
    log(f"[mae] the CLI chain in {time.perf_counter() - t0:.1f} s ({card})")


def phase_mae(dev, results, card):
    """MAE pretraining at full width: kernels A, A′ and B at the step's
    shapes against their plain versions; 3 steps through the kernels
    against 3 through the plain versions on the same draws (losses within
    LOSS_REL_TOL, every first gradient at cosine ≥ GRAD_COSINE, every MLP
    weight's gradient nonzero: kernel B's chain backward); the launches of
    one step; 30 steps that lower the loss on the first 5 batches; the
    step's time; A, A′ and B alone; then the CLI chain. Returns (the
    step's launches, the kernels' MAE rows)."""
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import pretrain_mae_torch
    import train_torch

    t_phase = time.perf_counter()
    cfg = mae_config()
    shapes = mae_shapes(cfg)
    cases = check_mae_kernels(dev, results, shapes)
    dataset = train_torch.create_dataset(cfg)
    bs = cfg.data.batch_size
    data = list(itertools.islice(train_torch.batches(dataset, bs, SEED),
                                 MAE_STEPS_LEARN))
    held = data[:5]
    dec_dim, dec_depth, dec_heads = MAE_DECODER
    pres = {impl: pretrain_mae_torch.MAEPretrainer(
        cfg, dev, len(dataset) // bs, decoder_dim=dec_dim,
        decoder_depth=dec_depth, decoder_heads=dec_heads,
        mask_ratio=MAE_MASK, impl=impl) for impl in ("auto", "reference")}
    before = mae_held_loss(pres["auto"], held)
    losses = {impl: [] for impl in pres}
    first_grads, counts = {}, None
    for i in range(MAE_STEPS_COMPARE):
        images = torch.from_numpy(data[i][0])
        for impl, pre in pres.items():
            if impl == "auto" and i == 1:
                torch.cuda.synchronize()
                reset_counts()
            losses[impl].append(pre.train_step(images).item())
            if impl == "auto" and i == 1:
                torch.cuda.synchronize()
                counts = read_counts()
            if i == 0:
                # after the update: clipped by the step's own global-norm
                # factor, which a cosine does not see
                first_grads[impl] = [(n, p.grad.detach().float().flatten())
                                     for n, p in
                                     pre.model.named_parameters()]
    rels = [abs(a - b) / abs(b) for a, b in zip(losses["auto"],
                                                 losses["reference"])]
    ok = max(rels) <= LOSS_REL_TOL
    log(f"[mae] ViT-B/16 MAE bf16 b{bs}, decoder {dec_dim}x{dec_depth}x"
        f"{dec_heads}, mask {MAE_MASK}: losses through the kernels "
        f"{[round(v, 5) for v in losses['auto']]}, through the plain "
        f"versions {[round(v, 5) for v in losses['reference']]}; max rel "
        f"diff {max(rels):.3e} (tol {LOSS_REL_TOL:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("MAE training through the kernels disagrees "
                             "with the plain versions")
    cos, mlp_norms = [], []
    for (name, a), (_, b) in zip(first_grads["auto"],
                                 first_grads["reference"]):
        if ".mlp.fc" in name and name.endswith(".weight"):
            mlp_norms.append((a.norm().item(), name))
        if b.abs().max() == 0 and a.abs().max() == 0:
            continue
        cos.append((torch.nn.functional.cosine_similarity(a, b, dim=0)
                    .item(), name))
    worst, weakest = min(cos), min(mlp_norms)
    ok = (worst[0] >= GRAD_COSINE and weakest[0] > 0
          and len(cos) == len(first_grads["auto"]))
    log(f"[mae] first-step gradients, kernels vs plain versions: lowest "
        f"cosine {worst[0]:.6f} ({worst[1]}) over {len(cos)} of "
        f"{len(first_grads['auto'])} parameters (need {GRAD_COSINE}); the "
        f"{len(mlp_norms)} MLP weights' gradient norms through the kernels "
        f"at least {weakest[0]:.3e} ({weakest[1]}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("an MAE gradient through the kernels is zero or "
                             "points away from the plain version's")
    depth = cfg.model.depth + dec_depth
    log("[mae] kernel launches in one MAE step: "
        + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if counts != expected({"A": depth, "A′": depth, "B": depth}):
        raise AssertionError(f"MAE launch counts {counts}, expected "
                             f"{expected({'A': depth, 'A′': depth, 'B': depth})}")
    del pres["reference"], first_grads
    pre = pres["auto"]
    for i in range(MAE_STEPS_COMPARE, MAE_STEPS_LEARN):
        losses["auto"].append(pre.train_step(
            torch.from_numpy(data[i][0])).item())
    after = mae_held_loss(pre, held)
    ok = all(math.isfinite(v) for v in losses["auto"]) and after < before
    log(f"[mae] {MAE_STEPS_LEARN} steps through the kernels (warmup 5 "
        f"steps, lr {cfg.training.learning_rate}): the loss of the first 5 "
        f"batches on fixed noise without augmentation {before:.5f} before "
        f"and {after:.5f} after; training losses "
        f"{[round(v, 4) for v in losses['auto']]} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{MAE_STEPS_LEARN} MAE steps through the "
                             "kernels did not lower the loss")
    times = []
    for i in range(MAE_STEPS_TIMED):
        images = torch.from_numpy(data[i % len(data)][0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre.train_step(images)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    log(f"[time] MAE step b{bs} bf16 (uint8 upload, preprocess, noise, "
        f"forward, loss, backward, clip, AdamW), host clock around a "
        f"synchronised step: median {ms:.3f} ms of {len(times)} "
        f"({[round(t, 3) for t in times]}), {bs / (ms / 1e3):.1f} images/s "
        f"({card})")
    del pre, pres
    rows = mae_times(dev, results, shapes, cases, card)
    del cases
    torch.cuda.empty_cache()
    mae_cli_chain(dev, card)
    log(f"[mae] phase in {time.perf_counter() - t_phase:.1f} s")
    return counts, rows


def kernels_json(results, serve_counts, train_counts, rows, rows_mae):
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
    weights. A′ in fp32 (``csrc/attention.cu``) has a row of its own: its
    launches from the fp32 224-px b32 step, ``gradcam_launches`` from
    Grad-CAM at block 6, its times at b64 N = 197 (the library call sdpa's
    fp32 forward and backward, TF32 off), ``device_ms`` as the others'.
    K, K′, L and L′ in fp32 (``csrc/attention_f32.cu``) have rows of their
    own: K's and K′'s launches from the fp32 384-px b16 step and
    ``gradcam_launches`` from the 384-px Grad-CAM at block 6, L's and L′'s
    from the fp32 512-px b32 step (FP32_DEPTH_512 blocks); their times at
    b16 N = 577 and b32 N = 1025, the library call sdpa in fp32 (its
    forward for K and L, forward and backward for K′ and L′), with
    ``device_ms`` and ``library_device_ms``.
    M, M′, tgmm and N-gmm in fp32 (``csrc/moe_f32.cu``) have rows of their
    own: M's, M′'s and tgmm's launches from the fused fp32 MoE step (b64,
    4 blocks), N-gmm's (both forms) from the unfused one, M's, M′'s and
    tgmm's ``gradcam_launches`` from the MoE Grad-CAM at block 6; their
    times at the b128 routing beside a loop of fp32 ``torch.matmul`` per
    expert (``library``), N-gmm's transposed form under ``transposed``,
    with ``device_ms`` and ``library_device_ms``.
    A's, A′'s and B's rows carry ``mae``: the launches of one MAE step
    (``train_counts['mae']``) and, at the step's encoder and decoder
    shapes (``rows_mae``), each one's times, bound and library figures;
    B's row also names its ``backward`` and carries its forward and
    backward time at those shapes beside the bf16 chain's."""
    spec = [
        ("A", "fused_qkv_attention",
         "gavit_tpu_torch/csrc/attention_fwd_sm90.cu",
         "gavit_tpu/ops/attention.py:583"),
        ("A′", "fused_qkv_attention_bwd",
         "gavit_tpu_torch/csrc/attention_bwd_sm90.cu",
         "gavit_tpu/ops/attention.py:608"),
        ("A′ fp32", "fused_qkv_attention_bwd_fp32",
         "gavit_tpu_torch/csrc/attention.cu",
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
        ("K fp32", "fused_qkv_attention_long_fp32",
         "gavit_tpu_torch/csrc/attention_f32.cu",
         "gavit_tpu/ops/attention.py:453"),
        ("K′ fp32", "fused_qkv_attention_long_bwd_fp32",
         "gavit_tpu_torch/csrc/attention_f32.cu",
         "gavit_tpu/ops/attention.py:475"),
        ("L fp32", "fused_qkv_attention_large_fp32",
         "gavit_tpu_torch/csrc/attention_f32.cu",
         "gavit_tpu/ops/attention.py:803"),
        ("L′ fp32", "fused_qkv_attention_large_bwd_fp32",
         "gavit_tpu_torch/csrc/attention_f32.cu",
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
        ("M fp32", "fused_grouped_mlp_fp32", "gavit_tpu_torch/csrc/moe_f32.cu",
         "gavit_tpu/ops/moe_fused.py:116"),
        ("M′ fp32", "fused_grouped_mlp_bwd_fp32",
         "gavit_tpu_torch/csrc/moe_f32.cu", "gavit_tpu/ops/moe_fused.py:167"),
        ("tgmm fp32", "grouped_dw_tgmm_fp32", "gavit_tpu_torch/csrc/moe_f32.cu",
         "gavit_tpu/ops/moe_fused.py:411"),
        ("N-gmm fp32", "grouped_gemm_gmm_fp32",
         "gavit_tpu_torch/csrc/moe_f32.cu", "gavit_tpu/ops/moe_grouped.py:138"),
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
            "ops" if key in ("I", "I′", "J", "J′", "G", "E") else
            "fp32" if key == "A′ fp32" else
            "moe fp32" if key in ("M fp32", "M′ fp32", "tgmm fp32") else
            "moe_unfused fp32" if key == "N-gmm fp32" else
            "384 fp32" if key in ("K fp32", "K′ fp32") else
            "512 fp32" if key in ("L fp32", "L′ fp32") else "224"]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": counts[key],
                    "max_abs_err": max(results[key]["errs"]), "ms": km,
                    "plain_ms": pm, "bound_ms": bms, "bound_by": by,
                    "library_ms": lm})
    row = dict(zip([key for key, _, _, _ in spec], out))
    for key in ("N-gmm", "N-gmm fp32"):
        km, pm, lm, bms, by = rows[f"{key} transposed"]
        row[key]["transposed"] = {"ms": km, "plain_ms": pm, "bound_ms": bms,
                                  "bound_by": by, "library_ms": lm}
        (row[key]["transposed"]["device_ms"],
         row[key]["transposed"]["library_device_ms"]) = \
            results[key]["device transposed"]
    tgmm_device = results["tgmm"]["device"]
    for key in ("A′", "A′ fp32", "B", "C", "D", "D′", "E", "F", "G", "H",
                "H′", "K′", "I′", "J′", "L", "L′", "M", "M′", "N-gmm",
                "K fp32", "K′ fp32", "L fp32", "L′ fp32", "M fp32", "M′ fp32",
                "tgmm fp32", "N-gmm fp32"):
        row[key]["device_ms"], row[key]["library_device_ms"] = \
            results[key]["device"]
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
    row["A′ fp32"]["gradcam_launches"] = train_counts["gradcam"]["A′ fp32"]
    for key in ("K fp32", "K′ fp32"):
        row[key]["gradcam_launches"] = train_counts["gradcam 384"][key]
    for key in ("M fp32", "M′ fp32", "tgmm fp32"):
        row[key]["gradcam_launches"] = train_counts["gradcam moe"][key]
    for key in ("M fp32", "M′ fp32", "tgmm fp32", "N-gmm fp32"):
        row[key]["library"] = ("a loop of one fp32 torch.matmul per expert, "
                               "TF32 off (torch._grouped_mm takes no fp32)")
    for key in ("A", "A′", "B"):
        row[key]["mae"] = {"launches": train_counts["mae"][key],
                           **rows_mae[key]}
    row["B"]["backward"] = ("the VJP of the chain recomputed from the "
                            "inputs, tensor ops and cuBLAS (as "
                            "gavit_tpu/ops/mlp.py:676 _fmi_bwd)")
    return {"kernels": out}


_T0 = time.perf_counter()


def stamp(what: str) -> None:
    """The script's wall clock at the end of a phase."""
    log(f"[time] {what} done at {time.perf_counter() - _T0:.1f} s")


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
    check_attention_bwd_f32(dev, results)
    check_long_attention(dev, results)
    check_attention_f32(dev, results)
    check_gelu_dropout(dev, results)
    # the JAX package's op-level entry points (the counts of their own run),
    # then I/I′ and J/J′ at other lengths, and their times
    counts_ops = phase_ops(dev, results)
    check_bhnd_attention(dev, results)
    op_rows = phase_op_times(dev, results, card)
    stamp("kernel checks and the op-level phase")

    # 224 px: vit_b16_graph2 (12 blocks, 2 kNN graph blocks)
    cfg = load_config(str(CONFIG))
    weights = gated_weights(cfg)
    depth = cfg.model.depth
    phase_slice(cfg, weights, dev, "vit_b16_graph2")
    predictor, reference, serve_counts = phase_serve(cfg, weights, dev)
    phase_serve_quant(cfg, weights, dev, card)
    # one CUDA graph per bucket against the eager kernel path, and the
    # torch.export artifact
    phase_serve_graphs(cfg, weights, dev, card)
    phase_export(cfg, weights, dev, card)
    stamp("224-px slice, serve, serve_quant, serve_graphs and export")
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
    stamp("224-px training")

    # fp32: Grad-CAM, rollout, A′ fp32's times, fp32 training at b32 and
    # the Grad-CAM CLI on its checkpoint
    counts_fp32, counts_gradcam, rows_fp32 = phase_gradcam(
        cfg, weights, dev, results, card)
    stamp("gradcam")

    # QAT at b128 and its checkpoint served int8 over HTTP
    phase_qat_serve(dev, card)
    stamp("qat_serve")

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
    # fp32 past 416 tokens: Grad-CAM of finetune_384 and fp32 training at
    # 384 px (K, K′ fp32) and 512 px (L, L′ fp32), the CLI at 384 px, the
    # four fp32 bodies' times
    counts_384_f32, counts_512_f32, counts_gradcam_384, rows_f32 = \
        phase_fp32_long(cfg384, weights384, dev, results, card)
    stamp("384 px and fp32_long")

    phase_times(cfg, dev, results, (predictor, reference), card)
    del predictor, reference
    rows, _ = phase_train_times(tcfg, dev, results, trainer, batch, card)
    rows.update(op_rows)
    rows.update(rows_fp32)
    rows.update(rows_f32)
    del trainer
    rows.update(phase_384_times(cfg384, tcfg384, dev, results, weights384,
                                trainer384, batch384, card))
    del trainer384, weights384
    stamp("times")

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
    stamp("512 and 1024 px")

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
         "tgmm": depth, "F": 2 * (1 + depth + 2)}, steps_compare=3)
    stamp("MoE checks, slices and fused training")
    rows.update(phase_moe_times(cfg_moe, tcfg_moe, dev, results, weights_moe,
                                trainer_moe, batch_moe, card))
    stamp("MoE times")

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
             "F": 2 * (1 + depth + 2) + 2 * 2 * (depth // 2)},
            steps_compare=3)
        stamp("N-gmm checks, unfused slice and training")
        phase_grouped_remat(tcfg_moe, dev, batch_moe, card)
    phase_engines(dev, card)
    phase_upcycle(cfg_moe, dev)
    rows.update(phase_unfused_times(
        cfg_moe, dev, results, weights_moe,
        {"fused": trainer_moe, "unfused": trainer_unf}, batch_moe, card))
    del trainer_moe, trainer_unf
    stamp("MoE")
    # the MoE example in fp32: training on both grouped engines (M, M′,
    # tgmm and N-gmm in fp32), Grad-CAM and rollout, the four bodies' times
    counts_moe_f32, counts_unfused_f32, counts_gradcam_moe, rows_moe_f32 = \
        phase_fp32_moe(cfg_moe, weights_moe, dev, results, card)
    rows.update(rows_moe_f32)
    del weights_moe
    stamp("fp32_moe")
    phase_run(dev, card)
    stamp("run")
    phase_data(dev, card)
    stamp("data")
    # MAE pretraining at b256: A, A′ and B in every encoder and decoder
    # block, B with its chain backward; then the pretrain → .pth → fine-tune
    # → convert → inspect chain through the CLIs
    counts_mae, rows_mae = phase_mae(dev, results, card)
    stamp("mae")
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
                                   "ops": counts_ops, "fp32": counts_fp32,
                                   "gradcam": counts_gradcam,
                                   "384 fp32": counts_384_f32,
                                   "512 fp32": counts_512_f32,
                                   "gradcam 384": counts_gradcam_384,
                                   "moe fp32": counts_moe_f32,
                                   "moe_unfused fp32": counts_unfused_f32,
                                   "gradcam moe": counts_gradcam_moe,
                                   "mae": counts_mae},
                                  rows, rows_mae), ensure_ascii=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
