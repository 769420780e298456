#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step, on a card
(bf16 as the configurations train; ``--set training.precision=fp32`` for
the fp32 step).

    python3 tools/profile_torch_training.py [--config configs/vit_b16_graph2.yaml] \
        [--batch 128] [--iters 5] [--out build/profile_train] [--set KEY=VALUE]
    python3 tools/profile_torch_training.py --mae [--batch 256]

Builds the configuration (``configs/vit_b16_graph2.yaml`` by default;
``configs/finetune_384.yaml`` for the 384-px fine-tune, at its batch 16,
and ``configs/examples/vit_b16_moe.yaml`` for the MoE model, at its batch
128, unless ``--batch`` says otherwise; with ``GAVIT_MOE_FUSED=0`` in the
environment its unfused grouped engine; ``--set`` overrides as the CLIs
take them, e.g. the 1024-px step: ``--batch 4 --set model.img_size=1024
--set data.image_size=1024 --set model.remat=true``; dropout 0.1, graph
gates 0.5, weights from a seed) through ``scripts/train_torch.py``'s
trainer (with ``--mae``, the MAE pretraining step of
``scripts/pretrain_mae_torch.py`` instead: its default 512 x 4 x 8 decoder
and mask 0.75 on the configuration's trunk, batch 256 unless ``--batch``
says otherwise), takes 3 warm-up steps on synthetic uint8 batches, then:

* times the step on the host clock around ``train_step`` and a
  synchronize (median over ``--iters``);
* runs ``torch.profiler`` over ``--iters`` more steps and prints the device
  time per step grouped by kernel family (the port's kernels A, A′, C, D,
  D′, F, H, H′, K, K′, L, L′, M, M′, tgmm, N-gmm (and their fp32 bodies)
  by name; cuBLAS GEMMs;
  LayerNorm; the MoE routing's sorts, scans and gathers; elementwise and
  reductions), the top kernels, the device busy time per step and the idle
  share of the wall time (1 - busy / wall);
* writes a Chrome trace under ``--out``.

It needs a CUDA device and exits nonzero without one.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# fragments of the (demangled) kernel names → family, first match wins
FAMILIES = (
    ("attn_large_sm90", "L blockwise attention forward, wgmma (attention_fwd_sm90.cu)"),
    # the backward pair under each entry's names (attention_bwd_sm90.cu)
    ("attn_large_bwd_q", "L′ query-major: delta from o, dq, wgmma (attention_bwd_sm90.cu)"),
    ("attn_large_bwd_kv", "L′ key-major: dk, dv, wgmma (attention_bwd_sm90.cu)"),
    ("attn_short_bwd_q", "A′ query-major: dq, row statistics, wgmma (attention_bwd_sm90.cu)"),
    ("attn_short_bwd_kv", "A′ key-major: dk, dv, wgmma (attention_bwd_sm90.cu)"),
    ("attn_fwd_sm90", "A/K attention forward, wgmma (attention_fwd_sm90.cu)"),
    ("attn_bwd_q_sm90", "K′ query-major: dq, row statistics, wgmma (attention_bwd_sm90.cu)"),
    ("attn_bwd_kv_sm90", "K′ key-major: dk, dv, wgmma (attention_bwd_sm90.cu)"),
    ("attn_f32_fwd", "K/L attention forward, fp32 (attention_f32.cu)"),
    ("attn_f32_bwd_dq", "K′/L′ fp32 query-major: row statistics, dq (attention_f32.cu)"),
    ("attn_f32_bwd_dkv", "K′/L′ fp32 key-major: dk, dv (attention_f32.cu)"),
    ("attn_fwd", "A attention forward, fp32 (attention.cu)"),
    ("attn_bwd_dq_kernel", "A′ fp32 query-major: dq, row statistics (attention.cu)"),
    ("attn_bwd_dkv_kernel", "A′ fp32 key-major: dk, dv (attention.cu)"),
    # the fp32 MoE bodies on the CUDA-core mainloop (gemm_f32.cuh,
    # moe_f32.cu): ahead of the bf16 names that their names contain
    ("bwd_prologue_f32", "M′ fp32 prologue: out mask + db2 partials (moe_f32.cu)"),
    ("gemm32::GroupedK", "tgmm fp32 grouped dW1, dW2, CUDA cores (gemm_f32.cuh)"),
    ("::Fc1Epi<", "M fp32 fc1 + b1[e] + h1 + GELU + mask → g, CUDA cores (moe_f32.cu)"),
    ("::Fc2Epi", "M fp32 fc2 + b2[e] + mask, CUDA cores (moe_f32.cu)"),
    ("::DhEpi<", "M′ fp32 dh + GELU′ + masks → dh1, go, db1 partials, CUDA cores (moe_f32.cu)"),
    ("gemm32::StoreEpi, false", "N-gmm fp32 x·W[e], CUDA cores (gemm_f32.cuh)"),
    ("gemm32::StoreEpi, true", "M′ fp32 dx = dh1·W1[e]ᵀ; N-gmm fp32 transposed, CUDA cores (gemm_f32.cuh)"),
    # the backward prologue D′ and M′ share; their bias reductions
    ("bwd_prologue", "D′/M′ prologue: out mask + db2 partials (train_epilogues.cuh)"),
    ("moe_colsum_reduce", "M′ per-expert bias reductions, both dtypes (moe_common.cuh)"),
    ("colsum_reduce", "D′ bias-gradient reductions (mlp.cu)"),
    # the wgmma mainloop's instantiations (gemm_sm90.cuh): tgmm's GroupedK
    # before N-gmm's "StoreEpi, true", D's (one bias row) before M's (a
    # bias row an expert), B's "InferEpi<0>" before "InferEpi<"
    ("GroupedK", "tgmm grouped dW1, dW2, wgmma (gemm_sm90.cuh)"),
    ("StoreEpi, true", "N-gmm x·W[e], wgmma (gemm_sm90.cuh)"),
    ("StoreEpi, false", "M′ dx = dh1·W1[e]ᵀ; N-gmm transposed, wgmma (gemm_sm90.cuh)"),
    # D′'s dh reads W2 MN-major ("true"), M′'s W2[e] K-major
    ("TrainDhEpi<2>, true", "D′ dh + GELU′ + masks → dh1, go, db1 partials, wgmma (gemm_sm90.cuh)"),
    ("TrainDhEpi", "M′ dh + GELU′ + masks → dh1, go, db1 partials, wgmma (gemm_sm90.cuh)"),
    ("TrainFc1Epi<2, false>", "D fc1 + h1 + GELU + mask → g, wgmma (gemm_sm90.cuh)"),
    ("TrainFc2Epi<false>", "D fc2 + mask, wgmma (gemm_sm90.cuh)"),
    ("TrainFc1Epi<", "M fc1 + b1[e] + h1 + GELU + mask → g, wgmma (gemm_sm90.cuh)"),
    ("TrainFc2Epi<true>", "M fc2 + b2[e] + mask, wgmma (gemm_sm90.cuh)"),
    ("InferEpi<0>", "B fc2 + bias, wgmma (gemm_sm90.cuh)"),
    ("InferEpi<", "B fc1 + bias + GELU, wgmma (gemm_sm90.cuh)"),
    # dropout.cu's kernel sits in an anonymous namespace; PyTorch's own
    # at::native::elementwise_kernel<128, ...> must not match
    ("namespace)::elementwise_kernel<0,", "F dropout (dropout.cu)"),
    ("namespace)::elementwise_kernel<1,", "H GELU + dropout (dropout.cu)"),
    ("namespace)::elementwise_kernel<2,",
     "H′ GELU + dropout backward (dropout.cu)"),
    ("graph_normalize", "C normalisation (graph.cu)"),
    ("graph_fwd_sm90", "C similarity, kNN, softmax, A·V, wgmma (graph.cu)"),
    ("graph_", "C graph op, CUDA cores (graph.cu)"),
    ("layer_norm", "LayerNorm forward and backward"),
    ("GammaBeta", "LayerNorm forward and backward"),
    ("Gelu", "GELU forward and backward, PyTorch's (B's chain backward)"),
    ("nvjet", "cuBLAS bf16 GEMMs (qkv, proj, patch, value, head; dx, dW)"),
    ("xmma_gemm_f32", "cuBLAS fp32 GEMMs (graph backward; every GEMM of an fp32 step)"),
    ("sgemm", "cuBLAS fp32 GEMMs (graph backward; every GEMM of an fp32 step)"),
    ("gemm", "cuBLAS bf16 GEMMs (qkv, proj, patch, value, head; dx, dW)"),
    ("multi_tensor_apply", "AdamW (foreach)"),
    ("Sort", "sorts (MoE top-k)"),
    ("sort", "sorts (MoE top-k)"),
    ("Scan", "scans (MoE grouping cumsums)"),
    ("scan", "scans (MoE grouping cumsums)"),
    ("index", "gathers and index_put (MoE grouping, dispatch, combine)"),
    ("reduce", "reductions (bias grads, norms, loss)"),
    ("copy_kernel", "dtype casts (weights to bf16, LayerNorm inputs to fp32)"),
    ("elementwise", "elementwise (adds, scales, preprocess, loss)"),
    ("Memcpy", "copies"),
    ("Memset", "memsets"),
)


def family(name: str) -> str:
    for frag, fam in FAMILIES:
        if frag in name:
            return fam
    return "other"


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/vit_b16_graph2.yaml")
    p.add_argument("--batch", type=int, default=None,
                   help="default: 128 for vit_b16_graph2 (256 with --mae), "
                        "else the file's")
    p.add_argument("--mae", action="store_true",
                   help="profile the MAE pretraining step")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--out", default="build/profile_train")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE", help="config override, repeatable")
    args = p.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_training: no CUDA device")
    import train_torch
    from gavit_tpu_torch import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = ROOT / args.config
    batch = args.batch or (256 if args.mae else 128 if
                           path.stem == "vit_b16_graph2" else None)
    cfg = load_config(str(path),
                      ([f"data.batch_size={batch}"] if batch else [])
                      + args.overrides)
    batch = cfg.data.batch_size
    dataset = train_torch.create_dataset(cfg)
    images, labels = (torch.from_numpy(a) for a in next(
        train_torch.batches(dataset, batch, 0)))
    if args.mae:
        from pretrain_mae_torch import MAEPretrainer

        pretrainer = MAEPretrainer(cfg, "cuda",
                                   max(1, len(dataset) // batch))

        def step():
            pretrainer.train_step(images)
    else:
        trainer = train_torch.build_trainer(cfg, dataset, "cuda", gate=0.5)

        def step():
            trainer.train_step(images, labels)
    from chip_smoke import card_line

    card = card_line()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    # device-side events only (kernels, memsets, copies), so no time is
    # counted twice through the CPU op that launched it; the optimizer's
    # annotations ("Optimizer.step#AdamW.step") span its kernels on the
    # device timeline and are left out too
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith(("Command Buffer", "Activity",
                                        "Optimizer."))]
    busy_ms = sum(e.self_device_time_total for e in events) / 1000
    n = args.iters
    step = statistics.median(times)
    what = "MAE step" if args.mae else "train step"
    print(f"[profile] {path.stem} {cfg.data.image_size} px {what} "
          f"b{batch} {cfg.training.precision} on {card}: "
          f"{step:.3f} ms (host clock, median of {n}), "
          f"{batch / step * 1000:.1f} "
          f"img/s; under the profiler wall {wall_ms / n:.3f} ms, device busy "
          f"{busy_ms / n:.3f} ms per step, idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    fams = defaultdict(lambda: [0.0, 0])
    for e in events:
        f = fams[family(e.key)]
        f[0] += e.self_device_time_total / 1000 / n
        f[1] += e.count // n
    for fam, (ms, cnt) in sorted(fams.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] family {ms:9.3f} ms/step {cnt:5d}x/step "
              f"{100 * ms / (busy_ms / n):5.1f}%  {fam}")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[:30]:
        print(f"[profile] kernel {e.self_device_time_total / 1000 / n:9.4f} "
              f"ms/step {e.count // n:4d}x/step  {e.key[:100]}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(
        str(out / f"trace_{'mae' if args.mae else 'train'}_{path.stem}"
                  f"_b{batch}.json"))


if __name__ == "__main__":
    main()
