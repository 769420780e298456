#!/usr/bin/env python3
"""Bring-up check of the PyTorch port's bf16 serving path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits nonzero
before the last line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the Hopper kernels from ``gavit_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernel checks: kernels A (attention), B (inference MLP) and C (graph
   aggregate) against their plain PyTorch versions at the serving shapes of
   ViT-B/16 at 224 px, each within a stated tolerance;
4. slice: ``configs/vit_b16_graph2.yaml`` in bf16 from a seed, graph gates
   set to 0.5, through the kernels (``impl='auto'``) and through the plain
   versions (``impl='reference'``) on the same weights;
5. serve: ``scripts/serve_torch.py``'s HTTP server in-process with a warmed
   Predictor; every response must be 200 and match the plain-version
   Predictor; the kernels' launch counters, zeroed just before, must show
   that the requests went through every kernel;
6. times: each kernel against its plain version (CUDA events, median),
   Predictor p50 for one image, images/s of the bf16 forward at batch 64.

The last two lines are one JSON object describing the kernels and then
``{"ok": true, "device": {...}}``. No CUDA device: exit 1, no result.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "vit_b16_graph2.yaml"
SEED = 0
GATE = 0.5
HEADS, HEAD_DIM, N_TOKENS, DIM, HIDDEN = 12, 64, 197, 768, 3072
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


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


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
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def check_attention(dev, results):
    import torch

    from gavit_tpu_torch.ops import attention as A

    scale = HEAD_DIM ** -0.5
    cases = [(name, b, N_TOKENS) for name in DTYPES for b in (1, 8, 64)]
    # bf16 past 224 keys takes the CUDA-core body (384 px: N=577)
    cases.append(("bf16", 2, 577))
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


def mlp_inputs(dev, m):
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + m)
    bf = torch.bfloat16
    x = torch.randn(m, DIM, device=dev, generator=g).to(bf)
    w1 = (torch.randn(HIDDEN, DIM, device=dev, generator=g) * 0.02).to(bf)
    b1 = (torch.randn(HIDDEN, device=dev, generator=g) * 0.02).to(bf)
    w2 = (torch.randn(DIM, HIDDEN, device=dev, generator=g) * 0.02).to(bf)
    b2 = (torch.randn(DIM, device=dev, generator=g) * 0.02).to(bf)
    return x, w1, b1, w2, b2


def check_mlp(dev, results):
    import torch

    from gavit_tpu_torch.ops import mlp as M

    for m in (N_TOKENS, 8 * N_TOKENS, 64 * N_TOKENS):
        args = mlp_inputs(dev, m)
        got = M.mlp_inference_kernel(*args, True)
        want = M._chain_infer(*args, True)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = torch.isfinite(got).all().item() and err <= MLP_TOL
        log(f"[check] B mlp bf16 tanh M={m} D={DIM} F={HIDDEN}: "
            f"max_abs_err {err:.3e} (tol {MLP_TOL:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
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


# ---------------------------------------------------------------------------


def gated_weights(cfg) -> dict:
    """Weights from SEED with both graph gates at GATE, keyed by '/'-joined
    Flax paths as an ``.npz`` would hold them. The gates are zero at init,
    which would hide the graph kernel from the logits."""
    import torch

    from gavit_tpu_torch.models.vit import build_model, init_params
    from gavit_tpu_torch.utils.convert import flax_layout

    model = init_params(build_model(cfg.model),
                        torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for gb in model.graphs:
            gb.gate.fill_(GATE)
    out = {}
    for path, (p, transpose) in flax_layout(model).items():
        arr = p.detach().numpy()
        out[path] = arr.T if transpose else arr
    return out


def phase_slice(cfg, weights, dev):
    import numpy as np
    import torch

    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.serving import Predictor

    imgs = np.random.default_rng(SEED).integers(
        0, 256, (8, cfg.data.image_size, cfg.data.image_size, 3), np.uint8)
    x = val_preprocess(torch.from_numpy(imgs).to(dev))
    probs = {}
    for precision, impl in (("bf16", "auto"), ("bf16", "reference"),
                            ("fp32", "reference")):
        model = Predictor(cfg, weights, precision=precision, device=dev,
                          impl=impl).model
        with torch.inference_mode():
            logits = model(x)
        if logits.shape != (8, cfg.model.num_classes) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"{precision}/{impl} logits: bad shape "
                                 f"{tuple(logits.shape)} or non-finite")
        probs[(precision, impl)] = torch.sigmoid(logits.float())
        del model
    err = max_err(probs[("bf16", "auto")], probs[("bf16", "reference")])
    err32 = max_err(probs[("bf16", "auto")], probs[("fp32", "reference")])
    ok = err <= PROB_TOL
    log(f"[slice] vit_b16_graph2 bf16, gates {GATE}, 8 images: kernels vs "
        f"plain versions max |dp| {err:.3e} (tol {PROB_TOL:.0e}) "
        f"{'ok' if ok else 'FAIL'}; bf16 kernels vs fp32 plain max |dp| "
        f"{err32:.3e}")
    if not ok:
        raise AssertionError("the slice through the kernels disagrees with "
                             "the plain versions")


def reset_counts():
    from gavit_tpu_torch.ops import attention, graph_ops, mlp

    attention.KERNEL_LAUNCHES = mlp.KERNEL_LAUNCHES = 0
    graph_ops.KERNEL_LAUNCHES = 0


def read_counts():
    from gavit_tpu_torch.ops import attention, graph_ops, mlp

    return {"A": attention.KERNEL_LAUNCHES, "B": mlp.KERNEL_LAUNCHES,
            "C": graph_ops.KERNEL_LAUNCHES}


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
        f"A {counts['A']} B {counts['B']} C {counts['C']}")
    depth, n_graph = cfg.model.depth, len(cfg.model.graph_insert_after())
    expect = {"A": depth * device_calls, "B": depth * device_calls,
              "C": n_graph * device_calls}
    if any(counts[k] == 0 for k in counts) or counts != expect:
        raise AssertionError(f"launch counts {counts}, expected {expect}")
    return predictor, reference, counts


def phase_times(cfg, dev, results, predictors, card):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gavit_tpu_torch.ops import attention as A
    from gavit_tpu_torch.ops import graph_ops as G
    from gavit_tpu_torch.ops import mlp as M
    from gavit_tpu_torch.ops.preprocess import val_preprocess

    scale = HEAD_DIM ** -0.5
    times = {}
    for dtype_name, b, qkv in results["A"]["cases"]:
        q, k_, v = A._split_heads(qkv, HEADS)
        k = cuda_ms(lambda: A.qkv_attention_kernel(qkv, scale, HEADS))
        p = cuda_ms(lambda: A.attention_reference(q, k_, v, scale))
        # a library rung to measure against, not a replacement
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k_, v))
        times[("A", dtype_name, b)] = (k, p)
        log(f"[time] A attention {dtype_name} B={b}: kernel {k:.4f} ms, "
            f"plain {p:.4f} ms, torch sdpa {sdpa:.4f} ms ({card})")
    for dtype_name, m, args in results["B"]["cases"]:
        x, w1, b1, w2, b2 = args
        k = cuda_ms(lambda: M.mlp_inference_kernel(*args, True))
        p = cuda_ms(lambda: M._chain_infer(*args, True))
        # bf16 cuBLAS chain: rounds x.W1 before the bias, so not the same
        # function, but the speed reference for kernel B
        blas = cuda_ms(lambda: F.linear(F.gelu(F.linear(x, w1, b1),
                                               approximate="tanh"), w2, b2))
        times[("B", dtype_name, m)] = (k, p)
        log(f"[time] B mlp {dtype_name} M={m}: kernel {k:.4f} ms, plain "
            f"{p:.4f} ms, bf16 cuBLAS chain {blas:.4f} ms ({card})")
    for dtype_name, b, (t, v) in results["C"]["cases"]:
        for mode, kw in GRAPH_MODES:
            k_, thr = kw.get("k", 8), kw.get("threshold", 0.0)
            k = cuda_ms(lambda: G.graph_aggregate_kernel(t, v, mode, k_, thr,
                                                         1.0))
            p = cuda_ms(lambda: G.graph_aggregate(G.build_adjacency(
                t, mode=mode, k=k_, threshold=thr), v))
            times[("C", dtype_name, b, mode)] = (k, p)
            log(f"[time] C graph {dtype_name} {mode} B={b}: kernel {k:.4f} "
                f"ms, plain {p:.4f} ms ({card})")

    predictor, reference = predictors
    s = cfg.data.image_size
    img = np.random.default_rng(SEED + 2).integers(0, 256, (s, s, 3), np.uint8)
    for _ in range(5):
        predictor.predict_proba(img)
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        predictor.predict_proba(img)
        lat.append((time.perf_counter() - t0) * 1000)
    p50 = statistics.median(lat)
    log(f"[time] Predictor.predict_proba 1 image bf16: p50 {p50:.3f} ms "
        f"over 50 calls ({card})")

    batch = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, 256, (64, s, s, 3), np.uint8)).to(dev)
    x = val_preprocess(batch)
    for impl, model in (("auto", predictor.model),
                        ("reference", reference.model)):
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(x), iters=10, warmup=2)
        log(f"[time] bf16 forward b64 impl={impl}: {ms:.3f} ms, "
            f"{64 / (ms / 1000):.1f} img/s ({card})")
    return times


def kernels_json(results, counts, times):
    rows = [
        ("A", "fused_qkv_attention", "gavit_tpu_torch/csrc/attention.cu",
         "gavit_tpu/ops/attention.py:583", ("A", "bf16", 64)),
        ("B", "fused_mlp_inference", "gavit_tpu_torch/csrc/mlp.cu",
         "gavit_tpu/ops/mlp.py:582", ("B", "bf16", 64 * N_TOKENS)),
        ("C", "fused_graph_aggregate", "gavit_tpu_torch/csrc/graph.cu",
         "gavit_tpu/ops/graph_ops.py:129", ("C", "bf16", 64, "knn")),
    ]
    return {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[key], "max_abs_err": max(results[key]["errs"]),
         "ms": times[tkey][0], "plain_ms": times[tkey][1]}
        for key, name, src, rep, tkey in rows
    ]}


def main():
    card = phase_environment()
    import torch

    from gavit_tpu_torch import load_config

    dev = torch.device("cuda", 0)
    phase_build()
    results = {k: {"errs": [], "cases": []} for k in "ABC"}
    check_attention(dev, results)
    check_mlp(dev, results)
    check_graph(dev, results)
    cfg = load_config(str(CONFIG))
    weights = gated_weights(cfg)
    phase_slice(cfg, weights, dev)
    predictor, reference, counts = phase_serve(cfg, weights, dev)
    times = phase_times(cfg, dev, results, (predictor, reference), card)
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax")]
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    log(f"[env] nothing of jax or flax imported; {card}")
    print(card)
    print(json.dumps(kernels_json(results, counts, times)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
