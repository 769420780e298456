#!/usr/bin/env python3
"""Device times of the kernels on the TMA-fed wgmma GEMM mainloop
(``gavit_tpu_torch/csrc/gemm_sm90.cuh``) against one PyTorch call each, at
the main path's shapes, on one CUDA card:

* kernel B (the serving MLP, fc1 + GELU + fc2) at M = 12608 (224 px b64),
  D = 768, F = 3072, against the bf16 cuBLAS chain ``F.linear → F.gelu →
  F.linear``; fc1 and fc2 alone as bare GEMMs through N-gmm with one group
  (the same mainloop with a store epilogue) against ``F.linear``;
* kernel D (the training MLP forward, dropout 0.1 at both sites) at M =
  25216 (224 px b128) against the bf16 chain ``F.linear → F.gelu →
  F.dropout → F.linear → F.dropout``, and its two GEMMs bare;
* kernel D′ (the training MLP backward at rate 0.1: the dye prologue, dh
  = dye·W2 with GELU′, both masks, go and db1's partials, the bias
  reductions) at M = 25216 against the chain's backward from y to the fc1
  output (``torch.autograd.grad`` through ``F.gelu → F.dropout →
  F.linear → F.dropout``); its dh GEMM, prologue and reductions apart by
  ``torch.profiler`` beside the same GEMM bare through N-gmm;
* kernel N-gmm in both forms at T = 50432 (MoE b128), E = 8, against
  ``torch._grouped_mm``;
* kernel M (the fused MoE expert MLP forward: fc1 + b1[e] → h1, GELU,
  hidden dropout → g, fc2 + b2[e], output dropout) over the cap-padded
  rows of the same grouping (each group rounded up to 256), erf at rate
  0.1 and tanh at rate 0, against the bf16 chain ``torch._grouped_mm →
  F.gelu → F.dropout → torch._grouped_mm → F.dropout`` on the same rows;
  its fc1 and fc2 apart (``torch.profiler``'s device time of each of its
  two launches) beside the same two GEMMs bare through N-gmm;
* kernel M′ (its backward: the dye prologue, dh = dye·W2[e]ᵀ with GELU′,
  both masks, go and db1's partials, the bias reductions, dx =
  dh1·W1[e]ᵀ) over the same rows, erf at rate 0.1 and tanh at rate 0,
  against that chain's backward to x (``torch.autograd.grad``); its dh
  and dx launches apart by ``torch.profiler`` beside the same two GEMMs
  bare through N-gmm's transposed form;
* kernel tgmm (the grouped dW) for dW1 ``[8, 768, 3072]`` and dW2 ``[8,
  3072, 768]`` over the packed T = 50432 rows (the unfused engine) and over
  the cap-padded rows (each group rounded up to 256, the fused engine),
  against ``torch._grouped_mm(a.t(), b, offs=...)``; and dW1 with every row
  on one expert;
* the host time of one kernel-B call at one image (M = 197) against the
  chain's.

Device times: 20 launches back to back between two CUDA events, after 3
warm-up calls, so the host's gap between calls is not inside. Each line is
printed twice (two rounds), kernel and library call in turns.

    python3 tools/time_gemm_sm90.py [--only B,D,D′,M,M′,N-gmm,tgmm,host]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import card_line, device_ms, host_us  # noqa: E402

M_B64, M_B1, M_B128, DIM, HIDDEN = 64 * 197, 197, 128 * 197, 768, 3072
T_B128, EXPERTS, TM = 2 * 128 * 197, 8, 256
SIZES = [6000, 7000, 5500, 6800, 6200, 6500, 6100]  # the 8th takes the rest


def profile_parts(fn, names):
    """Device ms of one ``fn()`` by the first of ``names`` (substring →
    part) each kernel's name holds, by ``torch.profiler`` over 10 calls."""
    import torch

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    parts = dict.fromkeys(dict.fromkeys(names.values()), 0.0)
    for ev in prof.key_averages():
        part = next((v for k, v in names.items() if k in ev.key), None)
        if part is not None:
            parts[part] += ev.self_device_time_total / 1e3 / 10
    return parts


def main() -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="B,D,D′,M,M′,N-gmm,tgmm,host",
                    help="comma-separated kernels to time")
    only = set(ap.parse_args().only.split(","))

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from gavit_tpu_torch.ops import gmm as GM
    from gavit_tpu_torch.ops import mlp as M
    from gavit_tpu_torch.ops import moe_fused as MF

    card = card_line()
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(bf)

    def int32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    x, h = draw(M_B64, DIM), draw(M_B64, HIDDEN)
    w1, b1 = draw(HIDDEN, DIM, scale=0.02), draw(HIDDEN, scale=0.02)
    w2, b2 = draw(DIM, HIDDEN, scale=0.02), draw(DIM, scale=0.02)
    one = int32([M_B64])
    gs = int32(SIZES + [T_B128 - sum(SIZES)])
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    a, dh = draw(T_B128, DIM), draw(T_B128, HIDDEN)
    w = draw(EXPERTS, DIM, HIDDEN, scale=0.02)
    # D at b128
    xd, hd = draw(M_B128, DIM), draw(M_B128, HIDDEN)
    one_d = int32([M_B128])
    seed, sites = 12345, (2, 3)
    # tgmm: the packed rows (a, dh over gs) and the cap-padded ones
    padded = [-(-s // TM) * TM for s in gs.tolist()]
    gs_cap = int32(padded)
    offs_cap = torch.cumsum(gs_cap, 0, dtype=torch.int32)
    cap = sum(padded)
    a_cap, dh_cap = draw(cap, DIM), draw(cap, HIDDEN, scale=0.01)
    hot = int32([0] * 5 + [T_B128] + [0] * 2)
    # M: the cap-padded rows with each expert's weights and biases
    we1, we2 = w, draw(EXPERTS, HIDDEN, DIM, scale=0.02)
    be1, be2 = draw(EXPERTS, HIDDEN, scale=0.02), draw(EXPERTS, DIM, scale=0.02)
    tg_cap = torch.repeat_interleave(
        torch.arange(EXPERTS, device=dev, dtype=torch.int32), gs_cap // TM)

    def chain(xx):
        return F.linear(F.gelu(F.linear(xx, w1, b1), approximate="tanh"),
                        w2, b2)

    def train_chain(xx):
        hid = F.dropout(F.gelu(F.linear(xx, w1, b1)), 0.1)
        return F.dropout(F.linear(hid, w2, b2), 0.1)

    def time_b():
        print(f"B M={M_B64}: kernel "
              f"{device_ms(lambda: M.mlp_inference_kernel(x, w1, b1, w2, b2, True)):.4f}"
              f" ms, cuBLAS chain {device_ms(lambda: chain(x)):.4f} ms; bare "
              f"fc1 {device_ms(lambda: GM.gmm_kernel(x, w1[None], one, True)):.4f}"
              f" ms (F.linear {device_ms(lambda: F.linear(x, w1, b1)):.4f}), "
              f"bare fc2 {device_ms(lambda: GM.gmm_kernel(h, w2[None], one, True)):.4f}"
              f" ms (F.linear {device_ms(lambda: F.linear(h, w2, b2)):.4f}) "
              f"({card})", flush=True)

    def time_d():
        with torch.no_grad():
            print(f"D M={M_B128} rate 0.1: kernel "
                  f"{device_ms(lambda: M.mlp_train_kernel(xd, w1, b1, w2, b2, seed, sites, 0.1, 0.1)):.4f}"
                  f" ms, bf16 chain {device_ms(lambda: train_chain(xd)):.4f} "
                  f"ms; bare fc1 "
                  f"{device_ms(lambda: GM.gmm_kernel(xd, w1[None], one_d, True)):.4f}"
                  f" ms, bare fc2 "
                  f"{device_ms(lambda: GM.gmm_kernel(hd, w2[None], one_d, True)):.4f}"
                  f" ms ({card})", flush=True)

    def time_d_bwd():
        dy, h1 = draw(M_B128, DIM), draw(M_B128, HIDDEN)
        h_pre = h1.detach().clone().requires_grad_(True)
        y = F.dropout(F.linear(F.dropout(F.gelu(h_pre), 0.1), w2, b2), 0.1)

        def kernel():
            return M.mlp_train_bwd_kernel(dy, h1, w2, seed, sites, 0.1, 0.1)
        alone = device_ms(kernel)
        # the dh GEMM under either design's name
        parts = profile_parts(kernel, {"TrainDhEpi": "dh", "dh_gemm": "dh",
                                       "prologue": "prologue",
                                       "colsum": "reductions"})
        print(f"D′ M={M_B128} rate 0.1: kernel {alone:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
              + " by the profiler); bare dh "
              f"{device_ms(lambda: GM.gmm_kernel(dy, w2[None], one_d, False)):.4f}"
              f" ms; the chain's backward to the fc1 output "
              f"{device_ms(lambda: torch.autograd.grad(y, h_pre, dy, retain_graph=True)):.4f}"
              f" ms ({card})", flush=True)

    def time_ngmm():
        print(f"N-gmm T={T_B128} E={EXPERTS}: forward "
              f"{device_ms(lambda: GM.gmm_kernel(a, w, gs, False)):.4f} ms, "
              f"torch._grouped_mm "
              f"{device_ms(lambda: torch._grouped_mm(a, w, offs=offs)):.4f}"
              f" ms; transposed "
              f"{device_ms(lambda: GM.gmm_kernel(dh, w, gs, True)):.4f} ms, "
              f"torch._grouped_mm "
              f"{device_ms(lambda: torch._grouped_mm(dh, w.transpose(1, 2), offs=offs)):.4f}"
              f" ms ({card})", flush=True)

    def moe_chain(xx):
        hid = F.dropout(F.gelu(torch._grouped_mm(xx, we1, offs=offs_cap)), 0.1)
        return F.dropout(torch._grouped_mm(hid, we2, offs=offs_cap), 0.1)

    def time_m():
        with torch.no_grad():
            for rate, approx in ((0.1, False), (0.0, True)):
                def kernel():
                    return MF.moe_fwd_kernel(a_cap, we1, be1, we2, be2, tg_cap,
                                             TM, seed, sites, rate, rate,
                                             approx, gs_cap)
                alone = device_ms(kernel)
                parts = profile_parts(kernel, {"TrainFc1Epi": "fc1",
                                               "TrainFc2Epi": "fc2"})
                print(f"M cap={cap} {'tanh' if approx else 'erf'} rate "
                      f"{rate}: kernel {alone:.4f} ms (fc1 {parts['fc1']:.4f}"
                      f", fc2 {parts['fc2']:.4f} by the profiler); bare fc1 "
                      f"{device_ms(lambda: GM.gmm_kernel(a_cap, we1, gs_cap, False)):.4f}"
                      f" ms, bare fc2 "
                      f"{device_ms(lambda: GM.gmm_kernel(dh_cap, we2, gs_cap, False)):.4f}"
                      f" ms; grouped_mm chain "
                      f"{device_ms(lambda: moe_chain(a_cap)):.4f} ms ({card})",
                      flush=True)

    def time_m_bwd():
        dy, h1 = draw(cap, DIM), draw(cap, HIDDEN)
        xg = a_cap.detach().clone().requires_grad_(True)
        y = moe_chain(xg)
        names = {"TrainDhEpi": "dh", "StoreEpi, false": "dx", "": "rest"}
        for rate, approx in ((0.1, False), (0.0, True)):
            def kernel():
                return MF.moe_bwd_kernel(dy, h1, we1, we2, tg_cap, TM, seed,
                                         sites, rate, rate, approx, gs_cap)
            alone = device_ms(kernel)
            parts = profile_parts(kernel, names)
            print(f"M′ cap={cap} {'tanh' if approx else 'erf'} rate {rate}: "
                  f"kernel {alone:.4f} ms (dh {parts['dh']:.4f}, dx "
                  f"{parts['dx']:.4f}, prologue and reductions "
                  f"{parts['rest']:.4f} by the profiler); bare dh "
                  f"{device_ms(lambda: GM.gmm_kernel(dy, we2, gs_cap, True)):.4f}"
                  f" ms, bare dx "
                  f"{device_ms(lambda: GM.gmm_kernel(h1, we1, gs_cap, True)):.4f}"
                  f" ms; grouped_mm chain's backward to x "
                  f"{device_ms(lambda: torch.autograd.grad(y, xg, dy, retain_graph=True)):.4f}"
                  f" ms ({card})", flush=True)

    def time_tgmm():
        for rows, lhs, rhs, g, o in (("packed T", a, dh, gs, offs),
                                     (f"cap {cap}", a_cap, dh_cap, gs_cap,
                                      offs_cap)):
            print(f"tgmm {rows} E={EXPERTS}: dW1 "
                  f"{device_ms(lambda: GM.tgmm_kernel(lhs, rhs, g)):.4f} ms, "
                  f"torch._grouped_mm "
                  f"{device_ms(lambda: torch._grouped_mm(lhs.t(), rhs, offs=o)):.4f}"
                  f" ms; dW2 "
                  f"{device_ms(lambda: GM.tgmm_kernel(rhs, lhs, g)):.4f} ms, "
                  f"torch._grouped_mm "
                  f"{device_ms(lambda: torch._grouped_mm(rhs.t(), lhs, offs=o)):.4f}"
                  f" ms ({card})", flush=True)
        print(f"tgmm T={T_B128} all on expert 5: dW1 "
              f"{device_ms(lambda: GM.tgmm_kernel(a, dh, hot)):.4f} ms "
              f"({card})", flush=True)

    for _ in range(2):
        for name, fn in (("B", time_b), ("D", time_d), ("D′", time_d_bwd),
                         ("M", time_m),
                         ("M′", time_m_bwd), ("N-gmm", time_ngmm),
                         ("tgmm", time_tgmm)):
            if name in only:
                fn()
    if "host" in only:
        xs = x[:M_B1].contiguous()
        print(f"B M={M_B1} host: kernel "
              f"{host_us(lambda: M.mlp_inference_kernel(xs, w1, b1, w2, b2, True)):.1f}"
              f" us a call, cuBLAS chain {host_us(lambda: chain(xs)):.1f} us "
              f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
