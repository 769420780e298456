#!/usr/bin/env python3
"""Device times of the kernels on the TMA-fed wgmma GEMM mainloop
(``gavit_tpu_torch/csrc/gemm_sm90.cuh``) against one PyTorch call each, at
the main path's shapes, on one CUDA card:

* kernel B (the serving MLP, fc1 + GELU + fc2) at M = 12608 (224 px b64),
  D = 768, F = 3072, against the bf16 cuBLAS chain ``F.linear → F.gelu →
  F.linear``; fc1 and fc2 alone as bare GEMMs through N-gmm with one group
  (the same mainloop with a store epilogue) against ``F.linear``;
* kernel N-gmm in both forms at T = 50432 (MoE b128), E = 8, against
  ``torch._grouped_mm``;
* the host time of one kernel-B call at one image (M = 197) against the
  chain's.

Device times: 20 launches back to back between two CUDA events, after 3
warm-up calls, so the host's gap between calls is not inside. Each line is
printed twice (two rounds), kernel and library call in turns.

    python3 tools/time_gemm_sm90.py
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import card_line, device_ms, host_us  # noqa: E402

M_B64, M_B1, DIM, HIDDEN = 64 * 197, 197, 768, 3072
T_B128, EXPERTS = 2 * 128 * 197, 8


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from gavit_tpu_torch.ops import gmm as GM
    from gavit_tpu_torch.ops import mlp as M

    card = card_line()
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(bf)

    x, h = draw(M_B64, DIM), draw(M_B64, HIDDEN)
    w1, b1 = draw(HIDDEN, DIM, scale=0.02), draw(HIDDEN, scale=0.02)
    w2, b2 = draw(DIM, HIDDEN, scale=0.02), draw(DIM, scale=0.02)
    one = torch.tensor([M_B64], dtype=torch.int32, device=dev)
    sizes = [6000, 7000, 5500, 6800, 6200, 6500, 6100]
    gs = torch.tensor(sizes + [T_B128 - sum(sizes)], dtype=torch.int32,
                      device=dev)
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    a, dh = draw(T_B128, DIM), draw(T_B128, HIDDEN)
    w = draw(EXPERTS, DIM, HIDDEN, scale=0.02)

    def chain(xx):
        return F.linear(F.gelu(F.linear(xx, w1, b1), approximate="tanh"),
                        w2, b2)

    for _ in range(2):
        print(f"B M={M_B64}: kernel "
              f"{device_ms(lambda: M.mlp_inference_kernel(x, w1, b1, w2, b2, True)):.4f}"
              f" ms, cuBLAS chain {device_ms(lambda: chain(x)):.4f} ms; bare "
              f"fc1 {device_ms(lambda: GM.gmm_kernel(x, w1[None], one, True)):.4f}"
              f" ms (F.linear {device_ms(lambda: F.linear(x, w1, b1)):.4f}), "
              f"bare fc2 {device_ms(lambda: GM.gmm_kernel(h, w2[None], one, True)):.4f}"
              f" ms (F.linear {device_ms(lambda: F.linear(h, w2, b2)):.4f}) "
              f"({card})", flush=True)
        print(f"N-gmm T={T_B128} E={EXPERTS}: forward "
              f"{device_ms(lambda: GM.gmm_kernel(a, w, gs, False)):.4f} ms, "
              f"torch._grouped_mm "
              f"{device_ms(lambda: torch._grouped_mm(a, w, offs=offs)):.4f}"
              f" ms; transposed "
              f"{device_ms(lambda: GM.gmm_kernel(dh, w, gs, True)):.4f} ms, "
              f"torch._grouped_mm "
              f"{device_ms(lambda: torch._grouped_mm(dh, w.transpose(1, 2), offs=offs)):.4f}"
              f" ms ({card})", flush=True)
    xs = x[:M_B1].contiguous()
    print(f"B M={M_B1} host: kernel "
          f"{host_us(lambda: M.mlp_inference_kernel(xs, w1, b1, w2, b2, True)):.1f}"
          f" us a call, cuBLAS chain {host_us(lambda: chain(xs)):.1f} us "
          f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
