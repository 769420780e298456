#!/usr/bin/env python3
"""Device times of kernel C and of the small elementwise kernels alone, at
the main path's shapes, on one CUDA card:

* kernel C (the fused kNN graph aggregate, k = 8, with the fp32 adjacency
  kept for the backward) at b128 and b1 over N = 196 patch tokens, D = 768
  (224 px), its normalisation and its tensor-core body apart by
  ``torch.profiler``; no one PyTorch call selects kNN and aggregates;
* kernel F (dropout 0.1) on one [128, 197, 768] bf16 site against
  ``F.dropout``;
* kernels H and H′ (GELU + dropout 0.1 and its backward) on the 384-px
  hidden rows [16·577, 3072] in bf16 against ``F.dropout(F.gelu(x))`` and
  that chain's backward.

Device times: 20 launches back to back between two CUDA events, after 3
warm-up calls, so the host's gap between calls is not inside. Each line is
printed twice (two rounds). It imports the package and ``chip_smoke.py``
from the tree it is run from, so running it from two trees in turns
compares them:

    python3 tools/time_small_kernels.py [TAG]
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import card_line, device_ms  # noqa: E402
from tools.time_gemm_sm90 import profile_parts  # noqa: E402

N_PATCHES, DIM, HIDDEN, RATE = 196, 768, 3072, 0.1


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from gavit_tpu_torch.ops import dropout as DR
    from gavit_tpu_torch.ops import graph_ops as G

    tag = sys.argv[1] if len(sys.argv) > 1 else "this tree"
    card = card_line()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(torch.bfloat16)

    tokens = {b: (draw(b, N_PATCHES, DIM), draw(b, N_PATCHES, DIM))
              for b in (128, 1)}
    xf = draw(128, 197, DIM)
    xh, gh = draw(16 * 577, HIDDEN), draw(16 * 577, HIDDEN)
    xg = xh.detach().clone().requires_grad_(True)
    y_lib = F.dropout(F.gelu(xg), RATE)

    for _ in range(2):
        for b, (t, v) in tokens.items():
            def kernel():
                return G.graph_aggregate_kernel(t, v, "knn", 8, 0.0, 1.0,
                                                return_adjacency=True)
            alone = device_ms(kernel)
            parts = profile_parts(kernel, {"graph_normalize": "normalise",
                                           "graph_fwd": "body"})
            print(f"[{tag}] C knn b{b} N={N_PATCHES} with the adjacency: "
                  f"kernel {alone:.4f} ms (normalise {parts['normalise']:.4f}"
                  f", body {parts['body']:.4f} by the profiler) ({card})",
                  flush=True)
        print(f"[{tag}] F [128, 197, {DIM}] rate {RATE}: kernel "
              f"{device_ms(lambda: DR.dropout_kernel(xf, 12345, 5, RATE)):.4f}"
              f" ms, F.dropout {device_ms(lambda: F.dropout(xf, RATE)):.4f} ms "
              f"({card})", flush=True)
        print(f"[{tag}] H [{xh.shape[0]}, {HIDDEN}] rate {RATE}: kernel "
              f"{device_ms(lambda: DR.gelu_dropout_kernel(xh, 12345, 7, RATE)):.4f}"
              f" ms, F.dropout(F.gelu) "
              f"{device_ms(lambda: F.dropout(F.gelu(xh), RATE)):.4f} ms; H′ "
              f"{device_ms(lambda: DR.gelu_dropout_bwd_kernel(xh, gh, 12345, 7, RATE)):.4f}"
              f" ms, that chain's backward "
              f"{device_ms(lambda: torch.autograd.grad(y_lib, xg, gh, retain_graph=True)):.4f}"
              f" ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
