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
  hidden rows [16·577, 3072] in bf16 (``chip_smoke.gelu_inputs``: x =
  2·N(0, 1), dy = N(0, 1), the inputs ``chip_smoke.py`` times) against
  ``F.dropout(F.gelu(x))`` and that chain's backward as its two aten calls
  (``chip_smoke.gelu_dropout_bwd_library``), and their issue floors from
  the SASS (``tools/sass_issue.py``, where ``cuobjdump`` is);
* kernel G (dropout 0.1 + residual add) on [128, 197, 768] bf16 and kernel
  E (the keep masks) at both sites of the b128 MLP rows, [25216, 3072] and
  [25216, 768] fp32, one call; no one PyTorch call computes either.

Device times: 20 launches back to back between two CUDA events, after 3
warm-up calls, so the host's gap between calls is not inside unless the
host takes longer than the kernel, as it can for F's and G's calls;
beside each the profiler's kernel time, which holds no host gap. Each line
is printed twice (two rounds). It imports the package and ``chip_smoke.py``
from the tree it is run from, so running it from two trees in turns
compares them:

    python3 tools/time_small_kernels.py [TAG]
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (card_line, device_ms, gelu_dropout_bwd_library,  # noqa: E402
                        gelu_inputs)
from tools.time_gemm_sm90 import profile_parts  # noqa: E402

N_PATCHES, DIM, HIDDEN, RATE = 196, 768, 3072, 0.1
SHAPES = {"F": "[128, 197, 768] bf16", "G": "[128, 197, 768] bf16",
          "H": "[9232, 3072] bf16", "H′": "[9232, 3072] bf16",
          "E": "[25216, 3072] + [25216, 768] fp32"}
# the device time of the port's elementwise kernels (both layouts' names),
# summed over a call's launches
KERNEL_NAMES = {"namespace)::elementwise_kernel<": "kernel",
                "keep_mask_kernel": "kernel"}


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from gavit_tpu_torch.ops import dropout as DR
    from gavit_tpu_torch.ops import graph_ops as G
    from gavit_tpu_torch.ops import mlp as M

    tag = sys.argv[1] if len(sys.argv) > 1 else "this tree"
    card = card_line()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(torch.bfloat16)

    tokens = {b: (draw(b, N_PATCHES, DIM), draw(b, N_PATCHES, DIM))
              for b in (128, 1)}
    xf, rf = draw(128, 197, DIM), draw(128, 197, DIM)
    xh, gh = gelu_inputs(dev, torch.bfloat16)
    bwd_lib = gelu_dropout_bwd_library(xh, gh)
    rows = 128 * 197
    libraries = {"F": ("F.dropout", lambda: F.dropout(xf, RATE)),
                 "H": ("F.dropout(F.gelu)", lambda: F.dropout(F.gelu(xh), RATE)),
                 "H′": ("that chain's backward (native_dropout_backward, "
                        "gelu_backward)", bwd_lib)}

    def library(key):
        if key not in libraries:
            return ""
        name, fn = libraries[key]
        return f", {name} {device_ms(fn):.4f} ms"

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
        for key, fn in (
                ("F", lambda: DR.dropout_kernel(xf, 12345, 5, RATE)),
                ("H", lambda: DR.gelu_dropout_kernel(xh, 12345, 7, RATE)),
                ("H′", lambda: DR.gelu_dropout_bwd_kernel(xh, gh, 12345, 7,
                                                          RATE)),
                ("G", lambda: DR.dropout_add_kernel(xf, rf, 12345, 9, RATE)),
                ("E", lambda: M.kernel_mask(12345, (2, 3), rows, HIDDEN, RATE,
                                            d=DIM, out_rate=RATE))):
            kernel = profile_parts(fn, KERNEL_NAMES)["kernel"]
            print(f"[{tag}] {key} {SHAPES[key]} rate {RATE}: kernel "
                  f"{device_ms(fn):.4f} ms alone ({kernel:.4f} by the "
                  f"profiler, no host gap){library(key)} ({card})",
                  flush=True)
    from gavit_tpu_torch.ops import _build
    from tools import sass_issue

    try:
        lines = sass_issue.report(_build.library_path())
    except (OSError, subprocess.CalledProcessError) as err:
        lines = [f"issue floors: not measured ({err})"]
    for line in lines:
        print(f"[{tag}] {line} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
