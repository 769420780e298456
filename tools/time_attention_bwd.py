#!/usr/bin/env python3
"""Device times of the attention backwards (``csrc/attention_bwd_sm90.cu``)
at the main path's shapes, against one PyTorch call, on one CUDA card:

* kernel A′ at b128 × 12 heads × 197 tokens × 64 (224 px training), beside
  the generic pair under K′'s entry on the same rows;
* kernel K′ at b16 × 12 × 577 × 64 (384 px);
* kernel L′ at b32 × 12 × 1025 × 64 (512 px), from kernel L's o and lse;

each beside ``scaled_dot_product_attention``'s forward and backward
(``torch.autograd.grad``) on the same q, k, v and dO, then each kernel's
two launches apart by ``torch.profiler``. Device times: 20 launches back to
back between two CUDA events after 3 warm-up calls, so the host's gap
between calls is not inside.

    python3 tools/time_attention_bwd.py [TAG]

TAG (default ``tree``) starts every line, so that two trees timed in turns
in one call stay apart: from each tree's root,
``python3 /path/to/tools/time_attention_bwd.py parent``.
"""

from __future__ import annotations

import sys

sys.path.insert(0, ".")


def main():
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_line, device_ms
    from gavit_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        raise SystemExit("time_attention_bwd: no CUDA device")
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    card = card_line()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    h = 12
    for b, n in ((128, 197), (16, 577), (32, 1025)):
        qkv = torch.randn(b, n, 3 * h * 64, device=dev,
                          generator=g).to(torch.bfloat16)
        # dO as the head-merging projection's backward hands it over
        do = torch.randn(b, n, h, 64, device=dev,
                         generator=g).to(torch.bfloat16).transpose(1, 2)
        q, k, v = (t.detach().clone().requires_grad_(True)
                   for t in A._split_heads(qkv, h))
        doc = do.contiguous()

        def sdpa():
            out = F.scaled_dot_product_attention(q, k, v)
            torch.autograd.grad(out, (q, k, v), doc)

        fns = {}
        if n > A.K_MAX_N[torch.bfloat16]:
            o, lse = A.qkv_attention_large_kernel(qkv, 0.125, h)
            fns["L′"] = lambda: A.qkv_attention_large_bwd_kernel(
                qkv, o, lse, do, 0.125, h)
        elif n <= A.A_MAX_N[torch.bfloat16]:
            fns["A′"] = lambda: A.qkv_attention_bwd_kernel(qkv, do, 0.125, h)
            fns["pair"] = lambda: A.qkv_attention_long_bwd_kernel(
                qkv, do, 0.125, h)
        else:
            fns["K′"] = lambda: A.qkv_attention_long_bwd_kernel(
                qkv, do, 0.125, h)
        line = ", ".join(f"{key} {device_ms(fn):.4f}"
                         for key, fn in fns.items())
        print(f"[{tag}] b{b} N={n}: {line}, sdpa fwd+bwd "
              f"{device_ms(sdpa):.4f} ms ({card})", flush=True)
        for key, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            parts = [f"{e.key.split('::')[1].split('(')[0]} "
                     f"{e.device_time_total / 1000 / 20:.4f}"
                     for e in prof.key_averages() if "attn_" in e.key]
            print(f"[{tag}]   {key} launches: " + ", ".join(parts),
                  flush=True)


if __name__ == "__main__":
    main()
