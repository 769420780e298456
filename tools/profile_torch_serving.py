#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's bf16 serving forward, on a card.

    python3 tools/profile_torch_serving.py [--batch 1 64] [--iters 10] \
        [--out build/profile]

Builds ``configs/vit_b16_graph2.yaml`` in bf16 through ``Predictor`` with
weights from a seed, warms it up, then for each batch size:

* times the forward with CUDA events (median over ``--iters``);
* runs ``torch.profiler`` over the same number of forwards and prints the
  device time by kernel, the sum of device time per forward and the device's
  idle share of the wall time (1 - busy / wall);
* writes a Chrome trace per batch size under ``--out``.

It needs a CUDA device and exits nonzero without one.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, nargs="+", default=[1, 64])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default="build/profile")
    args = p.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serving: no CUDA device")
    from gavit_tpu_torch import load_config
    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.serving import Predictor

    cfg = load_config(str(ROOT / "configs" / "vit_b16_graph2.yaml"))
    # the graph gates stay zero: the graph kernel runs all the same
    model = Predictor(cfg, precision="bf16", device="cuda", seed=0).model
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    s = cfg.data.image_size
    for b in args.batch:
        imgs = np.random.default_rng(b).integers(0, 256, (b, s, s, 3),
                                                 np.uint8)
        x = val_preprocess(torch.from_numpy(imgs).cuda())
        with torch.inference_mode():
            for _ in range(3):
                model(x)
            torch.cuda.synchronize()
            times = []
            for _ in range(args.iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                model(x)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    model(x)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1000
        # device-side events only (kernels, memsets), so no time is counted
        # twice through the CPU op that launched it
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith(("Command Buffer", "Activity"))]
        busy_ms = sum(e.self_device_time_total for e in events) / 1000
        print(f"[profile] b{b}: forward {statistics.median(times):.3f} ms "
              f"(CUDA events, median of {args.iters}); under the profiler "
              f"wall {wall_ms / args.iters:.3f} ms, device busy "
              f"{busy_ms / args.iters:.3f} ms per forward, idle share "
              f"{1 - busy_ms / wall_ms:.3f}")
        events.sort(key=lambda e: e.self_device_time_total, reverse=True)
        for e in events[:25]:
            print(f"[profile] b{b}   {e.self_device_time_total / 1000 / args.iters:9.4f} "
                  f"ms/fwd  {e.count // args.iters:4d}x/fwd  {e.key[:90]}")
        prof.export_chrome_trace(str(out / f"trace_b{b}.json"))


if __name__ == "__main__":
    main()
