#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving forward, on a card.

    python3 tools/profile_torch_serving.py [--batch 1 64] [--iters 10] \
        [--precision bf16|int8] [--tome-r R] [--out build/profile]

Builds ``configs/vit_b16_graph2.yaml`` through ``Predictor`` with weights
from a seed (int8: calibrated on 8 noise images from
``np.random.default_rng(0)``, as its warm-up does; ``--tome-r``: the
forward of ``models/tome.py`` with R merges after every block), warms it
up, then for each batch size:

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
    p.add_argument("--precision", default="bf16", choices=["bf16", "int8"])
    p.add_argument("--tome-r", type=int, default=0)
    args = p.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serving: no CUDA device")
    from gavit_tpu_torch import load_config
    from gavit_tpu_torch.models.tome import tome_forward
    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.serving import Predictor

    cfg = load_config(str(ROOT / "configs" / "vit_b16_graph2.yaml"))
    # the graph gates stay zero: the graph kernel runs all the same
    pred = Predictor(cfg, precision=args.precision, device="cuda", seed=0,
                     tome_r=args.tome_r)
    s = cfg.data.image_size
    if args.precision == "int8":
        pred.calibrate(np.random.default_rng(0).integers(
            0, 256, (8, s, s, 3), np.uint8))
    model = pred.model

    def forward(x):
        return (tome_forward(model, x, args.tome_r) if args.tome_r
                else model(x))

    what = args.precision + (f" ToMe r={args.tome_r}" if args.tome_r else "")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for b in args.batch:
        imgs = np.random.default_rng(b).integers(0, 256, (b, s, s, 3),
                                                 np.uint8)
        x = val_preprocess(torch.from_numpy(imgs).cuda())
        with torch.inference_mode():
            for _ in range(3):
                forward(x)
            torch.cuda.synchronize()
            times = []
            for _ in range(args.iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                forward(x)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    forward(x)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1000
        # device-side events only (kernels, memsets), so no time is counted
        # twice through the CPU op that launched it
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith(("Command Buffer", "Activity"))]
        busy_ms = sum(e.self_device_time_total for e in events) / 1000
        print(f"[profile] {what} b{b}: forward "
              f"{statistics.median(times):.3f} ms "
              f"(CUDA events, median of {args.iters}); under the profiler "
              f"wall {wall_ms / args.iters:.3f} ms, device busy "
              f"{busy_ms / args.iters:.3f} ms per forward, idle share "
              f"{1 - busy_ms / wall_ms:.3f}")
        events.sort(key=lambda e: e.self_device_time_total, reverse=True)
        for e in events[:25]:
            print(f"[profile] {what} b{b}   "
                  f"{e.self_device_time_total / 1000 / args.iters:9.4f} "
                  f"ms/fwd  {e.count // args.iters:4d}x/fwd  {e.key[:90]}")
        tag = what.replace(" ", "_").replace("=", "")
        prof.export_chrome_trace(str(out / f"trace_{tag}_b{b}.json"))


if __name__ == "__main__":
    main()
