#!/usr/bin/env python
"""Export a serving artifact of the PyTorch port: one ``torch.export``
program per batch bucket, the weights beside them, and a manifest.

    python scripts/export_serving_torch.py --config <yaml> --out ARTIFACT \
        [--checkpoint CKPT_DIR | --weights params.npz] \
        [--precision bf16|fp32|int8] [--calib calib.npy] [--tome-r R] \
        [--buckets 1,8,32,128] [--device cuda] [--set key=value]

The artifact is served without the model code by
``gavit_tpu_torch.serving.ExportedPredictor`` or ``scripts/serve_torch.py
--artifact``, on the device type it was exported on (``--device``; the
programs of a CUDA artifact call the kernels' custom ops, registered by
importing ``gavit_tpu_torch.ops``). ``--precision int8`` needs ``--calib``
(a ``.npy`` of uint8 images ``[N, S, S, 3]``) unless the checkpoint carries
QAT-trained scales.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default="",
                   help="checkpoint directory of scripts/train_torch.py")
    p.add_argument("--weights", default="",
                   help="npz of '/'-joined Flax parameter paths (default: "
                        "random weights from a seed)")
    p.add_argument("--out", required=True)
    p.add_argument("--precision", default="bf16",
                   choices=["bf16", "fp32", "int8"])
    p.add_argument("--calib", default="",
                   help="int8: .npy of uint8 calibration images "
                        "[N, S, S, 3] (unneeded for QAT checkpoints: their "
                        "trained scales ride along)")
    p.add_argument("--tome-r", type=int, default=0)
    p.add_argument("--buckets", default="1,8,32,128",
                   help="comma-separated batch buckets to export")
    p.add_argument("--device", default="cuda",
                   help="the device the artifact is exported for and "
                        "serves on")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE")
    args = p.parse_args(argv)
    if args.checkpoint and args.weights:
        p.error("--checkpoint and --weights are exclusive")

    logging.basicConfig(level=logging.INFO)
    from gavit_tpu_torch.config import load_config
    from gavit_tpu_torch.serving import export_serving

    config = load_config(args.config, args.overrides)
    calib = None
    if args.calib:
        import numpy as np

        calib = np.load(args.calib)
    manifest = export_serving(
        config, args.out, checkpoint_path=args.checkpoint or None,
        weights=args.weights or None, precision=args.precision,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        tome_r=args.tome_r, device=args.device, calibration_images=calib)
    logging.info("Exported %s (%s, buckets %s, %s) -> %s", manifest["model"],
                 manifest["precision"], manifest["buckets"],
                 manifest["device"], args.out)
    return manifest


if __name__ == "__main__":
    main()
