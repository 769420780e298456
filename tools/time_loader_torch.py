#!/usr/bin/env python3
"""The threaded loader's images/s alone, in a process of its own: the
measurement ``chip_smoke.py``'s data phase takes late in that script
(``chip_smoke.loader_rates``), taken here with nothing run before it.

Writes ``chip_smoke.py``'s PNG corpus from its SEED (``--train`` grayscale
1024 x 1024 PNGs of NIH ChestX-ray14's format, 1,024 by default) under
``build/loader_time/``, packs it at 224 px with
``scripts/prepare_dataset_torch.py``, prints one line of images/s over the
PNGs at 4, 8 and 16 decode threads and over the pack, with the card's
name and power limit beside it where ``nvidia-smi`` answers, and removes
the corpus. The loader runs on the host only; no card is needed.

    python3 tools/time_loader_torch.py [--train N]
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
import prepare_dataset_torch  # noqa: E402
from gavit_tpu_torch.data.dataset import PackedChestXrayDataset  # noqa: E402

OUT = ROOT / "build" / "loader_time"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--train", type=int, default=1024,
                   help="PNGs to write and read")
    args = p.parse_args(argv)
    try:
        card = chip_smoke.card_line()
    except (OSError, subprocess.SubprocessError):
        card = "no nvidia-smi"
    shutil.rmtree(OUT, ignore_errors=True)
    try:
        img_dir, labels = chip_smoke.write_corpus(
            OUT / "train", args.train, chip_smoke.SEED, chip_smoke.DATA_PNG)
        prepare_dataset_torch.main(["--image-dir", str(img_dir), "--labels",
                                    str(labels), "--out", str(OUT / "packed"),
                                    "--image-size", "224"])
        packed = PackedChestXrayDataset(str(OUT / "packed"))
        print(chip_smoke.loader_rates(img_dir, labels, packed, 224, card),
              flush=True)
    finally:
        shutil.rmtree(OUT, ignore_errors=True)


if __name__ == "__main__":
    main()
