"""wandb-compatible metric sink (the port's copy of
``gavit_tpu/utils/wandb_compat.py``).

The same ``init/log/finish`` surface: real wandb when installed and
enabled, otherwise a JSONL-file sink under ``paths.log_dir`` (one record a
``log`` call, the config as a header), so every metric is still on disk.
Unlike the JAX module it imports wandb only when ``wandb.mode`` is not
``disabled``: a disabled run never loads it (wandb's import and init reach
for the network).
"""

from __future__ import annotations

import json
import logging
import os
import time

logger = logging.getLogger(__name__)


class _JsonlRun:
    """File-backed stand-in with wandb's Run surface."""

    def __init__(self, log_dir: str, name: str, config=None):
        os.makedirs(log_dir, exist_ok=True)
        self.name = name
        self._path = os.path.join(log_dir, f"metrics_{name}_{int(time.time())}.jsonl")
        self._f = open(self._path, "a")
        self._step = 0
        if config is not None:
            header = {"_type": "config", "config": config}
            self._f.write(json.dumps(header, default=str) + "\n")

    def log(self, data: dict, step: int | None = None):
        rec = {"_step": self._step if step is None else step}
        for k, v in data.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self._step += 1

    def finish(self):
        self._f.close()


def init(config, log_dir: str = "logs"):
    """wandb.init-equivalent."""
    wb = config.get("wandb", {}) if isinstance(config, dict) else config.to_dict()[
        "wandb"
    ]
    mode = wb.get("mode", "auto")
    cfg_dict = config if isinstance(config, dict) else config.to_dict()
    _wandb = None
    if mode not in ("disabled",):
        try:  # wandb is optional
            import wandb as _wandb
        except Exception:  # pragma: no cover - depends on environment
            _wandb = None
    if _wandb is not None:
        try:
            return _wandb.init(
                project=wb.get("project"),
                name=wb.get("name"),
                entity=wb.get("entity") or None,
                config=cfg_dict,
                reinit=True,
                mode="offline" if mode == "offline" else None,
            )
        except Exception as e:  # no API key / no network → file sink
            logger.warning(f"wandb.init failed ({e}); falling back to JSONL sink")
    return _JsonlRun(log_dir, wb.get("name", "run"), cfg_dict)
