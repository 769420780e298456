"""Run logging (counterpart of ``gavit_tpu/utils/custom_logging.py``): the
root logger with a timestamped file in ``paths.log_dir`` and the console,
the device inventory (torch's CUDA devices in place of JAX's), and the
dataset sizes."""

from __future__ import annotations

import logging
import os
from datetime import datetime

import torch


def setup_logging(config) -> logging.Logger:
    """File + console handlers on the root logger (any handlers it had are
    removed); ``config`` a ``Config`` or its dict. Returns the root
    logger."""
    log_dir = (config["paths"]["log_dir"] if isinstance(config, dict)
               else config.paths.log_dir)
    os.makedirs(log_dir, exist_ok=True)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_file = os.path.join(log_dir, f"training_{timestamp}.log")

    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
        if getattr(h, "_run_log", False):  # an earlier call's file
            h.close()
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    for handler in (logging.FileHandler(log_file), logging.StreamHandler()):
        handler.setFormatter(fmt)
        handler._run_log = True
        root.addHandler(handler)
    root.info(f"Logging to {log_file}")
    return root


def log_system_info() -> None:
    """The device inventory (the JAX package logs its devices): torch's
    and CUDA's versions, then each CUDA device's name, memory, compute
    capability and SMs, or the CPU alone."""
    logger = logging.getLogger(__name__)
    logger.info(f"PyTorch {torch.__version__}, CUDA "
                f"{torch.version.cuda or 'none'}")
    if not torch.cuda.is_available():
        logger.info(f"no CUDA device: cpu ({os.cpu_count()} cores)")
        return
    logger.info(f"{torch.cuda.device_count()} CUDA device(s)")
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        logger.info(f"  device {i}: {p.name}, {p.total_memory / 2**30:.1f} "
                    f"GiB, capability {p.major}.{p.minor}, "
                    f"{p.multi_processor_count} SMs")


def log_dataset_info(train_dataset, val_dataset):
    logger = logging.getLogger(__name__)
    logger.info(f"Training samples: {len(train_dataset)}")
    logger.info(f"Validation samples: {len(val_dataset)}")
    logger.info(f"Diseases: {', '.join(train_dataset.disease_names)}")
