"""Run logging (the port's copy of ``log_dataset_info`` from
``gavit_tpu/utils/custom_logging.py``)."""

from __future__ import annotations

import logging


def log_dataset_info(train_dataset, val_dataset):
    logger = logging.getLogger(__name__)
    logger.info(f"Training samples: {len(train_dataset)}")
    logger.info(f"Validation samples: {len(val_dataset)}")
    logger.info(f"Diseases: {', '.join(train_dataset.disease_names)}")
