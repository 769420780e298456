#!/usr/bin/env python
"""Checkpoint conversion for the PyTorch port (counterpart of
``scripts/convert_checkpoint.py``).

    # reference-layout .pt/.pth (an MAE encoder or a reference model) →
    # the port's checkpoint directory (state.pt + meta.json)
    python scripts/convert_checkpoint_torch.py --to-jax model.pth out_dir \\
        --config configs/baseline_config.yaml

    # the port's checkpoint → a reference-layout .npz
    python scripts/convert_checkpoint_torch.py --to-torch ckpt_dir out.npz

    # a dense checkpoint → an MoE-init checkpoint (sparse upcycling)
    python scripts/convert_checkpoint_torch.py --upcycle-moe dense_dir \\
        out_dir --config configs/examples/vit_b16_moe.yaml

The direction names are the JAX script's: ``--to-jax`` writes this
framework's checkpoint (here the port's, not orbax), ``--to-torch`` the
reference's layout. The first follows the reference's MAE loading
(``utils/torch_convert.py::load_mae_weights``): head weights dropped, the
position embeddings interpolated to the config's grid, over weights from
``training.seed``; the checkpoint holds step 0, the model and a fresh
criterion, which ``scripts/evaluate_torch.py`` and the serving
``Predictor`` read. The second reads the model's config from the
checkpoint's ``meta.json`` (``--config`` where it has none). The upcycle
takes ``--config`` describing the MoE model (``model.moe.enabled: true``)
and a source of the same architecture with MoE off: every expert starts
as its block's dense MLP and the router at zero
(``models/moe.py::upcycle_params``).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

logger = logging.getLogger("convert_checkpoint_torch")


def _fresh_model(model_cfg, seed: int):
    from gavit_tpu_torch.models.vit import build_model, init_params

    return init_params(build_model(model_cfg, precision="fp32"),
                       torch.Generator().manual_seed(seed))


def _save(dst: str, model, criterion_state, meta: dict) -> None:
    from gavit_tpu_torch.utils import checkpoint as ckpt_lib

    ckpt_lib.save(dst, {"step": 0, "model": model.state_dict(),
                        "criterion": criterion_state}, meta)


def to_port(src: str, dst: str, config) -> None:
    from gavit_tpu_torch.training.losses import DynamicWeightedLoss
    from gavit_tpu_torch.utils.torch_convert import load_mae_weights

    model = _fresh_model(config.model, config.training.seed)
    load_mae_weights(model, src)
    _save(dst, model, DynamicWeightedLoss().state_dict(),
          {"converted_from": src, "config": config.to_dict()})
    logger.info(f"Wrote the port's checkpoint: {dst}")


def to_npz(src: str, dst: str, config) -> None:
    from gavit_tpu_torch.config import from_dict
    from gavit_tpu_torch.models.vit import build_model
    from gavit_tpu_torch.utils import checkpoint as ckpt_lib
    from gavit_tpu_torch.utils.torch_convert import params_to_torch_state_dict

    state, meta = ckpt_lib.restore(src, map_location="cpu")
    if "config" in meta:
        config = from_dict(meta["config"])
    model = build_model(config.model, precision="fp32")
    model.load_state_dict(state["model"])
    sd = params_to_torch_state_dict(model)
    np.savez(dst, **sd)
    logger.info(f"Wrote torch-layout npz: {dst} ({len(sd)} tensors)")


def _modules(state_dict) -> set:
    """The top-level modules a state dict holds (``blocks.3``,
    ``graphs.0``, ``norm``, ``cls_token``, ...)."""
    out = set()
    for key in state_dict:
        parts = key.split(".")
        out.add(".".join(parts[:2]) if parts[0] in ("blocks", "graphs")
                else parts[0])
    return out


def upcycle_moe(src: str, dst: str, config) -> None:
    from gavit_tpu_torch.config import MoEConfig
    from gavit_tpu_torch.models.moe import upcycle_params
    from gavit_tpu_torch.training.losses import DynamicWeightedLoss
    from gavit_tpu_torch.utils import checkpoint as ckpt_lib
    from gavit_tpu_torch.utils.convert import load_flax_params, to_flax_tree

    if not config.model.moe.enabled:
        raise SystemExit("--upcycle-moe needs model.moe.enabled: true "
                         "in --config")
    state, _ = ckpt_lib.restore(src, map_location="cpu")
    dense = _fresh_model(dataclasses.replace(config.model, moe=MoEConfig()),
                         config.training.seed)
    # the source really is this architecture without MoE
    missing = sorted(_modules(dense.state_dict()) - _modules(state["model"]))
    if missing:
        raise SystemExit(f"source checkpoint lacks {missing}; it must be "
                         "the same architecture with moe disabled")
    dense.load_state_dict(state["model"])
    moe_model = _fresh_model(config.model, config.training.seed)
    load_flax_params(moe_model, upcycle_params(
        to_flax_tree(dense), to_flax_tree(moe_model), config.model))
    _save(dst, moe_model,
          state.get("criterion") or DynamicWeightedLoss().state_dict(),
          {"upcycled_from": src, "config": config.to_dict()})
    logger.info(f"Wrote upcycled MoE checkpoint: {dst}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    direction = p.add_mutually_exclusive_group(required=True)
    direction.add_argument(
        "--to-jax", action="store_true",
        help="reference-layout .pt/.pth -> this framework's (the port's) "
             "checkpoint directory")
    direction.add_argument(
        "--to-torch", action="store_true",
        help="the port's checkpoint directory -> reference-layout .npz")
    direction.add_argument(
        "--upcycle-moe", action="store_true",
        help="dense port checkpoint -> MoE-init checkpoint (sparse "
             "upcycling; --config describes the MoE model)")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--config", default="configs/baseline_config.yaml")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted-key config overrides")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    from gavit_tpu_torch.config import load_config

    config = load_config(args.config, args.overrides)
    if args.to_jax:
        to_port(args.src, args.dst, config)
    elif args.upcycle_moe:
        upcycle_moe(args.src, args.dst, config)
    else:
        to_npz(args.src, args.dst, config)


if __name__ == "__main__":
    main()
