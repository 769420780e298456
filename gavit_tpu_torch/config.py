"""Typed configuration for gavit_tpu_torch: the port's own copy of
``gavit_tpu/config.py`` (same dataclasses, coercion, ``extra``
preservation, presets and ``--set`` overrides), so the port imports nothing
of the JAX package. ``tests/test_torch_config.py`` holds the two readers to
the same result on every file in ``configs/``.

The YAML schema is a strict superset of the reference's
``configs/baseline_config.yaml`` (sections ``data / model / training /
optimizer / paths / wandb`` — see reference ``scripts/train.py:121-122`` which
loads the raw dict). The reference passes the raw nested dict around and
re-parses strings to float at use sites (``src/training/trainer.py:26-34``);
here the YAML is validated once into frozen dataclasses, with the same lenient
string→number coercion so existing YAML files keep working.

Additive (defaulted) sections the reference does not have:
  * ``model.graph``  — the graph-branch configuration (adjacency mode, kNN k,
    similarity threshold, static vs dynamic rebuild, block placement).
  * ``training.precision`` / ``training.seed`` / ``training.max_grad_norm``.
  * ``mesh`` — device-mesh axis sizes for data-parallel training over ICI.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import yaml

# ---------------------------------------------------------------------------
# coercion helpers
# ---------------------------------------------------------------------------


def _as_float(v: Any, name: str) -> float:
    try:
        return float(v)
    except (TypeError, ValueError) as e:
        raise ValueError(f"config field {name!r}: cannot convert {v!r} to float") from e


def _as_int(v: Any, name: str) -> int:
    try:
        return int(v)
    except (TypeError, ValueError) as e:
        raise ValueError(f"config field {name!r}: cannot convert {v!r} to int") from e


def _as_bool(v: Any, name: str) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        if v.lower() in ("true", "yes", "1"):
            return True
        if v.lower() in ("false", "no", "0"):
            return False
    raise ValueError(f"config field {name!r}: cannot convert {v!r} to bool")


_COERCERS = {float: _as_float, int: _as_int, bool: _as_bool, str: lambda v, n: str(v)}


def _build(cls, raw: Mapping[str, Any] | None, path: str):
    """Construct dataclass ``cls`` from a raw mapping with type coercion.

    Unknown keys are preserved in ``extra`` (if the dataclass has one) so
    user YAML keys the framework does not know about are not silently lost.
    """
    raw = dict(raw or {})
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for name, f in fields.items():
        if name == "extra":
            continue
        if name not in raw:
            continue
        v = raw.pop(name)
        if v is None:
            kwargs[name] = None
            continue
        coercer = _COERCERS.get(f.type if isinstance(f.type, type) else None)
        target = _FIELD_TYPES.get((cls.__name__, name))
        if target in _COERCERS:
            kwargs[name] = _COERCERS[target](v, f"{path}.{name}")
        elif target is tuple:
            kwargs[name] = tuple(v) if isinstance(v, (list, tuple)) else (v,)
        elif isinstance(target, type) and dataclasses.is_dataclass(target):
            kwargs[name] = _build(target, v, f"{path}.{name}")
        elif coercer is not None:
            kwargs[name] = coercer(v, f"{path}.{name}")
        else:
            kwargs[name] = v
    if "extra" in fields:
        kwargs["extra"] = dict(raw)
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataConfig:
    """Mirrors reference ``configs/baseline_config.yaml:11-19``."""

    train_dir: str = ""
    val_dir: str = ""
    train_labels: str = ""
    val_labels: str = ""
    chexpert_dir: str = ""
    chexpert_labels: str = ""
    image_size: int = 224
    batch_size: int = 32
    num_workers: int = 4
    # additive: synthetic dataset for smoke tests / benchmarking without data
    synthetic: bool = False
    synthetic_size: int = 512
    # learnable synthetic task (class-region blobs): end-to-end learning check
    synthetic_learnable: bool = False
    prefetch: int = 2
    # RandomAffine in the train pipeline. Default False matches the transform
    # the reference *actually trains with* (scripts/train.py:29-47 — flip +
    # color-jitter only); True adds src/data/transforms.py:17-22 semantics.
    augment_affine: bool = False
    # input pipeline: "threaded" (default) or "grain" — grain adds
    # checkpointable mid-epoch iteration (resume on the next unseen sample)
    # and per-host sharding for multi-host slices
    loader: str = "threaded"
    extra: dict = field(default_factory=dict)


@dataclass(frozen=True)
class GraphConfig:
    """Graph branch: patch-token adjacency + message passing.

    Similarity/kNN adjacency over patch tokens with adjacency-weighted
    aggregation, interleaved with the transformer blocks.
    """

    enabled: bool = False
    num_blocks: int = 1
    # indices of transformer blocks AFTER which a graph block is inserted;
    # None → spread evenly across the depth.
    insert_after: tuple | None = None
    # adjacency construction: 'knn' | 'threshold' | 'dense' | 'learned_static'
    adjacency: str = "knn"
    k: int = 8
    threshold: float = 0.0
    # dynamic=True rebuilds adjacency from the current tokens at every graph
    # block; False builds it once (at the first graph block) and reuses it.
    dynamic: bool = True
    include_cls: bool = False
    temperature: float = 1.0
    extra: dict = field(default_factory=dict)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts blocks (V-MoE family — ``models/moe.py``).

    A model family beyond the reference's dense ViTs: selected blocks
    replace the dense MLP with a top-k-routed expert bank. Expert weights
    shard over the ``model`` mesh axis (expert parallelism)."""

    enabled: bool = False
    num_experts: int = 8
    # experts consulted per token (1 = Switch, 2 = V-MoE default)
    k: int = 2
    # execution engine:
    #  'dense'   — static-capacity one-hot dispatch (V-MoE semantics:
    #              overflow tokens are dropped); EP via GSPMD all-to-alls.
    #  'grouped' — dropless MegaBlocks-style ragged expert GEMMs
    #              (ops/moe_grouped.py): no capacity, no dropped tokens,
    #              no dispatch/combine one-hot GEMMs; EP runs local-expert
    #              grouping + one psum (no all-to-all).
    #  'auto'    — measured policy (models/moe.py::resolve_moe_impl):
    #              tokens/step crossover, resolved per traced shape and
    #              logged — FUSED_MIN_PAIRS (b16/b64 bracket) when the r5
    #              fused megakernel is live, GROUPED_MIN_PAIRS (b64/b128)
    #              otherwise. BASELINE.md r5 rows.
    impl: str = "dense"
    # per-expert buffer = ceil(k · tokens · capacity_factor / num_experts);
    # overflow tokens pass through the residual unchanged ('dense' impl
    # only — 'grouped' is dropless and ignores this)
    capacity_factor: float = 1.25
    # replace the MLP of every ``every``-th block (i % every == every-1:
    # the V-MoE "every other, counting from the back" placement for
    # every=2 on even depths); ``insert_at`` overrides with explicit indices
    every: int = 2
    insert_at: tuple | None = None
    # renormalise the selected top-k gates to sum to 1
    normalize_gates: bool = True
    # rematerialise the grouped engine's expert computation in the backward
    # ('grouped' impl only): the [T, hidden] ragged-GEMM residuals never
    # persist between forward and backward (~1.5 GiB at ViT-B b128 E=8), at
    # the cost of re-running the expert GEMMs once (+33 ms/step measured).
    # Default off since the r4 machinery fixes shrank the non-remat
    # footprint back under a 16 GiB chip at the flagship MoE config
    # (261.8 ms/step vs dense 283.8 — BASELINE.md); flip on when a bigger
    # config OOMs
    grouped_remat: bool = False
    # grouped engine under expert parallelism (mesh.model > 1): static
    # per-expert buffer bound of ceil(T·factor/E) rows over the local token
    # shard — dropless while every expert's realized load stays under
    # factor× the mean. Note: expert-GEMM compute scales with this bound
    # (unused tail rows are booked to the last group and masked out of the
    # combine), so the factor trades drop headroom against FLOPs
    ep_capacity_factor: float = 2.0
    # auxiliary-loss weights (added to the objective by the Trainer)
    aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    extra: dict = field(default_factory=dict)


@dataclass(frozen=True)
class ModelConfig:
    """Mirrors reference ``configs/baseline_config.yaml:21-32`` /
    ``src/models/vit.py:125-127`` defaults, plus the graph branch."""

    name: str = "vit_base_16"
    pretrained_path: str = ""
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 14
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    # rematerialise each transformer/graph block in the backward pass
    # (jax.checkpoint): activation memory drops from O(depth) to O(1) blocks
    # at ~1/3 extra forward FLOPs — enables batch/resolution combinations
    # that otherwise OOM HBM (224px b192+, 384px large-batch)
    remat: bool = False
    graph: GraphConfig = field(default_factory=GraphConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    extra: dict = field(default_factory=dict)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    def graph_insert_after(self) -> tuple:
        """Transformer-block indices after which graph blocks sit."""
        g = self.graph
        if not g.enabled or g.num_blocks <= 0:
            return ()
        if g.insert_after is not None:
            return tuple(int(i) for i in g.insert_after)
        # spread evenly: depth=12, 1 block -> after block 5; 2 -> after 3, 7
        return tuple(
            round((j + 1) * self.depth / (g.num_blocks + 1)) - 1
            for j in range(g.num_blocks)
        )

    def moe_sites(self) -> tuple:
        """Transformer-block indices whose MLP is a mixture of experts."""
        m = self.moe
        if not m.enabled:
            return ()
        if m.insert_at is not None:
            return tuple(int(i) % self.depth for i in m.insert_at)
        every = max(1, int(m.every))
        return tuple(
            i for i in range(self.depth) if i % every == every - 1
        )


# model-name presets (explicit YAML keys always win — applied only when the
# YAML leaves the dimension fields at their dataclass defaults)
MODEL_PRESETS = {
    "vit_tiny_16": dict(embed_dim=192, depth=12, num_heads=3),
    "vit_small_16": dict(embed_dim=384, depth=12, num_heads=6),
    "vit_base_16": dict(embed_dim=768, depth=12, num_heads=12),
    "vit_large_16": dict(embed_dim=1024, depth=24, num_heads=16),
}


@dataclass(frozen=True)
class TrainingConfig:
    """Mirrors reference ``configs/baseline_config.yaml:34-41`` +
    ``trainer.py:26-34`` (max_grad_norm default 1.0)."""

    epochs: int = 150
    learning_rate: float = 1e-4
    weight_decay: float = 0.05
    warmup_epochs: int = 5
    eval_freq: int = 1
    save_freq: int = 5
    early_stopping_patience: int = 10
    max_grad_norm: float = 1.0
    # additive
    precision: str = "bf16"  # 'bf16' | 'fp32'
    seed: int = 42
    # PRNG implementation for dropout/augmentation streams. 'rbg' generates
    # random bits ~3x faster than 'threefry2x32' on TPU (hardware-friendly
    # counter RNG) and is partitionable across the mesh.
    prng_impl: str = "rbg"
    # number of optimizer steps fused into ONE device dispatch via lax.scan.
    # Amortises host→device dispatch latency (large on tunneled TPU setups);
    # logging/metric granularity stays per-step, checkpoints land on
    # chunk boundaries.
    steps_per_call: int = 1
    # micro-batches accumulated into ONE optimizer update (activation memory
    # scales with batch_size/grad_accum_steps — reference-scale global
    # batches on few chips). batch_size must be divisible by it.
    grad_accum_steps: int = 1
    # quantisation-aware training: fake-quantise every GEMM the int8
    # serving path quantises, against static activation scales calibrated
    # at train start — the exported checkpoint then serves int8 with the
    # exact quantisation noise it trained under (gavit_tpu/serving.py).
    qat: bool = False
    criterion_lr_scale: float = 0.1  # reference trainer.py:50 (0.1 x lr)
    # torch AdamW (and the reference) decays EVERY parameter; setting this
    # False masks LayerNorm scales/biases and the cls/pos embeddings from
    # weight decay (common ViT practice)
    weight_decay_all_params: bool = True
    # log the global gradient norm each step (one extra scalar per step)
    log_grad_norm: bool = False
    min_delta: float = 1e-4  # reference trainer.py:71
    log_every: int = 100  # reference trainer.py:141
    extra: dict = field(default_factory=dict)


@dataclass(frozen=True)
class OptimizerConfig:
    """Mirrors reference ``configs/baseline_config.yaml:43-47``."""

    name: str = "adamw"
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    extra: dict = field(default_factory=dict)


@dataclass(frozen=True)
class PathsConfig:
    save_dir: str = "checkpoints"
    log_dir: str = "logs"
    extra: dict = field(default_factory=dict)


@dataclass(frozen=True)
class WandbConfig:
    project: str = "thoracic-disease-classification"
    name: str = "gavit-tpu"
    entity: str = ""
    mode: str = "auto"  # 'auto' | 'disabled' | 'online' | 'offline'
    extra: dict = field(default_factory=dict)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axis sizes. -1 on the data axis → all visible devices.

    The reference is single-device (``scripts/train.py:133``); this section is
    the TPU-native replacement: a ('data',) mesh over ICI with pjit-sharded
    batches and psum-averaged gradients.

    ``fsdp`` turns on ZeRO-3-style fully-sharded data parallelism: parameters
    and optimizer moments are sharded along the 'data' axis (GSPMD inserts
    the all-gathers on use and reduce-scatters the gradients), cutting the
    per-chip state memory ~data-axis-fold for large models. Leaves smaller
    than ``fsdp_min_size`` elements stay replicated (gather overhead beats
    the memory win there). Composes with tensor parallelism ('model' axis).
    """

    data: int = -1
    model: int = 1
    # pipeline parallelism (GPipe, parallel/pp.py): >1 builds a
    # ('pipe', 'data') mesh — each stage owns depth/pipe trunk layers, the
    # Trainer's train/eval steps run the pipelined forward (r5). Composes
    # with dp; model/fsdp/sp stay 1/off under pp (validated loudly).
    pipe: int = 1
    # GPipe microbatches per step; 0 = auto (parallel/pp.py::
    # pick_microbatches — largest of 4·pipe/2·pipe/pipe dividing the batch)
    pipe_microbatches: int = 0
    fsdp: bool = False
    fsdp_min_size: int = 4096
    # sequence parallelism (Megatron-SP): with model > 1, keep the residual
    # stream token-sharded along 'model' through the LayerNorm / dropout /
    # residual-add segments between the matmul regions — GSPMD turns the
    # row-parallel all-reduces into reduce-scatter + all-gather pairs and
    # the elementwise segments compute (and store) 1/tp of the tokens.
    sp: bool = False
    extra: dict = field(default_factory=dict)


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        def conv(x):
            if dataclasses.is_dataclass(x) and not isinstance(x, type):
                d = {}
                for f in dataclasses.fields(x):
                    v = conv(getattr(x, f.name))
                    if f.name == "extra":
                        if v:
                            d.update(v)
                    else:
                        d[f.name] = v
                return d
            if isinstance(x, tuple):
                return list(x)
            return x

        return conv(self)


# explicit per-field coercion targets (dataclass .type may be a string under
# `from __future__ import annotations`, so record the real types here)
_FIELD_TYPES: dict = {}
for _cls in (
    DataConfig,
    GraphConfig,
    MoEConfig,
    ModelConfig,
    TrainingConfig,
    OptimizerConfig,
    PathsConfig,
    WandbConfig,
    MeshConfig,
    Config,
):
    _hints = {
        "str": str,
        "int": int,
        "float": float,
        "bool": bool,
        "tuple": tuple,
        "tuple | None": tuple,
        "GraphConfig": GraphConfig,
        "MoEConfig": MoEConfig,
        "DataConfig": DataConfig,
        "ModelConfig": ModelConfig,
        "TrainingConfig": TrainingConfig,
        "OptimizerConfig": OptimizerConfig,
        "PathsConfig": PathsConfig,
        "WandbConfig": WandbConfig,
        "MeshConfig": MeshConfig,
    }
    for _f in dataclasses.fields(_cls):
        t = _f.type if isinstance(_f.type, str) else getattr(_f.type, "__name__", None)
        if t in _hints:
            _FIELD_TYPES[(_cls.__name__, _f.name)] = _hints[t]


def from_dict(raw: Mapping[str, Any]) -> Config:
    cfg: Config = _build(Config, raw, "config")
    # apply model-name presets only for fields the YAML did not set
    model_raw = dict((raw or {}).get("model") or {})
    preset = MODEL_PRESETS.get(cfg.model.name)
    if preset:
        updates = {k: v for k, v in preset.items() if k not in model_raw}
        if updates:
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, **updates)
            )
    return cfg


def load_config(path: str, overrides: list[str] | None = None) -> Config:
    """Load a YAML config file (reference ``scripts/train.py:121-122``).

    ``overrides``: dotted-key assignments applied on top of the file —
    ``["data.batch_size=64", "mesh.data=1"]`` — values parsed as YAML.
    Lets a shipped config run on different hardware (e.g. v5e8_dp on one
    chip via grad accumulation) without editing the file.
    """
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    for item in overrides or []:
        key, _, value = item.partition("=")
        if not _ or not key:
            raise ValueError(f"override {item!r} is not of the form key=value")
        node = raw
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"override {key!r} crosses a non-dict node")
        node[parts[-1]] = yaml.safe_load(value)
    return from_dict(raw)


def mesh_note(cfg: Config) -> str | None:
    """A log line for a config whose ``mesh`` asks for more than one device
    (the MoE example's ``data: 4, model: 2``): the port reads the mesh and
    runs on one card all the same, as the JAX package does on one device;
    its parallel modes wait for ROADMAP Queue 1 item 13."""
    m = cfg.mesh
    if max(m.data, m.model, m.pipe) <= 1 and not (m.fsdp or m.sp):
        return None
    return (f"config mesh data={m.data} model={m.model} pipe={m.pipe} "
            f"fsdp={m.fsdp} sp={m.sp} read and not used: the port runs on "
            f"one card")


def unused_note(cfg: Config) -> str | None:
    """A log line naming each field that is set away from its default and
    that the port reads and does not use: ``training.prng_impl`` (JAX's
    generator; the port's masks are Philox4x32-10 whatever it names).
    None when it is not set."""
    default = TrainingConfig().prng_impl
    if cfg.training.prng_impl == default:
        return None
    return (f"config training.prng_impl={cfg.training.prng_impl} read and "
            f"not used: the port draws Philox masks")
