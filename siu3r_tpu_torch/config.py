"""Typed configuration tree.

Mirrors the reference's dataclass schema (src/config.py:26-145) so configs are
interchangeable concept-for-concept; loading is plain-YAML -> dataclasses (no
hydra dependency) with dotted-key CLI overrides.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Literal, Optional


@dataclass
class CrocoCfg:
    """reference src/config.py:46-57"""

    enc_depth: int = 24
    dec_depth: int = 12
    enc_embed_dim: int = 1024
    dec_embed_dim: int = 768
    enc_num_heads: int = 16
    dec_num_heads: int = 12
    pos_embed: str = "RoPE100"
    patch_size: int = 16
    freeze: str = "encoder"

    @property
    def rope_base(self) -> float:
        assert self.pos_embed.startswith("RoPE")
        return float(self.pos_embed[len("RoPE"):])


@dataclass
class Mask2formerCfg:
    """reference src/config.py:59-65 + the HF Mask2FormerConfig defaults the
    reference inherits (hidden_dim 256, 8 heads, ffw 2048, 9+1 decoder layers,
    6 pixel-decoder layers, 100 queries)."""

    id2label: dict[int, str] = field(default_factory=dict)
    seg_threshold: float = 0.5
    label_ids_to_fuse: list[int] = field(default_factory=list)
    num_queries: int = 100
    # HF Mask2FormerConfig defaults (transformers Mask2FormerConfig)
    hidden_dim: int = 256
    num_attention_heads: int = 8
    dim_feedforward: int = 2048
    decoder_layers: int = 10  # 10-1 = 9 masked-attn layers (ref :1186)
    encoder_layers: int = 6
    encoder_feedforward_dim: int = 1024
    feature_size: int = 256
    mask_feature_size: int = 256
    common_stride: int = 4
    feature_strides: tuple[int, ...] = (4, 8, 16, 32)
    no_object_weight: float = 0.1
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    train_num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    pre_norm: bool = False
    enforce_input_projection: bool = False
    train_refer_segmentation: bool = False
    # vocab for the learned text embedder (ours: the reference ships NO text
    # encoder — ScanRefer provides pre-tokenized ``text_token`` ids and
    # VideoMask2Former consumes ready word_embeddings,
    # video_seg_decoder.py:2400-2443; 49408 = CLIP BPE vocab size)
    text_vocab_size: int = 49408
    # fixed padded query budget for jit-able panoptic lift (ours; the
    # reference keeps ragged per-image kept-query lists)
    max_lift_queries: int = 16

    @property
    def num_labels(self) -> int:
        return len(self.id2label)


@dataclass
class GaussianHeadCfg:
    """reference src/config.py:67-71"""

    gaussian_scale_min: float = 0.5
    gaussian_scale_max: float = 15.0
    sh_degree: int = 4

    @property
    def d_sh(self) -> int:
        return (self.sh_degree + 1) ** 2

    @property
    def raw_dim(self) -> int:
        # sh*3 + 3 scale + 4 rotation + 1 opacity (reference model.py:91-93)
        return 3 * self.d_sh + 3 + 4 + 1


@dataclass
class ModelCfg:
    """reference src/config.py:74-80"""

    croco: CrocoCfg = field(default_factory=CrocoCfg)
    mask2former: Mask2formerCfg = field(default_factory=Mask2formerCfg)
    gaussian_head: GaussianHeadCfg = field(default_factory=GaussianHeadCfg)
    image_size: tuple[int, int] = (256, 256)
    pretrained_weights_path: Optional[str] = None
    num_views: int = 2
    # compute dtype for the backbone/adapter/decoder matmuls ("float32" or
    # "bfloat16"); params are always fp32
    dtype: str = "float32"


@dataclass
class OptimizerCfg:
    """reference src/config.py:26-29 + pipeline.py:366-423 group multipliers"""

    lr: float = 1e-4
    warm_up_epochs: int = 3  # reference configs/main.yaml:26
    weight_decay: float = 0.05
    betas: tuple[float, float] = (0.9, 0.95)
    gaussian_head_lr_mult: float = 5.0
    seg_lr_mult: float = 3.0
    base_lr_mult: float = 0.1


@dataclass
class TrainerCfg:
    max_epochs: int = 100
    max_steps: int = -1  # Lightning Trainer(max_steps): -1 = unlimited
    devices: int = 8
    accumulate_grad_batches: int = 1
    gradient_clip_val: float = 1.0  # reference configs/main.yaml:19
    check_val_every_n_epoch: int = 100
    log_every_n_steps: int = 10
    precision: str = "32"
    # ZeRO-1 optimizer-state sharding over the data axis (TPU-native
    # extension; numerically identical to plain DP — see
    # Pipeline.make_zero1_dp_train_step). Frees ~(N-1)/N of the Adam-moment
    # HBM per chip; needed for V=8 multi-view training on 16 GB chips.
    zero1: bool = False


@dataclass
class VisualizerCfg:
    log_colored_depth: bool = False
    log_rendered_video: bool = False
    log_gaussian_ply: bool = False
    save_sh_dc_only: bool = True
    dataset_name: str = "scannet"
    overlay_mask_alpha: float = 0.5
    write_to: str = "outputs"


@dataclass
class EvaluatorCfg:
    dataset_name: str = "scannet"
    eval_context_miou: bool = True
    eval_context_pq: bool = True
    eval_context_map: bool = True
    eval_target_miou: bool = True
    eval_target_pq: bool = True
    eval_target_map: bool = True
    eval_image_quality: bool = True
    eval_depth_quality: bool = True
    id2label: dict[int, str] = field(default_factory=dict)
    stuffs: list[int] = field(default_factory=list)
    things: list[int] = field(default_factory=list)
    eval_path: Optional[str] = None


@dataclass
class DatasetCfg:
    name: str = "scannet"
    root: str = "data/scannet"
    image_height: int = 256
    image_width: int = 256
    seg_task: str = "panoptic"
    num_context_views: int = 2
    num_extra_context_views: int = 0
    num_extra_target_views: int = 0
    min_views_overlap: float = 0.3
    max_views_overlap: float = 0.8
    # GT objects padded to this fixed count (jit-able batching); must be
    # <= mask2former.num_queries for every object to be matchable
    max_objects: int = 48


@dataclass
class DataLoaderCfg:
    batch_size: int = 3
    num_workers: int = 4
    shuffle: bool = True


@dataclass
class DatamoduleCfg:
    dataset_cfg: DatasetCfg = field(default_factory=DatasetCfg)
    train_loader_cfg: DataLoaderCfg = field(default_factory=DataLoaderCfg)
    val_loader_cfg: DataLoaderCfg = field(default_factory=DataLoaderCfg)
    test_loader_cfg: DataLoaderCfg = field(default_factory=DataLoaderCfg)


@dataclass
class PipelineCfg:
    log_training_result_interval: int = 400
    pretrained_weights_path: str = "pretrained_weights"
    weight_seg_loss: float = 0.05
    enable_instance_depth_smoothness: bool = True
    weight_depth_smoothness: float = 0.05
    model: ModelCfg = field(default_factory=ModelCfg)
    visualizer: VisualizerCfg = field(default_factory=VisualizerCfg)
    evaluator: EvaluatorCfg = field(default_factory=EvaluatorCfg)


@dataclass
class RootCfg:
    trainer: TrainerCfg = field(default_factory=TrainerCfg)
    optimizer: OptimizerCfg = field(default_factory=OptimizerCfg)
    datamodule: DatamoduleCfg = field(default_factory=DatamoduleCfg)
    pipeline: PipelineCfg = field(default_factory=PipelineCfg)
    project: str = "siu3r_tpu"
    experiment: str = "default"
    output_path: Optional[str] = None
    ckpt_path: Optional[str] = None
    mode: Literal["train", "test", "val"] = "train"
    seed: int = 0


def _from_dict(cls, data: Any):
    if data is None:
        return None
    if dataclasses.is_dataclass(cls):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in (data or {}).items():
            if key not in fields:
                raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
            ftype = fields[key].type
            resolved = _resolve_type(ftype, cls)
            if dataclasses.is_dataclass(resolved) and isinstance(value, dict):
                kwargs[key] = _from_dict(resolved, value)
            else:
                kwargs[key] = value
        return cls(**kwargs)
    return data


def _resolve_type(ftype, owner):
    if isinstance(ftype, str):
        import sys

        mod = sys.modules[owner.__module__]
        return getattr(mod, ftype, ftype) if isinstance(ftype, str) else ftype
    return ftype


def load_config(path: Optional[str | Path] = None, overrides: Optional[list[str]] = None) -> RootCfg:
    """Load a YAML config file (optional) and apply ``a.b.c=value`` overrides."""
    import yaml

    data: dict = {}
    if path is not None:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
    cfg = _from_dict(RootCfg, data)
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        target = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            target = getattr(target, p)
        current = getattr(target, parts[-1], None)
        value: Any = yaml.safe_load(raw)
        if current is not None and not isinstance(current, (dict, list, tuple)):
            value = type(current)(value)
        setattr(target, parts[-1], value)
    return cfg


def bind_scannet_classes(cfg: RootCfg) -> RootCfg:
    """Wire dataset-dependent class tables (reference src/config.py:166-199):
    ScanNet-20 / ADE20K / COCO selected by the dataset name."""
    name = cfg.datamodule.dataset_cfg.name
    if name in ("ade20k", "coco"):
        from siu3r_tpu_torch.utils import class_constants as cc

        id2label = cc.panoptic_id2name(name)
        stuffs = cc.stuff_classes(name)
        things = cc.thing_classes(name)
    else:
        from siu3r_tpu_torch.utils.scannet_constant import (
            PANOPTIC_SEMANTIC2NAME,
            STUFF_CLASSES,
            THING_CLASSES,
        )

        id2label = dict(PANOPTIC_SEMANTIC2NAME)
        stuffs = list(STUFF_CLASSES)
        things = list(THING_CLASSES)

    m2f = cfg.pipeline.model.mask2former
    if not m2f.id2label:
        m2f.id2label = id2label
        m2f.label_ids_to_fuse = list(stuffs)
    ev = cfg.pipeline.evaluator
    if not ev.id2label:
        ev.id2label = id2label
        ev.stuffs = list(stuffs)
        ev.things = list(things)
    return cfg
