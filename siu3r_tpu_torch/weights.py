"""JAX variables -> the port's ``state_dict``.

``state_dict_from_jax`` takes the JAX package's ``{"params", "batch_stats"}``
tree (as numpy arrays) and returns torch tensors under the reference's torch
names, the names the port's modules carry. It is the exact inverse of
``siu3r_tpu.checkpoint.convert_siu3r_state_dict``:

* scan-stacked blocks are un-stacked along axis 0;
* Dense kernels [in, out] -> Linear weights [out, in];
* Conv kernels [kh, kw, I, O] -> [O, I, kh, kw] (ConvTranspose kernels
  [kh, kw, O, I] -> [I, O, kh, kw], the same permutation);
* LayerNorm/GroupNorm/BatchNorm ``scale`` -> ``weight``; BatchNorm
  ``mean``/``var`` -> ``running_mean``/``running_var``;
* separate q/k/v Dense -> packed ``in_proj_weight``/``in_proj_bias``.

The BatchNorm statistics (flax ``batch_stats``) become the BatchNorm
buffers. ``lpips_params_from_jax`` carries the LPIPS network's parameters.
A reference Lightning ``.ckpt`` loads into the port through
``load_checkpoint``, which strips the pipeline's ``model.`` prefix.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from siu3r_tpu_torch.config import ModelCfg

State = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32)))


def _linear(out: State, tree, prefix: str) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _conv(out: State, tree, prefix: str) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


_conv_transpose = _conv  # [kh, kw, O, I] -> [I, O, kh, kw]: the same permutation


def _norm(out: State, tree, prefix: str) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def _bn(out: State, params, stats, prefix: str) -> None:
    _norm(out, params, prefix)
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _mha(out: State, tree, prefix: str) -> None:
    out[f"{prefix}.in_proj_weight"] = _t(
        np.concatenate([np.asarray(tree[k]["kernel"]).T for k in ("q_proj", "k_proj", "v_proj")])
    )
    out[f"{prefix}.in_proj_bias"] = _t(
        np.concatenate([np.asarray(tree[k]["bias"]) for k in ("q_proj", "k_proj", "v_proj")])
    )
    _linear(out, tree["out_proj"], f"{prefix}.out_proj")


def _unstack(tree, i: int):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _enc_block(out: State, t, p: str) -> None:
    _norm(out, t["norm1"], f"{p}.norm1")
    _linear(out, t["attn"]["qkv"], f"{p}.attn.qkv")
    _linear(out, t["attn"]["proj"], f"{p}.attn.proj")
    _norm(out, t["norm2"], f"{p}.norm2")
    _linear(out, t["mlp"]["fc1"], f"{p}.mlp.fc1")
    _linear(out, t["mlp"]["fc2"], f"{p}.mlp.fc2")


def _dec_block(out: State, t, p: str) -> None:
    _enc_block(out, t, p)
    for name in ("projq", "projk", "projv", "proj"):
        _linear(out, t["cross_attn"][name], f"{p}.cross_attn.{name}")
    _norm(out, t["norm3"], f"{p}.norm3")
    _norm(out, t["norm_y"], f"{p}.norm_y")


def _backbone(out: State, t, cfg: ModelCfg) -> None:
    c = cfg.croco
    _conv(out, t["patch_embed"]["proj"], "backbone.patch_embed.proj")
    _linear(out, t["intrinsic_encoder"], "backbone.intrinsic_encoder")
    for i in range(c.enc_depth):
        _enc_block(out, _unstack(t["enc_blocks"]["block"], i), f"backbone.enc_blocks.{i}")
    _norm(out, t["enc_norm"], "backbone.enc_norm")
    _linear(out, t["decoder_embed"], "backbone.decoder_embed")
    for i in range(c.dec_depth):
        pair = _unstack(t["dec_blocks"], i)
        _dec_block(out, pair["block1"], f"backbone.dec_blocks.{i}")
        _dec_block(out, pair["block2"], f"backbone.dec_blocks2.{i}")
    _norm(out, t["dec_norm"], "backbone.dec_norm")


def _msdeform(out: State, t, p: str) -> None:
    for name in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        _linear(out, t[name], f"{p}.{name}")


def _extractor(out: State, t, p: str) -> None:
    for name in ("query_norm", "feat_norm", "ffn_norm"):
        _norm(out, t[name], f"{p}.{name}")
    _msdeform(out, t["attn"], f"{p}.attn")
    _linear(out, t["ffn"]["fc1"], f"{p}.ffn.fc1")
    _linear(out, t["ffn"]["fc2"], f"{p}.ffn.fc2")
    _conv(out, t["ffn"]["dwconv"]["dwconv"], f"{p}.ffn.dwconv.dwconv")


def _adapter(out: State, t, stats, n_interactions: int) -> None:
    out["adapter.level_embed"] = _t(t["level_embed"])
    spm, spm_stats = t["spm"], stats["spm"]
    for name, conv, bn in (
        ("stem1", "stem.0", "stem.1"),
        ("stem2", "stem.3", "stem.4"),
        ("stem3", "stem.6", "stem.7"),
        ("conv2", "conv2.0", "conv2.1"),
        ("conv3", "conv3.0", "conv3.1"),
        ("conv4", "conv4.0", "conv4.1"),
    ):
        _conv(out, spm[name]["conv"], f"adapter.spm.{conv}")
        _bn(out, spm[name]["norm"]["bn"], spm_stats[name]["norm"]["bn"], f"adapter.spm.{bn}")
    for i in range(1, 5):
        _conv(out, spm[f"fc{i}"], f"adapter.spm.fc{i}")
    for i in range(n_interactions):
        inter = t[f"interactions_{i}"]
        _extractor(out, inter["extractor"], f"adapter.interactions.{i}.extractor")
        for j in range(2):
            if f"extra_extractors_{j}" in inter:
                _extractor(out, inter[f"extra_extractors_{j}"], f"adapter.interactions.{i}.extra_extractors.{j}")
    _conv_transpose(out, t["up"], "adapter.up")
    for i in range(1, 5):
        _bn(out, t[f"norm{i}"]["bn"], stats[f"norm{i}"]["bn"], f"adapter.norm{i}")


def _mask2former(out: State, t, cfg: ModelCfg) -> None:
    m = cfg.mask2former
    pd, tpd = "mask2former.model.pixel_decoder", t["pixel_decoder"]
    out[f"{pd}.level_embed"] = _t(tpd["level_embed"])
    _conv(out, tpd["mask_projection"], f"{pd}.mask_projection")
    _conv(out, tpd["adapter_1"]["conv"], f"{pd}.adapter_1.0")
    _norm(out, tpd["adapter_1"]["norm"], f"{pd}.adapter_1.1")
    _conv(out, tpd["layer_1_conv"], f"{pd}.layer_1.0")
    _norm(out, tpd["layer_1_norm"], f"{pd}.layer_1.1")
    for i in range(3):
        _conv(out, tpd[f"input_projections_{i}"]["conv"], f"{pd}.input_projections.{i}.0")
        _norm(out, tpd[f"input_projections_{i}"]["norm"], f"{pd}.input_projections.{i}.1")
    for i in range(m.encoder_layers):
        p, lt = f"{pd}.encoder.layers.{i}", tpd[f"encoder_layers_{i}"]
        _msdeform(out, lt, f"{p}.self_attn")
        _norm(out, lt["self_attn_layer_norm"], f"{p}.self_attn_layer_norm")
        _linear(out, lt["fc1"], f"{p}.fc1")
        _linear(out, lt["fc2"], f"{p}.fc2")
        _norm(out, lt["final_layer_norm"], f"{p}.final_layer_norm")

    tm, ttm = "mask2former.model.transformer_module", t["transformer_module"]
    for name in ("level_embed", "queries_embedder", "queries_features"):
        out[f"{tm}.{name}.weight"] = _t(ttm[name]["embedding"])
    _norm(out, ttm["layernorm"], f"{tm}.decoder.layernorm")
    for i in range(3):
        _linear(
            out, ttm["mask_predictor"]["mask_embedder"][f"layers_{i}"],
            f"{tm}.decoder.mask_predictor.mask_embedder.{i}.0",
        )
    for i in range(m.decoder_layers - 1):
        p, lt = f"{tm}.decoder.layers.{i}", ttm[f"layers_{i}"]
        _mha(out, lt["cross_attn"], f"{p}.cross_attn")
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(out, lt["self_attn"][name], f"{p}.self_attn.{name}")
        for name in ("cross_attn_layer_norm", "self_attn_layer_norm", "final_layer_norm"):
            _norm(out, lt[name], f"{p}.{name}")
        _linear(out, lt["fc1"], f"{p}.fc1")
        _linear(out, lt["fc2"], f"{p}.fc2")
    _linear(out, t["class_predictor"], "mask2former.class_predictor")


def _dpt_head(out: State, t, p: str, head_type: str) -> None:
    _conv(out, t["act_0_conv"], f"{p}.dpt.act_postprocess.0.0")
    _conv_transpose(out, t["act_0_up"], f"{p}.dpt.act_postprocess.0.1")
    _conv(out, t["act_1_conv"], f"{p}.dpt.act_postprocess.1.0")
    _conv_transpose(out, t["act_1_up"], f"{p}.dpt.act_postprocess.1.1")
    _conv(out, t["act_2_conv"], f"{p}.dpt.act_postprocess.2.0")
    _conv(out, t["act_3_conv"], f"{p}.dpt.act_postprocess.3.0")
    _conv(out, t["act_3_down"], f"{p}.dpt.act_postprocess.3.1")
    for i in range(1, 5):
        _conv(out, t[f"layer{i}_rn"], f"{p}.dpt.scratch.layer{i}_rn")
        rf, trf = f"{p}.dpt.scratch.refinenet{i}", t[f"refinenet{i}"]
        for unit in ("resConfUnit1", "resConfUnit2") if i < 4 else ("resConfUnit2",):
            for conv in ("conv1", "conv2"):
                _conv(out, trf[unit][conv], f"{rf}.{unit}.{conv}")
        _conv(out, trf["out_conv"], f"{rf}.out_conv")
    if head_type == "regression":
        _conv(out, t["head_conv1"], f"{p}.dpt.head.0")
        _conv(out, t["head_conv2"], f"{p}.dpt.head.2")
        _conv(out, t["head_conv3"], f"{p}.dpt.head.4")
    else:
        _conv(out, t["input_merger"], f"{p}.dpt.input_merger.0")
        _conv(out, t["head_conv1"], f"{p}.dpt.head.0")
        _conv(out, t["head_conv2"], f"{p}.dpt.head.4")


def state_dict_from_jax(variables: Dict[str, Any], cfg: ModelCfg) -> State:
    """JAX SIU3RModel variables (numpy leaves) -> the port's state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out: State = {}
    _backbone(out, params["backbone"], cfg)
    _adapter(out, params["adapter"], stats["adapter"], n_interactions=4)
    _mask2former(out, params["mask2former"], cfg)
    for head in ("downstream_head1", "downstream_head2"):
        _dpt_head(out, params[head], head, "regression")
    for head in ("gaussian_param_head1", "gaussian_param_head2"):
        _dpt_head(out, params[head], head, "gs_params")
    return out


def load_checkpoint(model: torch.nn.Module, path: str, prefix: str = "model.") -> None:
    """Load a reference Lightning ``.ckpt`` (or a bare state_dict file).
    Every parameter of the port must be present; keys the port has no module
    for (the loss's buffers, the DPT ``refinenet4.resConfUnit1`` that never
    runs) are left out."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob)
    state = {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in state.items()}
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in state.items() if k in own}, strict=True)


def lpips_params_from_jax(params: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The JAX package's LPIPS parameters (``init_lpips_params``, numpy
    leaves: conv kernels [3, 3, I, O], linear heads [C, 1]) -> the port's
    (``train/lpips.py``: conv weights [O, I, 3, 3], heads [C])."""
    from siu3r_tpu_torch.train.lpips import with_scaling

    return with_scaling({
        "convs": [
            (_t(np.asarray(c["kernel"]).transpose(3, 2, 0, 1)).to(device), _t(c["bias"]).to(device))
            for c in params["convs"]
        ],
        "lins": [_t(np.asarray(lin)[:, 0]).to(device) for lin in params["lins"]],
        "pretrained": bool(params["pretrained"]),
    })
