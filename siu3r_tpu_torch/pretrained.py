"""Pretrained-init surgeries, the port's copy of those in
``siu3r_tpu/checkpoint.py`` (reference src/utils/weight_modify.py:13-228,
src/models/model.py:116-176, backbone_croco.py:106-113), on torch state
dicts in the reference's layout, which is the port's own.

  * ``filter_recon_state``: a MASt3R/DUSt3R checkpoint -> the model's keys:
    the patch-embed kernel resampled to the configured patch size
    (``resample_patch_embed_kernel``) and its input channels adapted
    (``adapt_input_conv``), a narrower ``decoder_embed`` widened
    (``adapt_linear``), ``backbone.`` prefixed to all but the downstream
    heads, ``dec_blocks`` copied into ``dec_blocks2`` where absent, and the
    confidence channel stripped from the point heads' output conv;
  * ``filter_seg_state``: a COCO/ADE20k ViT-Adapter and mask-decoder
    checkpoint -> the model's keys: the class predictor, the criterion and
    the backbone dropped, the query embeddings zero-padded (or cut) to the
    configured query count, the ``model.`` prefix stripped;
  * ``init_from_pretrained``: both overlaid on a model's state dict (the
    segmentation checkpoint's class predictor left at its init: the label
    count differs).

Host-side numpy, run once before training.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from siu3r_tpu_torch.config import ModelCfg


def resample_patch_embed_kernel(kernel: np.ndarray, new_hw) -> np.ndarray:
    """FlexiViT's pseudo-inverse resampling of a patch kernel (reference
    weight_modify.py:13-93): kernel [O, I, H, W] -> [O, I, h, w], the resize
    matrix built from torch's bicubic antialiased resize of each basis
    kernel."""
    old = kernel.shape[-2:]
    if tuple(old) == tuple(new_hw):
        return kernel

    def resize(x):
        t = torch.from_numpy(x.astype(np.float32))[None, None]
        return F.interpolate(t, size=tuple(new_hw), mode="bicubic", antialias=True)[0, 0].numpy()

    mat = []
    for i in range(int(np.prod(old))):
        basis = np.zeros(old, np.float32)
        basis[np.unravel_index(i, old)] = 1.0
        mat.append(resize(basis).reshape(-1))
    resize_mat_pinv = np.linalg.pinv(np.stack(mat))

    o, i_ch = kernel.shape[:2]
    flat = kernel.reshape(o * i_ch, -1).astype(np.float32)
    return (resize_mat_pinv @ flat.T).T.reshape(o, i_ch, *new_hw)


def adapt_input_conv(in_chans: int, w: np.ndarray) -> np.ndarray:
    """A conv kernel [O, I, kh, kw] for ``in_chans`` input channels
    (reference weight_modify.py:96-125): summed over I for one channel, an
    RGB kernel tiled and scaled by 3 / in_chans for more."""
    w = w.astype(np.float32)
    if in_chans == 1:
        return w.sum(axis=1, keepdims=True)
    if in_chans != 3:
        if w.shape[1] != 3:
            raise NotImplementedError(f"adapting a {w.shape[1]}-channel kernel to {in_chans} channels")
        repeat = -(-in_chans // 3)
        w = np.tile(w, (1, repeat, 1, 1))[:, :in_chans]
        w *= 3.0 / in_chans
    return w


def adapt_linear(w: np.ndarray) -> np.ndarray:
    """Widen a linear layer's input (reference weight_modify.py:145-160):
    the means of 81 column splits appended, both halves scaled by 0.5."""
    chunks = np.array_split(w.astype(np.float32), 81, axis=1)
    means = np.concatenate([c.mean(axis=1, keepdims=True) for c in chunks], axis=1)
    return np.concatenate([w * 0.5, means * 0.5], axis=1)


def filter_recon_state(state: Dict[str, np.ndarray], cfg: ModelCfg) -> Dict[str, np.ndarray]:
    """A MASt3R/DUSt3R checkpoint's state -> the model's keys (the module
    docstring's first item)."""
    state = {k: np.asarray(v) for k, v in state.items()}
    p = cfg.croco.patch_size
    out: Dict[str, np.ndarray] = {}
    for k, v in state.items():
        if "patch_embed.proj.weight" in k:
            if v.shape[-1] != p or v.shape[-2] != p:
                v = resample_patch_embed_kernel(v, (p, p))
            if v.shape[1] != 3:
                v = adapt_input_conv(3, v)
        elif "decoder_embed.weight" in k:
            if v.shape[1] != cfg.croco.enc_embed_dim:
                v = adapt_linear(v)
        out[k] = v

    if not any(k.startswith("dec_blocks2") for k in out):
        for k in list(out):
            if k.startswith("dec_blocks."):
                out[k.replace("dec_blocks.", "dec_blocks2.", 1)] = out[k]

    prefixed = {(k if "downstream_head" in k else "backbone." + k): v for k, v in out.items()}
    for head in ("downstream_head1", "downstream_head2"):
        wk, bk = f"{head}.dpt.head.4.weight", f"{head}.dpt.head.4.bias"
        if wk in prefixed and prefixed[wk].shape[0] > 3:
            prefixed[wk] = prefixed[wk][:3]
            prefixed[bk] = prefixed[bk][:3]
    return prefixed


def filter_seg_state(state: Dict[str, np.ndarray], cfg: ModelCfg, prefix: str = "model.") -> Dict[str, np.ndarray]:
    """A COCO/ADE20k segmentation checkpoint's state -> the model's keys (the
    module docstring's second item)."""
    out: Dict[str, np.ndarray] = {}
    nq = cfg.mask2former.num_queries
    for k, v in state.items():
        if "class_predictor" in k or "criterion" in k or "backbone" in k:
            continue
        key = k[len(prefix):] if k.startswith(prefix) else k
        v = np.asarray(v)
        if "queries_embedder" in k or "queries_features" in k:
            padded = np.zeros((nq, v.shape[1]), v.dtype)
            padded[: min(nq, v.shape[0])] = v[:nq]
            v = padded
        out[key] = v
    return out


def _load_state(path: str, key: str) -> Dict[str, np.ndarray]:
    blob = torch.load(path, map_location="cpu", weights_only=False)
    return {k: np.asarray(v) for k, v in blob.get(key, blob).items()}


def init_from_pretrained(
    state: Dict[str, torch.Tensor],
    cfg: ModelCfg,
    recon_ckpt: Optional[str] = None,
    seg_ckpt: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """The training init (reference Pipeline.setup, pipeline.py:41-44):
    ``state`` (a model's ``state_dict``, e.g. a seeded random init) with the
    backbone and point heads of ``recon_ckpt`` (a MASt3R/DUSt3R file, its
    ``model`` entry or the bare state) and the adapter and mask decoder of
    ``seg_ckpt`` (a segmentation file, its ``state_dict`` entry or the bare
    state; the class predictor kept from ``state``) laid over it. Returns a
    new dict for ``load_state_dict``; ``state`` is not changed. A checkpoint's
    keys that the model does not have are left out; a tensor whose shape
    differs from the model's raises."""
    out = dict(state)

    def overlay(entries: Dict[str, np.ndarray], parts) -> None:
        for k, v in entries.items():
            if k not in out or not k.startswith(parts):
                continue
            if tuple(v.shape) != tuple(out[k].shape):
                raise ValueError(f"pretrained {k} {tuple(v.shape)} does not fit the model's {tuple(out[k].shape)}")
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(out[k].device, out[k].dtype)

    if recon_ckpt is not None:
        overlay(filter_recon_state(_load_state(recon_ckpt, "model"), cfg),
                ("backbone.", "downstream_head1.", "downstream_head2."))
    if seg_ckpt is not None:
        overlay(filter_seg_state(_load_state(seg_ckpt, "state_dict"), cfg), ("adapter.", "mask2former."))
    return out
