"""LPIPS perceptual loss on a VGG16 backbone, counterpart of
``siu3r_tpu/train/lpips.py`` (torchmetrics ``LPIPS('vgg', normalize=True)``,
used by the render loss at half resolution).

The VGG16 and linear-head weights load from ``lpips_vgg.pth``
({'vgg': torchvision vgg16.features state, 'lins': lpips lin state}) where
that file exists. No such file is in the repository and there is no network,
so without it the module builds the JAX package's fixed-seed random VGG
(``np.random.RandomState(0)``, the same draws in the same order) with the
same warning: a perceptual-style signal, not numerically LPIPS.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# lpips ScalingLayer constants (inputs in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# VGG16 features: (out channels, convs) per block
_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
# torchvision vgg16.features conv indices
_CONV_IDS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

Params = Dict[str, object]


def init_lpips_params(weights_path: Optional[str] = None, seed: int = 0, device="cpu") -> Params:
    """{"convs": [(weight [O, I, 3, 3], bias [O])], "lins": [[C]], "pretrained": bool}."""
    if weights_path is not None and Path(weights_path).exists():
        blob = torch.load(weights_path, map_location="cpu", weights_only=False)
        convs = [(blob["vgg"][f"{i}.weight"].float(), blob["vgg"][f"{i}.bias"].float()) for i in _CONV_IDS]
        lins = [blob["lins"][f"lin{i}.model.1.weight"].float().clamp(min=0)[0, :, 0, 0] for i in range(5)]
        pretrained = True
    else:
        logging.getLogger("siu3r_tpu_torch").warning(
            "LPIPS: no pretrained VGG16 weights found (weights_path=%s) - falling back to a fixed-seed "
            "RANDOM VGG. The lpips loss/metric is a perceptual-style signal but NOT numerically "
            "comparable to the reference's torchvision LPIPS.", weights_path,
        )
        rng = np.random.RandomState(seed)
        convs, in_ch = [], 3
        for out_ch, n in _BLOCKS:
            for _ in range(n):
                w = rng.normal(0, np.sqrt(2.0 / (in_ch * 9)), (3, 3, in_ch, out_ch)).astype(np.float32)
                convs.append((torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.zeros(out_ch)))
                in_ch = out_ch
        lins = [torch.full((ch,), 1.0 / ch) for ch, _ in _BLOCKS]
        pretrained = False
    return with_scaling({
        "convs": [(w.to(device), b.to(device)) for w, b in convs],
        "lins": [x.to(device) for x in lins],
        "pretrained": pretrained,
    })


def with_scaling(params: Params) -> Params:
    """Add the input scaling's constants, as tensors on the parameters'
    device (made once here: a tensor built from a Python list on a CUDA
    device is a copy from the host that waits for the device)."""
    dev = params["lins"][0].device
    return {**params, "shift": torch.tensor(_SHIFT, device=dev)[:, None, None],
            "scale": torch.tensor(_SCALE, device=dev)[:, None, None]}


def _vgg_features(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """x [B, 3, H, W] in [-1, 1] -> the 5 blocks' outputs (after ReLU)."""
    x = (x - params["shift"]) / params["scale"]
    feats, ci = [], 0
    for bi, (_, n) in enumerate(_BLOCKS):
        for _ in range(n):
            w, b = params["convs"][ci]
            x = F.relu(F.conv2d(x, w, b, padding=1))
            ci += 1
        feats.append(x)
        if bi < len(_BLOCKS) - 1:
            x = F.max_pool2d(x, 2, 2)
    return feats


def lpips(params: Params, img0: torch.Tensor, img1: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """img0/img1 [B, H, W, 3]; ``normalize``: inputs in [0, 1]. The mean over
    the batch of the summed per-layer distances."""
    if normalize:
        img0 = 2 * img0 - 1
        img1 = 2 * img1 - 1
    f0 = _vgg_features(params, img0.permute(0, 3, 1, 2))
    f1 = _vgg_features(params, img1.permute(0, 3, 1, 2))
    total = 0.0
    for a, b, lin in zip(f0, f1, params["lins"]):
        a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
        b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
        d = (a - b) ** 2  # [B, C, H, W]
        total = total + torch.einsum("bchw,c->bhw", d, lin).mean(dim=(1, 2))
    return total.mean()
