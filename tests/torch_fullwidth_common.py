"""The model at the shipped widths, its weights drawn with numpy, its inputs
and its framed target cameras.

Shared by tests/test_torch_fullwidth.py (the port against the JAX package on
the CPU) and chip_smoke.py's phase ``fullwidth`` (the port on the GPU against
the JAX package's numbers in tests/torch_fullwidth_ref.npz), so it imports
numpy, torch and the port only: the GPU machine has no JAX.

The config is ``configs/scannet.yaml``'s model with its ScanNet label set
(CroCo 1024/16 and 768/12 heads, patch 16, RoPE100, Mask2Former hidden 256, 8
heads, ffw 2048, 100 queries, 21 classes, 16 lift slots, SH degree 4,
256x256, two views, fp32) at one of two depths:
  * "cut": 4 encoder blocks, 4 + 4 decoder blocks, Mask2Former 4 decoder
    layers and 1 encoder layer. The adapter's interaction indexes come out
    as (0, 1, 2, 3) and the DPT hooks as [0, 2, 3, 4], each distinct as at
    the shipped depths, and every level of the masked decoder is read;
  * "full": the shipped 24 / 12 + 12 blocks, 10 / 6 layers.

Every weight is drawn from ``np.random.default_rng(seed).random``: its
float64 stream (the top 53 bits of each PCG64 output, scaled) is the same on
every machine and numpy version, where a ``torch.Generator`` draws other
numbers on another kind of device or build. Normals are made from it by
Box-Muller. Each value is computed in float64 and rounded to float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch import nn

from siu3r_tpu_torch.config import ModelCfg, bind_scannet_classes, load_config

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "torch_fullwidth_ref.npz"

DEPTHS = {
    "cut": dict(enc_depth=4, dec_depth=4, decoder_layers=4, encoder_layers=1),
    "full": dict(enc_depth=24, dec_depth=12, decoder_layers=10, encoder_layers=6),
}
WEIGHT_SEED = 0
INPUT_SEED = 1
SUBSET_SEED = 2
# the class predictor's weights are scaled up, as tests/test_torch_model.py
# scales the tiny model's, so that the post-process keeps queries (82 of 100)
CLASS_SCALE = 8.0
# target cameras of the render held in the fixture, and Gaussians kept
N_TARGETS = 2
N_SUBSET = 4096
# the rasterizer's per-tile cap (siu3r_tpu/render/rasterizer.py:357)
MAX_PER_TILE = 4096

# floats: rtol 1e-3 and an absolute floor of 1e-4 times the field's largest
# magnitude (fp32 on both sides, other summation orders; the Gaussian means
# span about 0.01, so a fixed 1e-4 would hide their errors); integers exact
RTOL, ATOL_SCALE = 1e-3, 1e-4
# the render on the GPU against the JAX package's: colour, depth and alpha
# within RENDER_ATOL on at least RENDER_SHARE of the pixels (the 1/255 alpha
# cut turns last-bit differences of the Gaussians into steps of a few 1e-3 at
# a few pixels)
RENDER_ATOL, RENDER_SHARE = 2e-4, 0.999
# Two discrete decisions of the forward turn last-bit differences into large
# ones, and are compared only where the reference decides them by more than
# its own rounding:
#  * Mask2Former's masked attention excludes a key where the previous
#    layer's resized mask logit is below 0 (sigmoid < 0.5). At full width
#    some 270,000 such bits a layer are decided, a few within 1e-6 of 0, and
#    one flipped bit moves that query's later logits by up to 5e-3. Where the
#    reference's logit lies within MASK_TIE of 0, the port is given the
#    reference's decision (``reference_ties``); elsewhere it decides alone.
#  * each pixel's panoptic label goes to the kept query with the largest
#    score-weighted mask probability. Pixels where the reference's two
#    largest lie within LABEL_TIE are left out of the exact comparison.
MASK_TIE = 1e-4
LABEL_TIE = 1e-4
GAUSSIAN_FIELDS = ("means", "covariances", "harmonics", "opacities", "scales", "rotations",
                   "seg_query_class_logits", "seg_query_scores")


def fullwidth_cfg(depth: str = "cut", dtype: str = "float32") -> ModelCfg:
    """``configs/scannet.yaml``'s model with the ScanNet classes at ``depth``
    ("cut" or "full"), computing in ``dtype``."""
    cfg = bind_scannet_classes(load_config(REPO / "configs" / "scannet.yaml")).pipeline.model
    d = DEPTHS[depth]
    return dataclasses.replace(
        cfg,
        dtype=dtype,
        image_size=tuple(cfg.image_size),
        croco=dataclasses.replace(cfg.croco, enc_depth=d["enc_depth"], dec_depth=d["dec_depth"]),
        mask2former=dataclasses.replace(cfg.mask2former, decoder_layers=d["decoder_layers"],
                                        encoder_layers=d["encoder_layers"]),
    )


def _uniform(rng: np.random.Generator, shape, low: float, high: float) -> np.ndarray:
    return (low + (high - low) * rng.random(math.prod(shape))).astype(np.float32).reshape(shape)


def _normal(rng: np.random.Generator, shape, mean: float, std: float) -> np.ndarray:
    n = math.prod(shape)
    u1, u2 = rng.random(n), rng.random(n)
    z = np.sqrt(-2.0 * np.log1p(-u1)) * np.cos(2.0 * np.pi * u2)
    return (mean + std * z).astype(np.float32).reshape(shape)


def _draw(rng: np.random.Generator, mod: nn.Module, name: str, shape) -> np.ndarray:
    """One tensor of ``mod`` (its parameter or buffer ``name``), at the scale
    of the seeded init (``models/layers.py:init_weights``): linear and
    convolution weights and biases uniform in +-1/sqrt(fan_in), embeddings
    N(0, 1); norms near theirs (scale N(1, 0.1), shift N(0, 0.1)) and
    BatchNorm statistics random (mean N(0, 0.1), variance U(0.5, 2)) so that
    each does real work."""
    if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
        w = mod.weight
        receptive = math.prod(w.shape[2:])
        in_ch = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) else w.shape[1]
        bound = (in_ch * receptive) ** -0.5
        return _uniform(rng, shape, -bound, bound)
    if name in ("in_proj_weight", "in_proj_bias"):  # a packed q, k, v projection
        bound = mod.in_proj_weight.shape[1] ** -0.5
        return _uniform(rng, shape, -bound, bound)
    if isinstance(mod, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
        if name == "weight":
            return _normal(rng, shape, 1.0, 0.1)
        if name in ("bias", "running_mean"):
            return _normal(rng, shape, 0.0, 0.1)
        if name == "running_var":
            return _uniform(rng, shape, 0.5, 2.0)
    if isinstance(mod, nn.Embedding) or name == "level_embed":
        return _normal(rng, shape, 0.0, 1.0)
    raise KeyError(f"no rule draws {type(mod).__name__}.{name}")


def fill_numpy_weights(model: nn.Module, seed: int = WEIGHT_SEED) -> nn.Module:
    """Overwrite every parameter and buffer of ``model`` (on any device) key by
    key in ``state_dict`` order from one numpy stream; the class predictor's
    weight is scaled by CLASS_SCALE, BatchNorm's step counts are 0."""
    owner = {}
    for mname, mod in model.named_modules():
        for name, _ in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
            owner[f"{mname}.{name}" if mname else name] = (mod, name)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, t in model.state_dict().items():
            mod, name = owner[key]
            if name == "num_batches_tracked":
                t.zero_()
                continue
            value = _draw(rng, mod, name, tuple(t.shape))
            if key.endswith("class_predictor.weight"):
                value *= CLASS_SCALE
            t.copy_(torch.from_numpy(value))
    return model


def build_fullwidth_model(depth: str = "cut", device: str = "cpu", dtype: str = "float32"):
    """The port's model at ``depth`` on ``device`` with the numpy weights, in
    eval mode. Its seeded init is skipped: every tensor is drawn anew."""
    from siu3r_tpu_torch.models import model as M

    with mock.patch.object(M, "init_weights", lambda model, generator: model):
        model = M.build_model(fullwidth_cfg(depth, dtype), device=device, seed=0)
    return fill_numpy_weights(model).eval()


def fullwidth_inputs(cfg: ModelCfg, seed: int = INPUT_SEED) -> tuple[np.ndarray, np.ndarray]:
    """Images [1, V, H, W, 3] uniform in [0, 1) and the inference CLI's
    default intrinsics [1, V, 3, 3] (focal 318/256 of the width, centred)."""
    h, w = cfg.image_size
    images = np.random.default_rng(seed).random((1, cfg.num_views, h, w, 3)).astype(np.float32)
    k = np.array([[318 / 256, 0, 0.5], [0, 318 / 256, 0.5], [0, 0, 1]], np.float32)
    return images, np.ascontiguousarray(np.broadcast_to(k, (1, cfg.num_views, 3, 3)))


def framed_targets(means: np.ndarray, n_views: int, context_views: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """``n_views`` target cameras framing the first context view's Gaussians
    (``means`` [1, V*H*W, 3]), as chip_smoke.py's ``_target_views`` frames
    them: camera-to-world poses [1, n, 4, 4] looking down +z from 0.15 units
    behind the nearest 2% of them, on a small circle about their median, and
    normalised intrinsics [1, n, 3, 3] whose field of view holds 98% of them.
    In float64, returned as float32."""
    m = np.asarray(means, np.float64).reshape(-1, 3)
    m = m[: m.shape[0] // context_views]
    center = np.median(m, axis=0)
    rel = m - center
    dist = max(float(np.quantile(-rel[:, 2], 0.02)), 0.0) + 0.15
    tan_half = float(np.quantile(np.abs(rel[:, :2]).max(axis=-1) / np.maximum(rel[:, 2] + dist, 1e-3), 0.98))
    angles = np.arange(n_views) * (2 * np.pi / n_views)
    offsets = np.stack([np.cos(angles), np.sin(angles), np.zeros_like(angles)], axis=-1)
    ext = np.tile(np.eye(4), (1, n_views, 1, 1))
    ext[0, :, :3, 3] = center + 0.1 * dist * tan_half * offsets
    ext[0, :, 2, 3] -= dist
    k = np.eye(3)
    k[0, 0] = k[1, 1] = 0.5 / tan_half
    k[:2, 2] = 0.5
    return ext.astype(np.float32), np.ascontiguousarray(np.broadcast_to(k, (1, n_views, 3, 3))).astype(np.float32)


def _mask_predictor(model: nn.Module) -> nn.Module:
    from siu3r_tpu_torch.models.mask2former.decoder import MaskPredictor

    found = [m for m in model.modules() if isinstance(m, MaskPredictor)]
    if len(found) != 1:
        raise ValueError(f"expected one Mask2Former mask predictor, found {len(found)}")
    return found[0]


@contextlib.contextmanager
def reference_ties(model: nn.Module, ties: list):
    """Inside the block, call i of ``model``'s Mask2Former mask predictor
    takes the reference's attention-mask decision at the bits of ``ties[i]``
    = (flat indices into its exclude mask [B, Q, V*h*w], the reference's
    exclusions there): the bits where the reference's resized logit lies
    within MASK_TIE of 0. Yields a list that receives, call by call, the
    number of those bits whose decision the port's own differed from (a
    tensor on the model's device: nothing here waits for the device)."""
    mp = _mask_predictor(model)
    dev = next(model.parameters()).device
    ties = [(torch.as_tensor(np.array(i), dtype=torch.int64, device=dev),
             torch.as_tensor(np.array(e), dtype=torch.bool, device=dev)) for i, e in ties]
    changed: list = []
    orig = mp.forward

    def forward(outputs, pixel_embeddings, target_hw):
        logits, exclude = orig(outputs, pixel_embeddings, target_hw)
        idx, want = ties[len(changed)]
        flat = exclude.reshape(-1).clone()
        changed.append((flat[idx] != want).sum())
        flat[idx] = want
        return logits, flat.reshape(exclude.shape)

    mp.forward = forward
    try:
        yield changed
    finally:
        del mp.forward


def label_ties(class_logits: np.ndarray, mask_logits: np.ndarray, cfg: ModelCfg) -> np.ndarray:
    """Flat indices into the label maps [B, V, H, W] of the pixels whose two
    largest score-weighted mask probabilities over the kept queries lie
    within LABEL_TIE (the post-process's assignment, recomputed from the
    reference's logits)."""
    from siu3r_tpu_torch.models.mask2former.postprocess import _resize_sigmoid_resize

    m2f = cfg.mask2former
    cl, ml = torch.from_numpy(np.array(class_logits)), torch.from_numpy(np.array(mask_logits))
    b, q, v, mh, mw = ml.shape
    h, w = cfg.image_size
    scores, labels = torch.softmax(cl, dim=-1).max(dim=-1)
    keep = (labels != m2f.num_labels) & (scores > m2f.seg_threshold)
    probs = _resize_sigmoid_resize(ml.reshape(b * q * v, mh, mw), (h, w)).reshape(b, q, v, h, w)
    wm = torch.where(keep[:, :, None, None, None], probs * scores[:, :, None, None, None], -1.0)
    top = wm.topk(2, dim=1).values
    return np.flatnonzero((top[:, 0] - top[:, 1]).numpy() < LABEL_TIE)


def subset_indices(g: int, n: int = N_SUBSET, seed: int = SUBSET_SEED) -> np.ndarray:
    """A fixed seeded subset of ``n`` of ``g`` Gaussians, in order."""
    return np.sort(np.random.default_rng(seed).permutation(g)[:n])


def excess(port, ref, scale: float | None = None) -> float:
    """The largest amount by which ``port`` misses ``ref`` beyond rtol RTOL
    and an absolute floor of ATOL_SCALE x ``scale`` (by default the largest
    magnitude of ``ref``): at most 0 passes. In float32."""
    port = port.detach().float().cpu() if isinstance(port, torch.Tensor) else torch.from_numpy(np.array(port))
    ref = torch.from_numpy(np.array(ref, np.float32))
    scale = float(ref.abs().max()) if scale is None else scale
    return float(((port.float() - ref).abs() - RTOL * ref.abs() - ATOL_SCALE * scale).max())


def label_misses(port, ref, ties: np.ndarray) -> tuple[int, int]:
    """(pixels whose label differs, of them those outside the reference's
    ties) of two label maps."""
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    differ = (port.astype(np.int64) != np.asarray(ref).astype(np.int64)).reshape(-1)
    outside = differ.copy()
    outside[np.asarray(ties, np.int64)] = False
    return int(differ.sum()), int(outside.sum())


def render_share(port, ref) -> float:
    """The share of pixels (and channels) of a render within RENDER_ATOL of
    the reference's."""
    port = port.detach().float().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    return float((np.abs(port - np.asarray(ref)) <= RENDER_ATOL).mean())
