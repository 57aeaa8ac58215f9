"""The optimizer: 3-group AdamW with warmup and cosine, and the frozen
encoder, counterpart of ``siu3r_tpu/train/optimizer.py`` (reference
Pipeline.configure_optimizers, pipeline.py:366-423).

  * ``gaussian_param_head*`` / ``intrinsic_encoder``: 5x the learning rate;
    ``mask2former`` / ``adapter``: 3x; everything else 0.1x;
  * AdamW with weight decay 0.05, betas (0.9, 0.95), eps 1e-8, in optax's
    order of operations (the moments, their bias corrections, then
    ``m / (sqrt(v) + eps) + wd * p`` scaled by the learning rate);
  * linear warmup from lr / warmup over the warmup epochs, then cosine down
    to 0.05 x lr, interpolated per step;
  * with ``freeze == "encoder"``, ``backbone.patch_embed``,
    ``backbone.enc_blocks`` and ``backbone.enc_norm`` get no update and no
    weight decay;
  * the gradients are clipped to a global norm first, over every gradient,
    the frozen encoder's included: the JAX package chains the clip before
    its per-group transform, and computes the frozen gradients. So the
    encoder keeps ``requires_grad`` and is left out of the update only.

The updates run as multi-tensor (``torch._foreach_*``) operations per group.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from siu3r_tpu_torch.config import OptimizerCfg, TrainerCfg

GROUPS = ("normal", "high", "low")  # 5x, 3x, 0.1x; "frozen" gets no update


def group_of(name: str, freeze_encoder: bool) -> str:
    """The group of a parameter from its ``named_parameters`` name."""
    if freeze_encoder and any(
        name.startswith(p) for p in ("backbone.patch_embed.", "backbone.enc_blocks.", "backbone.enc_norm.")
    ):
        return "frozen"
    if "gaussian_param_head" in name or "intrinsic_encoder" in name:
        return "normal"
    if "mask2former" in name or "adapter" in name:
        return "high"
    return "low"


def make_lr_schedule(base_lr: float, warm_up_epochs: int, max_epochs: int, steps_per_epoch: int):
    """step -> learning rate, in float32 as optax computes it op by op: a
    linear schedule from base_lr / warmup to base_lr over the warmup steps,
    then a cosine decay to alpha = 0.05 over the remaining epochs."""
    f = np.float32
    warm_steps = warm_up_epochs * steps_per_epoch
    init = base_lr / max(warm_up_epochs, 1)
    decay_steps = max(max_epochs - warm_up_epochs, 1) * steps_per_epoch
    alpha = 0.05

    # optax's arithmetic, one float32 operation at a time: its Python floats
    # combine in double first, then meet the float32 count
    def warm(count: int) -> np.float32:
        if warm_steps <= 0:
            return f(init)
        frac = f(1) - f(min(max(count, 0), warm_steps)) / f(warm_steps)
        return f(init - base_lr) * frac + f(base_lr)

    def cosine(count: int) -> np.float32:
        x = f(f(math.pi) * f(min(count, decay_steps))) / f(decay_steps)
        decay = f(0.5) * (f(1) + f(np.cos(np.float64(x))))  # cos rounded once to float32
        return f(base_lr) * (f(1 - alpha) * decay + f(alpha))

    def schedule(step: int) -> float:
        return float(warm(step) if step < warm_steps else cosine(step - warm_steps))

    return schedule


class AdamW3:
    """The three AdamW groups over a model's parameters, with the global-norm
    clip over all of them. ``step()`` reads ``p.grad`` of every parameter (a
    missing gradient counts as zero) and updates the trainable groups."""

    def __init__(
        self,
        model: nn.Module,
        opt_cfg: OptimizerCfg,
        trainer_cfg: TrainerCfg,
        steps_per_epoch: int = 1000,
        freeze_encoder: bool = True,
    ):
        self.params: Dict[str, nn.Parameter] = dict(model.named_parameters())
        self.groups: Dict[str, List[str]] = {g: [] for g in (*GROUPS, "frozen")}
        for name in self.params:
            self.groups[group_of(name, freeze_encoder)].append(name)
        mult = {"normal": opt_cfg.gaussian_head_lr_mult, "high": opt_cfg.seg_lr_mult, "low": opt_cfg.base_lr_mult}
        self.schedules = {
            g: make_lr_schedule(opt_cfg.lr * mult[g], opt_cfg.warm_up_epochs, trainer_cfg.max_epochs,
                                steps_per_epoch)
            for g in GROUPS
        }
        self.b1, self.b2 = opt_cfg.betas
        self.eps = 1e-8
        self.weight_decay = opt_cfg.weight_decay
        self.clip = trainer_cfg.gradient_clip_val
        self.count = 0
        self.mu = {n: torch.zeros_like(self.params[n]) for g in GROUPS for n in self.groups[g]}
        self.nu = {n: torch.zeros_like(self.params[n]) for g in GROUPS for n in self.groups[g]}

    def lr(self, group: str, step: int) -> float:
        return self.schedules[group](step)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update. Returns the global gradient norm (before the clip), on
        the device."""
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in self.params.items()}
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads.values()))))
        if self.clip and self.clip > 0:
            # optax.clip_by_global_norm: g if norm < clip else g / norm * clip,
            # written (g / d) * clip with d = clip below the norm (exact for a
            # power-of-two clip), on the device
            d = torch.where(norm < self.clip, norm.new_full((), self.clip), norm)
            clipped = torch._foreach_div(list(grads.values()), d)
            torch._foreach_mul_(clipped, self.clip)
            grads = dict(zip(grads, clipped))
        count = self.count + 1
        f = np.float32
        bc1 = float(f(1) - f(self.b1) ** f(count))
        bc2 = float(f(1) - f(self.b2) ** f(count))
        for group in GROUPS:
            names = self.groups[group]
            if not names:
                continue
            p = [self.params[n] for n in names]
            g = [grads[n] for n in names]
            mu = [self.mu[n] for n in names]
            nu = [self.nu[n] for n in names]
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
            torch._foreach_mul_(nu, self.b2)
            sq = torch._foreach_mul(g, g)
            torch._foreach_mul_(sq, 1 - self.b2)
            torch._foreach_add_(nu, sq)
            del sq
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            del denom
            torch._foreach_add_(upd, torch._foreach_mul(p, self.weight_decay))
            torch._foreach_mul_(upd, -self.lr(group, self.count))
            torch._foreach_add_(p, upd)
        self.count = count
        return norm

    def state_dict(self) -> dict:
        return {
            "count": self.count,
            "mu": self.mu,
            "nu": self.nu,
            "groups": {g: list(n) for g, n in self.groups.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        if state["groups"] != self.groups:
            raise ValueError("optimizer-state structure mismatch: the checkpoint was saved with other "
                             "parameter groups (freeze, model config)")
        for key in ("mu", "nu"):
            for n, t in state[key].items():
                if t.shape != self.params[n].shape:
                    raise ValueError(f"optimizer state {key}[{n}] {tuple(t.shape)} does not fit the parameter")
                getattr(self, key)[n].copy_(t)
        self.count = int(state["count"])
