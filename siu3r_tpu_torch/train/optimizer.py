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
Under a process group of N ranks, ``Zero1AdamW3`` (``trainer.zero1``) keeps
1/N of the state a rank (ZeRO-1); ``MultiSteps`` wraps either.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from siu3r_tpu_torch import parallel
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


def _grads_of(params: Dict[str, nn.Parameter]) -> Dict[str, torch.Tensor]:
    """Each parameter's ``.grad``, a missing one as zeros."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in params.items()}


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
        self.mu = self._new_moments()
        self.nu = self._new_moments()

    def _new_moments(self) -> Dict[str, torch.Tensor]:
        return {n: torch.zeros_like(self.params[n]) for g in GROUPS for n in self.groups[g]}

    def lr(self, group: str, step: int) -> float:
        return self.schedules[group](step)

    @torch.no_grad()
    def step(self, grads: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """One update from ``grads`` (by parameter name), or from each
        parameter's ``.grad`` when none are given. Returns the global gradient
        norm (before the clip), on the device."""
        if grads is None:
            grads = _grads_of(self.params)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads.values()))))
        grads = dict(zip(grads, self._clipped(list(grads.values()), norm)))
        count = self.count + 1
        for group in GROUPS:
            names = self.groups[group]
            if names:
                self._update(group, count, [self.params[n] for n in names], [grads[n] for n in names],
                             [self.mu[n] for n in names], [self.nu[n] for n in names])
        self.count = count
        return norm

    def _clipped(self, grads: List[torch.Tensor], norm: torch.Tensor) -> List[torch.Tensor]:
        """optax.clip_by_global_norm: g if norm < clip else g / norm * clip,
        written (g / d) * clip with d = clip below the norm (exact for a
        power-of-two clip), on the device."""
        if not (self.clip and self.clip > 0):
            return grads
        d = torch.where(norm < self.clip, norm.new_full((), self.clip), norm)
        clipped = torch._foreach_div(grads, d)
        torch._foreach_mul_(clipped, self.clip)
        return clipped

    def _update(self, group: str, count: int, p: List[torch.Tensor], g: List[torch.Tensor],
                mu: List[torch.Tensor], nu: List[torch.Tensor]) -> None:
        """The AdamW update of step ``count`` on one group's tensors, in place."""
        f = np.float32
        bc1 = float(f(1) - f(self.b1) ** f(count))
        bc2 = float(f(1) - f(self.b2) ** f(count))
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
        torch._foreach_mul_(upd, -self.lr(group, count - 1))
        torch._foreach_add_(p, upd)

    # the layout of the gradients and of the state: by parameter name here;
    # by group, this rank's slice, under ZeRO-1 (Zero1AdamW3)
    def local_grads(self) -> Dict[str, Optional[torch.Tensor]]:
        """Each parameter's ``.grad`` (None where it has none)."""
        return {n: p.grad for n, p in self.params.items()}

    def new_accumulator(self) -> Dict[str, torch.Tensor]:
        """Zeros in the layout of ``local_grads`` (every parameter's)."""
        return {n: torch.zeros_like(p) for n, p in self.params.items()}

    def full_layout(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tensors of this optimizer's layout in the one-device layout (by
        parameter name, full shapes): the same here."""
        return tensors

    def local_layout(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The inverse of ``full_layout``."""
        return tensors

    def state_dict(self) -> dict:
        return {
            "count": self.count,
            "mu": self.mu,
            "nu": self.nu,
            "groups": {g: list(n) for g, n in self.groups.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        _check_accumulation(state, 1)
        if state["groups"] != self.groups:
            raise ValueError("optimizer-state structure mismatch: the checkpoint was saved with other "
                             "parameter groups (freeze, model config)")
        for key in ("mu", "nu"):
            for n, t in state[key].items():
                if t.shape != self.params[n].shape:
                    raise ValueError(f"optimizer state {key}[{n}] {tuple(t.shape)} does not fit the parameter")
                getattr(self, key)[n].copy_(t)
        self.count = int(state["count"])


class Zero1AdamW3(AdamW3):
    """``AdamW3`` with its state sharded over the ranks of the process group
    (ZeRO-1, the JAX package's ``make_zero1_dp_train_step``). Each group's
    parameters, flattened in order and zero-padded to a multiple of the world
    size N, fall into N contiguous slices; rank r keeps the moments of slice
    r only, and under ``MultiSteps`` the running mean of its gradients too.

    ``step()`` takes the gradients averaged over the ranks (every rank holds
    them, as after the JAX step's ``pmean``), cuts this rank's slices, clips
    them by the global norm, whose square is the sum over the ranks of each
    rank's slices' squared norms, the frozen encoder's included
    (``_shard_global_clip``), updates its slices and reassembles each group's
    parameters by an all-gather. AdamW is elementwise, so the result is the
    replicated update's but for the norm's rounding. ``state_dict`` gathers
    the moments to full parameter shapes (the one-device layout: a one-device
    run restores it) and is a collective that every rank calls;
    ``load_state_dict`` takes that layout and keeps this rank's slices."""

    @functools.cached_property
    def slices(self) -> Dict[str, Tuple[int, int]]:
        """Per group, (first, end) of this rank's slice of the flat group."""
        n, r = parallel.world_size(), parallel.rank()
        out = {}
        for group, names in self.groups.items():
            per = -(-sum(self.params[k].numel() for k in names) // n)
            out[group] = (r * per, (r + 1) * per)
        return out

    def _new_moments(self) -> Dict[str, torch.Tensor]:
        return {g: self._zeros(g) for g in GROUPS}

    def _zeros(self, group: str) -> torch.Tensor:
        first, end = self.slices[group]
        device = next(iter(self.params.values())).device
        return torch.zeros(end - first, device=device)

    def _local(self, group: str, tensors: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
        """This rank's slice of ``group``'s tensors (by parameter name; None
        counts as zeros) flattened in order, zero past the group's end."""
        first, end = self.slices[group]
        out = self._zeros(group)
        offset = 0
        for name in self.groups[group]:
            size = self.params[name].numel()
            a, b = max(first, offset), min(end, offset + size)
            if a < b and tensors.get(name) is not None:
                out[a - first:b - first].copy_(tensors[name].reshape(-1)[a - offset:b - offset])
            offset += size
        return out

    def _full(self, group: str, local: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The ranks' slices of ``group`` gathered, by parameter name, in
        full shapes."""
        flat = parallel.all_gather_flat(local)
        out, offset = {}, 0
        for name in self.groups[group]:
            p = self.params[name]
            out[name] = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        return out

    @torch.no_grad()
    def step(self, grads: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """One update from ``grads`` (by group, this rank's slices, as
        ``local_grads`` gives them), or from each parameter's ``.grad``.
        Returns the global gradient norm (before the clip)."""
        if grads is None:
            grads = self.local_grads()
        sq = torch.stack([g.square().sum() for g in grads.values()]).sum()
        parallel.all_reduce_sum_([sq])
        norm = sq.sqrt()
        grads = dict(zip(grads, self._clipped(list(grads.values()), norm)))
        count = self.count + 1
        for group in GROUPS:
            if not self.groups[group]:
                continue
            local = self._local(group, self.params)
            self._update(group, count, [local], [grads[group]], [self.mu[group]], [self.nu[group]])
            for name, full in self._full(group, local).items():
                self.params[name].copy_(full)
        self.count = count
        return norm

    def local_grads(self) -> Dict[str, torch.Tensor]:
        """This rank's slice of every group's gradients (the frozen group's
        too: the clip counts them)."""
        grads = {n: p.grad for n, p in self.params.items()}
        return {g: self._local(g, grads) for g in self.groups}

    def new_accumulator(self) -> Dict[str, torch.Tensor]:
        return {g: self._zeros(g) for g in self.groups}

    def full_layout(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Slices by group -> full tensors by parameter name (a collective)."""
        out: Dict[str, torch.Tensor] = {}
        for group, local in tensors.items():
            out.update(self._full(group, local))
        return out

    def local_layout(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Full tensors by parameter name -> this rank's slice of each group
        (of the groups whose tensors ``tensors`` holds)."""
        return {g: self._local(g, tensors) for g, names in self.groups.items() if names and names[0] in tensors}

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.full_layout(self.mu), "nu": self.full_layout(self.nu),
                "groups": {g: list(n) for g, n in self.groups.items()}}

    def load_state_dict(self, state: dict) -> None:
        _check_accumulation(state, 1)
        if state["groups"] != self.groups:
            raise ValueError("optimizer-state structure mismatch: the checkpoint was saved with other "
                             "parameter groups (freeze, model config)")
        for key in ("mu", "nu"):
            for n, t in state[key].items():
                if t.shape != self.params[n].shape:
                    raise ValueError(f"optimizer state {key}[{n}] {tuple(t.shape)} does not fit the parameter")
            for group, local in self.local_layout(state[key]).items():
                getattr(self, key)[group].copy_(local)
        self.count = int(state["count"])


class MultiSteps:
    """Gradient accumulation over ``k`` micro-steps around an ``AdamW3``, as
    ``optax.MultiSteps`` (the JAX package's ``accumulate_grad_batches``):
    each ``step()`` folds the parameters' ``.grad`` into a running mean,
    ``acc + (g - acc) / (n + 1)``, kept in its own buffers (every parameter's,
    the frozen encoder's included: the clip counts them). Micro-steps 1 to
    k - 1 change no parameter and leave the optimizer's count alone; the k-th
    runs ``AdamW3.step`` on the mean (clip, moments, decay, the schedule at
    the optimizer's count) and zeroes the mean."""

    def __init__(self, inner: AdamW3, k: int):
        if k < 2:
            raise ValueError(f"MultiSteps accumulates k >= 2 micro-steps, not {k}")
        self.inner = inner
        self.k = k
        self.mini_step = 0
        self.acc = inner.new_accumulator()

    @property
    def count(self) -> int:
        """Optimizer steps taken (micro-steps do not count)."""
        return self.inner.count

    def lr(self, group: str, step: int) -> float:
        return self.inner.lr(group, step)

    @torch.no_grad()
    def step(self) -> Optional[torch.Tensor]:
        """One micro-step. Returns the global gradient norm of the mean on the
        k-th micro-step, None on the others."""
        # in place, with no temporary of the parameters' size: lerp towards
        # g with weight 1 / (n + 1); a missing gradient counts as zero, a
        # lerp towards which is a scaling
        w = 1.0 / (self.mini_step + 1)
        grads = self.inner.local_grads()
        with_grad = [k for k, g in grads.items() if g is not None]
        without = [self.acc[k] for k, g in grads.items() if g is None]
        if with_grad:
            torch._foreach_lerp_([self.acc[k] for k in with_grad], [grads[k] for k in with_grad], w)
        if without:
            torch._foreach_mul_(without, 1.0 - w)
        if self.mini_step < self.k - 1:
            self.mini_step += 1
            return None
        norm = self.inner.step(self.acc)
        torch._foreach_zero_(list(self.acc.values()))
        self.mini_step = 0
        return norm

    def state_dict(self) -> dict:
        """The inner optimizer's state, k, the micro-step count and, in the
        middle of an accumulation only, the running mean (zero otherwise), in
        the one-device layout (under ZeRO-1 a collective: every rank calls it)."""
        return {"inner": self.inner.state_dict(), "accumulate_grad_batches": self.k, "mini_step": self.mini_step,
                "acc": self.inner.full_layout(self.acc) if self.mini_step else None}

    def load_state_dict(self, state: dict) -> None:
        _check_accumulation(state, self.k)
        self.inner.load_state_dict(state["inner"])
        acc = None if state["acc"] is None else self.inner.local_layout(state["acc"])
        for k, a in self.acc.items():
            if acc is None:
                a.zero_()
            else:
                a.copy_(acc[k])
        self.mini_step = int(state["mini_step"])


def _check_accumulation(state: dict, k: int) -> None:
    saved = state.get("accumulate_grad_batches", 1)
    if saved != k:
        raise ValueError(f"optimizer-state structure mismatch: the checkpoint accumulates {saved} micro-steps "
                         f"a step, this run {k} (trainer.accumulate_grad_batches)")
