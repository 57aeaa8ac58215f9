"""The bf16 train step of siu3r_tpu_torch (``model.dtype: bfloat16`` under
``Pipeline.train_step``) against ``jax.value_and_grad`` of the JAX package's
bf16 loss, on the CPU, at two views.

Config, weights, batch and sample points are those of
tests/test_torch_train_step.py (the tiny config of tests/test_train.py,
32x32, framed target cameras, the same LPIPS parameters on both sides, the
JAX loss composed from the package's own functions) with the model's
compute dtype set to bf16: the backbone and the adapter compute in bf16 on
both sides, from the same fp32 parameters. The JAX loss is compiled with
XLA's excess precision off, as tests/test_torch_bf16.py compiles its
forwards.

The yardstick is the bf16-vs-fp32 gap: for a tensor, ||JAX bf16 - fp32||.
The fp32 side is the port's fp32 step on the same weights and inputs, which
tests/test_torch_train_step.py holds to the JAX package's fp32 step at this
very config and batch (loss terms rtol 1e-3, gradients 2e-3 relative L2,
both far inside the gap), so one JAX compile serves the file.

What the comparison can resolve. The step takes discrete decisions on its
floats: Mask2Former's masked attention thresholds the previous layer's mask
logits, the criterion picks its importance points by top-k of their
uncertainty, and the depth smoothness follows the panoptic labels. A
last-bit difference that flips one of them moves the losses and gradients
downstream by as much as bf16 itself does, and such differences grow from
layer to layer through the adapter's convolutions and deformable sampling:
two equally correct bf16 computations, the port with oneDNN's CPU
convolutions on and then off (nothing else changed), differ by up to 0.87
of the gap in a gradient group at tests/test_model.py's 64x64 config with
four decoder layers, where the port against JAX reaches 1.07 (and 1.4 in
the final cross-entropy). At this config's two decoder layers the rules
below hold at half the gap, with the margins measured beside them.

Rules:
- both sides' Hungarian assignments are equal (a flipped match moves the
  loss terms and gradients by far more than bf16 does);
- each loss term within max(LOSS_FRACTION x gap, LOSS_RTOL x |JAX bf16|)
  (measured: every term within the relative bound; loss_mask_0 at 0.52 of
  its gap), the depth smoothness, masked by the panoptic labels, within
  LABELS_RTOL (measured 1.41e-3, 1.13 of its gap);
- each parameter tensor's gradient scores ||port - JAX bf16|| / gap.
  Tensors whose gap exceeds NOISE_GAP of their fp32 norm hold rounding noise
  (gradients that are zero in exact arithmetic: the biases in front of a
  softmax, a GroupNorm or a BatchNorm) and are left out; at most NOISE_MAX
  of them (measured 10 of 532). Every group (the first two keys of the JAX
  parameter path, a head by its first key) scores at most GROUP_MAX over
  its tensors together (measured: 0.976, ``downstream_head1``; then 0.748,
  ``adapter/up``), and the median tensor at most MEDIAN_MAX (measured
  0.448). A backward that rounds as fp32 does scores 1;
- the BatchNorm running statistics after the step by the same rule
  (measured: median 0.120, worst group 0.338, none left out).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from siu3r_tpu.checkpoint import convert_siu3r_state_dict
from siu3r_tpu.train import lpips as jax_lpips
from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch.models.model import set_compute_dtype
from siu3r_tpu_torch.train import losses as port_losses
from siu3r_tpu_torch.train.optimizer import MultiSteps
from siu3r_tpu_torch.weights import lpips_params_from_jax
from test_torch_bf16 import _strict
from test_torch_train_cli import two_torch_threads  # noqa: F401  (fixture)
from test_torch_train_step import _batch, _injected, _jax_loss_fn, _port_pipeline
from test_torch_weights import port_state_numpy
from test_train import tiny_root_cfg

LOSS_FRACTION, LOSS_RTOL = 0.5, 1e-3
# the depth smoothness is masked by the panoptic labels
FOLLOWS_LABELS, LABELS_RTOL = ("depth_smoothness",), 2e-3
NOISE_GAP = 0.5
NOISE_MAX = 10
GROUP_MAX, MEDIAN_MAX = 1.0, 0.5


def bf16_cfgs(num_views=2, base=tiny_root_cfg):
    """(JAX RootCfg, the port's RootCfg) of ``base()`` with the model's
    compute dtype bf16."""
    jcfg = base()
    jcfg.pipeline.model.num_views = num_views
    jcfg.pipeline.model.dtype = "bfloat16"
    return jcfg, port_config._from_dict(port_config.RootCfg, dataclasses.asdict(jcfg))


def flat(tree):
    """{path of keys: float64 array} of a JAX tree."""
    return {tuple(getattr(k, "key", k) for k in path): np.asarray(x, np.float64)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def port_grads_tree(pipe, model_cfg, convert=convert_siu3r_state_dict):
    """The port's gradients (zeros where the loss did not reach) and its
    state after the step, as flat JAX trees: (params, batch_stats). Every
    gradient is fp32, as the parameters are."""
    grads = {}
    for k, p in pipe.model.named_parameters():
        assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32), k
        grads[k] = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
        p.grad = None
    state = port_state_numpy(pipe.model)
    tree = convert({**state, **grads}, model_cfg)
    return flat(tree["params"]), flat(tree["batch_stats"])


def port_step(pipe, model_cfg, batch, injected):
    """The port's loss terms, gradients, BatchNorm statistics after the
    step (JAX trees) and the criterion's assignments [L, B, O] (kept from
    its ``auction_lap``)."""
    kept = []
    lap = port_losses.auction_lap
    port_losses.auction_lap = lambda *a, **k: kept.append(lap(*a, **k)) or kept[-1]
    try:
        _, losses = pipe.loss_fn({k: torch.from_numpy(x) for k, x in batch.items()}, None,
                                 injected_coords=[{k: torch.from_numpy(x) for k, x in d.items()} for d in injected])
        losses["total"].backward()
    finally:
        port_losses.auction_lap = lap
    grads, stats = port_grads_tree(pipe, model_cfg)
    (assignment,) = kept
    return ({k: float(x.detach()) for k, x in losses.items()}, grads, stats,
            assignment.reshape(len(injected), *batch["gt_valid"].shape).numpy())


def fp32_yardstick(pipe, state, run):
    """``run()`` with ``pipe``'s model at ``state`` computing in fp32, then
    back in bf16 at ``state``."""
    pipe.model.load_state_dict(state)
    set_compute_dtype(pipe.model, "float32")
    try:
        return run()
    finally:
        set_compute_dtype(pipe.model, "bfloat16")
        pipe.model.load_state_dict(state)


def scores(port, j16, p32):
    """{path: (||port - j16|| / gap, gap / ||p32||)} with gap = ||j16 - p32||,
    for every tensor whose gap is not zero."""
    out = {}
    for path, a16 in j16.items():
        gap = np.linalg.norm(a16 - p32[path])
        if gap > 0.0:
            out[path] = (np.linalg.norm(port[path] - a16) / gap, gap / max(np.linalg.norm(p32[path]), 1e-30))
    return out


def group_of(path):
    """The first two keys of a JAX parameter path; a head's first key."""
    return path[:1] if "head" in path[0] else path[:2]


def check_rules(port, j16, p32, group_max, median_max, noise_max, what):
    """The gradient rule of the module docstring. Returns (median, {group:
    score}, the paths left out)."""
    s = scores(port, j16, p32)
    keep = [p for p, (_, gap) in s.items() if gap <= NOISE_GAP]
    noise = sorted(set(s) - set(keep))
    assert len(noise) <= noise_max, f"{what}: {len(noise)} tensors past the noise gap: {noise}"
    num, den = {}, {}
    for p in keep:
        g = group_of(p)
        num[g] = num.get(g, 0.0) + np.sum(np.square(port[p] - j16[p]))
        den[g] = den.get(g, 0.0) + np.sum(np.square(j16[p] - p32[p]))
    groups = {g: float(np.sqrt(num[g] / den[g])) for g in num}
    median = float(np.median([s[p][0] for p in keep]))
    worst = max(groups, key=groups.get)
    assert groups[worst] <= group_max, f"{what}: group {worst} scores {groups[worst]:.3f}"
    assert median <= median_max, f"{what}: median {median:.3f}"
    return median, groups, noise


def check_loss_terms(port, j16, p32):
    assert port.keys() == j16.keys() == p32.keys()
    for key, ref in j16.items():
        rtol = LABELS_RTOL if key in FOLLOWS_LABELS else LOSS_RTOL
        tol = max(LOSS_FRACTION * abs(ref - p32[key]), rtol * abs(ref))
        assert abs(port[key] - ref) <= tol, (key, port[key], ref, p32[key])


# ---------------------------------------------------------------- the two-view step


@pytest.fixture(scope="module")
def step_run():
    jcfg, cfg = bf16_cfgs()
    pipe = _port_pipeline(cfg)
    state = {k: v.clone() for k, v in pipe.model.state_dict().items()}
    # copies: the port's steps below update the BatchNorm statistics in
    # place, and JAX may read a numpy input's buffer after the call returns
    variables = convert_siu3r_state_dict({k: v.numpy().copy() for k, v in state.items()}, jcfg.pipeline.model)
    jlpips = jax_lpips.init_lpips_params(None)
    pipe.lpips_params = lpips_params_from_jax(jax.tree.map(np.asarray, jlpips))
    batch = _batch()
    injected = _injected(jcfg, batch)
    fn = jax.value_and_grad(_jax_loss_fn(jcfg, jlpips, batch, injected, with_assignments=True), has_aux=True)
    (_, (jstats, jlosses, jalpha, jassign)), jgrads = _strict(fn, variables["params"], variables["batch_stats"])
    model_cfg = jcfg.pipeline.model
    run = lambda: port_step(pipe, model_cfg, batch, injected)
    losses, grads, stats, assignment = run()
    losses32, grads32, stats32, _ = fp32_yardstick(pipe, state, run)
    return dict(j16=dict(losses={k: float(x) for k, x in jlosses.items()}, grads=flat(jgrads), stats=flat(jstats),
                         alpha=float(np.asarray(jalpha).mean()), assignment=np.asarray(jassign)),
                losses=losses, grads=grads, stats=stats, assignment=assignment,
                losses32=losses32, grads32=grads32, stats32=stats32)


def test_assignments_are_equal(step_run):
    r = step_run
    np.testing.assert_array_equal(r["assignment"], r["j16"]["assignment"])
    assert (r["assignment"] >= 0).sum() >= 4


def test_loss_terms_match_jax_in_bf16(step_run):
    r = step_run
    assert r["j16"]["alpha"] > 0.05  # the target views see the scene's splats
    check_loss_terms(r["losses"], r["j16"]["losses"], r["losses32"])
    assert r["j16"]["losses"]["depth_smoothness"] > 0 and r["j16"]["losses"]["lpips"] > 0


def test_gradients_match_jax_in_bf16(step_run):
    r = step_run
    _, groups, _ = check_rules(r["grads"], r["j16"]["grads"], r["grads32"], GROUP_MAX, MEDIAN_MAX, NOISE_MAX,
                               "gradients")
    # every trained part and the frozen encoder (its gradient counted by the clip) is scored
    for part in (("backbone", "enc_blocks"), ("backbone", "dec_blocks"), ("adapter", "spm"),
                 ("mask2former", "transformer_module"), ("gaussian_param_head1",), ("downstream_head1",)):
        assert part in groups, part


def test_batchnorm_running_stats_match_jax_in_bf16(step_run):
    r = step_run
    check_rules(r["stats"], r["j16"]["stats"], r["stats32"], GROUP_MAX, MEDIAN_MAX, 0, "statistics")


# ---------------------------------------------------------------- the step's state


def _fp32_state(pipe):
    opt = pipe.optimizer.inner if isinstance(pipe.optimizer, MultiSteps) else pipe.optimizer
    tensors = list(pipe.model.parameters()) + list(opt.mu.values()) + list(opt.nu.values())
    if isinstance(pipe.optimizer, MultiSteps) and pipe.optimizer.acc is not None:
        tensors += list(pipe.optimizer.acc.values())
    return all(t.dtype == torch.float32 for t in tensors)


def test_bf16_train_step_keeps_fp32_state():
    """``train_step`` under bf16 with k = 2 micro-steps of ``MultiSteps``: the
    parameters, the AdamW moments and the running mean stay fp32 (so the
    saved state is the fp32 run's layout; tests/test_torch_train_cli.py
    saves and resumes one); the second micro-step moves the trained parts
    and not the frozen encoder."""
    _, cfg = bf16_cfgs()
    cfg.trainer.accumulate_grad_batches = 2
    pipe = _port_pipeline(cfg)
    batch = {k: torch.from_numpy(v[:1]) for k, v in _batch(1).items()}
    before = {k: p.detach().clone() for k, p in pipe.model.named_parameters()}
    losses = pipe.train_step(batch, torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(x)) for x in losses.values())
    assert (pipe.optimizer.count, pipe.optimizer.mini_step) == (0, 1) and _fp32_state(pipe)
    assert max(float(a.abs().max()) for a in pipe.optimizer.acc.values()) > 0

    losses = pipe.train_step(batch, torch.Generator().manual_seed(1))
    assert all(np.isfinite(float(x)) for x in losses.values())
    assert (pipe.optimizer.count, pipe.optimizer.mini_step) == (1, 0) and _fp32_state(pipe)
    moved = {k: float((p.detach() - before[k]).abs().max()) for k, p in pipe.model.named_parameters()}
    assert max(v for k, v in moved.items() if k.startswith(("backbone.enc_blocks", "backbone.patch_embed"))) == 0.0
    for prefix in ("mask2former.", "gaussian_param_head1.", "adapter.", "backbone.dec_blocks."):
        assert max(v for k, v in moved.items() if k.startswith(prefix)) > 0.0, prefix
