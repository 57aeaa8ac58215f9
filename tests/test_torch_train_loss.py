"""siu3r_tpu_torch's training pieces against the JAX package: the auction LAP,
the matcher, the segmentation criterion, the depth-smoothness and MSE terms,
LPIPS, the point samplers and the optimizer.

Inputs are made from a seed with numpy and handed to both sides.

The JAX package's ``_label_loss`` writes the no-object class, through the
clipped index 0, for every invalid (padded) object; where query 0 is matched
to a valid object, the order of XLA's scatter decides which write stays. The
port marks only the matched queries, as the reference's loss_labels does.
The cross-entropy terms are therefore held against the JAX ``_label_loss``
fed the JAX matcher's assignment with the invalid rows sent past the last
query, which its ``mode="drop"`` scatter leaves out (``jax_label_losses``).
Tolerances: assignments equal (and, against scipy, cost-optimal); the
criterion's terms rtol 1e-4 (tests/test_criterion_parity.py's); LPIPS rtol
1e-5 on the value and 1e-4 on its input gradient; the optimizer's params
rtol 1e-6 / atol 1e-7 after 5 steps, its learning rates within rel 1e-7 of
``make_lr_schedule``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from siu3r_tpu.ops.deformable import grid_sample_bilinear as jax_grid_sample_bilinear
from siu3r_tpu.ops.deformable import grid_sample_separable as jax_grid_sample_separable
from siu3r_tpu.train.matcher import sample_mask_points as jax_sample_mask_points
from siu3r_tpu.ops.lap import auction_lap as jax_auction_lap
from siu3r_tpu.train import lpips as jax_lpips
from siu3r_tpu.train.losses import _label_loss as jax_label_loss
from siu3r_tpu.train.losses import depth_smoothness_loss as jax_depth_smoothness
from siu3r_tpu.train.losses import mse_render_loss as jax_mse
from siu3r_tpu.train.losses import segmentation_loss as jax_segmentation_loss
from siu3r_tpu.train.matcher import hungarian_match as jax_hungarian_match
from siu3r_tpu.train.optimizer import make_lr_schedule as jax_lr_schedule
from siu3r_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch.ops import lap
from siu3r_tpu_torch.ops.deformable import grid_sample_bilinear
from siu3r_tpu_torch.train import lpips
from siu3r_tpu_torch.train.losses import depth_smoothness_loss, mse_render_loss, segmentation_loss
from siu3r_tpu_torch.train.matcher import hungarian_match, sample_mask_points
from siu3r_tpu_torch.train.optimizer import GROUPS, AdamW3, group_of
from siu3r_tpu_torch.weights import lpips_params_from_jax
from test_train import tiny_root_cfg


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- LAP


def _lap_cases():
    rng = np.random.RandomState(0)
    cases = []
    for r, c in ((15, 100), (48, 100), (30, 40), (8, 8)):  # both regimes
        cases.append((f"random_{r}x{c}", rng.rand(5, r, c).astype(np.float32) * 10, rng.rand(5, r) > 0.25))
    dup = rng.rand(3, 12, 40).astype(np.float32)
    dup[:, 6:] = dup[:, :6]  # duplicated rows: ties
    cases.append(("dup_rows", dup, np.ones((3, 12), bool)))
    quant = np.round(rng.rand(3, 20, 20) * 4).astype(np.float32)  # quantized: many ties
    cases.append(("quantized_square", quant, rng.rand(3, 20) > 0.1))
    return cases


@pytest.mark.parametrize("name,cost,valid", _lap_cases(), ids=[c[0] for c in _lap_cases()])
def test_auction_lap_matches_jax_and_scipy(name, cost, valid):
    got = lap.auction_lap(_t(cost), _t(valid)).numpy()
    ref = np.stack([np.asarray(jax_auction_lap(jnp.asarray(c), jnp.asarray(v))) for c, v in zip(cost, valid)])
    np.testing.assert_array_equal(got, ref)
    for c, v, a in zip(cost, valid, got):
        assert (a[~v] == -1).all()
        rows = np.where(v)[0]
        assert len(np.unique(a[rows])) == len(rows) and (a[rows] >= 0).all()
        ri, ci = linear_sum_assignment(c[rows])
        assert c[rows, a[rows]].sum() <= c[rows][ri, ci].sum() + 1e-3
        if not name.startswith(("dup", "quant")):  # no ties: the same assignment as scipy
            np.testing.assert_array_equal(a[rows][ri], ci)


def test_auction_lap_counts_one_sync_when_the_first_block_converges(monkeypatch):
    rng = np.random.RandomState(1)
    tests = []  # each convergence test is one host sync
    unassigned = lap._unassigned
    monkeypatch.setattr(lap, "_unassigned", lambda *a: tests.append(1) or unassigned(*a))
    lap.auction_lap(_t(rng.rand(20, 48, 100).astype(np.float32)), _t(rng.rand(20, 48) > 0.5))
    assert len(tests) == 1


def test_auction_lap_raises_when_it_does_not_converge():
    rng = np.random.RandomState(2)
    with pytest.raises(lap.LAPNotConverged):
        lap.auction_lap(_t(rng.rand(1, 10, 30).astype(np.float32)), max_iters=1)


# ---------------------------------------------------------------- samplers, matcher, criterion


def test_point_samplers_match_jax():
    """The port's one sampler (the gather form) against the JAX package's
    gather and separable forms and its matcher's interpolation-matrix form."""
    rng = np.random.RandomState(3)
    img = rng.randn(3, 9, 13, 1).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (3, 50, 2)).astype(np.float32)
    got = grid_sample_bilinear(_t(img), _t(grid)).numpy()
    for jax_sampler in (jax_grid_sample_bilinear, jax_grid_sample_separable):
        ref = np.asarray(jax_sampler(jnp.asarray(img), jnp.asarray(grid)))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    masks = rng.randn(4, 2, 9, 13).astype(np.float32)
    coords = rng.uniform(-0.1, 1.1, (50, 2)).astype(np.float32)
    ref = np.asarray(jax_sample_mask_points(jnp.asarray(masks), jnp.asarray(coords)))
    np.testing.assert_allclose(sample_mask_points(_t(masks), _t(coords)).numpy(), ref, rtol=1e-6, atol=1e-6)


B, Q, V, H, W = 2, 8, 2, 16, 16
NUM_LABELS, O, N_LAYERS = 5, 4, 2
NUM_POINTS, OVERSAMPLE, IMPORTANCE = 32, 2.0, 0.75
N_SAMPLED, N_RANDOM = int(NUM_POINTS * OVERSAMPLE), NUM_POINTS - int(IMPORTANCE * NUM_POINTS)


def _criterion_inputs(seed):
    rng = np.random.RandomState(seed)
    cls = [(rng.randn(B, Q, NUM_LABELS + 1) * 2).astype(np.float32) for _ in range(N_LAYERS)]
    msk = [(rng.randn(B, Q, V, H, W) * 2).astype(np.float32) for _ in range(N_LAYERS)]
    gt_masks = (rng.rand(B, O, V, H, W) > 0.6).astype(np.float32)
    gt_classes = rng.randint(0, NUM_LABELS, (B, O)).astype(np.int32)
    gt_valid = np.array([[True] * O, [True, True, False, False]])
    injected = [{
        "match": rng.rand(B, NUM_POINTS, 2).astype(np.float32),
        "pre": rng.rand(B, O * V, N_SAMPLED, 2).astype(np.float32),
        "extra": rng.rand(B, O * V, N_RANDOM, 2).astype(np.float32),
    } for _ in range(N_LAYERS)]
    return cls, msk, gt_masks, gt_classes, gt_valid, injected


def jax_label_losses(cls, msk, gt_masks, gt_classes, gt_valid, injected, num_labels, num_points,
                     no_object_weight=0.1, cost_mask=5.0, cost_dice=5.0):
    """Per layer: the JAX matcher's assignment [B, O] and the JAX
    ``_label_loss`` on it with the invalid rows dropped (module docstring)."""
    out = []
    for li, (c, m) in enumerate(zip(cls, msk)):
        assignment = jax.vmap(
            lambda c, m, gm, gc, gv, mc: jax_hungarian_match(
                c, m, gm, gc, gv, None, num_points=num_points, cost_mask=cost_mask, cost_dice=cost_dice,
                coords=mc)
        )(jnp.asarray(c), jnp.asarray(m), jnp.asarray(gt_masks), jnp.asarray(gt_classes),
          jnp.asarray(gt_valid), jnp.asarray(injected[li]["match"]))
        dropped = jnp.where(assignment >= 0, assignment, c.shape[1])
        out.append((np.asarray(assignment),
                    jax_label_loss(c, jnp.asarray(gt_classes), dropped, num_labels, no_object_weight)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_hungarian_match_with_injected_coords_matches_jax(seed):
    cls, msk, gt_masks, gt_classes, gt_valid, injected = _criterion_inputs(seed)
    for li in range(N_LAYERS):
        for i in range(B):
            coords = injected[li]["match"][i]
            ref = jax_hungarian_match(
                jnp.asarray(cls[li][i]), jnp.asarray(msk[li][i]), jnp.asarray(gt_masks[i]),
                jnp.asarray(gt_classes[i]), jnp.asarray(gt_valid[i]), jax.random.PRNGKey(0),
                num_points=NUM_POINTS, coords=jnp.asarray(coords),
            )
            got = hungarian_match(_t(cls[li][i]), _t(msk[li][i]), _t(gt_masks[i]), _t(gt_classes[i]),
                                  _t(gt_valid[i]), coords=_t(coords))
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_segmentation_loss_with_injected_coords_matches_jax(seed):
    cls, msk, gt_masks, gt_classes, gt_valid, injected = _criterion_inputs(seed)
    kw = dict(num_labels=NUM_LABELS, num_points=NUM_POINTS, oversample=OVERSAMPLE, importance=IMPORTANCE,
              match_points=NUM_POINTS)
    ref = jax_segmentation_loss(
        [jnp.asarray(x) for x in cls], [jnp.asarray(x) for x in msk], jnp.asarray(gt_masks),
        jnp.asarray(gt_classes), jnp.asarray(gt_valid), jax.random.PRNGKey(0),
        injected_coords=[{k: jnp.asarray(v) for k, v in inj.items()} for inj in injected], **kw,
    )
    cls_t = [_t(x).requires_grad_(True) for x in cls]
    msk_t = [_t(x).requires_grad_(True) for x in msk]
    got = segmentation_loss(cls_t, msk_t, _t(gt_masks), _t(gt_classes), _t(gt_valid), None,
                            injected_coords=[{k: _t(v) for k, v in inj.items()} for inj in injected], **kw)
    assert got.keys() == ref.keys()
    for key in ref:
        if "cross_entropy" not in key and key != "seg_total":
            np.testing.assert_allclose(float(got[key].detach()), float(ref[key]), rtol=1e-4, err_msg=key)
    total = float(ref["seg_total"])
    for li, (_, ce) in enumerate(jax_label_losses(cls, msk, gt_masks, gt_classes, gt_valid, injected,
                                                  NUM_LABELS, NUM_POINTS)):
        key = "loss_cross_entropy" + ("" if li == N_LAYERS - 1 else f"_{li}")
        np.testing.assert_allclose(float(got[key].detach()), float(ce), rtol=1e-4, err_msg=key)
        total += 2.0 * (float(ce) - float(ref[key]))
    np.testing.assert_allclose(float(got["seg_total"].detach()), total, rtol=1e-4)
    got["seg_total"].backward()
    assert all(float(x.grad.abs().max()) > 0 for x in cls_t + msk_t)


def test_segmentation_loss_random_path_is_seeded_and_finite():
    cls, msk, gt_masks, gt_classes, gt_valid, _ = _criterion_inputs(2)
    kw = dict(num_labels=NUM_LABELS, num_points=NUM_POINTS, oversample=OVERSAMPLE, importance=IMPORTANCE,
              match_points=NUM_POINTS)
    runs = []
    for _ in range(2):
        msk_t = [_t(x).requires_grad_(True) for x in msk]
        out = segmentation_loss([_t(x) for x in cls], msk_t, _t(gt_masks), _t(gt_classes), _t(gt_valid),
                                torch.Generator().manual_seed(4), **kw)
        out["seg_total"].backward()  # the checkpointed point losses recompute the same draws
        runs.append((float(out["seg_total"]), [x.grad for x in msk_t]))
    assert np.isfinite(runs[0][0]) and runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b) and float(a.abs().max()) > 0
    with pytest.raises(ValueError):
        segmentation_loss([_t(x) for x in cls], [_t(x) for x in msk], _t(gt_masks), _t(gt_classes),
                          _t(gt_valid), None, **kw)


@pytest.mark.parametrize("masked", [True, False])
def test_depth_smoothness_and_mse_match_jax(masked):
    rng = np.random.RandomState(5)
    depth = rng.rand(2, 2, 12, 14).astype(np.float32)
    seg = rng.randint(-1, 3, (2, 2, 12, 14)).astype(np.int32)
    ref = jax_depth_smoothness(jnp.asarray(depth), jnp.asarray(seg), instance_masked=masked)
    got = depth_smoothness_loss(_t(depth), _t(seg), instance_masked=masked)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    a, b = rng.rand(2, 3, 5, 5, 3).astype(np.float32), rng.rand(2, 3, 5, 5, 3).astype(np.float32)
    np.testing.assert_allclose(float(mse_render_loss(_t(a), _t(b))), float(jax_mse(a, b)), rtol=1e-6)


# ---------------------------------------------------------------- LPIPS


def test_lpips_matches_jax_value_and_input_gradient():
    jparams = jax_lpips.init_lpips_params(None)
    params = lpips_params_from_jax(jax.tree.map(np.asarray, jparams))
    fresh = lpips.init_lpips_params(None)  # the port's own fixed-seed VGG is the same
    for (w, b), (w2, b2) in zip(params["convs"], fresh["convs"]):
        assert torch.equal(w, w2) and torch.equal(b, b2)
    rng = np.random.RandomState(6)
    x, y = rng.rand(2, 32, 32, 3).astype(np.float32), rng.rand(2, 32, 32, 3).astype(np.float32)
    ref, ref_grad = jax.jit(jax.value_and_grad(lambda a: jax_lpips.lpips(jparams, a, jnp.asarray(y))))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = lpips.lpips(params, xt, _t(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad), rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref_grad).max()))


# ---------------------------------------------------------------- optimizer


@pytest.fixture(scope="module")
def tiny_train_cfgs():
    jcfg = tiny_root_cfg()
    return jcfg, port_config._from_dict(port_config.RootCfg, dataclasses.asdict(jcfg))


# parameter names of every group: frozen encoder, 5x, 3x and 0.1x
GROUP_NAMES = (
    "backbone.patch_embed.proj", "backbone.enc_blocks.0.fc", "backbone.enc_norm", "backbone.intrinsic_encoder",
    "gaussian_param_head1.head", "adapter.spm.fc1", "mask2former.class_predictor", "backbone.dec_blocks.0.fc",
    "downstream_head1.head",
)


class _Named(torch.nn.Module):
    """Linear layers under the model's parameter names, so that both
    optimizers group them as they group the model."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        for i, name in enumerate(GROUP_NAMES):
            parent = self
            for part in name.split(".")[:-1]:
                if not hasattr(parent, part):
                    parent.add_module(part, torch.nn.Module())
                parent = getattr(parent, part)
            lin = torch.nn.Linear(5 + i, 3 + i)
            torch.nn.init.normal_(lin.weight, generator=gen)
            parent.add_module(name.split(".")[-1], lin)


def _nested(flat):
    """{"a.b.weight": x} -> {"a": {"b": {"weight": x}}} (the JAX tree)."""
    tree = {}
    for name, value in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _grads(model, rng, frozen_scale):
    return {n: (rng.randn(*p.shape) * (frozen_scale if group_of(n, True) == "frozen" else 1.0)).astype(np.float32)
            for n, p in model.named_parameters()}


def test_optimizer_matches_optax_over_five_steps(tiny_train_cfgs):
    jcfg, cfg = tiny_train_cfgs
    model = _Named()
    named = dict(model.named_parameters())
    assert {g: sum(group_of(n, True) == g for n in named) > 0 for g in (*GROUPS, "frozen")} == dict.fromkeys(
        (*GROUPS, "frozen"), True)
    params = _nested({n: p.detach().numpy().copy() for n, p in named.items()})
    tx = jax_make_optimizer(params, jcfg.optimizer, jcfg.trainer, steps_per_epoch=10, freeze_encoder=True)
    state = tx.init(params)

    @jax.jit
    def jax_step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    opt = AdamW3(model, cfg.optimizer, cfg.trainer, steps_per_epoch=10, freeze_encoder=True)
    frozen0 = {n: p.detach().clone() for n, p in named.items() if group_of(n, True) == "frozen"}
    rng = np.random.RandomState(7)
    for step in range(5):
        # large frozen-encoder gradients: the clip norm is mostly theirs
        grads = _grads(model, rng, frozen_scale=10.0)
        params, state = jax_step(_nested(grads), state, params)
        for n, p in named.items():
            p.grad = _t(grads[n])
        assert float(opt.step()) > jcfg.trainer.gradient_clip_val  # the clip is active
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(_nested({n: p.detach().numpy() for n, p in named.items()})))
    for path, ref in flat_ref.items():
        np.testing.assert_allclose(flat_got[path], np.asarray(ref), rtol=1e-6, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
    for n, p0 in frozen0.items():
        assert torch.equal(named[n].detach(), p0), n
    assert opt.count == 5


def test_optimizer_clip_counts_the_frozen_gradients(tiny_train_cfgs):
    """The clip's norm is over every gradient, the frozen encoder's included:
    larger frozen gradients in the first of two steps clip that step's
    trainable gradients harder, which moves the second step's update."""
    _, cfg = tiny_train_cfgs
    after = []
    for scale in (0.0, 10.0):
        model = _Named()
        opt = AdamW3(model, cfg.optimizer, cfg.trainer, steps_per_epoch=10, freeze_encoder=True)
        rng = np.random.RandomState(8)
        for step_scale in (scale, 0.0):
            grads = _grads(model, rng, frozen_scale=step_scale)
            for n, p in model.named_parameters():
                p.grad = _t(grads[n])
            norm = float(opt.step())
            np.testing.assert_allclose(norm, np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                                          for g in grads.values())), rtol=1e-5)
        after.append(model.mask2former.class_predictor.weight.detach().clone())
    assert not torch.allclose(after[0], after[1], rtol=1e-6, atol=0)


def test_learning_rates_match_make_lr_schedule(tiny_train_cfgs):
    jcfg, cfg = tiny_train_cfgs
    opt = AdamW3(_Named(), cfg.optimizer, cfg.trainer, steps_per_epoch=10, freeze_encoder=True)
    o = jcfg.optimizer
    mults = {"normal": o.gaussian_head_lr_mult, "high": o.seg_lr_mult, "low": o.base_lr_mult}
    for group, mult in mults.items():
        ref = jax_lr_schedule(o.lr * mult, o.warm_up_epochs, jcfg.trainer.max_epochs, 10)
        for step in range(45):
            want = float(ref(step))
            assert abs(opt.lr(group, step) - want) <= 1e-7 * want, (group, step)
