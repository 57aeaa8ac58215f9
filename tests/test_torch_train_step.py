"""siu3r_tpu_torch's training step against the JAX package, on the tiny
config of tests/test_train.py (32x32, fake_batch).

The port's seeded weights go into JAX through
``siu3r_tpu.checkpoint.convert_siu3r_state_dict`` (the class predictor scaled
up and the BatchNorm statistics randomised, so that queries are kept and the
depth smoothness has segments to follow), and both sides take the same LPIPS
parameters. fake_batch's target cameras sit at the origin, behind the
random-init Gaussians; here they look at them from 0.11 units back, so the
render and its gradient do real work (mean alpha about 0.09: the tiny
model's splats are small and sparse).

The JAX loss is composed in the test from the JAX package's own functions as
``Pipeline.loss_fn`` composes it, with the criterion's sample points injected
into both sides. Its cross-entropy terms use the JAX ``_label_loss`` with the
invalid (padded) objects left out (see tests/test_torch_train_loss.py): the
port, like the reference, marks only the matched queries.

Tolerances: every loss term rtol 1e-3 / atol 1e-5; each parameter tensor's
gradient within a relative L2 error of 2e-3 where its JAX norm exceeds 1e-6
of the global norm; the updated BatchNorm running statistics rtol 1e-4 /
atol 1e-6. The 1/255 alpha cut is a step: a (gaussian, pixel) pair whose
alpha the two sides round to opposite sides of it changes the render, so the
render-level gradient is held tightly by tests/test_torch_train_raster.py on
the same Gaussians, and here through the whole model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siu3r_tpu.checkpoint import convert_siu3r_state_dict
from siu3r_tpu.models.layers import bilinear_resize_torch
from siu3r_tpu.models.model import SIU3RModel as JaxModel
from siu3r_tpu.renderer import render_gaussians as jax_render_gaussians
from siu3r_tpu.train import lpips as jax_lpips
from siu3r_tpu.train.losses import _label_loss as jax_label_loss
from siu3r_tpu.train.losses import depth_smoothness_loss as jax_depth_smoothness
from siu3r_tpu.train.losses import mse_render_loss as jax_mse
from siu3r_tpu.train.losses import segmentation_loss as jax_segmentation_loss
from siu3r_tpu.train.matcher import hungarian_match as jax_hungarian_match
from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch.checkpoint_io import restore_train_state, save_train_state
from siu3r_tpu_torch.pipeline import Pipeline
from siu3r_tpu_torch.weights import lpips_params_from_jax
from test_train import fake_batch, tiny_root_cfg

MATCH_POINTS = 64


def _port_pipeline(cfg, seed=0):
    pipe = Pipeline(cfg, device="cpu", seed=seed).init_train(steps_per_epoch=10)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        pipe.model.mask2former.class_predictor.weight.mul_(8.0)
        for mod in pipe.model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.from_numpy(rng.standard_normal(mod.num_features).astype(np.float32) * 0.1))
                mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, mod.num_features).astype(np.float32)))
    return pipe


def _batch(seed=0):
    batch = {k: np.asarray(v).copy() for k, v in fake_batch(b=2, seed=seed).items()}
    ext = batch["target_views_extrinsics"]
    ext[..., :3, 3] = np.array([0.006, 0.04, -0.2], np.float32) + np.random.RandomState(seed).uniform(
        -0.01, 0.01, ext[..., :3, 3].shape).astype(np.float32)
    return batch


def _injected(cfg, batch, seed=0):
    m2f = cfg.pipeline.model.mask2former
    b, o, v = batch["gt_masks"].shape[:3]
    n_sampled = int(m2f.train_num_points * m2f.oversample_ratio)
    n_random = m2f.train_num_points - int(m2f.importance_sample_ratio * m2f.train_num_points)
    rng = np.random.RandomState(seed)
    return [{
        "match": rng.rand(b, MATCH_POINTS, 2).astype(np.float32),
        "pre": rng.rand(b, o * v, n_sampled, 2).astype(np.float32),
        "extra": rng.rand(b, o * v, n_random, 2).astype(np.float32),
    } for _ in range(m2f.decoder_layers)]


def _jax_loss_fn(jcfg, lpips_params, batch, injected, with_assignments=False):
    """The JAX package's Pipeline.loss_fn, composed from its functions with
    injected sample points and the label loss on the matched queries only.
    ``with_assignments`` adds each layer's Hungarian assignment [L, B, O] to
    the aux outputs."""
    model = JaxModel(jcfg.pipeline.model)
    m2f = jcfg.pipeline.model.mask2former
    pcfg = jcfg.pipeline
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    inj = [{k: jnp.asarray(x) for k, x in d.items()} for d in injected]
    h, w = batch["context_views_images"].shape[2:4]

    def loss_fn(params, batch_stats):
        out, mutated = model.apply({"params": params, "batch_stats": batch_stats}, jb["context_views_images"],
                                   jb["context_views_intrinsics"], train=True, mutable=["batch_stats"])
        render = jax_render_gaussians(out.gaussians, jb["target_views_extrinsics"], jb["target_views_intrinsics"],
                                      (h, w))
        seg = jax_segmentation_loss(
            out.seg.aux_class_logits, out.seg.aux_mask_logits, jb["gt_masks"], jb["gt_classes"], jb["gt_valid"],
            jax.random.PRNGKey(0), num_labels=m2f.num_labels, class_weight=m2f.class_weight,
            mask_weight=m2f.mask_weight, dice_weight=m2f.dice_weight, no_object_weight=m2f.no_object_weight,
            num_points=m2f.train_num_points, oversample=m2f.oversample_ratio,
            importance=m2f.importance_sample_ratio, injected_coords=inj,
        )
        losses = dict(seg)
        assignments = []
        n_layers = len(out.seg.aux_class_logits)
        for li, (cls_l, msk_l) in enumerate(zip(out.seg.aux_class_logits, out.seg.aux_mask_logits)):
            assignment = jax.vmap(
                lambda c, m, gm, gc, gv, mc: jax_hungarian_match(
                    c, m, gm, gc, gv, None, cost_mask=m2f.mask_weight, cost_dice=m2f.dice_weight, coords=mc)
            )(cls_l, msk_l, jb["gt_masks"], jb["gt_classes"], jb["gt_valid"], inj[li]["match"])
            assignments.append(assignment)
            dropped = jnp.where(assignment >= 0, assignment, cls_l.shape[1])
            key = "loss_cross_entropy" + ("" if li == n_layers - 1 else f"_{li}")
            ce = jax_label_loss(cls_l, jb["gt_classes"], dropped, m2f.num_labels, m2f.no_object_weight)
            losses["seg_total"] = losses["seg_total"] + m2f.class_weight * (ce - losses[key])
            losses[key] = ce
        losses["seg"] = losses.pop("seg_total")
        loss = pcfg.weight_seg_loss * losses["seg"]
        ctx_pos = jnp.argmax(jb["context_views_id"][:, :, None] == jb["target_views_id"][:, None, :], axis=-1)
        ctx_depth = jnp.take_along_axis(render.depth, ctx_pos[:, :, None, None], axis=1)
        losses["depth_smoothness"] = jax_depth_smoothness(ctx_depth, out.post["segmentation"])
        loss = loss + pcfg.weight_depth_smoothness * losses["depth_smoothness"]
        target = jb["target_views_images"]
        losses["render_mse"] = jax_mse(render.color, target)
        loss = loss + losses["render_mse"]
        b, n = target.shape[:2]
        half = (h // 2, w // 2)
        if lpips_params is None:  # as the port's loss without LPIPS
            losses["lpips"] = jnp.zeros(())
        else:
            losses["lpips"] = jax_lpips.lpips(
                lpips_params, bilinear_resize_torch(render.color.reshape(b * n, h, w, 3), half, align_corners=True),
                bilinear_resize_torch(target.reshape(b * n, h, w, 3), half, align_corners=True))
            loss = loss + 0.5 * losses["lpips"]
        losses["total"] = loss
        aux = (mutated["batch_stats"], losses, render.alpha)
        return loss, aux + (jnp.stack(assignments),) if with_assignments else aux

    return loss_fn


@pytest.fixture(scope="module")
def slice_run():
    jcfg = tiny_root_cfg()
    cfg = port_config._from_dict(port_config.RootCfg, dataclasses.asdict(jcfg))
    pipe = _port_pipeline(cfg)
    state = {k: v.numpy().copy() for k, v in pipe.model.state_dict().items()}
    variables = convert_siu3r_state_dict(state, jcfg.pipeline.model)
    jlpips = jax_lpips.init_lpips_params(None)
    pipe.lpips_params = lpips_params_from_jax(jax.tree.map(np.asarray, jlpips))
    batch = _batch()
    injected = _injected(jcfg, batch)
    loss_fn = _jax_loss_fn(jcfg, jlpips, batch, injected)
    (_, (jstats, jlosses, jalpha)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])

    _, losses = pipe.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()}, None,
                             injected_coords=[{k: torch.from_numpy(v) for k, v in d.items()} for d in injected])
    losses["total"].backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in pipe.model.named_parameters()}
    after = {k: v.numpy() for k, v in pipe.model.state_dict().items()}
    port_grads = convert_siu3r_state_dict({**after, **grads}, jcfg.pipeline.model)["params"]
    port_stats = convert_siu3r_state_dict(after, jcfg.pipeline.model)["batch_stats"]
    return dict(jlosses=jlosses, jgrads=jgrads, jstats=jstats, jalpha=jalpha, losses=losses,
                port_grads=port_grads, port_stats=port_stats)


def test_loss_terms_match_jax(slice_run):
    r = slice_run
    assert float(np.asarray(r["jalpha"]).mean()) > 0.05  # the target views see the scene's sparse splats
    assert r["losses"].keys() == r["jlosses"].keys()
    for key, ref in r["jlosses"].items():
        np.testing.assert_allclose(float(r["losses"][key].detach()), float(ref), rtol=1e-3, atol=1e-5, err_msg=key)
    assert float(r["jlosses"]["depth_smoothness"]) > 0 and float(r["jlosses"]["lpips"]) > 0


def test_gradients_match_jax(slice_run):
    r = slice_run
    ref = dict(jax.tree_util.tree_leaves_with_path(r["jgrads"]))
    got = dict(jax.tree_util.tree_leaves_with_path(r["port_grads"]))
    global_norm = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64)))) for g in ref.values()))
    checked = 0
    for path, g in ref.items():
        g = np.asarray(g, np.float64)
        norm = np.linalg.norm(g)
        if norm <= 1e-6 * global_norm:
            continue
        err = np.linalg.norm(np.asarray(got[path], np.float64) - g) / norm
        assert err <= 2e-3, (jax.tree_util.keystr(path), err)
        checked += 1
    assert checked > 0.9 * len(ref)


def test_batchnorm_running_stats_match_jax(slice_run):
    r = slice_run
    ref = dict(jax.tree_util.tree_leaves_with_path(r["jstats"]))
    got = dict(jax.tree_util.tree_leaves_with_path(r["port_stats"]))
    assert ref.keys() == got.keys() and ref
    for path, value in ref.items():
        np.testing.assert_allclose(got[path], np.asarray(value), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def _params(pipe):
    return {k: p.detach().clone() for k, p in pipe.model.named_parameters()}


def test_train_step_moves_the_heads_and_keeps_the_encoder(tmp_path):
    jcfg = tiny_root_cfg()
    cfg = port_config._from_dict(port_config.RootCfg, dataclasses.asdict(jcfg))
    pipe = _port_pipeline(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    before = _params(pipe)
    losses = pipe.train_step(batch, torch.Generator().manual_seed(1))
    for key in ("seg", "depth_smoothness", "render_mse", "lpips", "total"):
        assert np.isfinite(float(losses[key])), key
    after = _params(pipe)
    moved = {k: float((after[k] - before[k]).abs().max()) for k in before}
    assert max(v for k, v in moved.items() if k.startswith(("backbone.enc_blocks", "backbone.patch_embed",
                                                            "backbone.enc_norm"))) == 0.0
    for prefix in ("mask2former.", "gaussian_param_head1.", "adapter."):
        assert max(v for k, v in moved.items() if k.startswith(prefix)) > 0.0, prefix
    assert pipe.optimizer.count == 1

    # save -> restore -> step equals step -> step
    save_train_state(tmp_path / "state.pt", pipe, epoch=3, global_step=42)
    other = _port_pipeline(cfg, seed=5)
    assert restore_train_state(tmp_path / "state.pt", other) == (3, 42)
    for k, v in _params(other).items():
        assert torch.equal(v, after[k]), k
    la = pipe.train_step(batch, torch.Generator().manual_seed(2))
    lb = other.train_step(batch, torch.Generator().manual_seed(2))
    np.testing.assert_allclose(float(la["total"]), float(lb["total"]), rtol=1e-6)
    pb = _params(other)
    for k, v in _params(pipe).items():
        np.testing.assert_allclose(pb[k].numpy(), v.numpy(), atol=1e-7, err_msg=k)
    for (ka, a), (kb, b) in zip(pipe.model.state_dict().items(), other.model.state_dict().items()):
        assert ka == kb and torch.allclose(a.float(), b.float(), atol=1e-7), ka

    # the eval step still works, in eval mode
    pipe.eval_step({k: batch[k] for k in ("context_views_images", "context_views_intrinsics",
                                          "target_views_extrinsics", "target_views_intrinsics")})
    assert not pipe.model.training
