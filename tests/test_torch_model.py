"""siu3r_tpu_torch modules and the two-view slice against the JAX package.

The port is built with a seeded random init on the CPU; its ``state_dict``
goes through ``siu3r_tpu.checkpoint.convert_siu3r_state_dict`` into the JAX
modules, so both sides hold the same weights. Inputs are made from a seed
with numpy. Config: the tiny config of tests/test_model.py. The class
predictor is scaled up and the BatchNorm statistics randomised so that the
panoptic post-process keeps queries and the BatchNorms do real work.

Tolerances: floats rtol 1e-3 / atol 1e-4 (fp32 on both sides, other
summation orders); integer labels exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siu3r_tpu.checkpoint import convert_siu3r_state_dict
from siu3r_tpu.models.adapter import CroCoViTAdapter as JaxAdapter
from siu3r_tpu.models.backbone import AsymmetricCroCo as JaxBackbone
from siu3r_tpu.models.gaussian_adapter import adapt_gaussians as jax_adapt_gaussians
from siu3r_tpu.models.heads.dpt import DPTHead as JaxDPTHead
from siu3r_tpu.models.heads.dpt import postprocess_pts3d as jax_postprocess_pts3d
from siu3r_tpu.models.mask2former.model import VideoMask2Former as JaxMask2Former
from siu3r_tpu.models.mask2former.postprocess import (
    panoptic_segmentation as jax_panoptic,
    qc_logits_per_pixel as jax_qc_logits,
)
from siu3r_tpu.models.model import SIU3RModel as JaxModel
from siu3r_tpu_torch.models.gaussian_adapter import adapt_gaussians
from siu3r_tpu_torch.models.heads.dpt import postprocess_pts3d
from siu3r_tpu_torch.models.mask2former.postprocess import (
    _segment_ids,
    panoptic_segmentation,
    qc_logits_per_pixel,
)
from siu3r_tpu_torch.models.model import build_model
from test_model import tiny_model_cfg
from test_torch_weights import port_cfg, port_state_numpy

RTOL, ATOL = 1e-3, 1e-4
H = W = 64


def _close(port, ref, rtol=RTOL, atol=ATOL, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol, err_msg=what)


def _equal(port, ref, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_array_equal(port.astype(np.int64), np.asarray(ref).astype(np.int64), err_msg=what)


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_model_cfg()
    model = build_model(port_cfg(jcfg), device="cpu", seed=0)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        model.mask2former.class_predictor.weight.mul_(8.0)
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.from_numpy(rng.standard_normal(mod.num_features).astype(np.float32) * 0.1))
                mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, mod.num_features).astype(np.float32)))
    variables = convert_siu3r_state_dict(port_state_numpy(model), jcfg)
    images = rng.rand(1, 2, H, W, 3).astype(np.float32)
    intr = np.tile(np.array([[1.24, 0, 0.5], [0, 1.24, 0.5], [0, 0, 1]], np.float32), (1, 2, 1, 1))
    return jcfg, model, variables, images, intr


def test_backbone_matches_jax(tiny):
    jcfg, model, variables, images, intr = tiny
    ref = jax.jit(JaxBackbone(jcfg.croco).apply)({"params": variables["params"]["backbone"]}, images, intr)
    with torch.inference_mode():
        out = model.backbone(torch.from_numpy(images), torch.from_numpy(intr))
    _close(out.feat1, ref.feat1, what="feat1")
    _close(out.feat2, ref.feat2, what="feat2")
    for i, (a, b) in enumerate(zip(out.all_feat1 + out.all_feat2, ref.all_feat1 + ref.all_feat2)):
        _close(a, b, what=f"all_feat {i}")
    assert len(out.dec1) == len(ref.dec1) == jcfg.croco.dec_depth + 1
    for i, (a, b) in enumerate(zip(out.dec1 + out.dec2, ref.dec1 + ref.dec2)):
        _close(a, b, what=f"dec {i}")


def test_adapter_matches_jax(tiny):
    jcfg, model, variables, _, _ = tiny
    rng = np.random.RandomState(1)
    image = rng.rand(2, H, W, 3).astype(np.float32)
    c = jcfg.croco
    feats = [rng.standard_normal((2, (H // 16) * (W // 16), c.enc_embed_dim)).astype(np.float32) for _ in range(c.enc_depth)]
    ref = jax.jit(JaxAdapter(
        num_block=c.enc_depth, embed_dim=c.enc_embed_dim, patch_size=c.patch_size,
        interaction_indexes=model.adapter.interaction_indexes,
    ).apply)(
        {"params": variables["params"]["adapter"], "batch_stats": variables["batch_stats"]["adapter"]},
        image, feats,
    )
    with torch.inference_mode():
        out = model.adapter(torch.from_numpy(image), [torch.from_numpy(f) for f in feats])
    for i, (a, b) in enumerate(zip(out, ref)):
        _close(a, b, what=f"level {i}")


@pytest.mark.parametrize("head", ["downstream_head1", "gaussian_param_head2"])
def test_dpt_head_and_gaussian_adapter_match_jax(tiny, head):
    jcfg, model, variables, images, _ = tiny
    rng = np.random.RandomState(2)
    c = jcfg.croco
    n = (H // 16) * (W // 16)
    tokens = [rng.standard_normal((1, n, d)).astype(np.float32) for d in (c.enc_embed_dim,) + (c.dec_embed_dim,) * 3]
    regression = head.startswith("downstream")
    channels = 3 if regression else jcfg.gaussian_head.raw_dim
    image = None if regression else images[:, 1]
    jax_head = JaxDPTHead(num_channels=channels, head_type="regression" if regression else "gs_params")
    ref = jax.jit(jax_head.apply, static_argnums=3)({"params": variables["params"][head]}, tokens, image, (H, W))
    with torch.inference_mode():
        out = getattr(model, head)(
            [torch.from_numpy(t) for t in tokens], None if image is None else torch.from_numpy(image), (H, W)
        )
    _close(out, ref, what="raw head output")
    if regression:
        _close(postprocess_pts3d(out), jax_postprocess_pts3d(ref), what="pts3d")
    else:
        means = rng.standard_normal((1, H * W, 3)).astype(np.float32)
        g = adapt_gaussians(torch.from_numpy(means), out.reshape(1, H * W, -1), jcfg.gaussian_head.sh_degree)
        jg = jax_adapt_gaussians(jnp.asarray(means), ref.reshape(1, H * W, -1), jcfg.gaussian_head.sh_degree)
        for f in ("covariances", "harmonics", "opacities", "scales", "rotations"):
            _close(getattr(g, f), getattr(jg, f), what=f)


def test_mask2former_matches_jax(tiny):
    jcfg, model, variables, _, _ = tiny
    rng = np.random.RandomState(3)
    ed = jcfg.croco.enc_embed_dim
    feats = [rng.standard_normal((1, 2, H // s, W // s, ed)).astype(np.float32) for s in (4, 8, 16, 32)]
    ref = jax.jit(JaxMask2Former(jcfg.mask2former).apply)({"params": variables["params"]["mask2former"]}, feats)
    with torch.inference_mode():
        out = model.mask2former([torch.from_numpy(f) for f in feats])
    _close(out.last_hidden_state, ref.last_hidden_state, what="last hidden state")
    assert len(out.aux_class_logits) == len(ref.aux_class_logits) == jcfg.mask2former.decoder_layers
    for i, (a, b) in enumerate(zip(out.aux_class_logits, ref.aux_class_logits)):
        _close(a, b, what=f"class logits {i}")
    for i, (a, b) in enumerate(zip(out.aux_mask_logits, ref.aux_mask_logits)):
        _close(a, b, what=f"mask logits {i}")


POST_CASES = {
    "kept_queries": (4.0, 0),
    "none_kept": (0.0, 1),
    "many_kept_stuff_fused": (8.0, 2),
}


@pytest.mark.parametrize("name", list(POST_CASES))
def test_panoptic_postprocess_matches_jax(name):
    """Synthetic logits: each query owns blocks of a random region map, so
    kept queries pass the area-ratio check; random floats leave no argmax or
    threshold ties."""
    scale, seed = POST_CASES[name]
    rng = np.random.RandomState(10 + seed)
    b, q, v, num_labels = 2, 12, 2, 5
    class_logits = (rng.standard_normal((b, q, num_labels + 1)) * scale).astype(np.float32)
    owner = rng.randint(0, q, (b, 1, v, 4, 4)).repeat(4, axis=3).repeat(4, axis=4)
    own = owner == np.arange(q)[None, :, None, None, None]
    mask_logits = (np.where(own, 4.0, -4.0) + rng.standard_normal((b, q, v, 16, 16))).astype(np.float32)
    kw = dict(target_size=(H, W), label_ids_to_fuse=(0, 1), num_labels=num_labels, max_lift_queries=4)
    ref = jax_panoptic(jnp.asarray(class_logits), jnp.asarray(mask_logits), **kw)
    out = panoptic_segmentation(torch.from_numpy(class_logits), torch.from_numpy(mask_logits), **kw)
    assert out.keys() == ref.keys()
    for key in ("segmentation", "semantic", "keep", "exists", "seg_ids", "pred_labels", "lift_slot", "lifted", "qc_valid"):
        _equal(out[key], ref[key], what=key)
    for key in ("pred_scores", "qc_class_probs", "qc_mask_probs", "query_scores"):
        _close(out[key], ref[key], what=key)
    _close(qc_logits_per_pixel(out), jax_qc_logits(ref), what="qc logits")
    if name == "none_kept":
        assert not bool(out["keep"].any()) and int(out["segmentation"].min()) == -1
    else:
        assert int(out["exists"].sum()) > 0


def test_segment_ids_match_the_sequential_rule():
    """The device form of the segment-id assignment against the query loop it
    replaces, on flags with many repeated labels (fused and not)."""
    rng = np.random.RandomState(5)
    exists = rng.rand(6, 40) < 0.6
    labels = rng.randint(0, 5, (6, 40))
    fuse = (0, 3)
    want = np.zeros(exists.shape, np.int64)
    for bi in range(exists.shape[0]):
        current, stuff_mem = 0, {}
        for k in np.flatnonzero(exists[bi]):
            lbl = int(labels[bi, k])
            if lbl in stuff_mem:
                want[bi, k] = stuff_mem[lbl]
                continue
            current += 1
            want[bi, k] = current
            if lbl in fuse:
                stuff_mem[lbl] = current
    got = _segment_ids(torch.from_numpy(exists), torch.from_numpy(labels), fuse)
    np.testing.assert_array_equal(got.numpy(), want)


def test_two_view_slice_matches_jax(tiny):
    """Whole forward: images -> Gaussians with lifted labels and query-class
    confidences, the dense post-process and the seg logits."""
    jcfg, model, variables, images, intr = tiny
    jm = JaxModel(jcfg)
    ref = jax.jit(lambda v, a, b: jm.apply(v, a, b, enable_query_class_logit_lift=True))(variables, images, intr)
    with torch.inference_mode():
        out = model(torch.from_numpy(images), torch.from_numpy(intr), enable_query_class_logit_lift=True)
    _close(out.pts3d, ref.pts3d, what="pts3d")
    for f in ("means", "covariances", "harmonics", "opacities", "scales", "rotations",
              "seg_query_class_logits", "seg_query_scores"):
        _close(getattr(out.gaussians, f), getattr(ref.gaussians, f), what=f)
    for f in ("semantic_labels", "instance_labels", "seg_query_valid"):
        _equal(getattr(out.gaussians, f), getattr(ref.gaussians, f), what=f)
    _close(out.seg.class_queries_logits, ref.seg.class_queries_logits, what="class logits")
    _close(out.seg.masks_queries_logits, ref.seg.masks_queries_logits, what="mask logits")
    for key in ("segmentation", "semantic", "keep", "exists", "seg_ids", "pred_labels"):
        _equal(out.post[key], ref.post[key], what=key)
    # the scaled class predictor keeps queries, so the labels are not all background
    assert int(out.post["keep"].sum()) > 0
    assert int(out.gaussians.semantic_labels.max()) > 0
