"""siu3r_tpu_torch's multi-view path against the JAX package: the shared-bank
backbone, the V-view model, its eval step and train step, and the
multi-view inference CLI.

Config: the tiny config of tests/test_model.py at V = 3 (and the backbone at
V = 4), 64x64; the train step on the tiny config of tests/test_train.py at
V = 3 (32x32, 3 context views among 5 sorted target views, as the
datamodule's sampler orders them). The port is built with a seeded random
init on the CPU and its ``state_dict`` goes through
``siu3r_tpu.checkpoint.convert_siu3r_state_dict`` into JAX, so both sides
hold the same weights (the class predictor scaled up and the BatchNorm
statistics randomised, so that queries are kept and lifted). Inputs are made
from a seed with numpy.

Tolerances: the backbone's and the model's floats rtol 1e-3 / atol 1e-4;
labels equal on >= 99.9% of Gaussians; the renders rtol 1e-3 / atol 1e-3
(depth 1e-2, as tests/test_torch_pipeline.py holds them); the loss terms
rtol 1e-3 / atol 1e-5 and each gradient within a relative L2 error of 2e-3
(tests/test_torch_train_step.py); the multi-view backbone at V = 2 against
the two-view one rtol 1e-5 / atol 1e-5 (the same arithmetic but for the
masked keys, whose weights are exactly 0).

One exception, in the JAX reference: the gradients of the adapter's first
conv and BatchNorm (``spm.stem1``) are sums whose terms cancel to about
1e-4 of their magnitude at this batch, and the JAX package computes that
BatchNorm in fp32 whatever the module's dtype: its gradient there is off by
4e-3 to 6e-3 (relative L2) from the same function in float64, where the
port's fp32 gradient is within 2e-6. Those tensors are held against the
port's SPM recomputed in float64 on the step's own input and cotangents,
at the same 2e-3.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from siu3r_tpu.checkpoint import convert_siu3r_state_dict
from siu3r_tpu.config import PipelineCfg as JaxPipelineCfg
from siu3r_tpu.config import RootCfg as JaxRootCfg
from siu3r_tpu.io import export_ply as jax_export_ply
from siu3r_tpu.io import read_ply as jax_read_ply
from siu3r_tpu.models.backbone import AsymmetricCroCoMulti as JaxMultiBackbone
from siu3r_tpu.pipeline import Pipeline as JaxPipeline
from siu3r_tpu.pipeline import TrainState
from siu3r_tpu.train import lpips as jax_lpips
from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch.cli import inference, inference_multiview
from siu3r_tpu_torch.config import PipelineCfg, RootCfg
from siu3r_tpu_torch.models.backbone import AsymmetricCroCo
from siu3r_tpu_torch.models.model import SIU3RModel, build_model
from siu3r_tpu_torch.pipeline import Pipeline
from siu3r_tpu_torch.weights import lpips_params_from_jax
from test_model import tiny_model_cfg
from test_torch_train_step import _injected, _jax_loss_fn, _port_pipeline
from test_torch_weights import port_cfg, port_state_numpy
from test_train import fake_batch, tiny_root_cfg

RTOL, ATOL = 1e-3, 1e-4
H = W = 64
V = 3
N_TARGET = 4
# the adapter's first conv and BatchNorm, in the port's and the JAX package's names
STEM1 = ("stem.0.", "stem.1.")
JAX_STEM1 = "['adapter']['spm']['stem1']"
INTR = np.array([[1.24, 0, 0.5], [0, 1.24, 0.5], [0, 0, 1]], np.float32)


def _close(port, ref, rtol=RTOL, atol=ATOL, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol, err_msg=what)


def _randomise(model, rng):
    """Scale the class predictor up and randomise the BatchNorm statistics,
    so that the post-process keeps queries and the BatchNorms do real work."""
    with torch.no_grad():
        model.mask2former.class_predictor.weight.mul_(8.0)
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.from_numpy(rng.standard_normal(mod.num_features).astype(np.float32) * 0.1))
                mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, mod.num_features).astype(np.float32)))


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_model_cfg(num_views=V)
    pipe = Pipeline(RootCfg(pipeline=PipelineCfg(model=port_cfg(jcfg))), device="cpu", seed=0)
    rng = np.random.RandomState(0)
    _randomise(pipe.model, rng)
    variables = convert_siu3r_state_dict(port_state_numpy(pipe.model), jcfg)
    images = rng.rand(1, 4, H, W, 3).astype(np.float32)
    intr = np.tile(INTR, (1, 4, 1, 1))
    return jcfg, pipe, variables, images, intr


@pytest.fixture(scope="module")
def eval_run(tiny):
    """The eval step (the forward with the query-class lift, then the render
    of N_TARGET views) on both sides."""
    jcfg, pipe, variables, images, intr = tiny
    rng = np.random.RandomState(1)
    ext = np.tile(np.eye(4, dtype=np.float32), (1, N_TARGET, 1, 1))
    # the random-init Gaussians sit within ~0.1 of the origin: the targets
    # look at them from 0.15 behind, past the near plane of the 10x rescale
    ext[..., :3, 3] = rng.uniform(-0.02, 0.02, (1, N_TARGET, 3)) + np.array([0.0, 0.0, -0.15], np.float32)
    batch = {
        "context_views_images": images[:, :V],
        "context_views_intrinsics": intr[:, :V],
        "target_views_extrinsics": ext,
        "target_views_intrinsics": np.tile(INTR, (1, N_TARGET, 1, 1)),
    }
    jpipe = JaxPipeline(JaxRootCfg(pipeline=JaxPipelineCfg(model=jcfg)), lpips_enabled=False)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"], opt_state=None, step=None)
    ref = jax.jit(jpipe.eval_step)(state, {k: jnp.asarray(x) for k, x in batch.items()})
    out = pipe.eval_step({k: torch.from_numpy(x) for k, x in batch.items()})
    return out, ref


@pytest.mark.parametrize("v", [3, 4])
def test_multi_backbone_matches_jax(tiny, v):
    jcfg, pipe, variables, images, intr = tiny
    ref = jax.jit(JaxMultiBackbone(jcfg.croco).apply)(
        {"params": variables["params"]["backbone"]}, images[:, :v], intr[:, :v])
    with torch.inference_mode():
        out = pipe.model.backbone(torch.from_numpy(images[:, :v]), torch.from_numpy(intr[:, :v]))
    assert out.feat.shape == (1, v, (H // 16) * (W // 16), jcfg.croco.enc_embed_dim)
    _close(out.feat, ref.feat, what="feat")
    assert len(out.all_feat) == len(ref.all_feat) == jcfg.croco.enc_depth
    for i, (a, b) in enumerate(zip(out.all_feat, ref.all_feat)):
        _close(a, b, what=f"all_feat[{i}]")
    assert len(out.dec_feat) == len(ref.dec_feat) == jcfg.croco.dec_depth + 1
    for i, (a, b) in enumerate(zip(out.dec_feat, ref.dec_feat)):
        _close(a, b, what=f"dec_feat[{i}]")


def test_multi_backbone_at_two_views_is_the_two_view_backbone(tiny):
    jcfg, pipe, _, images, intr = tiny
    two = AsymmetricCroCo(pipe.model.backbone.cfg)
    two.load_state_dict(pipe.model.backbone.state_dict())
    x, k = torch.from_numpy(images[:, :2]), torch.from_numpy(intr[:, :2])
    with torch.inference_mode():
        multi = pipe.model.backbone(x, k)
        ref = two(x, k)
    close = lambda a, b, what: _close(a, b.numpy(), rtol=1e-5, atol=1e-5, what=what)
    close(multi.feat[:, 0], ref.feat1, "feat view 0")
    close(multi.feat[:, 1], ref.feat2, "feat view 1")
    for i in range(jcfg.croco.enc_depth):
        close(multi.all_feat[i][:, 0], ref.all_feat1[i], f"all_feat[{i}] view 0")
        close(multi.all_feat[i][:, 1], ref.all_feat2[i], f"all_feat[{i}] view 1")
    for i in range(jcfg.croco.dec_depth + 1):
        close(multi.dec_feat[i][:, 0], ref.dec1[i], f"dec[{i}] view 0")
        close(multi.dec_feat[i][:, 1], ref.dec2[i], f"dec[{i}] view 1")


def test_forward_matches_jax(eval_run):
    (out, _, _), (jout, _, _) = eval_run
    g, jg = out.gaussians, jout.gaussians
    assert g.means.shape == (1, V * H * W, 3)
    assert out.pts3d.shape == (1, V, H, W, 3)
    assert out.seg.masks_queries_logits.shape[2] == V
    for f in ("means", "covariances", "harmonics", "opacities", "scales", "rotations",
              "seg_query_class_logits", "seg_query_scores"):
        _close(getattr(g, f), getattr(jg, f), what=f)
    _close(out.pts3d, jout.pts3d, what="pts3d")
    _close(out.seg.class_queries_logits, jout.seg.class_queries_logits, what="class logits")
    _close(out.seg.masks_queries_logits, jout.seg.masks_queries_logits, what="mask logits")
    for f in ("semantic_labels", "instance_labels"):
        agree = (getattr(g, f).numpy() == np.asarray(getattr(jg, f))).mean()
        assert agree >= 0.999, (f, agree)
    assert int((g.semantic_labels > 0).sum()) > 0  # some Gaussians are labelled


def test_views_past_the_first_share_head_2(tiny):
    """Views 1..V-1 take the same decoder and heads, and the bank is
    symmetric in them: swapping views 1 and 2 swaps their points."""
    _, pipe, _, images, intr = tiny
    x, k = torch.from_numpy(images[:, :V]), torch.from_numpy(intr[:, :V])
    perm = [0, 2, 1]
    with torch.inference_mode():
        out = pipe.model(x, k)
        out_p = pipe.model(x[:, perm], k[:, perm])
    _close(out_p.pts3d[:, 1], out.pts3d[:, 2].numpy(), rtol=0, atol=1e-4, what="view 1 of the swap")
    _close(out_p.pts3d[:, 2], out.pts3d[:, 1].numpy(), rtol=0, atol=1e-4, what="view 2 of the swap")
    _close(out_p.pts3d[:, 0], out.pts3d[:, 0].numpy(), rtol=0, atol=1e-4, what="view 0")


def test_eval_step_matches_jax(eval_run):
    (_, render, qc), (_, jrender, jqc) = eval_run
    assert render.color.shape == (1, N_TARGET, H, W, 3)
    assert qc.shape == jqc.shape == (1, N_TARGET, 4, 6, H, W)
    assert float(render.alpha.mean()) > 0.02  # the views see the scene
    _close(render.color, jrender.color, 1e-3, 1e-3, "color")
    _close(render.alpha, jrender.alpha, 1e-3, 1e-3, "alpha")
    _close(render.depth, jrender.depth, 1e-3, 1e-2, "depth")
    _close(qc, jqc, 1e-3, 1e-3, "qc")


# ---------------------------------------------------------------- train step


@pytest.fixture(scope="module")
def train_run():
    jcfg = tiny_root_cfg()
    jcfg.pipeline.model.num_views = V
    cfg = port_config._from_dict(port_config.RootCfg, dataclasses.asdict(jcfg))
    pipe = _port_pipeline(cfg)
    variables = convert_siu3r_state_dict(port_state_numpy(pipe.model), jcfg.pipeline.model)
    jlpips = jax_lpips.init_lpips_params(None)
    pipe.lpips_params = lpips_params_from_jax(jax.tree.map(np.asarray, jlpips))
    batch = {k: np.asarray(x).copy() for k, x in fake_batch(b=1, v=V, n_tgt=V + 2, seed=3).items()}
    ext = batch["target_views_extrinsics"]
    ext[..., :3, 3] = np.array([0.006, 0.04, -0.2], np.float32) + np.random.RandomState(3).uniform(
        -0.01, 0.01, ext[..., :3, 3].shape).astype(np.float32)
    injected = _injected(jcfg, batch)
    loss_fn = _jax_loss_fn(jcfg, jlpips, batch, injected)
    (_, (_, jlosses, jalpha)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])

    # the adapter's SPM: its input and the cotangents of its outputs, kept
    # for the float64 recomputation of the stem's gradients
    spm, spm_io = pipe.model.adapter.spm, {}

    def keep(mod, inputs, outputs):
        spm_io["x"], spm_io["out"] = inputs[0].detach(), outputs
        for o in outputs:
            o.retain_grad()

    spm64 = copy.deepcopy(spm).double().train()  # the step's batch statistics
    handle = spm.register_forward_hook(keep)
    _, losses = pipe.loss_fn({k: torch.from_numpy(x) for k, x in batch.items()}, None,
                             injected_coords=[{k: torch.from_numpy(x) for k, x in d.items()} for d in injected])
    losses["total"].backward()
    handle.remove()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in pipe.model.named_parameters()}
    after = {k: x.numpy() for k, x in pipe.model.state_dict().items()}
    port_grads = convert_siu3r_state_dict({**after, **grads}, jcfg.pipeline.model)["params"]
    stem1 = {n: p for n, p in spm64.named_parameters() if n.startswith(STEM1)}
    stem1_f64 = torch.autograd.grad(spm64(spm_io["x"].double()), list(stem1.values()),
                                    [o.grad.double() for o in spm_io["out"]])
    stem1_f64 = {n: (dict(spm.named_parameters())[n].grad.double(), g) for n, g in zip(stem1, stem1_f64)}
    return dict(batch=batch, jlosses=jlosses, jgrads=jgrads, jalpha=jalpha, losses=losses, port_grads=port_grads,
                stem1_f64=stem1_f64)


def test_train_loss_terms_match_jax(train_run):
    r = train_run
    # the context views are not the first V targets: the depth smoothness
    # finds them by id
    assert list(r["batch"]["context_views_id"][0]) != list(r["batch"]["target_views_id"][0, :V])
    assert float(np.asarray(r["jalpha"]).mean()) > 0.05  # the target views see the scene's splats
    assert r["losses"].keys() == r["jlosses"].keys()
    for key, ref in r["jlosses"].items():
        np.testing.assert_allclose(float(r["losses"][key].detach()), float(ref), rtol=1e-3, atol=1e-5, err_msg=key)
    assert float(r["jlosses"]["depth_smoothness"]) > 0 and float(r["jlosses"]["lpips"]) > 0


def test_train_gradients_match_jax(train_run):
    r = train_run
    ref = dict(jax.tree_util.tree_leaves_with_path(r["jgrads"]))
    got = dict(jax.tree_util.tree_leaves_with_path(r["port_grads"]))
    global_norm = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64)))) for g in ref.values()))
    checked = 0
    for path, g in ref.items():
        g = np.asarray(g, np.float64)
        norm = np.linalg.norm(g)
        if norm <= 1e-6 * global_norm or jax.tree_util.keystr(path).startswith(JAX_STEM1):
            continue
        err = np.linalg.norm(np.asarray(got[path], np.float64) - g) / norm
        assert err <= 2e-3, (jax.tree_util.keystr(path), err)
        checked += 1
    assert checked > 0.9 * len(ref)
    # the stem's gradients against the float64 recomputation (module docstring)
    assert len(r["stem1_f64"]) == 3
    for name, (port, exact) in r["stem1_f64"].items():
        err = float((port - exact).norm() / exact.norm())
        assert err <= 2e-3, (name, err)
    # the shared decoder of views 1..V-1 and head 2 are trained
    for key in ("dec_blocks", "gaussian_param_head2", "downstream_head2"):
        assert any(key in jax.tree_util.keystr(p) for p in ref), key


# ---------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("views")
    rng = np.random.RandomState(5)
    for i in range(V):
        Image.fromarray((rng.rand(240, 320, 3) * 255).astype(np.uint8)).save(path / f"view{i}.png")
    (path / "notes.txt").write_text("not an image")
    return path


def test_inference_multiview_cli_writes_the_reference_ply(image_dir, tmp_path, monkeypatch):
    """The CLI at the tiny widths (its `model_cfg` swapped) on 3 images at
    its 256x256 crop: output.ply holds 3 x 256 x 256 vertices, equal to what
    the JAX package's exporter writes for the same model's Gaussians."""
    tiny_cfg = lambda num_views: port_cfg(tiny_model_cfg(num_views=num_views))
    monkeypatch.setattr(inference_multiview, "model_cfg", tiny_cfg)
    path = inference_multiview.main(["--image_dir", str(image_dir), "--output_path", str(tmp_path / "out"),
                                     "--device", "cpu"])
    ply = jax_read_ply(path)
    assert len(ply["x"]) == V * 256 * 256

    paths = sorted(image_dir.glob("*.png"))
    images = torch.from_numpy(np.stack([inference.preprocess_image(p) for p in paths])[None])
    intr = torch.tensor([[318 / 256, 0, 0.5], [0, 318 / 256, 0.5], [0, 0, 1]]).expand(1, V, 3, 3)
    model = build_model(tiny_cfg(V), device="cpu", seed=0)
    with torch.inference_mode():
        g = model(images, intr, enable_query_class_logit_lift=True).gaussians.to_host()
    jax_export_ply(means=g.means[0], scales=g.scales[0], rotations=g.rotations[0], harmonics=g.harmonics[0],
                   opacities=g.opacities[0], semantic_labels=g.semantic_labels[0],
                   instance_labels=g.instance_labels[0], seg_query_class_logits=g.seg_query_class_logits[0],
                   path=tmp_path / "ref.ply", save_sh_dc_only=False)
    ref = jax_read_ply(tmp_path / "ref.ply")
    assert list(ply) == list(ref)
    for name, col in ref.items():
        np.testing.assert_allclose(ply[name], col, rtol=1e-6, atol=1e-6, err_msg=name)


def test_multiview_entry_points_need_a_gpu_unless_told(image_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_cfg(tiny_model_cfg(num_views=V))
    with pytest.raises(RuntimeError, match="CUDA"):
        SIU3RModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        inference_multiview.main(["--image_dir", str(image_dir)])
    assert next(SIU3RModel(cfg, device="cpu").parameters()).device.type == "cpu"
