"""siu3r_tpu_torch's refer path (text-referred segmentation) against the JAX
package: Mask2Former's language layers, ``seg_forward``, the forward with
text tokens, the post-process's word filter, the word-match loss, the refer
eval and train steps, the weights, and ``cli/validate_refer``.

Config: the tiny refer config of tests/test_refer.py (tests/test_train.py's
tiny config at 32x32 with ``train_refer_segmentation`` and a 64-token
vocabulary), B = 2, 3 referring expressions of 5 tokens (some padded). The
port is built with a seeded random init on the CPU (the class predictor
scaled up and the BatchNorm statistics randomised, so that queries are kept
and the BatchNorms do real work) and its ``state_dict`` goes through
``siu3r_tpu.checkpoint.convert_siu3r_state_dict`` into JAX; the converter
has no text embedding (the reference ships none), so it is carried by hand.
Inputs are made from a seed with numpy.

Tolerances: floats rtol 1e-3 / atol 1e-4, the class logits atol 8e-4 (the
class predictor's weights are scaled by 8, and so is the rounding error of
the hidden state it reads, 1e-5 to 5e-5 here); labels and eval masks equal on
>= 99.9% of pixels; the post-process's word filter exact; the word-match
loss rtol 1e-5; the train step's loss rtol 1e-3 and each gradient within a
relative L2 error of 2e-3 (tests/test_torch_train_step.py), the BatchNorm
statistics rtol 1e-4 / atol 1e-6, and the parameters after one AdamW step:
where the gradient is zero (the DPT and Gaussian heads, which the refer loss
does not reach, and which both sides decay) rtol 1e-6; where the gradient
is held (above 1e-6 of the global norm) each tensor's update within a
relative L2 error of 2e-2 of the JAX update. The first AdamW step moves
each element by about lr x sign(gradient), so a tensor whose gradient is
rounding noise (a key projection's bias, to which the softmax is blind)
moves either way on either side, and is not compared (neither is one that
JAX computes as exactly 0 and the port as noise, a GroupNorm scale over a
1x1 map).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from siu3r_tpu.checkpoint import convert_siu3r_state_dict
from siu3r_tpu.eval.metrics import referred_mask_iou as jax_referred_mask_iou
from siu3r_tpu.models.mask2former import VideoMask2Former as JaxMask2Former
from siu3r_tpu.models.mask2former.postprocess import panoptic_segmentation as jax_panoptic
from siu3r_tpu.models.model import SIU3RModel as JaxModel
from siu3r_tpu.pipeline import Pipeline as JaxPipeline
from siu3r_tpu.pipeline import TrainState
from siu3r_tpu.train.losses import refer_word_match_loss as jax_word_match
from siu3r_tpu.train.optimizer import _group_of as jax_group_of
from siu3r_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch.cli import validate_refer
from siu3r_tpu_torch.models.mask2former.postprocess import panoptic_segmentation
from siu3r_tpu_torch.models.model import build_model
from siu3r_tpu_torch.pipeline import Pipeline
from siu3r_tpu_torch.train.losses import refer_word_match_loss
from siu3r_tpu_torch.weights import load_checkpoint, state_dict_from_jax
from test_cli_smoke import TINY_OVERRIDES
from test_refer import fake_refer_root, refer_batch, refer_cfg  # noqa: F401  (fixture)
from test_torch_weights import port_state_numpy

RTOL, ATOL = 1e-3, 1e-4
CLASS_SCALE = 8.0
CLASS_ATOL = CLASS_SCALE * ATOL
AGREEMENT = 0.999
GRAD_REL_L2 = 2e-3
UPDATE_REL_L2 = 2e-2


def _close(port, ref, rtol=RTOL, atol=ATOL, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol, err_msg=what)


def _agree(port, ref) -> float:
    return float((port.numpy() == np.asarray(ref)).mean())


def _randomise(model, rng):
    with torch.no_grad():
        model.mask2former.class_predictor.weight.mul_(CLASS_SCALE)
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.from_numpy(rng.standard_normal(mod.num_features).astype(np.float32) * 0.1))
                mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, mod.num_features).astype(np.float32)))


def _carry(model, jcfg_model):
    """The port's weights as JAX variables, the text embedding included."""
    state = port_state_numpy(model)
    variables = convert_siu3r_state_dict(state, jcfg_model)
    variables["params"]["text_embed"] = {"embedding": state["text_embed.weight"]}
    return variables


def _setup(num_views):
    jcfg = refer_cfg()
    jcfg.pipeline.model.num_views = num_views
    cfg = port_config._from_dict(port_config.RootCfg, dataclasses.asdict(jcfg))
    pipe = Pipeline(cfg, device="cpu", seed=0).init_train(steps_per_epoch=10, lpips_enabled=False)
    _randomise(pipe.model, np.random.RandomState(num_views))
    batch = {k: np.asarray(x).copy() for k, x in refer_batch(v=num_views, seed=num_views).items()}
    batch["text_token"][0, 1, 2:] = 0  # padded expressions: the mean runs over the real tokens
    batch["text_token"][1, 2, 1:] = 0
    return jcfg, pipe, _carry(pipe.model, jcfg.pipeline.model), batch


@pytest.fixture(scope="module")
def tiny():
    return _setup(2)


@pytest.fixture(scope="module")
def tiny3():
    return _setup(3)


def _t(batch):
    return {k: torch.from_numpy(x) for k, x in batch.items()}


def _j(batch):
    return {k: jnp.asarray(x) for k, x in batch.items()}


def test_mask2former_with_words_matches_jax(tiny):
    jcfg, pipe, variables, _ = tiny
    m2f = jcfg.pipeline.model.mask2former
    rng = np.random.RandomState(3)
    c = jcfg.pipeline.model.croco.enc_embed_dim
    feats = [rng.randn(2, 2, 8 // s, 8 // s, c).astype(np.float32) * 0.5 for s in (1, 2, 4, 8)]
    words = rng.randn(2, 5, m2f.hidden_dim).astype(np.float32)
    ref = jax.jit(JaxMask2Former(m2f).apply)({"params": variables["params"]["mask2former"]},
                                             [jnp.asarray(f) for f in feats], word_embeddings=jnp.asarray(words))
    with torch.no_grad():
        out = pipe.model.mask2former([torch.from_numpy(f) for f in feats], word_embeddings=torch.from_numpy(words))
        plain = pipe.model.mask2former([torch.from_numpy(f) for f in feats])
    assert out.word_logits.shape == (2, 5, m2f.num_queries) and plain.word_logits is None
    _close(out.class_queries_logits, ref.class_queries_logits, atol=CLASS_ATOL, what="class logits")
    _close(out.masks_queries_logits, ref.masks_queries_logits, what="mask logits")
    _close(out.last_hidden_state, ref.last_hidden_state, what="last hidden state")
    _close(out.word_logits, ref.word_logits, what="word logits")
    # the words reach only the language layers
    _close(plain.masks_queries_logits, out.masks_queries_logits.numpy(), rtol=0, atol=0, what="decoder untouched")
    no_lang = port_config._from_dict(port_config.Mask2formerCfg, dataclasses.asdict(m2f))
    no_lang.train_refer_segmentation = False
    model = type(pipe.model.mask2former)(no_lang, in_channels=c)
    assert not any("lang" in n for n, _ in model.named_parameters())
    with pytest.raises(ValueError, match="train_refer_segmentation"):
        model([torch.from_numpy(f) for f in feats], word_embeddings=torch.from_numpy(words))


@pytest.mark.parametrize("views", [2, 3])
def test_seg_forward_matches_jax(tiny, tiny3, views):
    jcfg, pipe, variables, batch = tiny if views == 2 else tiny3
    jb = _j(batch)
    seg_ref, post_ref = jax.jit(lambda v, im, k, tt: JaxModel(jcfg.pipeline.model).apply(
        v, im, k, text_tokens=tt, method=JaxModel.seg_forward))(
        variables, jb["context_views_images"], jb["context_views_intrinsics"], jb["text_token"])
    pipe.model.eval()
    with torch.no_grad():
        seg, post = pipe.model.seg_forward(*(torch.from_numpy(batch[k]) for k in (
            "context_views_images", "context_views_intrinsics")), text_tokens=torch.from_numpy(batch["text_token"]))
    assert seg.masks_queries_logits.shape[2] == views
    assert seg.word_logits.shape == (2, 3, jcfg.pipeline.model.mask2former.num_queries)
    _close(seg.class_queries_logits, seg_ref.class_queries_logits, atol=CLASS_ATOL, what="class logits")
    _close(seg.masks_queries_logits, seg_ref.masks_queries_logits, what="mask logits")
    _close(seg.word_logits, seg_ref.word_logits, what="word logits")
    np.testing.assert_array_equal(post["keep"].numpy(), np.asarray(post_ref["keep"]))
    assert bool(post["keep"].any()) and not bool(post["keep"].all())  # the words filter the kept queries
    assert _agree(post["segmentation"], post_ref["segmentation"]) >= AGREEMENT
    assert _agree(post["semantic"], post_ref["semantic"]) >= AGREEMENT


def test_forward_with_text_tokens_matches_jax(tiny):
    jcfg, pipe, variables, batch = tiny
    jb = _j(batch)
    ref = jax.jit(lambda v, im, k, tt: JaxModel(jcfg.pipeline.model).apply(v, im, k, text_tokens=tt))(
        variables, jb["context_views_images"], jb["context_views_intrinsics"], jb["text_token"])
    pipe.model.eval()
    with torch.no_grad():
        out = pipe.model(*(torch.from_numpy(batch[k]) for k in ("context_views_images", "context_views_intrinsics")),
                         text_tokens=torch.from_numpy(batch["text_token"]))
        words = pipe.model._embed_text(torch.from_numpy(batch["text_token"]))
        by_words = pipe.model(*(torch.from_numpy(batch[k]) for k in ("context_views_images",
                                                                     "context_views_intrinsics")),
                              word_embeddings=words)
    _close(out.seg.word_logits, ref.seg.word_logits, what="word logits")
    np.testing.assert_array_equal(out.post["keep"].numpy(), np.asarray(ref.post["keep"]))
    assert _agree(out.post["segmentation"], ref.post["segmentation"]) >= AGREEMENT
    assert _agree(out.gaussians.instance_labels, ref.gaussians.instance_labels) >= AGREEMENT
    _close(out.gaussians.means, ref.gaussians.means, what="means")
    np.testing.assert_array_equal(by_words.post["segmentation"].numpy(), out.post["segmentation"].numpy())
    # the masked mean over the tokens, 0 the padding
    emb = pipe.model.text_embed.weight.detach().numpy()
    tok = batch["text_token"][0, 1]
    np.testing.assert_allclose(words[0, 1].numpy(), emb[tok[tok > 0]].mean(0), rtol=1e-6, atol=1e-6)


def test_panoptic_word_filter_matches_jax_exactly():
    """Random logits with tied word argmaxes: the first maximal query wins on
    both sides, and every output equals the JAX package's."""
    rng = np.random.RandomState(4)
    b, q, v, n_labels = 2, 8, 2, 5
    class_logits = (rng.randn(b, q, n_labels + 1) * 4).astype(np.float32)
    mask_logits = rng.randn(b, q, v, 8, 8).astype(np.float32) * 3
    word_logits = rng.randint(0, 3, (b, 6, q)).astype(np.float32)  # many ties
    kw = dict(target_size=(32, 32), label_ids_to_fuse=(0, 1), num_labels=n_labels, max_lift_queries=4)
    ref = jax_panoptic(jnp.asarray(class_logits), jnp.asarray(mask_logits), word_logits=jnp.asarray(word_logits), **kw)
    got = panoptic_segmentation(torch.from_numpy(class_logits), torch.from_numpy(mask_logits),
                                word_logits=torch.from_numpy(word_logits), **kw)
    unfiltered = panoptic_segmentation(torch.from_numpy(class_logits), torch.from_numpy(mask_logits), **kw)
    referred = np.zeros((b, q), bool)
    for i in range(b):
        referred[i, word_logits[i].argmax(-1)] = True
    np.testing.assert_array_equal(got["keep"].numpy(), unfiltered["keep"].numpy() & referred)
    assert got["keep"].sum() < unfiltered["keep"].sum()
    assert got.keys() == ref.keys()
    for key, want in ref.items():
        want = np.asarray(want)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got[key].numpy(), want, rtol=1e-6, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key].numpy(), want, err_msg=key)


def test_refer_word_match_loss_matches_jax():
    rng = np.random.RandomState(5)
    b, w, q, o = 4, 4, 6, 5
    logits = rng.randn(b, w, q).astype(np.float32) * 2
    assignment = rng.randint(0, q, (b, o)).astype(np.int32)
    assignment[0, 1] = -1  # the auction left it unassigned
    assignment[2, :] = -1  # an item with no word left
    valid = rng.rand(b, o) > 0.3
    valid[1, :] = True
    ref = float(jax_word_match(jnp.asarray(logits), jnp.asarray(assignment), jnp.asarray(valid)))
    got = refer_word_match_loss(torch.from_numpy(logits), torch.from_numpy(assignment), torch.from_numpy(valid))
    np.testing.assert_allclose(float(got), ref, rtol=1e-5)
    # item 1 (every word valid and assigned) alone is torch's cross-entropy
    one = refer_word_match_loss(torch.from_numpy(logits[1:2]), torch.from_numpy(assignment[1:2]),
                                torch.from_numpy(valid[1:2]))
    ce = torch.nn.functional.cross_entropy(torch.from_numpy(logits[1]), torch.from_numpy(assignment[1, :w]).long())
    np.testing.assert_allclose(float(one), float(ce), rtol=1e-5)


def test_refer_eval_step_matches_jax(tiny):
    jcfg, pipe, variables, batch = tiny
    jpipe = JaxPipeline(jcfg, lpips_enabled=False)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"], opt_state=None, step=None)
    ref_masks, ref_logits = jax.jit(jpipe.refer_eval_step)(state, _j(batch))
    masks, logits = pipe.refer_eval_step(_t(batch))
    assert masks.shape == (2, 3, 2, 32, 32) and masks.dtype == torch.bool
    _close(logits, ref_logits, what="word logits")
    assert _agree(masks, ref_masks) >= AGREEMENT
    assert 0.0 < float(masks.float().mean()) < 1.0


# ---------------------------------------------------------------- train step


@pytest.fixture(scope="module")
def train_run():
    """One refer train step on both sides from the same weights. JAX: the
    gradient of ``Pipeline.refer_loss_fn`` (the matcher's points drawn from
    its key), then ``make_optimizer``'s update, which is ``Pipeline.train_step``.
    The port: ``refer_loss_fn`` with those points injected, its gradient,
    then ``AdamW3.step``."""
    jcfg, pipe, variables, batch = _setup(2)
    m2f = jcfg.pipeline.model.mask2former
    jpipe = JaxPipeline(jcfg, steps_per_epoch=10, lpips_enabled=False)
    key = jax.random.PRNGKey(1)
    params = variables["params"]
    (_, (jstats, jlosses)), jgrads = jax.jit(jax.value_and_grad(jpipe.refer_loss_fn, has_aux=True))(
        params, variables["batch_stats"], _j(batch), key)
    tx = jax_make_optimizer(params, jcfg.optimizer, jcfg.trainer, steps_per_epoch=10, freeze_encoder=True)
    updates, _ = jax.jit(tx.update)(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)
    coords = np.stack([np.asarray(jax.random.uniform(k, (m2f.train_num_points, 2)))
                       for k in jax.random.split(key, batch["gt_valid"].shape[0])])

    before = {k: v.copy() for k, v in port_state_numpy(pipe.model).items()}  # the step updates in place
    for p in pipe.model.parameters():
        p.grad = None
    _, losses = pipe.refer_loss_fn(_t(batch), None, injected_coords=torch.from_numpy(coords))
    losses["total"].backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
             for k, p in pipe.model.named_parameters()}
    stats = convert_siu3r_state_dict(port_state_numpy(pipe.model), jcfg.pipeline.model)["batch_stats"]
    pipe.optimizer.step()
    after = port_state_numpy(pipe.model)

    def tree(state):
        out = _carry_state(state, jcfg)
        return dict(jax.tree_util.tree_leaves_with_path(out))

    return dict(jlosses=jlosses, losses=losses, jgrads=dict(jax.tree_util.tree_leaves_with_path(jgrads)),
                grads=tree({**before, **grads}), jstats=dict(jax.tree_util.tree_leaves_with_path(jstats)),
                stats=dict(jax.tree_util.tree_leaves_with_path(stats)), before=tree(before), after=tree(after),
                jnew=dict(jax.tree_util.tree_leaves_with_path(jnew)), pipe=pipe)


def _carry_state(state, jcfg):
    params = convert_siu3r_state_dict(state, jcfg.pipeline.model)["params"]
    params["text_embed"] = {"embedding": state["text_embed.weight"]}
    return params


def test_refer_train_loss_and_gradients_match_jax(train_run):
    r = train_run
    assert r["losses"].keys() == r["jlosses"].keys() == {"word_match", "total"}
    for key, ref in r["jlosses"].items():
        np.testing.assert_allclose(float(r["losses"][key].detach()), float(ref), rtol=RTOL, err_msg=key)
    assert float(r["jlosses"]["word_match"]) > 0
    global_norm = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64)))) for g in r["jgrads"].values()))
    checked = set()
    for path, g in r["jgrads"].items():
        g = np.asarray(g, np.float64)
        norm = np.linalg.norm(g)
        if norm <= 1e-6 * global_norm:
            continue
        err = np.linalg.norm(np.asarray(r["grads"][path], np.float64) - g) / norm
        assert err <= GRAD_REL_L2, (jax.tree_util.keystr(path), err)
        checked.add(jax.tree_util.keystr(path))
    # the gradient reaches the text embedding, every language layer, the
    # decoder, the adapter and the encoder (frozen, its gradient counted by
    # the clip); not the backbone's decoder or the heads, which only the
    # Gaussians read
    for part in ("['text_embed']", *(f"['lang_{n}_{i}']" for n in ("cross_attns", "fc1s", "fc2s") for i in range(6)),
                 "['transformer_module']", "['adapter']", "['enc_blocks']"):
        assert any(part in p for p in checked), part
    assert not any("head" in p or "dec_blocks" in p for p in checked)
    for path, s in r["jstats"].items():
        _close(r["stats"][path], s, rtol=1e-4, atol=1e-6, what=jax.tree_util.keystr(path))


def test_refer_train_step_update_matches_jax(train_run):
    r = train_run
    decayed = moved = 0
    global_norm = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64)))) for g in r["jgrads"].values()))
    for path, ref in r["jnew"].items():
        name = jax.tree_util.keystr(path)
        ref, old, got = np.asarray(ref, np.float64), np.asarray(r["before"][path], np.float64), r["after"][path]
        if jax_group_of(path, True) == "frozen":
            assert (ref == old).all() and (got == old).all(), name
            continue
        if not np.asarray(r["jgrads"][path]).any() and not r["grads"][path].any():
            # the refer loss does not reach it (the heads): AdamW decays it
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9, err_msg=name)
            decayed += "head" in name and bool((ref != old).any())
            continue
        if np.linalg.norm(np.asarray(r["jgrads"][path], np.float64)) <= 1e-6 * global_norm:
            continue  # rounding noise (a key bias under the softmax): its sign, so its update, is arbitrary
        upd = ref - old
        err = np.linalg.norm(np.asarray(got, np.float64) - old - upd) / np.linalg.norm(upd)
        assert err <= UPDATE_REL_L2, (name, err)
        moved += 1
    assert decayed >= 4 and moved > 50  # the DPT and Gaussian heads decay; the rest moves


def test_refer_optimizer_groups(train_run):
    opt = train_run["pipe"].optimizer
    names = {n: g for g, ns in opt.groups.items() for n in ns}
    assert names["text_embed.weight"] == "low"  # the base learning rate, x0.1
    langs = [n for n in names if n.startswith("mask2former.lang_")]
    assert len(langs) == 6 * 12 and all(names[n] == "high" for n in langs)  # x3, with Mask2Former
    assert jax_group_of(("text_embed", "embedding"), True) == "low"
    assert jax_group_of(("mask2former", "lang_fc1s_0", "kernel"), True) == "high"


# ---------------------------------------------------------------- weights and CLI


def test_refer_weights_carry_both_ways(tiny, tmp_path):
    jcfg, pipe, variables, batch = tiny
    shapes = jax.eval_shape(JaxModel(jcfg.pipeline.model).init, jax.random.PRNGKey(0),
                            *(jnp.asarray(batch[k]) for k in ("context_views_images", "context_views_intrinsics")),
                            text_tokens=jnp.asarray(batch["text_token"]))
    want = {jax.tree_util.keystr(p): leaf.shape for p, leaf in jax.tree_util.tree_leaves_with_path(shapes["params"])}
    got = {jax.tree_util.keystr(p): leaf.shape for p, leaf in jax.tree_util.tree_leaves_with_path(variables["params"])}
    assert got == want
    assert sum("lang_" in k for k in want) == 6 * 16 and "['text_embed']['embedding']" in want
    # and back: the JAX variables give the port's state dict exactly
    state = state_dict_from_jax(jax.tree.map(np.asarray, variables), pipe.model.cfg)
    own = port_state_numpy(pipe.model)
    assert state.keys() == own.keys()
    for k, v in state.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), own[k], err_msg=k)
    # a Lightning-layout refer checkpoint loads by name
    torch.save({"state_dict": {f"model.{k}": torch.from_numpy(v) for k, v in own.items()}}, tmp_path / "refer.ckpt")
    fresh = build_model(pipe.model.cfg, device="cpu", seed=9)
    assert not torch.equal(fresh.text_embed.weight, pipe.model.text_embed.weight)
    load_checkpoint(fresh, str(tmp_path / "refer.ckpt"))
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), own[k], err_msg=k)


def test_validate_refer_cli_matches_jax(fake_refer_root, tmp_path):  # noqa: F811
    """The CLI at tiny widths on the CPU, with weights from --ckpt, against
    the JAX package's refer eval step and referred_mask_iou over the same
    items with the same weights."""
    overrides = [f"datamodule.dataset_cfg.root={fake_refer_root}", *TINY_OVERRIDES,
                 "pipeline.model.mask2former.train_refer_segmentation=true",
                 "pipeline.model.mask2former.text_vocab_size=64"]
    cfg = port_config.bind_scannet_classes(port_config.load_config(os.devnull, overrides))
    model = build_model(cfg.pipeline.model, device="cpu", seed=4)
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    result = validate_refer.main(["--config", os.devnull, "--ckpt", str(tmp_path / "weights.pt"), "--device", "cpu",
                                  "--limit", "1", *overrides])

    from siu3r_tpu.cli.train import build_dataset as jax_build_dataset
    from siu3r_tpu.config import bind_scannet_classes as jax_bind
    from siu3r_tpu.config import load_config as jax_load_config

    jcfg = jax_bind(jax_load_config(os.devnull, overrides))
    jcfg.datamodule.dataset_cfg.name = "scanrefer"
    jpipe = JaxPipeline(jcfg, lpips_enabled=False)
    variables = _carry(model, jcfg.pipeline.model)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"], opt_state=None, step=None)
    item = jax_build_dataset(jcfg, train=False)[0]
    masks, _ = jax.jit(jpipe.refer_eval_step)(state, {k: jnp.asarray(item[k])[None] for k in (
        "context_views_images", "context_views_intrinsics", "text_token")})
    miou, per_word = jax_referred_mask_iou(np.asarray(masks[0]), item["gt_masks"], item["gt_valid"])
    assert result["num_referred"] == len(per_word) == 2
    np.testing.assert_allclose(result["refer_miou"], miou, rtol=0, atol=1e-3)
    assert result["acc@0.5"] == float(np.mean(per_word > 0.5))
    assert result["acc@0.25"] == float(np.mean(per_word > 0.25))
