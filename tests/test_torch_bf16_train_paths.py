"""The bf16 train step of siu3r_tpu_torch on its two other batch kinds,
against ``jax.value_and_grad`` of the JAX package's bf16 loss, on the CPU:

- three context views (the shared-bank backbone, whose masked bank
  attention takes the plain path in bf16): tests/test_torch_multiview.py's
  train step (tests/test_train.py's tiny config at V = 3, 32x32, 3 context
  views among 5 sorted targets, the loss composed as
  tests/test_torch_train_step.py composes it, injected sample points);
- the refer batch (``refer_loss_fn`` through ``seg_forward``):
  tests/test_torch_refer.py's train step (the tiny refer config, B = 2,
  three expressions, some padded; JAX's ``Pipeline.refer_loss_fn`` draws
  the matcher's points from its key and the port takes the same points).

The model computes in bf16 on both sides from the same fp32 weights; the
JAX loss is compiled with XLA's excess precision off. The rules, the
yardstick (the port's fp32 step, which those files hold to the JAX
package's fp32 step) and the groups are those of
tests/test_torch_bf16_train.py, at its bounds but for two. Measured:
- three views: median 0.114, 10 tensors left out, the loss terms within
  the relative bound; the groups at most 0.913 (the pixel decoder) but the
  three behind the train-mode BatchNorms of the adapter's 1/4 and 1/8
  levels, whose input gradient over three 8x8 and 4x4 maps is a difference
  of nearly cancelling terms (tests/test_torch_multiview.py meets the same
  in fp32 at the stem): ``adapter/up`` 1.356, ``norm1`` 1.223, ``norm2``
  1.132, held at MULTI_GROUP_MAX; statistics median 0.240, worst 0.357;
- refer: the word-match loss reaches the backbone and the adapter only
  through Mask2Former's queries, and REFER_NOISE_MAX tensors' bf16-vs-fp32
  gap exceeds half their norm (33 of 313); median 0.057, worst group 0.270;
  statistics median 0.221, worst 0.393.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siu3r_tpu.checkpoint import convert_siu3r_state_dict
from siu3r_tpu.pipeline import Pipeline as JaxPipeline
from siu3r_tpu_torch.pipeline import Pipeline
from test_refer import refer_batch, refer_cfg
from test_torch_bf16 import _strict
from test_torch_bf16_train import (
    GROUP_MAX,
    MEDIAN_MAX,
    NOISE_MAX,
    bf16_cfgs,
    check_loss_terms,
    check_rules,
    flat,
    fp32_yardstick,
    port_grads_tree,
    port_step,
)
from test_torch_refer import _randomise as refer_randomise
from test_torch_train_cli import two_torch_threads  # noqa: F401  (fixture)
from test_torch_train_step import _injected, _jax_loss_fn, _port_pipeline
from test_train import fake_batch

V = 3
MULTI_GROUP_MAX = 1.5
REFER_NOISE_MAX = 33


def _copy_state(pipe):
    return {k: v.clone() for k, v in pipe.model.state_dict().items()}


# ---------------------------------------------------------------- three views


@pytest.fixture(scope="module")
def multi_run():
    jcfg, cfg = bf16_cfgs(num_views=V)
    pipe = _port_pipeline(cfg)
    state = _copy_state(pipe)
    variables = convert_siu3r_state_dict({k: v.numpy().copy() for k, v in state.items()}, jcfg.pipeline.model)
    pipe.lpips_params = None  # the two-view step holds LPIPS in bf16; here it would only add compile time
    batch = {k: np.asarray(x).copy() for k, x in fake_batch(b=1, v=V, n_tgt=V + 2, seed=3).items()}
    ext = batch["target_views_extrinsics"]
    ext[..., :3, 3] = np.array([0.006, 0.04, -0.2], np.float32) + np.random.RandomState(3).uniform(
        -0.01, 0.01, ext[..., :3, 3].shape).astype(np.float32)
    injected = _injected(jcfg, batch)
    fn = jax.value_and_grad(_jax_loss_fn(jcfg, None, batch, injected, with_assignments=True), has_aux=True)
    (_, (jstats, jlosses, jalpha, jassign)), jgrads = _strict(fn, variables["params"], variables["batch_stats"])
    run = lambda: port_step(pipe, jcfg.pipeline.model, batch, injected)
    losses, grads, stats, assignment = run()
    losses32, grads32, stats32, _ = fp32_yardstick(pipe, state, run)
    return dict(jlosses={k: float(x) for k, x in jlosses.items()}, jgrads=flat(jgrads), jstats=flat(jstats),
                jalpha=float(np.asarray(jalpha).mean()), jassign=np.asarray(jassign), losses=losses, grads=grads,
                stats=stats, assignment=assignment, losses32=losses32, grads32=grads32, stats32=stats32)


def test_multi_view_step_matches_jax_in_bf16(multi_run):
    r = multi_run
    assert r["jalpha"] > 0.05  # the target views see the scene's splats
    np.testing.assert_array_equal(r["assignment"], r["jassign"])
    check_loss_terms(r["losses"], r["jlosses"], r["losses32"])
    _, groups, _ = check_rules(r["grads"], r["jgrads"], r["grads32"], MULTI_GROUP_MAX, MEDIAN_MAX, NOISE_MAX,
                               "3 views")
    # the shared decoder of views 1..V-1 and head 2 are trained and scored
    for part in (("backbone", "dec_blocks"), ("gaussian_param_head2",), ("downstream_head2",)):
        assert part in groups, part
    check_rules(r["stats"], r["jstats"], r["stats32"], GROUP_MAX, MEDIAN_MAX, 0, "3-view statistics")


# ---------------------------------------------------------------- refer


def _carry(state, model_cfg):
    """The port's state as JAX variables, the text embedding carried by hand
    (the converter has none)."""
    variables = convert_siu3r_state_dict(state, model_cfg)
    variables["params"]["text_embed"] = {"embedding": np.asarray(state["text_embed.weight"])}
    return variables


@pytest.fixture(scope="module")
def refer_run():
    jcfg, cfg = bf16_cfgs(base=refer_cfg)
    pipe = Pipeline(cfg, device="cpu", seed=0).init_train(steps_per_epoch=10, lpips_enabled=False)
    refer_randomise(pipe.model, np.random.RandomState(2))
    state = _copy_state(pipe)
    variables = _carry({k: v.numpy().copy() for k, v in state.items()}, jcfg.pipeline.model)
    batch = {k: np.asarray(x).copy() for k, x in refer_batch(v=2, seed=2).items()}
    batch["text_token"][0, 1, 2:] = 0  # padded expressions: the mean runs over the real tokens
    batch["text_token"][1, 2, 1:] = 0
    jpipe = JaxPipeline(jcfg, steps_per_epoch=10, lpips_enabled=False)
    key = jax.random.PRNGKey(1)
    (_, (jstats, jlosses)), jgrads = _strict(jax.value_and_grad(jpipe.refer_loss_fn, has_aux=True),
                                             variables["params"], variables["batch_stats"],
                                             {k: jnp.asarray(x) for k, x in batch.items()}, key)
    m2f = jcfg.pipeline.model.mask2former
    coords = np.stack([np.asarray(jax.random.uniform(k, (m2f.train_num_points, 2)))
                       for k in jax.random.split(key, batch["gt_valid"].shape[0])])

    def run():
        _, losses = pipe.refer_loss_fn({k: torch.from_numpy(x) for k, x in batch.items()}, None,
                                       injected_coords=torch.from_numpy(coords))
        losses["total"].backward()
        grads, stats = port_grads_tree(pipe, jcfg.pipeline.model, convert=_carry)
        return {k: float(x.detach()) for k, x in losses.items()}, grads, stats

    losses, grads, stats = run()
    losses32, grads32, stats32 = fp32_yardstick(pipe, state, run)
    return dict(jlosses={k: float(x) for k, x in jlosses.items()}, jgrads=flat(jgrads), jstats=flat(jstats),
                losses=losses, grads=grads, stats=stats, losses32=losses32, grads32=grads32, stats32=stats32)


def test_refer_step_matches_jax_in_bf16(refer_run):
    r = refer_run
    assert r["losses"].keys() == {"word_match", "total"} and r["jlosses"]["word_match"] > 0
    check_loss_terms(r["losses"], r["jlosses"], r["losses32"])
    _, groups, _ = check_rules(r["grads"], r["jgrads"], r["grads32"], GROUP_MAX, MEDIAN_MAX, REFER_NOISE_MAX,
                               "refer")
    # the gradient reaches the text embedding, the language layers, the
    # adapter and the encoder; the heads and the backbone's decoder, which
    # only the Gaussians read, take none
    for part in (("text_embed", "embedding"), ("mask2former", "lang_cross_attns_0"), ("adapter", "spm"),
                 ("backbone", "enc_blocks")):
        assert part in groups, part
    assert not any("head" in g[0] or g == ("backbone", "dec_blocks") for g in groups)
    check_rules(r["stats"], r["jstats"], r["stats32"], GROUP_MAX, MEDIAN_MAX, 0, "refer statistics")
