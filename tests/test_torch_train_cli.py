"""siu3r_tpu_torch's gradient accumulation and training entry point, on the
CPU at the tiny configs of tests/test_train.py and tests/test_cli_smoke.py.

Tolerances: parameters bitwise unchanged in the middle of an accumulation;
two identical micro-batches at k = 2 against one k = 1 step, atol 1e-6 (the
JAX package's own test, tests/test_train.py:192); the accumulated AdamW
steps against the JAX package's ``optax.MultiSteps`` on the same weights and
gradients, rtol 1e-6 / atol 1e-7 (as the k = 1 optimizer test,
tests/test_torch_train_loss.py); a resumed run against the uninterrupted
one, equal tensors (the same operations on the same inputs on the CPU).
"""

import dataclasses
import json
import os
import shutil
import types

import jax
import numpy as np
import optax
import pytest
import torch

from siu3r_tpu.pipeline import Pipeline as JaxPipeline
from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch.cli import train
from siu3r_tpu_torch.checkpoint_io import restore_train_state
from siu3r_tpu_torch.train.optimizer import AdamW3, MultiSteps
from test_cli_smoke import TINY_OVERRIDES, fake_root  # noqa: F401
from test_torch_train_loss import _grads, _Named, _nested
from test_torch_train_step import _batch, _port_pipeline
from test_train import fake_batch, tiny_root_cfg


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two torch threads for the module. The tier-1 run puts six test
    workers on eight cores; at torch's default of a thread per core their
    OpenMP barriers wait on descheduled threads, and this file took about
    10 times as long there as with two threads under a like load."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(k):
    jcfg = tiny_root_cfg()
    jcfg.trainer.accumulate_grad_batches = k
    return jcfg, port_config._from_dict(port_config.RootCfg, dataclasses.asdict(jcfg))


def _params(pipe):
    return {n: p.detach().clone() for n, p in pipe.model.named_parameters()}


@pytest.fixture(scope="module")
def accumulation():
    """One pipeline at k = 2 takes two micro-steps on the same batch. Then
    the same pipeline, back at its initial weights and BatchNorm statistics
    with a k = 1 optimizer, takes one step on that batch."""
    _, cfg1 = _cfgs(1)
    _, cfg2 = _cfgs(2)
    acc = _port_pipeline(cfg2)
    initial = {k: v.clone() for k, v in acc.model.state_dict().items()}
    batch = {k: torch.from_numpy(v[:1]) for k, v in _batch(1).items()}  # one item: the step's cost halves
    run = {"type": type(acc.optimizer), "before": _params(acc)}
    acc.train_step(batch, torch.Generator().manual_seed(4))
    run["mid"] = _params(acc)
    run["mid_counts"] = (acc.optimizer.count, acc.optimizer.mini_step)
    acc.train_step(batch, torch.Generator().manual_seed(4))
    run["acc"] = _params(acc)
    run["counts"] = (acc.optimizer.count, acc.optimizer.mini_step)
    run["acc_after"] = [float(a.abs().max()) for a in acc.optimizer.acc.values()]
    acc.model.load_state_dict(initial)
    acc.optimizer = AdamW3(acc.model, cfg1.optimizer, cfg1.trainer, steps_per_epoch=10, freeze_encoder=True)
    assert _params(acc).keys() == run["before"].keys()
    acc.train_step(batch, torch.Generator().manual_seed(4))
    run["one"], run["one_count"] = _params(acc), acc.optimizer.count
    run["model"] = acc.model  # for the refusals below
    return run


def test_two_identical_micro_batches_equal_one_step(accumulation):
    run = accumulation
    assert run["type"] is MultiSteps
    for n, p in run["mid"].items():
        assert torch.equal(p, run["before"][n]), n  # nothing moves mid-accumulation, decay included
    assert run["mid_counts"] == (0, 1)
    assert run["counts"] == (1, 0) and run["one_count"] == 1
    moved = 0.0
    for n, p in run["acc"].items():
        np.testing.assert_allclose(p.numpy(), run["one"][n].numpy(), rtol=0, atol=1e-6, err_msg=n)
        moved = max(moved, float((p - run["before"][n]).abs().max()))
    assert moved > 0.0
    assert max(run["acc_after"]) == 0.0  # the mean restarts


def test_accumulation_matches_optax_multisteps():
    """Four micro-steps at k = 2 (two optimizer steps), with large
    frozen-encoder gradients so that the clip is active, against the
    optimizer the JAX package's ``Pipeline.init_state`` builds (its AdamW
    groups wrapped in optax.MultiSteps) on the same weights: linear layers
    under the model's parameter names, one in every group (as the k = 1
    test of tests/test_torch_train_loss.py), the JAX model's init replaced
    by them."""
    jcfg, cfg = _cfgs(2)
    model = _Named()
    named = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in named.items()}
    weights = _nested({n: p.detach().numpy().copy() for n, p in named.items()})
    jpipe = JaxPipeline(jcfg, steps_per_epoch=10, lpips_enabled=False)
    jpipe.model = types.SimpleNamespace(init=lambda rng, images, intr: {"params": weights})
    jstate = jpipe.init_state(jax.random.PRNGKey(0), fake_batch(b=1))
    tx, params, opt_state = jpipe.tx, jstate.params, jstate.opt_state
    assert isinstance(opt_state, optax.MultiStepsState)

    @jax.jit
    def jax_step(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    opt = MultiSteps(AdamW3(model, cfg.optimizer, cfg.trainer, steps_per_epoch=10, freeze_encoder=True), 2)
    rng = np.random.RandomState(11)
    for micro in range(4):
        grads = _grads(model, rng, frozen_scale=10.0)
        prev = params
        params, opt_state = jax_step(_nested(grads), opt_state, params)
        for n, p in named.items():
            p.grad = torch.from_numpy(grads[n])
        norm = opt.step()
        if micro % 2 == 0:
            assert norm is None
            for a, b in zip(jax.tree.leaves(prev), jax.tree.leaves(params)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert all(torch.equal(named[n].detach(), start[n]) for n in named)
        else:
            assert float(norm) > jcfg.trainer.gradient_clip_val  # the clip sees the averaged gradient
            start = {n: p.detach().clone() for n, p in named.items()}
    assert opt.count == 2 and opt.mini_step == 0
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(_nested({n: p.detach().numpy() for n, p in named.items()})))
    assert got.keys() == ref.keys()
    for path, value in ref.items():
        np.testing.assert_allclose(got[path], np.asarray(value), rtol=1e-6, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


def _run(root, out, *extra, resume=None):
    argv = ["--config", os.devnull, "--device", "cpu"] + (["--resume", str(resume)] if resume else [])
    return train.main(argv + [f"datamodule.dataset_cfg.root={root}", f"output_path={out}", *TINY_OVERRIDES,
                              "trainer.max_epochs=4", "trainer.accumulate_grad_batches=2", *extra])


def _records(out):
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    return [r for r in records if "train/total" in r]


@pytest.fixture(scope="module")
def cli_runs(fake_root, tmp_path_factory):  # noqa: F811
    """``cli/train`` for two steps (one an epoch on the one-scene split) at
    k = 2 with a checkpoint each epoch, the first mid-accumulation; then a
    run resumed from that checkpoint. The three training states (about 1 GB
    each: the tiny config's DPT heads keep the reference's widths) are
    removed at the end of the module."""
    tmp = tmp_path_factory.mktemp("train_cli")
    try:
        full = _run(fake_root, tmp / "full", "trainer.max_steps=2", "pipeline.log_training_result_interval=2")
        resumed = _run(fake_root, tmp / "resumed", "trainer.max_steps=2",
                       resume=tmp / "full" / "checkpoints" / "epoch000-1")
        yield {"tmp": tmp, "full": full, "resumed": resumed}
    finally:
        for run in ("full", "resumed"):
            shutil.rmtree(tmp / run / "checkpoints", ignore_errors=True)


def test_checkpoint_carries_the_accumulation(cli_runs, accumulation):
    """The CLI's state saved mid-accumulation holds the running mean and the
    micro-step (the resumed run below continues from them as the
    uninterrupted one did); optimizers with another k refuse it."""
    path = cli_runs["tmp"] / "full" / "checkpoints" / "epoch000-1"
    mid = torch.load(path, map_location="cpu", mmap=True, weights_only=False)
    assert (mid["epoch"], mid["global_step"]) == (0, 1)
    assert mid["optimizer"]["accumulate_grad_batches"] == 2 and mid["optimizer"]["mini_step"] == 1
    assert mid["optimizer"]["inner"]["count"] == 0
    assert max(float(v.abs().max()) for v in mid["optimizer"]["acc"].values()) > 0
    _, cfg1 = _cfgs(1)
    model = accumulation["model"]
    for k in (1, 3):
        inner = AdamW3(model, cfg1.optimizer, cfg1.trainer, steps_per_epoch=10, freeze_encoder=True)
        target = types.SimpleNamespace(model=model, optimizer=inner if k == 1 else MultiSteps(inner, k))
        with pytest.raises(ValueError, match="accumulates 2"):  # raised before any tensor is loaded
            restore_train_state(path, target)


def test_train_cli_resumes_mid_accumulation_as_the_uninterrupted_run(cli_runs):
    """Resuming the mid-accumulation checkpoint runs epoch 1 at global step 1
    and ends where the uninterrupted run ended."""
    tmp, full, resumed = cli_runs["tmp"], cli_runs["full"], cli_runs["resumed"]
    assert [os.path.basename(c) for c in full["checkpoints"]] == ["epoch000-1", "epoch001-2"]
    steps = _records(tmp / "full")
    assert [r["step"] for r in steps] == [0, 1]
    assert all(np.isfinite(r["train/total"]) and r["lr"] > 0 for r in steps)
    names = {p.parent.name for p in (tmp / "full" / "train_viz").rglob("*.png")}
    assert {"rgb", "rgb_gt", "depth"} <= names
    assert [p.name for p in (tmp / "full" / "train_viz").iterdir()] == ["step0000000"]

    assert [os.path.basename(c) for c in resumed["checkpoints"]] == ["epoch001-2"]
    rsteps = _records(tmp / "resumed")
    assert [r["step"] for r in rsteps] == [1]
    assert rsteps[0]["train/total"] == steps[1]["train/total"]
    a = torch.load(full["checkpoints"][-1], map_location="cpu", mmap=True, weights_only=False)
    b = torch.load(resumed["checkpoints"][0], map_location="cpu", mmap=True, weights_only=False)
    assert (a["epoch"], a["global_step"]) == (b["epoch"], b["global_step"]) == (1, 2)
    assert a["optimizer"]["inner"]["count"] == b["optimizer"]["inner"]["count"] == 1
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k
    for key in ("mu", "nu"):
        for k, v in a["optimizer"]["inner"][key].items():
            assert torch.equal(b["optimizer"]["inner"][key][k], v), (key, k)
    assert a["optimizer"]["acc"] is b["optimizer"]["acc"] is None  # saved at a step boundary: the mean is zero


def test_train_cli_trains_in_bf16_and_resumes(fake_root, tmp_path):  # noqa: F811
    """``cli/train ... pipeline.model.dtype=bfloat16`` at k = 2: one step,
    then a resume of its mid-accumulation checkpoint for the second: finite
    records, and the state file holds fp32 parameters, moments and running
    mean (the fp32 run's layout)."""
    try:
        full = _run(fake_root, tmp_path / "full", "trainer.max_steps=1", "pipeline.model.dtype=bfloat16")
        resumed = _run(fake_root, tmp_path / "resumed", "trainer.max_steps=2", "pipeline.model.dtype=bfloat16",
                       resume=tmp_path / "full" / "checkpoints" / "epoch000-1")
        steps = _records(tmp_path / "full") + _records(tmp_path / "resumed")
        assert [r["step"] for r in steps] == [0, 1]
        assert all(np.isfinite(r["train/total"]) for r in steps)
        assert [os.path.basename(c) for c in full["checkpoints"]] == ["epoch000-1"]
        assert [os.path.basename(c) for c in resumed["checkpoints"]] == ["epoch001-2"]
        for path in (full["checkpoints"][0], resumed["checkpoints"][0]):
            state = torch.load(path, map_location="cpu", mmap=True, weights_only=False)
            assert state["model"] and all(v.dtype in (torch.float32, torch.int64) for v in state["model"].values())
            inner = state["optimizer"]["inner"]
            assert all(v.dtype == torch.float32 for key in ("mu", "nu") for v in inner[key].values())
        acc = torch.load(full["checkpoints"][0], map_location="cpu", mmap=True, weights_only=False)["optimizer"]["acc"]
        assert acc and all(v.dtype == torch.float32 for v in acc.values())
    finally:
        for run in ("full", "resumed"):
            shutil.rmtree(tmp_path / run / "checkpoints", ignore_errors=True)
