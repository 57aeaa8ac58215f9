"""``python -m siu3r_tpu_torch.cli.train`` on a concat root (the reference's
published training recipe, configs/concat.yaml's dataset) on the CPU:
tests/test_cli_smoke.py's ``fake_concat_root`` (one 32x32 scene a member,
JPG / PNG / JPG colour, 1 + 1 + 50 items an epoch) at its tiny config with
k = 2, against the JAX package's loader length and learning-rate schedule
(within 1e-7 relative, as tests/test_torch_datasets.py), and a run resumed
from inside an epoch against the uninterrupted run (bitwise: the same
operations on the same inputs on the CPU). ``python -m pytest
tests/test_torch_concat_train_cli.py -q`` (about 80 s: eight micro-steps and
three training states of about 1 GB each, removed at the end).
"""

import json
import math
import os
import shutil
from pathlib import Path

import pytest
import torch

from siu3r_tpu.cli.train import build_dataset as jax_build_dataset
from siu3r_tpu.config import load_config as jax_load_config
from siu3r_tpu.data import Loader as JaxLoader
from siu3r_tpu.train.optimizer import make_lr_schedule as jax_lr_schedule
from siu3r_tpu_torch.cli import train
from siu3r_tpu_torch.pipeline import Pipeline
from test_cli_smoke import TINY_OVERRIDES, fake_concat_root  # noqa: F401  (fixture)
from test_torch_datasets import LR_RTOL
from test_torch_train_cli import two_torch_threads  # noqa: F401  (fixture)


def _run(root, out, max_steps: int, resume=None) -> dict:
    argv = ["--config", os.devnull, "--device", "cpu"] + (["--resume", str(resume)] if resume else [])
    return train.main(argv + [f"datamodule.dataset_cfg.root={root}", "datamodule.dataset_cfg.name=concat",
                              f"output_path={out}", *TINY_OVERRIDES, "trainer.accumulate_grad_batches=2",
                              f"trainer.max_steps={max_steps}"])


def _records(out: Path) -> list:
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k != "time"} for r in records if "train/total" in r]


@pytest.fixture(scope="module")
def concat_cli_runs(fake_concat_root, tmp_path_factory):  # noqa: F811
    """``cli/train`` on tests/test_cli_smoke.py's concat root (one scene a
    member, 52 steps an epoch at batch 1) at k = 2: four micro-steps (two
    optimizer steps) uninterrupted; one micro-step, stopped by max_steps in
    the middle of the epoch and of the accumulation; then that checkpoint
    resumed to step 4. Records each run's ``init_train`` steps an epoch. The
    training states (about 1 GB each) are removed at the end of the module."""
    tmp = tmp_path_factory.mktemp("concat_cli")
    built = []
    init_train = Pipeline.init_train

    def recording(self, steps_per_epoch=1000, **kw):
        built.append(steps_per_epoch)
        return init_train(self, steps_per_epoch=steps_per_epoch, **kw)

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(Pipeline, "init_train", recording)
            full = _run(fake_concat_root, tmp / "full", 4)
            first = _run(fake_concat_root, tmp / "first", 1)
            resumed = _run(fake_concat_root, tmp / "resumed", 4,
                           resume=tmp / "first" / "checkpoints" / "epoch000-1")
        yield {"tmp": tmp, "full": full, "first": first, "resumed": resumed, "steps_per_epoch": built}
    finally:
        for run in ("full", "first", "resumed"):
            shutil.rmtree(tmp / run / "checkpoints", ignore_errors=True)


def test_train_cli_on_a_concat_root_matches_the_jax_packages_schedule(concat_cli_runs, fake_concat_root):  # noqa: F811
    """Two optimizer steps at k = 2: four finite records whose learning rate
    is the JAX package's schedule at the JAX CLI's steps an epoch (its
    loader's length on the same config), one checkpoint, and every run's
    pipeline built with that many steps an epoch."""
    runs = concat_cli_runs
    jcfg = jax_load_config(os.devnull, [f"datamodule.dataset_cfg.root={fake_concat_root}",
                                        "datamodule.dataset_cfg.name=concat", *TINY_OVERRIDES])
    loader_cfg = jcfg.datamodule.train_loader_cfg
    jax_steps = max(len(JaxLoader(jax_build_dataset(jcfg, train=True), batch_size=loader_cfg.batch_size,
                                  num_workers=loader_cfg.num_workers, seed=jcfg.seed)), 1)
    assert jax_steps == 1 + 1 + 50  # the smoke root's one-scene members, batch 1
    assert runs["steps_per_epoch"] == [jax_steps] * 3
    records = _records(runs["tmp"] / "full")
    assert [r["step"] for r in records] == [0, 1, 2, 3] and all(r["epoch"] == 0 for r in records)
    assert all(math.isfinite(v) for r in records for k, v in r.items() if k.startswith("train/"))
    o = jcfg.optimizer
    lr_of = jax_lr_schedule(o.lr, o.warm_up_epochs, jcfg.trainer.max_epochs, jax_steps)
    for r in records:
        assert abs(r["lr"] - float(lr_of(r["step"]))) <= LR_RTOL * r["lr"], r["step"]
    assert [os.path.basename(c) for c in runs["full"]["checkpoints"]] == ["epoch000-4"]
    state = torch.load(runs["full"]["checkpoints"][0], map_location="cpu", mmap=True, weights_only=False)
    assert state["optimizer"]["inner"]["count"] == 2 and state["optimizer"]["mini_step"] == 0
    assert (state["epoch"], state["global_step"], state["epoch_step"]) == (0, 4, 4)


def test_train_cli_resumes_inside_a_concat_epoch_as_the_uninterrupted_run(concat_cli_runs):
    """The run stopped at step 1 saved its place in epoch 0 and its half
    accumulation; its resume goes on with epoch 0's second batch (drawing
    the views of the first one again, unused), and its records and its
    final state equal the uninterrupted run's bit for bit."""
    runs, tmp = concat_cli_runs, concat_cli_runs["tmp"]
    full, first, resumed = (_records(tmp / run) for run in ("full", "first", "resumed"))
    assert first == full[:1]
    assert [os.path.basename(c) for c in runs["first"]["checkpoints"]] == ["epoch000-1"]
    mid = torch.load(runs["first"]["checkpoints"][0], map_location="cpu", mmap=True, weights_only=False)
    assert (mid["epoch"], mid["global_step"], mid["epoch_step"]) == (0, 1, 1)
    assert mid["optimizer"]["mini_step"] == 1 and mid["optimizer"]["inner"]["count"] == 0
    assert resumed == full[1:]
    assert [os.path.basename(c) for c in runs["resumed"]["checkpoints"]] == ["epoch000-4"]
    a = torch.load(runs["full"]["checkpoints"][0], map_location="cpu", mmap=True, weights_only=False)
    b = torch.load(runs["resumed"]["checkpoints"][0], map_location="cpu", mmap=True, weights_only=False)
    assert (a["epoch"], a["global_step"], a["epoch_step"]) == (b["epoch"], b["global_step"], b["epoch_step"])
    assert a["model"].keys() == b["model"].keys()
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k
    assert a["optimizer"]["inner"]["count"] == b["optimizer"]["inner"]["count"] == 2
    for key in ("mu", "nu"):
        for k, v in a["optimizer"]["inner"][key].items():
            assert torch.equal(b["optimizer"]["inner"][key][k], v), (key, k)
