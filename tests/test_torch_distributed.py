"""siu3r_tpu_torch's data parallelism on the CPU: one two-rank gloo group
(``python -m torch.distributed.run --standalone --nproc_per_node 2
tests/torch_dist_worker.py``, two torch threads a rank) shared by the module,
at the tiny config of tests/test_train.py, held against the JAX package's
rule and against one process.

  * The data-parallel step (the JAX package's ``make_dp_train_step``): the
    averaged gradients, loss terms and BatchNorm running statistics against
    the mean of the JAX package's per-shard ones, each shard's loss composed
    as tests/test_torch_train_step.py composes it, with the same injected
    sample points on both sides; its tolerances (loss terms rtol 1e-3 /
    atol 1e-5, each gradient tensor a relative L2 error of 2e-3 where its
    norm exceeds 1e-6 of the global norm, statistics rtol 1e-4 / atol 1e-6).
  * The same step with the model computing in bf16 against the mean of the
    port's one-process bf16 step on each shard, at the same tolerances
    (tests/test_torch_bf16_train.py holds that step against JAX's).
  * ZeRO-1 against the replicated step from the same state: every parameter
    within 1e-6 (tests/test_train.py's), each rank's moments of each group
    half the group plus at most one element of padding.
  * The eval step's outputs gathered from the ranks against one process's on
    the whole batch: atol 1e-5 on the renders, equal label maps.
  * ``cli/validate`` under two ranks against one process's sweep (the
    tolerances of tests/test_torch_validate.py), one writer.
  * ``cli/train`` under two ranks with ZeRO-1 at k = 2: one writer; a resume
    of its mid-accumulation checkpoint ends bitwise where the uninterrupted
    run ended (the same operations on the same inputs on the CPU); the file
    holds the one-device layout and restores into one process.

Also the parts that need no group: ``shard_batch``, the loader's batch
order with several workers (every rank must cut the same global batch), the entry points'
behaviour without ``WORLD_SIZE``, and the kernel build's safety when two
processes build into one directory at once (with a stub ``nvcc``).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from siu3r_tpu.checkpoint import convert_siu3r_state_dict
from siu3r_tpu.train import lpips as jax_lpips
from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch import parallel
from siu3r_tpu_torch.checkpoint_io import restore_train_state
from siu3r_tpu_torch.cli import validate
from siu3r_tpu_torch.data import Loader
from siu3r_tpu_torch.models.model import set_compute_dtype
from siu3r_tpu_torch.pipeline import Pipeline
from siu3r_tpu_torch.train.optimizer import MultiSteps
from siu3r_tpu_torch.weights import lpips_params_from_jax
from test_cli_smoke import TINY_OVERRIDES, fake_root  # noqa: F401
from test_torch_train_cli import two_torch_threads  # noqa: F401
from test_torch_train_step import _batch, _injected, _jax_loss_fn, _port_pipeline
from test_train import tiny_root_cfg

REPO = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 900


def _sweep_weights(cfg, path):
    """The tiny model's weights biased as tests/test_torch_validate.py biases
    them, so that the sweep keeps a query and its renders are covered."""
    pipe = Pipeline(cfg, device="cpu", seed=3)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        pipe.model.mask2former.class_predictor.bias[4] += 4.0
        for head in (pipe.model.downstream_head1, pipe.model.downstream_head2):
            head.dpt.head[4].bias[2] += 0.5
        for head in (pipe.model.gaussian_param_head1, pipe.model.gaussian_param_head2):
            head.dpt.head[4].bias[0] += 2.0
            head.dpt.head[4].bias[1:4] += 60.0
        for mod in pipe.model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.from_numpy(rng.standard_normal(mod.num_features).astype(np.float32) * 0.1))
                mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, mod.num_features).astype(np.float32)))
    torch.save(pipe.model.state_dict(), path)


def _two_scene_root(fake_root, root):  # noqa: F811
    """fake_root with a second train scene (a global batch of 2) and a second
    val pair (one sweep batch of 2)."""
    shutil.copytree(fake_root, root)
    shutil.copytree(root / "train" / "scene0000_00", root / "train" / "scene0001_00")
    pairs = json.loads((root / "val_pair.json").read_text())
    pairs.append({"scan": "scene0000_00", "context_ids": [3, 8], "target_ids": [3, 6, 8]})
    (root / "val_pair.json").write_text(json.dumps(pairs))


def _jax_shard_means(jcfg, jlpips, variables, batch, injected):
    """The JAX package's rule: value_and_grad of each shard's loss (one item
    each), then the mean over the shards of the loss terms, the gradients and
    the new BatchNorm statistics (``pmean``). One compile serves both."""
    fn = jax.jit(jax.value_and_grad(
        lambda params, stats, b, inj: _jax_loss_fn(jcfg, jlpips, b, inj)(params, stats), has_aux=True))
    shards = []
    for i in range(2):
        b = {k: v[i:i + 1] for k, v in batch.items()}
        inj = [{k: v[i:i + 1] for k, v in d.items()} for d in injected]
        (_, (stats, losses, alpha)), grads = fn(variables["params"], variables["batch_stats"], b, inj)
        shards.append((stats, losses, grads, float(np.asarray(alpha).mean())))
    mean = lambda *xs: np.mean([np.asarray(x, np.float64) for x in xs], axis=0)
    return dict(stats=jax.tree.map(mean, *[s[0] for s in shards]), losses=jax.tree.map(mean, *[s[1] for s in shards]),
                grads=jax.tree.map(mean, *[s[2] for s in shards]), alphas=[s[3] for s in shards])


def _bf16_shard_means(cfg, state, lpips, batch, injected):
    """The port's one-process bf16 step on each shard (one item each): the
    mean over the shards of the loss terms, the gradients and the new
    BatchNorm statistics, by the port's parameter and buffer names."""
    pipe = Pipeline(cfg, device="cpu", seed=0)
    set_compute_dtype(pipe.model, "bfloat16")
    pipe.lpips_params = lpips
    shards = []
    for i in range(2):
        pipe.model.load_state_dict(state)
        b = {k: torch.from_numpy(v[i:i + 1]) for k, v in batch.items()}
        inj = [{k: torch.from_numpy(v[i:i + 1]) for k, v in d.items()} for d in injected]
        _, losses = pipe.loss_fn(b, None, injected_coords=inj)
        losses["total"].backward()
        grads = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                 for n, p in pipe.model.named_parameters()}
        pipe.model.zero_grad(set_to_none=True)
        stats = {k: v.clone() for k, v in pipe.model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
        shards.append(({k: float(v.detach()) for k, v in losses.items()}, grads, stats))
    mean = lambda dicts: {k: sum(d[k] for d in dicts) / 2 for k in dicts[0]}
    return dict(losses=mean([s[0] for s in shards]), grads=mean([s[1] for s in shards]),
                stats=mean([s[2] for s in shards]))


@pytest.fixture(scope="module")
def group(fake_root, tmp_path_factory):  # noqa: F811
    """Start the two-rank group, then, while it runs, the JAX package's
    per-shard step and one process's sweep; wait for the group."""
    tmp = tmp_path_factory.mktemp("dist")
    root = tmp / "scannet"
    _two_scene_root(Path(fake_root), root)
    jcfg = tiny_root_cfg()
    cfg = port_config._from_dict(port_config.RootCfg, dataclasses.asdict(jcfg))
    pipe = _port_pipeline(cfg)
    state = {k: v.clone() for k, v in pipe.model.state_dict().items()}
    del pipe
    jlpips = jax_lpips.init_lpips_params(None)
    batch = _batch()
    injected = _injected(jcfg, batch)
    sweep_cfg = port_config.bind_scannet_classes(port_config.load_config(None, [
        *TINY_OVERRIDES, f"datamodule.dataset_cfg.root={root}"]))
    _sweep_weights(sweep_cfg, tmp / "sweep_weights.pt")
    torch.save({"cfg": dataclasses.asdict(jcfg), "state": state, "batch": batch, "injected": injected,
                "lpips": lpips_params_from_jax(jax.tree.map(np.asarray, jlpips)), "overrides": TINY_OVERRIDES,
                "sweep_weights": str(tmp / "sweep_weights.pt")}, tmp / "inputs.pt")
    out = tmp / "out"
    out.mkdir()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "2"}
    env.pop("WORLD_SIZE", None)
    log = open(tmp / "group.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                             str(REPO / "tests" / "torch_dist_worker.py"), str(tmp / "inputs.pt"), str(out),
                             str(root)], cwd=tmp, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        variables = convert_siu3r_state_dict({k: v.numpy() for k, v in state.items()}, jcfg.pipeline.model)
        ref = _jax_shard_means(jcfg, jlpips, variables, batch, injected)
        bf16_ref = _bf16_shard_means(cfg, state, lpips_params_from_jax(jax.tree.map(np.asarray, jlpips)), batch,
                                     injected)
        one_sweep = validate.main(["--config", os.devnull, "--device", "cpu", "--ckpt", str(tmp / "sweep_weights.pt"),
                                   "--output_path", str(tmp / "val_one"), *TINY_OVERRIDES,
                                   f"datamodule.dataset_cfg.root={root}"])
        rc = proc.wait(timeout=GROUP_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    assert rc == 0, (tmp / "group.log").read_text()[-6000:]
    res = torch.load(out / "results.pt", weights_only=False)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    yield dict(tmp=tmp, out=out, jcfg=jcfg, cfg=cfg, state=state, ref=ref, bf16_ref=bf16_ref, res=res, ranks=ranks,
               one_sweep=one_sweep)
    for run in ("train", "resumed"):
        shutil.rmtree(out / run / "checkpoints", ignore_errors=True)


def test_dp_step_loss_terms_are_the_mean_of_the_jax_shards(group):
    ref, got = group["ref"], group["res"]["dp_losses"]
    assert min(group["ref"]["alphas"]) > 0.05  # each shard's target views see its splats
    assert got.keys() == ref["losses"].keys()
    for key, value in ref["losses"].items():
        np.testing.assert_allclose(got[key], float(value), rtol=1e-3, atol=1e-5, err_msg=key)


def test_dp_step_gradients_are_the_mean_of_the_jax_shards(group):
    state = {k: v.numpy() for k, v in group["state"].items()}
    grads = {k: v.numpy() for k, v in group["res"]["dp_grads"].items()}
    port = convert_siu3r_state_dict({**state, **grads}, group["jcfg"].pipeline.model)["params"]
    ref = dict(jax.tree_util.tree_leaves_with_path(group["ref"]["grads"]))
    got = dict(jax.tree_util.tree_leaves_with_path(port))
    global_norm = np.sqrt(sum(float(np.sum(np.square(g))) for g in ref.values()))
    checked = 0
    for path, g in ref.items():
        norm = np.linalg.norm(g)
        if norm <= 1e-6 * global_norm:
            continue
        err = np.linalg.norm(np.asarray(got[path], np.float64) - g) / norm
        assert err <= 2e-3, (jax.tree_util.keystr(path), err)
        checked += 1
    assert checked > 0.9 * len(ref)


def test_dp_step_batchnorm_statistics_are_the_mean_of_the_jax_shards(group):
    state = {k: v.numpy() for k, v in group["state"].items()}
    stats = {k: v.numpy() for k, v in group["res"]["dp_stats"].items()}
    port = convert_siu3r_state_dict({**state, **stats}, group["jcfg"].pipeline.model)["batch_stats"]
    ref = dict(jax.tree_util.tree_leaves_with_path(group["ref"]["stats"]))
    got = dict(jax.tree_util.tree_leaves_with_path(port))
    assert ref.keys() == got.keys() and ref
    for path, value in ref.items():
        np.testing.assert_allclose(got[path], value, rtol=1e-4, atol=1e-6, err_msg=jax.tree_util.keystr(path))
    # the mean of the shards', not rank 0's: the statistics moved from the state
    moved = max(float(np.abs(stats[k] - state[k]).max()) for k in stats)
    assert moved > 1e-4


def test_dp_bf16_step_is_the_mean_of_the_one_process_bf16_shards(group):
    ref, res = group["bf16_ref"], group["res"]
    assert res["bf16_losses"].keys() == ref["losses"].keys()
    for key, value in ref["losses"].items():
        np.testing.assert_allclose(res["bf16_losses"][key], value, rtol=1e-3, atol=1e-5, err_msg=key)
    assert res["bf16_losses"]["total"] != res["dp_losses"]["total"]  # the step computed in bf16
    grads = res["bf16_grads"]
    assert all(g.dtype == torch.float32 for g in grads.values())
    global_norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref["grads"].values())))
    checked = 0
    for name, g in ref["grads"].items():
        norm = float(g.double().norm())
        if norm <= 1e-6 * global_norm:
            continue
        err = float((grads[name].double() - g.double()).norm()) / norm
        assert err <= 2e-3, (name, err)
        checked += 1
    assert checked > 0.9 * len(ref["grads"])
    for name, value in ref["stats"].items():
        np.testing.assert_allclose(res["bf16_stats"][name].numpy(), value.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


def test_the_ranks_hold_the_same_parameters(group):
    a, b = group["ranks"]
    assert a["dp_params_sum"] == b["dp_params_sum"] and a["z1_params_sum"] == b["z1_params_sum"]


def test_zero1_matches_the_replicated_step(group):
    res = group["res"]
    assert max(res["z1_minus_dp"].values()) < 1e-6, max(res["z1_minus_dp"].items(), key=lambda kv: kv[1])
    assert max(res["dp_moved"].values()) > 1e-6
    np.testing.assert_allclose(res["z1_losses"]["total"], res["dp_losses"]["total"], rtol=1e-6)
    for r in group["ranks"]:
        for g, (mu, nu) in r["moment_sizes"].items():
            size = r["group_sizes"][g]
            assert mu == nu == -(-size // 2), (g, mu, size)  # half the group, padded
            assert 2 * mu - size in (0, 1)


def test_dp_eval_step_gathers_the_one_process_outputs(group):
    got, want = group["res"]["dp_eval"], group["res"]["one_eval"]
    assert got.keys() == want.keys() and got["color"].shape[0] == 2
    for key in ("color", "depth"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=key)
    for key in ("context_seg", "sem_ids", "ins_ids"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert [[{**i, "score": 0} for i in x] for x in got["seg_infos"]] == [
        [{**i, "score": 0} for i in x] for x in want["seg_infos"]]


def _pngs(root, sub):
    return {p.relative_to(root): np.asarray(Image.open(p)).astype(np.int64) for p in sorted(root.rglob(f"{sub}/*.png"))}


def test_two_rank_sweep_matches_one_process(group):
    sweep, one = group["res"]["validate"], group["one_sweep"]
    got_dir, want_dir = group["out"] / "val", group["tmp"] / "val_one"
    assert sweep["n_scenes"] == one["n_scenes"] == 2 and sweep["devices"] == 2 and sweep["batch_size"] == 2
    files = lambda root: sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    assert files(got_dir) == files(want_dir)  # one writer: the same files, none twice
    for sub, level, share in (("rgb", 1, 0.999), ("depth", 1, 0.99)):
        got, want = _pngs(got_dir, sub), _pngs(want_dir, sub)
        assert got.keys() == want.keys() and len(got) == 6
        for rel, w in want.items():
            assert (np.abs(got[rel] - w) <= level).mean() >= share, rel
    for which in ("context", "target"):
        got, want = _pngs(got_dir, f"{which}_seg_pred"), _pngs(want_dir, f"{which}_seg_pred")
        assert got.keys() == want.keys() and got
        assert np.mean([(got[k] == want[k]).all(-1).mean() for k in want]) >= 0.999
    r, w = sweep["results"], one["results"]
    assert r.keys() == w.keys()
    np.testing.assert_allclose(r["psnr"], w["psnr"], rtol=0, atol=1e-2)
    for key in ("ssim", "lpips", "absrel", "rmse", "context_miou", "target_miou", "context_pq", "target_pq"):
        np.testing.assert_allclose(r[key], w[key], rtol=0, atol=1e-3, err_msg=key)


def _records(out):
    lines = (out / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if "train/total" in r]


def test_two_rank_train_cli_writes_once(group):
    out, res = group["out"], group["res"]
    assert [os.path.basename(c) for c in res["train"]["checkpoints"]] == ["epoch000-1", "epoch001-2"]
    steps = _records(out / "train")
    assert [r["step"] for r in steps] == [0, 1]  # one record a step: rank 0 alone writes
    assert all(np.isfinite(r["train/total"]) for r in steps)
    assert [p.name for p in (out / "train" / "train_viz").iterdir()] == ["step0000000"]
    scenes = {p.parent.parent.name for p in (out / "train" / "train_viz").rglob("rgb/*.png")}
    assert len(scenes) == 2  # both ranks' items, gathered on rank 0
    mid = torch.load(out / "train" / "checkpoints" / "epoch000-1", map_location="cpu", mmap=True, weights_only=False)
    opt = mid["optimizer"]
    assert opt["mini_step"] == 1 and opt["inner"]["count"] == 0
    for key in ("mu", "nu"):  # the one-device layout
        assert all(v.shape == mid["model"][k].shape for k, v in opt["inner"][key].items())
    assert opt["acc"].keys() == {n for names in opt["inner"]["groups"].values() for n in names}
    assert all(v.shape == mid["model"][k].shape for k, v in opt["acc"].items())
    assert max(float(v.abs().max()) for v in opt["acc"].values()) > 0


def test_two_rank_resume_mid_accumulation_is_bitwise_the_uninterrupted_run(group):
    out, res = group["out"], group["res"]
    assert [os.path.basename(c) for c in res["resumed"]["checkpoints"]] == ["epoch001-2"]
    assert _records(out / "resumed")[0]["train/total"] == _records(out / "train")[1]["train/total"]
    a = torch.load(out / "train" / "checkpoints" / "epoch001-2", map_location="cpu", mmap=True, weights_only=False)
    b = torch.load(out / "resumed" / "checkpoints" / "epoch001-2", map_location="cpu", mmap=True, weights_only=False)
    assert a["optimizer"]["inner"]["count"] == b["optimizer"]["inner"]["count"] == 1
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k
    for key in ("mu", "nu"):
        for k, v in a["optimizer"]["inner"][key].items():
            assert torch.equal(b["optimizer"]["inner"][key][k], v), (key, k)
    mid = torch.load(out / "train" / "checkpoints" / "epoch000-1", map_location="cpu", mmap=True, weights_only=False)
    assert max(float((a["model"][k] - v).abs().max()) for k, v in mid["model"].items() if "head" in k) > 0


def test_a_two_rank_checkpoint_restores_into_one_process(group):
    path = group["out"] / "train" / "checkpoints" / "epoch000-1"
    cfg = port_config.bind_scannet_classes(port_config.load_config(None, [
        *TINY_OVERRIDES, "trainer.accumulate_grad_batches=2", "trainer.zero1=true"]))
    pipe = Pipeline(cfg, device="cpu", seed=1).init_train(steps_per_epoch=1, lpips_enabled=False)
    assert isinstance(pipe.optimizer, MultiSteps) and type(pipe.optimizer.inner).__name__ == "AdamW3"  # no group
    assert restore_train_state(path, pipe) == (0, 1)
    saved = torch.load(path, map_location="cpu", mmap=True, weights_only=False)
    assert (pipe.optimizer.count, pipe.optimizer.mini_step) == (0, 1)
    for k, v in saved["optimizer"]["acc"].items():
        assert torch.equal(pipe.optimizer.acc[k], v), k
    for k, v in saved["model"].items():
        assert torch.equal(pipe.model.state_dict()[k], v), k


def test_without_a_group_nothing_is_distributed(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not parallel.is_distributed() and parallel.world_size() == 1 and parallel.rank() == 0
    assert parallel.init_distributed("gloo", "cpu") == torch.device("cpu") and not parallel.is_distributed()
    t = torch.ones(3)
    parallel.all_reduce_mean_([t])
    assert torch.equal(t, torch.ones(3)) and torch.equal(parallel.all_gather_flat(t), t)
    assert parallel.gather_to_rank0({"x": 1}) == [{"x": 1}]


class _UnevenDataset:
    """Items that take uneven times to load: with several loader workers,
    later batches are often ready before earlier ones."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        time.sleep(0.01 * ((5 * i) % 7))
        return {"i": np.array([i])}


@pytest.mark.parametrize("workers", [1, 3, 4])
def test_loader_yields_the_epochs_batches_in_order(workers):
    """Each rank iterates a loader of its own and cuts its slice of each
    batch: the batches must come in the epoch's order whatever the number
    of workers, or the ranks would cut different global batches."""
    loader = Loader(_UnevenDataset(), batch_size=2, shuffle=True, num_workers=workers, seed=5)
    loader.set_epoch(1)
    order = np.arange(12)
    np.random.RandomState(6).shuffle(order)
    assert [b["i"][:, 0].tolist() for b in loader] == [order[i:i + 2].tolist() for i in range(0, 12, 2)]


def test_shard_batch_cuts_contiguous_slices():
    batch = {"a": np.arange(6), "t": torch.arange(12).view(6, 2), "names": list("abcdef"), "k": 3}
    parts = [parallel.shard_batch(batch, world=3, index=i) for i in range(3)]
    assert [list(p["a"]) for p in parts] == [[0, 1], [2, 3], [4, 5]]
    assert [p["names"] for p in parts] == [["a", "b"], ["c", "d"], ["e", "f"]]
    assert torch.equal(parts[1]["t"], torch.tensor([[4, 5], [6, 7]])) and parts[2]["k"] == 3
    with pytest.raises(ValueError, match="does not divide"):
        parallel.shard_batch(batch, world=4, index=0)


STUB_NVCC = """\
#!{python}
# a stand-in for nvcc: -c SRC -o OBJ writes OBJ in two halves with a pause
# between them; -shared OBJS -o LIB concatenates the objects the same way
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    data = ("obj:" + open(args[args.index("-c") + 1]).read()[:200]).encode()
else:
    data = b"".join(open(a, "rb").read() for a in args if a.endswith(".o"))
with open(out, "wb") as f:
    f.write(data[: len(data) // 2])
    f.flush()
    time.sleep(0.3)
    f.write(data[len(data) // 2:])
print("ptxas info    : Used 8 registers")
"""


def test_concurrent_kernel_builds_do_not_clobber_each_other(tmp_path):
    """Two processes build the kernels into one empty directory at once, as
    the ranks of a fresh checkout do: both return the library, which is the
    sources' objects whole, and no scratch is left behind."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "nvcc").write_text(STUB_NVCC.format(python=sys.executable))
    (bin_dir / "nvcc").chmod(0o755)
    build_dir = tmp_path / "kernels"
    script = textwrap.dedent(f"""
        from pathlib import Path
        from siu3r_tpu_torch.kernels import _build
        _build.BUILD_DIR = Path({str(build_dir)!r})
        lib, _ = _build.build()
        print(lib)
    """)
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", script], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    from siu3r_tpu_torch.kernels import _build

    lib = build_dir / _build.library_path().name
    assert {o.strip() for o, _ in outs} == {str(lib)}
    sources = sorted((REPO / "siu3r_tpu_torch" / "csrc").glob("*.cu"))
    assert lib.read_bytes() == b"".join(("obj:" + s.read_text()[:200]).encode() for s in sources)
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(["build.log", lib.name])
    assert (build_dir / "build.log").read_text().count("Used 8 registers") == len(sources)
