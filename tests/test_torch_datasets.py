"""The reference's published training recipe (configs/concat.yaml) in
siu3r_tpu_torch: the ScanNet++, Replica and concat datasets, ``build_dataset``
and the loader against the JAX package's, the recipe's learning-rate
schedule on a concat root (``cli/train`` on a concat root is
tests/test_torch_concat_train_cli.py's).

Data: a concat root of this file (``concat_root``), 32x32, with train and val
splits under ``scannet`` (two scenes, JPG), ``scannetpp`` (two scenes, PNG,
120 frames: most first views have candidates past its +10..+50 window) and
``replica`` (120 frames, past its +10..+60 window, and its overlap table in
an ``iou.pt`` written by ``torch.save`` in place of ``iou.npy``). Its overlaps spread over (0.2, 0.8),
so Replica's (0.4, 0.8) window takes fewer pairs than ScanNet's (0.3, 0.8).
Items, batches and lengths are equal, key by key and dtype by dtype (the
same numpy operations on the same files); learning rates within 1e-7
relative (tests/test_torch_train_loss.py's tolerance for the schedule).
``python -m pytest tests/test_torch_datasets.py -q`` (about 25 s).
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from siu3r_tpu.cli.train import build_dataset as jax_build_dataset
from siu3r_tpu.config import RootCfg as JaxRootCfg
from siu3r_tpu.config import bind_scannet_classes as jax_bind_scannet_classes
from siu3r_tpu.config import load_config as jax_load_config
from siu3r_tpu.data import ConcatSceneDataset as JaxConcat
from siu3r_tpu.data import Loader as JaxLoader
from siu3r_tpu.data import ReplicaDataset as JaxReplica
from siu3r_tpu.data import ScanNetPPDataset as JaxScanNetPP
from siu3r_tpu.train.optimizer import make_lr_schedule as jax_lr_schedule
from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch.cli.train import build_dataset
from siu3r_tpu_torch.data import ConcatSceneDataset, Loader, ReplicaDataset, ScanNetPPDataset
from siu3r_tpu_torch.train.optimizer import AdamW3
from test_torch_data import _equal_items
from test_torch_train_loss import _Named

RECIPE = Path(__file__).resolve().parent.parent / "configs" / "concat.yaml"
LR_RTOL = 1e-7

# sub-root: (colour, train frames, train scene names, overlap table file)
MEMBERS = {
    "scannet": ("jpg", 16, ("scene0000_00", "scene0001_00"), "npy"),
    "scannetpp": ("png", 120, ("0a5c013435", "0a7cc12c0e"), "npy"),
    "replica": ("jpg", 120, ("room0",), "pt"),
}
VAL_FRAMES = 12
VAL_PAIRS = ({"context_ids": [0, 5], "target_ids": [0, 2, 5]}, {"context_ids": [3, 9], "target_ids": [3, 6, 9]})
DATASETS = {"scannetpp": (ScanNetPPDataset, JaxScanNetPP), "replica": (ReplicaDataset, JaxReplica),
            "concat": (ConcatSceneDataset, JaxConcat)}
# train items: one a scene, Replica's 50 a scene (its epoch_mult)
TRAIN_LEN = {"scannetpp": 2, "replica": 50, "concat": 2 + 2 + 50}
VAL_LEN = {"scannetpp": 2, "replica": 2, "concat": 3 * 2}
ITEM_KW = dict(num_extra_target_views=1, image_size=32, max_objects=4)


def _write_scene(scan: Path, rng, colour: str, frames: int, iou_file: str) -> None:
    from PIL import Image

    s = 32
    for sub in ("color", "depth", "extrinsic", "panoptic"):
        (scan / sub).mkdir(parents=True)
    np.savetxt(scan / "intrinsic.txt", np.array([[40.0, 0, 16], [0, 40, 16], [0, 0, 1]]))
    iou = rng.rand(128, 128) * 0.6 + 0.2
    if iou_file == "pt":
        torch.save(torch.from_numpy(iou.astype(np.float32)), scan / "iou.pt")
    else:
        np.save(scan / "iou.npy", iou)
    for i in range(frames):
        Image.fromarray((rng.rand(s, s, 3) * 255).astype(np.uint8)).save(scan / "color" / f"{i}.{colour}")
        Image.fromarray((rng.rand(s, s) * 4000 + 500).astype(np.uint16)).save(scan / "depth" / f"{i}.png")
        ext = np.eye(4)
        ext[0, 3] = 0.05 * i
        ext[2, 3] = 0.01 * i
        np.savetxt(scan / "extrinsic" / f"{i}.txt", ext)
        seg = np.full((s, s), 1000, np.int64)  # a wall, a chair and a table that moves
        seg[:, s // 2:] = 5 * 1000 + 7
        seg[4:12, (i % 10) + 2:(i % 10) + 12] = 7 * 1000 + 3
        Image.fromarray(np.stack([seg % 256, (seg // 256) % 256, seg // 65536], -1).astype(np.uint8)).save(
            scan / "panoptic" / f"{i}.png")


@pytest.fixture(scope="module")
def concat_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipe")
    rng = np.random.RandomState(7)
    for sub, (colour, frames, scenes, iou_file) in MEMBERS.items():
        for name in scenes:
            _write_scene(root / sub / "train" / name, rng, colour, frames, iou_file)
        _write_scene(root / sub / "val" / scenes[0], rng, colour, VAL_FRAMES, iou_file)
        (root / sub / "val_pair.json").write_text(json.dumps([{"scan": scenes[0], **p} for p in VAL_PAIRS]))
    replica = root / "replica" / "train" / "room0"
    assert (replica / "iou.pt").exists() and not (replica / "iou.npy").exists()
    return str(root)


def _root_of(root: str, name: str) -> str:
    return root if name == "concat" else os.path.join(root, name)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", list(DATASETS))
def test_items_equal_the_jax_packages(concat_root, name, train):
    """Every item, key by key and dtype by dtype; the train split over two
    passes (the view draws' random stream goes on alike); ``len()`` with
    Replica's x50."""
    cls, jax_cls = DATASETS[name]
    kw = dict(ITEM_KW, train=train, seed=3)
    port, ref = cls(_root_of(concat_root, name), **kw), jax_cls(_root_of(concat_root, name), **kw)
    assert len(port) == len(ref) == (TRAIN_LEN if train else VAL_LEN)[name]
    names = set()
    for _ in range(2 if train else 1):
        for i in range(len(ref)):
            item = port[i]
            _equal_items(item, ref[i])
            names.add(item["scene_names"])
    members = [n for n in MEMBERS if name in ("concat", n)]
    scenes = {s for m in members for s in MEMBERS[m][2]} if train else {MEMBERS[m][2][0] for m in members}
    assert names == scenes
    assert item["context_views_images"].shape == (2, 32, 32, 3) and item["gt_masks"].shape == (4, 2, 32, 32)


def _batches(loader, epoch: int) -> list:
    loader.set_epoch(epoch)
    return list(loader)


def _equal_batches(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _equal_items(g, w)


def test_concat_set_epoch_restarts_every_members_stream(concat_root):
    """A run over epochs 0, 1 and 2 (the CLI's loop: the loader's
    ``set_epoch`` at each epoch, one worker): its epoch 0 equals the JAX
    package's (whose datasets have no ``set_epoch``), and a fresh dataset
    set to epoch 2 gives the run's epoch 2, every member's items included."""
    kw = dict(ITEM_KW, train=True)
    loader_kw = dict(batch_size=4, shuffle=True, num_workers=1, seed=2)
    run = Loader(ConcatSceneDataset(concat_root, **kw), **loader_kw)
    epochs = [_batches(run, e) for e in range(3)]
    _equal_batches(epochs[0], _batches(JaxLoader(JaxConcat(concat_root, **kw), **loader_kw), 0))
    fresh = Loader(ConcatSceneDataset(concat_root, **kw), **loader_kw)
    _equal_batches(_batches(fresh, 2), epochs[2])
    scenes = {s for b in epochs[2] for s in b["scene_names"]}
    assert scenes == {s for m in MEMBERS.values() for s in m[2]}

    def draws(batches):  # each Replica item's views, in the order drawn
        return [tuple(ids) for b in batches for s, ids in zip(b["scene_names"], b["context_views_id"].tolist())
                if s == "room0"]

    assert draws(epochs[1]) != draws(epochs[2])  # a later epoch draws anew


def _cfgs(name: str, root: str):
    jcfg = JaxRootCfg()
    dcfg = jcfg.datamodule.dataset_cfg
    dcfg.name, dcfg.root, dcfg.max_objects, dcfg.image_width, dcfg.num_extra_target_views = name, root, 4, 32, 1
    return jcfg, port_config._from_dict(port_config.RootCfg, dataclasses.asdict(jcfg))


def _batch_key(batch) -> tuple:
    return tuple(batch["scene_names"]), batch["context_views_id"].tobytes()


@pytest.mark.parametrize("name", list(DATASETS))
def test_build_dataset_and_loaders_match_the_jax_packages(concat_root, name):
    """``build_dataset`` builds the JAX package's class for the name; the
    train batches through one loader worker and the val batches through two
    equal the JAX loader's. The JAX loader's workers share one queue, so at
    two its batches come in the order they finish: they are matched to the
    port's, whose order is fixed, by scene and context views."""
    jcfg, cfg = _cfgs(name, _root_of(concat_root, name))
    for train, workers in ((True, 1), (False, 2)):
        port, ref = build_dataset(cfg, train=train), jax_build_dataset(jcfg, train=train)
        assert type(port).__name__ == type(ref).__name__ == DATASETS[name][0].__name__
        assert type(port) is DATASETS[name][0]
        loader_kw = dict(batch_size=1, shuffle=train, num_workers=workers, seed=1, drop_last=train)
        got = list(Loader(port, **loader_kw))
        want = list(JaxLoader(ref, **loader_kw))
        if workers > 1:
            by_key = {_batch_key(w): w for w in want}
            assert len(by_key) == len(want)
            want = [by_key[_batch_key(g)] for g in got]
        assert len(got) == (TRAIN_LEN if train else VAL_LEN)[name]
        _equal_batches(got, want)


def test_recipe_schedule_on_a_concat_root(concat_root):
    """configs/concat.yaml on the concat root, in both packages: the same
    dataset class and loader length, and so the same steps an epoch (Replica's
    x50 dominates it); the port's optimizer built with it gives each
    group's learning rate of the JAX package's optax schedule at steps 0, 1,
    the last of the warm-up, the first after it and the last step."""
    overrides = [f"datamodule.dataset_cfg.root={concat_root}"]
    jcfg = jax_bind_scannet_classes(jax_load_config(str(RECIPE), overrides))
    cfg = port_config.bind_scannet_classes(port_config.load_config(RECIPE, overrides))
    assert cfg.datamodule.dataset_cfg.name == "concat" and cfg.optimizer.warm_up_epochs == 3
    loader_kw = dict(batch_size=cfg.datamodule.train_loader_cfg.batch_size,
                     num_workers=cfg.datamodule.train_loader_cfg.num_workers, seed=cfg.seed)
    port = Loader(build_dataset(cfg, train=True), **loader_kw)
    ref = JaxLoader(jax_build_dataset(jcfg, train=True), **loader_kw)
    assert type(port.dataset) is ConcatSceneDataset and len(port.dataset) == TRAIN_LEN["concat"]
    assert len(port) == len(ref) == TRAIN_LEN["concat"] // 3
    steps_per_epoch = max(len(port), 1)  # as cli/train computes it
    opt = AdamW3(_Named(), cfg.optimizer, cfg.trainer, steps_per_epoch=steps_per_epoch, freeze_encoder=True)
    o, warm = jcfg.optimizer, jcfg.optimizer.warm_up_epochs * steps_per_epoch
    steps = (0, 1, warm - 1, warm, jcfg.trainer.max_epochs * steps_per_epoch - 1)
    for group, mult in {"normal": o.gaussian_head_lr_mult, "high": o.seg_lr_mult, "low": o.base_lr_mult}.items():
        sched = jax_lr_schedule(o.lr * mult, o.warm_up_epochs, jcfg.trainer.max_epochs, steps_per_epoch)
        for step in steps:
            want = float(sched(step))
            assert abs(opt.lr(group, step) - want) <= LR_RTOL * want, (group, step)
