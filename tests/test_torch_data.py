"""siu3r_tpu_torch's copies of the JAX package's host-side modules (data,
native IO, metrics) against the originals.

Data: the fake ScanNet root of tests/test_data.py and the fake ScanRefer
root of tests/test_refer.py, read by both packages' datasets, loaders and
``build_dataset``: every item equal, key by key. Native IO: the port builds
its own library (``build/native/``) from the same source; decodes and
segment packing equal the JAX package's. Metrics: the same random inputs
through both modules, within 1e-6.
"""

import dataclasses

import numpy as np
import pytest

from siu3r_tpu.cli.train import build_dataset as jax_build_dataset
from siu3r_tpu.config import RootCfg as JaxRootCfg
from siu3r_tpu.data import Loader as JaxLoader
from siu3r_tpu.data import ScanNetDataset as JaxScanNet
from siu3r_tpu.data import ScanReferDataset as JaxScanRefer
from siu3r_tpu.data import native_io as jax_native_io
from siu3r_tpu.data import seg_labels as jax_seg_labels
from siu3r_tpu.eval import metrics as JM
from siu3r_tpu.visualizer import pack_segment_rgb as jax_pack_segment_rgb
from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch.cli.train import build_dataset
from siu3r_tpu_torch.data import Loader, ScanNetDataset, ScanReferDataset, collate, native_io, seg_labels
from siu3r_tpu_torch.eval import metrics as PM
from test_data import fake_scannet  # noqa: F401  (fixture)
from test_refer import fake_refer_root  # noqa: F401  (fixture)

METRIC_TOL = 1e-6


def _equal_items(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, ref in want.items():
        if isinstance(ref, np.ndarray):
            assert got[key].dtype == ref.dtype, key
            np.testing.assert_array_equal(got[key], ref, err_msg=key)
        else:
            assert got[key] == ref, key


@pytest.mark.parametrize("train", [True, False])
def test_scannet_items_equal_the_jax_packages(fake_scannet, train):  # noqa: F811
    kw = dict(num_extra_target_views=1, train=train, image_size=64, seed=3)
    port, ref = ScanNetDataset(fake_scannet, **kw), JaxScanNet(fake_scannet, **kw)
    assert len(port) == len(ref)
    for _ in range(2):  # the train sampler's random stream goes on alike
        for i in range(len(ref)):
            _equal_items(port[i], ref[i])


@pytest.mark.parametrize("train", [True, False])
def test_scanrefer_items_equal_the_jax_packages(fake_refer_root, train):  # noqa: F811
    kw = dict(train=train, max_objects=4, image_size=32, seed=1)
    port, ref = ScanReferDataset(fake_refer_root, **kw), JaxScanRefer(fake_refer_root, **kw)
    assert len(port) == len(ref)
    for _ in range(3):
        for i in range(len(ref)):
            item = port[i]
            _equal_items(item, ref[i])
    assert item["text_token"].shape == (4, 32) and item["gt_valid"].sum() == 2


def test_build_dataset_and_loader_match_the_jax_packages(fake_refer_root):  # noqa: F811
    jcfg = JaxRootCfg()
    jcfg.datamodule.dataset_cfg.name = "scanrefer"
    jcfg.datamodule.dataset_cfg.root = fake_refer_root
    jcfg.datamodule.dataset_cfg.max_objects = 4
    jcfg.datamodule.dataset_cfg.image_width = 32
    cfg = port_config._from_dict(port_config.RootCfg, dataclasses.asdict(jcfg))
    port, ref = build_dataset(cfg, train=False), jax_build_dataset(jcfg, train=False)
    assert type(port) is ScanReferDataset
    got = list(Loader(port, batch_size=1, shuffle=False, num_workers=2, drop_last=False))
    want = list(JaxLoader(ref, batch_size=1, shuffle=False, num_workers=2, drop_last=False))
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        _equal_items(g, w)
    assert got[0]["context_views_images"].shape == (1, 2, 32, 32, 3)
    assert got[0]["scene_names"] == ["scene0000_00"]


def test_loader_order_and_collate_match_the_jax_packages():
    class Items:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return {"x": np.full((2,), i, np.float32), "i": i, "name": f"n{i}"}

    for kw in (dict(shuffle=True, drop_last=True, seed=5), dict(shuffle=False, drop_last=False)):
        port, ref = Loader(Items(), 3, num_workers=3, **kw), JaxLoader(Items(), 3, num_workers=3, **kw)
        port.set_epoch(2)
        ref.set_epoch(2)
        assert len(port) == len(ref)
        # the workers interleave; the same batches come out
        key = lambda b: tuple(b["i"].tolist())
        assert sorted(map(key, port)) == sorted(map(key, ref))
    batch = collate([Items()[i] for i in (4, 7)])
    assert batch["x"].shape == (2, 2) and batch["i"].tolist() == [4, 7] and batch["name"] == ["n4", "n7"]


def test_seg_labels_match_the_jax_packages():
    rng = np.random.RandomState(0)
    sems = [rng.randint(0, 6, (9, 11)) for _ in range(2)]
    inss = [rng.randint(0, 5, (9, 11)) for _ in range(2)]
    ins2sem = seg_labels.build_ins2sem(sems, inss)
    assert ins2sem == jax_seg_labels.build_ins2sem(sems, inss)
    for max_objects in (2, 8):
        got = seg_labels.instance_maps_to_video_masks(inss, ins2sem, max_objects)
        want = jax_seg_labels.instance_maps_to_video_masks(inss, ins2sem, max_objects)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    rgb = rng.randint(0, 256, (7, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(seg_labels.decode_panoptic_png(rgb), jax_seg_labels.decode_panoptic_png(rgb))


def test_native_io_builds_its_own_library_and_matches_the_jax_packages(tmp_path):
    from PIL import Image

    lib = native_io.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")  # the PIL fallback is checked below either way
    assert native_io._LIB_PATH.parent.name == "native" and native_io._LIB_PATH.parent.parent.name == "build"
    rng = np.random.RandomState(0)
    img = (rng.rand(24, 40, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "a.jpg", quality=95)
    Image.fromarray(img).save(tmp_path / "a.png")
    depth = (rng.rand(24, 40) * 60000).astype(np.uint16)
    Image.fromarray(depth.astype(np.int32), mode="I").convert("I;16").save(tmp_path / "d.png")
    for name, kind in (("a.jpg", "jpeg"), ("a.png", "png_rgb"), ("d.png", "png_gray16")):
        path = str(tmp_path / name)
        assert native_io.image_size(path) == jax_native_io.image_size(path) == (40, 24)
        np.testing.assert_array_equal(native_io.decode_batch([path, path], kind, 40, 24),
                                      jax_native_io.decode_batch([path, path], kind, 40, 24))
    sem = rng.randint(0, 21, (17, 13)).astype(np.int32)
    ins = rng.randint(0, 999, (17, 13)).astype(np.int32)
    packed = native_io.pack_segments(sem, ins)
    np.testing.assert_array_equal(packed, jax_pack_segment_rgb(sem, ins))
    np.testing.assert_array_equal(native_io.pack_segment_rgb(sem, ins), packed)
    for a, b in zip(native_io.unpack_segments(packed), jax_native_io.unpack_segments(packed)):
        np.testing.assert_array_equal(a, b)


def test_native_io_pil_fallback_matches(tmp_path, monkeypatch):
    from PIL import Image

    rng = np.random.RandomState(1)
    img = (rng.rand(16, 20, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    sem = rng.randint(0, 21, (6, 5)).astype(np.int32)
    ins = rng.randint(0, 999, (6, 5)).astype(np.int32)
    monkeypatch.setattr(native_io, "get_lib", lambda: None)
    np.testing.assert_array_equal(native_io.decode_batch([str(tmp_path / "a.png")], "png_rgb", 20, 16)[0], img)
    assert native_io.image_size(tmp_path / "a.png") == (20, 16)
    packed = native_io.pack_segments(sem, ins)
    np.testing.assert_array_equal(packed, jax_pack_segment_rgb(sem, ins))
    for a, b in zip(native_io.unpack_segments(packed), (sem, ins)):
        np.testing.assert_array_equal(a, b)


def test_metrics_match_the_jax_packages():
    rng = np.random.RandomState(0)
    close = lambda a, b: np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                                    rtol=METRIC_TOL, atol=METRIC_TOL)
    pred, target = rng.rand(2, 24, 24, 3), rng.rand(2, 24, 24, 3)
    close(PM.psnr(pred, target), JM.psnr(pred, target))
    close(PM.ssim(pred[0], target[0]), JM.ssim(pred[0], target[0]))
    d_pred, d_gt = rng.rand(16, 16) + 0.1, rng.rand(16, 16) * 3
    close(PM.fit_scale_and_shift(d_pred, d_gt), JM.fit_scale_and_shift(d_pred, d_gt))
    close(PM.depth_errors(d_pred, d_gt), JM.depth_errors(d_pred, d_gt))

    miou, jmiou = PM.MeanIoU(6), JM.MeanIoU(6)
    pq, jpq = PM.PanopticQuality(things=[3, 4, 5], stuffs=[1, 2]), JM.PanopticQuality(things=[3, 4, 5], stuffs=[1, 2])
    mapm, jmap = PM.MeanAveragePrecision(), JM.MeanAveragePrecision()
    for _ in range(3):
        sem_p, sem_t = rng.randint(0, 6, (2, 16, 16))
        ins_p, ins_t = rng.randint(0, 3, (2, 16, 16))
        for m in (miou, jmiou):
            m.update(sem_p, sem_t)
        for m in (pq, jpq):
            m.update(np.stack([sem_p, ins_p], -1), np.stack([sem_t, ins_t], -1))
        preds = {"masks": rng.rand(5, 16, 16) > 0.6, "labels": rng.randint(0, 3, 5), "scores": rng.rand(5)}
        gts = {"masks": rng.rand(3, 16, 16) > 0.6, "labels": rng.randint(0, 3, 3)}
        for m in (mapm, jmap):
            m.update(preds, gts)
    close(miou.compute(), jmiou.compute())
    close(pq.compute(), jpq.compute())
    got, want = mapm.compute(), jmap.compute()
    assert got.keys() == want.keys()
    for key in want:
        close(got[key], want[key])

    masks = rng.rand(5, 2, 8, 8) > 0.5
    gt = (rng.rand(6, 2, 8, 8) > 0.5).astype(np.float32)
    valid = np.array([True, False, True, True, True, False])
    gmean, gper = PM.referred_mask_iou(masks, gt, valid)
    wmean, wper = JM.referred_mask_iou(masks, gt, valid)
    close(gmean, wmean)
    close(gper, wper)
    assert len(gper) == 4
