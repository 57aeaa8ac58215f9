"""Scene datasets: ScanNet / ScanNet++ / Replica / ScanRefer, a copy of
``siu3r_tpu/data/datasets.py`` (numpy and PIL, no framework).

Same on-disk layout and sampling behavior as the reference
(src/data/components/*.py):
  * train: random context pair from the precomputed pairwise view-overlap
    table ``iou.pt`` (accept window per dataset), extra context/target views
    sampled in between; target ids = context ids + extras
    (scannet_dataset.py:126-163);
  * val: fixed pairs from ``val_pair.json`` (:165-170);
  * color JPG/PNG, 16-bit depth PNG (mm -> m), per-scan ``intrinsic.txt``,
    per-view ``extrinsic/{id}.txt``; poses made relative to the first context
    view (:90-114); intrinsics normalized by 256 (:77-88);
  * panoptic PNG decoded RGB -> sem*1000+inst (:258-269); labels via
    seg_labels.py; a ValueError during loading resamples another index
    (:358-366).

Images come out NHWC float32 [0, 1]; GT objects padded to ``max_objects``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import random
from typing import Dict, List, Optional

import numpy as np

from siu3r_tpu_torch.data.seg_labels import (
    build_ins2sem,
    decode_panoptic_png,
    instance_maps_to_video_masks,
)


@dataclasses.dataclass
class SamplingSpec:
    color_ext: str = "jpg"
    candidate_lo: int = 10
    candidate_hi: int = 101  # exclusive
    iou_min: float = 0.3
    iou_max: float = 0.8
    epoch_mult: int = 1


class MultiViewSceneDataset:
    spec = SamplingSpec()

    def __init__(
        self,
        root: str,
        num_extra_context_views: int = 0,
        num_extra_target_views: int = 2,
        train: bool = True,
        seg_task: str = "panoptic",
        val_pair_json: str = "val_pair.json",
        max_objects: int = 48,
        image_size: int = 256,
        seed: int = 0,
    ):
        self.root = root
        self.num_extra_context_views = num_extra_context_views
        self.num_extra_target_views = num_extra_target_views
        self.train = train
        self.seg_task = seg_task
        self.max_objects = max_objects
        self.image_size = image_size
        self.seed = seed
        self.rng = random.Random(seed)

        if train:
            self.scans_dir = osp.join(root, "train")
        else:
            self.scans_dir = osp.join(root, "val")
            if "demo" in val_pair_json:
                self.scans_dir = osp.join(root, "train")
            with open(osp.join(root, val_pair_json)) as f:
                self.val_pairs = json.load(f)
        names = [
            n
            for n in os.listdir(self.scans_dir)
            if osp.isdir(osp.join(self.scans_dir, n))
        ]
        self.scan_names = sorted(names)
        self.scan_items = {
            n: sorted(
                int(f.split(".")[0])
                for f in os.listdir(osp.join(self.scans_dir, n, "depth"))
            )
            for n in self.scan_names
        }

    def __len__(self) -> int:
        if self.train:
            return len(self.scan_names) * self.spec.epoch_mult
        return len(self.val_pairs)

    def set_epoch(self, epoch: int) -> None:
        """Restart the train views' random stream at (seed, epoch) (epoch 0
        is the stream the dataset starts with), so that a resumed run draws
        the views the uninterrupted run drew in that epoch. The draws follow
        the order items are loaded in: one loader worker keeps it fixed."""
        self.rng = random.Random(self.seed + 1_000_003 * int(epoch))

    # -- IO helpers (native libjpeg/libpng decode via data/native_io.py,
    # PIL fallback) ---------------------------------------------------------
    def _load_color(self, scan_path, vid) -> np.ndarray:
        from siu3r_tpu_torch.data import native_io

        path = osp.join(scan_path, "color", f"{vid}.{self.spec.color_ext}")
        w, h = native_io.image_size(path)
        kind = "jpeg" if self.spec.color_ext == "jpg" else "png_rgb"
        img = native_io.decode_batch([path], kind, w, h)[0]
        return img.astype(np.float32) / 255.0  # HWC [0,1]

    def _load_depth(self, scan_path, vid) -> np.ndarray:
        from siu3r_tpu_torch.data import native_io

        path = osp.join(scan_path, "depth", f"{vid}.png")
        w, h = native_io.image_size(path)
        d = native_io.decode_batch([path], "png_gray16", w, h)[0]
        return d.astype(np.float32) / 1000.0

    def _load_iou(self, scan_path) -> np.ndarray:
        pt = osp.join(scan_path, "iou.pt")
        npy = osp.join(scan_path, "iou.npy")
        if osp.exists(npy):
            return np.load(npy)
        import torch

        return torch.load(pt, weights_only=True, map_location="cpu").numpy()

    # -- sampling -----------------------------------------------------------
    def _sample_train_views(self, scan_name):
        scan_path = osp.join(self.scans_dir, scan_name)
        items = self.scan_items[scan_name]
        iou = self._load_iou(scan_path)
        n_extra = self.num_extra_context_views + self.num_extra_target_views
        for _ in range(100):
            idx1 = self.rng.randrange(len(items))
            cid1 = items[idx1]
            candidates = items[idx1 + self.spec.candidate_lo : idx1 + self.spec.candidate_hi]
            stay = [
                (i2, c)
                for i2, c in enumerate(candidates)
                if self.spec.iou_min < iou[cid1, c] < self.spec.iou_max
            ]
            if len(stay) <= n_extra:
                continue
            idx2, cid2 = self.rng.choice(stay)
            between = items[idx1 + 1 : idx1 + idx2 + self.spec.candidate_lo]
            if len(between) < n_extra:
                continue
            extra = self.rng.sample(between, n_extra)
            extra_ctx = extra[: self.num_extra_context_views]
            extra_tgt = extra[self.num_extra_context_views :]
            context_ids = sorted([cid1, cid2] + extra_ctx)
            target_ids = sorted(context_ids + extra_tgt)
            return context_ids, target_ids
        raise ValueError(
            f"Cannot find enough target views in scan {scan_name}"
        )

    # -- main ---------------------------------------------------------------
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        for attempt in range(len(self)):
            try:
                return self._load_item((idx + attempt) % len(self))
            except ValueError:
                continue
        raise RuntimeError("no loadable item found")

    def _load_item(self, idx: int) -> Dict[str, np.ndarray]:
        if self.train:
            scan_name = self.scan_names[idx % len(self.scan_names)]
            context_ids, target_ids = self._sample_train_views(scan_name)
        else:
            pair = self.val_pairs[idx]
            scan_name = pair["scan"]
            context_ids = list(pair["context_ids"])
            target_ids = list(pair["target_ids"])
        scan_path = osp.join(self.scans_dir, scan_name)

        ctx_imgs = np.stack([self._load_color(scan_path, v) for v in context_ids])
        tgt_imgs = np.stack([self._load_color(scan_path, v) for v in target_ids])
        ctx_depths = np.stack([self._load_depth(scan_path, v) for v in context_ids])
        tgt_depths = np.stack([self._load_depth(scan_path, v) for v in target_ids])

        intrinsic = np.loadtxt(osp.join(scan_path, "intrinsic.txt"))
        s = self.image_size
        k = np.array(
            [
                [intrinsic[0][0] / s, 0, intrinsic[0][2] / s],
                [0, intrinsic[1][1] / s, intrinsic[1][2] / s],
                [0, 0, 1],
            ],
            np.float32,
        )
        exts = {
            v: np.loadtxt(osp.join(scan_path, "extrinsic", f"{v}.txt")).astype(
                np.float32
            )
            for v in set(context_ids + target_ids)
        }
        canon_inv = np.linalg.inv(exts[context_ids[0]])
        ctx_ext = np.stack([canon_inv @ exts[v] for v in context_ids])
        tgt_ext = np.stack([canon_inv @ exts[v] for v in target_ids])

        def seg_labels(view_ids):
            from PIL import Image

            folder = "panoptic" if self.seg_task == "panoptic" else "instance"
            sems, inss = [], []
            for v in view_ids:
                rgb = np.asarray(
                    Image.open(osp.join(scan_path, folder, f"{v}.png"))
                )
                seg = decode_panoptic_png(rgb)
                sem = seg // 1000
                ins = seg % 1000
                if len(np.unique(sem)) == 1 and np.unique(sem)[0] == 0:
                    raise ValueError(
                        f"No semantic label in {scan_name} view {v}"
                    )
                sems.append(sem)
                inss.append(ins)
            ins2sem = build_ins2sem(sems, inss)
            return instance_maps_to_video_masks(inss, ins2sem, self.max_objects)

        ctx_masks, ctx_classes, ctx_valid = seg_labels(context_ids)
        tgt_masks, tgt_classes, tgt_valid = seg_labels(target_ids)

        return {
            "scene_names": scan_name,
            "context_views_id": np.asarray(context_ids, np.int32),
            "context_views_images": ctx_imgs.astype(np.float32),
            "context_views_depths": ctx_depths,
            "context_views_intrinsics": np.stack([k] * len(context_ids)),
            "context_views_extrinsics": ctx_ext.astype(np.float32),
            "target_views_id": np.asarray(target_ids, np.int32),
            "target_views_images": tgt_imgs.astype(np.float32),
            "target_views_depths": tgt_depths,
            "target_views_intrinsics": np.stack([k] * len(target_ids)),
            "target_views_extrinsics": tgt_ext.astype(np.float32),
            "gt_masks": ctx_masks,
            "gt_classes": ctx_classes,
            "gt_valid": ctx_valid,
            "target_gt_masks": tgt_masks,
            "target_gt_classes": tgt_classes,
            "target_gt_valid": tgt_valid,
        }


class ScanNetDataset(MultiViewSceneDataset):
    """reference scannet_dataset.py: JPG color, candidates +10..+100,
    IoU (0.3, 0.8)."""

    spec = SamplingSpec("jpg", 10, 101, 0.3, 0.8, 1)


class ScanNetPPDataset(MultiViewSceneDataset):
    """reference scannetpp_dataset.py: PNG color, candidates +10..+50."""

    spec = SamplingSpec("png", 10, 51, 0.3, 0.8, 1)


class ReplicaDataset(MultiViewSceneDataset):
    """reference replica_dataset.py: 50x epoch length, IoU (0.4, 0.8),
    candidates +10..+60."""

    spec = SamplingSpec("jpg", 10, 61, 0.4, 0.8, 50)


class ConcatSceneDataset:
    """Joint multi-dataset training — the reference's published training
    recipe (``src/data/datamodules/concat_datamodule.py:91-180``,
    ``get_datamodule.py:37-45``): ScanNet + ScanNet++ + Replica concatenated
    into one index space, with sub-roots ``{root}/scannet``,
    ``{root}/scannetpp``, ``{root}/replica`` (the reference's
    ``data_dir + "/scannet"`` convention). Per-dataset epoch weighting rides
    the member ``SamplingSpec.epoch_mult`` (Replica 50x), exactly like the
    reference's Replica epoch-length multiplier. Missing sub-roots are
    skipped with a warning so partial corpora still train."""

    members = (
        ("scannet", ScanNetDataset),
        ("scannetpp", ScanNetPPDataset),
        ("replica", ReplicaDataset),
    )

    def __init__(self, root: str, **kw):
        self.datasets = []
        for sub, cls in self.members:
            subroot = osp.join(root, sub)
            if osp.isdir(subroot):
                self.datasets.append(cls(subroot, **kw))
            else:
                import logging

                logging.getLogger(__name__).warning(
                    "concat: missing sub-dataset %s (skipped)", subroot
                )
        if not self.datasets:
            raise FileNotFoundError(
                f"concat root {root} has none of "
                f"{[s for s, _ in self.members]}"
            )
        self._lens = [len(d) for d in self.datasets]

    def __len__(self) -> int:
        return sum(self._lens)

    def set_epoch(self, epoch: int) -> None:
        for d in self.datasets:
            d.set_epoch(epoch)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if idx < 0:
            idx += len(self)
        for d, n in zip(self.datasets, self._lens):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError(idx)


class ScanReferDataset(MultiViewSceneDataset):
    """Referring-expression dataset (reference scanrefer_dataset.py:82-181).

    ``{split}_refer_seg_data.json`` schema (reference):
      {scene: {"frame2object": {frame_id: [obj ids]},
               "objects": {obj_id: {"panoptic_label_id": int,
                                    "text": [str, ...],
                                    "text_token": [[int, ...], ...]}}}}

    Train sampling mirrors the reference: random anchor frame, second frame
    10-30 frames ahead; context objects = union of the two frames' objects;
    per object, masks = (instance map == obj_id) across BOTH views, class =
    panoptic_label_id - 1, one randomly-chosen text/token sequence. Word i
    corresponds to GT object i — the alignment ``refer_word_match_loss``
    trains against. Val uses fixed ``val_refer_pair.json`` entries
    ({"scan", "context_views_id", "context_objects"}). Outputs padded to
    ``max_objects`` with a validity mask; no depth/extrinsics/targets (the
    refer batch is seg-only, like the reference's)."""

    spec = SamplingSpec("jpg", 10, 101, 0.3, 0.8, 1)

    def __init__(self, root: str, train: bool = True, max_objects: int = 8,
                 max_tokens: int = 32, **kw):
        kw.pop("num_extra_context_views", None)
        kw.pop("num_extra_target_views", None)
        super().__init__(root, train=train, max_objects=max_objects,
                         val_pair_json="val_refer_pair.json", **kw)
        split = "train" if train else "val"
        with open(osp.join(root, f"{split}_refer_seg_data.json")) as f:
            self.refer_data = json.load(f)
        self.max_tokens = max_tokens
        if train:
            self.scan_names = [
                n for n in self.scan_names if n in self.refer_data
            ]

    def __len__(self) -> int:
        return len(self.scan_names) if self.train else len(self.val_pairs)

    def _load_item(self, idx: int):
        if self.train:
            scan_name = self.scan_names[idx % len(self.scan_names)]
            data = self.refer_data[scan_name]
            frames = sorted(int(f) for f in data["frame2object"])
            right_margin = max(len(frames) - 1 - 30, 0) or (len(frames) - 1)
            i1 = self.rng.randint(0, right_margin)
            i2 = min(i1 + self.rng.randint(10, 30), len(frames) - 1)
            context_ids = [frames[i1], frames[i2]]
            objects = sorted(
                set(
                    int(o)
                    for f in context_ids
                    for o in data["frame2object"][str(f)]
                )
            )
        else:
            pair = self.val_pairs[idx]
            scan_name = pair["scan"]
            data = self.refer_data[scan_name]
            context_ids = list(pair["context_views_id"])
            objs = pair["context_objects"]
            objects = list(objs) if isinstance(objs, (list, tuple)) else [objs]
        scan_path = osp.join(self.scans_dir, scan_name)

        ctx_imgs = np.stack([self._load_color(scan_path, v) for v in context_ids])
        intrinsic = np.loadtxt(osp.join(scan_path, "intrinsic.txt"))
        s = self.image_size
        k = np.array(
            [
                [intrinsic[0][0] / s, 0, intrinsic[0][2] / s],
                [0, intrinsic[1][1] / s, intrinsic[1][2] / s],
                [0, 0, 1],
            ],
            np.float32,
        )

        from PIL import Image

        ins_maps = []
        for v in context_ids:
            rgb = np.asarray(
                Image.open(osp.join(scan_path, "panoptic", f"{v}.png"))
            )
            seg = decode_panoptic_png(rgb)
            ins_maps.append(seg % 1000)
        ins_maps = np.stack(ins_maps)  # [V, H, W]

        o_max, t_max = self.max_objects, self.max_tokens
        h, w = ins_maps.shape[1:]
        masks = np.zeros((o_max, len(context_ids), h, w), np.float32)
        classes = np.zeros((o_max,), np.int32)
        valid = np.zeros((o_max,), bool)
        texts: List[str] = []
        tokens = np.zeros((o_max, t_max), np.int32)
        for oi, obj_id in enumerate(objects[:o_max]):
            obj = data["objects"][str(obj_id)]
            choice = self.rng.randrange(len(obj["text"])) if self.train else 0
            tok = np.asarray(obj["text_token"][choice], np.int32)[:t_max]
            masks[oi] = (ins_maps == obj_id).astype(np.float32)
            classes[oi] = int(obj["panoptic_label_id"]) - 1
            valid[oi] = True
            texts.append(obj["text"][choice])
            tokens[oi, : len(tok)] = tok
        while len(texts) < o_max:
            texts.append("")
        if not valid.any():
            raise ValueError(f"No referred objects in {scan_name}")

        return {
            "scene_names": scan_name,
            "context_views_id": np.asarray(context_ids, np.int32),
            "context_views_images": ctx_imgs.astype(np.float32),
            "context_views_intrinsics": np.stack([k] * len(context_ids)),
            "gt_masks": masks,
            "gt_classes": classes,
            "gt_valid": valid,
            "text": texts,
            "text_token": tokens,
        }
