"""Segmentation ground-truth preparation, a copy of
``siu3r_tpu/data/seg_labels.py``.

Replicates the video Mask2Former image-processor label pipeline
(reference image_processing_video_mask2former.py:270-309 + encode_inputs
:904-1056, as used by the datasets with reduce_labels=True, ignore_index=255,
scannet_dataset.py:65-72, :258-339): instance-id maps -> per-object binary
video masks + 0-indexed class labels. Output is PADDED to a fixed object
count for jit-able batching (the reference keeps ragged lists)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IGNORE_INDEX = 255


def decode_panoptic_png(rgb: np.ndarray) -> np.ndarray:
    """RGB-encoded segment id: little-endian base-256
    (reference scannet_dataset.py:258-263). Returns sem*1000+inst int32."""
    rgb = rgb.astype(np.int64)
    return rgb[..., 0] + rgb[..., 1] * 256 + rgb[..., 2] * 256 * 256


def instance_maps_to_video_masks(
    instance_maps: Sequence[np.ndarray],
    ins2sem: Dict[int, int],
    max_objects: int,
    reduce_labels: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """instance_maps: V x [H, W] instance-id maps; ins2sem: instance id ->
    dataset-space semantic id (1-indexed; 0 = unlabeled).

    Returns (masks [O, V, H, W] float32, classes [O] int32 0-indexed,
    valid [O] bool). Objects beyond max_objects are dropped (reference keeps
    all; cap chosen generously)."""
    v = len(instance_maps)
    h, w = instance_maps[0].shape

    # reduce_labels: id 0 -> ignore, else id-1 (reference :288-292)
    reduced = []
    for m in instance_maps:
        m = np.asarray(m)
        if reduce_labels:
            m = np.where(m == 0, IGNORE_INDEX, m - 1)
        reduced.append(m)

    all_ids = np.unique(np.concatenate([np.unique(m) for m in reduced]))
    all_ids = all_ids[all_ids != IGNORE_INDEX]
    n = min(len(all_ids), max_objects)

    masks = np.zeros((max_objects, v, h, w), np.float32)
    classes = np.zeros((max_objects,), np.int32)
    valid = np.zeros((max_objects,), bool)
    for oi, ins in enumerate(all_ids[:n]):
        for vi, m in enumerate(reduced):
            masks[oi, vi] = m == ins
        raw = ins + 1 if reduce_labels else ins
        cls = ins2sem[int(raw)]
        classes[oi] = cls - 1 if reduce_labels else cls
        valid[oi] = True
    return masks, classes, valid


def build_ins2sem(semantic: Sequence[np.ndarray], instance: Sequence[np.ndarray]) -> Dict[int, int]:
    """Per-view instance->semantic map union (reference :274-290)."""
    ins2sem: Dict[int, int] = {}
    for sem, ins in zip(semantic, instance):
        for semantic_label in np.unique(sem):
            ids = np.unique(ins[sem == semantic_label])
            for sid in ids:
                ins2sem[int(sid)] = int(semantic_label)
    return ins2sem
