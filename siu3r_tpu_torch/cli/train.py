"""The training entry point's dataset dispatch, counterpart of
``siu3r_tpu/cli/train.py:build_dataset``.

Only ``build_dataset`` is here for now; the training loop with gradient
accumulation, checkpointing and the closing validation sweep
(``siu3r_tpu/cli/train.py:main``) comes with the distributed training slice.
"""

from __future__ import annotations


def build_dataset(cfg, train: bool):
    """Dataset dispatch (reference get_datamodule.py:4-77): scannet /
    scannetpp / replica / concat (joint multi-dataset training) /
    scanrefer (referring-expression segmentation)."""
    from siu3r_tpu_torch.data import (
        ConcatSceneDataset,
        ReplicaDataset,
        ScanNetDataset,
        ScanNetPPDataset,
        ScanReferDataset,
    )

    dcfg = cfg.datamodule.dataset_cfg
    cls = {
        "scannet": ScanNetDataset,
        "scannetpp": ScanNetPPDataset,
        "replica": ReplicaDataset,
        "concat": ConcatSceneDataset,
        "scanrefer": ScanReferDataset,
    }[dcfg.name]
    return cls(
        dcfg.root,
        num_extra_context_views=dcfg.num_extra_context_views,
        num_extra_target_views=dcfg.num_extra_target_views,
        train=train,
        seg_task=dcfg.seg_task,
        image_size=dcfg.image_width,
        max_objects=dcfg.max_objects,
    )
