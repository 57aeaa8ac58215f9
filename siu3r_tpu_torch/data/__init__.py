from siu3r_tpu_torch.data.datasets import (  # noqa: F401
    ConcatSceneDataset,
    MultiViewSceneDataset,
    ReplicaDataset,
    ScanNetDataset,
    ScanNetPPDataset,
    ScanReferDataset,
)
from siu3r_tpu_torch.data.loader import Loader, collate  # noqa: F401
