"""Batching + background-prefetch loader (the reference's Lightning
DataModule/DataLoader equivalent, src/data/datamodules/*), a copy of
``siu3r_tpu/data/loader.py``.

collate(): stacks per-sample dicts into batched numpy arrays — unlike the
reference's ragged mask/class lists (scannet_datamodule.py:13-86), GT objects
arrive pre-padded from the dataset so everything stacks densely (fixed shapes).

Loader: thread-pool prefetcher producing host (numpy) batches; the caller
moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals  # strings etc.
    return out


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last

    def set_epoch(self, epoch: int) -> None:
        """Make the shuffle order a pure function of (seed, epoch) so a
        resumed run re-derives the same order the original run would have
        used at this epoch (torch DistributedSampler.set_epoch semantics;
        the reference's Lightning resume restores loop/sampler state), and
        restart the dataset's own random stream for the epoch where it has
        one (``set_epoch``)."""
        self.epoch = int(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        n_batches = len(self)
        batches = [
            order[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(n_batches)
        ]

        q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 2)
        stop = threading.Event()

        def worker(batch_indices_list):
            for idxs in batch_indices_list:
                if stop.is_set():
                    return
                try:
                    samples = [self.dataset[int(i)] for i in idxs]
                    q.put(("ok", collate(samples)))
                except Exception as e:  # surface loader errors
                    q.put(("err", e))
                    return

        chunks = [batches[i :: self.num_workers] for i in range(self.num_workers)]
        threads = [
            threading.Thread(target=worker, args=(c,), daemon=True) for c in chunks
        ]
        for t in threads:
            t.start()
        produced = 0
        try:
            while produced < n_batches:
                kind, payload = q.get()
                if kind == "err":
                    raise payload
                produced += 1
                yield payload
        finally:
            stop.set()
