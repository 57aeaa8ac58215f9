"""Batching + background-prefetch loader (the reference's Lightning
DataModule/DataLoader equivalent, src/data/datamodules/*), a copy of
``siu3r_tpu/data/loader.py``.

collate(): stacks per-sample dicts into batched numpy arrays — unlike the
reference's ragged mask/class lists (scannet_datamodule.py:13-86), GT objects
arrive pre-padded from the dataset so everything stacks densely (fixed shapes).

Loader: thread-pool prefetcher producing host (numpy) batches, in the
order of the epoch's batch list whatever the number of workers (batch i
comes from worker i % num_workers), so that every rank of a data-parallel
run, iterating its own loader, takes its slice of the same global batch at
each step; the caller moves them to the device.
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

        # one queue a worker: worker w makes batches w, w + n, ..., and the
        # consumer takes batch i from queue i % n, in order
        queues: List["queue.Queue"] = [queue.Queue(maxsize=2) for _ in range(self.num_workers)]
        stop = threading.Event()

        def worker(q, batch_indices_list):
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
            threading.Thread(target=worker, args=(q, c), daemon=True) for q, c in zip(queues, chunks)
        ]
        for t in threads:
            t.start()
        try:
            for produced in range(n_batches):
                kind, payload = queues[produced % self.num_workers].get()
                if kind == "err":
                    raise payload
                yield payload
        finally:
            stop.set()
