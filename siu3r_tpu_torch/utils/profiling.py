"""Profiling and step timing, counterpart of ``siu3r_tpu/utils/profiling.py``.

``trace(dir)`` captures a ``torch.profiler`` trace of the host and, on a GPU,
of the device (Chrome trace JSON, for Perfetto or TensorBoard); ``sync``
waits for the device work behind a result; ``StepTimer`` sums host-side
stage times, synchronising before it reads the clock."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str = "traces") -> Iterator[None]:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / f"trace_{time.time_ns()}.json"))


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, name))


def sync(tree) -> None:
    """Wait until the CUDA work behind the tensors of ``tree`` is done
    (``torch.cuda.synchronize`` of their devices); nothing on the CPU."""
    devices = {t.device for t in _tensors(tree) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, result=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if result is not None:
                sync(result)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def timed(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in sorted(self.totals)}

    def report(self) -> str:
        return " | ".join(f"{k}: {v * 1000:.1f}ms" for k, v in self.summary().items())
