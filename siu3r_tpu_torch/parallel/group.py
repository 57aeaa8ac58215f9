"""The process group and its collectives, counterpart of
``siu3r_tpu/parallel/mesh.py``.

One process per rank, launched by ``torchrun`` (``python -m
torch.distributed.run``), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``. The JAX package's 1-D
``data`` mesh becomes the group's ranks: the global batch is cut into one
contiguous slice a rank (``shard_batch``), the parameters are replicated, and
the ``pmean``s that the JAX steps write inside ``shard_map`` are explicit
calls here (``all_reduce_mean_``), made after the backward.

Without ``WORLD_SIZE`` in the environment no group is made: ``world_size()``
is 1, ``rank()`` 0, the collectives are not called, and every entry point
runs as one process on one device.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from siu3r_tpu_torch.device import resolve_device

# the largest flat buffer a collective sends at once: tensors are packed
# into buckets of at most this many bytes (a larger tensor goes alone)
BUCKET_BYTES = 256 << 20


class CollectiveStats:
    """Calls, bytes (of this rank's send buffer) and host seconds of the
    collectives this process ran, by name. With ``timed`` set each collective
    is timed between two synchronisations of the device, so that its seconds
    are its own and not the queue's before it; unset, nothing is timed and no
    synchronisation is added."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()
        self.seconds: collections.Counter = collections.Counter()

    def run(self, name: str, nbytes: int, device: torch.device, fn) -> None:
        self.calls[name] += 1
        self.bytes[name] += nbytes
        if not self.timed:
            fn()
            return
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        self.seconds[name] += time.perf_counter() - t0


stats = CollectiveStats()


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def init_distributed(backend: str = "nccl", device: str = "cuda") -> torch.device:
    """Join the process group that torchrun's environment describes and
    return this rank's device: ``cuda:{LOCAL_RANK % device_count}``, or the
    CPU when ``device`` is ``cpu``. ``backend`` is the caller's choice:
    ``nccl`` (one card a rank) or ``gloo`` (the CPU, or ranks that share a
    card, which NCCL refuses). Every rank logs the device it got. Without
    ``WORLD_SIZE`` in the environment, makes no group and returns
    ``resolve_device(device)``. A group made before (by the caller) is kept."""
    if "WORLD_SIZE" not in os.environ:
        return resolve_device(device)
    from siu3r_tpu_torch.utils.logging import RankedLogger

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the nccl backend runs on CUDA devices; pass backend gloo with device cpu")
    if not is_distributed():
        env = os.environ
        dist.init_process_group(
            backend, init_method=f"tcp://{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}",
            rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
        )
    RankedLogger(__name__).info(f"rank {rank()} of {world_size()} ({dist.get_backend()}): device {dev}")
    return dev


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if is_distributed():
        dist.destroy_process_group()


def shard_slice(n: int, world: Optional[int] = None, index: Optional[int] = None) -> slice:
    """Rank ``index``'s contiguous share of ``n`` items over ``world`` ranks
    (this rank's of this group by default). Raises unless ``world`` divides
    ``n``, as the JAX package's batch sharding does."""
    world = world_size() if world is None else world
    index = rank() if index is None else index
    if n % world:
        raise ValueError(f"a global batch of {n} does not divide over {world} ranks")
    per = n // world
    return slice(index * per, (index + 1) * per)


def shard_batch(batch: Dict[str, Any], world: Optional[int] = None, index: Optional[int] = None) -> Dict[str, Any]:
    """This rank's slice of a global batch (counterpart of ``shard_batch``):
    every array, tensor and list of the batch's leading size cut to
    ``shard_slice``; other entries as they are."""
    batched = lambda v: isinstance(v, list) or (isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0)
    sizes = {len(v) for v in batch.values() if batched(v)}
    if len(sizes) != 1:
        raise ValueError(f"batch entries of leading sizes {sorted(sizes)}: expected one")
    cut = shard_slice(sizes.pop(), world, index)
    return {k: v[cut] if batched(v) else v for k, v in batch.items()}


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Consecutive runs of ``tensors`` of one dtype and device, each at most
    BUCKET_BYTES (a larger tensor alone)."""
    out: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        last = out[-1][-1] if out else None
        if (last is None or last.dtype != t.dtype or last.device != t.device
                or size + nbytes > BUCKET_BYTES):
            out.append([])
            size = 0
        out[-1].append(t)
        size += nbytes
    return out


def _reduce_(name: str, tensors: Sequence[torch.Tensor], scale: Optional[float]) -> None:
    for bucket in _buckets(tensors):
        flat = torch.cat([t.detach().reshape(-1) for t in bucket])
        stats.run(name, flat.numel() * flat.element_size(), flat.device, lambda: dist.all_reduce(flat))
        if scale is not None:
            flat.div_(scale)
        offset = 0
        with torch.no_grad():
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks (the JAX steps'
    ``pmean``), in place: packed into flat buckets, summed by one
    ``all_reduce`` each (gloo has no average), then divided by the world
    size. Every rank must pass tensors of the same shapes in the same order.
    Without a group, does nothing."""
    if is_distributed():
        _reduce_("all_reduce", tensors, float(world_size()))


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its sum over the ranks (``psum``), in place."""
    if is_distributed():
        _reduce_("all_reduce", tensors, None)


def all_gather_flat(local: torch.Tensor) -> torch.Tensor:
    """The ranks' 1-D ``local`` tensors (one size on every rank) concatenated
    in rank order (``all_gather(..., tiled=True)``). Without a group, ``local``."""
    if not is_distributed():
        return local
    full = local.new_empty(local.numel() * world_size())
    stats.run("all_gather", local.numel() * local.element_size(), local.device,
              lambda: dist.all_gather_into_tensor(full, local.contiguous()))
    return full


def gather_to_rank0(obj: Any) -> Optional[List[Any]]:
    """Every rank's ``obj`` (picklable, on the host), in rank order, on rank 0;
    None on the others. Without a group, ``[obj]``."""
    if not is_distributed():
        return [obj]
    out = [None] * world_size() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def barrier() -> None:
    if is_distributed():
        dist.barrier()
