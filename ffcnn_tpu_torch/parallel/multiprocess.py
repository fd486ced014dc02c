"""Data parallelism across processes, the port of
``ffcnn_tpu/parallel/multiprocess.py``.

Detection needs no exchange between images, so processes exchange no
tensor: each runs its own mesh (``make_mesh`` over the devices it drives)
on its own images.  The process group (gloo) carries host metadata only:
the device census at start-up and each process's image count, from which
``global_batch`` gives this process's offset in the global batch.

Two recipes, as in JAX:

* One process a card (serving): independent ``python -m
  ffcnn_tpu_torch.serve`` workers behind a load balancer; this module is
  not needed.
* One process a host (batch throughput):

      info = init_distributed()          # torchrun's environment
      mesh = make_mesh()                 # this process's cards
      fn, place = build_sharded_pipeline(ir, mesh, h, w)
      batch = global_batch(mesh, local_images)
      start, res = local_results(fn(place(params), batch, mean, norm))

``tests/test_torch_multiprocess.py`` runs this with two processes of two
CPU slots each over a loopback address.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.nms import NMSResult
from .mesh import DATA_AXIS


@dataclasses.dataclass(frozen=True)
class ProcInfo:
    process_index: int
    process_count: int
    local_devices: int
    global_devices: int


class LocalBatch(NamedTuple):
    """This process's images of a global batch: rows [start, start + len)
    of ``total``.  The pipelines of ``dp.py`` and ``pp.py`` take it in
    place of a batch and give a ``LocalResult``."""
    images: object
    start: int
    total: int


class LocalResult(NamedTuple):
    """A pipeline's result on a ``LocalBatch``: its rows start at
    ``start`` of the global batch."""
    start: int
    result: NMSResult


_STATE: dict = {}


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     devices: Optional[Sequence] = None) -> ProcInfo:
    """Join this process to the group: gloo over ``coordinator``
    (``host:port``), ``num_processes`` processes, this one ``process_id``.
    The arguments default to torchrun's environment (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  ``devices``: the devices
    this process drives (default: every visible card), counted into the
    census.  A second call is a no-op that returns the topology."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if coordinator is None and os.environ.get("MASTER_ADDR") \
                and os.environ.get("MASTER_PORT"):
            coordinator = (f"{os.environ['MASTER_ADDR']}:"
                           f"{os.environ['MASTER_PORT']}")
        if num_processes is None and os.environ.get("WORLD_SIZE"):
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None and os.environ.get("RANK"):
            process_id = int(os.environ["RANK"])
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError("init_distributed needs the coordinator "
                             "address, the process count and this rank (or "
                             "MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
        local = (len(devices) if devices is not None
                 else torch.cuda.device_count())
        census = [None] * num_processes
        dist.all_gather_object(census, local)
        _STATE.update(local=local, census=census)
    return ProcInfo(process_index=dist.get_rank(),
                    process_count=dist.get_world_size(),
                    local_devices=_STATE["local"],
                    global_devices=sum(_STATE["census"]))


def shutdown_distributed() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.clear()


def global_batch(mesh, local_images) -> LocalBatch:
    """This process's part of the global batch: ``local_images`` (uint8
    (n, H, W, 3), n a multiple of the mesh's data axis) with its global
    offset.  Every process must contribute the same n, as in JAX; outside
    a process group the batch is the whole."""
    import torch.distributed as dist

    n = int(local_images.shape[0])
    nd = mesh.axis_size(DATA_AXIS)
    if n % nd:
        raise ValueError(f"{n} local images do not split over the mesh's "
                         f"data axis {nd}")
    if not dist.is_initialized():
        return LocalBatch(local_images, 0, n)
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, n)
    if len(set(counts)) != 1:
        raise ValueError(f"every process must contribute the same number of "
                         f"images, got {counts}")
    rank = dist.get_rank()
    return LocalBatch(local_images, rank * n, n * len(counts))


def local_results(res):
    """``(first global row, this process's rows as host numpy arrays)`` of
    a pipeline's result on a ``LocalBatch`` (a plain ``NMSResult`` starts
    at 0)."""
    start, r = ((res.start, res.result) if isinstance(res, LocalResult)
                else (0, res))
    return start, NMSResult(*(np.asarray(t.cpu()) for t in r))
