"""Device meshes, the port of ``ffcnn_tpu/parallel/mesh.py``.

A mesh names the axes a pipeline splits its work over:

  * ``data``    -- the batch: each slot runs its own images, and inference
    needs no exchange between slots (``dp.py``);
  * ``spatial`` -- image rows: each slot owns a block of every blob's rows
    and gathers the halo rows each window needs from its neighbours
    (``dp.py::build_sharded_pipeline``);
  * ``model``   -- conv output channels: a sharded conv computes its slice
    of the filters on each slot (``build_sharded_pipeline``);
  * ``pipe``    -- pipeline stages (``pp.py``), appended as the minor axis
    when asked for, as in JAX.

A mesh is a grid of ``torch.device`` slots.  A device may fill several
slots (``["cuda:0"] * 4``, or ``["cpu"] * 8`` in the tests): the
counterpart of JAX's forced host device count, which lets one card run a
mesh's every path.  ``batch_sharding``, ``activation_sharding`` and
``replicated`` describe how a tensor is split over a mesh: for each of the
tensor's leading dimensions, the mesh axis it is split over.  The
pipelines take every split from them (``Sharding.block``) and place each
slot's part with ``Sharding.shard``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``; a bare ``"cuda"`` is the current
    card, so two spellings of one card are one slot device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An object array of ``torch.device`` slots with named axes, as a
    ``jax.sharding.Mesh``: ``devices``, ``axis_names`` and ``shape`` (axis
    name -> size, in axis order)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``, 1 where the mesh has no such axis."""
        return self.shape.get(axis, 1)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.devices.tolist() == other.devices.tolist())


def make_mesh(devices: Optional[Sequence] = None, *, model_parallel: int = 1,
              spatial_parallel: int = 1, pipeline_parallel: int = 1) -> Mesh:
    """A (data, spatial, model[, pipe]) mesh over ``devices`` (each a
    ``torch.device`` or its name; one may repeat), in JAX's order and
    reshape: ``pipeline_parallel`` > 1 appends the minor ``pipe`` axis.
    ``devices=None`` takes every visible card, and raises where there is
    none: a mesh never falls back to the CPU unasked."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh() takes every visible card and "
                               "there is none; pass devices= (the CPU "
                               "as ['cpu'] * n)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices)
    per = model_parallel * spatial_parallel * pipeline_parallel
    if n % per != 0:
        raise ValueError(
            f"{n} devices not divisible by model_parallel={model_parallel} "
            f"* spatial_parallel={spatial_parallel} "
            f"* pipeline_parallel={pipeline_parallel}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    if pipeline_parallel > 1:
        return Mesh(arr.reshape(n // per, spatial_parallel, model_parallel,
                                pipeline_parallel),
                    (DATA_AXIS, SPATIAL_AXIS, MODEL_AXIS, PIPE_AXIS))
    return Mesh(arr.reshape(n // per, spatial_parallel, model_parallel),
                (DATA_AXIS, SPATIAL_AXIS, MODEL_AXIS))


def slot_devices(device: str = "cuda") -> list:
    """The mesh devices a command line asks for: one slot a visible card,
    or one CPU slot for ``device="cpu"``.  No card and ``device="cuda"``
    raises."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError("no CUDA device for the mesh")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class Sharding(NamedTuple):
    """How a tensor is split over a mesh, as a ``NamedSharding``:
    ``spec[i]`` is the mesh axis its dimension i is split over (None:
    whole), trailing dimensions whole; ``spec == ()`` is a tensor every
    slot holds whole."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def block(self, dim: int, size: int, i: int) -> Tuple[int, int]:
        """The range [lo, hi) of dimension ``dim`` (``size`` long) that
        slot ``i`` of its mesh axis holds: even contiguous blocks of
        ceil(size / parts), the last ones short or empty; (0, size) where
        the dimension is whole."""
        axis = self.spec[dim] if dim < len(self.spec) else None
        if axis is None:
            return 0, size
        blk = -(-size // self.mesh.axis_size(axis))
        return min(size, i * blk), min(size, (i + 1) * blk)

    def shard(self, t: torch.Tensor, idx: tuple) -> torch.Tensor:
        """The block of ``t`` that the slot at mesh coordinates ``idx``
        holds, on that slot's device (``jax.device_put``'s part for one
        slot)."""
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                lo, hi = self.block(dim, t.shape[dim],
                                    idx[self.mesh.axis_names.index(axis)])
                t = t.narrow(dim, lo, hi - lo)
        return t.to(self.mesh.devices[idx])


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) dimension split over ``data``; the rest whole."""
    return Sharding(mesh, (DATA_AXIS,))


def activation_sharding(mesh: Mesh) -> Sharding:
    """(N, H, W, C) activations: the batch over ``data``, the rows over
    ``spatial`` (the batch alone where the mesh has no spatial axis of
    size > 1)."""
    if mesh.axis_size(SPATIAL_AXIS) > 1:
        return Sharding(mesh, (DATA_AXIS, SPATIAL_AXIS))
    return batch_sharding(mesh)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
