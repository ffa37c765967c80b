"""A (data, model) mesh of ``torch.device``s and the collectives over it.

Counterpart of ``avenir_tpu/parallel/mesh.py``.  The reference runs every
multi-device engine as one SPMD program under ``shard_map``: rows shard
over the ``data`` axis, candidate rows of the O(n^2) kNN engines over
``model``, and shards exchange data through ``psum``, ``all_gather`` and
``ppermute``.  The port keeps the reference's single controller: one
process holds the mesh and drives every shard in turn, each on its own
device, so an engine is called once and returns every row, as the
reference's is.

A mesh may name one device more than once.  ``[cuda:0] * 4`` runs a
four-way ring or a 2 x 2 engine on one card (every hop and every kernel
launch of the four-device program, with no bytes moving between cards),
and ``[cpu] * 8`` is the counterpart of the eight virtual CPU devices of
the reference's tests.  The repeats show in the mesh's ``repr``.

A shard is a tensor on its device; a collective takes one tensor per
shard and returns one per shard.  Each copy between devices is issued
with ``non_blocking=True`` under the target device's context, and PyTorch
orders it against the current streams of both devices.  A mesh is all
CUDA devices or all the CPU, so a CUDA mesh never routes a tensor through
the host and never falls back to the CPU.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

AXES = ("data", "model")


class Mesh:
    """A ``(data, model)`` grid of devices: ``devices[i, j]`` (a numpy
    object array, as ``jax.sharding.Mesh.devices``) runs data shard ``i``
    against model shard ``j``.  ``shape`` maps each axis name to its
    size."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        types = {d.type for d in devices.flat}
        if not types <= {"cpu", "cuda"}:
            raise ValueError(f"unsupported mesh devices {sorted(types)}: use "
                             f"CUDA devices or the CPU")
        if len(types) > 1:
            raise ValueError("a mesh is all CUDA devices or all the CPU, "
                             "never both")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def repeated(self) -> bool:
        """True when some device holds more than one position."""
        return len(set(self.devices.flat)) < self.size

    def axis_devices(self, axis: Union[str, Tuple[str, ...]] = "data"
                     ) -> List[torch.device]:
        """The device of each shard along ``axis``: ``'data'`` (row i of
        the grid, its first device), ``'model'`` (column j, its first
        device) or ``('data', 'model')`` (every position, row-major)."""
        if axis == "data":
            return list(self.devices[:, 0])
        if axis == "model":
            return list(self.devices[0, :])
        if tuple(axis) == AXES:
            return list(self.devices.flat)
        raise ValueError(f"unknown mesh axis {axis!r}; use 'data', 'model' "
                         f"or ('data', 'model')")

    def __repr__(self) -> str:
        names = sorted({str(d) for d in self.devices.flat})
        note = ", devices repeated" if self.repeated else ""
        return (f"Mesh({self.shape['data']}x{self.shape['model']} over "
                f"{', '.join(names)}{note})")


def _normalize(device) -> torch.device:
    from ..device import resolve_device
    if device is None:
        raise ValueError("a mesh position needs a device")
    return resolve_device(device)


def make_mesh(devices: Optional[Sequence] = None, data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """Build a ``(data, model)`` mesh over the given devices (default:
    every visible CUDA card; none raises).  Devices may repeat."""
    if devices is None:
        from ..device import resolve_device
        resolve_device()                    # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_normalize(d) for d in devices]
    n = len(devs)
    if data is None:
        data = n // model
    if data * model != n or n == 0:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(data, model))


def get_mesh() -> Mesh:
    """The default mesh: ``AVENIR_MESH=<data>x<model>`` over every visible
    CUDA card when set (data x model must equal the card count), else one
    ``cuda:0``.  Raises without a card."""
    spec = os.environ.get("AVENIR_MESH")
    if not spec:
        from ..device import resolve_device
        return make_mesh([resolve_device()])
    try:
        data_s, model_s = spec.lower().split("x")
        return make_mesh(data=int(data_s), model=int(model_s))
    except (ValueError, TypeError) as e:
        raise ValueError(
            f"bad AVENIR_MESH={spec!r}; expected <data>x<model> with "
            f"data*model == device count ({torch.cuda.device_count()})"
        ) from e


def pad_rows(arr: np.ndarray, multiple: int,
             fill=0) -> Tuple[np.ndarray, np.ndarray]:
    """Pad axis 0 to a multiple of ``multiple`` so rows shard evenly;
    returns the padded array and a bool validity mask (False on the
    padding rows, which the count kernels drop)."""
    n = arr.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    mask = np.zeros(target, dtype=bool)
    mask[:n] = True
    if target == n:
        return arr, mask
    pad_width = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill), mask


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself where it already lies there, else a
    non-blocking copy issued under the target device's context."""
    if t.device == device:
        return t
    if device.type == "cuda":
        with torch.cuda.device(device):
            return t.to(device, non_blocking=True)
    return t.to(device)


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr))


def split_rows(arr, n: int) -> List:
    """``arr`` cut along axis 0 into ``n`` pieces of ``ceil(rows / n)``
    rows, the last pieces shorter or empty: the reference's row shards
    without the padding.  Piece ``s`` starts at row ``s * ceil(rows / n)``,
    the global index base of its rows."""
    step = -(-arr.shape[0] // n)
    return [arr[s * step:(s + 1) * step] for s in range(n)]


def shard_rows(arr, mesh: Optional[Mesh] = None,
               axis: Union[str, Tuple[str, ...]] = "data"
               ) -> List[torch.Tensor]:
    """Host rows (or a tensor) cut along axis 0 into one contiguous block
    per shard of ``axis``, each on its shard's device.  The row count must
    divide evenly (``pad_rows`` first), as the reference requires."""
    mesh = mesh or get_mesh()
    devs = mesh.axis_devices(axis)
    t = _as_tensor(arr)
    if t.shape[0] % len(devs):
        raise ValueError(f"{t.shape[0]} rows do not shard evenly over "
                         f"{len(devs)} shards; pad them first (pad_rows)")
    return [to_device(b.contiguous(), dev)
            for b, dev in zip(split_rows(t, len(devs)), devs)]


def shard_grid(arr, mesh: Mesh, axis: Optional[str] = None
               ) -> List[List[torch.Tensor]]:
    """What each mesh position holds of ``arr``: ``grid[i][j]`` is piece
    ``i`` (``axis='data'``) or ``j`` (``'model'``) of ``split_rows``, or
    the whole of ``arr`` (``None``), on ``devices[i, j]``; positions on one
    device share one copy."""
    t = _as_tensor(arr)
    d, m = mesh.devices.shape
    parts = split_rows(t, {"data": d, "model": m}[axis]) if axis else [t]
    placed = {}
    grid = []
    for i in range(d):
        row = []
        for j in range(m):
            key = ({"data": i, "model": j}[axis] if axis else 0,
                   mesh.devices[i, j])
            if key not in placed:
                placed[key] = to_device(parts[key[0]].contiguous(), key[1])
            row.append(placed[key])
        grid.append(row)
    return grid


def replicate(arr, mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """One copy of ``arr`` per mesh position (row-major), each on that
    position's device; positions on one device share one tensor."""
    mesh = mesh or get_mesh()
    t = _as_tensor(arr)
    placed = {}
    for dev in mesh.devices.flat:
        if dev not in placed:
            placed[dev] = to_device(t, dev)
    return [placed[dev] for dev in mesh.devices.flat]


def ppermute_ring(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One hop of the ring: shard ``i`` receives shard ``i + 1``'s block
    (mod the shard count), on shard ``i``'s device: the reference's
    ``ppermute`` with ``perm = [((i + 1) % d, i)]``."""
    d = len(blocks)
    return [to_device(blocks[(i + 1) % d], blocks[i].device)
            for i in range(d)]


def gather(blocks: Sequence[torch.Tensor], device: torch.device,
           dim: int = 0) -> torch.Tensor:
    """Every shard's block laid side by side along ``dim``, on
    ``device``."""
    return torch.cat([to_device(b, device) for b in blocks], dim=dim)


def all_gather(blocks: Sequence[torch.Tensor], dim: int = 0
               ) -> List[torch.Tensor]:
    """``gather`` on each shard's device (the reference's
    ``all_gather(..., tiled=True)``); shards on one device share one
    result."""
    done = {}
    for b in blocks:
        if b.device not in done:
            done[b.device] = gather(blocks, b.device, dim)
    return [done[b.device] for b in blocks]


def psum(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of every shard's block, added left to right on the first
    shard's device, then placed on each shard's device."""
    dev = blocks[0].device
    total = blocks[0].clone()
    for b in blocks[1:]:
        total += to_device(b, dev)
    placed = {dev: total}
    for b in blocks:
        if b.device not in placed:
            placed[b.device] = to_device(total, b.device)
    return [placed[b.device] for b in blocks]
