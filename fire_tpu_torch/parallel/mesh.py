"""Device mesh (counterpart of ``fire_tpu.parallel.mesh``).

Axes as in JAX: ``dp`` (data parallel: streams, gallery rows) and ``mp``
(model parallel).  A mesh is a grid of ``torch.device``s driven by this
one process; the same device may appear more than once, which is how
several streams or gallery shards share one card (and how the CPU tests
get eight "devices").
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def canonical_device(device) -> torch.device:
    """``cuda`` with its index filled in (the current device), so that a
    tensor's device and the name it was placed by compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A (dp, mp) grid of devices with named axes."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str = "dp") -> list:
        """One device per index of ``axis`` (the first along the others):
        where that index's shard or stream lives."""
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return [row.reshape(-1)[0] for row in grid]

    def distinct_devices(self) -> list:
        """Every device of the mesh once, in mesh order."""
        out = []
        for d in self.devices.reshape(-1):
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Sequence[str] = ("dp", "mp"),
    devices=None,
) -> Mesh:
    """A 2-D (dp, mp) mesh.  ``devices`` defaults to every CUDA device and
    raises when there is none; ``shape=None`` puts them all on ``dp``."""
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cuda == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices=[...] (e.g. ['cpu'] * 8) to build "
                "a mesh without one.")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = [canonical_device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axis_names)


# ------------------------------------------------------------- collectives --
# One process drives every device of a mesh, so a collective is a few
# copies: ``Tensor.to`` is differentiable (its gradient goes back to the
# source device) and a no-op where the tensor already lives, so the same
# code runs on a mesh that repeats one device.


def sum_to(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of ``tensors`` (one per shard, on any devices) on
    ``device``, added in list order; the gradient of the sum reaches
    every term on its own device."""
    total = tensors[0].to(device)
    for t in tensors[1:]:
        total = total + t.to(device)
    return total


def broadcast(tensor: torch.Tensor, devices: Sequence) -> list:
    """``tensor`` on each of ``devices`` (the tensor itself where it
    already lives); the gradients of the copies sum into it, which is
    the all-reduce of a replicated tensor's gradient."""
    return [tensor.to(d) for d in devices]


def column_devices(mesh: Mesh) -> list:
    """The device of each ``mp`` column block: the first row of the
    mesh (``dp`` index 0), as ``PartitionSpec(None, "mp")`` puts column
    block j on ``devices[:, j]`` and its master copy lives on the first."""
    return list(mesh.devices[0, :])


def split_columns(tensor: torch.Tensor, devices: Sequence) -> list:
    """``tensor`` (…, C) as column blocks of ``ceil(C / len(devices))``
    columns, block j a contiguous copy on ``devices[j]``; the last block
    holds fewer where ``len(devices)`` does not divide C (XLA pads), and
    fewer blocks than devices are made where C is that small.  Blocks of
    a tensor that requires grad are leaves that require grad."""
    width = -(-tensor.shape[-1] // len(devices))
    blocks = torch.split(tensor.detach(), width, dim=-1)
    return [b.to(device=d, memory_format=torch.contiguous_format, copy=True)
            .requires_grad_(tensor.requires_grad) for b, d in zip(blocks, devices)]
