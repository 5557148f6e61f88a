"""A batch split over the ``dp`` shards of a mesh, carried through a
model layer by layer.

JAX's SPMD step runs one program on every shard, and where a layer
reduces over the whole batch (BatchNorm's statistics in train mode) XLA
inserts an all-reduce.  Here one process carries a :class:`ShardList`,
one tensor per shard on the shard's device, through the model's own
``forward``: each torch function or tensor method it meets is applied
shard by shard (``__torch_function__``), and every other tensor argument
(a parameter, a buffer) is copied to the shard's device.  ``Tensor.to``
is differentiable and a no-op where the tensor already lives, so the
gradients of those copies add up on the master tensors in the one
backward: the all-reduce of a replicated parameter's gradient.  A layer
that reduces over the batch checks for a :class:`ShardList` and reduces
over every shard (``models.layers.BatchNorm``).

There are no threads: the shards' operations are issued in turn, and on
a mesh of distinct devices they run at once, each on its device.
"""

from __future__ import annotations

import operator
from typing import Any, List, Sequence

import torch


def _at(obj: Any, i: int, device: torch.device) -> Any:
    """``obj`` as shard ``i`` sees it: a ShardList's shard i, any other
    tensor copied to ``device``, containers element by element."""
    if isinstance(obj, ShardList):
        return obj.shards[i]
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if type(obj) in (list, tuple):
        return type(obj)(_at(v, i, device) for v in obj)
    if isinstance(obj, dict):
        return {k: _at(v, i, device) for k, v in obj.items()}
    return obj


def _find(obj: Any):
    """The first ShardList in ``obj`` (arguments, nested)."""
    if isinstance(obj, ShardList):
        return obj
    if isinstance(obj, (list, tuple)):
        obj = list(obj)
    elif isinstance(obj, dict):
        obj = list(obj.values())
    else:
        return None
    for v in obj:
        found = _find(v)
        if found is not None:
            return found
    return None


def _gather(outs: List[Any]) -> Any:
    """Per-shard results as one: tensors a ShardList, tuples element by
    element, anything else the one value every shard gave."""
    if isinstance(outs[0], torch.Tensor):
        return ShardList(outs)
    if type(outs[0]) is tuple:
        return tuple(_gather(list(col)) for col in zip(*outs))
    if any(o != outs[0] for o in outs[1:]):
        raise ValueError(f"the shards disagree: {outs}")
    return outs[0]


def each(fn, args: Sequence = (), kwargs=None) -> Any:
    """``fn`` applied shard by shard to ``args`` / ``kwargs``, which hold
    at least one ShardList (see :func:`_at`)."""
    kwargs = kwargs or {}
    devices = _find((args, kwargs)).devices
    return _gather([fn(*_at(args, i, d), **_at(kwargs, i, d)) for i, d in enumerate(devices)])


class ShardList:
    """One tensor per ``dp`` shard, each on its own device, standing for
    their concatenation along the batch axis."""

    def __init__(self, shards: Sequence[torch.Tensor]):
        self.shards = list(shards)

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return each(func, args, kwargs)

    def __getattr__(self, name: str):
        """Tensor methods and attributes, shard by shard."""
        if name.startswith("__") or name == "shards":
            raise AttributeError(name)
        attrs = [getattr(s, name) for s in self.shards]
        if not callable(attrs[0]):
            return _gather(attrs)

        def method(*args, **kwargs):
            return _gather([a(*_at(args, i, s.device), **_at(kwargs, i, s.device))
                            for i, (a, s) in enumerate(zip(attrs, self.shards))])

        return method

    def __add__(self, other):
        return each(operator.add, (self, other))

    def __radd__(self, other):
        return each(operator.add, (other, self))

    def __mul__(self, other):
        return each(operator.mul, (self, other))

    def __rmul__(self, other):
        return each(operator.mul, (other, self))

    def __repr__(self) -> str:
        return f"ShardList({[tuple(s.shape) for s in self.shards]}, {self.devices})"
