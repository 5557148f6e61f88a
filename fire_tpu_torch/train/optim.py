"""Optax's gradient transformations, as the trainers of
``fire_tpu.train`` use them, written in torch with optax's formulas
(``optax`` 0.2: ``scale_by_adam``, ``add_decayed_weights``,
``scale_by_learning_rate``, ``clip_by_global_norm``, ``chain``,
``cosine_decay_schedule``).

A transformation is ``init(params) -> state`` and ``update(updates,
state, params) -> (updates, state)`` over a *list* of tensors, the
trained tensors in a fixed order (a model's ``parameters()``, then the
ArcFace classifier).  States are NamedTuples named and shaped as
optax's (``ScaleByAdamState(count, mu, nu)``, ``EmptyState()``,
``ScaleByScheduleState(count)``, a tuple for a chain), so a JAX train
state carries across (:func:`fire_tpu_torch.weights.carry_state`).
Counts are Python ints; the moment tensors are updated in place.  The
tensors of one list may live on several devices (the classifier's
column blocks of a sharded ArcFace state, each with its moments on its
own device): ``torch._foreach_*`` then takes its per-tensor route, and
the one reduction across tensors, ``clip_by_global_norm``'s, gathers
the norms on one device.

Where optax differs from ``torch.optim``, this follows optax:

* ``adamw`` decays every tensor (classifier, BatchNorm scale and bias,
  conv biases) with ``weight_decay=1e-4`` by default, added to the Adam
  direction before the learning rate: ``p -= lr·(m̂/(√v̂ + eps) + wd·p)``.
* ``clip_by_global_norm(c)`` scales by ``c/‖g‖`` only when ``‖g‖ ≥ c``.
* A schedule is evaluated at the 0-based update count.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Union

import numpy as np
import torch

Tensors = List[torch.Tensor]
Schedule = Callable[[int], float]


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: int
    mu: Tensors
    nu: Tensors


class ScaleByScheduleState(NamedTuple):
    count: int


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors], Any]


def _by_device(tensors: Tensors) -> dict:
    """The indices of ``tensors`` grouped by device, in order."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    return groups


def _empty_init(params: Tensors) -> EmptyState:
    return EmptyState()


def _bias_correction(decay: float, count: int) -> float:
    """``1 − decay**count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """Adam's direction ``m̂ / (√(v̂ + eps_root) + eps)`` with bias-corrected
    moments ``m = b1·m + (1−b1)·g`` and ``v = b2·v + (1−b2)·g²``."""

    def init(params):
        return ScaleByAdamState(0, [torch.zeros_like(p, memory_format=torch.preserve_format)
                                    for p in params],
                                [torch.zeros_like(p, memory_format=torch.preserve_format)
                                 for p in params])

    def update(updates, state, params=None):
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, updates, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, updates, updates, value=1.0 - b2)
        count = state.count + 1
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
        den = torch._foreach_div(nu, _bias_correction(b2, count))
        if eps_root:
            torch._foreach_add_(den, eps_root)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        return torch._foreach_div(mu_hat, den), ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """``updates + weight_decay · params``."""

    def update(updates, state, params):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        decayed = torch._foreach_add(updates, [p.detach() for p in params], alpha=weight_decay)
        return decayed, state

    return GradientTransformation(_empty_init, update)


def scale_by_learning_rate(learning_rate: Union[float, Schedule]) -> GradientTransformation:
    """``−lr · updates``; a schedule is read at the update count (0 first)."""
    if callable(learning_rate):
        def init(params):
            return ScaleByScheduleState(0)

        def update(updates, state, params=None):
            step = -float(learning_rate(state.count))
            return torch._foreach_mul(updates, step), ScaleByScheduleState(state.count + 1)

        return GradientTransformation(init, update)

    def update_const(updates, state, params=None):
        return torch._foreach_mul(updates, -float(learning_rate)), state

    return GradientTransformation(_empty_init, update_const)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every update by ``max_norm / ‖g‖`` when the global norm
    ``‖g‖`` (over all tensors) is at least ``max_norm``; else pass.  The
    tensors may live on several devices (a sharded train state): the
    norms are reduced on the first tensor's device and the factor is
    copied to each device."""

    def update(updates, state, params=None):
        home = updates[0].device
        norms = [n.to(home) for n in torch._foreach_norm(updates)]
        g_norm = torch.linalg.vector_norm(torch.stack(norms))
        factor = torch.where(g_norm < max_norm, 1.0, max_norm / g_norm)
        scaled = list(updates)
        for dev, idx in _by_device(updates).items():
            for i, u in zip(idx, torch._foreach_mul([updates[i] for i in idx], factor.to(dev))):
                scaled[i] = u
        return scaled, state

    return GradientTransformation(_empty_init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Apply ``transforms`` in order; the state is the tuple of theirs."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


def adam(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps, eps_root), scale_by_learning_rate(learning_rate))


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps, eps_root), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    """``init · ((1−alpha)·(½(1 + cos(π·min(t, T)/T)))**exponent + alpha)``."""
    if not decay_steps > 0:
        raise ValueError(
            f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps=}.")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """``params += updates``, in place."""
    torch._foreach_add_(params, updates)
