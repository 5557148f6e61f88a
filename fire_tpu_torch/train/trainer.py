"""The ArcFace training step on one device (counterpart of
``fire_tpu.train.trainer``).

The parameters and BatchNorm statistics live in the model: a
:class:`TrainState` holds the model's own tensors (``params`` in the
order of ``model.parameters()``, ``batch_stats`` the running means and
variances), the (D, C) ArcFace ``classifier``, the optimizer state of
:mod:`fire_tpu_torch.train.optim` over ``params + [classifier]`` and the
step count.  A step updates them in place and returns the next state.

Compute follows Flax's ``dtype=bf16`` models: the master parameters and
Adam moments stay float32, and ``compute_dtype=torch.bfloat16`` runs the
forward's convolutions and matmuls in bf16 under ``torch.autocast``
(BatchNorm normalises in float32 and the ArcFace product is float32
either way).  ``None`` computes in float32, as the parity tests do.

JAX's step can shard over a dp×mp mesh (batch over ``dp``, classifier
columns over ``mp``); that step is not ported (``ROADMAP.md`` §1, "the
dp×mp-sharded ArcFace step"), and ``make_train_step`` refuses a mesh of
more than one device rather than train on one.

Checkpoints are the port's own: ``<dir>/step_<N>/state.msgpack``, the
whole state through :func:`fire_tpu_torch.weights.msgpack_serialize`,
written to a temporary file and moved into place.  Orbax checkpoints of
the JAX trainer are not read.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fire_tpu_torch.models.layers import BatchNorm
from fire_tpu_torch.train.losses import arcface_logits
from fire_tpu_torch.train.optim import GradientTransformation, apply_updates
from fire_tpu_torch.weights import (flax_shapes, load_flax, materialize, msgpack_serialize,
                                    read_msgpack)

# The numpy-init seed JAX's ``init_state`` draws for ``PRNGKey(0)``:
# ``int(jax.random.randint(split(PRNGKey(0))[0], (), 0, 2**31 - 1))``.
JAX_INIT_SEED = 447923887


class TrainState(NamedTuple):
    params: List[torch.Tensor]
    batch_stats: List[torch.Tensor]
    classifier: torch.Tensor  # (D, C)
    opt_state: Any
    step: int


def model_batch_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    """The running means and variances of every BatchNorm, in order."""
    return [t for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


def cli_compute_dtype(device: torch.device) -> Optional[torch.dtype]:
    """The command lines' compute dtype: bf16 on the card, as the JAX
    CLIs' ``dtype=bf16`` models; float32 on the CPU, whose bf16
    convolutions (and their gradients) run slower than float32 ones."""
    return torch.bfloat16 if device.type == "cuda" else None


def compute_context(device: torch.device, compute_dtype: Optional[torch.dtype]):
    """``torch.autocast`` to ``compute_dtype`` (None or float32: none)."""
    if compute_dtype in (None, torch.float32):
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def init_state(model: torch.nn.Module, seed: int, num_classes: int,
               optimizer: GradientTransformation, classifier_seed: int = 0) -> TrainState:
    """Fill ``model`` (float32, on its device) with the JAX engine's
    numpy init (:func:`fire_tpu_torch.weights.materialize` at ``seed``;
    :data:`JAX_INIT_SEED` is the seed JAX's ``init_state(PRNGKey(0))``
    uses), and draw the classifier as ``N(0, 1)·0.01`` from a torch
    generator seeded with ``classifier_seed`` (JAX draws it from its own
    key: the two classifiers differ)."""
    model.float()
    load_flax(model, materialize(flax_shapes(model), seed))
    dev = next(model.parameters()).device
    g = torch.Generator().manual_seed(classifier_seed)
    classifier = (torch.randn(model.embed_dim, num_classes, generator=g) * 0.01).to(dev)
    classifier.requires_grad_(True)
    params = list(model.parameters())
    return TrainState(params, model_batch_stats(model), classifier,
                      optimizer.init(params + [classifier]), 0)


def arcface_loss(model: torch.nn.Module, classifier: torch.Tensor, images: torch.Tensor,
                 labels: torch.Tensor, margin: float = 0.5, scale: float = 64.0,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Mean softmax cross-entropy of the ArcFace logits of
    ``model(images, train=True)``; updates the BatchNorm statistics."""
    with compute_context(images.device, compute_dtype):
        emb = model(images, train=True)
    logits = arcface_logits(emb, classifier, labels, margin, scale)
    return F.cross_entropy(logits, labels.long())


def make_train_step(model: torch.nn.Module, optimizer: GradientTransformation, mesh=None,
                    margin: float = 0.5, scale: float = 64.0,
                    compute_dtype: Optional[torch.dtype] = None):
    """``step(state, images (B,H,W,3) [0,1], labels (B,)) → (state,
    loss)``: one ArcFace step on one device, the optimizer's target the
    tuple (params, classifier) as in JAX."""
    if mesh is not None and mesh.devices.size > 1:
        raise NotImplementedError(
            "the dp×mp-sharded ArcFace step is not ported yet (ROADMAP.md §1, "
            "'the dp×mp-sharded ArcFace step'); pass mesh=None to train on one device")

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        loss = arcface_loss(model, state.classifier, images, labels, margin, scale,
                            compute_dtype)
        opt_state = optimizer_step(optimizer, state.params + [state.classifier],
                                   state.opt_state, loss)
        return state._replace(opt_state=opt_state, step=state.step + 1), loss.detach()

    return step


def optimizer_step(optimizer: GradientTransformation, target: List[torch.Tensor],
                   opt_state: Any, loss: torch.Tensor) -> Any:
    """Differentiate ``loss`` by ``target``, update ``target`` in place
    with ``optimizer`` and return its new state."""
    grads = torch.autograd.grad(loss, target)
    with torch.no_grad():
        updates, opt_state = optimizer.update(list(grads), opt_state, target)
    apply_updates(target, updates)
    return opt_state


# ------------------------------------------------------------- checkpoints --


def state_tree(x: Any) -> Any:
    """A state (tensors, ints, lists, tuples, NamedTuples) as msgpack-able
    numpy trees: NamedTuples become dicts of their fields."""
    if isinstance(x, torch.Tensor):
        return np.ascontiguousarray(x.detach().cpu().numpy())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: state_tree(v) for f, v in zip(x._fields, x)}
    if isinstance(x, (list, tuple)):
        return [state_tree(v) for v in x]
    if isinstance(x, (int, float)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def restore_tree(target: Any, tree: Any) -> Any:
    """The inverse of :func:`state_tree` into ``target``'s structure:
    tensors are overwritten in place (shapes must agree), ints replaced."""
    if isinstance(target, torch.Tensor):
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"checkpoint shape {arr.shape} != state {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(arr.copy()))
        return target
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(restore_tree(v, tree[f]) for f, v in zip(target._fields, target)))
    if isinstance(target, (list, tuple)):
        if len(tree) != len(target):
            raise ValueError(f"checkpoint holds {len(tree)} entries, the state {len(target)}")
        return type(target)(restore_tree(t, v) for t, v in zip(target, tree))
    return type(target)(tree)


def save_checkpoint(path: str, state: Any) -> None:
    """Write ``state`` to ``<path>/state.msgpack`` atomically."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "state.msgpack")
    with open(out + ".tmp", "wb") as f:
        f.write(msgpack_serialize(state_tree(state)))
    os.replace(out + ".tmp", out)


def restore_checkpoint(path: str, target: Any) -> Any:
    """Read ``<path>/state.msgpack`` into ``target`` (a state of the same
    model and optimizer) and return the restored state."""
    return restore_tree(target, read_msgpack(os.path.join(path, "state.msgpack")))


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest complete ``step_<N>`` checkpoint under ``directory``."""
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        int(d.split("_", 1)[1]) for d in os.listdir(directory)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
        and os.path.exists(os.path.join(directory, d, "state.msgpack")))
    return os.path.join(directory, f"step_{steps[-1]}") if steps else None
