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

JAX jits the step; on a card the one-device step replays a CUDA graph
per key (:class:`~fire_tpu_torch.runtime.graphs.GraphedStep`), captured
at the key's first call: the batch is copied into the graph's static
inputs, the state is updated in place by the replay, and the loss comes
back as a clone of the graph's output.  On the CPU the step runs
eagerly, and the eager step is the graph's plain version.

With a mesh of more than one device the step is JAX's dp×mp-sharded
one (:func:`state_shardings`), driven by this one process as JAX's
single controller drives its mesh:

* the global batch splits over ``dp``; one forward of the model
  carries every shard, each on its device
  (:class:`~fire_tpu_torch.parallel.shards.ShardList`), reading the
  master parameters (on the mesh's first device, in the model) through
  differentiable copies, and its BatchNorms take the statistics of the
  whole batch;
* the classifier is a list of column blocks, block j (``ceil(C/mp)``
  columns; the last may hold fewer) and its Adam moments on the first
  row's device j; each ``(dp, mp)`` position forms its block of ArcFace
  logits, and the softmax's normaliser is reduced over ``mp``
  (:func:`~fire_tpu_torch.train.losses.column_sharded_cross_entropy`);
* one backward from the summed loss carries every gradient home: the
  copies' gradients add up on the master tensors, which is the
  all-reduce over ``dp``; then one optimizer update, each block's on
  its own device.

It computes the one-device step's arithmetic, the order of the sums
aside.  Its backward runs on the calling thread
(``torch.autograd.set_multithreading_enabled(False)``), from one queue
of the autograd engine ordered by the nodes' creation: by default the
engine runs each card's backward on a thread of its own, and a gradient
that gathers three or more terms from several cards (a master tensor
read by every shard, a BatchNorm's statistics, an activation feeding
several branches) adds them in the order they arrive, so two runs from
one state would differ over distinct cards.  The one-device step keeps
the engine's default.

JAX jits the step as one program (``in_shardings`` over the mesh); the
port runs it as a :class:`~fire_tpu_torch.runtime.graphs.GraphedStep`
too.  An unsharded state is laid out on the mesh first
(:func:`shard_state`, outside any graph; the same unsharded state
passed again is laid out into the same tensors, and a state laid out
for another mesh raises), then the key is taken: the batch's shapes and
dtypes and the laid-out state's tensors by identity.  The key's graph
holds the whole step, every shard's forward, the BatchNorms' sums over
the shards, the column-sharded softmax, the backward and the AdamW
update, replayed with no host read: on a mesh that repeats one card
(``["cuda:0"] * 4``) on that card, over distinct cards as one graph
over every card of the mesh (the first card's capture with each other
card's side stream forked from it and joined back).

On the CPU the step runs eagerly, and the eager step is the graph's
plain version.

Checkpoints are the port's own: ``<dir>/step_<N>/state.msgpack``, the
whole state through :func:`fire_tpu_torch.weights.msgpack_serialize`,
written to a temporary file and moved into place.  A sharded state is
written gathered (the whole classifier and moments, as orbax writes
global arrays), so a checkpoint resumes on any mesh or on none.  Orbax
checkpoints of the JAX trainer are not read.
"""

from __future__ import annotations

import contextlib
import os
import weakref
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves

from fire_tpu_torch.models.layers import BatchNorm
from fire_tpu_torch.parallel.mesh import (Mesh, broadcast, canonical_device, column_devices,
                                          split_columns, sum_to)
from fire_tpu_torch.parallel.shards import ShardList
from fire_tpu_torch.runtime.graphs import GraphedStep
from fire_tpu_torch.train.losses import arcface_logits, column_sharded_cross_entropy
from fire_tpu_torch.train.optim import GradientTransformation, apply_updates
from fire_tpu_torch.weights import (flax_shapes, load_flax, materialize, msgpack_serialize,
                                    read_msgpack)

# The numpy-init seed JAX's ``init_state`` draws for ``PRNGKey(0)``:
# ``int(jax.random.randint(split(PRNGKey(0))[0], (), 0, 2**31 - 1))``.
JAX_INIT_SEED = 447923887


class TrainState(NamedTuple):
    params: List[torch.Tensor]
    batch_stats: List[torch.Tensor]
    classifier: Union[torch.Tensor, List[torch.Tensor]]  # (D, C), or its column blocks
    opt_state: Any
    step: int


class Sharding(NamedTuple):
    """Where a leaf of a train state lives: ``dim=None`` one copy on
    ``devices[0]`` (replicated: every shard reads it there); ``dim=1``
    column blocks, block j on ``devices[j]``
    (:func:`~fire_tpu_torch.parallel.mesh.split_columns`)."""
    devices: Tuple[torch.device, ...]
    dim: Optional[int] = None

    def place(self, t: torch.Tensor) -> List[torch.Tensor]:
        if self.dim == 1:
            return split_columns(t, self.devices)
        return [t.to(self.devices[0])]


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
    """``torch.autocast`` to ``compute_dtype`` (None or float32: none).
    Inside a CUDA graph capture (on ``device``'s current stream) its cache
    of cast weights is off: a cached cast would be captured once and
    replayed stale.  The cache is one for every card, so a forward that
    goes on to other cards keeps it off there too."""
    if compute_dtype in (None, torch.float32):
        return contextlib.nullcontext()
    capturing = False
    if device.type == "cuda":
        with torch.cuda.device(device):
            capturing = torch.cuda.is_current_stream_capturing()
    return torch.autocast(device.type, dtype=compute_dtype, cache_enabled=not capturing)


def init_state(model: torch.nn.Module, seed: int, num_classes: int,
               optimizer: GradientTransformation, classifier_seed: int = 0,
               mesh: Optional[Mesh] = None) -> TrainState:
    """Fill ``model`` (float32, on its device) with the JAX engine's
    numpy init (:func:`fire_tpu_torch.weights.materialize` at ``seed``;
    :data:`JAX_INIT_SEED` is the seed JAX's ``init_state(PRNGKey(0))``
    uses), and draw the classifier as ``N(0, 1)·0.01`` from a torch
    generator seeded with ``classifier_seed`` (JAX draws it from its own
    key: the two classifiers differ).  With a ``mesh`` of more than one
    device the state comes laid out on it (:func:`shard_state`)."""
    model.float()
    load_flax(model, materialize(flax_shapes(model), seed))
    dev = next(model.parameters()).device
    g = torch.Generator().manual_seed(classifier_seed)
    classifier = (torch.randn(model.embed_dim, num_classes, generator=g) * 0.01).to(dev)
    classifier.requires_grad_(True)
    params = list(model.parameters())
    state = TrainState(params, model_batch_stats(model), classifier,
                       optimizer.init(params + [classifier]), 0)
    return shard_state(mesh, state) if _sharded_mesh(mesh) else state


# ---------------------------------------------------------------- sharding --


def _sharded_mesh(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.devices.size > 1


def is_sharded(state: TrainState) -> bool:
    """Whether ``state``'s classifier is split into column blocks."""
    return isinstance(state.classifier, (list, tuple))


def _map_lists(fn: Callable, tree: Any, *others: Any) -> Any:
    """``fn`` on each tensor list of an optimizer state (its ``mu`` and
    ``nu``: one tensor per trained tensor, params first, then the
    classifier), zipped with the lists at the same place in ``others``;
    the other leaves (counts) are ``tree``'s."""
    if isinstance(tree, list):
        return fn(tree, *others)
    if isinstance(tree, tuple):
        items = [_map_lists(fn, t, *(o[i] for o in others)) for i, t in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def state_shardings(mesh: Mesh, state: TrainState) -> TrainState:
    """Where each leaf of an unsharded ``state`` lives on ``mesh``
    (counterpart of ``fire_tpu.train.trainer.state_shardings``): the
    model's parameters and statistics replicated (on the mesh's first
    device, in the model), the classifier's columns over ``mp``, and so
    the classifier's Adam moments; the step replicated.  The optimizer's
    counts stay where they are, on the mesh's first device."""
    first = canonical_device(mesh.devices.flat[0])
    rep = Sharding((first,))
    cols = Sharding(tuple(canonical_device(d) for d in column_devices(mesh)), 1)
    n = len(state.params)
    return TrainState(
        params=[rep] * n, batch_stats=[rep] * len(state.batch_stats), classifier=cols,
        opt_state=_map_lists(lambda lst: [rep] * n + [cols] * (len(lst) - n), state.opt_state),
        step=rep)


def shard_state(mesh: Mesh, state: TrainState) -> TrainState:
    """``state`` laid out on ``mesh`` as :func:`state_shardings` says:
    the classifier and its moments become lists of column blocks, each
    on its device; the model's tensors must already be on the mesh's
    first device."""
    if is_sharded(state):
        raise ValueError("shard_state: the state is sharded already")
    sh = state_shardings(mesh, state)
    home = sh.step.devices[0]
    if state.params[0].device != home:
        raise ValueError(f"shard_state: the model is on {state.params[0].device}, the mesh's "
                         f"first device is {home}")

    def lay_out(ts, shs):
        return [b for t, s in zip(ts, shs) for b in s.place(t)]

    return state._replace(classifier=sh.classifier.place(state.classifier),
                          opt_state=_map_lists(lay_out, state.opt_state, sh.opt_state))


def gather_state(state: TrainState) -> TrainState:
    """The inverse of :func:`shard_state`: the classifier and its
    moments whole again, on the first block's device."""
    if not is_sharded(state):
        return state
    n, home = len(state.params), state.classifier[0].device

    def cat(blocks):
        return torch.cat([b.detach().to(home) for b in blocks], dim=1)

    return state._replace(
        classifier=cat(state.classifier).requires_grad_(True),
        opt_state=_map_lists(lambda lst: lst[:n] + [cat(lst[n:])], state.opt_state))


def _blocks_like(full: torch.Tensor, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``full`` split into the column widths of ``blocks``, each on its block's device."""
    parts = torch.split(full.detach(), [b.shape[1] for b in blocks], dim=1)
    return [p.to(device=b.device, memory_format=torch.contiguous_format, copy=True)
            .requires_grad_(b.requires_grad) for p, b in zip(parts, blocks)]


def arcface_loss(model: torch.nn.Module, classifier: torch.Tensor, images: torch.Tensor,
                 labels: torch.Tensor, margin: float = 0.5, scale: float = 64.0,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Mean softmax cross-entropy of the ArcFace logits of
    ``model(images, train=True)``; updates the BatchNorm statistics."""
    with compute_context(images.device, compute_dtype):
        emb = model(images, train=True)
    logits = arcface_logits(emb, classifier, labels, margin, scale)
    return F.cross_entropy(logits, labels.long())


def sharded_arcface_loss(model: torch.nn.Module, classifier: Sequence[torch.Tensor],
                         images: torch.Tensor, labels: torch.Tensor, mesh: Mesh,
                         margin: float = 0.5, scale: float = 64.0,
                         compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`arcface_loss` over ``mesh``: the global batch split over
    ``dp`` into a :class:`~fire_tpu_torch.parallel.shards.ShardList`, one
    forward carrying every shard (BatchNorm statistics over the whole
    batch, the running ones updated once), the classifier's column
    blocks ``classifier`` (block j on ``column_devices(mesh)[j]``)
    copied down each column of the mesh, one block of logits per mesh
    position, the softmax normaliser reduced over ``mp``.  The loss is
    the mean over the global batch, on the mesh's first device;
    differentiate it by ``model.parameters()`` and ``classifier``."""
    dp = mesh.shape["dp"]
    batch = images.shape[0]
    if batch % dp:
        raise ValueError(f"a batch of {batch} does not split over dp = {dp} shards")
    rows = batch // dp
    dp_devices = [canonical_device(d) for d in mesh.axis_devices("dp")]
    shards = ShardList([images[i * rows:(i + 1) * rows].to(d) for i, d in enumerate(dp_devices)])
    with compute_context(dp_devices[0], compute_dtype):
        embeddings = model(shards, train=True).shards
    offsets = np.cumsum([0] + [b.shape[1] for b in classifier[:-1]]).tolist()
    columns = [broadcast(block, mesh.devices[:, j]) for j, block in enumerate(classifier)]
    shard_losses = []
    for i, emb in enumerate(embeddings):
        lab = labels[i * rows:(i + 1) * rows]
        devs = mesh.devices[i, :len(classifier)]
        logits = [arcface_logits(e, columns[j][i], lab.to(d), margin, scale, offsets[j])
                  for j, (d, e) in enumerate(zip(devs, broadcast(emb, devs)))]
        shard_losses.append(column_sharded_cross_entropy(logits, lab, offsets, batch))
    return sum_to(shard_losses, dp_devices[0])


def make_train_step(model: torch.nn.Module, optimizer: GradientTransformation,
                    mesh: Optional[Mesh] = None, margin: float = 0.5, scale: float = 64.0,
                    compute_dtype: Optional[torch.dtype] = None):
    """``step(state, images (B,H,W,3) [0,1], labels (B,)) → (state,
    loss)``: one ArcFace step, the optimizer's target the tuple (params,
    classifier) as in JAX.  The batch is tensors or numpy arrays.

    The step is a :class:`~fire_tpu_torch.runtime.graphs.GraphedStep`:
    on a card it replays the CUDA graph of its key, the batch's shapes
    and dtypes and the state's tensors (the step count a host int,
    incremented without a device read; ``release_graphs()`` drops the
    graphs).  With a ``mesh`` of more than one position the step is the
    dp×mp-sharded one (:func:`sharded_arcface_loss`; the model on the
    mesh's first device, B divisible by ``dp``): it lays out an
    unsharded state first (:func:`shard_state`), runs its backward on
    the calling thread, and replays one graph on every mesh, over all
    its cards where they are distinct (see the module's docstring)."""
    if _sharded_mesh(mesh):
        return _make_sharded_step(model, optimizer, mesh, margin, scale, compute_dtype)

    def body(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        loss = arcface_loss(model, state.classifier, images, labels, margin, scale,
                            compute_dtype)
        optimizer_step(optimizer, state.params + [state.classifier], state.opt_state, loss)
        return (loss.detach(),)

    return GraphedStep(body, _advance)


def _advance(state: TrainState, out: Tuple[torch.Tensor, ...]):
    """The state after a step (its host count advanced) and the step's loss."""
    return state._replace(step=state.step + 1), out[0]


def _make_sharded_step(model, optimizer, mesh, margin, scale, compute_dtype):
    home = canonical_device(mesh.devices.flat[0])
    if next(model.parameters()).device != home:
        raise ValueError(f"the model is on {next(model.parameters()).device}; the sharded "
                         f"step keeps it on the mesh's first device, {home}")
    blocks = [canonical_device(d) for d in column_devices(mesh)]

    last = []  # the last unsharded state laid out: weak references to its tensors, its layout

    def lay_out(state: TrainState) -> TrainState:
        if not is_sharded(state):
            tensors = _tensors(state)
            fresh = shard_state(mesh, state)
            if last and len(last[0]) == len(tensors) and all(
                    r() is t for r, t in zip(last[0], tensors)):
                # the same state again: into the same tensors, so the step keeps its key
                kept = last[1]
                with torch.no_grad():
                    for dst, src in zip(_tensors(kept), _tensors(fresh)):
                        if dst is not src:
                            dst.copy_(src)
                fresh = kept._replace(step=state.step)
            else:
                last[:] = [weakref.ref(t) for t in tensors], fresh
            state = fresh
        if [b.device for b in state.classifier] != blocks[:len(state.classifier)]:
            raise ValueError("the state's classifier blocks are laid out for another mesh")
        return state

    def body(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        loss = sharded_arcface_loss(model, state.classifier, images, labels, mesh, margin,
                                    scale, compute_dtype)
        # one thread, one ready queue: the cards' gradient terms add in a fixed order
        with torch.autograd.set_multithreading_enabled(False):
            optimizer_step(optimizer, state.params + list(state.classifier), state.opt_state,
                           loss)
        return (loss.detach(),)

    return GraphedStep(body, _advance, prepare=lay_out, devices=mesh.distinct_devices())


def _tensors(state: TrainState) -> List[torch.Tensor]:
    return [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]


def optimizer_step(optimizer: GradientTransformation, target: List[torch.Tensor],
                   opt_state: Any, loss: torch.Tensor) -> Any:
    """Differentiate ``loss`` by ``target``, update ``target`` in place
    with ``optimizer`` and return its new state (``opt_state``'s tensors,
    updated in place)."""
    grads = torch.autograd.grad(loss, target)
    with torch.no_grad():
        updates, opt_state = optimizer.update(list(grads), opt_state, target)
    apply_updates(target, updates)
    return opt_state


# ------------------------------------------------------------- checkpoints --


def state_tree(x: Any) -> Any:
    """A state (tensors, ints, lists, tuples, NamedTuples) as msgpack-able
    numpy trees: NamedTuples become dicts of their fields."""
    if isinstance(x, torch.Tensor):  # 0-d stays 0-d (np.ascontiguousarray would give 1-d)
        return x.detach().cpu().contiguous().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: state_tree(v) for f, v in zip(x._fields, x)}
    if isinstance(x, (list, tuple)):
        return [state_tree(v) for v in x]
    if isinstance(x, (int, float)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def restore_tree(target: Any, tree: Any) -> Any:
    """The inverse of :func:`state_tree` into ``target``'s structure:
    tensors are overwritten in place (shapes must agree), ints replaced.
    An optimizer count saved as an int (before counts were tensors) goes
    into the count tensor, in place."""
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
    """Write ``state`` to ``<path>/state.msgpack`` atomically; a sharded
    :class:`TrainState` is written gathered."""
    if isinstance(state, TrainState):
        state = gather_state(state)
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "state.msgpack")
    with open(out + ".tmp", "wb") as f:
        f.write(msgpack_serialize(state_tree(state)))
    os.replace(out + ".tmp", out)


def restore_checkpoint(path: str, target: Any) -> Any:
    """Read ``<path>/state.msgpack`` into ``target`` (a state of the same
    model and optimizer) and return the restored state, laid out as
    ``target`` is (sharded or not, whatever the saved state was)."""
    tree = read_msgpack(os.path.join(path, "state.msgpack"))
    if not (isinstance(target, TrainState) and is_sharded(target)):
        return restore_tree(target, tree)
    full = restore_tree(gather_state(target), tree)
    n = len(target.params)
    return full._replace(
        classifier=_blocks_like(full.classifier, target.classifier),
        opt_state=_map_lists(lambda f, t: f[:n] + _blocks_like(f[n], t[n:]),
                             full.opt_state, target.opt_state))


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest complete ``step_<N>`` checkpoint under ``directory``."""
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        int(d.split("_", 1)[1]) for d in os.listdir(directory)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
        and os.path.exists(os.path.join(directory, d, "state.msgpack")))
    return os.path.join(directory, f"step_{steps[-1]}") if steps else None
