"""CUDA graphs as the port's counterpart of ``jax.jit``, and what feeds them.

JAX compiles a function once per static key (shapes, static arguments)
and replays the compiled program on every later call.  On a card the
port captures the same function once per key into a CUDA graph and
replays it:

* :class:`CapturedCall`: one function of fixed-shape device tensors as
  one plain CUDA graph with static inputs and outputs, or (its training
  form) a step that differentiates and updates its state in place;
* :class:`GraphedStep`: a training step replayed per key, the
  counterpart of a jitted ``step(state, *args)``;
* :func:`replay`: a call through a :class:`GraphCache` (the graph of the
  key, captured at the key's first call), copying the call's arguments
  into the graph's static inputs;
* :class:`GraphCache`: graphs by key, all of a device in one memory pool
  (``_POOLS``), warmed up and captured on one side stream a device (a
  graph over several cards takes each card's pool and side stream);
* :class:`HostStaging`: two pinned buffers for each shape of host array
  going up to a card, so that an upload does not wait for the card.

The batched step's graph (``pipeline/batch_engine.py`` ``StepGraph``,
conditional nodes composed by :mod:`fire_tpu_torch.runtime.step_graph`)
shares the pools, side streams and cache.  Nothing here builds or
captures at import.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten


def check_graph_runtime() -> None:
    """Raise unless this PyTorch can hand over the graphs it captures and
    runs a CUDA with conditional nodes (12.4 or later)."""
    version = tuple(int(v) for v in (torch.version.cuda or "0.0").split(".")[:2])
    if version < (12, 4) or not hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph"):
        raise RuntimeError(
            f"the step graph needs CUDA graph conditional nodes (CUDA 12.4 or later) and "
            f"torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph(); this PyTorch "
            f"{torch.__version__} is built with CUDA {torch.version.cuda}")


def indexed(device) -> torch.device:
    """``device`` with its index (``cuda`` → ``cuda:<current>``), the form
    a tensor on it reports and the pools are keyed by."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


# One memory pool per device for every graph of the process, with the
# graphs that use it and, of those, the graphs whose capture began into
# it on that device (a graph over several cards only routes its other
# cards' allocations to theirs).  Graphs on a device replay one after
# another on its stream, and every tensor that outlives a replay (inputs,
# states, outputs, what passes between parts) is held by its graph, so
# one graph's scratch may be another's.  A pool whose graphs are all gone
# is released by PyTorch and not captured into again: the next graph
# takes a new one.  PyTorch's pinned-host allocator counts a pool's users
# apart: a capture that begins into the pool takes a count, and its graph
# gives it back when it goes; routed allocations take none.  It refuses
# (an internal assert) a capture into a pool whose count came back to 0,
# so a capture begins into a pool only while a graph that began one into
# it lives.
_POOLS: Dict[torch.device, Tuple[object, "weakref.WeakSet", "weakref.WeakSet"]] = {}
# Capture count: one per graph GraphCache.get builds (the per-frame, step
# and training graphs); nowhere else.  A steady per-frame loop adds none.
captures = 0
# One side stream per device for every warm-up and capture, so that the
# blocks a warm-up leaves in the allocator's cache serve the next one.
_SIDE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def side_stream(device: torch.device) -> torch.cuda.Stream:
    side = _SIDE_STREAMS.get(device)
    if side is None:
        side = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return side


def _new_pool():
    return torch.cuda.graph_pool_handle()


def _launch_counters():
    # at the call: track.scan imports track.sort, which imports this module
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.track import scan as k2

    return k1, k2


def warm_up(fn: Callable, inputs: Sequence[torch.Tensor], state: Sequence[torch.Tensor] = (),
            writes: Optional[Sequence[torch.Tensor]] = None) -> None:
    """The eager run of ``fn`` before its capture (:class:`CapturedCall`):
    on clones of ``inputs`` and ``state``; or, in the training form
    (``writes`` given), with grad enabled on the tensors themselves, each
    tensor of ``writes`` copied before and copied back after, bitwise."""
    if writes is None:
        with torch.no_grad():
            fn(*(x.clone() for x in inputs), *(x.clone() for x in state))
        return
    with torch.no_grad():
        saved = [t.clone() for t in writes]
    with torch.enable_grad():
        fn(*inputs, *state)
    with torch.no_grad():
        for t, v in zip(writes, saved):
            t.copy_(v)


class CapturedCall:
    """``fn`` over fixed-shape device tensors as one CUDA graph, replayed
    per call: the counterpart of ``jax.jit(fn)`` for one key.

    ``inputs`` are its static inputs, holding the first call's values;
    ``state`` static tensors that ``fn`` updates in place (a tracker's
    table), updated by every replay; :attr:`outputs` what ``fn`` returns,
    overwritten by every replay, so a caller reads or copies them before
    the next one.

    Building it: ``fn`` runs once eagerly on the device's side stream, on
    clones of the inputs and the state, so that cuDNN's choice of
    algorithm, the cuBLAS workspace, the allocator's blocks and any
    constants ``fn`` caches on the device are settled; then the cache is
    emptied (its blocks back to the card, where the pool can take them)
    and ``fn`` is captured into ``pool``.  A capture that fails raises:
    nothing falls back to eager dispatch.

    The training form (``writes`` given) captures a step that
    differentiates and updates tensors it reaches itself: ``writes`` are
    those tensors (a model's parameters and BatchNorm statistics, an
    optimizer's moments and counts).  Its warm-up and capture run with
    grad enabled, and its warm-up runs on the static inputs themselves
    (``fn`` only reads them; a bound scene pool is too large to clone),
    each tensor of ``writes`` copied before it and copied back after it,
    so that building the graph leaves the training state bitwise as it
    was.  No autograd graph of those tensors made on another stream may
    be alive then (a loss not detached, a clone taken with grad): its
    gradient accumulators keep that stream, and the capture fails.  One warm-up is enough for ``torch.autograd.grad``: the
    autograd engine's device thread, its cuBLAS handle and workspace and
    cuDNN's choices are settled by it, and the backward runs on the
    stream of its forward, the side stream of the capture.

    A graph over several cards: ``others`` are ``(device, pool)`` of each
    card ``fn`` computes on besides the first (:attr:`device`, the
    inputs' card, where the capture begins and the graph is launched).
    Each other card's side stream is forked from the first card's by an
    event and is that card's current stream for the warm-up and the
    capture (a copy between two cards runs on the current streams of
    both, and the autograd engine keeps each node's forward stream on
    its own card); it is joined back before the capture ends, so one
    graph holds every card's work.  Each other card's allocations go to
    its own pool while the capture runs.  ``fn`` must run its backward
    on this thread (``torch.autograd.set_multithreading_enabled(False)``):
    the engine's device threads would issue another card's work on that
    card's default stream, outside the capture.  A replay waits for
    every card's current stream and makes each wait for the replay, as
    an eager step over the cards would order them.

    K1's and K2's launch counters count what runs: the warm-up and the
    capture add nothing, and each :meth:`replay` adds the launches the
    graph holds."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], pool,
                 state: Sequence[torch.Tensor] = (),
                 writes: Optional[Sequence[torch.Tensor]] = None,
                 others: Sequence[Tuple[torch.device, object]] = ()):
        self.inputs, self.state, self.others = tuple(inputs), tuple(state), tuple(others)
        dev = self.device = self.inputs[0].device
        self.devices = (dev, *(d for d, _ in self.others))
        k1, k2 = _launch_counters()
        counts = k1.launches, k2.launches
        curs = [torch.cuda.current_stream(d) for d in self.devices]
        sides = [side_stream(d) for d in self.devices]
        for side, cur in zip(sides, curs):
            side.wait_stream(cur)
        for side in sides[1:]:
            side.wait_stream(sides[0])
        try:
            with contextlib.ExitStack() as on:
                for side in sides[1:]:  # each sets its card current: the first card's last
                    on.enter_context(torch.cuda.stream(side))
                on.enter_context(torch.cuda.device(dev))
                on.enter_context(torch.cuda.stream(sides[0]))
                on.enter_context(torch.set_grad_enabled(writes is not None))
                warm_up(fn, self.inputs, self.state, writes)
                for d in self.devices:
                    torch.cuda.synchronize(d)
                torch.cuda.empty_cache()
                reserved = [torch.cuda.memory_reserved(d) for d in self.devices]
                t0 = time.perf_counter()
                before = k1.launches, k2.launches
                self.graph = torch.cuda.CUDAGraph()
                out = self._capture(fn, pool)
                self.outputs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
                self.k1_per_replay = k1.launches - before[0]
                self.k2_per_replay = k2.launches - before[1]
                self.capture_s = time.perf_counter() - t0
                # what this capture added to each card's shared pool
                self.pool_bytes_by_device = {
                    str(d): torch.cuda.memory_reserved(d) - r
                    for d, r in zip(self.devices, reserved)}
                self.pool_bytes = sum(self.pool_bytes_by_device.values())
            for cur, side in zip(curs, sides):
                cur.wait_stream(side)
        finally:
            k1.launches, k2.launches = counts
        if self.others:
            # the graph gives back the first card's pool when it goes; the
            # other cards' were taken by _cuda_beginAllocateToPool
            weakref.finalize(self, _release_pools,
                             [(d.index, p) for d, p in self.others]).atexit = False

    def _capture(self, fn: Callable, pool):
        """``fn`` on the static tensors, captured on the current stream
        (the first card's side stream), the other cards' side streams
        forked from it and joined back."""
        sides = [side_stream(d) for d in self.devices]
        self.graph.capture_begin(pool=pool)
        routed = []
        try:
            for d, p in self.others:
                torch._C._cuda_beginAllocateToPool(d.index, p)
                routed.append((d.index, p))
            for side in sides[1:]:
                side.wait_stream(sides[0])
            out = fn(*self.inputs, *self.state)
            for side in sides[1:]:
                sides[0].wait_stream(side)
        except BaseException:
            for side in sides[1:]:  # a fork left unjoined keeps its stream capturing
                with contextlib.suppress(RuntimeError):
                    sides[0].wait_stream(side)
            self._end(pool, routed, failed=True)
            raise
        self._end(pool, routed, failed=False)
        return out

    def _end(self, pool, routed, failed: bool) -> None:
        """End the capture and the other cards' routing to their pools
        (``routed``); a capture that failed, or that ``capture_end``
        refuses, gives those pools back and leaves no card routing."""
        try:
            self.graph.capture_end()
        except RuntimeError:
            # torch then left this stream's allocations going to the pool,
            # unless it had ended that
            with contextlib.suppress(RuntimeError):
                torch._C._cuda_endAllocateToPool(self.device.index, pool)
            _release_pools(routed, end=True)
            if not failed:
                raise
            return  # the capture was invalid already: the first error is the one to see
        _release_pools(routed, end=True, release=failed)

    def replay(self) -> Tuple[torch.Tensor, ...]:
        """Queue one run on the current stream (the inputs already in
        place); returns :attr:`outputs`.  Over several cards the run
        waits for each card's current stream, and each waits for it."""
        if self.others:
            home = torch.cuda.current_stream(self.device)
            curs = [torch.cuda.current_stream(d) for d, _ in self.others]
            for cur in curs:
                home.wait_stream(cur)
            self.graph.replay()
            for cur in curs:
                cur.wait_stream(home)
        else:
            self.graph.replay()
        k1, k2 = _launch_counters()
        k1.count_replayed(self.k1_per_replay)
        k2.count_replayed(self.k2_per_replay)
        return self.outputs


def _release_pools(routed, end: bool = False, release: bool = True) -> None:
    """For each ``(card index, pool)`` of ``routed``: end the routing of
    the card's allocations to the pool (``end``), and give back the
    reference to the pool that starting it took (``release``)."""
    for index, pool in routed:
        if end:
            torch._C._cuda_endAllocateToPool(index, pool)
        if release:
            torch._C._cuda_releasePool(index, pool)


class GraphCache:
    """Graphs by key (whose first entry is the indexed device), the
    ``limit`` most recently used kept (None: all)."""

    def __init__(self, limit: Optional[int] = 4):
        self.limit = limit
        self._graphs: "OrderedDict[tuple, object]" = OrderedDict()

    def find(self, key: tuple):
        """The graph of ``key``, or None."""
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
        return graph

    def get(self, key: tuple, build: Callable[..., object], devices: Sequence = ()):
        """The graph of ``key``, built when absent by ``build(pool,
        *pools)``: the shared pool of the device ``key[0]``, then that of
        each of ``devices`` (the graph's other cards)."""
        global captures
        graph = self.find(key)
        if graph is not None:
            return graph
        cards = (key[0], *devices)
        for i, dev in enumerate(cards):
            # the first card's capture begins into its pool; the others route
            if dev not in _POOLS or not _POOLS[dev][2 if i == 0 else 1]:
                _POOLS[dev] = (_new_pool(), weakref.WeakSet(), weakref.WeakSet())
        try:
            graph = self._graphs[key] = build(*(_POOLS[dev][0] for dev in cards))
        except BaseException:
            # a capture that failed leaves its pools refusing captures: the
            # next graph of each of its cards takes a new one
            for dev in cards:
                _POOLS.pop(dev, None)
            raise
        captures += 1
        for dev in cards:
            _POOLS[dev][1].add(graph)
        _POOLS[key[0]][2].add(graph)
        while self.limit is not None and len(self._graphs) > self.limit:
            self._graphs.popitem(last=False)
        return graph

    def clear(self) -> None:
        self._graphs.clear()

    def __len__(self) -> int:
        return len(self._graphs)

    def __iter__(self):
        return iter(self._graphs.items())


def replay(cache: GraphCache, key: tuple, fn: Callable, args: Sequence, staging: "HostStaging",
           state: Sequence[torch.Tensor] = ()) -> Tuple[torch.Tensor, ...]:
    """``fn(*args, *state)`` as the graph of ``key`` in ``cache``.  A
    device tensor among ``args`` is a static input at the key's first call
    (the graph reads that tensor from then on, so it must be one the
    caller keeps for the purpose, such as ``DeviceEngine``'s static frame
    inputs, never a tensor its own caller handed in) and is copied into
    the input at a later call unless it is that input; a host array goes up through
    ``staging``'s pinned buffers, into a new static input at the first
    call.  The first call captures (:class:`CapturedCall`) on these
    values.  Returns the graph's static outputs."""
    dev = key[0]
    graph = cache.find(key)
    if graph is None:
        inputs = [a if isinstance(a, torch.Tensor) else staging.upload(a, dev) for a in args]
        graph = cache.get(key, lambda pool: CapturedCall(fn, inputs, pool, state))
    else:
        for dst, a in zip(graph.inputs, args):
            if not isinstance(a, torch.Tensor):
                staging.upload(a, dev, out=dst)
            elif a is not dst:
                dst.copy_(a)
    return graph.replay()


class GraphedStep:
    """A training step that updates its state in place, run as JAX runs
    its jitted ``step(state, *args)``.

    ``body(state, *args)`` returns a tuple of tensors and updates the
    tensors of ``state`` (a tree of NamedTuples, tuples and lists whose
    other leaves, such as a host step count, it leaves alone) in place;
    a call returns ``finish(state, outputs)`` (the state with its host
    fields advanced, and the outputs as the trainer hands them out).
    The first ``bound`` arguments are device tensors the step reads as
    they are (a trainer's scene pool); the rest, arrays or trees of
    arrays (numpy or tensors), are the batch.  ``prepare(state)``, when
    given, runs first, outside any graph, and its result is the state
    the step runs on and returns (the sharded ArcFace step lays out an
    unsharded state on its mesh there, and refuses one laid out for
    another mesh).  ``devices`` are cards the body computes on besides
    those its state lies on (a mesh's: a (2, 2) mesh's second row holds
    no state but computes a ``dp`` shard).

    On a CUDA device each key replays a graph, :class:`CapturedCall`'s
    training form captured at the key's first call.  The key is what
    ``jax.jit`` retraces on, the shapes and dtypes of the batch's arrays
    and the tree they form, plus what the graph binds: the bound tensors
    and the state's tensors, by identity (a step handed another pool or
    another state gets a key of its own, and never writes a caller's
    tensor).  The static configuration (model, optimizer, compute
    dtype, mesh) is the body's own.  The cards of a graph are the device
    of the batch and the state's first tensor, then, in the order first
    seen, the other devices of the state and of ``devices``: a state
    whose tensors lie on several cards (the sharded step over distinct
    cards) replays one graph over all of them, whose body must run its
    backward on the calling thread (:class:`CapturedCall`).  A call
    copies the batch into the static inputs of its key, a host array
    through :class:`HostStaging`'s pinned buffers, replays, and returns
    clones of the graph's outputs (the next replay overwrites them).
    Every key is kept until :meth:`release_graphs`.  On another device
    ``body`` runs eagerly: the eager step is the graph's plain version,
    and ``_graphed`` set off on an instance runs it on a card."""

    def __init__(self, body: Callable, finish: Callable, bound: int = 0,
                 prepare: Optional[Callable] = None, devices: Sequence = ()):
        self.body, self.finish, self.bound, self.prepare = body, finish, bound, prepare
        self.devices = tuple(devices)
        self.graphs = GraphCache(limit=None)
        self._staging = HostStaging()

    def _graphed(self, device: torch.device) -> bool:
        """Whether calls replay captured graphs: on a CUDA device."""
        return torch.device(device).type == "cuda"

    def release_graphs(self) -> None:
        """Drop every graph, its static inputs and the pinned buffers; the
        next call on a card captures again."""
        self.graphs.clear()
        self._staging = HostStaging()

    def __call__(self, state, *args):
        if self.prepare is not None:
            state = self.prepare(state)
        return self.finish(state, self._outputs(state, *args))

    def _outputs(self, state, *args) -> Tuple[torch.Tensor, ...]:
        writes = [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]
        dev = writes[0].device
        bound = args[:self.bound]
        leaves, spec = tree_flatten(args[self.bound:])
        leaves = [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray)
                  else torch.as_tensor(a) for a in leaves]
        if not self._graphed(dev):
            batch = [self._staging.upload(a, dev, slot=i) for i, a in enumerate(leaves)]
            return self.body(state, *bound, *tree_unflatten(batch, spec))
        for t in bound:
            if not isinstance(t, torch.Tensor) or t.device != dev:
                raise ValueError(f"a bound argument of the step is a tensor on {dev}")
        key = (indexed(dev), tuple(map(id, bound)), str(spec),
               tuple((tuple(a.shape), a.dtype) for a in leaves), tuple(map(id, writes)))
        graph = self.graphs.find(key)
        if graph is None:
            statics = [torch.empty(a.shape, dtype=a.dtype, device=dev) for a in leaves]
            self._fill(statics, leaves, dev)
            body, n = self.body, len(bound)
            others = []
            for d in [t.device for t in writes] + [indexed(d) for d in self.devices]:
                if d != key[0] and d not in others:
                    others.append(d)

            def fn(*ins):  # holds no reference to self: the graphs go with the step
                return body(state, *ins[:n], *tree_unflatten(list(ins[n:]), spec))

            def build(pool, *pools):
                return CapturedCall(fn, [*bound, *statics], pool, writes=writes,
                                    others=list(zip(others, pools)))

            graph = self.graphs.get(key, build, others)
        else:
            self._fill(graph.inputs[len(bound):], leaves, dev)
        return tuple(o.clone() for o in graph.replay())

    def _fill(self, statics, leaves, dev) -> None:
        for i, (dst, a) in enumerate(zip(statics, leaves)):
            self._staging.upload(a, dev, slot=i, out=dst)


class HostStaging:
    """Host arrays on their way to a device.  To a card, each (slot,
    shape, dtype) goes through one of two pinned buffers and up
    asynchronously, so an upload waits only for the copy out of the same
    buffer two uploads before; elsewhere it is a plain copy."""

    def __init__(self):
        self._rings: Dict[tuple, list] = {}

    def upload(self, x, device, slot: int = 0, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """``x`` (a host array or tensor) on ``device``, in ``out`` when
        given (a graph's static input)."""
        device = torch.device(device)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if device.type != "cuda" or x.device.type != "cpu":
            return x.to(device) if out is None else out.copy_(x)
        key = (slot, tuple(x.shape), x.dtype)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = [
                [torch.empty(x.shape, dtype=x.dtype, pin_memory=True), None] for _ in range(2)]
        entry = ring.pop(0)
        ring.append(entry)
        buf, done = entry
        if done is not None:
            done.synchronize()  # the upload out of this buffer, two uploads ago, has left it
        buf.copy_(x)
        if out is None:
            out = buf.to(device, non_blocking=True)
        else:
            out.copy_(buf, non_blocking=True)
        entry[1] = torch.cuda.Event()
        entry[1].record(torch.cuda.current_stream(device))
        return out
