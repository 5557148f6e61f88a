"""Several video streams over a device mesh (counterpart of
``fire_tpu.parallel.multistream``).

S = ``mesh.shape["dp"]`` streams, stream i on the i-th device of the
``dp`` axis, each with its own tracker and identity state.  Every stream
runs the single-stream batched step unchanged
(:meth:`fire_tpu_torch.pipeline.batch_engine.BatchStreamEngine.step`)
against the one shared gallery.  Where JAX stacks the states and runs one
SPMD program, on each card this process replays one CUDA graph that holds
the steps of all the streams on it
(:class:`~fire_tpu_torch.pipeline.batch_engine.StepGraph`), with their
states and frames static: ``submit`` reads nothing from the card.  Every
stream matches against the gallery as it stood at ``submit``: each graph
reads its replica's device count, written in stream order before it.
Off the card the S eager steps run one after the other, all of them
before the first readback, against the host count read once.

The models and the gallery get one replica per distinct device of the
mesh: on one card the replicas are the engine and the gallery matrix
themselves.  A replica of the gallery on another device is brought up to
date when the count changes, by copying the new rows only.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import torch

from fire_tpu_torch.config import RecognizerConfig, TrackerConfig
from fire_tpu_torch.parallel.mesh import Mesh, canonical_device
from fire_tpu_torch.pipeline.batch_engine import (BatchResults, BatchStreamEngine, StepGraph,
                                                  copy_state, make_stream_state)
from fire_tpu_torch.runtime.graphs import GraphCache


def replicate_engine(engine, device: torch.device):
    """``engine`` with its models copied to ``device`` (the engine itself
    when it is already there)."""
    if canonical_device(device) == canonical_device(engine.device):
        return engine
    rep = copy.copy(engine)
    rep.device = torch.device(device)
    memo = {}  # a module held under two names stays one module
    for name in ("encoder", "detector", "_encoder_net", "_detector_net"):
        module = getattr(engine, name, None)
        if module is not None:
            setattr(rep, name, copy.deepcopy(module, memo).to(rep.device))
    return rep


class MultiStreamEngine:
    """S streams × B frames per submit, one stream per ``dp`` device."""

    def __init__(self, engine, gallery, cfg: RecognizerConfig, mesh: Mesh,
                 tracker_cfg: Optional[TrackerConfig] = None,
                 encode_k: int = 8, detection_interval: int = 1,
                 encode_budget: Optional[int] = None):
        self.mesh = mesh
        self.n_streams = mesh.shape["dp"]
        self.inner = BatchStreamEngine(engine, gallery, cfg, tracker_cfg, encode_k=encode_k,
                                       detection_interval=detection_interval,
                                       encode_budget=encode_budget)
        self.cfg = cfg
        self.tcfg = self.inner.tcfg
        self.devices = mesh.axis_devices("dp")
        self.engines = {d: replicate_engine(engine, d) for d in mesh.distinct_devices()}
        self.states = [make_stream_state(self.tcfg, cfg.embedding_dim, d) for d in self.devices]
        self._gal_replicas: Dict[torch.device, list] = {}  # device → [matrix, rows synced]
        self._count_replicas: Dict[torch.device, torch.Tensor] = {}  # device → its rows there
        # device-resident zero batches for streams that have ended, by
        # (h, w, b, stream): uploaded once, then reused
        self._zero_batches = {}
        self.graphs = GraphCache(4 * len(self.engines))  # one graph a device for each shape

    def reset(self) -> None:
        """A fresh state for every stream, written into its own tensors
        (the step graphs hold them)."""
        for state, dev in zip(self.states, self.devices):
            copy_state(state, make_stream_state(self.tcfg, self.cfg.embedding_dim, dev))

    def _gallery_on(self, device: torch.device, gal: torch.Tensor,
                    count: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The gallery matrix on ``device`` and its live rows there as a
        0-d int32 tensor: ``gal`` and the gallery's own device count
        there, else a replica that copies only the rows added since its
        last sync (all of them on the first use, a shrink or a change of
        shape), with a count of its own written in stream order."""
        if device == canonical_device(gal.device):
            return gal, self.inner.gallery.count_dev
        rep = self._gal_replicas.get(device)
        if rep is None or rep[0].shape != gal.shape or rep[0].dtype != gal.dtype or count < rep[1]:
            rep = self._gal_replicas[device] = [gal.to(device, copy=True), count]
            self._count_replicas[device] = torch.full((), count, dtype=torch.int32, device=device)
        elif count > rep[1]:
            rep[0][rep[1] : count] = gal[rep[1] : count].to(device)
            rep[1] = count
            self._count_replicas[device].fill_(count)
        return rep[0], self._count_replicas[device]

    def _frames_for(self, frames, i: int, live: bool) -> torch.Tensor:
        dev = self.devices[i]
        s, b, h, w = frames.shape[:4]
        if live:
            return self.inner._upload(frames[i], dev, slot=i)
        key = (h, w, b, i)
        z = self._zero_batches.get(key)
        if z is None:
            z = self._zero_batches[key] = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=dev)
        return z

    def submit(self, frames, active: Optional[List[bool]] = None):
        """frames: (S, B, H, W, 3) uint8, one batch per stream.  Streams
        marked inactive in ``active`` get a zero batch instead of a fresh
        upload; their step still runs and their results are dropped by
        the caller.  Returns a token for :meth:`collect`."""
        s, b = frames.shape[:2]
        assert s == self.n_streams, f"need {self.n_streams} streams, got {s}"
        gallery = self.inner.gallery
        count = gallery.count  # one snapshot for every stream
        gal = gallery.gal_matmul
        live = [active is None or active[i] for i in range(s)]
        if not self.inner._graphed(self.devices[0]):
            packed = []
            with torch.inference_mode():
                for i, dev in enumerate(self.devices):
                    x = self._frames_for(frames, i, live[i])
                    g = self._gallery_on(dev, gal, count)[0]
                    new, out = self.inner.step(self.engines[dev], g, count, self.states[i], x)
                    copy_state(self.states[i], new)
                    packed.append(out)
            return [self.inner._readback(p, slot=i) for i, p in enumerate(packed)], b
        packed = [None] * s
        for dev in dict.fromkeys(self.devices):
            streams = [i for i, d in enumerate(self.devices) if d == dev]
            g, c = self._gallery_on(dev, gal, count)
            key = self.inner._graph_key(self.engines[dev], g, c, len(streams), frames.shape[1:])
            graph = self.graphs.get(key, lambda pool: StepGraph(
                self.inner, self.engines[dev], g, c, [self.states[i] for i in streams],
                [self._frames_for(frames, i, live[i]).clone() for i in streams], pool))
            for j, i in enumerate(streams):
                if live[i]:
                    self.inner._upload(frames[i], dev, slot=i, out=graph.frames[j])
                else:
                    graph.frames[j].zero_()
            for j, p in zip(streams, graph.replay()):
                packed[j] = p
        return [self.inner._readback(p, slot=i) for i, p in enumerate(packed)], b

    def collect(self, token) -> List[BatchResults]:
        """Wait for a submitted step; one BatchResults per stream.  Each
        stream's readback buffer goes back to the pool here."""
        reads, b = token
        return [self.inner._unpack(read, b) for read in reads]

    def process_batches(self, frames) -> List[BatchResults]:
        return self.collect(self.submit(frames))
