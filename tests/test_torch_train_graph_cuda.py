"""The training steps' CUDA graphs on the card (``runtime/graphs.py``
``GraphedStep``) against their plain version, the same step run
eagerly: the one-device steps, and the dp×mp-sharded ArcFace step on a
(2, 2) mesh of the card repeated.

Needs an NVIDIA card, and skips without one.  This file imports no JAX,
so it runs on the machine with the card, where tests/conftest.py (which
imports JAX) must be left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_graph_cuda.py -q

For the ArcFace step and the YuNet, BlazeFace and RetinaFace pool steps,
a graph and the eager step start from one state and take 5 steps in
float32 with TF32 off, ``cudnn.deterministic`` on and ``cudnn.benchmark``
off: losses, parameters, BatchNorm statistics, Adam moments and counts
bitwise equal after every step (the detectors' cosine schedule passes
its end within them, so a learning rate or bias correction frozen at
its capture value would show).  Building the graph leaves the state
bitwise as it was, and the caller's tensors are read, never written.
Each trainer's own loop (``train_loop`` of the ArcFace command line,
``train_on_pool`` of the detector command lines) makes no synchronising
call after its first step, refreshes of the pool included, under
``torch.cuda.set_sync_debug_mode("error")``, the sharded ``train_loop``
too.  A capture that fails raises, nothing runs eagerly in its place,
and the next capture into the device's pool works, a sharded one's
too.  The sharded step is held to the same bitwise comparison (C = 7
over two column blocks), on the card repeated and, with two cards or
more, over distinct cards, where its graph spans every card of the
mesh; there two eager runs from one state are bitwise equal too, a
failed capture leaves every card capturing, and eager work on another
card after a replay sees the replay's update.
"""

import contextlib
import logging
import types

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from fire_tpu_torch.models.blazeface import BlazeFace
from fire_tpu_torch.models.facenet import tiny_facenet
from fire_tpu_torch.models.retinaface import RetinaFace
from fire_tpu_torch.models.yunet import YuNet
from fire_tpu_torch.parallel.mesh import make_mesh
from fire_tpu_torch.runtime import graphs
from fire_tpu_torch.train import trainer
from fire_tpu_torch.train import __main__ as arcface_cli
from fire_tpu_torch.train import detect, detect_blaze, detect_retina, optim
from fire_tpu_torch.train.scenes import compose_scene, make_identities
from fire_tpu_torch.train.trainer import (JAX_INIT_SEED, init_state, make_train_step,
                                          model_batch_stats)
from fire_tpu_torch.weights import flax_shapes, load_flax, materialize

pytestmark = pytest.mark.cuda

STEPS = 5
CASES = ["arcface", "yunet", "blazeface", "retinaface"]


@pytest.fixture
def exact_cuda():
    """The card, with float32 kept float32 and cuDNN deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the graphs are captured there only")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags


def _tensors(state):
    return [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]


def _scenes(hw, n, max_faces, face_px, seed):
    idents = make_identities(6, seed=seed)
    out = [compose_scene(np.random.default_rng(seed + s), idents, hw=hw, n_faces=(1, max_faces),
                         face_px=face_px) for s in range(n)]
    padded = [detect.pad_gt(b, l, max_faces) for _, b, l in out]
    return [np.stack([s[0].astype(np.uint8) for s in out])] + [
        np.stack([p[i] for p in padded]) for i in range(3)]


def _cli_optimizer(lr):
    """The detector command lines' optimizer, its cosine schedule ending
    within the 5 steps."""
    return optim.chain(optim.clip_by_global_norm(5.0),
                       optim.adamw(optim.cosine_decay_schedule(lr, 4, 0.05)))


def _make(case, dev):
    """``(step, state, pool tensors, batches)``: a fresh step of ``case``
    on ``dev`` (the same each call), its pool (empty for ArcFace) and 5
    batches of device tensors (the arguments after the pool)."""
    rng = np.random.default_rng(5)
    if case == "arcface":
        model = tiny_facenet(32).to(dev)
        opt = optim.adamw(1e-3)
        state = init_state(model, JAX_INIT_SEED, 8, opt)
        batches = [(torch.tensor(rng.random((8, 96, 96, 3)), dtype=torch.float32, device=dev),
                    torch.tensor(np.arange(8) % 8, dtype=torch.int32, device=dev))
                   for _ in range(STEPS)]
        return make_train_step(model, opt), state, [], batches
    if case == "yunet":
        model, hw, scene_hw, n, lr = YuNet(width=8), (96, 96), (96, 96), 8, 2e-3
        make = lambda m, o: detect.make_pool_train_step(m, o, hw)  # noqa: E731
    elif case == "blazeface":
        model, scene_hw, n, lr = BlazeFace(), (80, 96), 6, 1e-3
        make = lambda m, o: detect_blaze.make_blaze_pool_train_step(m, o, input_px=64)  # noqa
    else:
        model, hw, scene_hw, n, lr = (RetinaFace(stage_sizes=(1, 1, 1, 1), width=16),
                                      (128, 128), (96, 160), 4, 2e-3)
        make = lambda m, o: detect_retina.make_retina_pool_train_step(m, o, hw)  # noqa: E731
    load_flax(model, materialize(flax_shapes(model), seed=0))
    model.to(dev)
    opt = _cli_optimizer(lr)
    params = list(model.parameters())
    state = ((params, opt.init(params)) if case == "blazeface"
             else (params, model_batch_stats(model), opt.init(params)))
    pool = [torch.from_numpy(a).to(dev) for a in _scenes(scene_hw, n, 2, (20, 60), seed=7)]
    batches = [(torch.tensor(rng.integers(0, n, 4), device=dev),) for _ in range(STEPS)]
    return make(model, opt), state, pool, batches


@pytest.mark.parametrize("case", CASES)
def test_graph_equals_eager_bitwise(case, exact_cuda, monkeypatch):
    built = []
    real = graphs.CapturedCall

    class Recording(real):
        def __init__(self, fn, inputs, pool, state=(), writes=None, others=()):
            super().__init__(fn, inputs, pool, state, writes, others)
            torch.cuda.synchronize()
            built.append((self, [t.detach().clone() for t in writes]))

    monkeypatch.setattr(graphs, "CapturedCall", Recording)
    eager, state_e, pool_e, batches_e = _make(case, exact_cuda)
    eager._graphed = lambda device: False
    graphed, state_g, pool_g, batches_g = _make(case, exact_cuda)
    start = [t.detach().clone() for t in _tensors(state_g)]
    callers = [t.clone() for t in pool_g + [x for b in batches_g for x in b]]
    for i in range(STEPS):
        state_e, *out_e = eager(state_e, *pool_e, *batches_e[i])
        state_g, *out_g = graphed(state_g, *pool_g, *batches_g[i])
        torch.cuda.synchronize()
        assert torch.equal(out_e[0], out_g[0]), (case, i, float(out_e[0]), float(out_g[0]))
        for a, b in zip(_tensors(state_e), _tensors(state_g)):
            assert torch.equal(a, b), (case, i)
    assert len(graphed.graphs) == 1 and len(eager.graphs) == 0
    (call, after_build), = built
    assert all(torch.equal(a, b) for a, b in zip(after_build, start)), "the build moved the state"
    counts = [t for t in _tensors(state_g) if t.dtype == torch.int32]
    assert counts and all(int(t) == STEPS for t in counts)
    # the caller's tensors: read, never written; only the pool is bound
    assert all(torch.equal(a, b) for a, b in zip(
        callers, pool_g + [x for b in batches_g for x in b]))
    assert all(a is b for a, b in zip(call.inputs, pool_g))
    assert not any(x is y for x in call.inputs[len(pool_g):] for b in batches_g for y in b)
    graphed.release_graphs()
    assert len(graphed.graphs) == 0


@contextlib.contextmanager
def _sync_mode(mode):
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def test_arcface_loop_synchronises_only_to_log(exact_cuda):
    """``train_loop`` as the command line runs it, on host batches: after
    the first step (the capture), a non-logging step makes no
    synchronising call; a logging step reads the loss."""
    _arcface_loop(exact_cuda, None)


def test_sharded_arcface_loop_synchronises_only_to_log(exact_cuda):
    """The same with the command line's (2, 2) mesh, the card repeated."""
    _arcface_loop(exact_cuda, make_mesh((2, 2), devices=[exact_cuda] * 4))


def _arcface_loop(dev, mesh):
    model = tiny_facenet(32).to(dev)
    opt = optim.adamw(1e-3)
    state = init_state(model, JAX_INIT_SEED, 8, opt, mesh=mesh)
    step = make_train_step(model, opt, mesh=mesh)
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 256, (8, 96, 96, 3), dtype=np.uint8),
                (np.arange(8) % 8).astype(np.int32)) for _ in range(7)]
    logged = []

    def guarded():
        it = iter(batches)
        yield next(it)  # the first step captures: it synchronises
        with _sync_mode("error"):
            yield from it

    def on_log(state, loss):
        with _sync_mode(0):
            logged.append((state.step, float(loss)))

    state = arcface_cli.train_loop(step, state, guarded(), 3, on_log)
    assert state.step == 7 and [s for s, _ in logged] == [3, 6]
    assert all(np.isfinite(v) for _, v in logged) and len(step.graphs) == 1


class _Pool:
    """A scene pool of pre-rendered scenes, as ``ScenePool`` samples them."""

    def __init__(self, scenes):
        self.scenes, self.generated = scenes, len(scenes)

    def sample(self, n, rng):
        return [self.scenes[i] for i in rng.integers(0, len(self.scenes), n)]


@pytest.mark.parametrize("case", ["yunet", "blazeface", "retinaface"])
def test_detector_loop_makes_no_synchronising_call(case, exact_cuda):
    """``train_on_pool`` with the pool refreshed every 2 steps: after the
    first step no step synchronises (the index vector and the fresh rows
    go up through pinned buffers)."""
    step, state, pool, _ = _make(case, exact_cuda)
    host = _scenes(tuple(pool[0].shape[1:3]), 12, pool[1].shape[1], (20, 60), seed=9)
    scenes = [tuple(a[i] for a in host) for i in range(12)]
    args = types.SimpleNamespace(seed=0, device_pool=8, steps=9, batch=4, refresh_every=2,
                                 refresh_block=2, log_every=100)
    seen = []

    def on_step(state, i):
        seen.append(i)
        if i == 1:
            torch.cuda.set_sync_debug_mode("error")

    try:
        detect.train_on_pool(_Pool(scenes), step, state, args, exact_cuda,
                             logging.getLogger("test"), ("cls",), on_step=on_step)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert seen == list(range(1, 10)) and len(step.graphs) == 1


def test_a_failed_capture_raises(exact_cuda):
    """A step that reads the card back cannot be captured: it raises, and
    the state is as it was (the warm-up's copies restored)."""
    x = torch.ones(4, device=exact_cuda, requires_grad=True)
    count = torch.zeros((), dtype=torch.int32, device=exact_cuda)

    def body(state, batch):
        loss = (state[0] * batch).sum()
        if loss.item() > 0:  # a host read: refused inside a capture
            state[1].add_(1)
        return (loss.detach(),)

    step = graphs.GraphedStep(body, lambda state, out: out)
    with pytest.raises(RuntimeError):
        step((x, count), torch.ones(4, device=exact_cuda))
    assert int(count) == 0 and len(step.graphs) == 0
    # the device's shared pool still takes captures
    good, state, pool, batches = _make("yunet", exact_cuda)
    good(state, *pool, *batches[0])
    assert len(good.graphs) == 1


# ------------------------------------------------------- the sharded step --


def _distinct_mesh():
    """The command line's mesh over distinct cards: four where there are
    four, else two."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs at least two cards for a mesh of distinct cards; this machine has {n}")
    n = 4 if n >= 4 else 2
    return make_mesh(arcface_cli.mesh_shape(n), devices=[f"cuda:{i}" for i in range(n)])


def _sharded(mesh, seed=5):
    """A fresh sharded ArcFace step of ``tiny_facenet(32)`` at 96² on
    ``mesh`` (the same each call), its state and 5 batches on the
    mesh's first device."""
    home = mesh.devices[0, 0]
    rng = np.random.default_rng(seed)
    model = tiny_facenet(32).to(home)
    opt = optim.adamw(1e-3)
    state = init_state(model, JAX_INIT_SEED, 7, opt, mesh=mesh)
    batches = [(torch.tensor(rng.random((8, 96, 96, 3)), dtype=torch.float32, device=home),
                torch.tensor(rng.integers(0, 7, 8), dtype=torch.int32, device=home))
               for _ in range(STEPS)]
    return make_train_step(model, opt, mesh=mesh), state, batches


def _synchronize(mesh):
    for d in mesh.distinct_devices():
        torch.cuda.synchronize(d)


def test_sharded_graph_equals_eager_bitwise(exact_cuda, monkeypatch):
    """The sharded step on the (2, 2) mesh of the card repeated: a graph
    and the eager step from one state, 5 float32 steps (C = 7 splits
    4 + 3 over ``mp``): loss, parameters, BatchNorm statistics,
    classifier blocks, Adam moments and counts bitwise equal after every
    step; building the graph left the state as it was; one key
    replayed."""
    _sharded_graph_vs_eager(make_mesh((2, 2), devices=[exact_cuda] * 4), monkeypatch)


def test_sharded_graph_over_distinct_cards_equals_eager_bitwise(exact_cuda, monkeypatch):
    """The same over distinct cards: one graph over every card of the
    mesh, bitwise equal to the eager step after each of 5 float32 steps,
    built without moving the state, one key; each classifier block and
    its moments on its card."""
    _sharded_graph_vs_eager(_distinct_mesh(), monkeypatch)


def _sharded_graph_vs_eager(mesh, monkeypatch):
    built = []
    real = graphs.CapturedCall

    class Recording(real):
        def __init__(self, fn, inputs, pool, state=(), writes=None, others=()):
            super().__init__(fn, inputs, pool, state, writes, others)
            _synchronize(mesh)
            built.append((self, [t.detach().clone() for t in writes]))

    monkeypatch.setattr(graphs, "CapturedCall", Recording)
    eager, state_e, batches_e = _sharded(mesh)
    eager._graphed = lambda device: False
    graphed, state_g, batches_g = _sharded(mesh)
    start = [t.detach().clone() for t in _tensors(state_g)]
    for i in range(STEPS):
        state_e, loss_e = eager(state_e, *batches_e[i])
        state_g, loss_g = graphed(state_g, *batches_g[i])
        _synchronize(mesh)
        assert torch.equal(loss_e, loss_g), (i, float(loss_e), float(loss_g))
        for a, b in zip(_tensors(state_e), _tensors(state_g)):
            assert a.device == b.device and torch.equal(a, b), i
    assert len(graphed.graphs) == 1 and len(eager.graphs) == 0
    ((call, after_build),) = built
    assert call.devices == tuple(mesh.distinct_devices())
    assert all(torch.equal(a, b) for a, b in zip(after_build, start)), "the build moved the state"
    counts = [t for t in _tensors(state_g) if t.dtype == torch.int32]
    assert counts and all(int(t) == STEPS for t in counts)
    _blocks_on_their_cards(state_g, mesh)
    graphed.release_graphs()


def _blocks_on_their_cards(state, mesh):
    n = len(state.params)
    adam = state.opt_state[0]
    for j, dev in enumerate(mesh.devices[0, :]):
        assert state.classifier[j].device == adam.mu[n + j].device == adam.nu[n + j].device == dev


def test_sharded_eager_over_distinct_cards_is_reproducible(exact_cuda):
    """Two eager runs of the sharded step over distinct cards from one
    state, 5 float32 steps: the loss and every tensor of the state
    bitwise equal after each step (the backward runs on the calling
    thread, so every gradient's terms from several cards add in one
    order)."""
    mesh = _distinct_mesh()
    runs = []
    for _ in range(2):
        step, state, batches = _sharded(mesh)
        step._graphed = lambda device: False
        after = []
        for i in range(STEPS):
            state, loss = step(state, *batches[i])
            _synchronize(mesh)
            after.append([loss.clone()] + [t.detach().clone() for t in _tensors(state)])
        assert len(step.graphs) == 0 and state.step == STEPS
        runs.append(after)
    for i, (a, b) in enumerate(zip(*runs)):
        differ = [j for j, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
        assert len(a) == len(b) and not differ, (i, len(differ), len(a), differ[:10])


def test_failed_capture_over_distinct_cards_raises(exact_cuda, monkeypatch):
    """A sharded step over distinct cards that reads the card back cannot
    be captured: it raises, keeps no key, leaves the state as it was,
    and no card is left routing its allocations to a pool: the next
    capture over every card of the mesh works, and so does a one-device
    capture on each of them."""
    mesh = _distinct_mesh()
    real = trainer.sharded_arcface_loss

    def reading(*args, **kwargs):
        loss = real(*args, **kwargs)
        loss.item()  # a host read: refused inside a capture
        return loss

    monkeypatch.setattr(trainer, "sharded_arcface_loss", reading)
    step, state, batches = _sharded(mesh)
    before = [t.detach().clone() for t in _tensors(state)]
    with pytest.raises(RuntimeError):
        step(state, *batches[0])
    assert len(step.graphs) == 0
    _synchronize(mesh)
    assert all(torch.equal(a, b) for a, b in zip(_tensors(state), before))
    monkeypatch.setattr(trainer, "sharded_arcface_loss", real)
    good, state, batches = _sharded(mesh)
    for i in range(2):
        state, loss = good(state, *batches[i])
    _synchronize(mesh)
    assert len(good.graphs) == 1 and bool(torch.isfinite(loss)) and state.step == 2
    ((_, call),) = good.graphs
    assert call.devices == tuple(mesh.distinct_devices())
    for dev in mesh.distinct_devices():
        x = torch.zeros(4, device=dev)
        one = graphs.GraphedStep(lambda st, b: (st[0].add_(b).sum(),), lambda st, out: out[0])
        for _ in range(2):
            total = one([x], torch.ones(4, device=dev))
        assert len(one.graphs) == 1 and float(total) == 8.0, dev


def test_replay_then_eager_read_on_another_card(exact_cuda):
    """Eager work on another card of the mesh, issued right after a
    replay with no synchronisation (a copy of the last classifier block
    and its moments on that card's current stream), sees that replay's
    update: the copies equal the eager step's blocks after each step."""
    mesh = _distinct_mesh()
    eager, state_e, batches_e = _sharded(mesh)
    eager._graphed = lambda device: False
    graphed, state_g, batches_g = _sharded(mesh)
    for i in range(STEPS):
        state_g, _ = graphed(state_g, *batches_g[i])
        adam = state_g.opt_state[0]
        dev = state_g.classifier[-1].device
        assert dev != mesh.devices[0, 0]
        with torch.cuda.device(dev):
            read = [state_g.classifier[-1].detach().clone(), adam.mu[-1].clone(),
                    adam.nu[-1].clone()]
        state_e, _ = eager(state_e, *batches_e[i])
        _synchronize(mesh)
        adam_e = state_e.opt_state[0]
        want = [state_e.classifier[-1], adam_e.mu[-1], adam_e.nu[-1]]
        assert all(torch.equal(a, b) for a, b in zip(read, want)), i
    assert len(graphed.graphs) == 1
    graphed.release_graphs()


def test_failed_sharded_capture_raises(exact_cuda, monkeypatch):
    """A sharded step that reads the card back cannot be captured: it
    raises, nothing runs eagerly in its place (no key kept, the state as
    it was), and the next sharded capture into the device's pool works."""
    mesh = make_mesh((2, 2), devices=[exact_cuda] * 4)
    real = trainer.sharded_arcface_loss

    def reading(*args, **kwargs):
        loss = real(*args, **kwargs)
        loss.item()  # a host read: refused inside a capture
        return loss

    monkeypatch.setattr(trainer, "sharded_arcface_loss", reading)
    step, state, batches = _sharded(mesh)
    before = [t.detach().clone() for t in _tensors(state)]
    with pytest.raises(RuntimeError):
        step(state, *batches[0])
    assert len(step.graphs) == 0
    assert all(torch.equal(a, b) for a, b in zip(_tensors(state), before))
    monkeypatch.setattr(trainer, "sharded_arcface_loss", real)
    good, state, batches = _sharded(mesh)
    state, loss = good(state, *batches[0])
    assert len(good.graphs) == 1 and bool(torch.isfinite(loss)) and state.step == 1
