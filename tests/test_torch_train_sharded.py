"""The port's dp×mp-sharded ArcFace step (``fire_tpu_torch.train.trainer``
with a mesh) against JAX's sharded step and against the port's own
one-device step, on ``tiny_facenet(32)`` at 96², B = 8.

The port's meshes are ``["cpu"] * 4`` (one process drives every entry,
as on a card repeated); JAX's are ``jax.devices()[:4]`` of the 8-device
virtual CPU mesh.  JAX's sharded step is compiled once for the module.

The sharded step is a ``GraphedStep``: its graph path runs here with
the capture faked (``FakeTrainCall`` of ``tests/test_torch_train_graph.py``),
bitwise equal to the eager step on four meshes, against JAX's jitted
sharded step at case 1's tolerances, its keys (the state laid out
first, JAX's retrace for another batch size, another mesh's state
refused), its body under ``NoHostReads``, and the dry run's
``train_plane`` through it; a state over two devices captured over
both, each with its own pool (renewed on every card when a build
fails), and the backward run on the calling thread.

Tolerances.  Against JAX: the loss at rtol 1e-4 over three steps; one
step's parameters and classifier by the Adam-direction bound of
``tests/test_torch_train_arcface.py`` (1e-6 where both directions are
resolved, ``2·lr`` where a gradient too small to resolve flips its
sign); BatchNorm statistics at 1e-5; gradients against JAX's one-device
step in float64 at ``1e-3·max|ref| + 1e-6`` a tensor, as the one-device
test holds them.  Against the port's one-device step (the same
arithmetic with the sums in another order): the loss at rtol 1e-5, the
statistics at 1e-6, and the Adam moments (``mu``, ``nu``) within 1e-3
of the model's largest: float32 gradients of this model scatter where
BatchNorm's fast variance cancels, and the sharded sums moved them by
up to 4.0e-4 of the largest (``mu``) and 3.4e-4 (``nu``) in these
cases."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from fire_tpu.models.facenet import tiny_facenet as jax_tiny_facenet
from fire_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fire_tpu.train.trainer import init_state as jax_init_state
from fire_tpu.train.trainer import make_train_step as jax_make_train_step
from fire_tpu.train.trainer import state_shardings as jax_state_shardings
from fire_tpu_torch.models.facenet import Block35, tiny_facenet
from fire_tpu_torch.models.layers import BatchNorm
from fire_tpu_torch.parallel.shards import ShardList
from fire_tpu_torch.parallel.mesh import column_devices, make_mesh, split_columns
from fire_tpu_torch.runtime.graphs import GraphedStep
from fire_tpu_torch.train import __main__ as arcface_cli
from fire_tpu_torch.train import optim, state_shardings
from fire_tpu_torch.train.losses import column_sharded_cross_entropy
from fire_tpu_torch.train.trainer import (JAX_INIT_SEED, Sharding, TrainState, gather_state,
                                          init_state,
                                          is_sharded, make_train_step, model_batch_stats,
                                          restore_checkpoint, save_checkpoint, shard_state,
                                          sharded_arcface_loss)
from fire_tpu_torch.weights import carry_state, flatten, params_list, to_flax
from tests.test_torch_train_arcface import _grad_lists, _jax_loss_and_grads
from tests.test_torch_train_graph import NoHostReads, _graph_path, fake_capture  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

HW = (96, 96)
LR = 1e-3
STEPS = 3


def _mesh(shape=(2, 2)):
    return make_mesh(shape, devices=["cpu"] * 4)


def _batch(classes=8, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.random((8, *HW, 3)).astype(np.float32)
    return images, (np.arange(8) % classes).astype(np.int32)


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's (2, 2)-sharded run from its own initial state: the start
    and each step's state as numpy, the losses, the batch; the losses
    of JAX's one-device run from the same state; JAX's jitted (2, 2)
    step and its last state."""
    opt = optax.adamw(LR)
    model = jax_tiny_facenet(32, dtype=jnp.float32)
    start_state = jax_init_state(model, jax.random.PRNGKey(0), 8, opt, image_hw=HW)
    start = jax.tree.map(np.asarray, start_state)
    images, labels = _batch()
    runs = {}
    for name, mesh in (("2x2", jax_make_mesh((2, 2), devices=jax.devices()[:4])), ("one", None)):
        step = jax_make_train_step(model, opt, mesh=mesh)
        state, states, losses = start_state, [], []
        for _ in range(STEPS):
            state, loss = step(state, jnp.asarray(images), jnp.asarray(labels))
            losses.append(float(loss))
            states.append(jax.tree.map(np.asarray, state))
        runs[name] = states, losses, (step, state)
    return (start, runs["2x2"][0], runs["2x2"][1], runs["one"][1], images, labels,
            runs["2x2"][2])


def _port_sharded(start, mesh):
    """The port's state on ``mesh`` carried from JAX's numpy ``start``."""
    model = tiny_facenet(32)
    opt_state = carry_state(model, {"params": start.params, "batch_stats": start.batch_stats},
                            start.opt_state, mesh=mesh)
    classifier = split_columns(torch.tensor(start.classifier).requires_grad_(True),
                               column_devices(mesh))
    return model, TrainState(list(model.parameters()), model_batch_stats(model), classifier,
                             opt_state, 0)


def _assert_adam_bound(before, ours, theirs):
    """One AdamW step of ``ours`` and ``theirs`` from ``before`` agree at
    1e-6 where both Adam directions are resolved (same sign, magnitude
    ≥ 0.9999), and within ``2·lr`` everywhere; at least half resolved."""
    resolved = total = 0
    for p0, a, b in zip(before, ours, theirs):
        da, db = a - p0, b - p0
        u_a, u_b = -da / LR - 1e-4 * p0, -db / LR - 1e-4 * p0
        ok = (np.sign(u_a) == np.sign(u_b)) & (np.minimum(np.abs(u_a), np.abs(u_b)) >= 0.9999)
        d = np.abs(da - db)
        assert d[ok].max(initial=0.0) <= 1e-6
        assert d.max() <= 2 * LR * (1 + 1e-3) + 1e-6
        resolved, total = resolved + ok.sum(), total + ok.size
    assert resolved >= 0.5 * total


def _numpy(tensors):
    return [t.detach().cpu().numpy().copy() for t in tensors]


def test_sharded_step_matches_jax_sharded_step(jax_sharded):
    """Case 1: the port's (2, 2) step against JAX's (2, 2) step from one
    state: the losses of three steps, and after the first the
    parameters, the gathered classifier and the BatchNorm statistics.

    The first loss is held at rtol 1e-4.  The later ones cannot be:
    Adam's first step moves every parameter by about ``lr·sign(g)``, so
    where a gradient is rounding noise the two runs step apart, and JAX's
    own (2, 2) and one-device runs differ by 2.1e-3 (relative) in the
    second loss and 6.3e-2 in the third.  The port is held to twice that
    spread of JAX's against itself, or 1e-4, whichever is larger."""
    _against_jax_sharded(jax_sharded, graphed=False)


def test_sharded_graph_path_matches_jax_sharded_step(jax_sharded, fake_capture):
    """Case 1 through the sharded step's graph path (the capture faked
    by ``FakeTrainCall``): one key, built without moving the state and
    replayed three times, against JAX's jitted (2, 2) step at case 1's
    tolerances."""
    _against_jax_sharded(jax_sharded, graphed=True)
    (call,) = fake_capture
    assert call.build_kept_state and call.replays == STEPS


def _against_jax_sharded(jax_sharded, graphed: bool):
    start, jstates, jlosses, jlosses_one, images, labels, _ = jax_sharded
    mesh = _mesh()
    model, state = _port_sharded(start, mesh)
    step = make_train_step(model, optim.adamw(LR), mesh=mesh)
    if graphed:
        _graph_path(step)
    before = _numpy(params_list(model, start.params)) + [start.classifier]
    losses = []
    for i in range(STEPS):
        state, loss = step(state, torch.tensor(images), torch.tensor(labels))
        losses.append(float(loss))
        if i == 0:
            ours = _numpy(state.params + [gather_state(state).classifier])
            stats = {k: v.copy() for k, v in flatten(to_flax(model)["batch_stats"]).items()}
    assert abs(losses[0] - jlosses[0]) <= 1e-4 * abs(jlosses[0])
    for got, want, one in zip(losses, jlosses, jlosses_one):
        assert abs(got - want) <= max(1e-4 * abs(want), 2 * abs(one - want)), \
            (losses, jlosses, jlosses_one)
    assert state.step == STEPS and all(b.shape == (32, 4) for b in state.classifier)
    j1 = jstates[0]
    theirs = _numpy(params_list(model, j1.params)) + [j1.classifier]
    _assert_adam_bound(before, ours, theirs)
    for k, v in flatten(j1.batch_stats).items():
        np.testing.assert_allclose(stats[k], v, rtol=0, atol=1e-5, err_msg="/".join(k))


def test_sharded_gradients_match_jax_float64(jax_sharded):
    """Case 2: the sharded loss's gradients (the loss the step
    differentiates) against JAX's one-device step in float64."""
    start, _, _, _, images, labels, _ = jax_sharded
    mesh = _mesh()
    model, state = _port_sharded(start, mesh)
    loss = sharded_arcface_loss(model, state.classifier, torch.tensor(images),
                                torch.tensor(labels), mesh)
    grads = torch.autograd.grad(loss, state.params + state.classifier)
    n = len(state.params)
    ours = [g.double().numpy() for g in grads[:n]] + [
        torch.cat(grads[n:], dim=1).double().numpy()]
    loss64, gp64, gc64 = _jax_loss_and_grads(start, images, labels, np.float64)
    assert abs(loss.item() - loss64) <= 1e-4 * abs(loss64)
    names = [k for k, _ in model.named_parameters()] + ["classifier"]
    for name, g, ref in zip(names, ours, _grad_lists(model, gp64, gc64)):
        tol = 1e-3 * np.abs(ref).max() + 1e-6
        assert np.abs(g - ref).max() <= tol, (name, np.abs(g - ref).max(), tol)


@pytest.mark.parametrize("shape,classes", [((4, 1), 8), ((1, 4), 8), ((2, 2), 8), ((2, 2), 7)],
                         ids=["dp4", "mp4", "dp2xmp2", "dp2xmp2-C7"])
def test_sharded_step_equals_one_device_step(shape, classes):
    """Case 3: one step on a mesh against the port's ``mesh=None`` step
    from one state (C = 7 splits 4 + 3 over ``mp``)."""
    images, labels = _batch(classes)
    out = {}
    for name, mesh in (("one", None), ("mesh", _mesh(shape))):
        model = tiny_facenet(32)
        opt = optim.adamw(LR)
        state = init_state(model, JAX_INIT_SEED, classes, opt, mesh=mesh)
        before = _numpy(state.params + [gather_state(state).classifier])
        state, loss = make_train_step(model, opt, mesh=mesh)(
            state, torch.tensor(images), torch.tensor(labels))
        assert is_sharded(state) == (mesh is not None)
        out[name] = (float(loss), gather_state(state), _numpy(model_batch_stats(model)))
    (l1, s1, b1), (l2, s2, b2) = out["one"], out["mesh"]
    assert abs(l2 - l1) <= 1e-5 * abs(l1)
    assert s2.step == s1.step == 1
    for a, b in zip(b2, b1):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    _assert_adam_bound(before, _numpy(s2.params + [s2.classifier]),
                       _numpy(s1.params + [s1.classifier]))
    adam2, adam1 = s2.opt_state[0], s1.opt_state[0]
    for field in ("mu", "nu"):
        ours, ref = _numpy(getattr(adam2, field)), _numpy(getattr(adam1, field))
        scale = max(np.abs(r).max() for r in ref)
        worst = max(np.abs(a - r).max() for a, r in zip(ours, ref))
        assert worst <= 1e-3 * scale, (field, worst / scale)


def _tensors(state):
    return [t for t in jax.tree.leaves(state) if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("shape,classes", [((4, 1), 8), ((1, 4), 8), ((2, 2), 8), ((2, 2), 7)],
                         ids=["dp4", "mp4", "dp2xmp2", "dp2xmp2-C7"])
def test_sharded_graph_path_equals_eager_bitwise(shape, classes, fake_capture):
    """The sharded step's graph path (the capture faked by
    ``FakeTrainCall``) against the eager step from one state, over
    three batches: the loss and every tensor of the state (parameters,
    BatchNorm statistics, classifier blocks, moments, counts) bitwise
    equal after each step; one key, built without moving the state and
    replayed three times."""
    runs = {}
    for name in ("eager", "graph"):
        mesh = _mesh(shape)
        model = tiny_facenet(32)
        opt = optim.adamw(LR)
        state = init_state(model, JAX_INIT_SEED, classes, opt, mesh=mesh)
        step = make_train_step(model, opt, mesh=mesh)
        if name == "graph":
            _graph_path(step)
        after = []
        for i in range(STEPS):
            images, labels = _batch(classes, seed=i)
            state, loss = step(state, torch.tensor(images), torch.tensor(labels))
            after.append([loss.clone()] + [t.detach().clone() for t in _tensors(state)])
        runs[name] = step, after
    for i, (a, b) in enumerate(zip(runs["eager"][1], runs["graph"][1])):
        same = [torch.equal(x, y) for x, y in zip(a, b)]
        assert len(a) == len(b) and all(same), (shape, classes, i, same.count(False))
    assert len(runs["eager"][0].graphs) == 0 and len(runs["graph"][0].graphs) == 1
    (call,) = fake_capture
    assert call.build_kept_state and call.replays == STEPS


def test_sharded_graph_keys_lay_out_first_and_follow_retraces(jax_sharded, fake_capture):
    """An unsharded state is laid out before the key is taken: the first
    call's key holds the laid-out blocks, and the state it returns gets
    the same key at the next call.  Fixed-shape batches keep one key, a
    batch of another size takes a second, as JAX's jitted (2, 2) step
    compiles once more for it; a state laid out for another mesh raises
    before anything runs."""
    jstep, jstate = jax_sharded[-1]
    mesh = _mesh()
    model = tiny_facenet(32)
    opt = optim.adamw(LR)
    state = init_state(model, JAX_INIT_SEED, 8, opt)
    assert not is_sharded(state)
    step = _graph_path(make_train_step(model, opt, mesh=mesh))
    images, labels = _batch()
    for _ in range(2):
        state, _ = step(state, torch.tensor(images), torch.tensor(labels))
    assert is_sharded(state) and len(step.graphs) == 1
    ((key, _),) = step.graphs
    assert set(map(id, _tensors(state))) == set(key[-1])
    assert [c.replays for c in fake_capture] == [2]
    compiled = jstep._cache_size()
    step(state, torch.tensor(images[:4]), torch.tensor(labels[:4]))
    jstep(jstate, jnp.asarray(images[:4]), jnp.asarray(labels[:4]))
    assert len(step.graphs) == 2 and jstep._cache_size() == compiled + 1
    assert [c.replays for c in fake_capture] == [2, 1]
    other = shard_state(_mesh((1, 4)), gather_state(state))
    with pytest.raises(ValueError, match="another mesh"):
        step(other, torch.tensor(images), torch.tensor(labels))
    assert len(step.graphs) == 2 and len(fake_capture) == 2


def test_unsharded_state_passed_twice_keeps_one_key(fake_capture):
    """One unsharded state passed twice, the returned state not threaded:
    the second call lays it out into the tensors of the first layout, so
    one key is captured and replayed twice, and the graph path gives the
    eager step's loss and state bitwise (the classifier and its moments
    laid out afresh, the tensors shared with the unsharded state
    advanced in place, as the eager step does)."""
    runs = {}
    images, labels = map(torch.tensor, _batch())
    for name in ("eager", "graph"):
        mesh = _mesh()
        model = tiny_facenet(32)
        opt = optim.adamw(LR)
        start = init_state(model, JAX_INIT_SEED, 8, opt)
        step = make_train_step(model, opt, mesh=mesh)
        if name == "graph":
            _graph_path(step)
        outs = []
        for _ in range(2):
            state, loss = step(start, images, labels)
            outs.append([loss.clone()] + [t.detach().clone() for t in _tensors(state)])
        assert state.step == 1
        runs[name] = step, outs
    assert len(runs["graph"][0].graphs) == 1 and [c.replays for c in fake_capture] == [2]
    for a, b in zip(runs["eager"][1], runs["graph"][1]):
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(runs["graph"][1][0][0], runs["graph"][1][1][0])


def test_state_on_several_devices_is_captured_over_all_of_them(fake_capture, monkeypatch):
    """Where the state lies never turns the graph off: a state on one
    device is captured (the sharded step on a mesh that repeats one
    card, as the CPU meshes here do), and so is a state whose tensors
    lie on two devices (the sharded step over distinct cards; here a
    second tensor on the ``meta`` device, which the body leaves alone):
    the second device goes to the capture as its other card, with that
    device's own pool.  Each key is captured once and replayed; nothing
    runs eagerly beside the replays."""
    from fire_tpu_torch.runtime import graphs

    def body(state, x):
        return (state[0].add_(x).sum(),)

    def finish(state, out):
        return state, out[0]

    pools, meta = iter(range(100)), torch.device("meta")
    monkeypatch.setattr(graphs, "_POOLS", {})
    monkeypatch.setattr(graphs, "_new_pool", lambda: next(pools))
    for other in ("cpu", "meta"):
        step = _graph_path(GraphedStep(body, finish))
        state = [torch.zeros(3), torch.zeros(3, device=other)]
        for _ in range(2):
            _, total = step(state, torch.ones(3))
        # the fake's warm-up leaves the state as it was: two replays, two adds
        assert float(total) == 6.0 and len(step.graphs) == 1, other
        others = [] if other == "cpu" else [(meta, graphs._POOLS[meta][0])]
        assert list(fake_capture[-1].others) == others, other
    assert [c.replays for c in fake_capture] == [2, 2]
    assert graphs._POOLS[torch.device("cpu")][0] != graphs._POOLS[meta][0]


def test_failed_build_renews_the_pool_of_every_card(monkeypatch):
    """``GraphCache.get`` hands a graph over several cards each card's
    shared pool, the first card's first; a build that fails keeps no key
    and leaves every one of those cards to take a new pool, and a built
    graph is a user of each card's pool."""
    from fire_tpu_torch.runtime import graphs

    pools, cpu, meta = iter(range(100)), torch.device("cpu"), torch.device("meta")
    monkeypatch.setattr(graphs, "_POOLS", {})
    monkeypatch.setattr(graphs, "_new_pool", lambda: next(pools))
    cache, given = graphs.GraphCache(), []

    def failing(*pools):
        given.append(pools)
        raise RuntimeError("the capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        cache.get((cpu, "key"), failing, [meta])
    assert len(cache) == 0 and graphs._POOLS == {}

    class Graph:
        pass

    graph = cache.get((cpu, "key"), lambda *pools: given.append(pools) or Graph(), [meta])
    assert given == [(0, 1), (2, 3)] and cache.find((cpu, "key")) is graph
    assert all(graph in graphs._POOLS[d][1] for d in (cpu, meta))


def test_sharded_backward_runs_on_the_calling_thread(monkeypatch):
    """The sharded step differentiates with the autograd engine's
    multithreading off, read from inside its backward; the one-device
    step's backward keeps the engine's default (on)."""
    from fire_tpu_torch.train import trainer

    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            seen.append(torch._C._is_multithreading_enabled())
            return g

    for name, mesh in (("sharded_arcface_loss", _mesh()), ("arcface_loss", None)):
        real = getattr(trainer, name)
        monkeypatch.setattr(trainer, name, lambda *a, real=real, **k: Probe.apply(real(*a, **k)))
        model = tiny_facenet(32)
        opt = optim.adamw(LR)
        state = init_state(model, JAX_INIT_SEED, 8, opt, mesh=mesh)
        images, labels = _batch()
        make_train_step(model, opt, mesh=mesh)(state, torch.tensor(images), torch.tensor(labels))
    assert seen == [False, True]
    assert torch._C._is_multithreading_enabled()


def test_sharded_body_makes_no_host_reads():
    """After its first call, the sharded step, fed tensors as the
    graph's static inputs are, reads nothing back to the host and makes
    no host constant (``NoHostReads``, the CPU proxy for capturable)."""
    mesh = _mesh()
    model = tiny_facenet(32)
    opt = optim.adamw(LR)
    state = init_state(model, JAX_INIT_SEED, 7, opt, mesh=mesh)
    step = make_train_step(model, opt, mesh=mesh)
    batches = [tuple(map(torch.tensor, _batch(7, seed=i))) for i in range(2)]
    state, _ = step(state, *batches[0])
    with NoHostReads():
        step(state, *batches[1])


def test_dryrun_train_plane_through_the_graph_path(fake_capture, monkeypatch):
    """``dryrun.train_plane`` on the dry run's (4, 2) CPU mesh: through
    the sharded step's graph path, one capture replayed once, its loss
    equals the eager step's."""
    from fire_tpu_torch import dryrun
    from fire_tpu_torch.runtime import graphs

    mesh = dryrun.dryrun_mesh(8, ["cpu"] * 8)
    eager = dryrun.train_plane(mesh)
    monkeypatch.setattr(graphs.GraphedStep, "_graphed", lambda self, device: True)
    assert dryrun.train_plane(mesh) == eager
    assert [c.replays for c in fake_capture] == [1]


def test_batch_norm_takes_the_whole_batchs_statistics():
    """Case 4: four ``dp`` shards with means 0, 10, 20, 30: the sharded
    BatchNorm normalises with, and updates its running statistics once
    from, the statistics of the whole batch, not any shard's; outputs and
    input gradients equal the unsharded layer's."""
    rng = np.random.default_rng(7)
    shards = [torch.tensor(rng.standard_normal((2, 3, 5, 5)).astype(np.float32) + 10.0 * i,
                           requires_grad=True) for i in range(4)]
    whole = torch.cat([s.detach() for s in shards]).requires_grad_(True)
    ref_bn, bn = BatchNorm(3, 1e-3, momentum=0.9), BatchNorm(3, 1e-3, momentum=0.9)
    ref_out = ref_bn(whole, train=True)
    outs = bn(ShardList(shards), train=True).shards
    np.testing.assert_allclose(torch.cat(outs).detach().numpy(), ref_out.detach().numpy(),
                               rtol=0, atol=1e-5)
    for ours, ref in ((bn.running_mean, ref_bn.running_mean), (bn.running_var, ref_bn.running_var)):
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    # the whole batch's mean is 15; momentum once: 0.9·0 + 0.1·15
    np.testing.assert_allclose(bn.running_mean.numpy(), 1.5, atol=0.05)
    per_shard = 0.1 * torch.stack([s.detach().mean((0, 2, 3)) for s in shards])
    assert float((per_shard - bn.running_mean).abs().min()) > 0.4
    w = torch.tensor(rng.standard_normal(ref_out.shape).astype(np.float32))
    (ref_out * w).sum().backward()
    (torch.cat(outs) * w).sum().backward()
    np.testing.assert_allclose(torch.cat([s.grad for s in shards]).numpy(),
                               whole.grad.numpy(), rtol=0, atol=1e-4)


def test_shard_list_carries_a_block_shard_by_shard():
    """A ShardList of three shards through an Inception-ResNet-A block
    (convolutions, concatenation, the scaled residual sum, BatchNorm in
    train mode) equals the block on the whole batch: outputs, running
    statistics, and the parameters' gradients summed over the shards."""
    torch.manual_seed(3)
    whole_block = Block35(16, 4)
    block = copy.deepcopy(whole_block)
    x = torch.randn(6, 16, 9, 9)
    w = torch.randn(6, 16, 9, 9)
    ref = whole_block(x, train=True)
    ref_grads = torch.autograd.grad((ref * w).sum(), list(whole_block.parameters()))
    out = block(ShardList([x[:2], x[2:4], x[4:]]), train=True)
    assert isinstance(out, ShardList) and len(out.shards) == 3
    got = torch.cat(out.shards)
    grads = torch.autograd.grad((got * w).sum(), list(block.parameters()))
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), rtol=0, atol=1e-5)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    for a, b in zip(model_batch_stats(block), model_batch_stats(whole_block)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_column_sharded_cross_entropy_equals_the_whole_softmax():
    """Case 5: C = 7 over ``mp = 2`` (blocks of 4 and 3), labels in both
    blocks, logits of scale 64: value and gradient of the row sum over
    B equal ``F.cross_entropy`` on the whole logits."""
    rng = np.random.default_rng(8)
    logits = torch.tensor((rng.random((6, 7)) * 2 - 1).astype(np.float32) * 64,
                          requires_grad=True)
    labels = torch.tensor([0, 3, 4, 6, 2, 5])
    ref = F.cross_entropy(logits, labels)
    (g_ref,) = torch.autograd.grad(ref, logits)
    blocks = [logits[:, :4], logits[:, 4:]]
    # two dp row blocks of 3, each divided by the global B
    ours = sum(column_sharded_cross_entropy([b[r] for b in blocks], labels[r], [0, 4], 6)
               for r in (slice(0, 3), slice(3, 6)))
    (g,) = torch.autograd.grad(ours, logits)
    assert abs(ours.item() - ref.item()) <= 1e-5 * abs(ref.item())
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=0, atol=1e-6)


def test_shard_gather_and_mesh_independent_checkpoints(tmp_path):
    """Case 6: ``shard_state`` / ``gather_state`` round-trip bitwise; the
    layout is JAX's (three column-sharded leaves: the classifier and
    its two moments); a checkpoint saved on (2, 2) restores bitwise with
    ``mesh=None`` and on (2, 2), and one saved unsharded restores on
    (2, 2), each classifier moment with its block."""
    mesh = _mesh()
    images, labels = _batch(7)
    model = tiny_facenet(32)
    opt = optim.adamw(LR)
    state = init_state(model, JAX_INIT_SEED, 7, opt, mesh=mesh)
    state, _ = make_train_step(model, opt, mesh=mesh)(
        state, torch.tensor(images), torch.tensor(labels))
    cols = [s.devices for s in jax.tree.leaves(state_shardings(mesh, gather_state(state)),
                                               is_leaf=lambda x: isinstance(x, Sharding))
            if isinstance(s, Sharding) and s.dim == 1]
    jmesh = jax_make_mesh((2, 2), devices=jax.devices()[:4])
    jstate = jax_init_state(jax_tiny_facenet(32, dtype=jnp.float32), jax.random.PRNGKey(0), 7,
                            optax.adamw(LR), image_hw=HW)
    jcols = [s for s in jax.tree.leaves(jax_state_shardings(jmesh, jstate))
             if s.spec == jax.sharding.PartitionSpec(None, "mp")]
    assert len(cols) == len(jcols) == 3
    assert all(list(c) == column_devices(mesh) for c in cols)

    def tree(s):
        g = gather_state(s)
        adam = g.opt_state[0]
        return _numpy(g.params + g.batch_stats + [g.classifier] + adam.mu + adam.nu)

    def assert_equal(a, b):
        assert a.step == b.step
        for x, y in zip(tree(a), tree(b)):
            np.testing.assert_array_equal(x, y)

    def assert_laid_out(s):
        adam = s.opt_state[0]
        n = len(s.params)
        for j, dev in enumerate(column_devices(mesh)):
            widths = {s.classifier[j].shape, adam.mu[n + j].shape, adam.nu[n + j].shape}
            assert widths == {(32, 4 - j)}
            assert s.classifier[j].device == adam.mu[n + j].device == torch.device(dev)
            assert s.classifier[j].requires_grad and s.classifier[j].is_leaf

    assert_laid_out(state)
    assert_equal(shard_state(mesh, gather_state(state)), state)
    save_checkpoint(str(tmp_path / "sharded"), state)
    saved = tree(state)
    # a fresh model and state on each side, restored from the file
    for target_mesh in (None, mesh):
        fresh = init_state(tiny_facenet(32), JAX_INIT_SEED + 1, 7, optim.adamw(LR),
                           mesh=target_mesh)
        restored = restore_checkpoint(str(tmp_path / "sharded"), fresh)
        assert is_sharded(restored) == (target_mesh is not None)
        assert restored.step == 1
        for x, y in zip(tree(restored), saved):
            np.testing.assert_array_equal(x, y)
        if target_mesh is not None:
            assert_laid_out(restored)
    save_checkpoint(str(tmp_path / "whole"), gather_state(state))
    restored = restore_checkpoint(str(tmp_path / "whole"), init_state(
        tiny_facenet(32), JAX_INIT_SEED + 1, 7, optim.adamw(LR), mesh=mesh))
    assert_laid_out(restored)
    for x, y in zip(tree(restored), saved):
        np.testing.assert_array_equal(x, y)


def test_carry_state_onto_a_mesh_equals_shard_state(jax_sharded):
    """``carry_state(..., mesh=)`` splits the classifier's moments as
    ``shard_state`` splits a state carried whole."""
    start = jax_sharded[0]
    mesh = _mesh()
    _, sharded = _port_sharded(start, mesh)
    model = tiny_facenet(32)
    opt_state = carry_state(model, {"params": start.params, "batch_stats": start.batch_stats},
                            start.opt_state)
    whole = TrainState(list(model.parameters()), model_batch_stats(model),
                       torch.tensor(start.classifier).requires_grad_(True), opt_state, 0)
    laid = shard_state(mesh, whole)
    for a, b in zip(sharded.opt_state[0].mu + sharded.opt_state[0].nu + sharded.classifier,
                    laid.opt_state[0].mu + laid.opt_state[0].nu + laid.classifier):
        assert a.shape == b.shape and a.device == b.device
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())


def test_batch_not_divisible_by_dp_and_failing_shard_raise(monkeypatch):
    """Case 7: B = 6 on dp = 4 raises naming ``dp``; a shard whose
    forward raises makes the step raise that error, and no step is
    taken from the other shards: the parameters, the classifier, the
    optimizer state and the step count stay as they were."""
    mesh = _mesh((4, 1))
    model = tiny_facenet(32)
    opt = optim.adam(1e-3)
    state = init_state(model, JAX_INIT_SEED, 8, opt, mesh=mesh)
    step = make_train_step(model, opt, mesh=mesh)
    images, labels = _batch()
    with pytest.raises(ValueError, match="dp = 4"):
        step(state, torch.tensor(images[:6]), torch.tensor(labels[:6]))

    before = _numpy(state.params + state.classifier + state.opt_state[0].mu)
    real, calls = F.conv2d, []

    def conv2d(x, *args, **kwargs):
        calls.append(x)
        if len(calls) == 2:  # the second convolution: shard 2 loses its channels
            x = ShardList([s[:, :1] if i == 2 else s for i, s in enumerate(x.shards)])
        return real(x, *args, **kwargs)

    monkeypatch.setattr(F, "conv2d", conv2d)
    with pytest.raises(RuntimeError, match="channels"):
        step(state, torch.tensor(images), torch.tensor(labels))
    assert len(calls) == 2 and state.step == 0 and state.opt_state[0].count == 0
    for a, b in zip(_numpy(state.params + state.classifier + state.opt_state[0].mu), before):
        np.testing.assert_array_equal(a, b)


def test_cli_mesh_rule_and_one_device_flags(tmp_path, monkeypatch, caplog):
    """Case 8: the JAX CLI's mesh for n = 1…8 devices (``mp = 2`` when n
    is even), and ``--device cpu`` trains on the CPU alone however many
    cards there are."""
    expected = {1: (1, 1), 2: (1, 2), 3: (3, 1), 4: (2, 2), 5: (5, 1), 6: (3, 2), 7: (7, 1),
                8: (4, 2)}
    for n, shape in expected.items():
        assert arcface_cli.mesh_shape(n) == shape
        mp = 2 if n % 2 == 0 else 1  # fire_tpu/train/__main__.py's rule
        assert shape == (n // mp, mp)
    from fire_tpu_torch.utils import imageio
    rng = np.random.default_rng(0)
    for ident in ("a", "b"):
        (tmp_path / "data" / ident).mkdir(parents=True)
        for i in range(4):
            imageio.imwrite(str(tmp_path / "data" / ident / f"{i}.png"),
                            rng.integers(0, 255, (96, 96, 3)).astype(np.uint8))
    from fire_tpu_torch.models import facenet as facenet_mod
    real = facenet_mod.FaceNet
    monkeypatch.setattr(facenet_mod, "FaceNet", lambda embed_dim, dropout_rate=0.0, **_: real(
        embed_dim=embed_dim, depths=(1, 1, 1), stem_width=8, dropout_rate=dropout_rate))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    out = tmp_path / "enc.msgpack"
    with caplog.at_level("INFO", logger="fire_tpu_torch.train"):
        arcface_cli.main(["--data", str(tmp_path / "data"), "--encoder", "128", "--epochs", "1",
                          "--batch", "4", "--image_size", "96", "--out", str(out),
                          "--log_every", "1", "--device", "cpu"])
    assert out.exists()
    assert not any(r.getMessage().startswith("mesh:") for r in caplog.records)


def test_clip_adam_on_a_sharded_state_equals_unsharded_and_optax():
    """``chain(clip_by_global_norm(1.0), adam(1e-3))`` over tensors whose
    last one is split into column blocks (a state sharded over
    ``["cpu"] * 2``) gives the unsharded updates and optax's, at 1e-6."""
    rng = np.random.default_rng(9)
    params = [rng.standard_normal((4, 3)).astype(np.float32),
              rng.standard_normal((8, 5)).astype(np.float32)]
    grads = [[(rng.standard_normal(p.shape) * 3).astype(np.float32) for p in params]
             for _ in range(3)]
    devices = column_devices(make_mesh((1, 2), devices=["cpu"] * 2))

    def port(sharded):
        opt = optim.chain(optim.clip_by_global_norm(1.0), optim.adam(1e-3))

        def lay(ts):
            ts = [torch.tensor(t) for t in ts]
            return ts[:1] + split_columns(ts[1], devices) if sharded else ts

        state = opt.init(lay(params))
        out = []
        for g in grads:
            upd, state = opt.update(lay(g), state, lay(params))
            out.append([u.numpy() for u in upd[:1]] + [np.concatenate(
                [u.numpy() for u in upd[1:]], axis=1)])
        return out

    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    jstate = jopt.init(params)
    ref = []
    for g in grads:
        upd, jstate = jopt.update(g, jstate, params)
        ref.append([np.asarray(u) for u in upd])
    for ours, whole, theirs in zip(port(True), port(False), ref):
        for a, b, c in zip(ours, whole, theirs):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)
