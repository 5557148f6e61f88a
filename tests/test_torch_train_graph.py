"""The one-device training steps run the way JAX runs them, held on the
CPU against the JAX package: the optimizer's counts on the device, the
graphed path of each step (``runtime/graphs.py`` ``GraphedStep``), its
keys, the bound scene pool, and checkpoints of the device counts.  The
graphs themselves are captured on the card only
(``tests/test_torch_train_graph_cuda.py``).

* The optimizers' counts are 0-d int32 tensors on the parameters'
  device, updated in place; ``adam``, ``adamw`` and the detector CLIs'
  clipped AdamW with a cosine schedule that passes its end in the six
  steps match optax at ``test_torch_train_optim.py``'s 1e-6.
* With the capture replaced by a stand-in that runs the real warm-up
  (the state copied before it and back after it) and then the step on
  its static inputs at each replay (``FakeTrainCall``, after
  ``test_torch_frame_graph.py``'s ``FakeCall``), the graphed path of the ArcFace step, the YuNet pool
  and dense steps and the BlazeFace and RetinaFace pool steps equals
  the eager step bitwise over 5 steps (losses, parameters, BatchNorm
  statistics, moments, counts); its first step matches JAX's jitted
  step within the parity tests' tolerances (``test_torch_train_arcface.py``
  one step's parameters, ``test_torch_train_detect.py`` a pool step's
  loss at rtol 1e-4); building the graph leaves the state bitwise as it
  was; its keys follow JAX's retraces (one for fixed-shape batches, a
  new one for a new batch shape); the pool is bound, not copied, its
  refreshed rows read at the next step, and another pool gets its own
  key.
* Each step's body reads nothing back to the host and makes no host
  constant after its first call: it runs under a dispatch mode that
  raises on ``_local_scalar_dense``, ``nonzero``, ``masked_select``,
  ``unique``, a boolean-mask ``index`` and ``lift_fresh`` (a tensor made
  from host data), the CPU proxy for "capturable".
* On a CPU device nothing is captured.

Sizes as the parity tests': ``tiny_facenet(32)`` at 96² (8 classes,
B = 8), YuNet ``width=8`` at 96², BlazeFace at a 64² input, RetinaFace
``width=16`` with one block a stage at 128²."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from fire_tpu.models.blazeface import BlazeFace as JaxBlazeFace
from fire_tpu.models.facenet import tiny_facenet as jax_tiny_facenet
from fire_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from fire_tpu.models.yunet import YuNet as JaxYuNet
from fire_tpu.train import detect as jax_detect
from fire_tpu.train import detect_blaze as jax_blaze
from fire_tpu.train import detect_retina as jax_retina
from fire_tpu.train.trainer import init_state as jax_init_state
from fire_tpu.train.trainer import make_train_step as jax_make_train_step
from fire_tpu_torch.models.blazeface import BlazeFace
from fire_tpu_torch.models.facenet import tiny_facenet
from fire_tpu_torch.models.retinaface import RetinaFace
from fire_tpu_torch.models.yunet import YuNet
from fire_tpu_torch.runtime import graphs
from fire_tpu_torch.train import TrainState, detect, detect_blaze, detect_retina, optim
from fire_tpu_torch.train.scenes import compose_scene, make_identities
from fire_tpu_torch.train.trainer import (make_train_step, model_batch_stats, restore_checkpoint,
                                          save_checkpoint, state_tree)
from fire_tpu_torch.weights import (carry_state, flax_shapes, load_flax, materialize,
                                    msgpack_serialize, params_list)
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6  # test_torch_train_optim.py
LR = 1e-3
STEPS = 5


# ------------------------------------------------------------- optimizer --


def _counts(state):
    """The count tensors of an optimizer state, optax's or the port's, in order."""
    if hasattr(state, "_fields") and "count" in state._fields:
        return [state.count]
    if isinstance(state, tuple):
        return [c for s in state for c in _counts(s)]
    return []


OPTIMIZERS = {
    "adam": (lambda: optax.adam(1e-3), lambda: optim.adam(1e-3)),
    "adamw": (lambda: optax.adamw(2e-3), lambda: optim.adamw(2e-3)),
    "clip_adamw_cosine": (
        lambda: optax.chain(optax.clip_by_global_norm(5.0),
                            optax.adamw(optax.cosine_decay_schedule(2e-3, 4, 0.05))),
        lambda: optim.chain(optim.clip_by_global_norm(5.0),
                            optim.adamw(optim.cosine_decay_schedule(2e-3, 4, 0.05)))),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_device_counts_match_optax_over_six_steps(name):
    """The counts are 0-d int32 tensors on the parameters' device,
    updated in place, equal to optax's; six steps' updates and moments
    match optax (the cosine schedule passes its end, 4, at count 4)."""
    rng = np.random.default_rng(7)
    make_j, make_t = OPTIMIZERS[name]
    jopt, topt = make_j(), make_t()
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    jstate = jopt.init(params)
    tparams = [torch.tensor(params["a"]), torch.tensor(params["b"])]
    tstate = topt.init(tparams)
    counts = _counts(tstate)
    assert len(counts) == len(_counts(jstate)) >= 1
    for c in counts:
        assert isinstance(c, torch.Tensor) and c.shape == () and c.dtype == torch.int32
        assert c.device == tparams[0].device and int(c) == 0
    for step, scale in enumerate((0.5, 8.0, 20.0, 0.1, 3.0, 1.0)):
        grads = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        jup, jstate = jopt.update(grads, jstate, params)
        tup, tstate = topt.update([torch.tensor(grads["a"]), torch.tensor(grads["b"])], tstate,
                                  tparams)
        assert all(a is b for a, b in zip(_counts(tstate), counts)), "counts not in place"
        assert [int(c) for c in counts] == [int(c) for c in _counts(jstate)] == [step + 1] * len(
            counts)
        for a, b in zip(tup, (jup["a"], jup["b"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL,
                                       err_msg=f"{name} step {step}")
        params = optax.apply_updates(params, jup)
        optim.apply_updates(tparams, tup)
    adam_t, adam_j = _adam(tstate), _adam(jstate)
    for a, b in zip(adam_t.mu + adam_t.nu, [adam_j.mu["a"], adam_j.mu["b"],
                                            adam_j.nu["a"], adam_j.nu["b"]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)


def _adam(state):
    if type(state).__name__ == "ScaleByAdamState":
        return state
    for s in state if isinstance(state, tuple) else ():
        found = _adam(s)
        if found is not None:
            return found
    return None


def test_schedule_runs_on_the_count_and_passes_its_end():
    """The cosine schedule maps a count tensor to a 0-d float32 tensor on
    its device, equal to optax's before, at and after its end."""
    ours = optim.cosine_decay_schedule(2e-3, 4, 0.05)
    theirs = optax.cosine_decay_schedule(2e-3, 4, 0.05)
    for c in range(7):
        lr = ours(torch.tensor(c, dtype=torch.int32))
        assert lr.shape == () and lr.dtype == torch.float32 and lr.device.type == "cpu"
        assert abs(float(lr) - float(theirs(jnp.int32(c)))) <= 1e-9
    assert float(ours(torch.tensor(6, dtype=torch.int32))) == pytest.approx(2e-3 * 0.05)


# ------------------------------------------------------------ the steps --


class FakeTrainCall:
    """Stands in for ``CapturedCall``'s training form where there is no
    card: it runs the real warm-up (``graphs.warm_up``, the state copied
    before and back after), records whether that left the state as it
    was, and runs ``fn`` on the static inputs at each replay (nothing is
    captured)."""

    built = []

    def __init__(self, fn, inputs, pool, state=(), writes=None, others=()):
        assert writes is not None, "a training step is built in the training form"
        self.fn, self.inputs, self.state = fn, tuple(inputs), tuple(state)
        self.others = tuple(others)
        before = [t.detach().clone() for t in writes]
        graphs.warm_up(fn, self.inputs, self.state, writes)
        self.build_kept_state = all(a.is_meta or torch.equal(a, b)  # meta: no data to compare
                                    for a, b in zip(before, writes))
        self.replays = 0
        FakeTrainCall.built.append(self)

    def replay(self):
        self.replays += 1
        with torch.enable_grad():
            out = self.fn(*self.inputs, *self.state)
        self.outputs = tuple(out)
        return self.outputs


@pytest.fixture
def fake_capture(monkeypatch):
    """The card's capture replaced by :class:`FakeTrainCall`; a step is
    put on the graphed path by :func:`_graph_path`."""
    FakeTrainCall.built = []
    monkeypatch.setattr(graphs, "CapturedCall", FakeTrainCall)
    monkeypatch.setattr(graphs, "_new_pool", lambda: None)
    return FakeTrainCall.built


def _graph_path(step):
    """``step`` on the card's path on the CPU (as the card tests set
    ``_graphed`` off on an instance for the eager one)."""
    step._graphed = lambda device: True
    return step


def _tensors(state):
    return [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]


def _scenes(hw, n, max_faces, face_px, seed):
    idents = make_identities(6, seed=seed)
    out = [compose_scene(np.random.default_rng(seed + s), idents, hw=hw, n_faces=(1, max_faces),
                         face_px=face_px) for s in range(n)]
    padded = [detect.pad_gt(b, l, max_faces) for _, b, l in out]
    return [np.stack([s[0].astype(np.uint8) for s in out])] + [
        np.stack([p[i] for p in padded]) for i in range(3)]


def _cli_optimizers(lr):
    """The detector CLIs' optimizer, the cosine schedule ending within the 5 steps."""
    return (optim.chain(optim.clip_by_global_norm(5.0),
                        optim.adamw(optim.cosine_decay_schedule(lr, 4, 0.05))),
            optax.chain(optax.clip_by_global_norm(5.0),
                        optax.adamw(optax.cosine_decay_schedule(lr, 4, 0.05))))


class Case:
    """One trainer's step at the parity tests' size: ``make()`` builds a
    fresh port model, step and state (the same each time), ``batches``
    are the steps' arguments after the state, ``jax()`` JAX's jitted
    step, state and the batch adapter."""

    def __init__(self, name, make, batches, other, jax_step, bound=0):
        self.name, self.make, self.batches, self.other = name, make, batches, other
        self.jax_step, self.bound = jax_step, bound


@pytest.fixture(scope="module")
def arcface_start():
    opt = optax.adamw(LR)
    state = jax_init_state(jax_tiny_facenet(32, dtype=jnp.float32), jax.random.PRNGKey(0), 8,
                           opt, image_hw=(96, 96))
    return state, jax.tree.map(np.asarray, state)


def _arcface_case(start):
    jstate, np_start = start
    rng = np.random.default_rng(0)
    batches = [(rng.random((8, 96, 96, 3)).astype(np.float32), (np.arange(8) % 8).astype(np.int32))
               for _ in range(STEPS)]
    other = (rng.random((4, 96, 96, 3)).astype(np.float32), np.arange(4).astype(np.int32))

    def make():
        model = tiny_facenet(32)
        opt_state = carry_state(model, {"params": np_start.params,
                                        "batch_stats": np_start.batch_stats}, np_start.opt_state)
        classifier = torch.tensor(np_start.classifier).requires_grad_(True)
        state = TrainState(list(model.parameters()), model_batch_stats(model), classifier,
                           opt_state, 0)
        return model, make_train_step(model, optim.adamw(LR)), state

    def jax_side():
        step = jax_make_train_step(jax_tiny_facenet(32, dtype=jnp.float32), optax.adamw(LR))
        return step, jstate, lambda b: tuple(map(jnp.asarray, b))

    return Case("arcface", make, batches, other, jax_side)


def _detector_case(name, model_fn, jax_model, make_step, jax_make_step, pool, idx, other_idx,
                   lr, with_stats):
    def make():
        model = model_fn()
        load_flax(model, materialize(flax_shapes(model), seed=0))
        opt, _ = _cli_optimizers(lr)
        params = list(model.parameters())
        state = ((params, model_batch_stats(model), opt.init(params)) if with_stats
                 else (params, opt.init(params)))
        dev_pool = [torch.tensor(a) for a in pool]
        return model, make_step(model, opt), state, dev_pool

    def jax_side():
        variables = materialize(flax_shapes(model_fn()), seed=0)
        _, jopt = _cli_optimizers(lr)
        p = variables["params"]
        jstate = (p, variables["batch_stats"], jopt.init(p)) if with_stats else (p, jopt.init(p))
        jstate = jax.tree.map(jnp.asarray, jstate)  # as the step returns it: one cache entry
        jpool = [jnp.asarray(a) for a in pool]
        return (jax_make_step(jax_model(), jopt), jstate,
                lambda b: (*jpool, jnp.asarray(b[0], jnp.int32)))

    case = Case(name, make, [(i,) for i in idx], (other_idx,), jax_side, bound=4)
    return case


def _yunet_dense_case():
    hw = (96, 96)
    pool = _scenes(hw, 8, 3, (24, 60), seed=30)
    rng = np.random.default_rng(3)

    def batch(b):
        ids = rng.integers(0, 8, b)
        images = pool[0][ids].astype(np.float32) / 255.0
        targets = detect.stack_targets([detect.build_targets(
            pool[1][i][pool[3][i]], pool[2][i][pool[3][i]], hw) for i in ids])
        return images, targets

    batches = [batch(4) for _ in range(STEPS)]
    other = batch(2)

    def make():
        model = YuNet(width=8)
        load_flax(model, materialize(flax_shapes(model), seed=0))
        opt, _ = _cli_optimizers(2e-3)
        params = list(model.parameters())
        return model, detect.make_detect_train_step(model, opt), (
            params, model_batch_stats(model), opt.init(params))

    def jax_side():
        variables = materialize(flax_shapes(YuNet(width=8)), seed=0)
        _, jopt = _cli_optimizers(2e-3)
        p = variables["params"]
        step = jax_detect.make_detect_train_step(JaxYuNet(width=8, dtype=jnp.float32), jopt)
        jstate = jax.tree.map(jnp.asarray, (p, variables["batch_stats"], jopt.init(p)))
        return step, jstate, lambda b: (
            jnp.asarray(b[0]), jax.tree.map(jnp.asarray, b[1]))

    return Case("yunet_dense", make, batches, other, jax_side)


CASE_NAMES = ["arcface", "yunet_pool", "yunet_dense", "blazeface", "retinaface"]
POOL_CASES = ["yunet_pool", "blazeface", "retinaface"]


def _case(name, arcface_start, pool_hw=None):
    """The case ``name``; a detector's pool rendered at ``pool_hw`` (the
    model input when None, so that the letterbox passes the scenes as
    they are, as the parity tests render them)."""
    rng = np.random.default_rng(11)
    if name == "arcface":
        return _arcface_case(arcface_start)
    if name == "yunet_dense":
        return _yunet_dense_case()
    if name == "yunet_pool":
        hw = (96, 96)
        pool = _scenes(pool_hw or hw, 8, 3, (24, 60), seed=20)
        return _detector_case(
            name, lambda: YuNet(width=8), lambda: JaxYuNet(width=8, dtype=jnp.float32),
            lambda m, o: detect.make_pool_train_step(m, o, hw),
            lambda jm, jo: jax_detect.make_pool_train_step(jm, jo, hw),
            pool, [rng.integers(0, 8, 4) for _ in range(STEPS)], rng.integers(0, 8, 2),
            2e-3, True)
    if name == "blazeface":
        pool = _scenes(pool_hw or (64, 64), 6, 2, (20, 40), seed=40)
        return _detector_case(
            name, BlazeFace, lambda: JaxBlazeFace(dtype=jnp.float32),
            lambda m, o: detect_blaze.make_blaze_pool_train_step(m, o, input_px=64),
            lambda jm, jo: jax_blaze.make_blaze_pool_train_step(jm, jo, input_px=64),
            pool, [rng.integers(0, 6, 4) for _ in range(STEPS)], rng.integers(0, 6, 2),
            1e-3, False)
    hw = (128, 128)
    pool = _scenes(pool_hw or hw, 4, 2, (24, 80), seed=50)
    return _detector_case(
        name, lambda: RetinaFace(stage_sizes=(1, 1, 1, 1), width=16),
        lambda: JaxRetinaFace(stage_sizes=(1, 1, 1, 1), width=16, dtype=jnp.float32),
        lambda m, o: detect_retina.make_retina_pool_train_step(m, o, hw),
        lambda jm, jo: jax_retina.make_retina_pool_train_step(jm, jo, hw),
        pool, [rng.integers(0, 4, 2) for _ in range(STEPS)], rng.integers(0, 4, 1), 2e-3, True)


# the letterboxed frame sizes of the bitwise checks (the letterbox and its
# scale run inside the step)
LETTERBOXED = {"yunet_pool": None, "blazeface": (80, 96), "retinaface": (96, 160)}


def _built(case, arcface_start, pool_hw=None):
    """``(case, model, step, state, args_of(batch))``, a fresh port side
    of ``case``; ``args_of.pool`` is its scene pool (empty without one)."""
    c = _case(case, arcface_start, pool_hw)
    made = c.make()
    model, step, state = made[:3]
    pool = made[3] if c.bound else []

    def args_of(batch):
        return (*pool, *batch)

    args_of.pool = pool
    return c, model, step, state, args_of


def _loss(out):
    return out[0]


@pytest.mark.parametrize("case", CASE_NAMES)
def test_graph_path_equals_eager_bitwise(case, arcface_start, fake_capture):
    """5 steps from one state: the graphed path's losses and state
    (parameters, BatchNorm statistics, moments, counts) equal the eager
    step's bitwise after every step; building the graph left the state
    as it was; one key, replayed 5 times."""
    pool_hw = LETTERBOXED.get(case)
    c, _, eager, state_e, args_e = _built(case, arcface_start, pool_hw)
    _, _, graphed, state_g, args_g = _built(case, arcface_start, pool_hw)
    _graph_path(graphed)
    for i, batch in enumerate(c.batches):
        state_e, *out_e = eager(state_e, *args_e(batch))
        state_g, *out_g = graphed(state_g, *args_g(batch))
        assert torch.equal(_loss(out_e), _loss(out_g)), (case, i)
        for a, b in zip(_tensors(state_e), _tensors(state_g)):
            assert torch.equal(a, b), (case, i)
    assert len(eager.graphs) == 0 and len(graphed.graphs) == 1
    (call,) = fake_capture
    assert call.build_kept_state and call.replays == STEPS
    counts = [t for t in _tensors(state_g) if t.dtype == torch.int32]
    assert counts and all(int(t) == STEPS for t in counts)
    if case == "arcface":
        assert state_g.step == state_e.step == STEPS


def _arcface_step_matches_jax(model, state, start, j2):
    """``test_torch_train_arcface.py``'s one-step tolerances: parameters
    at 1e-6 where both Adam directions are resolved, within 2·lr
    everywhere, at least half resolved; BatchNorm statistics at 1e-5."""
    from fire_tpu_torch.weights import flatten, to_flax

    before = params_list(model, start.params) + [torch.tensor(start.classifier)]
    after = params_list(model, jax.tree.map(np.asarray, j2.params)) + [
        torch.tensor(np.asarray(j2.classifier))]
    resolved = total = 0
    for p, b, w in zip(state.params + [state.classifier], before, after):
        p0 = b.numpy()
        ours, theirs = p.detach().numpy() - p0, w.numpy() - p0
        u_ours, u_theirs = -ours / LR - 1e-4 * p0, -theirs / LR - 1e-4 * p0
        ok = (np.sign(u_ours) == np.sign(u_theirs)) & (np.minimum(
            np.abs(u_ours), np.abs(u_theirs)) >= 0.9999)
        d = np.abs(ours - theirs)
        assert d[ok].max(initial=0.0) <= 1e-6
        assert d.max() <= 2 * LR * (1 + 1e-3) + 1e-6
        resolved, total = resolved + ok.sum(), total + ok.size
    assert resolved >= 0.5 * total
    ours_stats = flatten(to_flax(model)["batch_stats"])
    for k, v in flatten(jax.tree.map(np.asarray, j2.batch_stats)).items():
        np.testing.assert_allclose(ours_stats[k], v, rtol=0, atol=1e-5, err_msg="/".join(k))


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's jitted step per case, shared by the tests of this module (a
    jitted function keeps its own compile cache)."""
    return {}


def _jax_of(c, jax_steps):
    if c.name not in jax_steps:
        jax_steps[c.name] = c.jax_step()
    return jax_steps[c.name]


@pytest.mark.parametrize("case", CASE_NAMES)
def test_graph_step_matches_jax_jitted_step(case, arcface_start, fake_capture, jax_steps):
    """The graphed path's first step against JAX's jitted step from the
    same start, at the parity tests' tolerances."""
    c, model, step, state, args = _built(case, arcface_start)
    _graph_path(step)
    jstep, jstate, jargs = _jax_of(c, jax_steps)
    state, *out = step(state, *args(c.batches[0]))
    jout = jstep(jstate, *jargs(c.batches[0]))
    if case == "arcface":
        assert abs(float(out[0]) - float(jout[1])) <= 1e-4 * abs(float(jout[1]))
        _arcface_step_matches_jax(model, state, arcface_start[1], jout[0])
        return
    loss, metrics = out
    np.testing.assert_allclose(float(loss), float(jout[1]), rtol=1e-4)
    assert float(metrics["n_pos"]) == pytest.approx(float(jout[2]["n_pos"]))


@pytest.mark.parametrize("case", CASE_NAMES)
def test_graph_keys_follow_jax_retraces(case, arcface_start, fake_capture, jax_steps):
    """Fixed-shape batches, as the command lines give, keep one key, as
    JAX compiles once; a batch of another shape takes a new key, as JAX
    retraces."""
    c, _, step, state, args = _built(case, arcface_start)
    _graph_path(step)
    jstep, jstate, jargs = _jax_of(c, jax_steps)
    for batch in c.batches[:3]:
        state, *_ = step(state, *args(batch))
        jstate = jstep(jstate, *jargs(batch))[0]
    assert len(step.graphs) == jstep._cache_size() == 1
    step(state, *args(c.other))
    jstep(jstate, *jargs(c.other))
    assert len(step.graphs) == jstep._cache_size() == 2
    assert [call.replays for call in fake_capture] == [3, 1]


@pytest.mark.parametrize("case", POOL_CASES)
def test_pool_is_bound_and_another_pool_gets_its_own_key(case, arcface_start, fake_capture):
    """The graph reads the pool tensors themselves (only the index vector
    is copied in), so rows rewritten in place by ``update_pool_rows``
    are read at the next step, as by the eager step; a step handed other
    pool tensors gets a key of its own and leaves them as they were."""
    pool_hw = LETTERBOXED.get(case)
    c, _, eager, state_e, args_e = _built(case, arcface_start, pool_hw)
    _, _, graphed, state_g, args_g = _built(case, arcface_start, pool_hw)
    _graph_path(graphed)
    pool_e, pool_g = args_e.pool, args_g.pool
    fresh = _scenes(tuple(pool_e[0].shape[1:3]), 2, pool_e[1].shape[1], (24, 40), seed=90)
    for i, batch in enumerate(c.batches[:3]):
        if i == 2:  # the rolling refresh between steps
            for pools in (pool_e, pool_g):
                for arr, block in zip(pools, fresh):
                    detect.update_pool_rows(arr, block, 0, graphs.HostStaging())
        state_e, loss_e, _ = eager(state_e, *pool_e, *batch)
        state_g, loss_g, _ = graphed(state_g, *pool_g, *batch)
        assert torch.equal(loss_e, loss_g), i
    (call,) = fake_capture
    assert len(call.inputs) == 5 and all(a is b for a, b in zip(call.inputs[:4], pool_g))
    other = [p.clone() for p in pool_g]
    kept = [p.clone() for p in other]
    graphed(state_g, *other, *c.batches[0])
    assert len(graphed.graphs) == 2
    assert all(a is b for a, b in zip(fake_capture[1].inputs[:4], other))
    assert all(torch.equal(a, b) for a, b in zip(other, kept))


class NoHostReads(TorchDispatchMode):
    """Raises on an operation that reads the device back to the host or
    whose output shape depends on the data (neither can be captured), or
    that makes a tensor from host data (a capture cannot copy from host
    memory)."""

    FORBIDDEN = ("aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
                 "aten::unique", "aten::_unique", "aten::lift_fresh")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name.startswith(self.FORBIDDEN) or (name == "aten::index" and any(
                i is not None and i.dtype == torch.bool for i in args[1])):
            raise AssertionError(f"{name} in a training step")
        return func(*args, **(kwargs or {}))


def test_no_host_reads_mode_catches_each_kind():
    x = torch.arange(6.0)
    for fn in (lambda: float(x.sum()), lambda: x.nonzero(), lambda: x[x > 2],
               lambda: torch.masked_select(x, x > 2), lambda: torch.unique(x),
               lambda: torch.tensor([1.0])):
        with pytest.raises(AssertionError, match="in a training step"), NoHostReads():
            fn()


@pytest.mark.parametrize("case", CASE_NAMES)
def test_step_bodies_make_no_host_reads(case, arcface_start):
    """After its first call (which makes the device constants), a step,
    fed tensors as the graph's static inputs are, reads nothing back and
    makes no host constant."""
    c, _, step, state, args = _built(case, arcface_start, LETTERBOXED.get(case))
    batches = [tuple(torch.utils._pytree.tree_map(torch.as_tensor, b)) for b in c.batches[:2]]
    state, *_ = step(state, *args(batches[0]))
    with NoHostReads():
        step(state, *args(batches[1]))


def test_no_capture_on_the_cpu(arcface_start, monkeypatch):
    """On a CPU device every step runs eagerly: nothing is built."""
    def refuse(*a, **k):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(graphs, "CapturedCall", refuse)
    for case in CASE_NAMES:
        c, _, step, state, args = _built(case, arcface_start)
        step(state, *args(c.batches[0]))
        assert not step._graphed(torch.device("cpu")) and len(step.graphs) == 0


# ----------------------------------------------------------- checkpoints --


def _two_steps(arcface_start):
    c, model, step, state, args = _built("arcface", arcface_start)
    for batch in c.batches[:2]:
        state, _ = step(state, *args(batch))
    return c, state


def test_checkpoint_round_trip_restores_counts_in_place(tmp_path, arcface_start):
    c, state = _two_steps(arcface_start)
    save_checkpoint(str(tmp_path / "step_2"), state)
    _, _, _, target, _ = _built("arcface", arcface_start)
    counts = _counts(target.opt_state)
    restored = restore_checkpoint(str(tmp_path / "step_2"), target)
    assert restored.step == 2
    got = _counts(restored.opt_state)
    assert all(a is b for a, b in zip(got, counts))
    assert all(t.dtype == torch.int32 and t.shape == () and int(t) == 2 for t in got)
    for a, b in zip(_tensors(restored), _tensors(state)):
        assert torch.equal(a, b)


def test_checkpoint_with_int_counts_restores(tmp_path, arcface_start):
    """A checkpoint written when counts were host ints restores into the
    count tensors, in place."""
    c, state = _two_steps(arcface_start)

    def as_ints(tree):
        if isinstance(tree, dict):
            return {k: int(v) if k == "count" else as_ints(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [as_ints(v) for v in tree]
        return tree

    tree = as_ints(state_tree(state))
    assert tree["opt_state"][0]["count"] == 2 and type(tree["opt_state"][0]["count"]) is int
    (tmp_path / "old").mkdir()
    (tmp_path / "old" / "state.msgpack").write_bytes(msgpack_serialize(tree))
    _, _, _, target, _ = _built("arcface", arcface_start)
    counts = _counts(target.opt_state)
    restored = restore_checkpoint(str(tmp_path / "old"), target)
    assert all(a is b and int(a) == 2 and a.dtype == torch.int32
               for a, b in zip(_counts(restored.opt_state), counts))
    for a, b in zip(_tensors(restored), _tensors(state)):
        assert torch.equal(a, b)


def test_update_pool_rows_through_staging_writes_in_place():
    arr = torch.zeros((6, 2, 3), dtype=torch.uint8)
    block = np.full((2, 2, 3), 7, np.uint8)
    out = detect.update_pool_rows(arr, block, 3, graphs.HostStaging())
    assert out is arr
    assert arr[3:5].eq(7).all() and arr[:3].eq(0).all() and arr[5].eq(0).all()
