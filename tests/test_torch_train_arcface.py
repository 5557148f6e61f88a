"""The port's ArcFace loss and training step (``fire_tpu_torch.train``)
against ``fire_tpu.train`` on ``tiny_facenet(32)`` at 96², 8 classes.

Both packages start from one state: JAX's ``init_state`` (its backbone
init and its classifier), carried into the port with
``weights.carry_state``.

Tolerances.  The loss is compared at rtol 1e-4.  Gradients are
compared tensor by tensor against JAX evaluated in float64, as
``max|port − ref| ≤ 1e-3·max|ref| + 1e-6``.  Both packages compute
Flax's fast variance ``E[x²] − E[x]²`` in float32, and on the stem's
all-positive activations (17,672 values a channel) it cancels: the
port's worst tensor is 7.9e-4 of its largest gradient away from float64,
JAX's own float32 gradients 6.6e-2 (``tools/torch_train_precision.py``;
XLA's CPU reductions round differently).  Against JAX's float32
gradients the port is therefore held to twice JAX's own distance plus
that tolerance.  One step's parameters agree at 1e-6 wherever both packages'
Adam directions ``g/(|g| + eps)`` have the same sign and a magnitude of
at least 0.9999 (``|g| ≳ 1e-4``); where a gradient is so small that its
sign differs, Adam's first step (about ``lr·sign(g)``) puts the two at
most ``2·lr`` apart, and that bound is asserted."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fire_tpu.models.facenet import tiny_facenet as jax_tiny_facenet
from fire_tpu.train.losses import arcface_logits as jax_arcface_logits
from fire_tpu.train.losses import triplet_loss as jax_triplet_loss
from fire_tpu.train.trainer import init_state as jax_init_state
from fire_tpu.train.trainer import make_train_step as jax_make_train_step
from fire_tpu_torch.models.facenet import tiny_facenet
from fire_tpu_torch.parallel.mesh import make_mesh
from fire_tpu_torch.train import TrainState, arcface_logits, make_train_step, optim
from fire_tpu_torch.train.losses import triplet_loss
from fire_tpu_torch.train.trainer import (JAX_INIT_SEED, arcface_loss, init_state,
                                          model_batch_stats)
from fire_tpu_torch.weights import carry_state, flatten, params_list, to_flax
from tests.torch_threads import one_torch_thread  # noqa: F401

HW = (96, 96)
LR = 1e-3


@pytest.fixture(scope="module")
def jax_start():
    """JAX's initial ArcFace state for tiny_facenet(32), 8 classes, as
    numpy, plus the batch both sides train on."""
    opt = optax.adamw(LR)
    state = jax_init_state(jax_tiny_facenet(32, dtype=jnp.float32), jax.random.PRNGKey(0), 8,
                           opt, image_hw=HW)
    rng = np.random.default_rng(0)
    images = rng.random((8, *HW, 3)).astype(np.float32)
    labels = (np.arange(8) % 8).astype(np.int32)
    return state, jax.tree.map(np.asarray, state), images, labels


def _port(start):
    model = tiny_facenet(32)
    opt_state = carry_state(model, {"params": start.params, "batch_stats": start.batch_stats},
                            start.opt_state)
    classifier = torch.tensor(start.classifier).requires_grad_(True)
    return model, TrainState(list(model.parameters()), model_batch_stats(model), classifier,
                             opt_state, 0)


def _jax_loss_and_grads(start, images, labels, dtype):
    """JAX's step loss and gradients (params, classifier) in ``dtype``."""
    with jax.enable_x64(dtype == np.float64):
        model = jax_tiny_facenet(32, dtype=dtype)

        def cast(tree):
            return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)

        def loss_fn(params, classifier):
            emb, _ = model.apply({"params": params, "batch_stats": cast(start.batch_stats)},
                                 jnp.asarray(images, dtype), train=True, mutable=["batch_stats"])
            logits = jax_arcface_logits(emb.astype(dtype), classifier, jnp.asarray(labels))
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(labels)).mean()

        loss, (gp, gc) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            cast(start.params), cast(start.classifier))
        return float(loss), jax.tree.map(lambda a: np.asarray(a, np.float64), gp), \
            np.asarray(gc, np.float64)


def _grad_lists(model, gp, gc):
    return [t.double().numpy() for t in params_list(model, gp)] + [gc]


def test_jax_init_seed_is_jax_init_states_seed():
    kv, _ = jax.random.split(jax.random.PRNGKey(0))
    assert JAX_INIT_SEED == int(jax.random.randint(kv, (), 0, 2**31 - 1))


def test_init_state_backbone_equals_jax(jax_start):
    """``init_state(model, JAX_INIT_SEED, ...)`` gives JAX's backbone
    bitwise; the classifier is the port's own draw (N(0, 1)·0.01)."""
    _, start, _, _ = jax_start
    model = tiny_facenet(32)
    state = init_state(model, JAX_INIT_SEED, 8, optim.adamw(LR))
    ours = flatten(to_flax(model))
    theirs = flatten({"params": start.params, "batch_stats": start.batch_stats})
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg="/".join(k))
    assert state.classifier.shape == (32, 8) and state.step == 0
    assert 0.005 < float(state.classifier.std()) < 0.015
    assert len(state.opt_state[0].mu) == len(state.params) + 1


def test_arcface_logits_match_jax():
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((6, 16)).astype(np.float32)
    w = rng.standard_normal((16, 10)).astype(np.float32)
    labels = np.array([0, 3, 3, 9, 1, 5])
    for margin, scale in ((0.5, 64.0), (0.0, 30.0), (0.35, 64.0)):
        ours = arcface_logits(torch.tensor(emb), torch.tensor(w), torch.tensor(labels),
                              margin, scale).numpy()
        theirs = np.asarray(jax_arcface_logits(jnp.asarray(emb), jnp.asarray(w),
                                               jnp.asarray(labels), margin, scale))
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)
    # the margin lowers only the target logit
    with_m = arcface_logits(torch.tensor(emb), torch.tensor(w), torch.tensor(labels)).numpy()
    no_m = arcface_logits(torch.tensor(emb), torch.tensor(w), torch.tensor(labels), 0.0).numpy()
    for i, lab in enumerate(labels):
        assert with_m[i, lab] < no_m[i, lab]
        others = [j for j in range(10) if j != lab]
        np.testing.assert_allclose(with_m[i, others], no_m[i, others], atol=1e-4)


def test_arcface_logits_stay_float32_under_autocast():
    rng = np.random.default_rng(4)
    emb = torch.tensor(rng.standard_normal((4, 8)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((8, 5)).astype(np.float32))
    labels = torch.tensor([0, 1, 2, 3])
    plain = arcface_logits(emb, w, labels)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        cast = arcface_logits(emb, w, labels)
    assert cast.dtype == torch.float32
    torch.testing.assert_close(cast, plain, rtol=0, atol=0)


def test_triplet_loss_matches_jax():
    rng = np.random.default_rng(5)
    a, p, n = (rng.standard_normal((6, 16)).astype(np.float32) for _ in range(3))
    for args in ((a, a + 0.01, n), (a, n, p), (a, p, n)):
        ours = float(triplet_loss(*map(torch.tensor, args)))
        theirs = float(jax_triplet_loss(*map(jnp.asarray, args)))
        assert abs(ours - theirs) < 1e-5
    good = float(triplet_loss(*map(torch.tensor, (a, a + 0.01, n))))
    bad = float(triplet_loss(*map(torch.tensor, (a, n, a + 0.01))))
    assert good < bad


def test_one_step_loss_and_gradients_match_jax(jax_start):
    _, start, images, labels = jax_start
    model, state = _port(start)
    loss = arcface_loss(model, state.classifier, torch.tensor(images), torch.tensor(labels))
    target = state.params + [state.classifier]
    ours = [g.double().numpy() for g in torch.autograd.grad(loss, target)]
    loss32, gp32, gc32 = _jax_loss_and_grads(start, images, labels, np.float32)
    loss64, gp64, gc64 = _jax_loss_and_grads(start, images, labels, np.float64)
    assert abs(float(loss) - loss32) <= 1e-4 * abs(loss32)
    assert abs(float(loss) - loss64) <= 1e-4 * abs(loss64)
    names = [n for n, _ in model.named_parameters()] + ["classifier"]
    ref64, ref32 = _grad_lists(model, gp64, gc64), _grad_lists(model, gp32, gc32)
    for name, g, r64, r32 in zip(names, ours, ref64, ref32):
        tol = 1e-3 * np.abs(r64).max() + 1e-6
        assert np.abs(g - r64).max() <= tol, (name, np.abs(g - r64).max(), tol)
        jax_own = np.abs(r32 - r64).max()
        assert np.abs(g - r32).max() <= 2 * jax_own + tol, (name, np.abs(g - r32).max(), jax_own)


def test_one_step_params_and_batch_stats_match_jax(jax_start):
    jstate, start, images, labels = jax_start
    model, state = _port(start)
    step = make_train_step(model, optim.adamw(LR))
    state, loss = step(state, torch.tensor(images), torch.tensor(labels))
    assert state.step == 1 and loss.ndim == 0
    j2, _ = jax_make_train_step(jax_tiny_facenet(32, dtype=jnp.float32), optax.adamw(LR))(
        jstate, jnp.asarray(images), jnp.asarray(labels))
    before = params_list(model, start.params) + [torch.tensor(start.classifier)]
    after = params_list(model, jax.tree.map(np.asarray, j2.params)) + [
        torch.tensor(np.asarray(j2.classifier))]
    resolved = total = 0
    for p, b, w in zip(state.params + [state.classifier], before, after):
        p0 = b.numpy()
        ours, theirs = p.detach().numpy() - p0, w.numpy() - p0
        # Adam's direction g/(|g| + eps) in (-1, 1), with AdamW's decay taken out
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


def test_train_step_runs_and_learns():
    """``tests/test_parallel.py``'s sharded learning test, on one device:
    three Adam steps memorise a tiny batch."""
    rng = np.random.default_rng(0)
    model = tiny_facenet(32)
    opt = optim.adam(1e-3)
    state = init_state(model, JAX_INIT_SEED, 8, opt)
    step = make_train_step(model, opt)
    images = torch.tensor(rng.random((8, *HW, 3)), dtype=torch.float32)
    labels = torch.tensor(np.arange(8) % 8)
    losses = []
    for _ in range(3):
        state, loss = step(state, images, labels)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert state.step == 3


def test_mesh_of_several_devices_raises():
    """A mesh of several devices gives the sharded step, which raises on
    a batch that ``dp`` does not divide (the sharded step's own tests are
    ``tests/test_torch_train_sharded.py``); a mesh of one device gives
    the one-device step."""
    model = tiny_facenet(32)
    opt = optim.adam(1e-3)
    mesh = make_mesh(devices=["cpu"] * 2)
    state = init_state(model, JAX_INIT_SEED, 8, opt, mesh=mesh)
    images = torch.zeros((3, *HW, 3))
    with pytest.raises(ValueError, match="dp = 2"):
        make_train_step(model, opt, mesh=mesh)(state, images, torch.arange(3))
    make_train_step(model, opt, mesh=make_mesh(devices=["cpu"]))
