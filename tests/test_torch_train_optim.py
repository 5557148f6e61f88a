"""The port's optimizers (``fire_tpu_torch.train.optim``) against optax
on identical gradients, and a JAX optimizer state carried across.

Tolerance: 1e-6 absolute on the updates and moments over several steps.
Both sides run the same float32 formula; they differ only in the
rounding of fused multiply-adds and in where a scalar is rounded to
float32 (a few ulps of values below 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fire_tpu_torch.models.yunet import YuNet
from fire_tpu_torch.train import optim
from fire_tpu_torch.weights import carry_state, flax_shapes, materialize, params_list, to_flax
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((3, 4)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal((5,)) * scale).astype(np.float32)}}


def _leaves(tree):
    return [tree["a"], tree["b"]["c"]]


def _adam_state(state):
    """The ScaleByAdamState inside a (nested) chain state, optax's or the port's."""
    if type(state).__name__ == "ScaleByAdamState":
        return state
    if isinstance(state, tuple):
        for s in state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


CASES = {
    "adam": (lambda: optax.adam(1e-3), lambda: optim.adam(1e-3)),
    "adamw": (lambda: optax.adamw(2e-3), lambda: optim.adamw(2e-3)),
    "adamw_wd": (lambda: optax.adamw(1e-3, weight_decay=0.05),
                 lambda: optim.adamw(1e-3, weight_decay=0.05)),
    "clip_adamw_cosine": (
        lambda: optax.chain(optax.clip_by_global_norm(5.0),
                            optax.adamw(optax.cosine_decay_schedule(2e-3, 4, 0.05))),
        lambda: optim.chain(optim.clip_by_global_norm(5.0),
                            optim.adamw(optim.cosine_decay_schedule(2e-3, 4, 0.05)))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_updates_match_optax_on_identical_gradients(name):
    rng = np.random.default_rng(1)
    make_j, make_t = CASES[name]
    jopt, topt = make_j(), make_t()
    params = _tree(rng)
    jstate = jopt.init(params)
    tparams = [torch.tensor(a) for a in _leaves(params)]
    tstate = topt.init(tparams)
    # gradient norms on both sides of the clip threshold (5.0)
    for step, scale in enumerate((0.5, 8.0, 20.0, 0.1, 3.0, 1.0)):
        grads = _tree(rng, scale)
        jup, jstate = jopt.update(grads, jstate, params)
        tup, tstate = topt.update([torch.tensor(a) for a in _leaves(grads)], tstate, tparams)
        for a, b in zip(tup, _leaves(jup)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL,
                                       err_msg=f"{name} step {step}")
        params = optax.apply_updates(params, jup)
        optim.apply_updates(tparams, tup)
        for a, b in zip(tparams, _leaves(params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
    adam_j, adam_t = _adam_state(jstate), _adam_state(tstate)
    assert adam_t.count == int(adam_j.count) == 6
    for a, b in zip(adam_t.nu, _leaves(adam_j.nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_clip_by_global_norm_threshold():
    """Scaled to norm 5 at or above 5; passed unchanged below."""
    clip = optim.clip_by_global_norm(5.0)
    for norm in (4.0, 5.0, 12.5):
        g = [torch.tensor([3.0, 4.0]) * (norm / 5.0), torch.zeros(3)]
        out, _ = clip.update(g, clip.init(g))
        want = optax.clip_by_global_norm(5.0).update(
            [jnp.asarray(t.numpy()) for t in g], optax.EmptyState())[0]
        for a, b in zip(out, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7, atol=0)
        got = float(torch.linalg.vector_norm(torch.cat(out)))
        assert abs(got - min(norm, 5.0)) < 1e-5


def test_cosine_decay_schedule_matches_optax():
    ours = optim.cosine_decay_schedule(2e-3, 100, 0.05)
    theirs = optax.cosine_decay_schedule(2e-3, 100, 0.05)
    for t in (0, 1, 37, 99, 100, 150):
        assert abs(ours(t) - float(theirs(t))) < 1e-9
    with pytest.raises(ValueError):
        optim.cosine_decay_schedule(1e-3, 0)


def test_carry_state_from_optax_then_step_together():
    """A JAX detector state (params, batch_stats, optax state) after two
    steps carried into YuNet and the port's optimizer: the next step's
    updates agree.  The gradients are the same numpy arrays on both
    sides, in their own layouts."""
    rng = np.random.default_rng(2)
    model = YuNet(width=8)
    variables = materialize(flax_shapes(model), seed=3)
    jopt = optax.chain(optax.clip_by_global_norm(5.0),
                       optax.adamw(optax.cosine_decay_schedule(1e-3, 10, 0.05)))
    params = variables["params"]
    jstate = jopt.init(params)

    def grad_tree():
        return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)

    for _ in range(2):
        up, jstate = jopt.update(grad_tree(), jstate, params)
        params = optax.apply_updates(params, up)
    params = jax.tree.map(np.asarray, params)
    tstate = carry_state(model, {"params": params, "batch_stats": variables["batch_stats"]},
                         jax.tree.map(np.asarray, jstate))
    assert isinstance(tstate[0], optim.EmptyState)
    assert tstate[1][0].count == 2 and tstate[1][2].count == 2
    np.testing.assert_array_equal(to_flax(model)["params"]["model0"]["conv1"]["kernel"],
                                  params["model0"]["conv1"]["kernel"])

    g = grad_tree()
    up, _ = jopt.update(g, jstate, params)
    topt = optim.chain(optim.clip_by_global_norm(5.0),
                       optim.adamw(optim.cosine_decay_schedule(1e-3, 10, 0.05)))
    tup, _ = topt.update(params_list(model, g), tstate, list(model.parameters()))
    for a, b in zip(tup, params_list(model, jax.tree.map(np.asarray, up))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL)
