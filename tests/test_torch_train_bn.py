"""BatchNorm's train mode in the port against ``flax.linen.BatchNorm``,
alone and inside FaceNet, YuNet and RetinaFace; and serving unchanged.

One layer: outputs, gradients and the running statistics after a
train-mode forward at 1e-5 against Flax in float32 (FaceNet's layer:
no scale, momentum 0.995, eps 1e-3; YuNet's and RetinaFace's: scale,
Flax's default momentum 0.99, eps 1e-5).

Whole tiny models in train mode are compared with JAX evaluated in
float64: heads within 5e-5 of their largest value and running
statistics within 1e-5 of theirs.  Each BatchNorm computes Flax's fast
variance ``E[x²] − E[x]²`` in float32, which cancels on activations
whose mean is large next to their spread (FaceNet's stem sees
all-positive inputs), so FaceNet comes closest to the bound.  FaceNet
runs at B = 4: at B = 2 its bottleneck BatchNorm maps each feature to
about ±1 from the difference of two samples, and that difference is
what float32 resolves least."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from fire_tpu.models.facenet import tiny_facenet as jax_tiny_facenet
from fire_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from fire_tpu.models.yunet import YuNet as JaxYuNet
from fire_tpu_torch.models.facenet import tiny_facenet
from fire_tpu_torch.models.layers import BatchNorm
from fire_tpu_torch.models.retinaface import RetinaFace
from fire_tpu_torch.models.yunet import YuNet
from fire_tpu_torch.weights import flatten, flax_shapes, load_flax, materialize, to_flax
from tests.torch_threads import one_torch_thread  # noqa: F401

LAYERS = {
    "facenet": dict(momentum=0.995, eps=1e-3, use_scale=False),
    "yunet_retinaface": dict(momentum=0.99, eps=1e-5, use_scale=True),
}


@pytest.mark.parametrize("kind", sorted(LAYERS))
@pytest.mark.parametrize("shape", [(8, 5, 5, 16), (8, 16)], ids=["conv", "dense"])
def test_one_layer_matches_flax(kind, shape):
    cfg = LAYERS[kind]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 2 + 3).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    n = shape[-1]
    scale = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(n)).astype(np.float32)
    var0 = (1 + 0.1 * rng.random(n)).astype(np.float32)

    flax_bn = nn.BatchNorm(use_running_average=False, momentum=cfg["momentum"],
                           epsilon=cfg["eps"], use_scale=cfg["use_scale"], dtype=jnp.float32)
    params = {"bias": bias, **({"scale": scale} if cfg["use_scale"] else {})}
    stats = {"mean": mean0, "var": var0}

    def f(x, p):
        y, mut = flax_bn.apply({"params": p, "batch_stats": stats}, x, mutable=["batch_stats"])
        return (y * g).sum(), (y, mut["batch_stats"])

    (_, (y, new_stats)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), params)

    bn = BatchNorm(n, cfg["eps"], momentum=cfg["momentum"], use_scale=cfg["use_scale"])
    load_flax(bn, {"params": params, "batch_stats": stats})
    to_nc = (lambda a: a.permute(0, 3, 1, 2)) if len(shape) == 4 else (lambda a: a)
    xt = to_nc(torch.tensor(x)).requires_grad_(True)
    yt = bn(xt, train=True)
    trained = [bn.weight, bn.bias] if cfg["use_scale"] else [bn.bias]
    grads = torch.autograd.grad((yt * to_nc(torch.tensor(g))).sum(), [xt] + trained)

    back = (lambda a: a.permute(0, 2, 3, 1)) if len(shape) == 4 else (lambda a: a)
    np.testing.assert_allclose(back(yt.detach()).numpy(), np.asarray(y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(back(grads[0]).numpy(), np.asarray(gx), rtol=0, atol=1e-5)
    want = [gp["scale"], gp["bias"]] if cfg["use_scale"] else [gp["bias"]]
    for a, b in zip(grads[1:], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new_stats["mean"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new_stats["var"]),
                               rtol=0, atol=1e-5)
    # train mode leaves the parameters alone and only the statistics move
    assert not np.allclose(bn.running_var.numpy(), var0)


MODELS = {
    "facenet": (lambda dt: jax_tiny_facenet(32, dtype=dt), lambda: tiny_facenet(32),
                (4, 96, 96), 1.0),
    "yunet": (lambda dt: JaxYuNet(width=8, dtype=dt), lambda: YuNet(width=8), (2, 64, 64), 1.0),
    "retinaface": (lambda dt: JaxRetinaFace(stage_sizes=(1, 1, 1, 1), width=16, dtype=dt),
                   lambda: RetinaFace((1, 1, 1, 1), 16), (2, 64, 64), 255.0),
}


def _model(name):
    make_jax, make_port, shape, x_scale = MODELS[name]
    model = make_port()
    variables = materialize(flax_shapes(model), seed=5)
    load_flax(model, variables)
    x = (np.random.default_rng(1).random((*shape, 3)) * x_scale).astype(np.float32)
    return make_jax, model, variables, x


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_train_mode_matches_jax(name):
    make_jax, model, variables, x = _model(name)
    ours = model(torch.tensor(x), train=True)
    with jax.enable_x64(True):
        cast = jax.tree.map(lambda a: jnp.asarray(a, np.float64), variables)
        theirs, mut = make_jax(np.float64).apply(cast, jnp.asarray(x, np.float64), train=True,
                                                 mutable=["batch_stats"])
        theirs = jax.tree.map(lambda a: np.asarray(a, np.float64), theirs)
        stats = jax.tree.map(lambda a: np.asarray(a, np.float64), mut["batch_stats"])
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        a = a.detach().double().numpy()
        assert np.abs(a - b).max() <= 5e-5 * np.abs(b).max()
    ours_stats = flatten(to_flax(model)["batch_stats"])
    for k, v in flatten(stats).items():
        assert np.abs(ours_stats[k] - v).max() <= 1e-5 * np.abs(v).max() + 1e-7, k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fresh_module_serves_with_running_statistics(name):
    """A module built and called without ``.eval()`` (``training`` is
    True) still serves: running statistics, equal to ``.eval()`` and to
    JAX's ``train=False`` forward, statistics untouched."""
    make_jax, model, variables, x = _model(name)
    assert model.training
    before = to_flax(model)["batch_stats"]
    with torch.no_grad():
        fresh = model(torch.tensor(x))
        served = model.eval()(torch.tensor(x))
    theirs = make_jax(jnp.float32).apply(variables, jnp.asarray(x))  # serving: train=False
    for a, b, c in zip(jax.tree_util.tree_leaves(fresh), jax.tree_util.tree_leaves(served),
                       jax.tree_util.tree_leaves(theirs)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        # 1e-4 absolute: RetinaFace's random-init class logits are of order
        # 100, and a face probability moves by p(1 − p)·Δlogit
        c = np.asarray(c)
        assert np.abs(a.numpy() - c).max() <= 1e-5 * np.abs(c).max() + 1e-4
    after = to_flax(model)["batch_stats"]
    for k, v in flatten(before).items():
        np.testing.assert_array_equal(flatten(after)[k], v)


def test_bf16_cast_keeps_statistics_and_parameters_float32():
    model = YuNet(width=8)
    bn = model.model0.bn1
    assert isinstance(bn.weight, torch.nn.Parameter) and isinstance(bn.bias, torch.nn.Parameter)
    model.to(torch.bfloat16)
    assert model.model0.conv1.weight.dtype == torch.bfloat16
    for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
        assert t.dtype == torch.float32
    assert isinstance(bn.weight, torch.nn.Parameter) and isinstance(bn.bias, torch.nn.Parameter)
    facenet_bn = tiny_facenet(32).to(torch.bfloat16).stem0.bn
    assert not isinstance(facenet_bn.weight, torch.nn.Parameter)  # no scale: a fixed 1
    assert facenet_bn.weight.dtype == torch.float32 and bool((facenet_bn.weight == 1).all())
