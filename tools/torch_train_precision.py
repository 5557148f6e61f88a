#!/usr/bin/env python3
"""How far the port's float32 training gradients are from exact ones, on
the CPU: the numbers behind the tolerances of
``tests/test_torch_train_arcface.py`` and of ``chip_smoke.py``'s
card-vs-CPU training check.

    JAX_PLATFORMS=cpu python tools/torch_train_precision.py

Prints one JSON line:

* ``tiny_facenet``: the ArcFace step of the test (``tiny_facenet(32)``,
  96², B = 8, JAX's ``init_state``): the port's float32 gradients and
  JAX's float32 gradients against JAX in float64, as the largest
  ``max|g − ref| / max|ref|`` over the tensors;
* ``facenet512``: the card-vs-CPU check's ArcFace step (FaceNet-512,
  160², B = 8, ``materialize`` seed 23): the port's float32 gradients
  against JAX in float64, as the largest relative L2 error and the
  largest single element over its tensor's largest gradient, over the
  tensors whose largest gradient is at least 1e-4 of the model's;
* ``yunet_gradient_gap``: in the check's YuNet step (YuNet-64, 320²,
  B = 4), the largest gradient of the tensors under 1e-4 of the model's
  largest and the smallest of the others, both over the model's largest.

Runs the JAX package beside the port; nothing here is part of either."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fire_tpu.models.facenet import FaceNet as JaxFaceNet  # noqa: E402
from fire_tpu.models.facenet import tiny_facenet as jax_tiny_facenet  # noqa: E402
from fire_tpu.train.losses import arcface_logits as jax_arcface_logits  # noqa: E402
from fire_tpu.train.trainer import init_state as jax_init_state  # noqa: E402
from fire_tpu_torch.models.facenet import facenet_512, tiny_facenet  # noqa: E402
from fire_tpu_torch.models.yunet import YuNet  # noqa: E402
from fire_tpu_torch.train.detect import build_targets_device, detection_loss, pad_gt  # noqa: E402
from fire_tpu_torch.train.scenes import compose_scene, make_identities  # noqa: E402
from fire_tpu_torch.train.trainer import arcface_loss  # noqa: E402
from fire_tpu_torch.weights import (carry_state, flax_shapes, load_flax, materialize,  # noqa: E402
                                    params_list)


def jax_grads(model_fn, variables, classifier, images, labels, dtype):
    """JAX's ArcFace loss gradients (params, classifier) in ``dtype``."""
    with jax.enable_x64(dtype == np.float64):
        model = model_fn(dtype)

        def cast(tree):
            return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)

        def loss_fn(params, c):
            emb, _ = model.apply({"params": params, "batch_stats": cast(variables["batch_stats"])},
                                 jnp.asarray(images, dtype), train=True, mutable=["batch_stats"])
            logits = jax_arcface_logits(emb.astype(dtype), c, jnp.asarray(labels))
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(labels)).mean()

        gp, gc = jax.grad(loss_fn, argnums=(0, 1))(cast(variables["params"]), cast(classifier))
        return jax.tree.map(lambda a: np.asarray(a, np.float64), gp), np.asarray(gc, np.float64)


def port_grads(model, variables, classifier, images, labels):
    load_flax(model, variables)
    cls = torch.tensor(np.asarray(classifier, np.float32), requires_grad=True)
    loss = arcface_loss(model, cls, torch.tensor(images), torch.tensor(labels))
    return [g.double().numpy() for g in torch.autograd.grad(loss, list(model.parameters()) + [cls])]


def as_list(model, gp, gc):
    return [t.double().numpy() for t in params_list(model, gp)] + [gc]


def main() -> None:
    out = {}
    # the test's step
    state = jax.tree.map(np.asarray, jax_init_state(
        jax_tiny_facenet(32, dtype=jnp.float32), jax.random.PRNGKey(0), 8, optax.adamw(1e-3),
        image_hw=(96, 96)))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    images = np.random.default_rng(0).random((8, 96, 96, 3)).astype(np.float32)
    labels = (np.arange(8) % 8).astype(np.int32)
    model = tiny_facenet(32)
    carry_state(model, variables)
    ours = port_grads(model, variables, state.classifier, images, labels)
    ref = as_list(model, *jax_grads(lambda dt: jax_tiny_facenet(32, dtype=dt), variables,
                                    state.classifier, images, labels, np.float64))
    j32 = as_list(model, *jax_grads(lambda dt: jax_tiny_facenet(32, dtype=dt), variables,
                                    state.classifier, images, labels, np.float32))

    def worst_of_max(gs, refs):
        return max(float(np.abs(g - r).max() / np.abs(r).max()) for g, r in zip(gs, refs)
                   if np.abs(r).max() > 1e-4 * max(np.abs(x).max() for x in refs))

    out["tiny_facenet"] = {"port_f32_vs_f64": worst_of_max(ours, ref),
                           "jax_f32_vs_f64": worst_of_max(j32, ref)}

    # the card-vs-CPU check's ArcFace step
    rng = np.random.default_rng(21)
    faces = rng.random((8, 160, 160, 3)).astype(np.float32)
    labels = np.arange(8) % 4
    classifier = (rng.standard_normal((512, 4)) * 0.01).astype(np.float32)
    model = facenet_512()
    variables = materialize(flax_shapes(model), seed=23)
    ours = port_grads(model, variables, classifier, faces, labels)
    ref = as_list(model, *jax_grads(lambda dt: JaxFaceNet(embed_dim=512, dtype=dt), variables,
                                    classifier, faces, labels, np.float64))
    scale = max(np.abs(r).max() for r in ref)
    live = [(g, r) for g, r in zip(ours, ref) if np.abs(r).max() >= 1e-4 * scale]
    out["facenet512"] = {
        "tensors": len(live),
        "worst_rel_l2": max(float(np.linalg.norm(g - r) / np.linalg.norm(r)) for g, r in live),
        "worst_element_of_max": max(float(np.abs(g - r).max() / np.abs(r).max())
                                    for g, r in live)}

    # the check's YuNet step: the gap between zero-but-for-rounding and live gradients
    idents = make_identities(4, seed=22)
    scenes = [compose_scene(np.random.default_rng(s), idents, hw=(320, 320), n_faces=(1, 3),
                            face_px=(24, 192)) for s in range(4)]
    frames = np.stack([sc[0] for sc in scenes]).astype(np.float32) / 255.0
    gt = [np.stack([pad_gt(b, l, 3)[i] for _, b, l in scenes]) for i in range(3)]
    model = YuNet()
    load_flax(model, materialize(flax_shapes(model), seed=24))
    loss, _ = detection_loss(model(torch.tensor(frames), train=True),
                             build_targets_device(*map(torch.tensor, gt), (320, 320)))
    tops = [float(g.abs().max()) for g in torch.autograd.grad(loss, list(model.parameters()))]
    top = max(tops)
    out["yunet_gradient_gap"] = {
        "largest_below_1e-4": max(t / top for t in tops if t < 1e-4 * top),
        "smallest_above_1e-4": min(t / top for t in tops if t >= 1e-4 * top)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
