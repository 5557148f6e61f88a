"""Training CLI: ``python -m fire_tpu_torch.train --data <root> ...``
(counterpart of ``python -m fire_tpu.train``).

Trains the FaceNet encoder with ArcFace on an identity-folder dataset
(``root/<identity>/*.png``) and writes the encoder's variables as a
Flax msgpack (``{"params", "batch_stats"}``, float32) that
``DeviceEngine.load_trained_encoder`` of either package loads.

Several cards: with ``--device cuda`` (the default) and more than one
CUDA device, a (dp, mp) mesh over every card is built by itself, as the
JAX CLI builds one (:func:`mesh_shape`), and the step is the
dp×mp-sharded one (batch over ``dp``, classifier columns over ``mp``).
``--device cuda:k`` or ``--device cpu`` trains on that one device.

The backbone starts from JAX's own numpy init for ``PRNGKey(0)``
(:data:`~fire_tpu_torch.train.trainer.JAX_INIT_SEED`); the ArcFace
classifier is drawn from a seeded torch generator.  The forward runs in
bf16 with float32 master weights, as the JAX CLI's ``dtype=bf16``
model.  ``--checkpoint_dir`` resumes from its newest ``step_<N>``
checkpoint and saves one at every log step.  ``--device`` defaults to
``cuda``; without a card pass ``--device cpu``.

On one card the step replays a CUDA graph (``make_train_step``), and
so does the sharded step, over several distinct cards one graph that
spans them all; the loop (:func:`train_loop`) reads the device only for
the loss of a logging step, as JAX's loop does.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Tuple


def mesh_shape(n_devices: int) -> Tuple[int, int]:
    """The JAX CLI's mesh for ``n_devices``: ``mp = 2`` when the count is
    even, else 1, and ``(n / mp, mp)``."""
    mp = 2 if n_devices % 2 == 0 else 1
    return n_devices // mp, mp


def train_loop(step_fn, state, batch_iter, log_every: int, on_log):
    """JAX's loop over ``batch_iter``'s ``(images_u8, labels)`` numpy
    batches: each becomes float32 in [0, 1] on the host and goes to
    ``step_fn``, which copies it up through pinned memory into its
    graph's static inputs; the step count stays on the host.
    ``on_log(state, loss)`` runs every ``log_every`` steps, the one place
    the device is read.  Returns the state."""
    import torch

    for images_u8, labels in batch_iter:
        images = torch.from_numpy(images_u8).float() / 255.0
        state, loss = step_fn(state, images, torch.from_numpy(labels))
        if state.step % log_every == 0:
            on_log(state, loss)
    return state


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="FIRE ArcFace encoder training (PyTorch)")
    p.add_argument("--data", required=True, help="dataset root: <root>/<identity>/*.png")
    p.add_argument("--encoder", default="512", choices=["128", "512"])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--margin", type=float, default=0.5)
    p.add_argument("--scale", type=float, default=64.0)
    p.add_argument("--image_size", type=int, default=160)
    p.add_argument("--out", default="trained_encoder.msgpack",
                   help="where to write the trained encoder variables")
    p.add_argument("--checkpoint_dir", default=None,
                   help="checkpoint directory (resume + periodic saves)")
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    log = logging.getLogger("fire_tpu_torch.train")

    import os

    import torch

    from fire_tpu_torch.device import resolve_device
    from fire_tpu_torch.models import facenet
    from fire_tpu_torch.parallel.mesh import make_mesh
    from fire_tpu_torch.train import optim
    from fire_tpu_torch.train.data import IdentityFolderDataset, batches
    from fire_tpu_torch.train.trainer import (JAX_INIT_SEED, cli_compute_dtype, init_state,
                                              latest_checkpoint, make_train_step,
                                              restore_checkpoint, save_checkpoint)
    from fire_tpu_torch.weights import msgpack_serialize, to_flax

    device = resolve_device(args.device)
    ds = IdentityFolderDataset(args.data)
    log.info("dataset: %d images, %d identities", len(ds), ds.num_classes)

    mesh = None
    if device.type == "cuda" and device.index is None and torch.cuda.device_count() > 1:
        mesh = make_mesh(mesh_shape(torch.cuda.device_count()))
        log.info("mesh: %s", mesh.shape)
        device = mesh.devices[0, 0]
    model = facenet.FaceNet(embed_dim=int(args.encoder), dropout_rate=0.0).to(device)
    optimizer = optim.adamw(args.lr)
    hw = (args.image_size, args.image_size)
    state = init_state(model, JAX_INIT_SEED, ds.num_classes, optimizer, mesh=mesh)

    if args.checkpoint_dir:
        path = latest_checkpoint(args.checkpoint_dir)
        if path:
            state = restore_checkpoint(path, state)
            log.info("resumed from %s (step %d)", os.path.abspath(path), state.step)
    step_fn = make_train_step(model, optimizer, mesh=mesh, margin=args.margin,
                              scale=args.scale, compute_dtype=cli_compute_dtype(device))

    t0 = time.time()

    def on_log(state, loss):
        step = state.step
        log.info("step %d  loss %.4f  (%.1f img/s)", step, float(loss),
                 step * args.batch / (time.time() - t0))
        if args.checkpoint_dir:
            save_checkpoint(os.path.join(args.checkpoint_dir, f"step_{step}"), state)

    train_loop(step_fn, state, batches(ds, args.batch, hw, epochs=args.epochs), args.log_every,
               on_log)

    with open(args.out, "wb") as f:
        f.write(msgpack_serialize(to_flax(model)))
    log.info("trained encoder variables written to %s "
             "(load with DeviceEngine.load_trained_encoder)", args.out)


if __name__ == "__main__":
    main()
