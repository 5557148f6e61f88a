"""A compile check and a multi-device dry run (counterpart of ``__graft_entry__.py``).

* :func:`entry` — FaceNet-512 in bf16 at full width as one forward with
  ``l2_normalize``, on the JAX engine's deterministic random init.
* :func:`dryrun_multichip` — every plane of the system together over an
  n-device mesh, at tiny shapes:

  - training: one dp × mp ArcFace step (:mod:`fire_tpu_torch.train.trainer`);
  - gallery: the row-sharded cosine top-k
    (:mod:`fire_tpu_torch.parallel.sharded_gallery`);
  - inference: :class:`~fire_tpu_torch.parallel.multistream.MultiStreamEngine`,
    one stream per ``dp`` device, against the single-stream
    :class:`~fire_tpu_torch.pipeline.batch_engine.BatchStreamEngine`,
    first with a stand-in engine, then with the real YuNet and FaceNet
    graphs (each step matches through K1 and tracks through K2);
  - the product surface: ``FaceRecognition.process_videos`` (``--inputs
    a b``) with the row-sharded gallery view.

Each plane is a function of the mesh, drawing its inputs as JAX's dry
run does; the training plane also takes a starting state and the gallery
plane its rows, so a test can feed them JAX's own.  Every check
raises: a plane that fails fails the call, and nothing falls back to the
CPU.  A mesh may repeat one device (``["cuda:0"] * 8``, ``["cpu"] * 8``),
as :func:`fire_tpu_torch.parallel.mesh.make_mesh` allows.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from fire_tpu_torch.config import EngineConfig, RecognizerConfig, TrackerConfig
from fire_tpu_torch.device import DeviceLike, resolve_device
from fire_tpu_torch.gallery.index import DeviceGallery
from fire_tpu_torch.models.detections import Detections
from fire_tpu_torch.models.facenet import facenet_512, tiny_facenet
from fire_tpu_torch.models.yunet import YuNet
from fire_tpu_torch.ops.gallery_match import l2_normalize
from fire_tpu_torch.parallel.mesh import Mesh, make_mesh
from fire_tpu_torch.parallel.multistream import MultiStreamEngine
from fire_tpu_torch.parallel.sharded_gallery import shard_gallery, sharded_cosine_topk
from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.train import optim
from fire_tpu_torch.train.trainer import JAX_INIT_SEED, init_state, make_train_step
from fire_tpu_torch.weights import flax_shapes, from_flax_facenet, load_into, materialize

STANDIN_DIM = 128  # the stand-in's one-hot width: the embedding dim of encoder "128"
STANDIN_MAX_FACES = 4


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ------------------------------------------------------------------ entry --


def facenet512_variables() -> dict:
    """FaceNet-512's Flax variable tree from the JAX engine's random init
    (``_materialize(jax.eval_shape(model.init, …), seed=0)``), float32."""
    return materialize(flax_shapes(facenet_512(), unit_bn_scale=True), 0)


def entry(device: DeviceLike = None):
    """``(fn, example_args)``: ``fn(*example_args)`` is the (8, 512)
    L2-normalised embedding of FaceNet-512 in bf16 on 8 zero images of
    160² (NHWC float32), as ``__graft_entry__.entry``.  The model carries
    the weights as JAX's ``variables`` do.  ``device=None`` is ``cuda``."""
    dev = resolve_device(device)
    model = facenet_512()
    load_into(model, from_flax_facenet(facenet512_variables()))
    model = model.to(device=dev, dtype=torch.bfloat16).eval()
    images = torch.zeros((8, 160, 160, 3), dtype=torch.float32, device=dev)

    def forward(model, images):
        with torch.inference_mode():
            return l2_normalize(model(images))

    return forward, (model, images)


# ------------------------------------------------------------------- mesh --


def dryrun_mesh(n_devices: int, devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """The dry run's (dp, mp) mesh: ``mp = 2`` where ``n_devices`` is even,
    over ``devices`` (default the first ``n_devices`` CUDA devices, which
    raises with fewer)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} devices, have {have} CUDA devices; pass "
                               "devices=[...] (e.g. ['cpu'] * 8) to run without them")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = list(devices)[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    mp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return make_mesh((n_devices // mp, mp), devices=devices)


def _home(mesh: Mesh) -> torch.device:
    return mesh.devices[0, 0]


def _synchronize(mesh: Mesh) -> None:
    for d in mesh.distinct_devices():
        if d.type == "cuda":
            torch.cuda.synchronize(d)


# ----------------------------------------------------------------- planes --


def train_plane(mesh: Mesh, start=None) -> float:
    """One dp × mp ArcFace step of ``tiny_facenet(64)`` (float32, Adam
    1e-3) at ``16·mp`` classes on ``2·dp`` images of 96² from
    ``default_rng(0).random``; ``start`` is ``(model, state)``, else
    ``init_state`` on the mesh.  Returns the loss, which must be finite."""
    dp, mp = mesh.shape["dp"], mesh.shape["mp"]
    num_classes, batch = 16 * mp, 2 * dp
    optimizer = optim.adam(1e-3)
    if start is None:
        model = tiny_facenet(64).to(_home(mesh))
        state = init_state(model, JAX_INIT_SEED, num_classes, optimizer, mesh=mesh)
    else:
        model, state = start
    step = make_train_step(model, optimizer, mesh=mesh)
    images = np.random.default_rng(0).random((batch, 96, 96, 3)).astype(np.float32)
    x = torch.tensor(images, device=_home(mesh))
    labels = torch.tensor(np.arange(batch) % num_classes, dtype=torch.int32, device=_home(mesh))
    _, loss = step(state, x, labels)
    loss = float(loss)
    _check(math.isfinite(loss), f"non-finite loss {loss}")
    return loss


def gallery_plane(mesh: Mesh, rows: Optional[np.ndarray] = None) -> list:
    """The row-sharded top-3 of the first 4 of ``128·dp`` unit rows of
    width 64 (default from ``default_rng(1)``), every row valid: each
    query's best row is its own.  Returns those rows."""
    if rows is None:
        rows = np.random.default_rng(1).standard_normal((128 * mesh.shape["dp"], 64))
        rows = rows.astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    gal = torch.tensor(rows, dtype=torch.float32, device=_home(mesh))
    valid = torch.ones(rows.shape[0], dtype=torch.bool, device=_home(mesh))
    _, idx = sharded_cosine_topk(mesh, gal[:4], shard_gallery(mesh, gal), valid, k=3)
    top = idx[:, 0].tolist()
    _check(top == [0, 1, 2, 3], f"sharded top-k self-match failed: {top}")
    return top


def standin_engine(device: DeviceLike):
    """An engine as ``BatchStreamEngine`` reaches one
    (``_build_detect``, ``encode``, ``device``): detect decodes up to 4
    boxes from row 0 of channel 0 (``[n, x, y, w, h, …]``), encode is the
    one-hot of ``round(mean(crop) · 255 / 10)`` over 128 dims, as
    ``__graft_entry__.py``'s stand-in."""
    maxf, dim = STANDIN_MAX_FACES, STANDIN_DIM

    def build_detect(frame_hw, timer=None):
        def run(frames):
            row = frames[:, 0, :, 0].float()
            n = row[:, 0].int()
            idx = torch.arange(maxf, device=frames.device)
            boxes = torch.stack([row[:, 1 + 4 * idx], row[:, 2 + 4 * idx], row[:, 3 + 4 * idx],
                                 row[:, 4 + 4 * idx]], dim=-1)
            mask = idx[None] < n[:, None]
            scores = torch.where(mask, 0.99, 0.0)
            return Detections(boxes * mask[..., None],
                              torch.zeros((*mask.shape, 5, 2), device=frames.device), scores, mask)

        return run

    def encode(x):
        hot = torch.clamp(torch.round(x.mean(dim=(1, 2, 3)) * 255.0 / 10.0).long(), 0, dim - 1)
        return torch.nn.functional.one_hot(hot, dim).float()

    return SimpleNamespace(_build_detect=build_detect, encode=encode,
                           device=resolve_device(device))


def standin_frame(x0: int) -> np.ndarray:
    """A 32² frame of one face at ``(x0, 8, 10, 10)`` of intensity 30,
    its box written into row 0 for the stand-in's detect."""
    f = np.zeros((32, 32, 3), np.uint8)
    f[0, 0, 0] = 1
    f[0, 1:5, 0] = [x0, 8, 10, 10]
    f[8:18, x0 : x0 + 10, :] = 30
    return f


def _recognizer_cfg(**kw) -> RecognizerConfig:
    return RecognizerConfig(similarity_threshold=0.7, unknown_trigger_count=1,
                            **kw).with_embedding_dim()


def _equal_to_single(results, frames, make_single, what: str) -> None:
    """Each stream's results against a single-stream engine's on the
    same frames: masks, track ids and gallery ids equal, boxes within
    1e-4 (they are whole pixels)."""
    for s, got in enumerate(results):
        ref = make_single().process_batch(frames[s])
        for field in ("mask", "tid", "gid"):
            _check(np.array_equal(getattr(got, field), getattr(ref, field)),
                   f"{what} stream {s} {field} mismatch")
        _check(np.allclose(got.boxes, ref.boxes, atol=1e-4), f"{what} stream {s} boxes mismatch")


def standin_plane(mesh: Mesh) -> list:
    """``MultiStreamEngine`` with the stand-in engine, one stream per
    ``dp`` device, all on the same 4 frames, against a gallery that holds
    ``person3``: every stream equals the single-stream engine.  Returns
    the streams' ``BatchResults``."""
    dev = _home(mesh)
    cfg = _recognizer_cfg()
    gallery = DeviceGallery(STANDIN_DIM, capacity=128, device=dev)
    hot3 = np.zeros(STANDIN_DIM, np.float32)
    hot3[3] = 1.0
    gallery.add(hot3, "person3", 1)
    ms = MultiStreamEngine(standin_engine(dev), gallery, cfg, mesh, TrackerConfig(),
                           encode_k=STANDIN_MAX_FACES)
    frames1 = np.stack([standin_frame(2 + i) for i in range(4)])
    frames = np.stack([frames1] * ms.n_streams)
    results = ms.process_batches(frames)
    _equal_to_single(results, frames, lambda: BatchStreamEngine(
        standin_engine(dev), gallery, cfg, TrackerConfig(), encode_k=STANDIN_MAX_FACES),
        "stand-in")
    return results


def real_engine_cfg() -> RecognizerConfig:
    """YuNet + FaceNet-128 at a 64² letterbox and 96² crops, deterministic
    random init, conf 0.05 (random heads sit near 0.5).  Float32: JAX's
    dry run passes float32 modules, and the port casts its modules to
    ``compute_dtype``."""
    return _recognizer_cfg(
        detector_type="yunet", encoder_model_type="128", weights_dir=None,
        engine=EngineConfig(detect_size=(64, 64), encode_size=(96, 96), compute_dtype="float32"),
        yunet_conf_threshold=0.05)


def real_frames(n_streams: int) -> np.ndarray:
    """(S, 2, 64, 64, 3) uint8 from ``default_rng(7)``, stream s rolled by
    s pixels along the width."""
    one = np.random.default_rng(7).integers(0, 255, (2, 64, 64, 3), np.uint8)
    return np.stack([np.roll(one, s, axis=2) for s in range(n_streams)])


def real_plane(mesh: Mesh) -> list:
    """``MultiStreamEngine`` over the real graphs (letterbox → YuNet(width=8)
    → decode → NMS → crop → tiny FaceNet-128 → K1 → K2) on
    :func:`real_frames`: each stream equals a single-stream engine of
    its own.  Returns the streams' ``BatchResults``."""
    dev = _home(mesh)
    cfg = real_engine_cfg()
    engine = DeviceEngine(cfg, device=dev, detector=YuNet(width=8), encoder=tiny_facenet(128))
    gallery = DeviceGallery(128, capacity=256, device=dev)
    ms = MultiStreamEngine(engine, gallery, cfg, mesh, TrackerConfig(), encode_k=4)
    frames = real_frames(ms.n_streams)
    results = ms.process_batches(frames)
    _equal_to_single(results, frames, lambda: BatchStreamEngine(
        engine, gallery, cfg, TrackerConfig(), encode_k=4), "real-model")
    return results


def cli_plane(mesh: Mesh, workdir: str) -> list:
    """``FaceRecognition.process_videos`` on ``min(2, dp)`` 8-frame XVID
    files of stand-in frames written into ``workdir``, annotated and
    saved, over the mesh with the row-sharded gallery view.  Every
    stream's ``out_stream<s>.avi`` must exist; returns their paths.
    Needs OpenCV."""
    from fire_tpu_torch.gallery.index import ShardedGalleryView
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition
    from fire_tpu_torch.utils.imageio import open_video_writer

    paths = []
    for s in range(min(2, mesh.shape["dp"])):
        p = os.path.join(workdir, f"in{s}.avi")
        writer = open_video_writer(p, 10, (32, 32))
        for i in range(8):
            writer.write(standin_frame(2 + (i % 4)))
        writer.release()
        paths.append(p)
    engine = standin_engine(_home(mesh))
    engine.detect_faces = lambda img: []
    engine.extract_faces = lambda img, align=True: []
    fr = FaceRecognition(
        detector_type="yunet", encoder_model_type="128", similarity_threshold=0.7,
        unknown_trigger_count=1, detection_interval=1, enable_logging=False,
        storage_root=os.path.join(workdir, "storage"), engine=engine,
        tracker_cfg=TrackerConfig(), sharded_gallery=True, device=engine.device)
    try:
        # the dry run's mesh, not every card: streams and the view's shards
        fr.mesh = mesh
        fr._matcher = ShardedGalleryView(fr.gallery, mesh)
        fr.process_videos(paths, annotate=True, save_path=os.path.join(workdir, "out.avi"),
                          batch_size=4)
    finally:
        fr.close()
    outs = [os.path.join(workdir, f"out_stream{s}.avi") for s in range(len(paths))]
    for p in outs:
        _check(os.path.exists(p), f"missing {p}")
    return outs


# ---------------------------------------------------------------- dry run --


def dryrun_multichip(n_devices: int, devices: Optional[Sequence[DeviceLike]] = None) -> dict:
    """Run one step of every plane over an ``n_devices`` mesh (see the
    module's docstring) and print ``__graft_entry__.py``'s closing line.
    ``devices`` defaults to the first ``n_devices`` CUDA devices.
    Returns the mesh's shape, the loss, the self-matches, the stream
    count, the stand-in and real-model streams' results, the CLI's
    outputs (their names) and the seconds of each plane (host clock
    around synchronised work)."""
    mesh = dryrun_mesh(n_devices, devices)
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        _synchronize(mesh)
        seconds[name] = time.perf_counter() - t0
        return out

    loss = timed("train", train_plane, mesh)
    top = timed("gallery", gallery_plane, mesh)
    standin = timed("standin", standin_plane, mesh)
    real = timed("real", real_plane, mesh)
    with tempfile.TemporaryDirectory() as td:
        outs = [os.path.basename(p) for p in timed("cli", cli_plane, mesh, td)]
    shape = dict(mesh.shape)
    print(f"dryrun_multichip ok: mesh={shape} loss={loss:.4f} streams={len(standin)} "
          "(train + gallery + inference planes [stand-in AND real YuNet+FaceNet] + "
          "process_videos CLI surface)")
    return {"mesh": shape, "loss": loss, "self_matches": top, "streams": len(standin),
            "standin": standin, "real": real, "cli_outputs": outs, "seconds": seconds}
