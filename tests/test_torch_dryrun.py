"""``fire_tpu_torch.dryrun`` against ``__graft_entry__.py`` on the CPU.

The port's meshes are ``["cpu"] * 8`` (one process drives every entry,
as on a card repeated); JAX's are ``jax.devices()[:8]`` of the 8-device
virtual CPU mesh, both (dp, mp) = (4, 2) as the dry run builds them.
Each plane of the port is fed what JAX's dry run draws and held against
JAX's code at the same shapes:

* training: the loss of one sharded ArcFace step from JAX's own initial
  state (carried across), rtol 1e-4, as ``test_torch_train_sharded.py``
  holds it;
* the stand-in multi-stream plane: masks, track ids, gallery ids and
  boxes equal to JAX's ``MultiStreamEngine``;
* the real-model plane: masks, track ids and gallery ids equal, boxes
  within 1e-3 px;
* ``entry()``: the weights bitwise equal to JAX's ``_materialize``
  after conversion; FaceNet-512 in float32 within 1e-4 of the largest
  output of ``model.apply``; the bf16 forward at row cosine ≥ 0.999
  against JAX's bf16 ``entry()``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fire_tpu.config import EngineConfig as JE
from fire_tpu.config import RecognizerConfig as JR
from fire_tpu.config import TrackerConfig as JT
from fire_tpu.gallery.index import DeviceGallery as JGallery
from fire_tpu.models.facenet import FaceNet as JFaceNet
from fire_tpu.models.facenet import tiny_facenet as j_tiny_facenet
from fire_tpu.models.yunet import YuNet as JYuNet
from fire_tpu.parallel.mesh import make_mesh as j_make_mesh
from fire_tpu.parallel.multistream import MultiStreamEngine as JMSE
from fire_tpu.pipeline.engine import DeviceEngine as JEngine
from fire_tpu.train.trainer import init_state as j_init_state
from fire_tpu.train.trainer import make_train_step as j_make_train_step
from fire_tpu_torch import dryrun
from fire_tpu_torch.models.facenet import facenet_512, tiny_facenet
from fire_tpu_torch.parallel.mesh import column_devices, split_columns
from fire_tpu_torch.train.trainer import TrainState, model_batch_stats
from fire_tpu_torch.weights import carry_state, flatten, from_flax_facenet, load_into
from tests.test_batch_engine import _fake_engine

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__ as graft  # noqa: E402

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def mesh():
    return dryrun.dryrun_mesh(8, CPU8)


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh((4, 2), devices=jax.devices()[:8])


@pytest.fixture(scope="module")
def graft_entry():
    """JAX's ``entry()``: the forward and its variables, jitted once."""
    fn, (variables, images) = graft.entry()
    return jax.jit(fn), variables, images


def test_dryrun_multichip_on_cpu(capsys):
    """The whole dry run on eight CPU entries: JAX's summary and closing
    line, and each plane timed."""
    summary = dryrun.dryrun_multichip(8, devices=CPU8)
    assert summary["mesh"] == {"dp": 4, "mp": 2} and summary["streams"] == 4
    assert summary["self_matches"] == [0, 1, 2, 3] and np.isfinite(summary["loss"])
    assert summary["cli_outputs"] == ["out_stream0.avi", "out_stream1.avi"]
    assert len(summary["standin"]) == len(summary["real"]) == 4
    assert sorted(summary["seconds"]) == ["cli", "gallery", "real", "standin", "train"]
    assert capsys.readouterr().out.startswith(
        "dryrun_multichip ok: mesh={'dp': 4, 'mp': 2} loss=")


@pytest.mark.parametrize("n,devices,shape", [
    (1, ["cpu"], {"dp": 1, "mp": 1}),
    (3, ["cpu"] * 3, {"dp": 3, "mp": 1}),
    (8, ["cpu"] * 9, {"dp": 4, "mp": 2}),
])
def test_dryrun_mesh_rule(n, devices, shape):
    """``mp = 2`` where n is even, over the first n devices."""
    mesh = dryrun.dryrun_mesh(n, devices)
    assert mesh.shape == shape and mesh.devices.size == n


def test_train_plane_matches_jax_sharded_step(mesh, jmesh):
    """One (4, 2)-sharded ArcFace step from JAX's ``init_state(PRNGKey(0))``
    carried across, on the dry run's batch: the loss at rtol 1e-4."""
    model = j_tiny_facenet(64, dtype=jnp.float32)
    opt = optax.adam(1e-3)
    jstate = j_init_state(model, jax.random.PRNGKey(0), 32, opt, image_hw=(96, 96))
    images = np.random.default_rng(0).random((8, 96, 96, 3))
    labels = jnp.asarray(np.arange(8) % 32, jnp.int32)
    _, jloss = j_make_train_step(model, opt, mesh=jmesh)(
        jstate, jnp.asarray(images, jnp.float32), labels)

    start = jax.tree.map(np.asarray, jstate)
    tmodel = tiny_facenet(64)
    opt_state = carry_state(tmodel, {"params": start.params, "batch_stats": start.batch_stats},
                            start.opt_state, mesh=mesh)
    classifier = split_columns(torch.tensor(start.classifier).requires_grad_(True),
                               column_devices(mesh))
    state = TrainState(list(tmodel.parameters()), model_batch_stats(tmodel), classifier,
                       opt_state, 0)
    loss = dryrun.train_plane(mesh, start=(tmodel, state))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)


def _jax_standin(jmesh):
    """JAX's stand-in plane (``__graft_entry__.py:105-181``) on the port's
    frames."""
    cfg = JR(similarity_threshold=0.7, unknown_trigger_count=1).with_embedding_dim()
    gal = JGallery(dryrun.STANDIN_DIM, capacity=128)
    hot3 = np.zeros(dryrun.STANDIN_DIM, np.float32)
    hot3[3] = 1.0
    gal.add(hot3, "person3", 1)
    ms = JMSE(_fake_engine(dryrun.STANDIN_MAX_FACES), gal, cfg, jmesh, JT(),
              encode_k=dryrun.STANDIN_MAX_FACES)
    frames1 = np.stack([dryrun.standin_frame(2 + i) for i in range(4)])
    return ms.process_batches(np.stack([frames1] * ms.n_streams))


def _jax_real(jmesh):
    """JAX's real-model plane (``__graft_entry__.py:183-218``)."""
    cfg = JR(detector_type="yunet", encoder_model_type="128", similarity_threshold=0.7,
             unknown_trigger_count=1, weights_dir=None,
             engine=JE(detect_size=(64, 64), encode_size=(96, 96)),
             yunet_conf_threshold=0.05).with_embedding_dim()
    eng = JEngine(cfg, detector=JYuNet(width=8, dtype=jnp.float32),
                  encoder=j_tiny_facenet(128, dtype=jnp.float32))
    ms = JMSE(eng, JGallery(128, capacity=256), cfg, jmesh, JT(), encode_k=4)
    return ms.process_batches(dryrun.real_frames(ms.n_streams))


@pytest.mark.parametrize("plane,box_atol", [("standin", 0), ("real", 1e-3)])
def test_inference_plane_matches_jax(mesh, jmesh, plane, box_atol):
    """Every stream's masks, track ids and gallery ids equal JAX's, and
    its boxes (whole pixels) within ``box_atol``."""
    ours = getattr(dryrun, f"{plane}_plane")(mesh)
    theirs = (_jax_standin if plane == "standin" else _jax_real)(jmesh)
    assert len(ours) == len(theirs) == 4
    for s, (t, j) in enumerate(zip(ours, theirs)):
        for field in ("mask", "tid", "gid"):
            np.testing.assert_array_equal(getattr(t, field), getattr(j, field),
                                          err_msg=f"stream {s} {field}")
        np.testing.assert_allclose(t.boxes, j.boxes, rtol=0, atol=box_atol,
                                   err_msg=f"stream {s} boxes")


def test_cli_plane_writes_every_stream(mesh, tmp_path):
    """``process_videos`` over two 8-frame inputs writes one annotated
    video a stream, 8 frames of 32² each."""
    import cv2

    outs = dryrun.cli_plane(mesh, str(tmp_path))
    assert [os.path.basename(p) for p in outs] == ["out_stream0.avi", "out_stream1.avi"]
    for p in outs:
        cap = cv2.VideoCapture(p)
        frames = 0
        while cap.read()[0]:
            frames += 1
        assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH), frames) == (32, 8)
        cap.release()


def test_entry_weights_bitwise_equal_to_jax(graft_entry):
    """The materialised tree equals JAX's ``entry()`` variables bit for
    bit, and ``entry()``'s bf16 model holds their conversion rounded to
    bf16."""
    _, variables, _ = graft_entry
    jflat = {k: np.asarray(v) for k, v in flatten(jax.tree.map(np.asarray, variables)).items()}
    tflat = flatten(dryrun.facenet512_variables())
    assert sorted(jflat) == sorted(tflat)
    for k, a in jflat.items():
        assert a.dtype == tflat[k].dtype == np.float32, k
        assert np.array_equal(a.view(np.uint32), tflat[k].view(np.uint32)), k
    _, (model, _) = dryrun.entry("cpu")
    converted = from_flax_facenet(jax.tree.map(np.asarray, variables))
    own = model.state_dict()
    assert sorted(own) == sorted(converted) and model.dtype == torch.bfloat16
    for k, v in converted.items():  # BatchNorm's statistics stay float32
        assert own[k].dtype in (torch.bfloat16, torch.float32), k
        assert torch.equal(own[k], v.to(own[k].dtype)), k


def test_entry_float32_matches_model_apply(graft_entry):
    """FaceNet-512 at full width in float32 from the same weights, on
    seeded random 160² images: within 1e-4 of the largest output."""
    _, variables, _ = graft_entry
    x = np.random.default_rng(3).random((2, 160, 160, 3)).astype(np.float32)
    ref = np.asarray(JFaceNet(embed_dim=512, dtype=jnp.float32).apply(variables, jnp.asarray(x)))
    model = facenet_512()
    load_into(model, from_flax_facenet(dryrun.facenet512_variables()))
    with torch.inference_mode():
        got = model.eval()(torch.tensor(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_entry_bf16_matches_jax_entry(graft_entry):
    """``entry()`` on the CPU: (8, 512), finite, zero on its zero images
    as JAX's is (every bias and mean is 0); on seeded random images unit
    rows at cosine ≥ 0.999 to JAX's bf16 forward."""
    jfn, variables, jimages = graft_entry
    fn, (model, images) = dryrun.entry("cpu")
    out = fn(model, images)
    assert out.shape == (8, 512) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(out.numpy(), np.asarray(jfn(variables, jimages), np.float32))
    x = np.random.default_rng(4).random((8, 160, 160, 3)).astype(np.float32)
    got = fn(model, torch.tensor(x)).numpy()
    ref = np.asarray(jfn(variables, jnp.asarray(x)), np.float32)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    cos = (got * ref).sum(1) / np.linalg.norm(ref, axis=1)
    assert cos.min() >= 0.999, cos


@pytest.mark.parametrize("call", ["dryrun_multichip", "entry"])
def test_entry_points_raise_without_a_card(monkeypatch, call):
    """No devices given and no card: both entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError):
        dryrun.dryrun_multichip(8) if call == "dryrun_multichip" else dryrun.entry()


def test_too_few_devices_raise():
    with pytest.raises(RuntimeError, match="need 8 devices, have 4"):
        dryrun.dryrun_multichip(8, devices=["cpu"] * 4)


def _infinite_classifier(mesh):
    """(A NaN image or class column would not do: ``l2_normalize`` zeroes
    a NaN row.)"""
    from fire_tpu_torch.train import optim
    from fire_tpu_torch.train.trainer import JAX_INIT_SEED, init_state

    model = tiny_facenet(64)
    state = init_state(model, JAX_INIT_SEED, 32, optim.adam(1e-3), mesh=mesh)
    with torch.no_grad():
        state.classifier[0][0, 0] = float("inf")
    dryrun.train_plane(mesh, start=(model, state))


def _zero_queries(mesh):
    rows = np.random.default_rng(1).standard_normal((512, 64)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rows[:4] = 0.0
    dryrun.gallery_plane(mesh, rows=rows)


@pytest.mark.parametrize("corrupt,message", [(_infinite_classifier, "non-finite loss"),
                                             (_zero_queries, "self-match failed")])
def test_a_failing_check_raises(mesh, corrupt, message):
    """A plane whose check fails raises: an infinite classifier entry in
    the training state, or zeroed query rows in the gallery."""
    with pytest.raises(AssertionError, match=message):
        corrupt(mesh)
