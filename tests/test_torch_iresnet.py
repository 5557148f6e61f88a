"""ArcFace IResNet in the port, on the CPU: the network against the plain
float32 reference the benchmark holds it to, its weight files, K3's
PReLU route's plain side, and the engine and recognizer serving it at
112 × 112.

The reference is ``benchmark/reference/networks/iresnet100.py``, plain
float32 torch that imports nothing of the program; it is loaded here
by path, as the benchmark's own tests load it.  Both networks are built
with one block a stage (``layers=(1, 1, 1, 1)``) at the published
widths, so every layer kind of IResNet-100 runs (the stem's PReLU, a
stride-2 block with its 1×1 shortcut, the 25,088-wide fc, ``features``),
with the seeded weights the benchmark draws, written by its msgpack
writer and read by the port's :func:`~fire_tpu_torch.weights.from_flax_iresnet`."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from fire_tpu_torch.config import ALIGN_TEMPLATE_160, EngineConfig, RecognizerConfig
from fire_tpu_torch.models.iresnet import IResNet, iresnet100
from fire_tpu_torch.models.layers import BatchNorm, PReLU
from fire_tpu_torch.ops import affine, bn_act
from fire_tpu_torch.weights import (flax_shapes, from_flax_iresnet, load_into, materialize,
                                    msgpack_serialize, read_msgpack, to_flax)
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
WT = os.path.join(ROOT, "weights_trained")
SMALL = (1, 1, 1, 1)


def _reference():
    """The benchmark's network file and its msgpack module."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    return (importlib.import_module("reference.networks.iresnet100"),
            importlib.import_module("reference.msgpack"))


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """The reference's small IResNet with the benchmark's seeded weights,
    and the weight file those were written to."""
    net, msgpack = _reference()
    ref = net.IResNet(SMALL).eval()
    g = torch.Generator().manual_seed(2**31 + 5)
    with torch.no_grad():
        net.init(ref, g)
    path = str(tmp_path_factory.mktemp("iresnet") / "iresnet.msgpack")
    msgpack.write(path, msgpack.tree_of(ref.state_dict(), net.UNIT_BN_SCALE))
    return ref, path


def _port(path: str, dtype=torch.float32) -> IResNet:
    model = IResNet(SMALL)
    load_into(model, from_flax_iresnet(read_msgpack(path)))
    return model.to(dtype).eval()


def _faces(n: int = 2, seed: int = 3) -> torch.Tensor:
    return torch.rand((n, 112, 112, 3), generator=torch.Generator().manual_seed(seed))


def _cos_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((1 - torch.nn.functional.cosine_similarity(a.double(), b.double())).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_port_equals_the_reference(seeded, dtype):
    """Float32: the same equations in the same order on the same
    weights, so the two differ only by how each convolution sums
    (oneDNN's kernels for each layout): 1 − cos below 1e-9 and every
    output within 1e-4 of its magnitude.  bf16 (the served dtype): the
    body's activations are rounded to 8 bits at each of the 20 layers'
    outputs (BatchNorm math in float32), the fc and ``features`` in
    float32, so 1 − cos stays below 1e-3 (the benchmark's check on the
    card allows 1e-2 at full depth: see PERF.md)."""
    ref, path = seeded
    x = _faces()
    with torch.no_grad():
        want = ref(x)
        got = _port(path, dtype)(x)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 512)
    if dtype == torch.float32:
        assert _cos_gap(got, want) < 1e-9
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    else:
        assert _cos_gap(got, want) < 1e-3


def test_weight_file_round_trip(seeded, tmp_path):
    """The port writes what it reads: every PReLU slope as a
    ``negative_slope`` leaf, every BatchNorm with its scale (IResNet's
    are not unit), ``features``' scale 1 as the draw left it."""
    ref, path = seeded
    model = _port(path)
    tree = to_flax(model)
    params = tree["params"]
    assert set(params["prelu"]) == {"negative_slope"}
    assert set(params["layer1_0"]["prelu"]) == {"negative_slope"}
    assert set(params["layer1_0"]["bn1"]) == {"scale", "bias"}
    assert set(params["features"]) == {"scale", "bias"}
    assert np.array_equal(params["features"]["scale"], np.ones(512, np.float32))
    assert np.array_equal(params["layer2_0"]["prelu"]["negative_slope"],
                          ref.layer2_0.prelu.negative_slope.detach().numpy())
    assert not np.array_equal(params["bn1"]["scale"], np.ones(64, np.float32))
    out = tmp_path / "again.msgpack"
    out.write_bytes(msgpack_serialize(tree))
    again = IResNet(SMALL)
    load_into(again, from_flax_iresnet(read_msgpack(str(out))))
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
    # the shapes the engine's random init draws for it hold the slopes and the scales
    shapes = flax_shapes(IResNet(SMALL), unit_bn_scale=False)
    assert shapes["params"]["layer4_0"]["prelu"]["negative_slope"].shape == (512,)
    assert shapes["params"]["bn2"]["scale"].shape == (512,)
    load_into(IResNet(SMALL), from_flax_iresnet(materialize(shapes, 0)))


def test_iresnet100_counts():
    """The published network: 65,156,160 parameters, 154 BatchNorms (153
    2-D, each a K3 launch in bf16, and ``features``), 50 PReLUs."""
    with torch.device("meta"):
        model = iresnet100()
    assert sum(p.numel() for p in model.parameters()) == 65_156_160
    assert sum(isinstance(m, BatchNorm) for m in model.modules()) == 154
    assert sum(isinstance(m, PReLU) for m in model.modules()) == 50
    assert model.fc.in_features == 25_088


def test_served_dtype_keeps_the_head_float32():
    model = IResNet(SMALL).to(torch.bfloat16)
    assert model.conv1.weight.dtype == torch.bfloat16
    assert model.fc.weight.dtype == model.fc.bias.dtype == torch.float32
    assert model.prelu.negative_slope.dtype == torch.float32
    assert model.features.weight.dtype == torch.float32


def _bn_inputs(shape, residual: bool, seed: int = 4):
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (2 * torch.randn(shape, generator=gen) + 0.2).to(torch.bfloat16)
    r = torch.randn(shape, generator=gen).to(torch.bfloat16) if residual else None
    if len(shape) == 4:
        x = x.to(memory_format=torch.channels_last)
        r = None if r is None else r.to(memory_format=torch.channels_last)
    params = (0.2 * torch.randn(c, generator=gen), 0.5 + torch.rand(c, generator=gen),
              1 + 0.2 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen))
    slope = 0.25 + 0.2 * torch.randn(c, generator=gen)
    return x, r, params, slope


@pytest.mark.parametrize("residual", [False, True], ids=["bn", "bn-add"])
@pytest.mark.parametrize("shape", [(2, 16, 5, 7), (6, 24)], ids=["channels-last", "rows"])
def test_plain_prelu_route_is_the_formula(shape, residual):
    """``bn_act(..., slope=)`` on CPU tensors is its plain version:
    Flax's BatchNorm op by op rounded to bf16, then ``y > 0 ? y :
    bf16(slope · y)`` with the product in float32.  A slope ends the
    layer alone: with a residual or a ReLU every route refuses it (no
    network adds before a PReLU)."""
    x, r, (mean, var, scale, bias), slope = _bn_inputs(shape, residual)
    bn_act.reset_launches()
    if residual:
        for f in (bn_act.bn_act, bn_act.plain_bn_act):
            with pytest.raises(ValueError, match="alone"):
                f(x, mean, var, scale, bias, 1e-5, r, slope=slope)
    got = bn_act.bn_act(x, mean, var, scale, bias, 1e-5, slope=slope)
    view = [1, shape[1]] + [1] * (len(shape) - 2)
    mul = torch.rsqrt(var + 1e-5) * scale
    y = ((x.float() - mean.view(view)) * mul.view(view) + bias.view(view)).to(torch.bfloat16)
    want = torch.where(y > 0, y, (y.float() * slope.view(view)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert bn_act.launches == bn_act.prelu_launches == 0 and bn_act._fn is None
    with pytest.raises(ValueError, match="alone"):
        bn_act.bn_act(x, mean, var, scale, bias, 1e-5, None, True, slope)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_layer_with_slope_is_batchnorm_then_prelu(dtype, train):
    """``BatchNorm(x, slope=p.negative_slope)`` equals the layer followed
    by the :class:`PReLU` module, in eval and train mode, its gradient
    reaches the slope, and it refuses a residual beside the slope."""
    x, r, (mean, var, scale, bias), slope = _bn_inputs((3, 8, 4, 4), True)
    x, r = x.to(dtype), r.to(dtype)
    bns = []
    for _ in range(2):
        bn = BatchNorm(8, 1e-5)
        with torch.no_grad():
            bn.running_mean.copy_(mean), bn.running_var.copy_(var)
            bn.weight.copy_(scale), bn.bias.copy_(bias)
        bns.append(bn)
    act = PReLU(8)
    with torch.no_grad():
        act.negative_slope.copy_(slope)
    got = bns[0](x, train, slope=act.negative_slope)
    want = act(bns[1](x, train))
    assert torch.equal(got, want)
    got.float().sum().backward()
    assert act.negative_slope.grad is not None
    with pytest.raises(ValueError, match="alone"):
        bns[0](x, train, residual=r, slope=act.negative_slope)


def test_embedding_width_comes_from_the_encoder():
    assert RecognizerConfig(encoder_model_type="iresnet100").embedding_dim == 512
    assert RecognizerConfig(encoder_model_type="512").embedding_dim == 512
    assert RecognizerConfig(encoder_model_type="128").embedding_dim == 128
    cfg = RecognizerConfig(encoder_model_type="iresnet100").with_embedding_dim()
    assert cfg.gallery.embedding_dim == 512


def test_facenet_aligned_crops_stay_bitwise():
    """The template scaled to 160 × 160 is the template itself, and the
    default crop is the old one: the warp to ``ALIGN_TEMPLATE_160`` as a
    tensor, bit for bit."""
    assert affine.template((160, 160)) == ALIGN_TEMPLATE_160
    gen = torch.Generator().manual_seed(8)
    image = torch.rand((240, 320, 3), generator=gen)
    lms = torch.tensor([[[100.0, 90.0], [140.0, 92.0], [121.0, 120.0]],
                        [[30.5, 40.25], [60.0, 41.0], [44.0, 66.0]]])
    tpl = torch.tensor(ALIGN_TEMPLATE_160, dtype=torch.float32)
    old = affine._warp(image, affine.affine_from_3pts(lms, tpl.expand(2, 3, 2)), (160, 160))
    assert torch.equal(affine.align_faces_160(image, lms), old)
    assert torch.equal(affine.align_faces_160(image, lms, (160, 160)), old)
    small = affine.align_faces_160(image, lms, (112, 112))
    assert small.shape == (2, 112, 112, 3)
    # the same framing: the 112² crop is the 160² crop resampled at 0.7
    assert affine.template((112, 112))[0] == pytest.approx((0.35 * 112, 0.35 * 112))


def _scene():
    from fire_tpu_torch.train.scenes import compose_scene, make_identities

    return compose_scene(np.random.default_rng(4), make_identities(4, seed=3), hw=(240, 320),
                         n_faces=(2, 2), face_px=(80, 110), occlusion_prob=0.0)[0]


@pytest.fixture(scope="module")
def recognizer(tmp_path_factory):
    """``FaceRecognition(encoder_model_type="iresnet100")`` on the CPU:
    the trained YuNet at 320², a small IResNet in the encoder slot with
    the random init (its own params cache), float32; the 112² crops come
    from the encoder, not from the engine configuration."""
    from fire_tpu_torch.pipeline.engine import DeviceEngine
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition

    root = tmp_path_factory.mktemp("fr")
    ekw = EngineConfig(detect_size=(320, 320), compute_dtype="float32")
    cfg = RecognizerConfig(detector_type="yunet", encoder_model_type="iresnet100",
                           weights_dir=None, engine=ekw).with_embedding_dim()
    eng = DeviceEngine(cfg, device="cpu", encoder=IResNet(SMALL),
                       params_dir=str(root / "params"))
    eng.load_trained_detector(os.path.join(WT, "yunet_synth.msgpack"))
    fr = FaceRecognition(detector_type="yunet", encoder_model_type="iresnet100", engine=eng,
                         storage_root=str(root / "storage"), weights_dir=None,
                         similarity_threshold=0.7, unknown_trigger_count=1,
                         detection_interval=1, engine_cfg=ekw, device="cpu")
    yield fr
    fr.close()


def test_recognizer_serves_iresnet(recognizer):
    fr = recognizer
    scene = _scene()
    assert fr.embedding_dim == 512 and os.path.exists(fr.engine._params_path())
    assert fr.cfg.engine.encode_size == fr.engine.cfg.engine.encode_size == (112, 112)
    assert fr.add_face(scene, "someone")  # the gallery is empty: nothing to deduplicate
    fr.track_id_to_label.clear()
    for _ in range(6):
        faces = fr.recognize_faces(scene)
    assert faces and all(f["label"] for f in faces)
    counters = fr.timer.counters
    assert counters["encoding.rows"] >= len(faces) and counters["encoding.padded"] == 0
    assert fr.timer.counts["encoding"] >= 1
    crops = fr.extract_faces(scene, align=True)
    assert crops and all(c.shape == (112, 112, 3) for c in crops)
    plain = fr.extract_faces(scene, align=False)
    assert plain and all(c.shape == (112, 112, 3) for c in plain)
    emb = fr.engine.encode_faces(np.stack(crops))
    assert emb.shape == (len(crops), 512)
    assert np.allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)
    got = []
    fr.process_frames([scene] * 6, annotate=False, batch_size=2,
                      on_frame=lambda _f, fs: got.append(len(fs)))
    assert len(got) == 6 and max(got) == len(faces), got


def test_encoding_range_names_the_encoder_and_the_bucket(recognizer):
    """While a profiler records (with shapes), the ``fire.encoding`` range
    carries ``encoder`` and ``bucket``; three faces pad to a bucket of 4,
    one pad row."""
    from torch.profiler import ProfilerActivity, profile

    fr = recognizer
    frame = _scene()
    boxes = np.asarray([[40, 40, 90, 100], [150, 50, 90, 100], [60, 120, 80, 90]], np.float32)
    before = dict(fr.timer.counters)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with fr.timer.span("encoding", encoder="iresnet100", bucket=fr.engine.encode_bucket(3)):
            fr.engine.encode_boxes(frame, boxes)
    ranges = [e for e in prof.events() if e.name == "fire.encoding"]
    assert [e.kwinputs for e in ranges] == [{"encoder": "iresnet100", "bucket": 4}]
    assert fr.timer.counters["encoding.rows"] - before.get("encoding.rows", 0) == 3
    assert fr.timer.counters["encoding.padded"] - before.get("encoding.padded", 0) == 1


def test_default_configuration_takes_the_encoders_crop_size(tmp_path, monkeypatch):
    """``FaceRecognition(encoder_model_type="iresnet100")`` with no engine
    and no engine configuration builds its own engine with 112² crops
    (the default ``EngineConfig`` says 160²) and encodes and enrols on
    them.  The encoder is built with one block a stage, so the CPU holds
    it; everything else is the default path."""
    from fire_tpu_torch.pipeline import engine as engine_mod
    from fire_tpu_torch.pipeline.factories import Encoder
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition

    entry = engine_mod.ENCODERS["iresnet100"]
    monkeypatch.setitem(engine_mod.ENCODERS, "iresnet100",
                        entry._replace(build=lambda dim: IResNet(SMALL, dim)))
    assert EngineConfig().encode_size == (160, 160)
    fr = FaceRecognition(detector_type="yunet", encoder_model_type="iresnet100",
                         storage_root=str(tmp_path / "storage"), weights_dir=None,
                         unknown_trigger_count=1, device="cpu")
    try:
        assert fr.cfg.engine.encode_size == fr.engine.cfg.engine.encode_size == (112, 112)
        emb = fr.engine.encode_faces(_faces(2).numpy())
        assert emb.shape == (2, 512) and np.isfinite(emb).all()
        crops = fr.engine.encode_landmarks(
            _scene(), np.asarray([[[100, 90], [140, 92], [121, 120]]], np.float32))
        assert crops.shape == (1, 512)
    finally:
        fr.close()
    # FaceNet keeps the caller's size, and the reference's encoder contract
    # resizes to the encoder's
    assert engine_mod.fit_encoder(RecognizerConfig(
        encoder_model_type="512", engine=EngineConfig(encode_size=(96, 96)))).engine.encode_size \
        == (96, 96)
    assert Encoder("iresnet100", device="cpu").input_shape == (112, 112)
