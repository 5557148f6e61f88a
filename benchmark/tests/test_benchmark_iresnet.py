"""The configuration ``yunet640-iresnet100-g100k`` on the CPU: it
resolves, its work is counted from its own networks, its seeded draw
sets every leaf, the reference embeds faces through the new network
file, and the readers of its per-layer metric and of the encoder's pad
rows read what a run records and nothing where the program has none."""

import numpy as np
import pytest
import torch

from harness import spec, weights, work
from reference import msgpack, nets
from reference.networks import iresnet100

BENCH = spec.load_benchmark()
CONFIG = "yunet640-iresnet100-g100k"
CELL = CONFIG + ".live"


def test_configuration_resolves():
    cfg = spec.config(BENCH, CONFIG)
    assert (cfg["encoder"], cfg["encoder_weights"], cfg["embedding_dim"]) == (
        "iresnet100", weights.SEEDED, 512)
    assert cfg["encode_px"] == [112, 112] and cfg["reduced"] == []
    assert cfg["program"]["encoder_model_type"] == "iresnet100"
    w = spec.cell(BENCH, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "live", 1)
    names = {m["name"] for m in spec.metrics_of(BENCH, CELL, "per_layer")}
    assert "bn_prelu_ms.frame" in names and "encode_ms.newtrack" in names
    assert {m["name"] for m in spec.metrics_of(BENCH, CELL, "end_to_end")} == {
        "frame_ms_p50", "frame_ms_p95", "setup_s"}
    # the other cells do not report the new metric
    assert "bn_prelu_ms.frame" not in {
        m["name"] for m in spec.metrics_of(BENCH, "yunet640-facenet512-g100k.live", "per_layer")}


def test_work_is_counted_from_the_networks():
    """IResNet-100 at 112²: 12,089,606,144 MACs a face (8.5× FaceNet-512);
    YuNet at 640²: 542,393,600 a frame."""
    macs = work.network_macs(spec.config(BENCH, CONFIG))
    assert macs == {"detector": 542_393_600, "encoder": 12_089_606_144}
    with torch.device("meta"):
        net = iresnet100.build()
    assert sum(p.numel() for p in net.parameters()) == 65_156_160


def test_seeded_draw_sets_every_leaf(tmp_path, monkeypatch):
    """The network file's ``init`` through the harness's draw, on one
    block a stage at the published widths (every layer kind of the full
    network, at a size the CPU holds): no leaf is left unset, the slopes
    are 0.25, ``features``' weight 1, the other BatchNorms' scales drawn,
    and the file reads back the same."""
    monkeypatch.setattr(iresnet100, "build", lambda: iresnet100.IResNet((1, 1, 1, 1)))
    path = str(tmp_path / "enc.msgpack")
    sd = weights.write_seeded("iresnet100", 2**31 + 7, path, "cpu")
    assert sd["prelu.negative_slope"].eq(0.25).all()
    assert sd["layer3_0.prelu.negative_slope"].eq(0.25).all()
    assert sd["features.weight"].eq(1.0).all()
    assert not sd["layer2_0.bn1.weight"].eq(1.0).all()
    back = msgpack.state_dict(msgpack.read(path), iresnet100.UNIT_BN_SCALE)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def test_reference_embeds_through_the_network_file(tmp_path, monkeypatch):
    """A small :class:`reference.pipeline.Reference` with the new
    encoder file: the crops of two boxes to 112², unit 512-d embeddings,
    the same on a second call, and the float8 control departs."""
    from reference.pipeline import Reference

    monkeypatch.setattr(iresnet100, "build", lambda: iresnet100.IResNet((1, 1, 1, 1)))
    cfg = dict(spec.config(BENCH, CONFIG), input_px=[160, 160], detector_weights="seeded")
    cfg = weights.resolve(cfg, 2**31 + 3, str(tmp_path), "cpu")
    frame = np.random.default_rng(0).integers(0, 256, (200, 240, 3), dtype=np.uint8)
    boxes = np.array([[10.0, 10.0, 80.0, 90.0], [120.0, 40.0, 70.0, 80.0]])
    ref = Reference(cfg, ".", "cpu")
    emb = ref.embed(frame, boxes)
    assert emb.shape == (2, 512) and np.allclose(np.linalg.norm(emb, axis=1), 1.0)
    assert np.array_equal(emb, ref.embed(frame, boxes))
    ctrl = Reference(cfg, ".", "cpu", quant="fp8").embed(frame, boxes)
    assert float((1 - (emb * ctrl).sum(1)).max()) > 1e-4
    assert nets.network("iresnet100").ROLE == "encoder"


def _trace(kernel_s, frames=150):
    return {"window_s": 1.0, "busy_s": 0.4, "busy_first_s": 0.4, "kernel_s": kernel_s,
            "frames": frames}


def _record(trace=None, counters=None):
    r = {"mode": "per_frame", "setup_s": 30.0, "trace": trace, "stages_ms": {},
         "latency_ms": []}
    if counters is not None:
        r["counters"] = counters
    return r


def test_bn_prelu_reader():
    read = spec.reader("bn_prelu_ms.frame")
    k = "void (anonymous namespace)::bn_prelu_kernel<8>(BnActArgs, float const*)"
    k1 = "void (anonymous namespace)::bn_prelu_kernel<1>(BnActArgs, float const*)"
    other = "void (anonymous namespace)::bn_act_kernel<8, false, true>(BnActArgs)"
    got = read(_record(_trace({k: 0.010, k1: 0.005, other: 0.5})))
    assert got == pytest.approx(1e3 * 0.015 / 150)
    # the parent's program has no such kernel, and an untraced run no trace
    assert read(_record(_trace({other: 0.5}))) is None
    assert read(_record()) is None
    assert read(dict(_record(_trace({k: 0.01})), mode="batched")) is None


def test_encode_pad_reader():
    read = spec.reader("encode_pad.newtrack")
    assert read(_record(counters={"encoding.rows": [1, 0, 3], "encoding.padded": [0, 0, 1]})) \
        == pytest.approx(0.25)
    assert read(_record(counters={"encoding.rows": [2, 1]})) == 0.0
    assert read(_record(counters={"other": [1]})) is None
    # span calls are not the encoder's counters
    assert read(dict(_record(), counts={"encoding.rows": [1]})) is None
    assert read(_record()) is None
