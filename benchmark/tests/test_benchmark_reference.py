"""The plain reference against itself on the CPU at a small size: its
networks load the trained files and equal the program's float32
networks, it finds the rendered faces, it repeats itself, and its
float8 control departs from it."""

import numpy as np
import pytest
import torch

from harness import spec, traffic
from reference import msgpack, nets, pipeline

CFG = spec.config(spec.load_benchmark(), "yunet640-facenet512-g100k")


@pytest.fixture(scope="module")
def scene():
    mix = spec.mix("live")
    mix.update({"frame_hw": [540, 960], "face_px": [120, 160], "loop_frames": 2})
    return traffic.render(mix, 2**31 + 17)


@pytest.fixture(scope="module")
def refs():
    cfg = dict(CFG, input_px=[320, 320])
    return (pipeline.Reference(cfg, spec.ROOT, "cpu"),
            pipeline.Reference(cfg, spec.ROOT, "cpu", quant="fp8"))


@pytest.mark.parametrize("kind,file,unit", [("yunet", "yunet_synth", False),
                                            ("facenet512", "facenet512_synth", True)])
def test_networks_equal_the_programs_in_float32(kind, file, unit):
    from fire_tpu_torch.models.facenet import FaceNet
    from fire_tpu_torch.models.yunet import YuNet
    from fire_tpu_torch.weights import (from_flax_facenet, from_flax_yunet, load_into,
                                        read_msgpack)

    path = f"{spec.ROOT}/weights_trained/{file}.msgpack"
    ref = nets.build(kind)
    ref.load_state_dict(msgpack.state_dict(msgpack.read(path), unit))
    port = YuNet() if kind == "yunet" else FaceNet(512)
    load_into(port, (from_flax_yunet if kind == "yunet" else from_flax_facenet)(
        read_msgpack(path)))
    x = torch.rand(1, 160, 160, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = ref.eval()(x), port.eval()(x)
    if isinstance(a, dict):
        for s in a:
            for u, v in zip(a[s], b[s]):
                assert torch.equal(u, v)
    else:
        assert torch.equal(a, b)


def test_finds_the_rendered_faces(refs, scene):
    ref, _ = refs
    frame, truth = scene.frames[0], scene.truth[0]
    d = ref.detect(frame)
    from harness.check import pair
    assert len(pair(truth[:, 2:], d["boxes"], min_iou=0.3)) == len(truth)
    assert (d["scores"] > CFG["det_threshold"]).all()


def test_repeats_itself(refs, scene):
    ref, _ = refs
    frame = scene.frames[0]
    a, b = ref.detect(frame), ref.detect(frame)
    assert np.array_equal(a["boxes"], b["boxes"])
    e1 = ref.embed(frame, a["boxes"])
    assert np.array_equal(e1, ref.embed(frame, a["boxes"]))
    assert np.allclose(np.linalg.norm(e1, axis=1), 1.0)


def test_control_departs(refs, scene):
    ref, ctrl = refs
    frame = scene.frames[0]
    boxes = ref.detect(frame)["boxes"]
    e, c = ref.embed(frame, boxes), ctrl.embed(frame, boxes)
    gap = 1.0 - np.sum(e * c, axis=1)
    assert gap.max() > CFG["limits"]["per_frame"]["emb_cos_gap"]


def test_gallery_top1(refs):
    ref, _ = refs
    rows = np.eye(4, 512, dtype=np.float32)
    ref.set_gallery(rows, [np.eye(1, 512, 5)[0]])
    q = np.eye(1, 512, 5)
    assert ref.sims(q, 5).argmax() == 4 and ref.sims(q, 4).max() == 0.0


def test_nms_and_fp8():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30]], float)
    keep = pipeline.greedy_nms(boxes, np.array([0.9, 0.95, 0.8]), 0.3, 32, False, False)
    assert keep.tolist() == [1, 2]
    x = torch.linspace(-3, 3, 101)
    q = pipeline.fp8(x)
    err = (q - x).abs()
    assert err.max() > 0 and (err <= 2.0**-4 * x.abs() + 1e-6).all()  # 3 mantissa bits
