"""Seeded weights: drawn from a seed by a network file's ``init``,
written by the benchmark's writer in the trained files' layout, and read
back the same by the reference's reader and by the program's loaders,
whose float32 networks then equal the reference's; the writer is the
reader's exact inverse, a parameter leaf of another name passes through
under its own, and a CPU run of a cell with a seeded encoder ends with
every frame served and every compared number finite."""

import math

import numpy as np
import pytest
import torch

from cpu_cell import run_cpu
from harness import spec, weights
from reference import msgpack, nets


def _port(kind):
    from fire_tpu_torch import weights as pw
    from fire_tpu_torch.models.facenet import FaceNet
    from fire_tpu_torch.models.retinaface import RetinaFace
    from fire_tpu_torch.models.yunet import YuNet

    return {"yunet": (YuNet, pw.from_flax_yunet),
            "retinaface": (RetinaFace, pw.from_flax_retinaface),
            "facenet512": (lambda: FaceNet(512), pw.from_flax_facenet)}[kind]


@pytest.mark.parametrize("kind,hw", [("yunet", (320, 320)), ("retinaface", (320, 320)),
                                     ("facenet512", (160, 160))])
def test_seeded_weights_read_back_and_run_alike(tmp_path, kind, hw):
    from fire_tpu_torch.weights import load_into, read_msgpack

    path = str(tmp_path / f"{kind}.msgpack")
    drawn = weights.write_seeded(kind, 2**31 + 29, path, "cpu")
    network = nets.network(kind)
    got = msgpack.state_dict(msgpack.read(path), network.UNIT_BN_SCALE)
    assert sorted(got) == sorted(drawn)
    assert all(torch.equal(got[k], drawn[k]) for k in drawn)

    make, convert = _port(kind)
    port = make()
    load_into(port, convert(read_msgpack(path)))
    own = port.state_dict()
    assert sorted(own) == sorted(drawn)
    assert all(torch.equal(own[k], drawn[k]) for k in drawn)

    ref = nets.build(kind)
    ref.load_state_dict(got)
    x = torch.rand(1, *hw, 3, generator=torch.Generator().manual_seed(1)) * (255.0 / network.SCALE)
    with torch.no_grad():
        a, b = ref.eval()(x), port.eval()(x)
    if isinstance(a, dict):
        for s in a:
            for u, v in zip(a[s], b[s]):
                assert torch.equal(u, v)
                assert torch.isfinite(u).all()
    else:
        assert torch.equal(a, b) and torch.isfinite(a).all()


def test_same_seed_same_weights(tmp_path):
    a = weights.write_seeded("yunet", 7, str(tmp_path / "a"), "cpu")
    b = weights.write_seeded("yunet", 7, str(tmp_path / "b"), "cpu")
    c = weights.write_seeded("yunet", 8, str(tmp_path / "c"), "cpu")
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model0.conv1.weight"], c["model0.conv1.weight"])


def test_writer_is_the_readers_inverse():
    """A trained float32 file is written back byte for byte; a tree
    through the state dict and back is the same tree."""
    path = f"{spec.ROOT}/weights_trained/yunet_synth.msgpack"
    with open(path, "rb") as f:
        raw = f.read()
    tree = msgpack.msgpack_restore(raw)
    assert msgpack.pack(tree) == raw
    for unit, name in ((False, "yunet_synth"), (True, "facenet512_synth")):
        tree = msgpack.read(f"{spec.ROOT}/weights_trained/{name}.msgpack")
        back = msgpack.tree_of(msgpack.state_dict(tree, unit), unit)
        a, b = msgpack.flatten(tree), msgpack.flatten(back)
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(np.asarray(a[k], np.float32), b[k]) for k in a)


def test_other_parameter_leaf_passes_through():
    """A leaf of ``params`` that is no kernel, bias or scale (a PReLU
    slope) keeps its name both ways; one of ``batch_stats`` still
    raises."""
    slope = np.full((4,), 0.25, np.float32)
    tree = {"params": {"stage": {"act": {"negative_slope": slope},
                                 "conv": {"kernel": np.ones((3, 3, 2, 4), np.float32)}}}}
    sd = msgpack.state_dict(tree, False)
    assert sorted(sd) == ["stage.act.negative_slope", "stage.conv.weight"]
    assert torch.equal(sd["stage.act.negative_slope"], torch.from_numpy(slope))
    back = msgpack.msgpack_restore(msgpack.pack(msgpack.tree_of(sd, False)))
    assert np.array_equal(back["params"]["stage"]["act"]["negative_slope"], slope)
    assert back["params"]["stage"]["conv"]["kernel"].shape == (3, 3, 2, 4)
    with pytest.raises(ValueError, match="unconsumed"):
        msgpack.state_dict({"batch_stats": {"bn": {"count": slope}}}, False)


def test_cell_runs_with_a_seeded_encoder():
    out = run_cpu("yunet640-facenet512-g100k.live", seconds=3.0,
                  config={"encoder_weights": weights.SEEDED})
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["info"]["setup_phases_s"]["weights"] > 0
    assert all(math.isfinite(c["value"]) for c in out["checks"].values()), out["checks"]
