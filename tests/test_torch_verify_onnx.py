"""``python -m fire_tpu_torch.verify_onnx`` against ``fire_tpu.verify_onnx``
on the same exported files: the same roles, verdicts and JSON keys."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fire_tpu import verify_onnx as JV
from fire_tpu.models import onnx_export as oe
from fire_tpu_torch import verify_onnx as TV
from fire_tpu_torch.models import onnx_import as TI
from tests.test_onnx_import import _tiny_facenet_vars


def _file(tmp_path, role):
    if role == "encoder":
        _, v = _tiny_facenet_vars(seed=3)
        blob = oe.export_facenet(v, embed_dim=32, depths=(1, 1, 1), stem_width=8)
        args = ["--dim", "32", "--depths", "1", "1", "1", "--stem_width", "8"]
    elif role == "yunet":
        from fire_tpu.models.yunet import YuNet

        v = YuNet(width=8, dtype=jnp.float32).init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
        blob = oe.export_yunet(jax.tree.map(np.asarray, v), width=8, image_hw=(64, 64))
        args = ["--role", "yunet", "--width", "8"]
    else:
        from fire_tpu.models.blazeface import BlazeFace

        v = BlazeFace(dtype=jnp.float32).init(jax.random.PRNGKey(2), jnp.zeros((1, 128, 128, 3)))
        blob = oe.export_blazeface(jax.tree.map(np.asarray, v))
        args = []
    p = tmp_path / f"{role}.onnx"
    p.write_bytes(blob)
    return str(p), args + ["--n", "2"]


@pytest.mark.parametrize("role", ["encoder", "yunet", "blazeface"])
def test_gate_verdicts_equal_jax(tmp_path, capsys, role):
    path, args = _file(tmp_path, role)
    assert JV.main([path] + args) == 0
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert TV.main([path] + args + ["--device", "cpu"]) == 0
    tout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(tout) == set(jout)
    for key in ("role", "ok", "gate", "file", "embed_dim", "matched_pairs"):
        assert tout.get(key) == jout.get(key), key
    if role == "encoder":
        assert tout["max_cosine_distance"] <= 1e-3
    else:
        assert tout["matched_pairs"] > 0 and tout["min_box_iou"] >= 0.99


def test_role_detection_and_refusals(tmp_path):
    path, _ = _file(tmp_path, "encoder")
    assert TV.detect_role(TI.read_onnx(path)) == JV.detect_role(TI.read_onnx(path)) == "encoder"
    stub = tmp_path / "stub.onnx"
    stub.write_bytes(b"version https://git-lfs.github.com/spec/v1\noid sha256:0\nsize 1\n")
    with pytest.raises(FileNotFoundError, match="(?i)lfs"):
        TV.main([str(stub), "--device", "cpu"])
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TV.main([path])  # the card by default, no fallback
