"""The port's TFLite reader, BlazeFace importer and writer
(``fire_tpu_torch.models.tflite_import``) against ``fire_tpu``'s: the
writer's bytes, the parsed model and the assigned params are equal."""

import jax
import numpy as np
import pytest

from fire_tpu.models import tflite_import as JT
from fire_tpu_torch.models import tflite_import as TT
from fire_tpu_torch.weights import flatten
from tests.test_tflite_import import _blaze_params


def _same_model(t, j):
    assert (t.inputs, t.outputs, t.description) == (j.inputs, j.outputs, j.description)
    assert [tuple(o) for o in t.ops] == [tuple(o) for o in j.ops]
    assert len(t.tensors) == len(j.tensors)
    for a, b in zip(t.tensors, j.tensors):
        assert (a.name, a.shape, a.ttype) == (b.name, b.shape, b.ttype)
        assert (a.data is None) == (b.data is None)
        if a.data is not None:
            np.testing.assert_array_equal(a.data, b.data)


def test_writer_bytes_and_reader_equal_jax(tmp_path):
    _, v = _blaze_params(seed=3)
    blob = TT.write_tflite_blazeface(v["params"])
    assert blob == JT.write_tflite_blazeface(v["params"])
    path = str(tmp_path / "face_detection_short_range.tflite")
    assert TT.write_tflite_blazeface(v["params"], path) == blob
    _same_model(TT.read_tflite(path), JT.read_tflite(blob))
    conv = [op for op in TT.read_tflite(blob).ops
            if op.code in (TT.OP_CONV_2D, TT.OP_DEPTHWISE_CONV_2D)]
    assert len(conv) == 37


def test_assign_equals_jax_and_round_trips():
    _, v = _blaze_params(seed=3)
    _, fresh = _blaze_params(seed=9)
    blob = JT.write_tflite_blazeface(v["params"])
    got = TT.assign_blazeface_tflite(fresh["params"], TT.read_tflite(blob))
    want = JT.assign_blazeface_tflite(fresh["params"], JT.read_tflite(blob))
    fg, fw, fs = flatten(got), flatten(jax.tree.map(np.asarray, want)), flatten(v["params"])
    assert list(fg) == list(fw)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype
        np.testing.assert_array_equal(fg[k], fw[k])
        np.testing.assert_array_equal(fg[k], fs[k])
    # the caller's tree is left as it was
    np.testing.assert_array_equal(fresh["params"]["conv1"]["kernel"],
                                  _blaze_params(seed=9)[1]["params"]["conv1"]["kernel"])


def test_fp16_dequantize_variant_equals_jax():
    """fp16 constants behind DEQUANTIZE ops, the weights widened."""
    _, v = _blaze_params()
    blob = JT.write_tflite_blazeface(v["params"])
    models = []
    for mod in (JT, TT):
        m = mod.read_tflite(blob)
        tensors, ops = list(m.tensors), []
        for op in m.ops:
            new_inputs = [op.inputs[0]]
            for ti in op.inputs[1:3]:
                t = tensors[ti]
                tensors.append(mod.TfliteTensor(t.name + "_f16", t.shape, 1,
                                                t.data.astype(np.float16)))
                tensors[ti] = mod.TfliteTensor(t.name, t.shape, 0, None)
                ops.append(mod.TfliteOp(mod.OP_DEQUANTIZE, (len(tensors) - 1,), (ti,)))
                new_inputs.append(ti)
            ops.append(mod.TfliteOp(op.code, tuple(new_inputs), op.outputs))
        models.append(mod.TfliteModel(tensors, ops, m.inputs, m.outputs, m.description))
    _, fresh = _blaze_params(seed=5)
    want = flatten(jax.tree.map(np.asarray,
                                JT.assign_blazeface_tflite(fresh["params"], models[0])))
    got = flatten(TT.assign_blazeface_tflite(fresh["params"], models[1]))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_rejections_equal_jax(tmp_path):
    _, v = _blaze_params()
    m = TT.read_tflite(TT.write_tflite_blazeface(v["params"]))
    short = TT.TfliteModel(m.tensors, m.ops[:-1], m.inputs, m.outputs, m.description)
    with pytest.raises(ValueError, match="conv ops"):
        TT.assign_blazeface_tflite(v["params"], short)
    stub = tmp_path / "stub.tflite"
    stub.write_bytes(b"version https://git-lfs.github.com/spec/v1\noid sha256:0\nsize 1\n")
    for mod in (TT, JT):
        with pytest.raises(FileNotFoundError, match="Git-LFS"):
            mod.read_tflite(str(stub))
    rng = np.random.default_rng(0)
    for bad in (b"\x00" * 4, b"TFL3TFL3" + b"\xff" * 64, b"\x10\x00\x00\x00TFL3" + rng.bytes(256),
                b"\x10\x00\x00\x00XXXX" + bytes(64)):
        errors = []
        for mod in (TT, JT):
            with pytest.raises(ValueError) as e:
                mod.read_tflite(bad)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
