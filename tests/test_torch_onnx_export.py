"""The port's ONNX writer (``fire_tpu_torch.models.onnx_export``) against
``fire_tpu``'s: for the same Flax-named tree both write the same bytes,
for the tiny models of the tests and for the committed full-width
weights, and the port's reader and importer take the files back."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fire_tpu.models import onnx_export as JE
from fire_tpu_torch.models import onnx_export as TE
from fire_tpu_torch.models import onnx_import as TI
from fire_tpu_torch.weights import flatten, read_msgpack
from tests.test_onnx_import import _tiny_facenet_vars

WT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights_trained")


def test_graph_builder_bytes_equal_jax():
    def build(mod):
        g = mod.GraphBuilder("t")
        g.add_input("x", (1, 3, 8, 8))
        w = g.add_init("w", np.arange(54, dtype=np.float32).reshape(2, 3, 3, 3))
        y = g.add_node("Conv", ["x", w], name="c", strides=[2, 2], pads=[1, 1, 1, 1], group=1)
        y = g.add_node("Fake", [y], i=-7, f=0.25, s="nearest", ints=[1, -2], floats=[0.5],
                       strs=["a"], t=np.asarray([[1.5]], np.float32), b=True)
        g.add_init("scalar", np.asarray(2, np.int64))
        g.add_node("Identity", [y], outputs=["out"])
        g.add_output("out", (1, 2, 4, 4))
        return g.model_bytes(opset=11, ir_version=6)

    assert build(TE) == build(JE)
    with pytest.raises(TypeError, match="mixed attribute list"):
        TE._attribute_proto("m", [1, 0.5])


def _tiny(name):
    if name == "facenet":
        _, v = _tiny_facenet_vars(seed=2)
        return v, dict(embed_dim=32, depths=(1, 1, 1), stem_width=8)
    if name == "yunet":
        from fire_tpu.models.yunet import YuNet

        v = YuNet(width=8, dtype=jnp.float32).init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
        return jax.tree.map(np.asarray, v), dict(width=8, image_hw=(64, 64))
    from fire_tpu.models.blazeface import BlazeFace

    v = BlazeFace(dtype=jnp.float32).init(jax.random.PRNGKey(2), jnp.zeros((1, 128, 128, 3)))
    return jax.tree.map(np.asarray, v), {}


@pytest.mark.parametrize("name", ["facenet", "yunet", "blazeface"])
def test_tiny_exports_equal_jax(name):
    v, kw = _tiny(name)
    fn = f"export_{name}"
    blob = getattr(TE, fn)(v, **kw)
    assert blob == getattr(JE, fn)(v, **kw)
    g = TI.read_onnx_bytes(blob)
    assert g.inputs == ["input"] and len(g.initializers) > 10


@pytest.mark.parametrize("name,file,kw", [
    ("facenet", "facenet512_synth.msgpack", dict(embed_dim=512)),
    ("yunet", "yunet_synth.msgpack", {}),
    ("blazeface", "blazeface192_synth.msgpack", {}),
])
def test_full_width_exports_equal_jax(name, file, kw):
    """The committed weights at full width, and the import of the port's
    file gives the tree back (FaceNet's BatchNorms are scale-free, so
    its statistics come back through the exact fold, not bitwise)."""
    tree = read_msgpack(os.path.join(WT, file))
    blob = getattr(TE, f"export_{name}")(tree, **kw)
    assert blob == getattr(JE, f"export_{name}")(tree, **kw)
    assign = getattr(TI, f"assign_{name}")
    params, stats = assign(tree["params"], tree.get("batch_stats", {}), TI.read_onnx_bytes(blob))
    for got, want in ((params, tree["params"]), (stats, tree.get("batch_stats", {}))):
        fg, fw = flatten(got), flatten(want)
        assert set(fg) == set(fw)
        for k in fw:
            np.testing.assert_allclose(fg[k], fw[k], rtol=1e-5, atol=1e-6, err_msg=str(k))
