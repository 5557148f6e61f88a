"""The port's ONNX reader and weight assignment
(``fire_tpu_torch.models.onnx_import``) against ``fire_tpu``'s: the same
files parse to the same graphs, and the same graph assigned onto the same
Flax-named tree gives bitwise the same tree (BatchNorm folding included).
The files are written by the JAX package's exporter, from trees with
randomised BatchNorm statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fire_tpu.models import onnx_export as oe
from fire_tpu.models import onnx_import as JI
from fire_tpu_torch.models import onnx_import as TI
from fire_tpu_torch.weights import flatten
from tests.test_onnx_import import _tiny_facenet_vars

LFS = b"version https://git-lfs.github.com/spec/v1\noid sha256:abc\nsize 1\n"


def _same_tree(a, b):
    fa, fb = flatten(a), flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=str(k))


def _same_graph(t, j):
    assert t.inputs == j.inputs and t.outputs == j.outputs and t.input_shapes == j.input_shapes
    assert list(t.initializers) == list(j.initializers)
    for k in j.initializers:
        assert t.initializers[k].dtype == j.initializers[k].dtype
        np.testing.assert_array_equal(t.initializers[k], j.initializers[k])
    assert len(t.nodes) == len(j.nodes)
    for tn, jn in zip(t.nodes, j.nodes):
        assert (tn.op_type, tn.name, tn.inputs, tn.outputs) == (jn.op_type, jn.name, jn.inputs,
                                                                jn.outputs)
        assert list(tn.attrs) == list(jn.attrs)
        for key, v in jn.attrs.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(tn.attrs[key], v)
            else:
                assert tn.attrs[key] == v


def _randomised(variables, seed):
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(np.asarray, variables)
    for path, leaf in flatten(variables.get("batch_stats", {})).items():
        node = variables["batch_stats"]
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = (rng.normal(0, 0.3, leaf.shape) if path[-1] == "mean"
                          else rng.uniform(0.5, 2.0, leaf.shape)).astype(np.float32)
    return variables


def _yunet(seed):
    from fire_tpu.models.yunet import YuNet

    v = YuNet(width=8, dtype=jnp.float32).init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))
    return _randomised(v, seed)


def _blazeface(seed):
    from fire_tpu.models.blazeface import BlazeFace

    v = BlazeFace(dtype=jnp.float32).init(jax.random.PRNGKey(seed), jnp.zeros((1, 128, 128, 3)))
    return jax.tree.map(np.asarray, v)


def test_wire_format_parses_the_same():
    g = oe.GraphBuilder("t")
    g.add_input("x", (1, 3, 8, 8))
    w = np.arange(2 * 3 * 3 * 3, dtype=np.float32).reshape(2, 3, 3, 3)
    y = g.add_node("Conv", ["x", g.add_init("w", w)], name="conv0", strides=[2, 2],
                   pads=[1, 1, 1, 1], group=1)
    z = g.add_node("LeakyRelu", [y], alpha=0.125)
    g.add_node("Fake", [z], outputs=["out"], i_attr=7, f_attr=0.25, s_attr="nearest",
               ints_attr=[1, 2, 3], floats_attr=[0.5, 1.5], strings_attr=["a", "bc"],
               tensor_attr=np.asarray([[1.5, -2.0]], np.float32),
               neg=-3, big=np.asarray([2**40], np.int64))
    g.add_init("i64", np.asarray([-1, 2**35], np.int64))
    g.add_init("scalar", np.asarray(3.0, np.float32))
    g.add_init("half", np.asarray([1.5, -0.25], np.float16))
    g.add_output("out", (1, 2, 4, 4))
    blob = g.model_bytes()
    _same_graph(TI.read_onnx_bytes(blob), JI.read_onnx_bytes(blob))
    t = TI.read_onnx_bytes(blob)
    assert t.nodes[0].attrs["pads"] == [1, 1, 1, 1] and t.initializers["scalar"].shape == ()


def test_unpacked_dims_and_typed_payloads_parse_the_same():
    from fire_tpu.models.onnx_export import _f_bytes, _f_varint, _tag, _varint

    msg = _tag(1, 0) + _varint(2) + _tag(1, 0) + _varint(3) + _f_varint(2, 1)
    msg += _f_bytes(8, b"t") + _f_bytes(9, np.arange(6, dtype=np.float32).tobytes())
    for parse in (TI._parse_tensor, JI._parse_tensor):
        name, arr = parse(msg)
        assert name == "t" and arr.shape == (2, 3)
    # int64_data (field 7) and fp16 bits in int32_data (field 6)
    ints = _f_varint(1, 3) + _f_varint(2, 7) + _f_bytes(7, _varint(5) + _varint(2**64 - 2)
                                                        + _varint(9))
    half = _f_varint(1, 2) + _f_varint(2, 10) + _f_bytes(6, _varint(0x3C00) + _varint(0xC000))
    for msg in (ints, half):
        (tn, ta), (jn, ja) = TI._parse_tensor(msg), JI._parse_tensor(msg)
        assert ta.dtype == ja.dtype
        np.testing.assert_array_equal(ta, ja)
    with pytest.raises(ValueError, match="payload has"):
        TI._parse_tensor(_f_varint(1, 4) + _f_bytes(9, np.zeros(3, np.float32).tobytes()))


def test_lfs_pointer_is_named(tmp_path):
    p = tmp_path / "stub.onnx"
    p.write_bytes(LFS)
    with pytest.raises(FileNotFoundError, match="Git-LFS pointer"):
        TI.read_onnx(str(p))
    with pytest.raises(ValueError, match="no GraphProto"):
        TI.read_onnx_bytes(b"\x08\x07" * 50)


def test_layer_orders_equal_jax():
    from fire_tpu.models import blazeface as jb
    from fire_tpu.models import facenet as jf
    from fire_tpu.models import yunet as jy
    from fire_tpu_torch.models import blazeface as tb
    from fire_tpu_torch.models import facenet as tf
    from fire_tpu_torch.models import yunet as ty

    assert tb.blazeface_layer_order() == jb.blazeface_layer_order()
    assert ty.yunet_layer_order() == jy.yunet_layer_order()
    for depths in ((1, 1, 1), (5, 10, 5)):
        assert tf.facenet_layer_order(depths) == jf.facenet_layer_order(depths)


@pytest.mark.parametrize("model", ["facenet", "yunet", "blazeface"])
def test_imported_tree_equals_jax(model):
    """Export a source tree, assign the file onto a different tree in
    both packages: the two results are bitwise equal, and equal the
    source where the layer is the same (no gamma to fold)."""
    if model == "facenet":
        _, src = _tiny_facenet_vars(seed=0)
        _, dst = _tiny_facenet_vars(seed=7)
        blob = oe.export_facenet(src, embed_dim=32, depths=(1, 1, 1), stem_width=8)
        kw = dict(depths=(1, 1, 1))
        assign = "assign_facenet"
    elif model == "yunet":
        src, dst = _yunet(0), _yunet(5)
        blob = oe.export_yunet(src, width=8, image_hw=(64, 64))
        kw, assign = {}, "assign_yunet"
    else:
        src, dst = _blazeface(0), _blazeface(5)
        blob = oe.export_blazeface(src)
        kw, assign = {}, "assign_blazeface"
    stats = dst.get("batch_stats", {})
    jp, js = getattr(JI, assign)(dst["params"], stats, JI.read_onnx_bytes(blob), **kw)
    tp, ts = getattr(TI, assign)(dst["params"], stats, TI.read_onnx_bytes(blob), **kw)
    _same_tree(tp, jp)
    _same_tree(ts, js)
    for path, leaf in flatten(src["params"]).items():
        np.testing.assert_allclose(flatten(tp)[path], leaf, rtol=1e-6, atol=1e-6)


def _conv_bn_graph(kind, rng):
    """Conv then BN with gamma ≠ 1 (``gamma``), with negative gammas
    (``flip``), or a Conv carrying the folded BN as its bias (``fused``)."""
    kern = rng.normal(0, 0.2, (3, 3, 3, 4)).astype(np.float32)
    g = oe.GraphBuilder()
    g.add_input("x", (1, 3, 8, 8))
    ins = ["x", g.add_init("w", np.transpose(kern, (3, 2, 0, 1)))]
    if kind == "fused":
        ins.append(g.add_init("b", rng.normal(0, 0.2, 4).astype(np.float32)))
    y = g.add_node("Conv", ins, pads=[1, 1, 1, 1])
    if kind != "fused":
        gamma = rng.uniform(0.5, 1.5, 4).astype(np.float32)
        if kind == "flip":
            gamma[[1, 3]] *= -1
        y = g.add_node("BatchNormalization", [
            y, g.add_init("g", gamma), g.add_init("beta", rng.normal(0, 0.2, 4).astype(np.float32)),
            g.add_init("m", rng.normal(0, 0.3, 4).astype(np.float32)),
            g.add_init("v", rng.uniform(0.5, 2.0, 4).astype(np.float32))], epsilon=1e-5)
    g.add_node("Identity", [y], outputs=["out"])
    g.add_output("out")
    return g.model_bytes()


@pytest.mark.parametrize("kind", ["gamma", "flip", "fused"])
@pytest.mark.parametrize("layer_eps", [1e-3, 1e-5])
def test_bn_folding_equals_jax(kind, layer_eps):
    """A scale-free BN layer (FaceNet's at 1e-3, YuNet's at 1e-5) takes a
    node's gamma by the exact fold of JAX's importer, bit for bit."""
    blob = _conv_bn_graph(kind, np.random.default_rng(3))
    params = {"c": {"conv": {"kernel": np.zeros((3, 3, 3, 4), np.float32)},
                    "bn": {"bias": np.zeros(4, np.float32)}}}
    stats = {"c": {"bn": {"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}}}
    order = [("convbn", ("c",), layer_eps)]
    jp, js = JI.assign_by_layer_order(params, stats, JI.read_onnx_bytes(blob), order)
    tp, ts = TI.assign_by_layer_order(params, stats, TI.read_onnx_bytes(blob), order)
    _same_tree(tp, jp)
    _same_tree(ts, js)


def test_gemm_orientation_and_mismatches_raise_as_in_jax():
    w = np.arange(16, dtype=np.float32).reshape(4, 4)
    for transb in (0, 1):
        g = oe.GraphBuilder()
        g.add_input("x", (1, 4))
        y = g.add_node("Gemm", ["x", g.add_init("w", w)], transB=transb)
        g.add_node("Identity", [y], outputs=["out"])
        g.add_output("out")
        sc = TI.StreamConsumer(TI.read_onnx_bytes(g.model_bytes()),
                               {("dense", "kernel"): np.zeros((4, 4), np.float32)}, {})
        sc.dense(("dense",))
        np.testing.assert_array_equal(sc.p[("dense", "kernel")], w.T if transb else w)
    _, src = _tiny_facenet_vars(seed=0)
    blob = oe.export_facenet(src, embed_dim=32, depths=(1, 1, 1), stem_width=8)
    for depths in ((1, 1, 1), (2, 1, 1)):
        _, wide = _tiny_facenet_vars(seed=1, embed_dim=16)
        errors = []
        for mod in (JI, TI):
            with pytest.raises(ValueError) as e:
                mod.assign_facenet(wide["params"], wide["batch_stats"], mod.read_onnx_bytes(blob),
                                   depths=depths)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
