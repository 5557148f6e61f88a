"""The port's ONNX executor (``fire_tpu_torch.models.onnx_exec``) against
``fire_tpu.models.onnx_exec`` on the same graphs and inputs: one case per
``_op_*`` of the JAX executor (Resize's linear and cubic modes up and
down apart), each at 1e-5, then whole exported YuNet, BlazeFace and
FaceNet graphs at 1e-4.  Graphs are written by the JAX package's
``GraphBuilder`` and parsed by each package's own reader."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fire_tpu.models import onnx_exec as JX
from fire_tpu.models import onnx_import as JI
from fire_tpu.models.onnx_export import GraphBuilder
from fire_tpu_torch.models import onnx_exec as TX
from fire_tpu_torch.models import onnx_import as TI

RNG = np.random.default_rng(0)
X = RNG.standard_normal((1, 3, 6, 7)).astype(np.float32)


def _unary(op, x=X, **attrs):
    def build():
        g = GraphBuilder(op)
        g.add_input("x", x.shape)
        g.add_node(op, ["x"], ["y"], **attrs)
        g.add_output("y")
        return g, [x]
    return build


def _with_inits(op, inits, x=X, n_out=1, **attrs):
    """``op(x, *inits)``; an init of ``None`` is an empty (absent) input."""
    def build():
        g = GraphBuilder(op)
        g.add_input("x", x.shape)
        names = ["x"] + ["" if a is None else g.add_init(f"c{i}", a) for i, a in enumerate(inits)]
        outs = [f"y{i}" for i in range(n_out)]
        g.add_node(op, names, outs, **attrs)
        for o in outs:
            g.add_output(o)
        return g, [x]
    return build


def _multi(op, xs, **attrs):
    def build():
        g = GraphBuilder(op)
        for i, x in enumerate(xs):
            g.add_input(f"x{i}", x.shape)
        g.add_node(op, [f"x{i}" for i in range(len(xs))], ["y"], **attrs)
        g.add_output("y")
        return g, list(xs)
    return build


def _shape_plumbing():
    """Shape of the input → Gather / Concat / Unsqueeze folded on the host
    → Reshape; exercises the traced Shape op and the folding."""
    g = GraphBuilder("plumb")
    g.add_input("x", X.shape)
    s = g.add_node("Shape", ["x"])
    n = g.add_node("Gather", [s, g.add_init("i0", np.asarray(0, np.int64))], axis=0)
    n = g.add_node("Unsqueeze", [n, g.add_init("ax", np.asarray([0], np.int64))])
    tail = g.add_init("tail", np.asarray([-1], np.int64))
    shape = g.add_node("Concat", [n, tail], axis=0)
    g.add_node("Reshape", ["x", shape], ["y"])
    g.add_output("y")
    return g, [X]


def _constant_of_shape():
    g = GraphBuilder("cos")
    g.add_input("x", X.shape)
    s = g.add_node("Shape", ["x"])
    c = g.add_node("ConstantOfShape", [s], value=np.asarray([0.5], np.float32))
    g.add_node("Add", ["x", c], ["y"])
    g.add_output("y")
    return g, [X]


POS = np.abs(X) + 0.1
CH = RNG.standard_normal((3,)).astype(np.float32)
W33 = RNG.standard_normal((4, 3, 3, 3)).astype(np.float32) * 0.3
B4 = RNG.standard_normal((4,)).astype(np.float32)
WDW = RNG.standard_normal((3, 1, 3, 3)).astype(np.float32) * 0.3
WT = RNG.standard_normal((3, 3, 3, 3)).astype(np.float32) * 0.3
X8 = RNG.standard_normal((1, 8, 4, 5)).astype(np.float32)
M25 = RNG.standard_normal((2, 5)).astype(np.float32)
W54 = RNG.standard_normal((5, 4)).astype(np.float32)
W45 = RNG.standard_normal((4, 5)).astype(np.float32)
i64 = lambda *v: np.asarray(v, np.int64)  # noqa: E731
f32 = lambda *v: np.asarray(v, np.float32)  # noqa: E731

CASES = {
    "relu": _unary("Relu"),
    "leakyrelu": _unary("LeakyRelu", alpha=0.2),
    "prelu": _with_inits("PRelu", [CH]),
    "sigmoid": _unary("Sigmoid"),
    "tanh": _unary("Tanh"),
    "softmax": _unary("Softmax", axis=1),
    "exp": _unary("Exp"),
    "log": _unary("Log", x=POS),
    "sqrt": _unary("Sqrt", x=POS),
    "neg": _unary("Neg"),
    "abs": _unary("Abs"),
    "erf": _unary("Erf"),
    "clip_attrs": _unary("Clip", min=-0.5, max=0.7),
    "clip_inputs": _with_inits("Clip", [f32(-0.3), f32(0.4)]),
    "hardswish": _unary("HardSwish", x=X * 4),
    "hardsigmoid": _unary("HardSigmoid", x=X * 4, alpha=0.3, beta=0.4),
    "elu": _unary("Elu", alpha=0.7),
    "add": _with_inits("Add", [CH.reshape(3, 1, 1)]),
    "sub": _with_inits("Sub", [CH.reshape(3, 1, 1)]),
    "mul": _with_inits("Mul", [CH.reshape(3, 1, 1)]),
    "div": _with_inits("Div", [POS[0, :, :1, :1]]),
    "pow": _with_inits("Pow", [f32(2.0)], x=POS),
    "min": _multi("Min", [X, X[:, :, ::-1].copy(), X * 0.5]),
    "max": _multi("Max", [X, X[:, :, ::-1].copy(), X * 0.5]),
    "identity": _unary("Identity"),
    "dropout": _unary("Dropout"),
    "cast_int32": _unary("Cast", x=X * 10, to=6),
    "cast_fp16": _unary("Cast", to=10),
    "concat": _multi("Concat", [X, X * 2], axis=1),
    "reshape": _with_inits("Reshape", [i64(1, -1, 7)]),
    "flatten": _unary("Flatten", axis=2),
    "transpose": _unary("Transpose", perm=[0, 2, 3, 1]),
    "squeeze": _with_inits("Squeeze", [i64(0)]),
    "unsqueeze": _unary("Unsqueeze", axes=[0, 3]),
    "slice": _with_inits("Slice", [i64(1, 0), i64(3, 2**63 - 1), i64(1, 3), i64(1, 2)]),
    "slice_backwards": _with_inits("Slice", [i64(-1, 5), i64(-(2**63), 0), i64(3, 2),
                                             i64(-2, -1)]),
    "gather": _with_inits("Gather", [i64(2, 0, -1)], axis=1),
    "expand": _with_inits("Expand", [i64(2, 3, 6, 7)]),
    "shape": _shape_plumbing,
    "split": _with_inits("Split", [], n_out=2, axis=3, split=[3, 4]),
    "pad_constant": _with_inits("Pad", [i64(0, 0, 1, 2, 0, 1, 2, 0), f32(0.25)]),
    "pad_edge": _with_inits("Pad", [i64(0, 0, 1, 2, 0, 0, 2, 1)], mode="edge"),
    "pad_reflect": _with_inits("Pad", [i64(0, 0, 1, 2, 0, 0, 2, 1)], mode="reflect"),
    "matmul": _with_inits("MatMul", [W54], x=M25),
    "gemm": _with_inits("Gemm", [W45, f32(*range(4))], x=M25, transB=1, alpha=0.5, beta=2.0),
    "conv": _with_inits("Conv", [W33, B4], pads=[1, 1, 1, 1], kernel_shape=[3, 3]),
    "conv_stride_dilation": _with_inits("Conv", [W33], strides=[2, 2], dilations=[2, 1],
                                        pads=[2, 1, 1, 0]),
    "conv_depthwise": _with_inits("Conv", [WDW], group=3, pads=[1, 1, 1, 1]),
    "conv_same_upper": _with_inits("Conv", [W33, B4], strides=[2, 2], auto_pad="SAME_UPPER"),
    "conv_same_lower": _with_inits("Conv", [W33], strides=[2, 2], auto_pad="SAME_LOWER"),
    "convtranspose": _with_inits("ConvTranspose", [WT, CH], strides=[2, 2]),
    "convtranspose_pads": _with_inits("ConvTranspose", [WT], strides=[2, 1], pads=[1, 2, 1, 0]),
    "batchnormalization": _with_inits("BatchNormalization",
                                      [CH, CH[::-1].copy(), CH * 0.1, np.abs(CH) + 0.5],
                                      epsilon=1e-3),
    "instancenormalization": _with_inits("InstanceNormalization", [CH, CH[::-1].copy()]),
    "maxpool": _unary("MaxPool", kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1]),
    "maxpool_ceil": _unary("MaxPool", kernel_shape=[2, 2], strides=[2, 2], ceil_mode=1),
    "averagepool": _unary("AveragePool", kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1]),
    "averagepool_include_pad": _unary("AveragePool", kernel_shape=[3, 2], strides=[1, 2],
                                      pads=[1, 0, 1, 1], count_include_pad=1),
    "globalaveragepool": _unary("GlobalAveragePool"),
    "globalmaxpool": _unary("GlobalMaxPool"),
    "reducemean": _unary("ReduceMean", axes=[2, 3], keepdims=0),
    "reducesum": _with_inits("ReduceSum", [i64(1)]),
    "reducemax": _unary("ReduceMax", axes=[1]),
    "lrn": _unary("LRN", x=X8, size=3, alpha=0.01, beta=0.6, bias=1.5),
    "resize_nearest": _with_inits("Resize", [f32(), f32(1, 1, 2, 3)], mode="nearest"),
    "resize_nearest_sizes": _with_inits("Resize", [f32(), f32(), i64(1, 3, 9, 11)],
                                        mode="nearest"),
    "resize_linear_up": _with_inits("Resize", [f32(), f32(), i64(1, 3, 11, 15)], mode="linear"),
    "resize_linear_down": _with_inits("Resize", [f32(), f32(), i64(1, 3, 4, 3)], mode="linear"),
    "resize_cubic_up": _with_inits("Resize", [f32(), f32(1, 1, 2, 2)], mode="cubic"),
    "resize_cubic_down": _with_inits("Resize", [f32(), f32(), i64(1, 3, 3, 4)], mode="cubic"),
    "upsample": _with_inits("Upsample", [f32(1, 1, 2, 2)], mode="nearest"),
    "depthtospace_dcr": _unary("DepthToSpace", x=X8, blocksize=2),
    "depthtospace_crd": _unary("DepthToSpace", x=X8, blocksize=2, mode="CRD"),
    "constantofshape": _constant_of_shape,
}


def test_every_jax_op_has_a_case_and_a_handler():
    ops = {name[4:] for name in dir(JX.OnnxExecutor) if name.startswith("_op_")}
    assert ops == {name[4:] for name in dir(TX.OnnxExecutor) if name.startswith("_op_")}
    covered = {name.split("_")[0] for name in CASES}
    assert ops <= covered, sorted(ops - covered)
    assert TX._FOLDABLE == JX._FOLDABLE
    assert TX.OnnxExecutor._SHAPE_SLOTS == JX.OnnxExecutor._SHAPE_SLOTS


def _run_both(blob, inputs):
    jout = JX.OnnxModel(JI.read_onnx_bytes(blob))(*inputs)
    tout = TX.OnnxModel(TI.read_onnx_bytes(blob), device="cpu")(*inputs)
    assert len(jout) == len(tout)
    return jout, [t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in tout]


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    g, inputs = CASES[case]()
    jout, tout = _run_both(g.model_bytes(), inputs)
    for j, t in zip(jout, tout):
        assert t.shape == j.shape, (t.shape, j.shape)
        np.testing.assert_allclose(t.astype(np.float64), np.asarray(j, np.float64),
                                   atol=1e-5, rtol=1e-5)


def test_cubic_is_keys_a_half_not_torch_bicubic():
    """``F.interpolate(bicubic)`` (a = −0.75) would differ from JAX here."""
    g, inputs = CASES["resize_cubic_up"]()
    _, (t,) = _run_both(g.model_bytes(), inputs)
    torch_bicubic = torch.nn.functional.interpolate(torch.from_numpy(X), scale_factor=2,
                                                    mode="bicubic", align_corners=False).numpy()
    assert np.abs(t - torch_bicubic).max() > 1e-3


def test_make_onnx_fn_splits_params_and_host_constants():
    g, _ = CASES["reshape"]()
    graph = TI.read_onnx_bytes(g.model_bytes())
    fn, params = TX.make_onnx_fn(graph)
    jfn, jparams = JX.make_onnx_fn(JI.read_onnx_bytes(g.model_bytes()))
    assert sorted(params) == sorted(jparams) and sorted(fn.consts) == sorted(jfn.consts)
    m = TX.OnnxModel(graph, device="cpu")
    assert m.input_names == ["x"] and m.output_names == ["y0"] and m.device.type == "cpu"
    with pytest.raises(ValueError, match="expected 1 inputs"):
        fn({}, X, X)
    bad = GraphBuilder("bad")
    bad.add_input("x", X.shape)
    bad.add_node("Tile", ["x", bad.add_init("r", i64(1, 1, 1, 1))], ["y"])
    bad.add_output("y")
    with pytest.raises(NotImplementedError, match="Tile"):
        TX.OnnxModel(TI.read_onnx_bytes(bad.model_bytes()), device="cpu")(X)


def _tiny_facenet_vars():
    from fire_tpu.models.facenet import FaceNet

    model = FaceNet(embed_dim=32, depths=(1, 1, 1), stem_width=8, dtype=jnp.float32)
    v = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 160, 160, 3)))
    return jax.tree.map(np.asarray, v)


def _exported(name):
    from fire_tpu.models import onnx_export as oe

    rng = np.random.default_rng(5)
    if name == "yunet":
        from fire_tpu.models.yunet import YuNet

        v = YuNet(width=8, dtype=jnp.float32).init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
        return (oe.export_yunet(jax.tree.map(np.asarray, v), width=8, image_hw=(64, 64)),
                [rng.uniform(0, 255, (1, 3, 64, 64)).astype(np.float32)])
    if name == "blazeface":
        from fire_tpu.models.blazeface import BlazeFace

        v = BlazeFace(dtype=jnp.float32).init(jax.random.PRNGKey(2), jnp.zeros((1, 128, 128, 3)))
        return (oe.export_blazeface(jax.tree.map(np.asarray, v)),
                [rng.uniform(-1, 1, (1, 3, 128, 128)).astype(np.float32)])
    return (oe.export_facenet(_tiny_facenet_vars(), embed_dim=32, depths=(1, 1, 1),
                              stem_width=8),
            [rng.uniform(0, 1, (2, 160, 160, 3)).astype(np.float32)])


@pytest.mark.parametrize("name", ["yunet", "blazeface", "facenet"])
def test_exported_graph_matches_jax(name):
    blob, inputs = _exported(name)
    jout, tout = _run_both(blob, inputs)
    for j, t in zip(jout, tout):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, np.asarray(j), atol=1e-4, rtol=1e-4)
