"""Minimal ONNX writer with no ``onnx`` package (counterpart of
``fire_tpu.models.onnx_export``, kept as a copy of its own).

:class:`GraphBuilder` serialises a ModelProto (packed repeated fields,
raw tensor data); :func:`export_yunet`, :func:`export_blazeface` and
:func:`export_facenet` write the three models from their Flax-named
numpy variable trees in the node order their layer orders declare, so
the files round-trip through :mod:`fire_tpu_torch.models.onnx_import`
and run under :mod:`fire_tpu_torch.models.onnx_exec`.  For the same tree
they write the same bytes as the JAX package's exporter.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from fire_tpu_torch.models.onnx_import import _NP_TO_ONNX
from fire_tpu_torch.weights import flatten

# ------------------------------------------------------------ proto encode ---


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fnum: int, wtype: int) -> bytes:
    return _varint((fnum << 3) | wtype)


def _f_varint(fnum: int, value: int) -> bytes:
    return _tag(fnum, 0) + _varint(value)


def _f_bytes(fnum: int, value: bytes) -> bytes:
    return _tag(fnum, 2) + _varint(len(value)) + value


def _f_string(fnum: int, value: str) -> bytes:
    return _f_bytes(fnum, value.encode())


def _f_float(fnum: int, value: float) -> bytes:
    return _tag(fnum, 5) + struct.pack("<f", value)


def _f_packed_varints(fnum: int, values: Sequence[int]) -> bytes:
    payload = b"".join(_varint(v) for v in values)
    return _f_bytes(fnum, payload)


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.ndim:  # ascontiguousarray would promote 0-d scalars to 1-d
        arr = np.ascontiguousarray(arr)
    onnx_dtype = _NP_TO_ONNX[arr.dtype]
    msg = _f_packed_varints(1, list(arr.shape))           # dims (packed)
    msg += _f_varint(2, onnx_dtype)                       # data_type
    msg += _f_string(8, name)                             # name
    msg += _f_bytes(9, arr.tobytes())                     # raw_data
    return msg


def _attribute_proto(name: str, value: Any) -> bytes:
    msg = _f_string(1, name)
    if isinstance(value, np.ndarray):
        msg += _f_bytes(5, _tensor_proto("", value)) + _f_varint(20, 4)
    elif isinstance(value, bool):
        msg += _f_varint(3, int(value)) + _f_varint(20, 2)
    elif isinstance(value, int):
        msg += _f_varint(3, value) + _f_varint(20, 2)
    elif isinstance(value, float):
        msg += _f_float(2, value) + _f_varint(20, 1)
    elif isinstance(value, str):
        msg += _f_bytes(4, value.encode()) + _f_varint(20, 3)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            msg += _f_packed_varints(8, [int(v) for v in value]) + _f_varint(20, 7)
        elif all(isinstance(v, (float, np.floating)) for v in value):
            payload = b"".join(struct.pack("<f", float(v)) for v in value)
            msg += _f_bytes(7, payload) + _f_varint(20, 6)
        elif all(isinstance(v, str) for v in value):
            msg += b"".join(_f_bytes(9, v.encode()) for v in value) + _f_varint(20, 8)
        else:
            raise TypeError(f"mixed attribute list for {name!r}")
    else:
        raise TypeError(f"unsupported attribute type {type(value)} for {name!r}")
    return msg


def _node_proto(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
                name: str = "", attrs: Optional[Dict[str, Any]] = None) -> bytes:
    msg = b"".join(_f_string(1, i) for i in inputs)
    msg += b"".join(_f_string(2, o) for o in outputs)
    if name:
        msg += _f_string(3, name)
    msg += _f_string(4, op_type)
    for k, v in (attrs or {}).items():
        if v is not None:
            msg += _f_bytes(5, _attribute_proto(k, v))
    return msg


def _value_info(name: str, shape: Sequence[int], onnx_dtype: int = 1) -> bytes:
    dims = b"".join(_f_bytes(1, _f_varint(1, d)) for d in shape)  # Dimension.dim_value
    tshape = _f_bytes(2, dims)                                    # TensorTypeProto.shape
    ttype = _f_varint(1, onnx_dtype) + tshape                     # elem_type + shape
    typ = _f_bytes(1, ttype)                                      # TypeProto.tensor_type
    return _f_string(1, name) + _f_bytes(2, typ)


class GraphBuilder:
    """Incrementally build a GraphProto and serialize a ModelProto."""

    def __init__(self, name: str = "fire_tpu"):
        self.name = name
        self._nodes: List[bytes] = []
        self._inits: List[bytes] = []
        self._inputs: List[bytes] = []
        self._outputs: List[bytes] = []
        self._auto = 0

    def fresh(self, hint: str = "t") -> str:
        self._auto += 1
        return f"{hint}_{self._auto}"

    def add_input(self, name: str, shape: Sequence[int], onnx_dtype: int = 1) -> str:
        self._inputs.append(_value_info(name, shape, onnx_dtype))
        return name

    def add_output(self, name: str, shape: Sequence[int] = (), onnx_dtype: int = 1) -> str:
        self._outputs.append(_value_info(name, shape, onnx_dtype))
        return name

    def add_init(self, name: str, arr: np.ndarray) -> str:
        self._inits.append(_f_bytes(5, _tensor_proto(name, np.asarray(arr))))
        return name

    def add_node(self, op_type: str, inputs: Sequence[str],
                 outputs: Optional[Sequence[str]] = None, name: str = "",
                 **attrs) -> str:
        if outputs is None:
            outputs = [self.fresh(op_type.lower())]
        self._nodes.append(_f_bytes(1, _node_proto(op_type, inputs, outputs, name, attrs)))
        return outputs[0]

    def model_bytes(self, opset: int = 13, ir_version: int = 8) -> bytes:
        graph = b"".join(self._nodes)
        graph += _f_string(2, self.name)
        graph += b"".join(self._inits)
        graph += b"".join(_f_bytes(11, vi) for vi in self._inputs)
        graph += b"".join(_f_bytes(12, vi) for vi in self._outputs)
        opset_id = _f_string(1, "") + _f_varint(2, opset)
        model = _f_varint(1, ir_version)
        model += _f_string(2, "fire_tpu")
        model += _f_bytes(7, graph)
        model += _f_bytes(8, opset_id)
        return model

    def save(self, path: str, opset: int = 13) -> None:
        with open(path, "wb") as f:
            f.write(self.model_bytes(opset))


# -------------------------------------------------------- YuNet exporter ---


def export_yunet(variables: dict, width: int = 64, image_hw=(640, 640)) -> bytes:
    """Serialize a :class:`fire_tpu_torch.models.yunet.YuNet` as ONNX with the
    2023mar file's I/O contract: input ``input`` (1,3,H,W) raw-pixel
    BGR NCHW; outputs ``cls_8..kps_32`` as (1, H·W, C) row-major maps
    (yunet.py:20-28 is the reference consumer).  Node order matches
    :func:`fire_tpu_torch.models.yunet.yunet_layer_order`, so the file
    round-trips through ``assign_yunet``."""
    p = flatten(variables["params"])
    s = flatten(variables["batch_stats"])
    g = GraphBuilder("yunet")
    h, w_in = image_hw
    g.add_input("input", (1, 3, h, w_in))

    def conv(x, path, strides=(1, 1), pads=(1, 1, 1, 1), group=1):
        kern = np.asarray(p[path + ("kernel",)], np.float32)  # HWIO
        if group > 1:
            oihw = np.transpose(kern, (3, 2, 0, 1))  # (C,1,kH,kW)
        else:
            oihw = np.transpose(kern, (3, 2, 0, 1))
        pre = "/".join(path)
        ins = [x, g.add_init(pre + "/W", oihw),
               g.add_init(pre + "/b", np.asarray(p[path + ("bias",)], np.float32))]
        return g.add_node("Conv", ins, strides=list(strides), pads=list(pads),
                          group=group, kernel_shape=list(kern.shape[:2]))

    def bn(x, path):
        pre = "/".join(path)
        ins = [x,
               g.add_init(pre + "/gamma", np.asarray(p[path + ("scale",)], np.float32)),
               g.add_init(pre + "/beta", np.asarray(p[path + ("bias",)], np.float32)),
               g.add_init(pre + "/mean", np.asarray(s[path + ("mean",)], np.float32)),
               g.add_init(pre + "/var", np.asarray(s[path + ("var",)], np.float32))]
        return g.add_node("BatchNormalization", ins, epsilon=1e-5)

    def dp(x, path, with_bn_relu=True):
        feats = np.asarray(p[path + ("conv2", "kernel")]).shape[-1]
        x = conv(x, path + ("conv1",), pads=(0, 0, 0, 0))
        x = conv(x, path + ("conv2",), group=feats)
        if with_bn_relu:
            x = bn(x, path + ("bn",))
            x = g.add_node("Relu", [x])
        return x

    def pool(x):
        return g.add_node("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])

    x = conv("input", ("model0", "conv1"), strides=(2, 2))
    x = bn(x, ("model0", "bn1"))
    x = g.add_node("Relu", [x])
    x = dp(x, ("model0", "conv2"))
    x = pool(x)
    x = dp(dp(x, ("model1", "conv1")), ("model1", "conv2"))
    x = dp(dp(x, ("model2", "conv1")), ("model2", "conv2"))
    x = pool(x)
    c3 = dp(dp(x, ("model3", "conv1")), ("model3", "conv2"))
    c4 = dp(dp(pool(c3), ("model4", "conv1")), ("model4", "conv2"))
    c5 = dp(dp(pool(c4), ("model5", "conv1")), ("model5", "conv2"))

    roi = g.add_init("roi", np.zeros(0, np.float32))
    up_scales = g.add_init("up2", np.asarray([1.0, 1.0, 2.0, 2.0], np.float32))
    p5 = dp(c5, ("neck2",))
    u5 = g.add_node("Resize", [p5, roi, up_scales], mode="nearest")
    p4 = dp(g.add_node("Add", [c4, u5]), ("neck1",))
    u4 = g.add_node("Resize", [p4, roi, up_scales], mode="nearest")
    p3 = dp(g.add_node("Add", [c3, u4]), ("neck0",))

    for stride, feat in ((8, p3), (16, p4), (32, p5)):
        f = dp(feat, (f"head_s{stride}", "feat"))
        for oname, ch in (("cls", 1), ("obj", 1), ("box", 4), ("kps", 10)):
            y = dp(f, (f"head_s{stride}", oname), with_bn_relu=False)
            if oname in ("cls", "obj"):
                y = g.add_node("Sigmoid", [y])
            y = g.add_node("Transpose", [y], perm=[0, 2, 3, 1])
            shape = g.add_init(f"shape_{oname}_{stride}", np.asarray([1, -1, ch], np.int64))
            out_name = f"{'bbox' if oname == 'box' else oname}_{stride}"
            g.add_node("Reshape", [y, shape], outputs=[out_name])
            g.add_output(out_name, (1, (h // stride) * (w_in // stride), ch))
    return g.model_bytes()


# ----------------------------------------------------- BlazeFace exporter ---


def export_blazeface(variables: dict) -> bytes:
    """Serialize a :class:`fire_tpu_torch.models.blazeface.BlazeFace` as ONNX
    in the TFLite file's spirit: BN-folded biased convs, input
    ``input`` (1,3,128,128) RGB in [-1,1], four NCHW head outputs named
    ``classifier_8/regressor_8`` (16×16 stride-8 map) and
    ``classifier_16/regressor_16`` (8×8) — the layer layout of
    MediaPipe's face_detection_short_range model
    (mediapipe_face_detector.py:28-33 is the reference consumer).
    Node order matches :func:`fire_tpu_torch.models.blazeface.blazeface_layer_order`
    so the file round-trips through ``assign_blazeface``."""
    from fire_tpu_torch.models.blazeface import BLAZE_BLOCKS

    p = flatten(variables["params"])
    g = GraphBuilder("blazeface")
    g.add_input("input", (1, 3, 128, 128))

    def conv(x, path, strides=(1, 1), pads=(0, 0, 0, 0), group=1):
        kern = np.asarray(p[path + ("kernel",)], np.float32)  # HWIO
        pre = "/".join(path)
        ins = [x, g.add_init(pre + "/W", np.transpose(kern, (3, 2, 0, 1))),
               g.add_init(pre + "/b", np.asarray(p[path + ("bias",)], np.float32))]
        return g.add_node("Conv", ins, strides=list(strides), pads=list(pads),
                          group=group, kernel_shape=list(kern.shape[:2]))

    # stem: 5×5/2 SAME on 128 → pads (1,1,2,2)
    x = conv("input", ("conv1",), strides=(2, 2), pads=(1, 1, 2, 2))
    x = g.add_node("Relu", [x])

    f16 = None
    cin = 24
    for i, (feats, stride) in enumerate(BLAZE_BLOCKS):
        if stride == 2 and feats == 96:
            f16 = x
        name = f"b{i + 1}"
        pads = (2, 2, 2, 2) if stride == 1 else (1, 1, 2, 2)
        y = conv(x, (name, "dw"), strides=(stride, stride), pads=pads, group=cin)
        y = conv(y, (name, "pw"))
        sc = x
        if stride == 2:
            sc = g.add_node("MaxPool", [sc], kernel_shape=[2, 2], strides=[2, 2])
        if feats > cin:
            pad_amt = g.add_init(
                f"{name}/chpad",
                np.asarray([0, 0, 0, 0, 0, feats - cin, 0, 0], np.int64),
            )
            sc = g.add_node("Pad", [sc, pad_amt], mode="constant")
        x = g.add_node("Relu", [g.add_node("Add", [sc, y])])
        cin = feats
    f8 = x

    for head, feat, ch, grid in (
        ("classifier_8", f16, 2, 16), ("regressor_8", f16, 32, 16),
        ("classifier_16", f8, 6, 8), ("regressor_16", f8, 96, 8),
    ):
        g.add_node("Conv", [
            feat,
            g.add_init(head + "/W", np.transpose(
                np.asarray(p[(head, "kernel")], np.float32), (3, 2, 0, 1))),
            g.add_init(head + "/b", np.asarray(p[(head, "bias")], np.float32)),
        ], outputs=[head], strides=[1, 1], pads=[0, 0, 0, 0], kernel_shape=[1, 1])
        g.add_output(head, (1, ch, grid, grid))
    return g.model_bytes()


# ------------------------------------------------------- FaceNet exporter ---


def export_facenet(variables: dict, embed_dim: int, depths=(5, 10, 5),
                   stem_width: int = 32, image_size: int = 160) -> bytes:
    """Serialize a :class:`fire_tpu_torch.models.facenet.FaceNet` as ONNX.

    Emits the Inception-ResNet-v1 graph in NCHW with the same node
    order :func:`fire_tpu_torch.models.facenet.facenet_layer_order` declares,
    so the file round-trips through :func:`assign_facenet` and runs
    under :mod:`fire_tpu_torch.models.onnx_exec` (or any standard runtime).
    Input contract matches the reference files: NHWC float [0,1]
    (modules/encoder.py:19-27) — a leading Transpose maps to NCHW.
    """
    p = flatten(variables["params"])
    s = flatten(variables["batch_stats"])
    g = GraphBuilder("facenet")
    g.add_input("input", (1, image_size, image_size, 3))
    x = g.add_node("Transpose", ["input"], perm=[0, 3, 1, 2])

    def conv(x, path, strides=(1, 1), pads=(0, 0, 0, 0)):
        kern = np.asarray(p[path + ("kernel",)], np.float32)
        w = g.add_init("/".join(path) + "/W", np.transpose(kern, (3, 2, 0, 1)))
        ins = [x, w]
        if path + ("bias",) in p:
            ins.append(g.add_init("/".join(path) + "/b",
                                  np.asarray(p[path + ("bias",)], np.float32)))
        return g.add_node("Conv", ins, strides=list(strides),
                          pads=list(pads), kernel_shape=list(kern.shape[:2]))

    def bn(x, path, eps=1e-3):
        n = np.asarray(s[path + ("mean",)]).shape[0]
        pre = "/".join(path)
        scale = (np.asarray(p[path + ("scale",)], np.float32)
                 if path + ("scale",) in p else np.ones(n, np.float32))
        ins = [x,
               g.add_init(pre + "/gamma", scale),
               g.add_init(pre + "/beta", np.asarray(p[path + ("bias",)], np.float32)),
               g.add_init(pre + "/mean", np.asarray(s[path + ("mean",)], np.float32)),
               g.add_init(pre + "/var", np.asarray(s[path + ("var",)], np.float32))]
        return g.add_node("BatchNormalization", ins, epsilon=float(eps))

    def convbn(x, path, strides=(1, 1), same=True, relu=True):
        kh, kw = np.asarray(p[path + ("conv", "kernel")]).shape[:2]
        pads = [kh // 2, kw // 2, (kh - 1) // 2, (kw - 1) // 2] if same else [0, 0, 0, 0]
        x = conv(x, path + ("conv",), strides, pads)
        x = bn(x, path + ("bn",))
        return g.add_node("Relu", [x]) if relu else x

    def block(x, name, branches, scale, relu=True):
        outs = [x]
        cat = [convbn_chain(x, name, br) for br in branches]
        up = g.add_node("Concat", cat, axis=1)
        up = conv(up, (name, "up"))
        sc = g.add_init(f"{name}/scale", np.asarray(scale, np.float32))
        up = g.add_node("Mul", [up, sc])
        out = g.add_node("Add", [x, up])
        return g.add_node("Relu", [out]) if relu else out

    def convbn_chain(x, name, chain):
        for sub in chain:
            x = convbn(x, (name, sub))
        return x

    # Stem — padding/stride layout mirrors FaceNet.__call__.
    x = convbn(x, ("stem0",), strides=(2, 2), same=False)
    x = convbn(x, ("stem1",), same=False)
    x = convbn(x, ("stem2",))
    x = g.add_node("MaxPool", [x], kernel_shape=[3, 3], strides=[2, 2])
    x = convbn(x, ("stem3",), same=False)
    x = convbn(x, ("stem4",), same=False)
    x = convbn(x, ("stem5",), strides=(2, 2), same=False)

    for i in range(depths[0]):
        x = block(x, f"block35_{i}", [["b0"], ["b1_0", "b1_1"], ["b2_0", "b2_1", "b2_2"]], 0.17)
    # ReductionA
    b0 = convbn(x, ("reduction_a", "b0"), strides=(2, 2), same=False)
    b1 = convbn(x, ("reduction_a", "b1_0"))
    b1 = convbn(b1, ("reduction_a", "b1_1"))
    b1 = convbn(b1, ("reduction_a", "b1_2"), strides=(2, 2), same=False)
    b2 = g.add_node("MaxPool", [x], kernel_shape=[3, 3], strides=[2, 2])
    x = g.add_node("Concat", [b0, b1, b2], axis=1)

    for i in range(depths[1]):
        x = block(x, f"block17_{i}", [["b0"], ["b1_0", "b1_1", "b1_2"]], 0.10)
    # ReductionB
    b0 = convbn(x, ("reduction_b", "b0_0"))
    b0 = convbn(b0, ("reduction_b", "b0_1"), strides=(2, 2), same=False)
    b1 = convbn(x, ("reduction_b", "b1_0"))
    b1 = convbn(b1, ("reduction_b", "b1_1"), strides=(2, 2), same=False)
    b2 = convbn(x, ("reduction_b", "b2_0"))
    b2 = convbn(b2, ("reduction_b", "b2_1"))
    b2 = convbn(b2, ("reduction_b", "b2_2"), strides=(2, 2), same=False)
    b3 = g.add_node("MaxPool", [x], kernel_shape=[3, 3], strides=[2, 2])
    x = g.add_node("Concat", [b0, b1, b2, b3], axis=1)

    for i in range(depths[2]):
        x = block(x, f"block8_{i}", [["b0"], ["b1_0", "b1_1", "b1_2"]], 0.20)
    x = block(x, "block8_final", [["b0"], ["b1_0", "b1_1", "b1_2"]], 1.0, relu=False)

    x = g.add_node("GlobalAveragePool", [x])
    x = g.add_node("Flatten", [x], axis=1)
    w = g.add_init("bottleneck/W", np.asarray(p[("bottleneck", "kernel")], np.float32))
    x = g.add_node("MatMul", [x, w])
    x = bn(x, ("bottleneck_bn",))
    g.add_node("Identity", [x], outputs=["embedding"])
    g.add_output("embedding", (1, embed_dim))
    return g.model_bytes()
