"""ONNX model reading and weight import, with no ``onnx`` package
(counterpart of ``fire_tpu.models.onnx_import``, whose numpy reader this
is, kept as a copy of its own: the port imports nothing of ``fire_tpu``).

* :func:`read_onnx` / :func:`read_onnx_bytes` parse a ModelProto's wire
  format: nodes with their attributes, initializers, graph inputs and
  outputs.  Repeated scalar fields are read packed (what exporters
  write) and unpacked.  A Git-LFS pointer stub raises
  ``FileNotFoundError`` naming it, as in JAX.
* :func:`assign_facenet` / :func:`assign_yunet` / :func:`assign_blazeface`
  zip the graph-order weight stream onto a Flax-named variable tree (the
  tree :func:`fire_tpu_torch.weights.materialize` fills, or a read
  msgpack) in the model's declared layer order, asserting every shape, so
  a topology mismatch raises ``ValueError`` naming the layer.  BatchNorm
  gammas fold into the variance of scale-free BN layers exactly as in
  JAX.  ``fire_tpu_torch.weights.from_flax_*`` then turn the tree into a
  state_dict.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from fire_tpu_torch.weights import flatten, unflatten

# ---------------------------------------------------------------- protobuf ---

_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _varints(buf: bytes) -> List[int]:
    """Decode a packed repeated-varint payload."""
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _signed(v: int) -> int:
    """Interpret a varint as two's-complement int64 (negative dims etc.)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _scan(buf: bytes):
    """Yield (field_number, wire_type, value_bytes_or_int) over a message."""
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == _WT_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wtype == _WT_I64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == _WT_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == _WT_I32:
            val = buf[pos : pos + 4]
            pos += 4
        else:  # pragma: no cover - groups unused by onnx
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _repeated_int(store: List[int], wtype: int, val) -> None:
    """Append to a repeated int64/int32 field, packed or unpacked."""
    if wtype == _WT_VARINT:
        store.append(_signed(val))
    elif wtype == _WT_LEN:
        store.extend(_signed(v) for v in _varints(val))
    else:  # fixed64 — not produced by onnx serializers, but cheap to accept
        store.append(struct.unpack("<q", val)[0])


# ONNX TensorProto.DataType → numpy
_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
_NP_TO_ONNX = {np.dtype(v): k for k, v in _ONNX_DTYPES.items()}


@dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    input_shapes: Dict[str, Tuple[int, ...]] = field(default_factory=dict)


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = np.float32
    raw = b""
    floats: List[float] = []
    ints: List[int] = []
    name = ""
    for fnum, wtype, val in _scan(buf):
        if fnum == 1:  # dims: repeated int64 (packed or unpacked)
            _repeated_int(dims, wtype, val)
        elif fnum == 2:  # data_type
            dtype = _ONNX_DTYPES.get(val, np.float32)
        elif fnum == 4:  # float_data (packed 32-bit)
            floats.extend(struct.unpack(f"<{len(val)//4}f", val))
        elif fnum == 7:  # int64_data (packed varints)
            ints.extend(_signed(v) for v in _varints(val))
        elif fnum == 8:  # name
            name = val.decode()
        elif fnum == 9:  # raw_data
            raw = val
        elif fnum == 6:  # int32_data (packed varints; also holds fp16 bits)
            ints.extend(_signed(v) for v in _varints(val))
        elif fnum == 10:  # double_data
            floats.extend(struct.unpack(f"<{len(val)//8}d", val))
    if raw:
        arr = np.frombuffer(raw, dtype=dtype).copy()
    elif floats:
        arr = np.asarray(floats, np.float64).astype(dtype)
    elif ints:
        if dtype == np.float16:  # fp16 payloads ride int32_data as raw bits
            arr = np.asarray(ints, np.uint16).view(np.float16)
        else:
            arr = np.asarray(ints, np.int64).astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    # no dims field ⇒ 0-d scalar tensor (ONNX convention)
    if arr.size != int(np.prod(dims)):
        # payload/dims mismatch (external-data tensor, truncated field):
        # fail at the parse site — a silently flat/empty array would
        # surface later as an opaque XLA shape error (or a wrong result)
        raise ValueError(
            f"initializer {name!r}: payload has {arr.size} elements, "
            f"dims {list(dims)} expect {int(np.prod(dims))} (external-data "
            "tensors are not supported)"
        )
    return name, arr.reshape(dims)


# AttributeProto.AttributeType
_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_TENSOR = 1, 2, 3, 4
_ATTR_FLOATS, _ATTR_INTS, _ATTR_STRINGS = 6, 7, 8


def _parse_attribute(buf: bytes) -> Tuple[str, Any]:
    name = ""
    atype = 0
    f_val: Optional[float] = None
    i_val: Optional[int] = None
    s_val: Optional[bytes] = None
    t_val: Optional[np.ndarray] = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for fnum, wtype, val in _scan(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:
            f_val = struct.unpack("<f", val)[0]
        elif fnum == 3:
            i_val = _signed(val)
        elif fnum == 4:
            s_val = val
        elif fnum == 5:
            _, t_val = _parse_tensor(val)
        elif fnum == 7:  # floats (packed or repeated fixed32)
            if wtype == _WT_LEN and len(val) % 4 == 0:
                floats.extend(struct.unpack(f"<{len(val)//4}f", val))
            elif wtype == _WT_I32:
                floats.append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            _repeated_int(ints, wtype, val)
        elif fnum == 9:
            strings.append(val)
        elif fnum == 20:
            atype = val
    if atype == _ATTR_FLOAT:
        return name, f_val
    if atype == _ATTR_INT:
        return name, i_val
    if atype == _ATTR_STRING:
        return name, s_val.decode() if s_val is not None else ""
    if atype == _ATTR_TENSOR:
        return name, t_val
    if atype == _ATTR_FLOATS:
        return name, list(floats)
    if atype == _ATTR_INTS:
        return name, list(ints)
    if atype == _ATTR_STRINGS:
        return name, [s.decode() for s in strings]
    # type field omitted: infer from what was set
    for v in (i_val, f_val, t_val):
        if v is not None:
            return name, v
    if ints:
        return name, list(ints)
    if floats:
        return name, list(floats)
    if s_val is not None:
        return name, s_val.decode()
    return name, None


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode(op_type="", name="")
    for fnum, wtype, val in _scan(buf):
        if fnum == 1:
            node.inputs.append(val.decode())
        elif fnum == 2:
            node.outputs.append(val.decode())
        elif fnum == 3:
            node.name = val.decode()
        elif fnum == 4:
            node.op_type = val.decode()
        elif fnum == 5:
            k, v = _parse_attribute(val)
            node.attrs[k] = v
    return node


def _parse_value_info(buf: bytes) -> Tuple[str, Tuple[int, ...]]:
    """ValueInfoProto → (name, static shape or () if unknown dims)."""
    name = ""
    shape: List[int] = []
    for fnum, wtype, val in _scan(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:  # TypeProto
            for f2, _, v2 in _scan(val):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _scan(v2):
                        if f3 == 2:  # TensorShapeProto
                            for f4, _, v4 in _scan(v3):
                                if f4 == 1:  # Dimension
                                    dim_value = 0
                                    for f5, _, v5 in _scan(v4):
                                        if f5 == 1:
                                            dim_value = _signed(v5)
                                    shape.append(dim_value)
    return name, tuple(shape)


def _parse_graph(buf: bytes) -> OnnxGraph:
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    inputs: List[str] = []
    outputs: List[str] = []
    input_shapes: Dict[str, Tuple[int, ...]] = {}
    for fnum, wtype, val in _scan(buf):
        if fnum == 1:  # node
            nodes.append(_parse_node(val))
        elif fnum == 5:  # initializer
            name, arr = _parse_tensor(val)
            inits[name] = arr
        elif fnum == 11:  # input (ValueInfoProto)
            name, shape = _parse_value_info(val)
            inputs.append(name)
            input_shapes[name] = shape
        elif fnum == 12:  # output
            name, _ = _parse_value_info(val)
            outputs.append(name)
    # ONNX allows initializers to double as graph inputs; real inputs are
    # the ones with no initializer backing them.
    inputs = [i for i in inputs if i not in inits]
    return OnnxGraph(nodes, inits, inputs, outputs, input_shapes)


def read_onnx(path: str) -> OnnxGraph:
    """Parse an ONNX ModelProto file into an :class:`OnnxGraph`."""
    with open(path, "rb") as f:
        data = f.read()
    return read_onnx_bytes(data, origin=path)


def read_onnx_bytes(data: bytes, origin: str = "<bytes>") -> OnnxGraph:
    if data.startswith(b"version https://git-lfs"):
        raise FileNotFoundError(
            f"{origin} is a Git-LFS pointer stub, not a real ONNX file — "
            "fetch the actual weights to enable import (SURVEY.md §7)."
        )
    for fnum, wtype, val in _scan(data):
        if fnum == 7 and wtype == _WT_LEN:  # ModelProto.graph
            return _parse_graph(val)
    raise ValueError(f"{origin}: no GraphProto found (not an ONNX model?)")


# ----------------------------------------------------------------- mapping ---

_PARAM_OPS = ("Conv", "BatchNormalization", "Gemm", "MatMul", "PRelu", "ConvTranspose")


def weight_stream(graph: OnnxGraph) -> List[Tuple[str, List[np.ndarray], OnnxNode]]:
    """Walk nodes in graph order; yield (op_type, [weight tensors], node)
    for every parameterised node.  ONNX graphs are topologically sorted,
    so for straight-line exports this is execution order — the order our
    Flax modules declare their parameters in."""
    out = []
    for node in graph.nodes:
        ws = [graph.initializers[i] for i in node.inputs if i in graph.initializers]
        if node.op_type in _PARAM_OPS and ws:
            out.append((node.op_type, ws, node))
    return out


def conv_to_hwio(w: np.ndarray) -> np.ndarray:
    """ONNX OIHW conv kernel → Flax HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def _fold_bn_gamma(scale, mean, var, node_eps, layer_eps):
    """Fold a positive BN gamma into the variance so a scale-free BN
    layer (epsilon ``layer_eps``) reproduces the ONNX node's
    y = gamma*(x-mean)/sqrt(var+node_eps) + beta exactly:
    (x-mean)/sqrt(var'+layer_eps) with var' = (var+node_eps)/gamma² − layer_eps."""
    gamma = scale.astype(np.float64)
    if np.any(gamma <= 0):
        raise ValueError(
            "non-positive BN gamma cannot fold into a scale-free BN layer "
            "(flip the preceding conv channel via convbn instead)"
        )
    var_new = (var.astype(np.float64) + node_eps) / np.square(gamma) - layer_eps
    return mean.astype(np.float32), var_new.astype(np.float32)


class StreamConsumer:
    """Zip an ONNX weight stream onto an explicit Flax layer order.

    The layer order is a list of ("convbn"|"conv"|"dense"|"bn", path)
    entries produced by the model module (e.g.
    :func:`fire_tpu_torch.models.facenet.facenet_layer_order`).  Every
    assignment asserts shape equality, so a topology mismatch fails
    loudly with the offending layer path instead of silently producing
    garbage embeddings.
    """

    def __init__(self, graph: OnnxGraph, flat_params: dict, flat_stats: dict):
        self.stream = weight_stream(graph)
        self.pos = 0
        self.p = dict(flat_params)
        self.s = dict(flat_stats)

    def _next(self, kinds: Tuple[str, ...], required=True):
        if self.pos >= len(self.stream):
            if required:
                raise ValueError(f"ONNX weight stream exhausted; wanted {kinds}")
            return None
        op, ws, node = self.stream[self.pos]
        if op not in kinds:
            if required:
                raise ValueError(
                    f"ONNX stream node #{self.pos} is {op} ({node.name!r}); wanted {kinds}"
                )
            return None
        self.pos += 1
        return op, ws, node

    def _set(self, tree: dict, path: tuple, value: np.ndarray, what: str):
        if path not in tree:
            raise ValueError(f"Flax tree has no leaf {path} (assigning {what})")
        want = tuple(tree[path].shape)
        got = tuple(value.shape)
        if want != got:
            raise ValueError(f"shape mismatch at {path}: Flax {want} vs ONNX {got} ({what})")
        tree[path] = value.astype(np.float32)

    def conv(self, path: tuple, bias_optional: bool = True):
        """Consume a Conv node → kernel (+ bias when the Flax layer has one)."""
        op, ws, node = self._next(("Conv",))
        kern = conv_to_hwio(ws[0])
        group = int(node.attrs.get("group", 1))
        if group > 1 and group == ws[0].shape[0] and ws[0].shape[1] == 1:
            # ONNX depthwise: (C,1,kH,kW) → Flax feature_group_count
            # layout (kH,kW,1,C) — same memory order, already correct.
            pass
        self._set(self.p, path + ("kernel",), kern, f"Conv {node.name}")
        if len(ws) > 1:
            if path + ("bias",) in self.p:
                self._set(self.p, path + ("bias",), ws[1], f"Conv bias {node.name}")
                return None
            return ws[1]  # caller folds into the following BN
        return None

    def bn(self, path: tuple, conv_bias: Optional[np.ndarray] = None,
           eps: float = 1e-3, kernel_path: Optional[tuple] = None):
        """Consume a BatchNormalization node → bias/mean/var (+ scale when
        the Flax BN has one; otherwise gamma is folded exactly, flipping
        the preceding conv channel when gamma is negative).

        When the exporter fused BN into the conv (no BN node follows),
        synthesize an identity BN carrying the conv bias instead.  ``eps``
        must match the Flax layer's epsilon (our FaceNet/YuNet BNs use
        the same eps the source models do, so node eps == layer eps).
        """
        nxt = self._next(("BatchNormalization",), required=False)
        if nxt is None:
            c = self.p.get(path + ("bias",))
            if c is None:
                raise ValueError(f"no BN node and no bias leaf for {path}")
            n = c.shape[0]
            bias = conv_bias if conv_bias is not None else np.zeros(n, np.float32)
            self._set(self.p, path + ("bias",), bias, "fused-BN bias")
            self._set(self.s, path + ("mean",), np.zeros(n, np.float32), "fused-BN mean")
            self._set(self.s, path + ("var",), np.full(n, 1.0 - eps, np.float32), "fused-BN var")
            return
        op, ws, node = nxt
        scale, bias, mean, var = ws[:4]
        node_eps = float(node.attrs.get("epsilon", 1e-5))
        if path + ("scale",) in self.p:
            self._set(self.p, path + ("scale",), scale, f"BN scale {node.name}")
            var = var + (node_eps - eps)  # absorb any epsilon difference
        elif not np.allclose(scale, 1.0):
            if np.any(scale <= 0) and kernel_path is not None:
                # flip the conv output channel so gamma becomes positive:
                # conv(x)·(-1) feeds BN with mean −mean and gamma −gamma
                sign = np.sign(scale).astype(np.float32)
                self.p[kernel_path] = self.p[kernel_path] * sign  # HWIO: last axis
                if conv_bias is not None:
                    conv_bias = conv_bias * sign
                mean = mean * sign
                scale = scale * sign
            mean, var = _fold_bn_gamma(scale, mean, var, node_eps, eps)
        else:
            var = var + (node_eps - eps)
        if conv_bias is not None:
            # conv bias b shifts BN input: (x+b-mean)/σ ⇒ fold into mean
            mean = mean - conv_bias
        self._set(self.p, path + ("bias",), bias, f"BN bias {node.name}")
        self._set(self.s, path + ("mean",), mean, f"BN mean {node.name}")
        self._set(self.s, path + ("var",), var, f"BN var {node.name}")

    def convbn(self, path: tuple, eps: float = 1e-3):
        """ConvBn pattern: Conv (bias folded if present) then BN."""
        conv_bias = self.conv(path + ("conv",))
        self.bn(path + ("bn",), conv_bias=conv_bias, eps=eps,
                kernel_path=path + ("conv", "kernel"))

    def dense(self, path: tuple):
        """Gemm / MatMul → Dense kernel (+bias).  ONNX Gemm stores W as
        (out, in) when transB=1, (in, out) otherwise; MatMul is (in, out)."""
        op, ws, node = self._next(("Gemm", "MatMul"))
        w = ws[0]
        if op == "Gemm" and int(node.attrs.get("transB", 0)):
            w = w.T
        self._set(self.p, path + ("kernel",), w, f"{op} {node.name}")
        if len(ws) > 1:
            self._set(self.p, path + ("bias",), ws[1], f"{op} bias {node.name}")

    def done(self):
        if self.pos != len(self.stream):
            left = [self.stream[i][2].name for i in range(self.pos, len(self.stream))]
            raise ValueError(f"unconsumed ONNX weight nodes: {left[:8]}")


def assign_by_layer_order(params: dict, batch_stats: dict, graph: OnnxGraph,
                          layer_order: List[Tuple[str, tuple]]) -> Tuple[dict, dict]:
    """Generic order-based assignment driven by an explicit layer list."""
    sc = StreamConsumer(graph, flatten(params), flatten(batch_stats))
    for entry in layer_order:
        kind, path = entry[0], entry[1]
        eps = entry[2] if len(entry) > 2 else 1e-3  # Flax layer epsilon
        if kind == "convbn":
            sc.convbn(path, eps=eps)
        elif kind == "conv":
            sc.conv(path)
        elif kind == "dense":
            sc.dense(path)
        elif kind == "bn":
            sc.bn(path, eps=eps)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
    sc.done()
    return unflatten(sc.p), unflatten(sc.s)


def assign_facenet(params: dict, batch_stats: dict, graph: OnnxGraph,
                   depths: Tuple[int, int, int] = (5, 10, 5)) -> Tuple[dict, dict]:
    """Map an ONNX FaceNet (Inception-ResNet-v1) export onto
    :class:`fire_tpu_torch.models.facenet.FaceNet`'s Flax-named variables by execution
    order, with a shape assertion at every layer (facenet_gpu.py:99-114
    is the reference consumer of these files)."""
    from fire_tpu_torch.models.facenet import facenet_layer_order

    return assign_by_layer_order(params, batch_stats, graph,
                                 facenet_layer_order(depths))


def assign_yunet(params: dict, batch_stats: dict, graph: OnnxGraph) -> Tuple[dict, dict]:
    """Map the OpenCV-zoo YuNet 2023mar ONNX export onto
    :class:`fire_tpu_torch.models.yunet.YuNet`'s Flax-named variables (yunet.py:20-28)."""
    from fire_tpu_torch.models.yunet import yunet_layer_order

    return assign_by_layer_order(params, batch_stats, graph, yunet_layer_order())


def assign_blazeface(params: dict, batch_stats: dict, graph: OnnxGraph) -> Tuple[dict, dict]:
    """Map a BlazeFace short-range ONNX export (BN pre-folded, biased
    convs — the TFLite file's layout, mediapipe_face_detector.py:28-33)
    onto :class:`fire_tpu_torch.models.blazeface.BlazeFace`'s Flax-named variables."""
    from fire_tpu_torch.models.blazeface import blazeface_layer_order

    return assign_by_layer_order(params, batch_stats, graph, blazeface_layer_order())
