"""TFLite flatbuffer reading, BlazeFace weight import and a writer, with
no ``flatbuffers`` or ``tensorflow`` package (counterpart of
``fire_tpu.models.tflite_import``, kept as a copy of its own).

:func:`read_tflite` walks ``Model → SubGraph → Operator/Tensor/Buffer``
and pulls out the float32 / float16 weight tensors (following one
DEQUANTIZE hop for the fp16 variant); quantized models are refused.
:func:`assign_blazeface_tflite` zips the CONV_2D / DEPTHWISE_CONV_2D ops
in execution order onto BlazeFace's Flax-named params
(:func:`fire_tpu_torch.models.blazeface.blazeface_layer_order`), and
:func:`write_tflite_blazeface` writes such a file from them.  A Git-LFS
pointer stub raises ``FileNotFoundError``, as in JAX.

Flatbuffer wire format (flatbuffers internals documentation):
  * root: uoffset32 at byte 0 to the root table (file id at bytes 4-8);
  * table: soffset32 to its vtable; vtable = [u16 vtable_bytes,
    u16 table_bytes, u16 field_offset...] (0 = field absent);
  * vector: u32 length then elements; string: u32 length + bytes;
  * all offsets are relative to the position they are stored at.

TFLite schema field slots (tensorflow/lite/schema/schema.fbs — stable
since schema v3): Model{version=0, operator_codes=1, subgraphs=2,
description=3, buffers=4}; OperatorCode{deprecated_builtin_code=0,
custom_code=1, version=2, builtin_code=3}; SubGraph{tensors=0,
inputs=1, outputs=2, operators=3, name=4}; Operator{opcode_index=0,
inputs=1, outputs=2}; Tensor{shape=0, type=1, buffer=2, name=3};
Buffer{data=0}.
"""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

# TFLite BuiltinOperator codes used here
OP_CONV_2D = 3
OP_DEPTHWISE_CONV_2D = 4
OP_DEQUANTIZE = 6

# TFLite TensorType
_TT_FLOAT32 = 0
_TT_FLOAT16 = 1
_TT_INT32 = 2

_TT_NP = {_TT_FLOAT32: np.float32, _TT_FLOAT16: np.float16, _TT_INT32: np.int32}


# --------------------------------------------------------------- reader --


class _Fb:
    """Cursor-free flatbuffer accessor over one bytes object."""

    def __init__(self, data: bytes):
        self.d = data

    def u8(self, p):
        return self.d[p]

    def u16(self, p):
        return struct.unpack_from("<H", self.d, p)[0]

    def u32(self, p):
        return struct.unpack_from("<I", self.d, p)[0]

    def i32(self, p):
        return struct.unpack_from("<i", self.d, p)[0]

    def root(self) -> int:
        return self.u32(0)

    def field(self, table: int, slot: int) -> Optional[int]:
        """Absolute position of field `slot` of the table at `table`,
        or None if absent."""
        vt = table - self.i32(table)
        vt_size = self.u16(vt)
        off = 4 + 2 * slot
        if off + 2 > vt_size:
            return None
        rel = self.u16(vt + off)
        return table + rel if rel else None

    def indirect(self, p: int) -> int:
        return p + self.u32(p)

    def table_field(self, table: int, slot: int) -> Optional[int]:
        p = self.field(table, slot)
        return None if p is None else self.indirect(p)

    def scalar_field(self, table: int, slot: int, fmt: str, default):
        p = self.field(table, slot)
        return default if p is None else struct.unpack_from(fmt, self.d, p)[0]

    def string_at(self, p: int) -> str:
        n = self.u32(p)
        return self.d[p + 4 : p + 4 + n].decode("utf-8", "replace")

    def string_field(self, table: int, slot: int) -> str:
        p = self.table_field(table, slot)
        return "" if p is None else self.string_at(p)

    def vector(self, table: int, slot: int) -> Tuple[int, int]:
        """(element_base, length) of a vector field; (0, 0) if absent."""
        p = self.table_field(table, slot)
        if p is None:
            return 0, 0
        return p + 4, self.u32(p)

    def i32_vector(self, table: int, slot: int) -> np.ndarray:
        base, n = self.vector(table, slot)
        return np.frombuffer(self.d, "<i4", n, base).copy() if n else np.empty(0, np.int32)

    def u8_vector_bytes(self, table: int, slot: int) -> bytes:
        base, n = self.vector(table, slot)
        return self.d[base : base + n] if n else b""

    def table_vector(self, table: int, slot: int) -> List[int]:
        base, n = self.vector(table, slot)
        return [self.indirect(base + 4 * i) for i in range(n)]


class TfliteTensor(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    ttype: int                      # TFLite TensorType code
    data: Optional[np.ndarray]      # weight payload, or None (activation)


class TfliteOp(NamedTuple):
    code: int                       # BuiltinOperator
    inputs: Tuple[int, ...]         # tensor indices (-1 = absent optional)
    outputs: Tuple[int, ...]


class TfliteModel(NamedTuple):
    tensors: List[TfliteTensor]
    ops: List[TfliteOp]             # execution order
    inputs: Tuple[int, ...]
    outputs: Tuple[int, ...]
    description: str

    def weight(self, idx: int) -> np.ndarray:
        """Float weight payload of tensor `idx`, following one
        DEQUANTIZE hop (fp16-variant files store fp16 constants that a
        DEQUANTIZE op widens at runtime)."""
        t = self.tensors[idx]
        if t.data is None:
            for op in self.ops:
                if op.code == OP_DEQUANTIZE and idx in op.outputs:
                    t = self.tensors[op.inputs[0]]
                    break
        if t.data is None:
            raise ValueError(f"tensor {idx} ({t.name!r}) has no constant payload")
        if t.ttype not in (_TT_FLOAT32, _TT_FLOAT16):
            raise ValueError(
                f"tensor {t.name!r} has TFLite type {t.ttype}; only float "
                "models are supported (the reference uses the float BlazeFace)"
            )
        return np.ascontiguousarray(t.data, np.float32)


def read_tflite(path_or_bytes) -> TfliteModel:
    """Parse a .tflite flatbuffer into tensors + execution-order ops."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data.startswith(b"version https://git-lfs"):
        # same contract as the ONNX reader: a Git-LFS pointer stub is
        # "file absent", not "file malformed" (onnx_import LFS handling)
        raise FileNotFoundError(
            "TFLite file is a Git-LFS pointer stub, not the actual weights"
        )
    if len(data) < 8:
        raise ValueError("not a TFLite flatbuffer: file too small")
    fb = _Fb(data)
    model = fb.root()
    if not 4 <= model <= len(data) - 4:
        raise ValueError("not a TFLite flatbuffer: root offset out of range")
    if data[4:8] != b"TFL3":
        # tflite files always carry the TFL3 identifier; anything else
        # (text files, other formats) is rejected before table parsing
        raise ValueError("not a TFLite flatbuffer: bad file identifier")

    try:
        return _parse_model(fb, model)
    except (struct.error, IndexError, OverflowError) as e:
        raise ValueError(f"malformed TFLite flatbuffer: {e}") from e


def _parse_model(fb: _Fb, model: int) -> TfliteModel:
    buffers: List[bytes] = [
        fb.u8_vector_bytes(b, 0) for b in fb.table_vector(model, 4)
    ]

    subgraphs = fb.table_vector(model, 2)
    if not subgraphs:
        raise ValueError("TFLite model has no subgraphs")
    sg = subgraphs[0]

    tensors: List[TfliteTensor] = []
    for t in fb.table_vector(sg, 0):
        shape = tuple(int(v) for v in fb.i32_vector(t, 0))
        ttype = fb.scalar_field(t, 1, "<b", 0)
        buf_idx = fb.scalar_field(t, 2, "<I", 0)
        name = fb.string_field(t, 3)
        payload = buffers[buf_idx] if 0 <= buf_idx < len(buffers) else b""
        arr = None
        if payload and ttype in _TT_NP:
            arr = np.frombuffer(payload, _TT_NP[ttype]).reshape(shape)
        tensors.append(TfliteTensor(name, shape, ttype, arr))

    # operator_codes: new-style builtin_code (slot 3) falls back to the
    # deprecated int8 field (slot 0) for codes < 127 (older exporters)
    codes: List[int] = []
    for oc in fb.table_vector(model, 1):
        code = fb.scalar_field(oc, 3, "<i", 0)
        if code == 0:
            code = fb.scalar_field(oc, 0, "<b", 0)
        codes.append(code)

    ops: List[TfliteOp] = []
    for op in fb.table_vector(sg, 3):
        oi = fb.scalar_field(op, 0, "<I", 0)
        ops.append(
            TfliteOp(
                codes[oi] if oi < len(codes) else -1,
                tuple(int(v) for v in fb.i32_vector(op, 1)),
                tuple(int(v) for v in fb.i32_vector(op, 2)),
            )
        )

    return TfliteModel(
        tensors,
        ops,
        tuple(int(v) for v in fb.i32_vector(sg, 1)),
        tuple(int(v) for v in fb.i32_vector(sg, 2)),
        fb.string_field(model, 3),
    )


# ----------------------------------------------------------- assignment --


def _tree_np(tree):
    """A copy of a nested dict with numpy leaves: assignment never
    writes into the caller's tree."""
    return {k: _tree_np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _conv_kernel_to_hwio(w: np.ndarray, depthwise: bool) -> np.ndarray:
    """TFLite conv layouts → Flax HWIO.

    CONV_2D filters are OHWI ``(out, kh, kw, in)``; DEPTHWISE_CONV_2D
    filters are ``(1, kh, kw, in·mult)`` and Flax's grouped conv
    (feature_group_count=in) wants ``(kh, kw, 1, in·mult)``.
    """
    if depthwise:
        if w.ndim != 4 or w.shape[0] != 1:
            raise ValueError(f"bad depthwise filter shape {w.shape}")
        return np.transpose(w, (1, 2, 0, 3))
    if w.ndim != 4:
        raise ValueError(f"bad conv filter shape {w.shape}")
    return np.transpose(w, (1, 2, 3, 0))


def assign_blazeface_tflite(params: dict, model: TfliteModel) -> dict:
    """Assign a TFLite BlazeFace's conv weights into Flax params.

    Walks the model's CONV_2D / DEPTHWISE_CONV_2D ops in execution
    order and zips them against
    :func:`fire_tpu_torch.models.blazeface.blazeface_layer_order` — the same
    execution-order contract the ONNX importer uses.  Raises
    ``ValueError`` on any count/type/shape mismatch (callers fall back
    to random init or another weight source).
    """
    from fire_tpu_torch.models.blazeface import blazeface_layer_order

    conv_ops = [op for op in model.ops if op.code in (OP_CONV_2D, OP_DEPTHWISE_CONV_2D)]
    order = blazeface_layer_order()
    if len(conv_ops) != len(order):
        raise ValueError(
            f"TFLite model has {len(conv_ops)} conv ops; BlazeFace "
            f"short-range needs {len(order)}"
        )

    params = _tree_np(params)
    for (kind, path), op in zip(order, conv_ops):
        assert kind == "conv"
        depthwise = path[-1] == "dw"
        want_code = OP_DEPTHWISE_CONV_2D if depthwise else OP_CONV_2D
        if op.code != want_code:
            raise ValueError(
                f"op for layer {'/'.join(path)} is builtin {op.code}, "
                f"expected {want_code}"
            )
        if len(op.inputs) < 3 or op.inputs[2] < 0:
            raise ValueError(f"conv for {'/'.join(path)} has no bias input")
        kernel = _conv_kernel_to_hwio(model.weight(op.inputs[1]), depthwise)
        bias = model.weight(op.inputs[2]).reshape(-1)

        leaf = params
        for k in path:
            leaf = leaf[k]
        if leaf["kernel"].shape != kernel.shape:
            raise ValueError(
                f"layer {'/'.join(path)}: kernel shape {kernel.shape} != "
                f"model's {leaf['kernel'].shape}"
            )
        if leaf["bias"].shape != bias.shape:
            raise ValueError(
                f"layer {'/'.join(path)}: bias shape {bias.shape} != "
                f"model's {leaf['bias'].shape}"
            )
        leaf["kernel"] = kernel.astype(leaf["kernel"].dtype)
        leaf["bias"] = bias.astype(leaf["bias"].dtype)
    return params


# ------------------------------------------------------------- builder --


class _FbBuilder:
    """Minimal flatbuffer builder (prepend-style, like the upstream
    libraries): enough to emit a valid TFLite file for round-trip
    tests of the reader/importer.  Offsets are measured from the END
    of the buffer, matching flatbuffers' build-backwards convention."""

    def __init__(self):
        self.data = bytearray()
        self.minalign = 4
        self._slots: Optional[Dict[int, int]] = None
        self._object_start = 0

    # -- primitives
    def offset(self) -> int:
        return len(self.data)

    def _place(self, b: bytes) -> None:
        self.data[:0] = b

    def _pad(self, n: int) -> None:
        if n:
            self.data[:0] = b"\x00" * n

    def _prep(self, size: int, additional: int) -> None:
        if size > self.minalign:
            self.minalign = size
        self._pad((-(len(self.data) + additional)) % size)

    def _scalar(self, fmt: str, v) -> None:
        b = struct.pack(fmt, v)
        self._prep(len(b), 0)
        self._place(b)

    def _uoffset(self, target: int) -> None:
        self._prep(4, 0)
        self._place(struct.pack("<I", self.offset() + 4 - target))

    # -- vectors / strings (create before the table that refers to them)
    def vector_i32(self, values: Sequence[int]) -> int:
        self._prep(4, 4 * len(values))
        for v in reversed(values):
            self._place(struct.pack("<i", int(v)))
        self._place(struct.pack("<I", len(values)))
        return self.offset()

    def vector_u8(self, payload: bytes) -> int:
        self._prep(4, len(payload))
        self._place(bytes(payload))
        self._place(struct.pack("<I", len(payload)))
        return self.offset()

    def vector_tables(self, offsets: Sequence[int]) -> int:
        self._prep(4, 4 * len(offsets))
        for t in reversed(offsets):
            self._uoffset(t)
        self._place(struct.pack("<I", len(offsets)))
        return self.offset()

    def string(self, s: str) -> int:
        b = s.encode("utf-8")
        self._prep(4, len(b) + 1)
        self._place(b + b"\x00")
        self._place(struct.pack("<I", len(b)))
        return self.offset()

    # -- tables
    def start_table(self) -> None:
        assert self._slots is None, "nested tables not supported"
        self._slots = {}
        self._object_start = self.offset()

    def slot_scalar(self, slot: int, fmt: str, v, default=0) -> None:
        if v == default:
            return
        self._scalar(fmt, v)
        self._slots[slot] = self.offset()

    def slot_offset(self, slot: int, target: Optional[int]) -> None:
        if not target:
            return
        self._uoffset(target)
        self._slots[slot] = self.offset()

    def end_table(self) -> int:
        slots, self._slots = self._slots, None
        self._prep(4, 0)
        self._place(struct.pack("<i", 0))  # soffset placeholder
        obj = self.offset()
        n_slots = (max(slots) + 1) if slots else 0
        for s in reversed(range(n_slots)):
            self._place(struct.pack("<H", obj - slots[s] if s in slots else 0))
        self._place(struct.pack("<H", obj - self._object_start))  # table bytes
        self._place(struct.pack("<H", 4 + 2 * n_slots))           # vtable bytes
        vt = self.offset()
        idx = len(self.data) - obj
        self.data[idx : idx + 4] = struct.pack("<i", vt - obj)
        return obj

    def finish(self, root: int, file_id: bytes = b"TFL3") -> bytes:
        self._prep(self.minalign, 4 + len(file_id))
        if file_id:
            assert len(file_id) == 4
            self._place(file_id)
        self._place(struct.pack("<I", self.offset() + 4 - root))
        return bytes(self.data)


def write_tflite_blazeface(params: dict, path: Optional[str] = None) -> bytes:
    """Serialize Flax BlazeFace params as a float32 TFLite flatbuffer
    with the real model's op sequence (DEPTHWISE_CONV_2D + CONV_2D per
    BlazeBlock, CONV_2D heads) — the interchange fixture proving
    :func:`read_tflite`/:func:`assign_blazeface_tflite` handle the
    distribution format, mirroring onnx_export.export_blazeface."""
    from fire_tpu_torch.models.blazeface import blazeface_layer_order

    params = _tree_np(params)
    b = _FbBuilder()

    # Tensor weights first (buffers/tensors reference them by index).
    weights: List[Tuple[str, np.ndarray]] = [("", np.empty(0, np.float32))]  # buffer 0 empty
    op_specs: List[Tuple[int, int, int]] = []  # (code, filter_buf, bias_buf)
    for kind, path_keys in blazeface_layer_order():
        leaf = params
        for k in path_keys:
            leaf = leaf[k]
        name = "/".join(path_keys)
        depthwise = path_keys[-1] == "dw"
        w = np.asarray(leaf["kernel"], np.float32)
        w = np.transpose(w, (2, 0, 1, 3)) if depthwise else np.transpose(w, (3, 0, 1, 2))
        weights.append((name + "/filter", np.ascontiguousarray(w)))
        weights.append((name + "/bias", np.asarray(leaf["bias"], np.float32)))
        code = OP_DEPTHWISE_CONV_2D if depthwise else OP_CONV_2D
        op_specs.append((code, len(weights) - 2, len(weights) - 1))

    buffer_offs = []
    for _, arr in weights:
        data_off = b.vector_u8(arr.tobytes()) if arr.size else None
        b.start_table()
        b.slot_offset(0, data_off)
        buffer_offs.append(b.end_table())
    buffers_vec = b.vector_tables(buffer_offs)

    tensor_offs = []

    def add_tensor(name: str, shape: Sequence[int], buf: int) -> int:
        shape_off = b.vector_i32(list(shape))
        name_off = b.string(name)
        b.start_table()
        b.slot_offset(0, shape_off)
        b.slot_scalar(1, "<b", _TT_FLOAT32)
        b.slot_scalar(2, "<I", buf)
        b.slot_offset(3, name_off)
        tensor_offs.append(b.end_table())
        return len(tensor_offs) - 1

    input_idx = add_tensor("input", (1, 128, 128, 3), 0)
    op_tensor_idx: List[Tuple[int, int, int, int]] = []  # (code, in, filt, bias) -> out appended
    for i, (code, fbuf, bbuf) in enumerate(op_specs):
        fname, farr = weights[fbuf]
        bname, barr = weights[bbuf]
        fi = add_tensor(fname, farr.shape, fbuf)
        bi = add_tensor(bname, barr.shape, bbuf)
        oi = add_tensor(f"act{i}", (1, 1, 1, int(barr.shape[0])), 0)
        op_tensor_idx.append((code, fi, bi, oi))
    tensors_vec = b.vector_tables(tensor_offs)

    # operator codes table: index 0 = CONV_2D, 1 = DEPTHWISE_CONV_2D
    oc_offs = []
    for code in (OP_CONV_2D, OP_DEPTHWISE_CONV_2D):
        b.start_table()
        b.slot_scalar(0, "<b", code)   # deprecated_builtin_code
        b.slot_scalar(2, "<i", 1, default=0)
        b.slot_scalar(3, "<i", code)
        oc_offs.append(b.end_table())
    opcodes_vec = b.vector_tables(oc_offs)

    op_offs = []
    prev_out = input_idx
    for code, fi, bi, oi in op_tensor_idx:
        inputs = b.vector_i32([prev_out, fi, bi])
        outputs = b.vector_i32([oi])
        b.start_table()
        b.slot_scalar(0, "<I", 1 if code == OP_DEPTHWISE_CONV_2D else 0, default=-1)
        b.slot_offset(1, inputs)
        b.slot_offset(2, outputs)
        op_offs.append(b.end_table())
        prev_out = oi
    ops_vec = b.vector_tables(op_offs)

    sg_inputs = b.vector_i32([input_idx])
    sg_outputs = b.vector_i32([prev_out])
    sg_name = b.string("blazeface_short_range")
    b.start_table()
    b.slot_offset(0, tensors_vec)
    b.slot_offset(1, sg_inputs)
    b.slot_offset(2, sg_outputs)
    b.slot_offset(3, ops_vec)
    b.slot_offset(4, sg_name)
    sg_off = b.end_table()
    subgraphs_vec = b.vector_tables([sg_off])

    desc = b.string("fire_tpu blazeface interchange")
    b.start_table()
    b.slot_scalar(0, "<I", 3)  # schema version
    b.slot_offset(1, opcodes_vec)
    b.slot_offset(2, subgraphs_vec)
    b.slot_offset(3, desc)
    b.slot_offset(4, buffers_vec)
    root = b.end_table()
    blob = b.finish(root)
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob
