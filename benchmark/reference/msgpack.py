"""Reader and writer of the networks' weight files (Flax ``to_bytes``
msgpack) and their conversion to and from ``torch`` state dicts of the
reference networks (:mod:`reference.nets`).

A frozen copy of the msgpack decoder and the Flax-to-torch layout rules
(HWIO kernels to OIHW, Dense ``(in, out)`` to Linear ``(out, in)``,
BatchNorm ``scale`` / ``bias`` / ``mean`` / ``var``, any other parameter
under its own name), and their exact inverse (:func:`tree_of`,
:func:`pack`, :func:`write`), which writes seeded weights in the trained
files' layout; it imports nothing of the program.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _bf16_to_f32(raw: bytes) -> np.ndarray:
    u16 = np.frombuffer(raw, np.uint16)
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _ndarray(payload: bytes):
    shape, dtype_name, buf = _Unpacker(payload).unpack_one()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        arr = _bf16_to_f32(buf)
    else:
        arr = np.frombuffer(buf, np.dtype(dtype_name)).copy()
    return arr.reshape(tuple(shape))


class _Unpacker:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.off = 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.off : self.off + n].tobytes()
        self.off += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _ext(self, code: int, payload: bytes):
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def unpack_one(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode()
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            return self._take(self._uint(1 << (b - 0xC4)))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._uint(1 << (b - 0xC7))
            code = struct.unpack(">b", self._take(1))[0]
            return self._ext(code, self._take(n))
        if b == 0xCA:
            return struct.unpack(">f", self._take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self._take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self._uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            n = 1 << (b - 0xD0)
            return int.from_bytes(self._take(n), "big", signed=True)
        if 0xD4 <= b <= 0xD8:
            code = struct.unpack(">b", self._take(1))[0]
            return self._ext(code, self._take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):
            return self._take(self._uint(1 << (b - 0xD9))).decode()
        if b in (0xDC, 0xDD):
            return self._array(self._uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self._map(self._uint(2 if b == 0xDE else 4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _array(self, n: int):
        return [self.unpack_one() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.unpack_one()
            out[k.decode() if isinstance(k, bytes) else k] = self.unpack_one()
        return out


def msgpack_restore(data: bytes) -> Any:
    """Decode a ``flax.serialization.to_bytes`` blob to nested dicts of
    numpy arrays (bf16 leaves come back as exact float32)."""
    up = _Unpacker(data)
    out = up.unpack_one()
    if up.off != len(up.data):
        raise ValueError("trailing bytes after msgpack object")
    if isinstance(out, dict) and "__msgpack_chunked_array__" in out:
        raise ValueError("chunked msgpack arrays are not supported")
    return out


def flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


_LEAF = {
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _convert(tree: Dict[str, Any], unit_bn_scale: bool) -> Dict[str, torch.Tensor]:
    flat = flatten(tree)
    sd: Dict[str, torch.Tensor] = {}
    bn_layers = set()
    for path, leaf in flat.items():
        col, mod, name = path[0], path[1:-1], path[-1]
        arr = np.array(leaf, dtype=np.float32)  # owned, writable copy
        if (col, name) == ("params", "kernel"):
            if arr.ndim == 4:  # HWIO → OIHW (depthwise (3,3,1,f) → (f,1,3,3))
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:  # Dense (in, out) → Linear (out, in)
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
            tname = "weight"
        elif (col, name) in _LEAF:
            tname = _LEAF[(col, name)]
            if col == "batch_stats":
                bn_layers.add(mod)
        elif col == "params":  # any other parameter (a PReLU slope) under its own name
            tname = name
        else:
            raise ValueError(f"unconsumed weight leaf {'/'.join(path)}")
        key = ".".join(mod + (tname,))
        if key in sd:
            raise ValueError(f"duplicate weight {key}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    if unit_bn_scale:
        for mod in bn_layers:
            key = ".".join(mod + ("weight",))
            if key in sd:
                raise ValueError(f"{key}: a BatchNorm under unit_bn_scale has no scale")
            sd[key] = torch.ones_like(sd[".".join(mod + ("running_mean",))])
    return sd


def read(path: str) -> Dict[str, Any]:
    """The variable tree of a trained file."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def state_dict(tree: Dict[str, Any], unit_bn_scale: bool) -> Dict[str, torch.Tensor]:
    """The ``torch`` state dict of a variable tree (FaceNet's BatchNorm
    has no scale: ``unit_bn_scale``)."""
    return _convert(tree, unit_bn_scale)


_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def tree_of(sd: Dict[str, torch.Tensor], unit_bn_scale: bool) -> Dict[str, Any]:
    """The variable tree (float32 numpy leaves) of a state dict: the
    exact inverse of :func:`state_dict`.  A module with a running mean
    is a BatchNorm; under ``unit_bn_scale`` its weight, which has to be
    1, is left out."""
    bn_layers = {k.rpartition(".")[0] for k in sd if k.endswith(".running_mean")}
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, t in sd.items():
        mod, _, name = key.rpartition(".")
        arr = t.detach().to("cpu", torch.float32).numpy()
        if mod in bn_layers:
            col, leaf = _BN_LEAF[name]
            if unit_bn_scale and name == "weight":
                if not (arr == 1.0).all():
                    raise ValueError(f"{key}: a BatchNorm without scale has weight 1")
                continue
        elif name == "weight":
            col, leaf = "params", "kernel"
            if arr.ndim == 4:  # OIHW → HWIO
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:  # Linear (out, in) → Dense (in, out)
                arr = arr.T
            else:
                raise ValueError(f"unexpected weight rank at {key}")
        elif name in ("kernel", "scale"):
            raise ValueError(f"{key}: the reader would take this leaf for another")
        else:
            col, leaf = "params", name
        node = out[col]
        for k in mod.split(".") if mod else ():
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {k: v for k, v in out.items() if v}


class _Packer:
    """msgpack as ``msgpack.packb(..., use_bin_type=True)`` writes it, for
    what Flax's ``to_bytes`` writes: maps, str, bin, arrays, non-negative
    ints and ndarrays (ext type 1)."""

    def __init__(self):
        self.out: list = []

    def _head(self, n: int, fix: int, fix_max: int, wide: tuple) -> None:
        if n < fix_max and fix is not None:
            self.out.append(bytes([fix | n]))
            return
        for code, size in wide:
            if n < 1 << (8 * size):
                self.out.append(bytes([code]) + n.to_bytes(size, "big"))
                return
        raise ValueError(f"msgpack length {n} too large")

    def pack(self, x: Any) -> None:
        if isinstance(x, dict):
            self._head(len(x), 0x80, 16, ((0xDE, 2), (0xDF, 4)))
            for k, v in x.items():
                self.pack(k)
                self.pack(v)
        elif isinstance(x, (list, tuple)):
            self._head(len(x), 0x90, 16, ((0xDC, 2), (0xDD, 4)))
            for v in x:
                self.pack(v)
        elif isinstance(x, str):
            b = x.encode()
            self._head(len(b), 0xA0, 32, ((0xD9, 1), (0xDA, 2), (0xDB, 4)))
            self.out.append(b)
        elif isinstance(x, bytes):
            self._head(len(x), None, 0, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))
            self.out.append(x)
        elif isinstance(x, (int, np.integer)) and not isinstance(x, bool) and x >= 0:
            x = int(x)
            if x < 128:
                self.out.append(bytes([x]))
            else:
                self._head(x, None, 0, ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)))
        elif isinstance(x, np.ndarray):
            inner = _Packer()
            inner.pack(([int(d) for d in x.shape], x.dtype.name, x.tobytes("C")))
            payload = inner.getvalue()
            fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
            if len(payload) in fixed:
                self.out.append(bytes([fixed[len(payload)]]))
            else:
                self._head(len(payload), None, 0, ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
            self.out.append(struct.pack(">b", _EXT_NDARRAY) + payload)
        else:
            raise TypeError(f"cannot write {type(x).__name__} to msgpack")

    def getvalue(self) -> bytes:
        return b"".join(self.out)


def pack(tree: Dict[str, Any]) -> bytes:
    """The msgpack bytes of a variable tree: the inverse of
    :func:`msgpack_restore`."""
    p = _Packer()
    p.pack(tree)
    return p.getvalue()


def write(path: str, tree: Dict[str, Any]) -> None:
    """Write a variable tree as a weight file that :func:`read` reads."""
    with open(path, "wb") as f:
        f.write(pack(tree))
