"""Flax msgpack weight files → torch state_dicts (no Flax, msgpack or
ml_dtypes needed).

Counterpart of ``fire_tpu.pipeline.engine.load_trained_*``
(``engine.py:218-259``), which restore the committed
``weights_trained/*.msgpack`` through ``flax.serialization``.  The
machine with the card has neither ``flax``, ``msgpack`` nor
``ml_dtypes``, so this module carries:

* :func:`msgpack_restore` — a minimal msgpack decoder for what
  ``flax.serialization.to_bytes`` writes: maps, str, bin, arrays, ints,
  floats, bool/nil and the ndarray / numpy-scalar ext types (1 and 3),
  whose payload is itself msgpack ``(shape, dtype_name, raw_bytes)``.
  ``bfloat16`` leaves are decoded by hand (uint16 shifted left by 16,
  viewed as float32 — exact).
* :func:`from_flax_yunet` / :func:`from_flax_blazeface` /
  :func:`from_flax_facenet` — the numpy tree
  to a torch state_dict for :mod:`fire_tpu_torch.models`: HWIO conv
  kernels become OIHW (a depthwise ``(3,3,1,f)`` becomes ``(f,1,3,3)``
  by the same transpose), Dense ``(in,out)`` becomes Linear ``(out,in)``,
  BatchNorm ``scale/bias/mean/var`` become ``weight/bias/running_mean/
  running_var``.  FaceNet's BatchNorms have ``use_scale=False``; their
  weight is 1.  Any leaf the mapping does not consume raises, and
  :func:`load_into` loads strictly, so a missing or surplus tensor
  raises too.  :func:`from_flax_retinaface` does the same for RetinaFace.
* :func:`flax_shapes` / :func:`to_flax` — the inverse direction: a
  module's Flax variable tree, as shapes or as float32 arrays, so that
* :func:`materialize` — the JAX engine's deterministic random init
  (``fire_tpu/pipeline/engine.py:54-85``), copied exactly — can fill it,
  and
* :func:`msgpack_serialize` — the writer of ``flax.serialization.
  to_bytes``'s format — can store it as the JAX engine's params cache or
  as a trainer's output, which either package loads.
* :func:`carry_state` — a JAX train state (params, batch stats and
  optax's Adam moments, as numpy trees) carried into a module and the
  port's optimizer state, so that tests start both packages from one
  state.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from fire_tpu_torch.models.layers import BatchNorm

# ---------------------------------------------------------------- msgpack --

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _bf16_to_f32(raw: bytes) -> np.ndarray:
    u16 = np.frombuffer(raw, np.uint16)
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _ndarray(payload: bytes) -> np.ndarray:
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


class _Packer:
    """msgpack encoder for what ``flax.serialization.to_bytes`` writes,
    byte for byte as the ``msgpack`` package packs it: the smallest
    header for each map, array, str, bin and int; floats as doubles;
    ndarrays as ext type 1 holding msgpack ``(shape, dtype name, raw C
    bytes)``."""

    def __init__(self):
        self.out = []

    def _head(self, n: int, fix: int, fix_max: int, codes, widths=(2, 4)) -> None:
        if n <= fix_max:
            self.out.append(bytes([fix | n]))
            return
        for code, width in zip(codes, widths):
            if n < 1 << (8 * width):
                self.out.append(bytes([code]) + n.to_bytes(width, "big"))
                return
        raise ValueError(f"msgpack object too large ({n})")

    def _int(self, v: int) -> None:
        if 0 <= v < 128:
            self.out.append(bytes([v]))
        elif -32 <= v < 0:
            self.out.append(bytes([v + 0x100]))
        elif v >= 0:
            for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
                if v < 1 << (8 * width):
                    self.out.append(bytes([code]) + v.to_bytes(width, "big"))
                    return
            raise ValueError(f"msgpack int too large ({v})")
        else:
            for code, width in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
                if v >= -(1 << (8 * width - 1)):
                    self.out.append(bytes([code]) + v.to_bytes(width, "big", signed=True))
                    return
            raise ValueError(f"msgpack int too small ({v})")

    def _sized(self, data: bytes, codes) -> None:
        n = len(data)
        for code, width in zip(codes, (1, 2, 4)):
            if n < 1 << (8 * width):
                self.out.append(bytes([code]) + n.to_bytes(width, "big"))
                self.out.append(data)
                return
        raise ValueError(f"msgpack object too large ({n})")

    def _ext(self, code: int, payload: bytes) -> None:
        n = len(payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.out.append(bytes([fixed[n], code]))
        else:
            for head, width in ((0xC7, 1), (0xC8, 2), (0xC9, 4)):
                if n < 1 << (8 * width):
                    self.out.append(bytes([head]) + n.to_bytes(width, "big") + bytes([code]))
                    break
        self.out.append(payload)

    def pack(self, x) -> None:
        if x is None:
            self.out.append(b"\xc0")
        elif isinstance(x, bool):
            self.out.append(b"\xc3" if x else b"\xc2")
        elif isinstance(x, int):
            self._int(x)
        elif isinstance(x, float):
            self.out.append(b"\xcb" + struct.pack(">d", x))
        elif isinstance(x, str):
            data = x.encode()
            if len(data) < 32:
                self.out.append(bytes([0xA0 | len(data)]) + data)
            else:
                self._sized(data, (0xD9, 0xDA, 0xDB))
        elif isinstance(x, (bytes, bytearray, memoryview)):
            self._sized(bytes(x), (0xC4, 0xC5, 0xC6))
        elif isinstance(x, dict):
            self._head(len(x), 0x80, 15, (0xDE, 0xDF))
            for k, v in x.items():
                self.pack(k)
                self.pack(v)
        elif isinstance(x, (list, tuple)):
            self._head(len(x), 0x90, 15, (0xDC, 0xDD))
            for v in x:
                self.pack(v)
        elif isinstance(x, np.ndarray):
            if x.dtype.hasobject or x.dtype.isalignedstruct:
                raise ValueError(f"cannot serialize arrays of {x.dtype}")
            inner = _Packer()
            inner.pack(([int(d) for d in x.shape], x.dtype.name, x.tobytes("C")))
            self._ext(_EXT_NDARRAY, inner.getvalue())
        else:
            raise TypeError(f"cannot msgpack-serialize {type(x).__name__}")

    def getvalue(self) -> bytes:
        return b"".join(self.out)


def msgpack_serialize(tree: Any) -> bytes:
    """Encode nested dicts of numpy arrays as ``flax.serialization.
    to_bytes`` does, so ``from_bytes`` and :func:`msgpack_restore` both
    read the result."""
    p = _Packer()
    p.pack(tree)
    return p.getvalue()


def read_msgpack(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten(flat: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


# ---------------------------------------------------------- random init --


class ShapeDtype(NamedTuple):
    """A leaf of a shape tree (what ``jax.eval_shape`` gives per leaf)."""

    shape: Tuple[int, ...]
    dtype: np.dtype


def materialize(shape_tree: Dict[str, Any], seed: int) -> Dict[str, Any]:
    """Variable arrays for a shape tree ``{collection: nested dicts of
    leaves with .shape and .dtype}``: LeCun-normal kernels, zero biases
    and means, unit scales and variances.  Deterministic per parameter
    path (``zlib.crc32`` of ``collection/…/name``), so the same weights
    come back in every process and in either package: this is the JAX
    engine's ``_materialize`` (``engine.py:54-85``) line for line.  The
    draw is made in the Flax layout (HWIO, Dense ``(in, out)``)."""
    out = {}
    for col, tree in shape_tree.items():
        new = {}
        for path, leaf in flatten(tree).items():
            name = path[-1]
            shape = tuple(leaf.shape)
            dtype = np.dtype(leaf.dtype)
            digest = zlib.crc32("/".join((col,) + path).encode())
            rng = np.random.default_rng((seed * 1_000_003 + digest) % (2**63))
            if name in ("var", "scale"):
                arr = np.ones(shape, dtype)
            elif name in ("mean", "bias"):
                arr = np.zeros(shape, dtype)
            elif len(shape) >= 2:
                fan_in = int(np.prod(shape[:-1]))
                arr = (rng.standard_normal(shape) / np.sqrt(max(fan_in, 1))).astype(dtype)
            else:
                arr = np.zeros(shape, dtype)
            new[path] = arr
        out[col] = unflatten(new)
    return out


def _flax_layout(module: torch.nn.Module, unit_bn_scale: bool = False):
    """``(collection, Flax path, tensor)`` for every tensor of ``module``
    in the Flax layout, as views (no copy): a conv's OIHW weight is an
    HWIO ``kernel``, a Linear's ``(out, in)`` a Dense ``(in, out)``
    kernel, a BatchNorm's weight and bias are ``params`` ``scale`` (none
    where it has no scale, as FaceNet's, or with ``unit_bn_scale``) and
    ``bias`` and its running statistics ``batch_stats`` ``mean`` and
    ``var``.  A module holding tensors of any other kind raises."""
    for name, mod in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        own = dict(mod.named_parameters(recurse=False))
        own.update(mod.named_buffers(recurse=False))
        if isinstance(mod, torch.nn.Conv2d):
            yield "params", path + ("kernel",), mod.weight.permute(2, 3, 1, 0)
        elif isinstance(mod, torch.nn.Linear):
            yield "params", path + ("kernel",), mod.weight.t()
        elif isinstance(mod, BatchNorm):
            if mod.use_scale and not unit_bn_scale:
                yield "params", path + ("scale",), mod.weight
            yield "params", path + ("bias",), mod.bias
            yield "batch_stats", path + ("mean",), mod.running_mean
            yield "batch_stats", path + ("var",), mod.running_var
            continue
        elif own:
            raise ValueError(f"no Flax counterpart for {type(mod).__name__} {name}")
        if own.get("bias") is not None:
            yield "params", path + ("bias",), own["bias"]


def _by_collection(flat: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    tree = unflatten(flat)
    return {col: tree[col] for col in ("params", "batch_stats") if col in tree}


def flax_shapes(module: torch.nn.Module, unit_bn_scale: bool = False) -> Dict[str, Any]:
    """The Flax variable tree of ``module`` as shapes (the layout of
    :func:`to_flax`).  Every leaf is float32, the Flax models'
    parameter dtype."""
    f32 = np.dtype(np.float32)
    return _by_collection({(col,) + path: ShapeDtype(tuple(int(d) for d in t.shape), f32)
                           for col, path, t in _flax_layout(module, unit_bn_scale)})


def to_flax(module: torch.nn.Module) -> Dict[str, Any]:
    """``module``'s variables as the Flax tree ``{"params",
    "batch_stats"}`` of float32 numpy arrays, the inverse of the
    converters below: what the JAX trainers write, so that
    :func:`msgpack_serialize` of it loads in either package."""
    return _by_collection({
        (col,) + path: np.ascontiguousarray(t.detach().float().cpu().numpy())
        for col, path, t in _flax_layout(module)})


def _has_unit_bn_scale(module: torch.nn.Module) -> bool:
    return any(isinstance(m, BatchNorm) and not m.use_scale for m in module.modules())


def load_flax(module: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """Load a Flax variable tree into ``module`` (strictly)."""
    load_into(module, _convert(tree, _has_unit_bn_scale(module)))


def params_list(module: torch.nn.Module, params_tree: Dict[str, Any]):
    """A tree shaped as ``module``'s Flax ``params`` (a gradient, an
    Adam moment) as tensors in the order of ``module.parameters()``, in
    the torch layout, on the module's device."""
    sd = _convert({"params": params_tree}, unit_bn_scale=False)
    names = [n for n, _ in module.named_parameters()]
    if sorted(sd) != sorted(names):
        raise ValueError("params tree does not match the module: "
                         f"{sorted(set(sd) ^ set(names))[:5]}")
    return [sd[n].to(p.device) for n, p in zip(names, module.parameters())]


def carry_state(module: torch.nn.Module, variables: Dict[str, Any], opt_state: Any = None,
                mesh=None):
    """Carry a JAX train state, as numpy trees, across to the port: load
    ``variables`` (``{"params"[, "batch_stats"]}``) into ``module`` and
    return ``opt_state`` (optax's state, e.g. ``jax.tree.map(np.asarray,
    state.opt_state)``) as :mod:`fire_tpu_torch.train.optim`'s.  Each
    optax NamedTuple becomes the port's of the same name; its ``mu`` and
    ``nu`` trees, shaped as the optimizer's target (the params tree, or
    ``(params, classifier, …)``), become the port's tensor lists
    (:func:`params_list`, then the extra arrays); counts become ints.

    With a ``mesh`` (of the sharded ArcFace step) the extra arrays, the
    classifier's moments as global arrays, are split over ``mp`` into
    column blocks on their devices, as ``shard_state`` splits the
    classifier."""
    from fire_tpu_torch.parallel.mesh import column_devices, split_columns
    from fire_tpu_torch.train import optim

    dev = next(module.parameters()).device
    load_flax(module, variables)

    def extra(a):
        t = torch.tensor(np.array(a, np.float32), device=dev)
        return [t] if mesh is None or mesh.devices.size == 1 else split_columns(
            t, column_devices(mesh))

    def target_list(tree):
        if isinstance(tree, dict):
            return params_list(module, tree)
        head, *rest = tree
        return params_list(module, head) + [b for a in rest for b in extra(a)]

    def carry(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            fields = {f: (target_list(v) if f in ("mu", "nu") else
                          int(v) if f == "count" else carry(v))
                      for f, v in zip(x._fields, x)}
            return getattr(optim, type(x).__name__)(**fields)
        if isinstance(x, tuple):
            return tuple(carry(v) for v in x)
        raise TypeError(f"carry_state: unexpected optimizer state leaf {type(x).__name__}")

    return None if opt_state is None else carry(opt_state)


# ------------------------------------------------------- flax → state_dict --

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
                raise ValueError(f"{key}: FaceNet BatchNorm has no scale")
            sd[key] = torch.ones_like(sd[".".join(mod + ("running_mean",))])
    return sd


def from_flax_yunet(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """YuNet variables (``{"params", "batch_stats"}``) → state_dict of
    :class:`fire_tpu_torch.models.yunet.YuNet`."""
    return _convert(tree, unit_bn_scale=False)


def from_flax_blazeface(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """BlazeFace variables (``{"params"}`` only: biased convs, BatchNorm
    folded) → state_dict of
    :class:`fire_tpu_torch.models.blazeface.BlazeFace`.  A depthwise
    ``(5,5,1,C)`` kernel becomes ``(C,1,5,5)``."""
    return _convert(tree, unit_bn_scale=False)


def from_flax_retinaface(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """RetinaFace variables (``{"params", "batch_stats"}``) → state_dict
    of :class:`fire_tpu_torch.models.retinaface.RetinaFace`."""
    return _convert(tree, unit_bn_scale=False)


def from_flax_facenet(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """FaceNet variables → state_dict of
    :class:`fire_tpu_torch.models.facenet.FaceNet` (BN weight = 1)."""
    return _convert(tree, unit_bn_scale=True)


def load_into(module: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Strict load: a missing, surplus or mis-shaped tensor raises."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise ValueError(f"weight mismatch: missing {missing[:5]}, unused {extra[:5]}")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != model {tuple(own[k].shape)}")
    module.load_state_dict(sd, strict=True)
