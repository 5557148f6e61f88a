"""ONNX graph → PyTorch function (counterpart of
``fire_tpu.models.onnx_exec``): runs a parsed
:class:`~fire_tpu_torch.models.onnx_import.OnnxGraph` op by op, so a
reference weight file whose topology the hand-written modules cannot
take still runs, exactly as its graph says.

* Tensors keep ONNX's NCHW layout; convolutions are ``F.conv*d`` with
  explicit (possibly asymmetric) padding.
* Shape plumbing (Shape / Gather / Slice / Concat / … on small integer
  tensors) folds in numpy on host constants (``_FOLDABLE``), and the
  operands that steer shapes (``_SHAPE_SLOTS``) stay on the host, so
  Reshape and Resize always see static shapes.
* Inference semantics: BatchNormalization uses its running statistics,
  Dropout is the identity.
* Each op computes what the JAX executor computes, including where that
  differs from another runtime: Resize's linear and cubic modes are
  ``jax.image.resize`` (half-pixel centres, antialiased when shrinking,
  Keys' cubic with a = −0.5, where ``F.interpolate`` uses −0.75), and
  ConvTranspose is ``lax.conv_transpose`` with the node's pads taken as
  the padding of the stride-dilated input.
* float32 throughout.  On the card, TF32 convolutions and matmuls
  (``torch.backends.cudnn.allow_tf32``) round operands to 10 bits: turn
  them off where the graph's float32 result is compared.

:class:`OnnxModel` holds a graph's weights as module buffers and is the
``nn.Module`` the engine puts in a model's slot.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fire_tpu_torch.device import DeviceLike, resolve_device
from fire_tpu_torch.models.onnx_import import _ONNX_DTYPES, OnnxGraph, OnnxNode, read_onnx

# Ops that run eagerly in numpy when all inputs are host constants: the
# shape-plumbing subset exporters emit around Reshape / Resize.
_FOLDABLE = {
    "Shape", "Gather", "Slice", "Concat", "Unsqueeze", "Squeeze", "Cast",
    "Add", "Sub", "Mul", "Div", "Constant", "ConstantOfShape", "Range",
    "ReduceProd", "Identity", "Floor", "Ceil", "Transpose", "Reshape",
    "Expand", "Equal", "Where",
}


def _ints(v) -> List[int]:
    return [int(x) for x in np.asarray(v).reshape(-1)]


def _auto_pads(auto_pad: str, in_hw, k_hw, strides, dilations) -> List[Tuple[int, int]]:
    """Resolve SAME_UPPER / SAME_LOWER / VALID into explicit (lo, hi) pads."""
    out = []
    for i in range(len(k_hw)):
        eff_k = (k_hw[i] - 1) * dilations[i] + 1
        if auto_pad == "VALID":
            out.append((0, 0))
            continue
        out_dim = -(-in_hw[i] // strides[i])  # ceil
        pad = max(0, (out_dim - 1) * strides[i] + eff_k - in_hw[i])
        if auto_pad == "SAME_LOWER":
            out.append((pad - pad // 2, pad // 2))
        else:
            out.append((pad // 2, pad - pad // 2))
    return out


def _node_pads(node: OnnxNode, in_hw, k_hw) -> List[Tuple[int, int]]:
    strides = node.attrs.get("strides", [1] * len(k_hw))
    dilations = node.attrs.get("dilations", [1] * len(k_hw))
    auto_pad = node.attrs.get("auto_pad", "NOTSET") or "NOTSET"
    if auto_pad not in ("NOTSET", ""):
        return _auto_pads(auto_pad, in_hw, k_hw, strides, dilations)
    pads = node.attrs.get("pads", [0] * (2 * len(k_hw)))
    n = len(pads) // 2
    return [(pads[i], pads[i + n]) for i in range(n)]


def _pad_spatial(x: torch.Tensor, pads: Sequence[Tuple[int, int]], value: float = 0.0):
    """Pad the trailing spatial axes by (lo, hi) each, first axis first."""
    flat = [p for lo_hi in reversed(list(pads)) for p in lo_hi]
    return F.pad(x, flat, value=value) if any(flat) else x


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def _tensor(a, device) -> torch.Tensor:
    """A host constant as a tensor: float64 becomes float32 and Python
    scalars become 0-d tensors, as JAX (64-bit off) takes them."""
    if isinstance(a, torch.Tensor):
        return a
    arr = np.asarray(a)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _conv_nd(ndim: int):
    return {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}[ndim]


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = −0.5 (``jax.image``'s)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _resize_weights(in_size: int, out_size: int, kernel, device) -> torch.Tensor:
    """(in, out) float32 resampling matrix of ``jax.image.resize`` along
    one axis: half-pixel sample centres, the kernel widened by the
    shrink factor (antialiasing), columns normalised, samples outside
    the input zeroed."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]
         ).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _slice(x, starts, ends, axes, steps):
    """numpy slicing semantics on a tensor or an array, negative steps
    included; exporters encode "to the end" as INT32/INT64_MAX (or MIN
    when stepping backwards), mapped to an open slice."""
    if isinstance(x, np.ndarray):
        sl = [slice(None)] * x.ndim
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            open_end = en >= 2**31 - 1 or (sp < 0 and en <= -(2**31) + 1)
            sl[ax] = slice(st, None if open_end else en, sp)
        return x[tuple(sl)]
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        open_end = en >= 2**31 - 1 or (sp < 0 and en <= -(2**31) + 1)
        idx = range(*slice(st, None if open_end else en, sp).indices(x.shape[ax]))
        if sp > 0:
            x = x.narrow(ax, idx.start, len(idx)) if sp == 1 else x[
                (slice(None),) * (ax % x.ndim) + (slice(idx.start, idx.stop, sp),)]
        else:
            x = x.index_select(ax, torch.arange(idx.start, idx.stop, idx.step, dtype=torch.long,
                                                device=x.device))
    return x


class OnnxExecutor:
    """Interpreter over an :class:`OnnxGraph`; ``ex(params, *inputs)``
    returns the graph's outputs, ``params`` mapping initializer names to
    tensors (:attr:`params` holds them as numpy)."""

    # operands that steer shapes and control stay host constants:
    # op_type → 0-based operand indices
    _SHAPE_SLOTS = {
        "Reshape": (1,), "Resize": (1, 2, 3), "Upsample": (1,),
        "Slice": (1, 2, 3, 4), "Pad": (1, 2, 3), "Expand": (1,),
        "ConstantOfShape": (0,), "Split": (1,), "Squeeze": (1,),
        "Unsqueeze": (1,), "Tile": (1,), "Range": (0, 1, 2),
        "Clip": (1, 2), "ReduceMean": (1,), "ReduceSum": (1,),
        "ReduceMax": (1,),
    }

    def __init__(self, graph: OnnxGraph, dtype: torch.dtype = torch.float32):
        self.graph = graph
        self.dtype = dtype
        shape_args = set()
        for node in graph.nodes:
            for idx in self._SHAPE_SLOTS.get(node.op_type, ()):
                if idx < len(node.inputs):
                    shape_args.add(node.inputs[idx])
        self.params: Dict[str, np.ndarray] = {}
        self.consts: Dict[str, np.ndarray] = {}
        for name, arr in graph.initializers.items():
            if name in shape_args or (
                    arr.dtype in (np.int64, np.int32, np.bool_) and arr.size <= 64):
                self.consts[name] = arr
            else:
                self.params[name] = arr
        self._on_device: Dict[tuple, torch.Tensor] = {}

    def _const(self, a, device) -> torch.Tensor:
        """A host constant that meets a tensor, on ``device``, made once
        per value: JAX folds such values into the compiled program, and a
        captured CUDA graph cannot copy from host memory."""
        if isinstance(a, torch.Tensor):
            return a
        arr = np.asarray(a)
        key = (arr.dtype.str, arr.shape, arr.tobytes(), torch.device(device))
        out = self._on_device.get(key)
        if out is None:
            out = self._on_device[key] = _tensor(arr, device)
        return out

    # -- dispatch ----------------------------------------------------------

    def __call__(self, params: Dict[str, Any], *inputs) -> List[Any]:
        g = self.graph
        if len(inputs) != len(g.inputs):
            raise ValueError(f"expected {len(g.inputs)} inputs {g.inputs}, got {len(inputs)}")
        env: Dict[str, Any] = dict(self.consts)
        env.update(params)
        for name, x in zip(g.inputs, inputs):
            env[name] = x
        self._device = next((x.device for x in inputs if isinstance(x, torch.Tensor)),
                            torch.device("cpu"))
        for node in g.nodes:
            args = [env[i] if i else None for i in node.inputs]
            if (node.op_type in _FOLDABLE
                    and all(a is None or isinstance(a, (np.ndarray, np.generic)) for a in args)):
                outs = self._fold(node, args)
                if not isinstance(outs, (tuple, list)):
                    outs = (outs,)
                outs = tuple(np.asarray(o) for o in outs)  # scalars → 0-d arrays
            else:
                outs = self._op(node, args)
                if not isinstance(outs, (tuple, list)):
                    outs = (outs,)
            for oname, oval in zip(node.outputs, outs):
                if oname:
                    env[oname] = oval
        return [env[o] for o in g.outputs]

    # -- host constant folding ---------------------------------------------

    def _fold(self, node: OnnxNode, args) -> Any:
        op = node.op_type
        a = node.attrs
        if op == "Constant":
            for key in ("value", "value_int", "value_float", "value_ints", "value_floats"):
                if key in a:
                    return np.asarray(a[key])
            raise ValueError("Constant node without value")
        if op == "Shape":
            return np.asarray(args[0].shape, np.int64)
        if op == "Gather":
            return np.take(args[0], args[1], axis=int(a.get("axis", 0)))
        if op == "Slice":
            return np.asarray(self._slice_args(node, args))
        if op == "Concat":
            return np.concatenate([np.atleast_1d(x) for x in args], axis=int(a.get("axis", 0)))
        if op == "Unsqueeze":
            axes = _ints(a.get("axes", args[1] if len(args) > 1 else [0]))
            out = args[0]
            for ax in sorted(axes):
                out = np.expand_dims(out, ax)
            return out
        if op == "Squeeze":
            axes = a.get("axes", args[1] if len(args) > 1 else None)
            return np.squeeze(args[0], axis=tuple(_ints(axes)) if axes is not None else None)
        if op == "Cast":
            return args[0].astype(_ONNX_DTYPES.get(int(a.get("to", 1)), np.float32))
        if op in ("Add", "Sub", "Mul", "Div"):
            x, y = args
            return {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
                    "Div": lambda p, q: p // q if p.dtype.kind in "iu" else p / q}[op](x, y)
        if op == "ConstantOfShape":
            value = a.get("value", np.zeros(1, np.float32))
            return np.full(_ints(args[0]), np.asarray(value).reshape(-1)[0])
        if op == "Range":
            return np.arange(args[0].item(), args[1].item(), args[2].item())
        if op == "ReduceProd":
            return np.prod(args[0], axis=tuple(_ints(a.get("axes", []))) or None,
                           keepdims=bool(a.get("keepdims", 1)))
        if op == "Identity":
            return args[0]
        if op == "Floor":
            return np.floor(args[0])
        if op == "Ceil":
            return np.ceil(args[0])
        if op == "Transpose":
            return np.transpose(args[0], a.get("perm"))
        if op == "Reshape":
            return np.reshape(args[0], self._reshape_dims(args[0], args[1]))
        if op == "Expand":
            return np.broadcast_to(args[0], _ints(args[1])).copy()
        if op == "Equal":
            return np.equal(args[0], args[1])
        if op == "Where":
            return np.where(args[0], args[1], args[2])
        raise NotImplementedError(op)  # pragma: no cover

    @staticmethod
    def _reshape_dims(x, shape_arr) -> List[int]:
        dims = _ints(shape_arr)
        out = [x.shape[i] if d == 0 else d for i, d in enumerate(dims)]
        if -1 in out:
            known = int(np.prod([d for d in out if d != -1]))
            out[out.index(-1)] = int(np.prod(x.shape)) // known
        return out

    @staticmethod
    def _slice_args(node: OnnxNode, args):
        x = args[0]
        a = node.attrs
        if len(args) > 1 and args[1] is not None:
            starts, ends = _ints(args[1]), _ints(args[2])
            axes = (_ints(args[3]) if len(args) > 3 and args[3] is not None
                    else list(range(len(starts))))
            steps = (_ints(args[4]) if len(args) > 4 and args[4] is not None
                     else [1] * len(starts))
        else:
            starts, ends = _ints(a["starts"]), _ints(a["ends"])
            axes = _ints(a.get("axes", list(range(len(starts)))))
            steps = [1] * len(starts)
        return _slice(x, starts, ends, axes, steps)

    # -- ops on tensors ----------------------------------------------------

    def _op(self, node: OnnxNode, args) -> Any:
        op = node.op_type
        handler = getattr(self, f"_op_{op.lower()}", None)
        if handler is None:
            raise NotImplementedError(
                f"ONNX op {op!r} (node {node.name!r}) not implemented in the fire_tpu_torch "
                "executor")
        host = self._SHAPE_SLOTS.get(op, ())
        args = [a if a is None or i in host or isinstance(a, torch.Tensor)
                else self._const(a, self._device) for i, a in enumerate(args)]
        return handler(node, args)

    # elementwise / activation
    def _op_relu(self, node, args):
        return torch.relu(args[0])

    def _op_leakyrelu(self, node, args):
        return F.leaky_relu(args[0], node.attrs.get("alpha", 0.01))

    def _op_prelu(self, node, args):
        x, slope = args
        if 0 < slope.ndim < x.ndim:
            # ONNX broadcasts the slope over the channel axis (1, NCHW)
            shape = [1] * x.ndim
            shape[1] = slope.numel()
            slope = slope.reshape(shape)
        return torch.where(x >= 0, x, slope * x)

    def _op_sigmoid(self, node, args):
        return torch.sigmoid(args[0])

    def _op_tanh(self, node, args):
        return torch.tanh(args[0])

    def _op_softmax(self, node, args):
        return torch.softmax(args[0], dim=int(node.attrs.get("axis", -1)))

    def _op_exp(self, node, args):
        return torch.exp(args[0])

    def _op_log(self, node, args):
        return torch.log(args[0])

    def _op_sqrt(self, node, args):
        return torch.sqrt(args[0])

    def _op_neg(self, node, args):
        return -args[0]

    def _op_abs(self, node, args):
        return torch.abs(args[0])

    def _op_erf(self, node, args):
        return torch.erf(args[0])

    def _op_clip(self, node, args):
        lo = node.attrs.get("min")
        hi = node.attrs.get("max")
        if len(args) > 1 and args[1] is not None:
            lo = args[1]
        if len(args) > 2 and args[2] is not None:
            hi = args[2]
        x = args[0]
        if lo is not None:
            x = torch.maximum(x, self._const(lo, x.device).to(x.dtype))
        if hi is not None:
            x = torch.minimum(x, self._const(hi, x.device).to(x.dtype))
        return x

    def _op_hardswish(self, node, args):
        return F.hardswish(args[0])

    def _op_hardsigmoid(self, node, args):
        alpha = node.attrs.get("alpha", 0.2)
        beta = node.attrs.get("beta", 0.5)
        return torch.clamp(alpha * args[0] + beta, 0.0, 1.0)

    def _op_elu(self, node, args):
        return F.elu(args[0], node.attrs.get("alpha", 1.0))

    def _op_add(self, node, args):
        return args[0] + args[1]

    def _op_sub(self, node, args):
        return args[0] - args[1]

    def _op_mul(self, node, args):
        return args[0] * args[1]

    def _op_div(self, node, args):
        return args[0] / args[1]

    def _op_pow(self, node, args):
        return args[0] ** args[1]

    def _op_min(self, node, args):
        out = args[0]
        for a in args[1:]:
            out = torch.minimum(out, a)
        return out

    def _op_max(self, node, args):
        out = args[0]
        for a in args[1:]:
            out = torch.maximum(out, a)
        return out

    def _op_identity(self, node, args):
        return args[0]

    def _op_dropout(self, node, args):
        return args[0]

    def _op_cast(self, node, args):
        np_dt = _ONNX_DTYPES.get(int(node.attrs.get("to", 1)), np.float32)
        return args[0].to(_torch_dtype(np_dt))

    # structure
    def _op_concat(self, node, args):
        return torch.cat(args, dim=int(node.attrs.get("axis", 0)))

    def _op_reshape(self, node, args):
        if not isinstance(args[1], np.ndarray):
            raise ValueError("Reshape with a computed (non-constant) shape is unsupported")
        return args[0].reshape(self._reshape_dims(args[0], args[1]))

    def _op_flatten(self, node, args):
        ax = int(node.attrs.get("axis", 1))
        shape = args[0].shape
        lead = int(np.prod(shape[:ax])) if ax else 1
        return args[0].reshape(lead, -1)

    def _op_transpose(self, node, args):
        perm = node.attrs.get("perm")
        x = args[0]
        return x.permute(*(perm if perm is not None else range(x.ndim - 1, -1, -1)))

    def _op_squeeze(self, node, args):
        axes = node.attrs.get("axes", args[1] if len(args) > 1 else None)
        if axes is None:
            return args[0].squeeze()
        return args[0].squeeze(tuple(_ints(axes)))

    def _op_unsqueeze(self, node, args):
        axes = _ints(node.attrs.get("axes", args[1] if len(args) > 1 else [0]))
        out = args[0]
        for ax in sorted(axes):
            out = out.unsqueeze(ax)
        return out

    def _op_slice(self, node, args):
        return self._slice_args(node, [args[0]] + [np.asarray(a) if a is not None else None
                                                   for a in args[1:]])

    def _op_gather(self, node, args):
        x, idx = args[0], args[1].long()
        axis = int(node.attrs.get("axis", 0)) % x.ndim
        idx = torch.where(idx < 0, idx + x.shape[axis], idx)
        out = x.index_select(axis, idx.reshape(-1))
        return out.reshape(*x.shape[:axis], *idx.shape, *x.shape[axis + 1:])

    def _op_expand(self, node, args):
        # numpy broadcasting against max(shape, target), as ONNX Expand
        shape = torch.broadcast_shapes(tuple(args[0].shape), tuple(_ints(args[1])))
        return args[0].expand(shape)

    def _op_shape(self, node, args):
        return np.asarray(args[0].shape, np.int64)

    def _op_split(self, node, args):
        axis = int(node.attrs.get("axis", 0))
        if "split" in node.attrs:
            sizes = _ints(node.attrs["split"])
        elif len(args) > 1 and args[1] is not None:
            sizes = _ints(args[1])
        else:
            n = len(node.outputs)
            sizes = [args[0].shape[axis] // n] * n
        return tuple(torch.split(args[0], sizes, dim=axis))

    def _op_pad(self, node, args):
        pads = _ints(node.attrs.get("pads", args[1] if len(args) > 1 else []))
        value = node.attrs.get("value", 0.0)
        if len(args) > 2 and args[2] is not None:
            value = float(np.asarray(args[2]).reshape(-1)[0])
        mode = node.attrs.get("mode", "constant")
        if isinstance(mode, bytes):
            mode = mode.decode()
        n = len(pads) // 2
        pairs = [(pads[i], pads[i + n]) for i in range(n)]
        x = args[0]
        if mode == "constant":
            return F.pad(x, [p for pair in reversed(pairs) for p in pair], value=float(value))
        lead = sum(1 for p in pairs[: x.ndim - 2] if p != (0, 0))
        if lead:
            raise NotImplementedError(f"Pad mode {mode!r} outside the spatial axes")
        spatial = pairs[2:]
        return F.pad(x, [p for pair in reversed(spatial) for p in pair],
                     mode="replicate" if mode == "edge" else "reflect")

    # linear algebra
    def _op_matmul(self, node, args):
        return torch.matmul(args[0].to(self.dtype), args[1].to(self.dtype))

    def _op_gemm(self, node, args):
        a, b = args[0], args[1]
        a = a.T if node.attrs.get("transA", 0) else a
        b = b.T if node.attrs.get("transB", 0) else b
        out = node.attrs.get("alpha", 1.0) * torch.matmul(a.to(self.dtype), b.to(self.dtype))
        if len(args) > 2 and args[2] is not None:
            out = out + node.attrs.get("beta", 1.0) * args[2]
        return out

    # conv / pool / norm
    def _op_conv(self, node, args):
        x, w = args[0], args[1]
        k_hw = list(w.shape[2:])
        strides = node.attrs.get("strides", [1] * len(k_hw))
        dilations = node.attrs.get("dilations", [1] * len(k_hw))
        group = int(node.attrs.get("group", 1))
        pads = _node_pads(node, x.shape[2:], k_hw)
        bias = None
        if len(args) > 2 and args[2] is not None:
            bias = args[2].to(self.dtype)
        return _conv_nd(x.ndim)(_pad_spatial(x.to(self.dtype), pads), w.to(self.dtype), bias,
                                stride=strides, dilation=dilations, groups=group)

    def _op_convtranspose(self, node, args):
        """``lax.conv_transpose(..., transpose_kernel=True)`` on an IOHW
        kernel, as the JAX executor calls it: the input dilated by the
        strides, padded by the node's pads, correlated with the spatially
        flipped kernel read as OIHW (so it needs as many output as input
        channels, as it does in JAX)."""
        x, w = args[0], args[1]
        k_hw = list(w.shape[2:])
        strides = node.attrs.get("strides", [1] * len(k_hw))
        pads = _node_pads(node, x.shape[2:], k_hw)
        if int(node.attrs.get("group", 1)) != 1:
            raise NotImplementedError("grouped ConvTranspose")
        x = x.to(self.dtype)
        if any(s > 1 for s in strides):
            n, c, *sp = x.shape
            dil = x.new_zeros((n, c, *[(d - 1) * s + 1 for d, s in zip(sp, strides)]))
            dil[(slice(None), slice(None)) + tuple(slice(None, None, s) for s in strides)] = x
            x = dil
        out = _conv_nd(x.ndim)(_pad_spatial(x, pads), w.to(self.dtype).flip(
            tuple(range(2, w.ndim))))
        if len(args) > 2 and args[2] is not None:
            out = out + args[2].to(self.dtype).reshape((1, -1) + (1,) * (out.ndim - 2))
        return out

    def _op_batchnormalization(self, node, args):
        x, scale, bias, mean, var = args[:5]
        eps = node.attrs.get("epsilon", 1e-5)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(var.float() + eps)
        out = ((x.float() - mean.reshape(shape)) * (scale * inv).reshape(shape)
               + bias.reshape(shape))
        return out.to(self.dtype)

    def _op_instancenormalization(self, node, args):
        x, scale, bias = args
        eps = node.attrs.get("epsilon", 1e-5)
        axes = tuple(range(2, x.ndim))
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, keepdim=True, unbiased=False)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (x - mean) * torch.rsqrt(var + eps) * scale.reshape(shape) + bias.reshape(shape)

    def _pool_pads(self, node, x, k_hw, strides):
        pads = _node_pads(node, x.shape[2:], k_hw)
        if node.attrs.get("ceil_mode", 0):
            # extend the end pad so the last partial window is included
            new_pads = []
            for i, (lo, hi) in enumerate(pads):
                size = x.shape[2 + i] + lo + hi
                rem = (size - k_hw[i]) % strides[i]
                new_pads.append((lo, hi + (strides[i] - rem) % strides[i] if rem else hi))
            pads = new_pads
        return pads

    def _op_maxpool(self, node, args):
        x = args[0]
        k_hw = _ints(node.attrs["kernel_shape"])
        strides = node.attrs.get("strides", [1] * len(k_hw))
        pads = self._pool_pads(node, x, k_hw, strides)
        pool = {3: F.max_pool1d, 4: F.max_pool2d, 5: F.max_pool3d}[x.ndim]
        return pool(_pad_spatial(x, pads, value=-math.inf), k_hw, strides)

    def _op_averagepool(self, node, args):
        """Window sums over the zero-padded input, divided by the count of
        real elements (or the window's size with ``count_include_pad``)."""
        x = args[0]
        k_hw = _ints(node.attrs["kernel_shape"])
        strides = node.attrs.get("strides", [1] * len(k_hw))
        pads = self._pool_pads(node, x, k_hw, strides)
        pool = {3: F.avg_pool1d, 4: F.avg_pool2d, 5: F.avg_pool3d}[x.ndim]
        size = float(np.prod(k_hw))
        sums = pool(_pad_spatial(x, pads), k_hw, strides) * size
        if node.attrs.get("count_include_pad", 0):
            return sums / size
        ones = x.new_ones((1, 1, *x.shape[2:]))
        counts = pool(_pad_spatial(ones, pads), k_hw, strides) * size
        return sums / counts

    def _op_globalaveragepool(self, node, args):
        x = args[0]
        return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)

    def _op_globalmaxpool(self, node, args):
        x = args[0]
        return x.amax(dim=tuple(range(2, x.ndim)), keepdim=True)

    @staticmethod
    def _reduce_axes(node, args):
        axes = node.attrs.get("axes", args[1] if len(args) > 1 else None)
        return (tuple(_ints(axes)) if axes is not None else tuple(range(args[0].ndim)),
                bool(node.attrs.get("keepdims", 1)))

    def _op_reducemean(self, node, args):
        axes, keep = self._reduce_axes(node, args)
        return args[0].mean(dim=axes, keepdim=keep)

    def _op_reducesum(self, node, args):
        axes, keep = self._reduce_axes(node, args)
        return args[0].sum(dim=axes, keepdim=keep)

    def _op_reducemax(self, node, args):
        axes, keep = self._reduce_axes(node, args)
        return args[0].amax(dim=axes, keepdim=keep)

    def _op_lrn(self, node, args):
        x = args[0]
        size = int(node.attrs.get("size", 5))
        alpha = node.attrs.get("alpha", 1e-4)
        beta = node.attrs.get("beta", 0.75)
        bias = node.attrs.get("bias", 1.0)
        half = size // 2
        sq = F.pad(torch.square(x).movedim(1, -1), (half, size - 1 - half)).movedim(-1, 1)
        s = sum(sq.narrow(1, i, x.shape[1]) for i in range(size))
        return x / torch.pow(bias + alpha / size * s, beta)

    # resize / upsample
    def _op_resize(self, node, args):
        x = args[0]
        mode = node.attrs.get("mode", "nearest")
        if isinstance(mode, bytes):
            mode = mode.decode()
        # opset 11+: inputs X, roi, scales, sizes
        sizes = scales = None
        if len(args) >= 4 and args[3] is not None and np.asarray(args[3]).size:
            sizes = _ints(args[3])
        elif len(args) >= 3 and args[2] is not None and np.asarray(args[2]).size:
            scales = np.asarray(args[2], np.float64).reshape(-1)
        elif len(args) == 2 and args[1] is not None:  # opset-9 Upsample form
            scales = np.asarray(args[1], np.float64).reshape(-1)
        elif "scales" in node.attrs:
            scales = np.asarray(node.attrs["scales"], np.float64)
        if sizes is None:
            sizes = [int(round(s * d)) for s, d in zip(scales, x.shape)]
        if mode == "nearest":
            # integer upsampling repeats exactly (asymmetric + floor)
            out = x
            for ax, (src, dst) in enumerate(zip(x.shape, sizes)):
                if dst == src:
                    continue
                if dst % src == 0:
                    out = out.repeat_interleave(dst // src, dim=ax)
                else:
                    idx = np.floor(np.arange(dst) * (src / dst)).astype(np.int64)
                    out = out.index_select(ax, self._const(idx, out.device))
            return out
        kernel = _triangle if mode == "linear" else _keys_cubic
        out = x
        for ax, (src, dst) in enumerate(zip(x.shape, sizes)):
            if dst == src:
                continue
            w = _resize_weights(src, dst, kernel, x.device).to(out.dtype)
            out = torch.matmul(out.movedim(ax, -1), w).movedim(-1, ax)
        return out

    def _op_upsample(self, node, args):
        return self._op_resize(node, args)

    def _op_depthtospace(self, node, args):
        x = args[0]
        b = int(node.attrs["blocksize"])
        n, c, h, w = x.shape
        mode = node.attrs.get("mode", "DCR")
        if mode in ("CRD", b"CRD"):
            x = x.reshape(n, c // (b * b), b, b, h, w).permute(0, 1, 4, 2, 5, 3)
        else:
            x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(n, c // (b * b), h * b, w * b)

    def _op_constantofshape(self, node, args):
        value = np.asarray(node.attrs.get("value", np.zeros(1, np.float32)))
        return torch.full(_ints(args[0]), value.reshape(-1)[0].item(),
                          dtype=_torch_dtype(value.dtype), device=self._device)


def make_onnx_fn(graph: OnnxGraph, dtype: torch.dtype = torch.float32
                 ) -> Tuple[Callable, Dict[str, np.ndarray]]:
    """``(fn, params)`` with ``fn(params, *inputs) -> [outputs]``;
    ``params`` is the initializer dict (host numpy): move it to the device
    once and pass tensors."""
    ex = OnnxExecutor(graph, dtype=dtype)
    return ex, ex.params


class OnnxModel(torch.nn.Module):
    """A parsed graph with its weights as buffers, on ``device`` (the card
    unless the caller asks for the CPU): ``model(*inputs)`` returns the
    graph's outputs as tensors.  Inputs may be numpy arrays."""

    def __init__(self, path_or_graph, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        graph = path_or_graph if isinstance(path_or_graph, OnnxGraph) else read_onnx(path_or_graph)
        self.graph = graph
        self.fn, host_params = make_onnx_fn(graph, dtype=dtype)
        self._names = list(host_params)
        for i, name in enumerate(self._names):  # buffer names may not hold "."
            self.register_buffer(f"w{i}", torch.from_numpy(np.array(host_params[name])))
        self.register_buffer("_anchor", torch.zeros(0))  # says where the module lives
        self.to(resolve_device(device)).eval()

    @property
    def input_names(self) -> List[str]:
        return list(self.graph.inputs)

    @property
    def output_names(self) -> List[str]:
        return list(self.graph.outputs)

    @property
    def device(self) -> torch.device:
        return self._anchor.device

    @torch.no_grad()
    def forward(self, *inputs) -> List[torch.Tensor]:
        dev = self.device
        xs = [x.to(dev) if isinstance(x, torch.Tensor) else _tensor(x, dev) for x in inputs]
        params = {name: getattr(self, f"w{i}") for i, name in enumerate(self._names)}
        return self.fn(params, *xs)
