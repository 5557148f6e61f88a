"""Kernel K3: inference BatchNorm, its ReLU or PReLU and its residual
add in one bf16 pass (CUDA C++, sm_90a).

What an eval-mode :class:`~fire_tpu_torch.models.layers.BatchNorm` runs
on the card for a bf16 input: ``(x − mean) · (rsqrt(var + eps) · scale)
+ bias`` in float32, Flax's formula, rounded to bf16, then the residual
added and the ReLU applied where the network asks for them, or, with no
residual, a PReLU with one float32 slope a channel (ArcFace IResNet's).
The ReLU routes are ``bn_act_kernel``, the PReLU route
``bn_prelu_kernel``.  The
source, its bound on the card and its design are in
``fire_tpu_torch/csrc/bn_act.cu``.

:func:`bn_act` dispatches on where its tensors lie: on the CPU it
computes the plain version (:func:`plain_bn_act`, the same formula as
separate torch ops); on a CUDA device it launches the kernel, or raises
where :func:`takes` says the kernel cannot take the call's tensors.  The
kernel is compiled with ``nvcc`` at first use into
``fire_tpu_torch/_build/`` (named by the source's hash) and bound with
``ctypes``; nothing here imports or builds at module import, so the
module loads on a machine without ``nvcc`` or a GPU.  How a call is cut
into blocks is decided by :func:`launch_plan`, a pure function that the
CPU tests hold.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
from typing import NamedTuple, Optional

import torch

from fire_tpu_torch.device import raw_stream
from fire_tpu_torch.runtime.build import build_cuda, cuda_library_path

NAME = "bn_act"
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "bn_act.cu")
# -fmad=false: no multiply-add contraction, so the float32 arithmetic
# rounds as the plain version's separate ops do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_THREADS = 256          # the kernel's launch bounds
THREADS_PER_SM = 2048      # resident threads an SM holds on sm_90

# Launch count: one per call that launches the kernel, and one per replay of
# a CUDA graph that holds a launch (runtime/graphs.py count_replayed); nowhere else.
launches = 0
# Of those, the launches of the PReLU route (counted in ``launches`` too).
prelu_launches = 0
# nvcc's output of the last build (ptxas register / spill report).
build_log = ""

_fn = None
_sm_count = {}


def library_path() -> str:
    return cuda_library_path(SOURCE, f"lib{NAME}", NVCC_FLAGS)


def build() -> str:
    """Compile the kernel for sm_90a unless this source's library
    exists.  Returns the library's path."""
    global build_log
    path, log = build_cuda(SOURCE, f"lib{NAME}", NVCC_FLAGS)
    build_log = log or build_log
    return path


def _kernel():
    """The library's two entries, ``fire_bn_act`` and ``fire_bn_prelu``."""
    global _fn
    if _fn is None:
        lib = ctypes.CDLL(build())
        ptr, i32, f32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        act, prelu = lib.fire_bn_act, lib.fire_bn_prelu
        act.argtypes = [ptr] * 7 + [f32, i64] + [i32] * 6 + [ptr]
        prelu.argtypes = [ptr] * 7 + [f32, i64] + [i32] * 5 + [ptr]
        act.restype = prelu.restype = ctypes.c_int
        _fn = act, prelu
    return _fn


class LaunchPlan(NamedTuple):
    """What one call gives the kernel: ``vector`` elements a load (8 or
    1), ``tpr`` threads a row of C channels and ``rpb`` rows a block
    (``threads = tpr · rpb``), ``blocks`` blocks that walk the rows with
    a grid stride."""
    vector: int
    tpr: int
    rpb: int
    blocks: int

    @property
    def threads(self) -> int:
        return self.tpr * self.rpb


@functools.lru_cache(maxsize=1024)
def launch_plan(rows: int, channels: int, vector: int, sms: int) -> LaunchPlan:
    """The launch plan for ``rows`` rows of ``channels`` channels in
    vectors of ``vector`` on a card with ``sms`` SMs.  A pure function of
    its arguments; it touches no device.

    A row's vectors go to consecutive threads, at most 256 of them (a
    wider row is walked a vector group at a time); a block stacks as many
    whole rows as fit in 256 threads; the grid covers every row once, or
    as many blocks as the card holds at once, the rest by the stride."""
    groups = channels // vector
    tpr = min(groups, MAX_THREADS)
    rpb = max(1, MAX_THREADS // tpr)
    resident = sms * (THREADS_PER_SM // (tpr * rpb))
    return LaunchPlan(vector, tpr, rpb, max(1, min(-(-rows // rpb), resident)))


def _channels_inner(t: torch.Tensor) -> bool:
    """Whether ``t``'s memory holds its channels (dim 1) innermost: a
    channels-last 4-D tensor, or a contiguous (rows, C) matrix."""
    if t.dim() == 4:
        return t.is_contiguous(memory_format=torch.channels_last)
    return t.dim() == 2 and t.is_contiguous()


def takes(x: torch.Tensor, residual: Optional[torch.Tensor], *params: torch.Tensor) -> bool:
    """Whether the kernel can take this call: bf16 ``x`` (and residual of
    its shape) on a CUDA device with channels innermost, and the four
    per-channel parameters float32, contiguous, on the same device."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or not _channels_inner(x):
        return False
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device or not _channels_inner(residual)):
        return False
    return all(p.dtype == torch.float32 and p.device == x.device and p.is_contiguous()
               and p.shape == (x.shape[1],) for p in params)


def check_end(relu: bool, residual: Optional[torch.Tensor],
              slope: Optional[torch.Tensor]) -> None:
    """Raise on an end of the layer no route has: a PReLU ``slope`` with
    a ReLU or a residual."""
    if slope is not None and (relu or residual is not None):
        raise ValueError("BatchNorm: a PReLU slope ends the layer alone, with no ReLU "
                         "and no residual")


def prelu(y: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """PReLU over dim 1 with one float32 ``slope`` a channel, in
    ``y``'s dtype: ``y > 0 ? y : slope · y``, the product in float32
    rounded once, a NaN kept as it is."""
    shape = [1, -1] + [1] * (y.dim() - 2)
    return torch.where(y <= 0, (y.float() * slope.reshape(shape)).to(y.dtype), y)


def plain_bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, eps: float, residual: Optional[torch.Tensor] = None,
                 relu: bool = False, slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: Flax's formula as separate torch ops in float32,
    rounded to ``x``'s dtype, then ``+ residual`` and ReLU, or
    :func:`prelu` with ``slope``, in that dtype.  On the card the kernel
    equals it bitwise."""
    check_end(relu, residual, slope)
    shape = [1, -1] + [1] * (x.dim() - 2)
    mul = torch.rsqrt(var + eps) * scale
    y = ((x.float() - mean.reshape(shape)) * mul.reshape(shape)
         + bias.reshape(shape)).to(x.dtype)
    if slope is not None:
        return prelu(y, slope)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def _sms(index: int) -> int:
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_count[index]


def bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
           bias: torch.Tensor, eps: float, residual: Optional[torch.Tensor] = None,
           relu: bool = False, slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inference BatchNorm of ``x`` (N, C, H, W) or (N, C) over its
    channels with the per-channel ``mean``, ``var``, ``scale`` and
    ``bias``, then ``+ residual`` and ReLU where given, or a PReLU of
    the per-channel ``slope`` alone.  Returns a new tensor laid out as
    ``x``.

    CPU tensors → the plain version.  CUDA tensors the kernel
    :func:`takes` → the kernel, on the current stream; others → an
    exception."""
    global launches, prelu_launches
    check_end(relu, residual, slope)
    if x.device.type == "cpu":
        return plain_bn_act(x, mean, var, scale, bias, eps, residual, relu, slope)
    params = (mean, var, scale, bias) if slope is None else (mean, var, scale, bias, slope)
    if not takes(x, residual, *params):
        raise ValueError(f"bn_act: the kernel takes bf16 (rows, C) or channels-last (N, C, H, W) "
                         f"tensors with float32 parameters on one CUDA device, not "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()} on {x.device}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    c = x.shape[1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, y, residual) if t is not None)
    plan = launch_plan(x.numel() // c, c, 8 if c % 8 == 0 and aligned else 1,
                       _sms(x.device.index))
    act, prelu_fn = _kernel()
    other = x.device.index != torch.cuda.current_device()
    ptrs = (mean.data_ptr(), var.data_ptr(), scale.data_ptr(), bias.data_ptr())
    plan_args = (plan.tpr, plan.rpb, plan.blocks, raw_stream(x.device.index))
    with torch.cuda.device(x.device) if other else contextlib.nullcontext():
        if slope is None:
            err = act(x.data_ptr(), None if residual is None else residual.data_ptr(),
                      y.data_ptr(), *ptrs, eps, x.numel() // c, c, plan.vector, int(relu),
                      *plan_args)
        else:
            err = prelu_fn(x.data_ptr(), y.data_ptr(), *ptrs, slope.data_ptr(), eps,
                           x.numel() // c, c, plan.vector, *plan_args)
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: code {err} "
                           f"(a cudaError_t, or the kernel's own above 20000) with {plan}")
    launches += 1
    prelu_launches += slope is not None
    return y


def reset_launches() -> None:
    global launches, prelu_launches
    launches = prelu_launches = 0
