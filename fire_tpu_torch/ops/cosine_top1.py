"""Kernel K1: fused cosine top-1 over the gallery (CUDA C++, sm_90a).

Replaces the TPU kernel ``fire_tpu/ops/pallas_topk.py:61``
(``pallas_cosine_top1``).  The source, its bound on the card and its
design are in ``fire_tpu_torch/csrc/cosine_top1.cu``.

:func:`cosine_top1` dispatches on where its tensors lie: on the CPU it
computes the plain version (:func:`fire_tpu_torch.ops.gallery_match.
cosine_topk` with ``k=1``); on a CUDA device it launches the kernel or
raises.  The kernel is compiled with ``nvcc`` at first use into
``fire_tpu_torch/_build/`` (named by the source's hash) and bound with
``ctypes``; nothing here imports or builds at module import, so the
module loads on a machine without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Tuple

import torch

from fire_tpu_torch.ops.gallery_match import cosine_topk

NAME = "cosine_top1"
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "cosine_top1.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
ROWS_PER_TILE = 64  # the kernel's RT: chunks are whole tiles
BLOCKS_PER_SM = 4

# Launch count: one per call that launches the kernel, and nowhere else.
launches = 0
# nvcc's output of the last build (ptxas register / spill report).
build_log = ""

_fn = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: K1 is built from csrc/ with the CUDA toolkit")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{NAME}_{digest}.so")


def build() -> str:
    """Compile the kernel for sm_90a unless this source's library
    exists.  Returns the library's path."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE}:\n{build_log}")
    os.replace(tmp, out)
    return out


def _kernel():
    global _fn
    if _fn is None:
        lib = ctypes.CDLL(build())
        fn = lib.fire_cosine_top1
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def chunk_rows_for(m: int, n: int, device: torch.device) -> int:
    """Rows per gallery chunk: enough chunks that (query tiles × chunks)
    puts about ``BLOCKS_PER_SM`` blocks on every SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-m // 64)
    target = max(1, -(-BLOCKS_PER_SM * sms // q_tiles))
    rows = -(-max(n, 1) // target)
    return max(ROWS_PER_TILE, -(-rows // ROWS_PER_TILE) * ROWS_PER_TILE)


def plain_cosine_top1(queries: torch.Tensor, gallery: torch.Tensor,
                      count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``cosine_topk(..., k=1)`` with rows ≥ count
    masked.  Returns ``(sims (M,) f32, idx (M,) int32)``."""
    valid = torch.arange(gallery.shape[0], device=gallery.device) < count
    sims, idx = cosine_topk(queries, gallery, valid, k=1)
    return sims[:, 0], idx[:, 0].to(torch.int32)


def cosine_top1(queries: torch.Tensor, gallery: torch.Tensor,
                count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused top-1 cosine match of ``queries`` (M, D) against the first
    ``count`` rows of ``gallery`` (N, D).  Returns ``(sims (M,) f32,
    idx (M,) int32)``; ``(-2, 0)`` for an empty gallery.

    CPU tensors → the plain version.  CUDA tensors → the kernel, on the
    current stream, or an exception."""
    global launches
    if queries.device.type == "cpu" and gallery.device.type == "cpu":
        return plain_cosine_top1(queries, gallery, count)
    if queries.device.type != "cuda" or gallery.device != queries.device:
        raise ValueError(f"cosine_top1: queries on {queries.device}, gallery on "
                         f"{gallery.device}; both must be on one CUDA device (or the CPU)")
    if queries.dim() != 2 or gallery.dim() != 2 or queries.shape[1] != gallery.shape[1]:
        raise ValueError(f"cosine_top1: shapes {tuple(queries.shape)} x {tuple(gallery.shape)}")
    m, d = queries.shape
    n = gallery.shape[0]
    if d % 8:
        raise ValueError(f"cosine_top1: D={d} must be a multiple of 8")
    q = queries.to(torch.bfloat16).contiguous()
    g = gallery.to(torch.bfloat16).contiguous()
    if q.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("cosine_top1: operands must be 16-byte aligned")
    count = max(0, min(int(count), n))
    dev = q.device
    out_v = torch.empty(m, dtype=torch.float32, device=dev)
    out_i = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return out_v, out_i
    chunk = chunk_rows_for(m, n, dev)
    s = max(1, -(-n // chunk))
    part_v = torch.empty((s, m), dtype=torch.float32, device=dev)
    part_i = torch.empty((s, m), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):  # the launch goes to the current device's context
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), g.data_ptr(), m, n, d, count, chunk, part_v.data_ptr(),
                 part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cosine_top1 kernel launch failed: cudaError_t {err}")
    launches += 1
    return out_v, out_i


def reset_launches() -> None:
    global launches
    launches = 0

