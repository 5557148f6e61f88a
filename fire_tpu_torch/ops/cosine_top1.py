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

How a call is cut into blocks (query tile width, gallery chunks, ring
stages, shared memory) is decided here, by :func:`launch_plan`, a pure
function that the CPU tests hold; the C entry point takes the plan and
refuses one that does not fit the kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import NamedTuple, Tuple

import torch

from fire_tpu_torch.ops.gallery_match import cosine_topk

NAME = "cosine_top1"
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "cosine_top1.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl")

# The kernel's constants (csrc/cosine_top1.cu): the plan below is held to
# them by the C entry point, which refuses a plan that does not fit.
QUERY_TILES = (8, 16, 32, 64, 128)  # instantiated widths QT of the query tile
ROWS_PER_TILE = 128                 # RT: gallery rows per ring stage
DEPTH_PER_STAGE = 64                # KD: depth values per ring stage (128 bytes of bf16)
STAGE_BYTES = ROWS_PER_TILE * DEPTH_PER_STAGE * 2
CONSUMER_WARPS = 8
MAX_SHARED_BYTES = 232_448          # dynamic shared memory one block may use on sm_90
MIN_STAGES, MAX_STAGES = 3, 8
CAST_IN_BLOCK_MAX_QT = 64           # wider float32 query tiles get a cast pass of their own
MAX_CHUNK_TILES = 32_767            # a tile's number in its chunk is kept in 15 bits
BLOCK_OVERHEAD_TILES = 0.5          # a block's start and end, in tiles of streaming time

# Launch count: one per call that launches the kernel, and nowhere else.
launches = 0
# nvcc's output of the last build (ptxas register / spill report).
build_log = ""

_fn = None
_sm_count = {}


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
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
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
        fn.argtypes = [ptr, i32, i32, ptr, ptr] + [i32] * 8 + [ptr] * 5
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


class LaunchPlan(NamedTuple):
    """What one call gives the kernel: ``qt`` queries per block,
    ``q_tiles`` query tiles, ``chunks`` gallery chunks of ``chunk_rows``
    rows (whole tiles; chunk ``s`` is rows ``[s * chunk_rows, (s + 1) *
    chunk_rows)`` cut at the row count), ``stages`` ring stages and the
    block's dynamic shared memory.  The grid is ``(q_tiles, chunks)``."""
    qt: int
    q_tiles: int
    chunk_rows: int
    chunks: int
    stages: int
    shared_bytes: int

    @property
    def blocks(self) -> int:
        return self.q_tiles * self.chunks


def shared_bytes(qt: int, d: int, stages: int) -> int:
    """Dynamic shared memory of one block: alignment slack, the resident
    query tile, the ring, the block reduction, the mbarriers."""
    depth_blocks = -(-d // DEPTH_PER_STAGE)
    return (1024 + depth_blocks * qt * DEPTH_PER_STAGE * 2 + stages * STAGE_BYTES
            + CONSUMER_WARPS * qt * 8 + (2 * stages + 1) * 8)


@functools.lru_cache(maxsize=1024)
def _plan(m: int, n_tiles: int, d: int, sms: int) -> LaunchPlan:
    fits = [w for w in QUERY_TILES if shared_bytes(w, d, MIN_STAGES) <= MAX_SHARED_BYTES]
    if not fits:
        raise ValueError(f"cosine_top1: D={d} leaves no room for a query tile in shared memory")
    qt = next((w for w in fits if w >= m), fits[-1])
    q_tiles = -(-m // qt)
    stages = MIN_STAGES
    while stages < MAX_STAGES and shared_bytes(qt, d, stages + 1) <= MAX_SHARED_BYTES:
        stages += 1
    # One block streams `tiles` tiles and pays a start and an end; an SM
    # runs ceil(blocks / sms) blocks one after the other (the resident
    # queries leave room for one at a time).  Take the chunk size with
    # the least time per SM, the larger on a draw.
    best = None
    for tiles in range(1, min(MAX_CHUNK_TILES, -(-n_tiles * q_tiles // sms)) + 1):
        chunks = -(-n_tiles // tiles)
        cost = -(-chunks * q_tiles // sms) * (tiles + BLOCK_OVERHEAD_TILES)
        if best is None or cost <= best[0]:
            best = (cost, tiles, chunks)
    _, tiles, chunks = best
    return LaunchPlan(qt, q_tiles, tiles * ROWS_PER_TILE, chunks, stages,
                      shared_bytes(qt, d, stages))


def launch_plan(m: int, rows: int, d: int, sms: int) -> LaunchPlan:
    """The launch plan for ``m`` queries against ``rows`` gallery rows of
    depth ``d`` on a card with ``sms`` SMs.  A pure function of its
    arguments; it touches no device.

    ``m`` ≤ 128: one query tile of the smallest width that holds ``m``.
    Above: tiles of 128 queries, the query tile the fastest grid index, so
    the blocks that share a gallery chunk run together and share it in
    L2.  The chunks cover rows ``[0, rows)`` once, in ascending order."""
    return _plan(max(int(m), 1), max(1, -(-int(rows) // ROWS_PER_TILE)), int(d), int(sms))


def plain_cosine_top1(queries: torch.Tensor, gallery: torch.Tensor,
                      count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``cosine_topk(..., k=1)`` with rows ≥ count
    masked.  Returns ``(sims (M,) f32, idx (M,) int32)``."""
    valid = torch.arange(gallery.shape[0], device=gallery.device) < count
    sims, idx = cosine_topk(queries, gallery, valid, k=1)
    return sims[:, 0], idx[:, 0].to(torch.int32)


def _sms(index: int) -> int:
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_count[index]


def _raw_stream(index: int) -> int:
    """The current stream's handle on device ``index``."""
    fast = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # no Stream object built
    return fast(index) if fast else torch.cuda.current_stream(index).cuda_stream


def _launch(q: torch.Tensor, g: torch.Tensor, count: int,
            plan: LaunchPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel under ``plan`` on contiguous, 16-byte aligned
    CUDA operands with ``0 <= count <= N``: ``g`` bf16, ``q`` bf16 or
    float32 (cast to bf16 on the card, into scratch)."""
    global launches
    (m, d), n, dev = q.shape, g.shape[0], q.device
    q_is_f32 = q.dtype == torch.float32
    out_v = torch.empty(m, dtype=torch.float32, device=dev)
    out_i = torch.empty(m, dtype=torch.int32, device=dev)
    # Float32 queries: every block of a narrow single tile casts them for
    # itself (each block reads them all once anyway).  A wide tile, or
    # several, get one pass into scratch first: the float32 reads of all
    # chunks' blocks would weigh on L2 beside the gallery.
    cast_in_block = q_is_f32 and plan.q_tiles == 1 and plan.qt <= CAST_IN_BLOCK_MAX_QT
    # one scratch: the bf16 queries (if that pass makes them), then the (chunks, m) partials
    q16_words = m * d // 2 if q_is_f32 and not cast_in_block else 0
    scratch = torch.empty(q16_words + 2 * plan.chunks * m, dtype=torch.int32, device=dev)
    q16 = scratch.data_ptr()
    part_v = q16 + 4 * q16_words
    fn = _kernel()
    # the launch goes to the current device's context
    other = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if other else contextlib.nullcontext():
        err = fn(q.data_ptr(), q_is_f32, cast_in_block, q16, g.data_ptr(), m, n, d, count,
                 plan.qt, plan.chunk_rows, plan.stages, plan.shared_bytes, part_v,
                 part_v + 4 * plan.chunks * m, out_v.data_ptr(), out_i.data_ptr(),
                 _raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"cosine_top1 kernel launch failed: code {err} "
                           f"(a cudaError_t, or the kernel's own above 20000) with {plan}")
    launches += 1
    return out_v, out_i


def cosine_top1(queries: torch.Tensor, gallery: torch.Tensor,
                count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused top-1 cosine match of ``queries`` (M, D) against the first
    ``count`` rows of ``gallery`` (N, D).  Returns ``(sims (M,) f32,
    idx (M,) int32)``; ``(-2, 0)`` for an empty gallery.

    CPU tensors → the plain version.  CUDA tensors → the kernel, on the
    current stream, or an exception."""
    if queries.dim() != 2 or gallery.dim() != 2 or queries.shape[1] != gallery.shape[1]:
        raise ValueError(f"cosine_top1: shapes {tuple(queries.shape)} x {tuple(gallery.shape)}")
    if queries.device.type == "cpu" and gallery.device.type == "cpu":
        return plain_cosine_top1(queries, gallery, count)
    if queries.device.type != "cuda" or gallery.device != queries.device:
        raise ValueError(f"cosine_top1: queries on {queries.device}, gallery on "
                         f"{gallery.device}; both must be on one CUDA device (or the CPU)")
    m, d = queries.shape
    n = gallery.shape[0]
    if d % 8:
        raise ValueError(f"cosine_top1: D={d} must be a multiple of 8")
    # float32 queries are cast by the kernel's own launch; anything else here
    q = queries if queries.dtype == torch.float32 else queries.to(torch.bfloat16)
    q, g = q.contiguous(), gallery.to(torch.bfloat16).contiguous()
    if q.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("cosine_top1: operands must be 16-byte aligned")
    count = max(0, min(int(count), n))
    if m == 0:
        return (torch.empty(0, dtype=torch.float32, device=q.device),
                torch.empty(0, dtype=torch.int32, device=q.device))
    return _launch(q, g, count, launch_plan(m, count, d, _sms(q.device.index)))


def reset_launches() -> None:
    global launches
    launches = 0

