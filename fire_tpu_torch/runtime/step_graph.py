"""One CUDA graph from captured parts, with a conditional node for each
encoder rung (``csrc/step_graph.cu``): the batched step's counterpart of
``jax.jit(step)`` with ``lax.switch`` inside.

PyTorch captures each part (``torch.cuda.CUDAGraph(keep_graph=True)``,
all into one memory pool); :class:`ComposedGraph` chains their graphs,
each as a child graph node, with the rung bodies behind IF nodes whose
handles a one-block kernel sets from the rung index on the card.  The
parts' memory stays with the PyTorch graphs, which the caller keeps.

The library is compiled with ``nvcc`` at first use into
``fire_tpu_torch/_build/`` and bound with ``ctypes``; nothing here builds
at import.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import torch

from fire_tpu_torch.device import raw_stream
from fire_tpu_torch.runtime.build import build_cuda, cuda_library_path

NAME = "step_graph"
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                      "step_graph.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

build_log = ""
_lib = None

# An item of a composed graph: one part, or the rung bodies with the
# 0-d int64 rung index on the card that picks one.
Item = Tuple[Sequence[torch.cuda.CUDAGraph], Optional[torch.Tensor]]


def library_path() -> str:
    return cuda_library_path(SOURCE, f"lib{NAME}", NVCC_FLAGS)


def build() -> str:
    """Compile the library unless this source's exists; its path."""
    global build_log
    path, log = build_cuda(SOURCE, f"lib{NAME}", NVCC_FLAGS)
    build_log = log or build_log
    return path


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr = ctypes.c_void_p
        lib.fire_graph_compose.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ptr), ctypes.POINTER(ptr),
                                           ctypes.POINTER(ptr)]
        lib.fire_graph_launch.argtypes = [ptr, ptr]
        lib.fire_graph_destroy.argtypes = [ptr]
        for fn in (lib.fire_graph_compose, lib.fire_graph_launch, lib.fire_graph_destroy):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class ComposedGraph:
    """The items' graphs chained in order into one executable graph on
    ``device``.  Raises if CUDA refuses any step of it."""

    def __init__(self, items: List[Item], device: torch.device):
        self.device = torch.device(device)
        lib = _library()
        rungs, graphs, index = [], [], []
        for parts, rung in items:
            if rung is None:
                if len(parts) != 1:
                    raise ValueError(f"an item without a rung index holds one part, not "
                                     f"{len(parts)}")
                rungs.append(0)
            else:
                if rung.shape != () or rung.dtype != torch.int64 or rung.device != self.device:
                    raise ValueError(f"rung index: a 0-d int64 tensor on {self.device}")
                rungs.append(len(parts))
            index.append(None if rung is None else rung.data_ptr())
            graphs += [p.raw_cuda_graph() for p in parts]
        ptrs = ctypes.c_void_p * max(len(graphs), 1)
        exec_ = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            err = lib.fire_graph_compose(len(items), (ctypes.c_int * len(rungs))(*rungs),
                                         ptrs(*graphs), (ctypes.c_void_p * len(index))(*index),
                                         ctypes.byref(exec_))
        if err != 0:
            raise RuntimeError(f"composing the step graph failed: code {err} (a cudaError_t, "
                               f"or above 20000 the library's own)")
        self._exec = exec_.value

    def launch(self) -> None:
        """One run on the device's current stream."""
        with torch.cuda.device(self.device):
            err = _library().fire_graph_launch(self._exec, raw_stream(self.device.index))
        if err != 0:
            raise RuntimeError(f"launching the step graph failed: cudaError_t {err}")

    def __del__(self):
        if getattr(self, "_exec", None) and _lib is not None:
            _lib.fire_graph_destroy(self._exec)
