"""ctypes bindings to the port's host C++ library (counterpart of
``fire_tpu.runtime.native``: ``load_native``, ``linear_sum_assignment``
and ``host_nms``).

``fire_tpu_torch/csrc/fire_native.cc`` holds the Jonker-Volgenant LAP
(``fire_lap_solve``) and greedy NMS (``fire_nms``).  It is built at first
use with the host C++ compiler into ``fire_tpu_torch/_build/``
(:mod:`fire_tpu_torch.runtime.build`).  Where it cannot be built (no
compiler), ``load_native`` logs a warning and returns ``None``, and the
two functions use SciPy and NumPy, as the JAX package does without its
library.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
from typing import Optional, Tuple

import numpy as np

from fire_tpu_torch.runtime import build as hostbuild

log = logging.getLogger(__name__)

SOURCE = os.path.join(hostbuild.CSRC, "fire_native.cc")


def library_path() -> str:
    return hostbuild.library_path(SOURCE, "libfire_native")


@functools.lru_cache(maxsize=None)
def load_native() -> Optional[ctypes.CDLL]:
    """The built library, or ``None`` (one warning) where it cannot be
    built."""
    try:
        lib = ctypes.CDLL(hostbuild.build(SOURCE, "libfire_native"))
    except (RuntimeError, OSError) as e:
        log.warning("fire_native could not be built (%s); SciPy / NumPy are used instead.", e)
        return None
    lib.fire_lap_solve.restype = ctypes.c_int
    lib.fire_lap_solve.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.fire_nms.restype = ctypes.c_int
    lib.fire_nms.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def linear_sum_assignment(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Rectangular LAP: ``(row_idx, col_idx)`` like SciPy, rows sorted.
    The native Jonker-Volgenant solver when built, SciPy otherwise."""
    lib = load_native()
    if lib is None:
        from scipy.optimize import linear_sum_assignment as scipy_lap

        return scipy_lap(cost)
    c = np.ascontiguousarray(cost, np.float64)
    if c.ndim != 2:
        raise ValueError(f"cost must be 2-D, got shape {c.shape}")
    n, m = c.shape
    k = min(n, m)
    rows = np.empty(k, np.int32)
    cols = np.empty(k, np.int32)
    rc = lib.fire_lap_solve(
        n, m,
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if rc != 0:  # no finite augmenting path (non-finite costs): SciPy decides
        from scipy.optimize import linear_sum_assignment as scipy_lap

        return scipy_lap(cost)
    order = np.argsort(rows)
    return rows[order], cols[order]


def host_nms(boxes_xyxy: np.ndarray, scores: np.ndarray, iou_threshold: float,
             plus_one: bool = False, suppress_equal: bool = False) -> np.ndarray:
    """Greedy NMS on the host → kept indices in score order: native C++
    when built, :func:`host_nms_numpy` otherwise."""
    lib = load_native()
    n = boxes_xyxy.shape[0]
    if n == 0:
        return np.empty(0, np.int64)
    if lib is None:
        return host_nms_numpy(boxes_xyxy, scores, iou_threshold, plus_one, suppress_equal)
    b = np.ascontiguousarray(boxes_xyxy, np.float32)
    s = np.ascontiguousarray(scores, np.float32)
    if b.shape != (n, 4) or s.shape != (n,):
        raise ValueError(f"boxes must be (N, 4) and scores (N,), got {b.shape} and {s.shape}")
    keep = np.empty(n, np.int32)
    k = lib.fire_nms(
        n,
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(iou_threshold),
        int(plus_one), int(suppress_equal),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return keep[:k].astype(np.int64)


def host_nms_numpy(boxes_xyxy: np.ndarray, scores: np.ndarray, iou_threshold: float,
                   plus_one: bool = False, suppress_equal: bool = False) -> np.ndarray:
    """The NumPy greedy NMS ``host_nms`` uses without the library."""
    n = boxes_xyxy.shape[0]
    if n == 0:
        return np.empty(0, np.int64)
    off = 1.0 if plus_one else 0.0
    x1, y1, x2, y2 = boxes_xyxy.T
    areas = (x2 - x1 + off) * (y2 - y1 + off)
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(n, bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order])
        yy1 = np.maximum(y1[i], y1[order])
        xx2 = np.minimum(x2[i], x2[order])
        yy2 = np.minimum(y2[i], y2[order])
        w = np.maximum(0.0, xx2 - xx1 + off)
        h = np.maximum(0.0, yy2 - yy1 + off)
        inter = w * h
        ovr = inter / (areas[i] + areas[order] - inter)
        sup = ovr >= iou_threshold if suppress_equal else ovr > iou_threshold
        suppressed[order[sup]] = True
        suppressed[i] = True
    return np.asarray(keep, np.int64)
