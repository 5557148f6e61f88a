"""Device selection shared by every entry point.

The port runs on the card.  A caller asks for the CPU explicitly
(``device="cpu"``, as the tests do); there is no silent fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for (or
    defaulted to) but no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fire_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly."
        )
    return dev


def raw_stream(index: int) -> int:
    """The handle of the current CUDA stream on device ``index``, for a
    kernel bound with ctypes."""
    fast = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # no Stream object built
    return fast(index) if fast else torch.cuda.current_stream(index).cuda_stream
