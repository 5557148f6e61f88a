"""The yardstick's arithmetic from shapes: the card's published peaks,
forward multiply-accumulates counted from a network's layer shapes,
and the least time K1 (the gallery's top-1) and K2 (the tracker scan)
could take for the work their inputs need.

``forward_macs`` is a copy of the counting rule of the program's bench
helpers, applied here to the reference networks on the ``meta`` device,
so the count comes from the configuration's shapes and not from the
program's modules.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM, published dense peaks at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

K1_KERNELS = ("top1_partial", "top1_merge", "cast_bf16")
K2_KERNELS = ("track_scan_kernel",)


def forward_macs(model: torch.nn.Module, *inputs: torch.Tensor) -> int:
    """Multiply-accumulates of one forward pass: each convolution's
    output elements x (input channels / groups) x kernel area, each
    linear layer's outputs x input features."""
    total = [0]

    def conv(mod, _inp, out):
        total[0] += out.numel() * (mod.in_channels // mod.groups) * (
            mod.kernel_size[0] * mod.kernel_size[1])

    def dense(mod, _inp, out):
        total[0] += out.numel() * mod.in_features

    hooks = [m.register_forward_hook(conv if isinstance(m, torch.nn.Conv2d) else dense)
             for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def network_macs(cfg: dict) -> dict:
    """MACs of the configuration's detector at its letterbox size
    ``input_px`` (one frame) and of its encoder at ``encode_px`` (one
    face), counted on the ``meta`` device."""
    from reference import nets

    with torch.device("meta"):
        det = nets.build(cfg["detector"])
        enc = nets.build(cfg["encoder"])
        x = torch.empty((1, *cfg["input_px"], 3))
        f = torch.empty((1, *cfg["encode_px"], 3))
    return {"detector": forward_macs(det, x), "encoder": forward_macs(enc, f)}


def k1_bound_s(queries: int, rows: int, dim: int) -> float:
    """Least time of one top-1 over ``rows`` bf16 gallery rows for
    ``queries`` bf16 queries: the rows and queries read once, the
    outputs (a float and an int each) written once, against
    2 * queries * rows * dim operations at the bf16 rate."""
    nbytes = rows * dim * 2 + queries * dim * 2 + queries * 8
    flops = 2.0 * queries * rows * dim
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def k2_bound_s(b: int, t: int, k: int) -> float:
    """Least time of one tracker scan over ``b`` frames of ``k``
    detection slots with ``t`` track slots and the identity state: the
    detections and the table read once, the table and the per-frame
    outputs written once (bytes only: the operations depend on the
    data, and bytes alone are a lower bound)."""
    table = t * (10 + 100) * 4 + t * 5 * 4 + t + 4
    nbytes = b * k * 17 + 2 * table + b * t * 29
    nbytes += b * k * 9 + 2 * t * 13 + b * t * 13
    return nbytes / HBM_BYTES_PER_S
