"""``python -m fire_tpu_torch.bench gallery``: the port of
``bench_gallery.py``, the gallery-match A/B.

On the resident gallery (100,352 padded rows × 512, 99,900 live: the
port's ``DeviceGallery`` at its 100,000 cap; ``bench_gallery.py:30-31``
uses 102,400 and 100,000), at M = 8 and 1,024 queries, ms a call of:

* ``xla_bf16shadow_B{M}``: the library route,
  :func:`fire_tpu_torch.ops.gallery_match.cosine_topk` (a bf16 matmul
  and a stable top-1, ``k=1``), against the bf16 gallery, where JAX runs
  XLA's ``matmul`` + ``top_k``;
* ``xla_f32cast_B{M}``: the same against the float32 gallery;
* ``pallas_bf16shadow_B{M}``: kernel K1
  (:func:`fire_tpu_torch.ops.cosine_top1.cosine_top1`) against the bf16
  gallery, where JAX runs its Pallas kernel.

The keys are ``bench_gallery.py``'s.  Each time is the best of 12 calls
(``bench_gallery.py:42-50``), by CUDA events on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from fire_tpu_torch.bench.common import best_ms, log, parser, print_result, unit_rows

TINY = dict(rows=2_048, count=1_900, batches=(8, 64), trials=2)


def make_inputs(device, rows: int = 100_352, count: int = 99_900, dim: int = 512,
                batches=(8, 1024)) -> dict:
    """``bench_gallery.py:32-57``'s draws from ``default_rng(0)``: the
    gallery (rows ≥ ``count`` zero, as in ``DeviceGallery``), then the
    queries of each M."""
    rng = np.random.default_rng(0)
    gal = torch.from_numpy(unit_rows(rng, rows, dim)).to(device)
    gal[count:] = 0.0
    queries = {b: torch.from_numpy(unit_rows(rng, b, dim)).to(device) for b in batches}
    return {"gal32": gal, "gal16": gal.to(torch.bfloat16), "count": count,
            "valid": torch.arange(rows, device=device) < count, "queries": queries}


def run(device=None, rows: int = 100_352, count: int = 99_900, batches=(8, 1024),
        trials: int = 12, inputs=None) -> dict:
    """ms a call of each variant at each M; returns the JSON record."""
    from fire_tpu_torch.device import resolve_device
    from fire_tpu_torch.ops.cosine_top1 import cosine_top1
    from fire_tpu_torch.ops.gallery_match import cosine_topk

    device = resolve_device(device)
    inputs = inputs or make_inputs(device, rows, count, batches=batches)
    valid, count = inputs["valid"], inputs["count"]
    results = {}
    for b, q in inputs["queries"].items():
        for key, fn in (
                ("xla_bf16shadow", lambda: cosine_topk(q, inputs["gal16"], valid, k=1)),
                ("xla_f32cast", lambda: cosine_topk(q, inputs["gal32"], valid, k=1)),
                ("pallas_bf16shadow", lambda: cosine_top1(q, inputs["gal16"], count))):
            results[f"{key}_B{b}"] = round(best_ms(fn, device, trials), 3)
        log(f"[gal] B={b}: { {k: v for k, v in results.items() if k.endswith(f'_B{b}')} }")
    return {"metric": "gallery top-1 ms/call (100k x 512)", "variants": results}


def main(argv=None) -> int:
    ap = parser("bench_gallery.py on the port: library route vs K1")
    ap.add_argument("--tiny", action="store_true",
                    help="a 2,048-row gallery: a CPU smoke of the tool itself")
    args = ap.parse_args(argv)
    print_result(run(args.device, **(TINY if args.tiny else {})), args.device)
    return 0
