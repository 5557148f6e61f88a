"""The benchmark of ``fire_tpu_torch``: one run of one cell.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for.  Prints the run's result as the last line of standard output
(one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each compared number with its limit), and the compared numbers, each
beside its limit, as the last lines of standard error.  Exits non-zero,
printing no result, without CUDA or with fewer cards than the cell
asks for, and when a JAX module was loaded.  ``--control 1`` also puts
the float8 control in the program's place after the window and prints
its numbers and its verdict beside the run's (not part of a benchmark
run).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "fire_tpu")


def _env(threads: int) -> None:
    """Caches inside the checkout at fixed paths; no JAX through any
    library; the host's numeric libraries on the configuration's
    ``host_threads``."""
    os.environ["OMP_NUM_THREADS"] = str(threads)
    os.environ["MKL_NUM_THREADS"] = str(threads)
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    from harness import spec

    bench = spec.load_benchmark(ROOT)
    w = spec.cell(bench, args.workload)
    threads = int(spec.config(bench, w["config"], ROOT)["host_threads"])
    _env(threads)
    import torch

    torch.set_num_threads(threads)
    from harness import cell

    chips = int(w["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                   device="cuda:0", control=bool(args.control), bench=bench, root=ROOT)
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps({"info": out["info"]}), file=sys.stderr)
    print(f"correct = {out['correct']}; the numbers compared, each with its limit:",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    del out["info"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
