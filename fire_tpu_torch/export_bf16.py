"""Re-serialise a trained msgpack checkpoint with bf16 float params
(counterpart of ``tools/export_bf16.py``).

    python -m fire_tpu_torch.export_bf16 in.msgpack out.msgpack

Float32 leaves under ``params`` become bfloat16, rounded to nearest even
as ``jnp.asarray(a, jnp.bfloat16)`` rounds; everything else
(``batch_stats``, int leaves, leaves already in bfloat16) stays as
stored.  A file without ``params`` has every float32 leaf cast.  Reading
and writing go through :mod:`fire_tpu_torch.weights`, so the output is
the bytes that ``tools/export_bf16.py`` writes for the same input, and
either package loads it.
"""

from __future__ import annotations

import sys

import numpy as np

from fire_tpu_torch.weights import BF16, f32_to_bf16, msgpack_restore, msgpack_serialize


def to_bf16(tree):
    """``tools/export_bf16.to_bf16``: each float32 leaf cast to bfloat16,
    every other leaf as an array."""
    if isinstance(tree, dict):
        return {k: to_bf16(v) for k, v in tree.items()}
    if tree is None or isinstance(tree, BF16):
        return tree
    a = np.asarray(tree)
    return f32_to_bf16(a) if a.dtype == np.float32 else a


def _sorted(tree):
    """Every dict's keys in sorted order, as Flax's ``msgpack_serialize``
    writes them (it copies the tree with a JAX tree map)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def export(src: str, dst: str) -> None:
    with open(src, "rb") as f:
        tree = msgpack_restore(f.read(), keep_bf16=True)
    out = dict(tree)
    if "params" in out:
        out["params"] = to_bf16(out["params"])
    else:
        out = to_bf16(out)
    with open(dst, "wb") as f:
        f.write(msgpack_serialize(_sorted(out)))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m fire_tpu_torch.export_bf16 in.msgpack out.msgpack",
              file=sys.stderr)
        return 2
    export(*argv)
    print(f"{argv[0]} -> {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
