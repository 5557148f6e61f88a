"""``python -m fire_tpu_torch.export_bf16`` against ``tools/export_bf16.py``
(its ``to_bf16`` and Flax's ``msgpack_serialize``) on the committed
checkpoints: the two files restore to equal trees (every leaf bitwise
equal, with equal dtypes; they are in fact the same bytes), and each
package's loader reads the other's file.  The rounding is held against
``jnp.asarray(a, jnp.bfloat16)`` bit for bit."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from fire_tpu_torch import export_bf16, weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("jax_export_bf16",
                                               os.path.join(REPO, "tools", "export_bf16.py"))
jax_export = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_export)


def _jax_bytes(src: str) -> bytes:
    """``tools/export_bf16.py:main`` without the file write."""
    with open(src, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    out = dict(tree)
    if "params" in out:
        out["params"] = jax_export.to_bf16(out["params"])
    else:
        out = jax_export.to_bf16(out)
    return serialization.msgpack_serialize(out)


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("name", ["yunet_synth", "blazeface_synth", "blazeface192_synth",
                                  "facenet512_synth"])
def test_export_matches_jax_tool(name, tmp_path):
    src = os.path.join(REPO, "weights_trained", f"{name}.msgpack")
    port_out, jax_out = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    assert export_bf16.main([src, str(port_out)]) == 0
    jax_out.write_bytes(_jax_bytes(src))

    a = _leaves(serialization.msgpack_restore(port_out.read_bytes()))
    b = _leaves(serialization.msgpack_restore(jax_out.read_bytes()))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path
        if path.startswith("['params']"):
            assert x.dtype == jnp.bfloat16, path
        else:
            assert x.dtype == np.float32, path
    assert port_out.read_bytes() == jax_out.read_bytes()

    # each package's loader reads the other's file
    from_jax = weights.read_msgpack(str(jax_out))
    from_port = weights.read_msgpack(str(port_out))
    flat_j, flat_p = weights.flatten(from_jax), weights.flatten(from_port)
    assert flat_j.keys() == flat_p.keys()
    for key in flat_j:
        assert flat_j[key].tobytes() == flat_p[key].tobytes(), key


@pytest.mark.parametrize("case", ["normal", "ties", "specials"])
def test_rounding_is_jax_bfloat16(case):
    """Bits of the rounded values, and the exact float32 they stand for."""
    rng = np.random.default_rng(7)
    if case == "normal":
        a = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-30, 30, 4096)).astype(np.float32)
    elif case == "ties":
        # every low half exactly 0x8000 (a tie), both parities of the kept bit
        hi = rng.integers(0, 0x7F00, 2048, dtype=np.uint32)
        a = ((hi << 16) | np.uint32(0x8000)).view(np.float32)
    else:
        a = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 3.4e38, -3.4e38,
                      np.finfo(np.float32).tiny, 65504.0], np.float32)
        # NaNs, quiet and signalling, of both signs: the quiet NaN of the sign
        nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFBFFFFF, 0x7FC12345], np.uint32)
        a = np.concatenate([a, nans.view(np.float32)])
    got = export_bf16.to_bf16({"w": a})["w"]
    want = np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(got.bits, want)
    finite = np.isfinite(a)
    np.testing.assert_array_equal(got.to_f32()[finite],
                                  np.asarray(jnp.asarray(a[finite], jnp.bfloat16), np.float32))


def test_non_float32_leaves_stay_as_stored():
    tree = {"i": np.arange(3, dtype=np.int32), "h": np.ones(2, np.float16),
            "b": weights.f32_to_bf16(np.ones(2, np.float32))}
    out = export_bf16.to_bf16(tree)
    assert out["i"].dtype == np.int32 and out["h"].dtype == np.float16
    assert out["b"] is tree["b"]
