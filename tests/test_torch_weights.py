"""The port's msgpack decoder and Flax→torch weight mapping.

The decoder must reproduce ``flax.serialization.msgpack_restore`` bit
for bit on both committed weight files (bf16 leaves compared as their
exact float32 widening), every leaf must land in the torch model, and
the port's layer lists must equal the JAX package's."""

import os

import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore as flax_restore
from flax.serialization import to_bytes
from flax.traverse_util import flatten_dict

from fire_tpu.models.facenet import facenet_layer_order as j_facenet_order
from fire_tpu.models.yunet import yunet_layer_order as j_yunet_order
from fire_tpu_torch import weights as W
from fire_tpu_torch.models.facenet import FaceNet, facenet_layer_order
from fire_tpu_torch.models.yunet import YuNet, yunet_layer_order

WT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights_trained")
FILES = {"yunet": "yunet_synth.msgpack", "facenet512": "facenet512_synth.msgpack"}


@pytest.mark.parametrize("name", sorted(FILES))
def test_decoder_matches_flax_bit_for_bit(name):
    blob = open(os.path.join(WT, FILES[name]), "rb").read()
    ref = flatten_dict(flax_restore(blob))
    mine = W.flatten(W.msgpack_restore(blob))
    assert set(ref) == set(mine)
    n_bf16 = 0
    for k, r in ref.items():
        m = mine[k]
        assert m.shape == r.shape, k
        n_bf16 += str(r.dtype) == "bfloat16"
        np.testing.assert_array_equal(np.asarray(r, np.float32).view(np.uint32),
                                      np.asarray(m, np.float32).view(np.uint32), err_msg=str(k))
    # the FaceNet-512 export stores most kernels in bf16
    assert (n_bf16 > 0) == (name == "facenet512")


def test_decoder_scalars_ints_and_nesting():
    tree = {"a": {"b": np.arange(6, dtype=np.int32).reshape(2, 3), "c": np.float32(1.5)},
            "d": np.zeros((0, 4), np.float32), "e": np.linspace(0, 1, 70000).astype(np.float64)}
    out = W.msgpack_restore(to_bytes(tree))
    np.testing.assert_array_equal(out["a"]["b"], tree["a"]["b"])
    assert float(out["a"]["c"]) == 1.5
    assert out["d"].shape == (0, 4)
    np.testing.assert_array_equal(out["e"], tree["e"])


@pytest.mark.parametrize("name", sorted(FILES))
def test_every_leaf_consumed_by_full_model(name):
    tree = W.read_msgpack(os.path.join(WT, FILES[name]))
    if name == "yunet":
        model, sd = YuNet(), W.from_flax_yunet(tree)
    else:
        model, sd = FaceNet(embed_dim=512), W.from_flax_facenet(tree)
    n_leaves = len(W.flatten(tree))
    n_unit_scale = sum(k.endswith(".weight") and k.rsplit(".", 1)[0] + ".running_mean" in sd
                       for k in sd) if name == "facenet512" else 0
    assert len(sd) == n_leaves + n_unit_scale
    W.load_into(model, sd)  # strict: raises on missing / surplus / shape
    with pytest.raises(ValueError):
        W.load_into(model, {k: v for k, v in sd.items() if not k.endswith("running_var")})
    bad = dict(tree)
    bad["params"] = dict(tree["params"], stray={"thing": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unconsumed"):
        W.from_flax_yunet(bad)


def _module_order(model, kinds):
    out = []
    for name, mod in model.named_modules():
        for kind, cls in kinds:
            if isinstance(mod, cls):
                out.append((kind, tuple(name.split("."))))
    return out


def test_layer_order_matches_jax_and_module_order():
    from fire_tpu_torch.models.layers import BatchNorm

    assert yunet_layer_order() == j_yunet_order()
    assert facenet_layer_order() == j_facenet_order()
    assert facenet_layer_order((1, 1, 1)) == j_facenet_order((1, 1, 1))
    # registration order of the torch modules is execution order
    y = _module_order(YuNet(), [("conv", torch.nn.Conv2d), ("bn", BatchNorm)])
    assert y == [(e[0], e[1]) for e in yunet_layer_order()]
    f = _module_order(FaceNet(embed_dim=512),
                      [("conv", torch.nn.Conv2d), ("bn", BatchNorm), ("dense", torch.nn.Linear)])
    expect = []
    for kind, path in facenet_layer_order():
        expect += [("conv", path + ("conv",)), ("bn", path + ("bn",))] if kind == "convbn" \
            else [(kind, path)]
    assert f == expect
