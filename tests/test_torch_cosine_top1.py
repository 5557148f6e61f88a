"""Kernel K1 (fused cosine top-1): its plain version against the Pallas
kernel in interpret mode and against the XLA top-k, on the cases of
tests/test_pallas_topk.py plus duplicated rows for ties.

The index must be exact and the sims agree to 1e-3: bf16 × bf16
products are exact in float32, only the order of the sums differs.
The CUDA kernel itself is held against this plain version on the card
by tests/test_torch_cosine_top1_cuda.py."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fire_tpu.ops.gallery_match import cosine_topk as j_cosine_topk
from fire_tpu.ops.pallas_topk import pallas_cosine_top1
from fire_tpu_torch.ops import cosine_top1 as k1
from fire_tpu_torch.ops.gallery_match import cosine_topk, l2_normalize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _case(name):
    rng = np.random.default_rng(0)
    if name == "random":
        gal, q, count = _unit(rng, 8192, 128), _unit(rng, 8, 128), 5000
    elif name == "exact_hit":
        gal = _unit(rng, 4096, 64)
        q, count = gal[[3, 100, 2048, 4000]], 4096
    elif name == "empty":
        gal, q, count = np.zeros((2048, 64), np.float32), _unit(rng, 2, 64), 0
    else:  # ties: duplicated rows, earlier copy must win, also across tiles
        gal = _unit(rng, 4096, 64)
        for src, dst in ((7, 9), (7, 3000), (2500, 2600), (100, 4000)):
            gal[dst] = gal[src]
        q, count = gal[[7, 2500, 100, 9]], 4096
    return q, gal, count


@pytest.mark.parametrize("name", ["random", "exact_hit", "empty", "ties"])
def test_plain_matches_pallas_and_xla(name):
    q, gal, count = _case(name)
    ts, ti = k1.cosine_top1(torch.from_numpy(q), torch.from_numpy(gal), count)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    ps, pi = pallas_cosine_top1(jnp.asarray(q), jnp.asarray(gal), count, interpret=True)
    valid = jnp.arange(gal.shape[0]) < count
    xs, xi = j_cosine_topk(jnp.asarray(q), jnp.asarray(gal), valid, k=1)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi)[:, 0])
    np.testing.assert_allclose(ts.numpy(), np.asarray(ps), atol=1e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(xs)[:, 0], atol=1e-3)
    if name == "empty":
        assert (ts.numpy() == -2.0).all() and (ti.numpy() == 0).all()
    if name == "ties":
        assert ti.tolist() == [7, 2500, 100, 7]
    assert k1.launches == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("k", [1, 5])
def test_cosine_topk_matches_xla(k):
    rng = np.random.default_rng(1)
    gal, q = _unit(rng, 1000, 32), _unit(rng, 6, 32)
    gal[500] = gal[20]  # a tie inside the top-k
    q[0] = gal[20]
    valid = np.arange(1000) < 900
    ts, ti = cosine_topk(torch.from_numpy(q), torch.from_numpy(gal), torch.from_numpy(valid), k)
    xs, xi = j_cosine_topk(jnp.asarray(q), jnp.asarray(gal), jnp.asarray(valid), k=k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
    np.testing.assert_allclose(ts.numpy(), np.asarray(xs), atol=1e-3)


def test_l2_normalize_zero_rows_stay_zero():
    from fire_tpu.ops.gallery_match import l2_normalize as j_l2

    x = np.random.default_rng(2).standard_normal((4, 16)).astype(np.float32)
    x[2] = 0.0
    t = l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t, np.asarray(j_l2(jnp.asarray(x))), atol=1e-6)
    assert (t[2] == 0).all()


def test_wrapper_rejects_mixed_devices_and_bad_shapes():
    q = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        k1.cosine_top1(q, torch.zeros(128, 64, device="meta"), 10)


def test_module_imports_without_nvcc_or_gpu(tmp_path):
    """Importing the wrapper builds nothing and needs neither nvcc nor a
    card (the kernel is compiled at its first CUDA launch)."""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="", CUDA_HOME=str(tmp_path))
    code = ("import fire_tpu_torch.ops.cosine_top1 as k1, os, torch; "
            "assert k1.launches == 0 and k1._fn is None; "
            "s, i = k1.cosine_top1(torch.ones(1, 8), torch.ones(4, 8), 4); "
            "assert i.item() == 0 and k1._fn is None; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
