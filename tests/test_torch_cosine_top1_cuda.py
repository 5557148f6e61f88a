"""Kernel K1 on the card: the CUDA kernel against its plain version.

Needs an NVIDIA card and nvcc, and skips without them.  This file
imports no JAX, so it runs on the machine with the card, where
tests/conftest.py (which imports JAX) must be left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cosine_top1_cuda.py -q

Sims agree to 1e-3; the index is equal wherever the best row wins by
more than 1e-3."""

import numpy as np
import pytest
import torch

from fire_tpu_torch.ops import cosine_top1 as k1

pytestmark = pytest.mark.cuda


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K1 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.usefixtures("cuda_device")
@pytest.mark.parametrize("m,n,count", [(1, 8192, 5000), (70, 4096, 4096), (130, 100_352, 99_900),
                                       (5, 2048, 1), (2100, 100_352, 12_345)])
def test_kernel_matches_plain_on_card(m, n, count):
    rng = np.random.default_rng(3)
    g = torch.from_numpy(_unit(rng, n, 512)).cuda().to(torch.bfloat16)
    q = torch.from_numpy(_unit(rng, m, 512)).cuda()
    before = k1.launches
    ks, ki = k1.cosine_top1(q, g, count)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ps, pi = k1.plain_cosine_top1(q, g, count)
    assert float((ks - ps).abs().max()) <= 1e-3
    assert int(ki.max()) < count
    full = q.to(torch.bfloat16).float() @ g[:count].float().T
    top2 = torch.topk(full, min(2, count), dim=1).values
    decisive = (top2[:, 0] - top2[:, -1] > 1e-3) | (count == 1)
    assert bool((ki[decisive] == pi[decisive]).all())


@pytest.mark.usefixtures("cuda_device")
def test_kernel_empty_gallery_and_ties_on_card():
    rng = np.random.default_rng(4)
    gal = torch.from_numpy(_unit(rng, 8192, 64)).cuda()
    s, i = k1.cosine_top1(gal[:3], gal.to(torch.bfloat16), 0)
    assert (s == -2.0).all() and (i == 0).all()
    picks = torch.tensor([7, 2500, 4000], device="cuda")
    gal[picks + 1] = gal[picks]
    gal[picks + 4000] = gal[picks]
    s, i = k1.cosine_top1(gal[picks], gal.to(torch.bfloat16), 8192)
    assert i.tolist() == picks.tolist()
