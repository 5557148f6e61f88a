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


def _check(m, n, d, count, queries_bf16=False):
    rng = np.random.default_rng(3)
    g = torch.from_numpy(_unit(rng, n, d)).cuda().to(torch.bfloat16)
    q = torch.from_numpy(_unit(rng, m, d)).cuda()
    if queries_bf16:
        q = q.to(torch.bfloat16)
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


# M: one query, the host path's 8, every query-tile width's edge (8/9,
# 64/65, 128/130), several query tiles (512, 2100).  N: whole tiles and
# not (4096 - 40, 100,312).  count: 1, N, and ones that end inside a tile.
@pytest.mark.usefixtures("cuda_device")
@pytest.mark.parametrize("m,n,count", [(1, 8192, 5000), (70, 4096, 4096), (130, 100_352, 99_900),
                                       (5, 2048, 1), (2100, 100_352, 12_345),
                                       (8, 8192, 8192), (9, 4056, 4056), (64, 100_352, 99_900),
                                       (65, 4096, 4000), (512, 100_312, 100_312),
                                       (64, 100_352, 1), (128, 4096, 129)])
def test_kernel_matches_plain_on_card(m, n, count):
    _check(m, n, 512, count)


# D = 128 is FaceNet-128's width; 64 is one ring stage deep; 72 ends inside one
@pytest.mark.usefixtures("cuda_device")
@pytest.mark.parametrize("d", [64, 72, 128])
@pytest.mark.parametrize("m,n,count", [(3, 4096, 4000), (64, 8192 - 40, 8192 - 40),
                                       (200, 8192, 5000)])
def test_kernel_matches_plain_at_other_depths(m, n, count, d):
    _check(m, n, d, count)


@pytest.mark.usefixtures("cuda_device")
@pytest.mark.parametrize("m", [8, 64, 128, 300])
def test_bf16_queries_take_the_copy_path_and_agree(m):
    """bf16 queries come in through the tensor map, float32 ones are cast
    on the card (inside the blocks or by a pass of its own): same bits."""
    _check(m, 8192, 512, 8000, queries_bf16=True)
    rng = np.random.default_rng(5)
    g = torch.from_numpy(_unit(rng, 8192, 512)).cuda().to(torch.bfloat16)
    q = torch.from_numpy(_unit(rng, m, 512)).cuda()
    s32, i32 = k1.cosine_top1(q, g, 8000)
    s16, i16 = k1.cosine_top1(q.to(torch.bfloat16), g, 8000)
    assert torch.equal(s32, s16) and torch.equal(i32, i16)


# the duplicate lies 8 rows after the original (the same thread's second
# row), 1 and 17 (another lane), 64 (the other warpgroup), 128 (the next
# tile) and 4000 rows after it (another chunk): the original must win
@pytest.mark.usefixtures("cuda_device")
@pytest.mark.parametrize("offset", [1, 8, 17, 64, 128, 4000])
@pytest.mark.parametrize("m_pad", [0, 61, 125])
def test_kernel_ties_keep_lowest_index_on_card(offset, m_pad):
    rng = np.random.default_rng(4)
    gal = torch.from_numpy(_unit(rng, 8192, 64)).cuda()
    picks = torch.tensor([7, 2500, 4000], device="cuda")
    gal[picks + offset] = gal[picks]
    q = torch.cat([gal[picks], torch.from_numpy(_unit(rng, m_pad, 64)).cuda()])
    s, i = k1.cosine_top1(q, gal.to(torch.bfloat16), 8192)
    assert i[:3].tolist() == picks.tolist()


@pytest.mark.usefixtures("cuda_device")
def test_wrapper_checks_on_card():
    q = torch.zeros(2, 64, device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        k1.cosine_top1(torch.zeros(2, 12, device="cuda"), torch.zeros(128, 12, device="cuda"), 10)
    with pytest.raises(ValueError, match="shapes"):
        k1.cosine_top1(q, torch.zeros(128, 32, device="cuda"), 10)
    with pytest.raises(ValueError, match="one CUDA device"):
        k1.cosine_top1(q, torch.zeros(128, 64), 10)
    s, i = k1.cosine_top1(q[:0], torch.zeros(128, 64, device="cuda"), 10)
    assert s.shape == (0,) and i.shape == (0,)


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
