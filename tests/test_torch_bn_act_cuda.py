"""Kernel K3 on the card: inference BatchNorm, ReLU or PReLU and
residual in one bf16 pass, against its plain version.

Needs an NVIDIA card and nvcc, and skips without them.  This file
imports no JAX, so it runs on the machine with the card, where
tests/conftest.py (which imports JAX) must be left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_bn_act_cuda.py -q

K3 equals ``plain_bn_act`` (Flax's formula as separate torch ops on the
card) bit for bit: every case below compares the two outputs' bf16 bits
and allows no difference."""

import pytest
import torch

from fire_tpu_torch.models.facenet import facenet_512
from fire_tpu_torch.models.iresnet import iresnet100
from fire_tpu_torch.models.layers import BatchNorm
from fire_tpu_torch.models.retinaface import RetinaFace
from fire_tpu_torch.models.yunet import YuNet
from fire_tpu_torch.ops import bn_act
from fire_tpu_torch.runtime import graphs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K3 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _params(c: int, gen, use_scale: bool = True):
    dev = "cuda"
    mean = (0.3 * torch.randn(c, generator=gen)).to(dev)
    var = (0.5 + torch.rand(c, generator=gen)).to(dev)
    scale = (1 + 0.3 * torch.randn(c, generator=gen)).to(dev) if use_scale else torch.ones(
        c, device=dev)
    bias = (0.2 * torch.randn(c, generator=gen)).to(dev)
    return mean, var, scale, bias


def _input(shape, gen):
    x = (2 * torch.randn(shape, generator=gen) + 0.3).to("cuda", torch.bfloat16)
    return x.to(memory_format=torch.channels_last) if len(shape) == 4 else x


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def _check(shape, relu: bool, residual: bool, use_scale: bool = True, eps: float = 1e-5,
           prelu: bool = False):
    gen = torch.Generator().manual_seed(sum(shape) + 2 * relu + residual)
    x = _input(shape, gen)
    r = _input(shape, gen) if residual else None
    params = _params(shape[1], gen, use_scale)
    slope = (0.25 + 0.1 * torch.randn(shape[1], generator=gen)).cuda() if prelu else None
    before, before_prelu = bn_act.launches, bn_act.prelu_launches
    got = bn_act.bn_act(x, *params, eps, r, relu, slope)
    torch.cuda.synchronize()
    assert bn_act.launches == before + 1
    assert bn_act.prelu_launches == before_prelu + prelu
    want = bn_act.plain_bn_act(x, *params, eps, r, relu, slope)
    assert got.shape == x.shape and got.stride() == x.stride()
    differ = int((_bits(got) != _bits(want)).sum())
    assert differ == 0, f"{differ} of {x.numel()} bf16 values differ from the plain version"


# (N, C, H, W) as the three networks give them, and (rows, C):
# RetinaFace 512²: the stem, a stage-1 block, stage 4, an SSH branch;
# YuNet 640²: the stem, the trunk; FaceNet at 8 × 160²: stem0, stem3's 80,
# block8's 1792; the 2-D bottleneck at B = 8; B = 64 batches; and channel
# counts that are not multiples of 8.
SHAPES = [(1, 64, 256, 256), (1, 256, 128, 128), (1, 2048, 16, 16), (1, 64, 64, 64),
          (1, 16, 320, 320), (1, 64, 80, 80), (8, 32, 79, 79), (8, 80, 37, 37),
          (8, 1792, 3, 3), (8, 512), (64, 512), (64, 16, 40, 40), (64, 256, 17, 17),
          (2, 10, 33, 31), (3, 3, 5, 5), (7, 12), (4, 24_576)]


@pytest.mark.usefixtures("cuda_device")
@pytest.mark.parametrize("relu,residual", [(False, False), (True, False), (False, True),
                                           (True, True)],
                         ids=["plain", "relu", "residual", "residual-relu"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_card(shape, relu, residual):
    _check(shape, relu, residual)


# IResNet-100 at 112²: the PReLU route at the stem and a layer-3 block's
# bn2, a layer-2 block's bn2 at four faces; rows × C, and a channel count
# that is not a multiple of 8; a layer-1 block's bn3 (the shortcut added,
# no activation: the residual route) at four faces (PERF.md's rows)
PRELU_SHAPES = [((1, 64, 112, 112), True), ((1, 256, 14, 14), True), ((4, 128, 28, 28), True),
                ((8, 512), True), ((2, 10, 33, 31), True), ((4, 64, 56, 56), False)]


@pytest.mark.usefixtures("cuda_device")
@pytest.mark.parametrize("shape,prelu", PRELU_SHAPES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else
                         ("prelu" if v else "residual"))
def test_prelu_route_matches_plain_on_card(shape, prelu):
    _check(shape, relu=False, residual=not prelu, prelu=prelu)


@pytest.mark.usefixtures("cuda_device")
def test_prelu_route_takes_no_residual():
    x = torch.ones((4, 8), dtype=torch.bfloat16, device="cuda")
    c = torch.ones(8, device="cuda")
    before = bn_act.launches
    with pytest.raises(ValueError, match="alone"):
        bn_act.bn_act(x, c, c, c, c, 1e-5, x, slope=c)
    assert bn_act.launches == before


@pytest.mark.usefixtures("cuda_device")
def test_prelu_route_keeps_nan_and_signed_zero():
    """``y <= 0 ? slope · y : y``: a NaN passes as it is, −0 and +0 both
    go through the product, as in the plain version."""
    x = torch.tensor([[float("nan"), -0.0, 0.0, -1.5, 2.0, float("-inf"), 1e-30, -3.0]],
                     dtype=torch.bfloat16, device="cuda").repeat(4, 1)
    c = x.shape[1]
    zeros, ones = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
    slope = torch.linspace(-0.5, 0.75, c, device="cuda")
    got = bn_act.bn_act(x, zeros, ones, ones, zeros, 0.0, slope=slope)
    want = bn_act.plain_bn_act(x, zeros, ones, ones, zeros, 0.0, slope=slope)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.isnan(got[:, 0]).all()


@pytest.mark.usefixtures("cuda_device")
@pytest.mark.parametrize("shape", [(8, 32, 79, 79), (8, 512), (2, 10, 33, 31)])
def test_kernel_without_scale_matches_plain(shape):
    """FaceNet's layers: no scale (a buffer of ones), eps 1e-3."""
    _check(shape, relu=True, residual=False, use_scale=False, eps=1e-3)
    _check(shape, relu=False, residual=False, use_scale=False, eps=1e-3)


@pytest.mark.usefixtures("cuda_device")
def test_unaligned_input_takes_the_scalar_loads():
    gen = torch.Generator().manual_seed(9)
    big = _input((1, 8 * 64 + 1), gen)
    x = big[0, 1:].view(8, 64)  # 2 bytes past a 16-byte boundary
    params = _params(64, gen)
    got = bn_act.bn_act(x, *params, 1e-5, None, True)
    want = bn_act.plain_bn_act(x, *params, 1e-5, None, True)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.usefixtures("cuda_device")
def test_wrapper_refuses_what_the_kernel_cannot_take():
    gen = torch.Generator().manual_seed(1)
    params = _params(16, gen)
    nchw = torch.zeros((2, 16, 4, 4), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels-last"):
        bn_act.bn_act(nchw, *params, 1e-5)
    with pytest.raises(ValueError, match="bf16"):
        bn_act.bn_act(nchw.float().to(memory_format=torch.channels_last), *params, 1e-5)
    empty = torch.zeros((0, 16), device="cuda", dtype=torch.bfloat16)
    before = bn_act.launches
    assert bn_act.bn_act(empty, *params, 1e-5).shape == (0, 16)
    assert bn_act.launches == before


def _layer(c: int, use_scale: bool = True):
    bn = BatchNorm(c, 1e-5, use_scale=use_scale)
    gen = torch.Generator().manual_seed(c)
    with torch.no_grad():
        bn.running_mean.copy_(0.3 * torch.randn(c, generator=gen))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))
        bn.weight.copy_(1 + 0.3 * torch.randn(c, generator=gen))
        bn.bias.copy_(0.2 * torch.randn(c, generator=gen))
    return bn.cuda()


@pytest.mark.usefixtures("cuda_device")
def test_graph_replay_counts_launches_and_follows_weights():
    """A captured graph of three layers counts K3 three times a replay,
    none at capture; weights loaded in place after the capture reach the
    replay."""
    gen = torch.Generator().manual_seed(3)
    bn1, bn2 = _layer(64), _layer(64)
    x = _input((1, 64, 40, 40), gen)

    def fn(x):
        with torch.no_grad():
            y = bn1(x, relu=True)
            return bn2(bn1(y), relu=True, residual=y)

    bn_act.reset_launches()
    call = graphs.CapturedCall(fn, [x], torch.cuda.graph_pool_handle())
    assert bn_act.launches == 0 and call.launches_per_replay[2] == 3
    for _ in range(4):
        out = call.replay()[0]
    torch.cuda.synchronize()
    assert bn_act.launches == 12
    assert torch.equal(_bits(out), _bits(fn(x)))
    with torch.no_grad():
        bn2.bias.add_(0.5)
        bn2.running_var.mul_(2.0)
    out = call.replay()[0]
    assert torch.equal(_bits(out), _bits(fn(x)))


@pytest.mark.usefixtures("cuda_device")
def test_calls_that_want_a_gradient_take_the_plain_route():
    gen = torch.Generator().manual_seed(5)
    bn = _layer(32)
    x = _input((2, 32, 9, 9), gen)
    bn_act.reset_launches()
    with torch.no_grad():
        served = bn(x, relu=True)
    assert bn_act.launches == 1
    xg = x.clone().requires_grad_(True)
    y = bn(xg, relu=True)  # eval mode, grad enabled: the plain route
    assert bn_act.launches == 1
    y.float().sum().backward()
    assert xg.grad is not None and bn.weight.grad is not None
    y2 = bn(x, relu=True)  # the input wants none, the layer's parameters do
    assert bn_act.launches == 1
    y2.float().sum().backward()
    # both plain calls are cuDNN's float32 BatchNorm, as before K3
    for out in (y, y2):
        assert torch.equal(out.detach(), torch.relu(bn._forward(x, False)))
    assert served.shape == y.shape


@pytest.mark.usefixtures("cuda_device")
def test_eval_route_is_chosen_by_dtype_alone():
    """In eval mode with no gradient, float32 compute takes the plain
    route and every bf16 call K3, which raises on a layout it does not
    take rather than fall back."""
    gen = torch.Generator().manual_seed(6)
    bn = _layer(32)
    x = _input((2, 32, 9, 9), gen)
    bn_act.reset_launches()
    with torch.no_grad():
        y = bn(x.float(), relu=True)
        assert bn_act.launches == 0
        assert torch.equal(y, torch.relu(bn._forward(x.float(), False)))
        with pytest.raises(ValueError, match="channels-last"):
            bn(x.contiguous(), relu=True)
        with pytest.raises(ValueError, match="channels-last"):
            bn(x, relu=True, residual=x.contiguous())
    assert bn_act.launches == 0


def _networks():
    return {"retinaface-512": (RetinaFace(), 512, 255.0, 68),
            "yunet-640": (YuNet(), 640, 1.0, None),
            "facenet-8x160": (facenet_512(), 160, 1.0, None)}


@pytest.mark.usefixtures("cuda_device")
@pytest.mark.parametrize("name", ["retinaface-512", "yunet-640", "facenet-8x160"])
def test_served_networks_run_every_layer_on_k3(name, monkeypatch):
    """Each network as the engine places it (bf16, eval, channels-last):
    every BatchNorm launches K3 once, and the outputs equal those with
    each layer computed by ``plain_bn_act`` bitwise."""
    model, size, peak, n_bn = _networks()[name]
    model = model.to("cuda", torch.bfloat16).eval().to(memory_format=torch.channels_last)
    layers = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert n_bn is None or layers == n_bn
    batch = 8 if name.startswith("facenet") else 1
    gen = torch.Generator().manual_seed(11)
    x = (torch.rand((batch, size, size, 3), generator=gen) * peak).cuda()
    bn_act.reset_launches()
    with torch.no_grad():
        got = model(x)
    torch.cuda.synchronize()
    assert bn_act.launches == layers
    monkeypatch.setattr(bn_act, "bn_act", bn_act.plain_bn_act)
    with torch.no_grad():
        want = model(x)
    flat = (lambda o: [t for k in sorted(o) for t in o[k]]) if isinstance(got, dict) else (
        lambda o: [o])
    for a, b in zip(flat(got), flat(want)):
        assert torch.equal(a, b)


@pytest.mark.usefixtures("cuda_device")
def test_iresnet100_runs_its_batchnorms_on_k3(monkeypatch):
    """IResNet-100 as the engine places it (bf16, eval, channels-last) at
    2 × 112²: each of its 153 2-D BatchNorms launches K3 once, the 50
    before a PReLU on the PReLU route; ``features`` (float32, after the
    float32 fc) takes the plain route; the outputs equal those with each
    layer computed by ``plain_bn_act`` bitwise."""
    model = iresnet100().to("cuda", torch.bfloat16).eval().to(memory_format=torch.channels_last)
    gen = torch.Generator().manual_seed(12)
    x = torch.rand((2, 112, 112, 3), generator=gen).cuda()
    bn_act.reset_launches()
    with torch.no_grad():
        got = model(x)
    torch.cuda.synchronize()
    assert (bn_act.launches, bn_act.prelu_launches) == (153, 50)
    assert got.dtype == torch.float32 and got.shape == (2, 512)
    monkeypatch.setattr(bn_act, "bn_act", bn_act.plain_bn_act)
    with torch.no_grad():
        want = model(x)
    assert torch.equal(got, want)
