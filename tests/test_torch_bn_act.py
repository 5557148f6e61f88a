"""BatchNorm's ReLU and residual arguments, and kernel K3's plain side, on the CPU.

``BatchNorm.forward(x, train, relu, residual)`` finishes the layer as
the networks did after it (``+ residual``, then ReLU).  On the CPU it
must equal that old sequence of modules bitwise, in eval and train mode,
for tensors and ``ShardList``s; the small RetinaFace, YuNet and FaceNet
must give what their call sites gave before they passed ``relu`` and
``residual`` to the layer (the old forwards are kept below for the
comparison), in eval mode and in train mode with their gradients and
running statistics.  Nothing here builds or launches K3: its launch plan
is a pure function, checked here; the kernel itself is checked against
``plain_bn_act`` on the card (``tests/test_torch_bn_act_cuda.py``)."""

import pytest
import torch

from fire_tpu_torch.models import facenet as FN
from fire_tpu_torch.models import retinaface as RF
from fire_tpu_torch.models import yunet as YN
from fire_tpu_torch.models.layers import BatchNorm, max_pool_same, same_pad
from fire_tpu_torch.ops import bn_act
from fire_tpu_torch.parallel.shards import ShardList
from fire_tpu_torch.runtime import graphs
from tests.torch_threads import one_torch_thread  # noqa: F401


def _randomise(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every BatchNorm given statistics and an affine map far from the
    identity, so that a wrong order of ops shows."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.running_mean.numel()
                m.running_mean.copy_(0.3 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                if m.use_scale:
                    m.weight.copy_(1 + 0.3 * torch.randn(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))
    return model


def _old_sequence(bn, x, train, relu, residual):
    y = bn._forward_shards(x, train) if isinstance(x, ShardList) else bn._forward(x, train)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def _same(a, b) -> bool:
    if isinstance(a, ShardList):
        return all(_same(s, t) for s, t in zip(a.shards, b.shards))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 16, 5, 7), (6, 24), (2, 10, 4, 4)],
                         ids=["conv", "dense", "conv-C10"])
@pytest.mark.parametrize("use_scale", [True, False], ids=["scale", "no-scale"])
@pytest.mark.parametrize("relu,residual", [(False, False), (True, False), (False, True),
                                           (True, True)],
                         ids=["plain", "relu", "residual", "residual-relu"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shards", [False, True], ids=["tensor", "shardlist"])
def test_layer_equals_the_old_sequence(dtype, shape, use_scale, relu, residual, train, shards):
    gen = torch.Generator().manual_seed(7)
    eps = 1e-3 if not use_scale else 1e-5
    new, old = (_randomise(BatchNorm(shape[1], eps, use_scale=use_scale), 3) for _ in range(2))
    x = (2 * torch.randn(shape, generator=gen) + 0.5).to(dtype)
    r = torch.randn(shape, generator=gen).to(dtype) if residual else None
    if shards:
        x = ShardList(list(x.chunk(2)))
        r = ShardList(list(r.chunk(2))) if residual else None
    got = new(x, train, relu=relu, residual=r)
    want = _old_sequence(old, x, train, relu, r)
    assert _same(got, want)
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(new, name), getattr(old, name))
    assert bn_act.launches == 0 and bn_act._fn is None


# The forwards of the call sites before they passed relu and residual to
# BatchNorm: the reference for the networks' outputs.

def _old_bottleneck(self, x, train=False):
    sc = x if self.proj is None else self.proj_bn(self.proj(x), train)
    y = torch.relu(self.bn1(self.c1(x), train))
    y = torch.relu(self.bn2(self.c2(same_pad(y, 3, self.strides)), train))
    y = self.bn3(self.c3(y), train)
    return torch.relu(y + sc)


def _old_ssh_conv_bn(self, x, name, relu, train):
    y = getattr(self, name + "_bn")(getattr(self, name)(x), train)
    return torch.relu(y) if relu else y


def _old_retina_forward(self, x_nhwc, train=False):
    x = x_nhwc.to(self.dtype).permute(0, 3, 1, 2)
    x = torch.relu(self.stem_bn(self.stem(same_pad(x, 7, 2)), train))
    x = max_pool_same(x, 3, 2)
    feats = {}
    for i, n_blocks in enumerate(self.stage_sizes):
        for j in range(n_blocks):
            x = getattr(self, f"stage{i}_block{j}")(x, train)
        if i >= 1:
            feats[2 ** (i + 2)] = x
    p5 = self.lat32(feats[32])
    p4 = self.smooth16(self.lat16(feats[16]) + RF._up2(p5))
    p3 = self.smooth8(self.lat8(feats[8]) + RF._up2(p4))
    a = self.num_anchors
    out = {}
    for stride, feat in ((8, p3), (16, p4), (32, p5)):
        ctx = getattr(self, f"ssh_s{stride}")(feat, train)

        def head(name):
            return getattr(self, f"{name}_s{stride}")(ctx).float().permute(0, 2, 3, 1)

        logits = head("cls")
        b, h, w = logits.shape[:3]
        prob = torch.softmax(logits.reshape(b, h, w, 2, a), dim=-2)[:, :, :, 1, :]
        out[stride] = (prob, head("bbox"), head("lmk"))
    return out


def _old_dp_unit(self, x, train=False):
    x = self.conv2(self.conv1(x))
    if self.bn is not None:
        x = torch.relu(self.bn(x, train))
    return x


def _old_conv_head(self, x, train=False):
    return self.conv2(torch.relu(self.bn1(self.conv1(x), train)), train)


def _old_conv_bn(self, x, train=False):
    x = self.bn(self.conv(x), train)
    return torch.relu(x) if self.relu else x


OLD = {
    "retinaface": [(RF.Bottleneck, "forward", _old_bottleneck),
                   (RF.SSH, "_conv_bn", _old_ssh_conv_bn),
                   (RF.RetinaFace, "forward", _old_retina_forward)],
    "yunet": [(YN.ConvDPUnit, "forward", _old_dp_unit), (YN.ConvHead, "forward", _old_conv_head)],
    "facenet": [(FN.ConvBn, "forward", _old_conv_bn)],
}


def _model(kind: str, dtype: torch.dtype):
    torch.manual_seed(0)
    model, size = {"retinaface": (lambda: RF.RetinaFace((1, 1, 1, 1), width=8), 64),
                   "yunet": (lambda: YN.YuNet(width=8), 64),
                   "facenet": (lambda: FN.tiny_facenet(32), 80)}[kind]
    return _randomise(model().to(dtype), 5), size


def _outputs(out):
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in out[k]]
    return [out]


def _run(kind, model, x, train, old):
    """The model's outputs (and, training, its gradients and statistics)
    with the old call sites or the new."""
    patches = OLD[kind] if old else []
    saved = [(cls, name, getattr(cls, name)) for cls, name, _ in patches]
    for cls, name, fn in patches:
        setattr(cls, name, fn)
    try:
        with torch.set_grad_enabled(train):
            out = model(x, train)
        outs = _outputs(out)
        if not train:
            return outs
        model.zero_grad()
        sum(o.float().square().mean() for o in outs).backward()
        grads = [p.grad.clone() for p in model.parameters()]
        stats = [b.clone() for n, b in model.named_buffers() if "running" in n]
        return outs + grads + stats
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


@pytest.mark.parametrize("kind", ["retinaface", "yunet", "facenet"])
@pytest.mark.parametrize("dtype,train", [(torch.float32, False), (torch.bfloat16, False),
                                         (torch.float32, True)],
                         ids=["eval-f32", "eval-bf16", "train-f32"])
def test_networks_unchanged_by_the_call_sites(kind, dtype, train):
    model, size = _model(kind, dtype)
    x = torch.rand((2, size, size, 3), generator=torch.Generator().manual_seed(1))
    x = x * 255.0 if kind == "retinaface" else x
    if train:
        want = _run(kind, model, x, True, old=True)
        model, _ = _model(kind, dtype)  # fresh statistics
        got = _run(kind, model, x, True, old=False)
    else:
        want = _run(kind, model, x, False, old=True)
        got = _run(kind, model, x, False, old=False)
    assert len(got) == len(want)
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("residual,relu", [(False, False), (True, True), (False, True)])
@pytest.mark.parametrize("shape", [(2, 16, 3, 3), (5, 12)])
def test_plain_form_is_flax_formula(residual, relu, shape):
    """``bn_act`` on CPU tensors is its plain version: Flax's formula op
    by op, rounded to bf16, then ``+ residual`` in bf16 and ReLU."""
    gen = torch.Generator().manual_seed(4)
    c = shape[1]
    x = torch.randn(shape, generator=gen).to(torch.bfloat16)
    r = torch.randn(shape, generator=gen).to(torch.bfloat16) if residual else None
    mean, bias = 0.2 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen)
    var, scale = 0.5 + torch.rand(c, generator=gen), 1 + 0.2 * torch.randn(c, generator=gen)
    got = bn_act.bn_act(x, mean, var, scale, bias, 1e-5, r, relu)
    view = [1, c] + [1] * (len(shape) - 2)
    mul = torch.rsqrt(var + 1e-5) * scale
    want = ((x.float() - mean.view(view)) * mul.view(view) + bias.view(view)).to(torch.bfloat16)
    if residual:
        want = (want.float() + r.float()).to(torch.bfloat16)
    if relu:
        want = want.clamp_min(0)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert bn_act.launches == 0 and bn_act._fn is None


def _to_jax(t: torch.Tensor):
    import jax.numpy as jnp
    import numpy as np

    return jnp.asarray(np.asarray(t.contiguous().view(torch.int16).numpy()).view(jnp.bfloat16))


def _flax_eval_bn(x, r, mean, var, scale, bias, eps, relu):
    """``flax.linen.BatchNorm(use_running_average=True, dtype=bf16)`` on
    ``x`` (channels last), then ``+ r`` and ``nn.relu`` as the JAX
    networks apply them, jitted as they run; the result as torch bf16."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import numpy as np

    layer = nn.BatchNorm(use_running_average=True, epsilon=eps, use_scale=scale is not None,
                         dtype=jnp.bfloat16)
    params = {"bias": jnp.asarray(bias.numpy())}
    if scale is not None:
        params["scale"] = jnp.asarray(scale.numpy())
    variables = {"params": params,
                 "batch_stats": {"mean": jnp.asarray(mean.numpy()),
                                 "var": jnp.asarray(var.numpy())}}

    @jax.jit
    def apply(variables, x, r):
        y = layer.apply(variables, x)
        y = y if r is None else y + r
        return nn.relu(y) if relu else y

    out = np.asarray(apply(variables, _to_jax(x), None if r is None else _to_jax(r)))
    return torch.from_numpy(out.view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("use_scale,eps", [(True, 1e-5), (False, 1e-3)],
                         ids=["scale-1e-5", "no-scale-1e-3"])
@pytest.mark.parametrize("relu,residual", [(False, False), (True, False), (True, True)],
                         ids=["bn", "bn-relu", "bn-add-relu"])
@pytest.mark.parametrize("shape", [(2, 64, 17, 17), (6, 512)], ids=["conv", "dense"])
def test_plain_form_matches_flax_eval_batchnorm(shape, relu, residual, use_scale, eps):
    """``plain_bn_act`` (what K3 equals bitwise on the card) against
    Flax's own eval BatchNorm with the residual and ReLU as the JAX
    networks apply them, on the same bf16 inputs and statistics.

    The two agree bitwise in every channel whose float32
    ``rsqrt(var + eps)`` torch and XLA round alike.  Neither library's
    rsqrt is correctly rounded, and they differ by an ulp in about a
    third of the channels here; that float32 ulp changes the bf16 result
    of at most one value in a thousand, by at most one bf16 ulp of the
    BatchNorm's output (here 0 to 2 values of 36,992 or 3,072)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    gen = torch.Generator().manual_seed(4)
    c = shape[1]
    x = (2 * torch.randn(shape, generator=gen) + 0.3).to(torch.bfloat16)
    r = torch.randn(shape, generator=gen).to(torch.bfloat16) if residual else None
    mean, bias = 0.3 * torch.randn(c, generator=gen), 0.2 * torch.randn(c, generator=gen)
    var = 0.5 + torch.rand(c, generator=gen)
    scale = 1 + 0.3 * torch.randn(c, generator=gen) if use_scale else None
    ones = torch.ones(c)
    got = bn_act.plain_bn_act(x, mean, var, ones if scale is None else scale, bias, eps, r, relu)

    last = (0, 2, 3, 1) if len(shape) == 4 else (0, 1)
    back = (0, 3, 1, 2) if len(shape) == 4 else (0, 1)
    want = _flax_eval_bn(x.permute(last), None if r is None else r.permute(last), mean, var,
                         scale, bias, eps, relu).permute(back)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape

    # the channels whose float32 rsqrt the two libraries round alike
    xla = np.asarray(jax.jit(lambda v: lax.rsqrt(v + eps))(jnp.asarray(var.numpy())))
    alike = torch.from_numpy(xla.copy()) == torch.rsqrt(var + eps)
    assert 0 < int(alike.sum()) < c
    view = [1, c] + [1] * (len(shape) - 2)
    alike = alike.view(view).expand(shape)
    assert torch.equal(got[alike].view(torch.int16), want[alike].view(torch.int16))

    differ = got.view(torch.int16) != want.view(torch.int16)
    assert int(differ.sum()) <= got.numel() // 1000
    bn = bn_act.plain_bn_act(x, mean, var, ones if scale is None else scale, bias, eps)
    a, b, y = got.float()[differ], want.float()[differ], bn.float()[differ]
    # one bf16 ulp of the BatchNorm output, and the two roundings after the add
    assert bool((a - b).abs().le(2.0 ** -7 * y.abs() + 2.0 ** -8 * (a.abs() + b.abs())).all())


def test_layouts_the_kernel_takes():
    conv = torch.zeros((2, 16, 5, 7))
    assert bn_act._channels_inner(conv.to(memory_format=torch.channels_last))
    assert not bn_act._channels_inner(conv)
    assert bn_act._channels_inner(torch.zeros((2, 16, 1, 1)))  # either layout
    assert bn_act._channels_inner(torch.zeros((6, 24)))
    assert not bn_act._channels_inner(torch.zeros((24, 6)).T)
    assert not bn_act._channels_inner(torch.zeros((2, 3, 4)))
    # nothing on the CPU goes to the kernel
    p = torch.zeros(16)
    assert not bn_act.takes(conv.to(torch.bfloat16, memory_format=torch.channels_last), None,
                            p, p, p, p)


SMS = 132
# (rows, C): RetinaFace 512² (stem, stage 1 and 4, SSH), YuNet 640² (stem,
# trunk), FaceNet at 160² (stem3's 80, 1792), the 2-D bottleneck at B = 8 and
# 64, a channel count not a multiple of 8, and a row wider than one block
SHAPES = [(256 * 256, 64), (128 * 128, 256), (16 * 16, 2048), (64 * 64, 128),
          (320 * 320, 16), (80 * 80, 64), (8 * 73 * 73, 80), (8 * 3 * 3, 1792), (8, 512),
          (64, 512), (64 * 17 * 17, 10), (3, 3), (5, 24_576), (1, 8)]


@pytest.mark.parametrize("rows,c", SHAPES)
def test_launch_plan(rows, c):
    for vector in ((8, 1) if c % 8 == 0 else (1,)):
        plan = bn_act.launch_plan(rows, c, vector, SMS)
        groups = c // vector
        assert plan.vector == vector
        assert 1 <= plan.tpr <= min(groups, bn_act.MAX_THREADS)
        assert plan.threads <= bn_act.MAX_THREADS and plan.rpb >= 1
        # a row's vectors fill a block's row of threads unless the row is wider
        assert plan.tpr == groups or plan.tpr == bn_act.MAX_THREADS
        # every row is some block's: at once, or by the grid stride
        resident = SMS * (bn_act.THREADS_PER_SM // plan.threads)
        assert plan.blocks == min(-(-rows // plan.rpb), resident)
        assert plan.blocks * plan.rpb >= min(rows, resident * plan.rpb)


def test_graphs_count_k3_with_k1_and_k2():
    """A replay adds K1's, K2's and K3's launches, then those of K3's
    PReLU route (counted in K3's too: 153 and 50 an IResNet-100 encode)."""
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.track import scan as k2

    assert graphs.launch_counters() == (k1, k2, bn_act)
    before = graphs.launch_counts()
    try:
        graphs.count_replayed((0, 0, 68))
        assert graphs.launch_counts() == (before[0], before[1], before[2] + 68, before[3])
        graphs.count_replayed((0, 0, 153, 50))
        assert graphs.launch_counts() == (before[0], before[1], before[2] + 221,
                                          before[3] + 50)
        assert (bn_act.launches, bn_act.prelu_launches) == (before[2] + 221, before[3] + 50)
    finally:
        graphs.set_launch_counts(before)
    assert graphs.launch_counts() == before
