"""The port's YuNet trainer (``fire_tpu_torch.train.detect``) against
``fire_tpu.train.detect``: targets, loss, the steps, the scene pool and
the warm start, and JAX's learning smoke test.

Tolerances: targets are equal, except the box targets' log-size
channels, within one float32 ulp (2.4e-7 at sizes up to e²): numpy's,
XLA's and torch's float32 ``log`` each round their own way (JAX's device
builder differs from JAX's host builder by the same ulp).  The loss is
compared at rtol 1e-5, a pool step's at rtol 1e-4 (a whole YuNet forward
in float32 on both sides)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fire_tpu.models.yunet import YuNet as JaxYuNet
from fire_tpu.train import detect as jax_detect
from fire_tpu_torch.models.yunet import YuNet, decode_yunet
from fire_tpu_torch.train import detect, optim
from fire_tpu_torch.train.scenes import compose_scene, make_identities
from fire_tpu_torch.train.trainer import model_batch_stats
from fire_tpu_torch.weights import flatten, flax_shapes, load_flax, materialize, to_flax
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def idents():
    return make_identities(8, seed=1)


def _scenes(idents, n, hw, seed0=100, n_faces=(0, 3), face_px=(24, 110), max_faces=4):
    out = []
    for s in range(n):
        img, b, l = compose_scene(np.random.default_rng(seed0 + s), idents, hw=hw,
                                  n_faces=n_faces, face_px=face_px)
        out.append((img, b, l, detect.pad_gt(b, l, max_faces)))
    return out


def _assert_targets_equal(ours, theirs, what):
    for st in (8, 16, 32):
        for j, name in enumerate(("cls", "box", "kps", "wgt")):
            a, b = np.asarray(ours[st][j]), np.asarray(theirs[st][j])
            assert a.shape == b.shape
            if name == "box":  # x, y exact; log w, log h within one ulp
                np.testing.assert_array_equal(a[..., :2], b[..., :2], err_msg=f"{what} {st}")
                np.testing.assert_allclose(a[..., 2:], b[..., 2:], rtol=0, atol=2.4e-7)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{what} {st} {name}")


def test_host_targets_equal_jax(idents):
    hw = (128, 160)
    for img, b, l, _ in _scenes(idents, 8, hw):
        ours, theirs = detect.build_targets(b, l, hw), jax_detect.build_targets(b, l, hw)
        for st in theirs:
            for a, c in zip(ours[st], theirs[st]):
                np.testing.assert_array_equal(a, c)
    assert detect.assign_level(44.9) == 0 and detect.assign_level(45.0) == 1
    assert detect.assign_level(90.0) == 2


def test_device_targets_equal_host_and_jax(idents):
    """Overlapping faces included: the last face touching a cell decides,
    as the host builder's sequential writes do."""
    hw = (128, 128)
    scenes = _scenes(idents, 12, hw)
    host = detect.stack_targets([detect.build_targets(b, l, hw) for _, b, l, _ in scenes])
    padded = [np.stack([s[3][i] for s in scenes]) for i in range(3)]
    ours = detect.build_targets_device(*map(torch.tensor, padded), hw)
    theirs = jax_detect.build_targets_device(*map(jnp.asarray, padded), hw)
    assert sum(float(ours[st][0].sum()) for st in ours) > 20
    _assert_targets_equal(ours, host, "device vs host")
    _assert_targets_equal(ours, theirs, "port vs jax device")
    # overlapping boxes: two faces sharing cells, the later one's targets win
    boxes = np.array([[[10.0, 10.0, 40.0, 40.0], [20.0, 14.0, 40.0, 40.0]]], np.float32)
    lms = np.tile(np.array([[[30.0, 30.0]]], np.float32), (1, 2, 5, 1))
    valid = np.ones((1, 2), bool)
    ours = detect.build_targets_device(*map(torch.tensor, (boxes, lms, valid)), (64, 64))
    host = detect.stack_targets([detect.build_targets(boxes[0], lms[0], (64, 64))])
    _assert_targets_equal(ours, host, "overlap")


def test_detection_loss_matches_jax(idents):
    hw = (96, 96)
    rng = np.random.default_rng(3)
    scenes = _scenes(idents, 3, hw, n_faces=(1, 2), face_px=(24, 60))
    tgt = detect.stack_targets([detect.build_targets(b, l, hw) for _, b, l, _ in scenes])
    heads = {st: (rng.random((3, *t[0].shape[1:], 1)).astype(np.float32),
                  rng.random((3, *t[0].shape[1:], 1)).astype(np.float32),
                  rng.standard_normal(t[1].shape).astype(np.float32),
                  rng.standard_normal(t[2].shape).astype(np.float32))
             for st, t in tgt.items()}
    # probabilities at and beyond the clip, as sigmoid heads reach them
    heads[8][0][0, 0, 0, 0], heads[8][1][0, 0, 1, 0] = 1.0, 0.0
    kwargs = dict(box_weight=1.5, kps_weight=0.3)
    loss, metrics = detect.detection_loss(
        {st: tuple(map(torch.tensor, h)) for st, h in heads.items()},
        {st: tuple(map(torch.tensor, t)) for st, t in tgt.items()}, **kwargs)
    jloss, jmetrics = jax_detect.detection_loss(
        {st: tuple(map(jnp.asarray, h)) for st, h in heads.items()},
        {st: tuple(map(jnp.asarray, t)) for st, t in tgt.items()}, **kwargs)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)
    # a perfect predictor scores near zero; a broken box raises the loss
    perfect = {st: (torch.tensor(t[0])[..., None].clamp(1e-6, 1 - 1e-6),) * 2
               + (torch.tensor(t[1]), torch.tensor(t[2])) for st, t in tgt.items()}
    tt = {st: tuple(map(torch.tensor, t)) for st, t in tgt.items()}
    assert float(detect.detection_loss(perfect, tt)[0]) < 1e-3
    broken = {st: (h[0], h[1], h[2] + 1.0, h[3]) for st, h in perfect.items()}
    assert float(detect.detection_loss(broken, tt)[0]) > 0.1


def _pool(idents, hw, n=8):
    scenes = _scenes(idents, n, hw, seed0=0, n_faces=(1, 2), face_px=(24, 60))
    return [np.stack([s[0] for s in scenes])] + [np.stack([s[3][i] for s in scenes])
                                                 for i in range(3)]


def test_pool_train_step_matches_jax(idents):
    """One pool step from one state: the same loss and positives, and
    the parameters move."""
    hw = (96, 96)
    pool = _pool(idents, hw)
    model = YuNet(width=8)
    variables = materialize(flax_shapes(model), seed=0)
    load_flax(model, variables)
    opt = optim.adam(1e-3)
    params = list(model.parameters())
    state = (params, model_batch_stats(model), opt.init(params))
    before = params[0].detach().clone()
    idx = np.array([0, 3, 5, 7])
    step = detect.make_pool_train_step(model, opt, hw)
    state, loss, metrics = step(state, *map(torch.tensor, pool), torch.tensor(idx))

    jopt = optax.adam(1e-3)
    jstate = (variables["params"], variables["batch_stats"], jopt.init(variables["params"]))
    jstep = jax_detect.make_pool_train_step(JaxYuNet(width=8, dtype=jnp.float32), jopt, hw)
    _, jloss, jmetrics = jstep(jstate, *map(jnp.asarray, pool), jnp.asarray(idx, jnp.int32))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert float(metrics["n_pos"]) == pytest.approx(float(jmetrics["n_pos"]))
    assert float(metrics["n_pos"]) >= 4
    assert not torch.equal(before, state[0][0])


def test_tiny_yunet_learns_to_detect(idents):
    """JAX's learning smoke test: width-8 YuNet on 96×96 scenes, 260
    steps of 8: the loss drops below a third and the trained net finds
    the faces through the production decode."""
    hw = (96, 96)
    rng = np.random.default_rng(0)
    scenes = [compose_scene(np.random.default_rng(s), idents, hw=hw, n_faces=(1, 1),
                            face_px=(40, 72), n_distractors=(0, 1), occlusion_prob=0.0)
              for s in range(24)]
    data = [(img, detect.build_targets(b, l, hw)) for img, b, l in scenes]
    model = YuNet(width=8)
    # JAX's test starts from Flax's own init: so does this one
    load_flax(model, jax.tree.map(np.asarray, JaxYuNet(width=8, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))))
    opt = optim.chain(optim.clip_by_global_norm(5.0), optim.adam(4e-3))
    params = list(model.parameters())
    state = (params, model_batch_stats(model), opt.init(params))
    step = detect.make_detect_train_step(model, opt)
    losses = []
    for _ in range(260):
        batch = [data[i] for i in rng.integers(0, len(data), 8)]
        images = torch.tensor(np.stack([b[0] for b in batch]), dtype=torch.float32) / 255.0
        targets = {st: tuple(map(torch.tensor, arrs))
                   for st, arrs in detect.stack_targets([b[1] for b in batch]).items()}
        state, loss, _ = step(state, images, targets)
        losses.append(float(loss))
    assert np.mean(losses[-10:]) < 0.33 * np.mean(losses[:10])

    def detect_fn(img):
        with torch.no_grad():
            heads = model(torch.tensor(img[None], dtype=torch.float32) / 255.0)
        d = decode_yunet(heads, 1.0, conf_threshold=0.3, nms_threshold=0.3, max_faces=8)
        m = d.mask[0].numpy()
        return [{"bbox": bb, "landmarks": ll}
                for bb, ll in zip(d.boxes_xywh[0].numpy()[m], d.landmarks[0].numpy()[m])]

    held = [compose_scene(np.random.default_rng(1000 + s), idents, hw=hw, n_faces=(1, 1),
                          face_px=(40, 72), n_distractors=(0, 1), occlusion_prob=0.0)
            for s in range(8)]
    pr = detect.detection_pr(detect_fn, held, iou_thresh=0.4)
    assert pr["recall"] >= 0.5, pr


def test_scene_pool_refreshes_and_stops():
    calls = {"n": 0}

    def gen(rng):
        calls["n"] += 1
        return ("scene", calls["n"])

    pool = detect.ScenePool(gen, size=16, threads=2, seed=0)
    try:
        out = pool.sample(4, np.random.default_rng(0))
        assert len(out) == 4 and all(o[0] == "scene" for o in out)
        import time

        deadline = time.time() + 10
        base = pool.generated
        while pool.generated <= base and time.time() < deadline:
            time.sleep(0.05)
        assert pool.generated > base
    finally:
        pool.stop()
    assert not any(t.is_alive() for t in pool._threads)


def test_scene_pool_under_contention_loses_no_update():
    """More generator threads than cores and a short switch interval:
    every scene made is counted once, the pool never outgrows its size,
    and the threads make at most one scene per scene sampled once full."""
    import sys
    import threading
    import time

    made, lock = [0], threading.Lock()

    def gen(rng):
        with lock:
            made[0] += 1
        return int(rng.integers(1 << 30))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    pool = detect.ScenePool(gen, size=24, threads=16, seed=1)
    try:
        rng = np.random.default_rng(2)
        deadline = time.time() + 1.0
        sampled = 0
        while time.time() < deadline:
            assert len(pool.sample(3, rng)) == 3
            sampled += 3
            assert len(pool._pool) <= 24
    finally:
        pool.stop()
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool._threads)
    assert pool.generated == made[0]
    # 16 threads may each have started one scene before their debt ran out
    assert made[0] <= 24 + sampled + 16


def test_update_pool_rows_writes_in_place():
    arr = torch.zeros((6, 2, 3), dtype=torch.uint8)
    block = np.full((2, 2, 3), 7, np.uint8)
    out = detect.update_pool_rows(arr, block, 3)
    assert out is arr
    assert arr[3:5].eq(7).all() and arr[:3].eq(0).all() and arr[5].eq(0).all()


def test_warm_start_variables_match_jax_and_name_a_mismatch():
    """The committed bf16 YuNet file over YuNet-64's variables: float32
    masters equal to JAX's warm start; a width-8 template raises, naming
    the leaf."""
    path = os.path.join(REPO, "weights_trained", "yunet_synth.msgpack")
    ours = detect.warm_start_variables(materialize(flax_shapes(YuNet()), seed=0), path)
    theirs = jax_detect.warm_start_variables(
        jax.tree.map(np.asarray, materialize(flax_shapes(YuNet()), seed=0)), path)
    fo, ft = flatten(ours), flatten(jax.tree.map(np.asarray, theirs))
    assert fo.keys() == ft.keys()
    for k in fo:
        assert fo[k].dtype == np.float32
        np.testing.assert_array_equal(fo[k], ft[k])
    model = YuNet()
    load_flax(model, ours)
    np.testing.assert_array_equal(to_flax(model)["params"]["model0"]["conv1"]["kernel"],
                                  ours["params"]["model0"]["conv1"]["kernel"])
    with pytest.raises(ValueError, match="shape mismatch at 'params/"):
        detect.warm_start_variables(materialize(flax_shapes(YuNet(width=8)), seed=0), path)
    with pytest.raises(ValueError, match="tree mismatch"):
        detect.warm_start_variables({"params": {"x": np.zeros(1, np.float32)}}, path)
