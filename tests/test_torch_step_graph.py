"""The pieces of the batched step that the port's CUDA graph runs, held
on the CPU against the JAX package and against the port's own eager
forms (the graph itself is captured on the card only:
``tests/test_torch_step_graph_cuda.py``).

* The rung choice on the device (``rung_index``: ``searchsorted`` of the
  batch's real detections over the ladder) equals ``bisect_left`` and
  JAX's ``jnp.searchsorted(side="left")`` for every count.
* The top rung's batched crop equals the per-frame loop bitwise, and
  JAX's ``jax.vmap(crop_and_resize_mm)`` within one pixel level, as
  ``tests/test_torch_image.py`` holds the one-frame crop.
* The step with the gallery's 0-d device count equals the step with the
  int count bitwise and JAX's step (ids, masks and enrol flags exact,
  boxes ±1 px, sims 1e-3), across an enrolment between two batches,
  each rung forced once.
* ``reset()`` keeps the state's tensors; ``plain_cosine_top1`` takes
  the count as an int or a 0-d tensor alike.
"""

import bisect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fire_tpu.ops import image as J
from fire_tpu.pipeline.batch_engine import BatchStreamEngine as JBSE
from fire_tpu_torch.ops import cosine_top1 as k1
from fire_tpu_torch.ops import image as T
from fire_tpu_torch.pipeline import batch_engine as TB
from tests.test_torch_batch_engine import _compare, _galleries, engines  # noqa: F401


@pytest.mark.parametrize("nk", [8, 64, 512, 2048])
def test_rung_index_equals_bisect_and_jax_searchsorted(nk):
    ladder = TB._bucket_ladder(nk, None)
    lad = torch.tensor(ladder, dtype=torch.int64)
    counts = np.arange(nk + 1)
    want = np.asarray(jnp.searchsorted(jnp.asarray(ladder, jnp.int32),
                                       jnp.asarray(counts, jnp.int32), side="left"))
    k = 8 if nk >= 8 else nk
    for n in counts:
        mask = torch.zeros(nk, dtype=torch.bool)
        mask[torch.randperm(nk, generator=torch.Generator().manual_seed(int(n)))[:n]] = True
        got = TB.rung_index(lad, mask.reshape(-1, k))
        assert got.shape == () and got.dtype == torch.int64
        assert int(got) == bisect.bisect_left(ladder, int(n)) == want[n], (nk, n)


BOXES = np.array([[[10.3, 20.7, 40.0, 50.0], [0.0, 0.0, 8.0, 8.0], [60.5, 30.2, 30.0, 25.0],
                   [-5.0, -3.0, 20.0, 30.0]],
                  [[70.0, 40.0, 0.0, 0.0], [1.5, 2.5, 90.0, 60.0], [30.0, 30.0, 12.0, 14.0],
                   [44.0, 8.0, 52.0, 61.0]],
                  [[0.0, 0.0, 96.0, 72.0], [80.2, 60.7, 20.0, 20.0], [5.0, 50.0, 33.0, 9.0],
                   [20.0, 20.0, 1.0, 1.0]]], np.float32)


@pytest.mark.parametrize("chunk_bytes", [1, T.CROP_CHUNK_BYTES], ids=["frame_chunks", "one_pass"])
def test_batched_crop_equals_loop_and_jax_vmap(chunk_bytes):
    frames = np.random.default_rng(6).integers(0, 256, (3, 72, 96, 3)).astype(np.uint8)
    tf, tb = torch.from_numpy(frames), torch.from_numpy(BOXES)
    got = T.crop_and_resize_mm_batched(tf, tb, (32, 32), chunk_bytes=chunk_bytes)
    loop = torch.stack([T.crop_and_resize_mm(tf[i], tb[i], (32, 32)) for i in range(3)])
    assert got.shape == (3, 4, 32, 32, 3) and got.dtype == torch.float32
    assert torch.equal(got, loop)
    j = jax.vmap(lambda img, b: J.crop_and_resize_mm(img, b, (32, 32)))(jnp.asarray(frames),
                                                                         jnp.asarray(BOXES))
    assert np.abs(got.numpy() - np.asarray(j, np.float32)).max() <= 1.0


@pytest.mark.parametrize("rung", [0, 1, 2])
def test_step_with_device_count_equals_int_count_and_jax(engines, rung):  # noqa: F811
    """Two batches of the one-face scene (8 real detections: every rung
    of B = 8's ladder (8, 32, 64) holds them all, so each forced rung
    must give JAX's result), a host enrolment between them."""
    jcfg, jeng, tcfg, teng, scenes = engines
    jg, tg = _galleries()
    _, tg_int = _galleries()
    jb = JBSE(jeng, jg, jcfg)
    tb = TB.BatchStreamEngine(teng, tg, tcfg)
    ti = TB.BatchStreamEngine(teng, tg_int, tcfg)
    one_face = scenes[1]
    assert tb.rungs(64) == ((8, 32, 64), ((8, False), (32, False), (64, True)))
    for i, batch in enumerate((np.stack([one_face] * 8), np.stack([one_face] * 8))):
        x = torch.from_numpy(batch)
        count = tg.count_dev
        assert count.shape == () and count.dtype == torch.int32 and int(count) == tg.count
        tb.state, packed = tb.step(teng, tg.gal_matmul, count, tb.state, x, rung=rung)
        ti.state, packed_int = ti.step(teng, tg_int.gal_matmul, tg_int.count, ti.state, x,
                                       rung=rung)
        assert torch.equal(packed, packed_int)
        got = TB.unpack_results(packed.numpy(), 8, tb.tcfg.max_tracks, tcfg.embedding_dim)
        want = jb.process_batch(batch)
        _compare(got, want)
        if i == 0:
            assert want.mask.any() and (want.mask.sum(axis=1) <= 1).all()
            for j in np.nonzero(want.enroll_frame >= 0)[0]:
                emb = want.enroll_emb[j] / np.linalg.norm(want.enroll_emb[j])
                for g in (jg, tg, tg_int):
                    g.add(emb, f"new{j}", 1000 + j)
    assert int(tg.count_dev) == tg.count > 300  # the enrolment reached the device count
    assert (got.gid[got.mask] >= 300).any()  # and was matched in the later batch


def test_reset_keeps_the_state_tensors(engines):  # noqa: F811
    _, _, tcfg, teng, scenes = engines
    _, tg = _galleries()
    tb = TB.BatchStreamEngine(teng, tg, tcfg)
    before = [(t, t.data_ptr()) for t in TB.state_tensors(tb.state)]
    tb.process_batch(np.stack([scenes[0]] * 8))
    assert bool(tb.state.table.active.any())
    for (t, ptr), now in zip(before, TB.state_tensors(tb.state)):
        assert now is t and now.data_ptr() == ptr
    tb.reset()
    fresh = TB.make_stream_state(tb.tcfg, tcfg.embedding_dim, "cpu")
    for (t, ptr), now, want in zip(before, TB.state_tensors(tb.state), TB.state_tensors(fresh)):
        assert now is t and now.data_ptr() == ptr
        assert torch.equal(now, want)


@pytest.mark.parametrize("count", [0, 1, 127, 128, 299, 384])
def test_plain_cosine_top1_takes_a_tensor_count(count):
    rng = np.random.default_rng(count)
    g = torch.from_numpy(rng.standard_normal((384, 64)).astype(np.float32))
    g[300:] = 0.0
    q = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    s_int, i_int = k1.plain_cosine_top1(q, g, count)
    s_t, i_t = k1.plain_cosine_top1(q, g, torch.tensor(count, dtype=torch.int32))
    assert torch.equal(s_int, s_t) and torch.equal(i_int, i_t)
    s_w, i_w = k1.cosine_top1(q, g, torch.tensor(count, dtype=torch.int32))
    assert torch.equal(s_int, s_w) and torch.equal(i_int, i_w)
    if count == 0:
        assert bool((s_t == -2.0).all()) and bool((i_t == 0).all())
