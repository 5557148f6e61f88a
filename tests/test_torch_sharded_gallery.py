"""The port's row-sharded gallery (``fire_tpu_torch.parallel``) against
``fire_tpu.parallel`` on the same numpy-seeded rows: JAX on its conftest's
eight CPU devices, the port on a mesh of ``"cpu"`` entries.  Indices are
exact, similarities within 1e-6."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from fire_tpu.gallery.index import DeviceGallery as JGallery
from fire_tpu.gallery.index import ShardedGalleryView as JView
from fire_tpu.parallel import mesh as JM
from fire_tpu.parallel import sharded_gallery as JS
from fire_tpu_torch.gallery.index import DeviceGallery, ShardedGalleryView
from fire_tpu_torch.parallel import mesh as TM
from fire_tpu_torch.parallel import sharded_gallery as TS

D = 64


def _meshes(n):
    return (JM.make_mesh((n, 1), devices=jax.devices()[:n]),
            TM.make_mesh(devices=["cpu"] * n))


def _unit(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_make_mesh():
    m = TM.make_mesh(devices=["cpu"] * 8)
    assert m.shape == {"dp": 8, "mp": 1} and m.axis_names == ("dp", "mp")
    assert m.axis_devices("dp") == [torch.device("cpu")] * 8
    assert m.distinct_devices() == [torch.device("cpu")]
    assert TM.make_mesh((4, 2), devices=["cpu"] * 8).shape == {"dp": 4, "mp": 2}
    with pytest.raises(ValueError, match="mesh shape"):
        TM.make_mesh((3, 1), devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.make_mesh()


@pytest.mark.parametrize("form", ["mask", "count"])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_topk_matches_jax(n, k, form):
    rng = np.random.default_rng(100 * n + k)
    gal = _unit(rng, 240)
    q = _unit(rng, 7)
    q[0] = gal[200]  # a query that is a row
    if form == "mask":
        valid = rng.random(240) < 0.7
        valid[200] = True
        jv, tv = valid, torch.from_numpy(valid)
    else:
        jv, tv = jax.numpy.int32(173 if n != 8 else 239), 173 if n != 8 else 239
    jmesh, tmesh = _meshes(n)
    js, ji = JS.sharded_cosine_topk(jmesh, q, JS.shard_gallery(jmesh, gal), jv, k=k)
    ts, ti = TS.sharded_cosine_topk(tmesh, torch.from_numpy(q), torch.from_numpy(gal), tv, k=k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    # and against the one-device plain top-k
    from fire_tpu_torch.ops.gallery_match import cosine_topk

    mask = (torch.from_numpy(valid) if form == "mask"
            else torch.arange(240) < int(tv))
    ps, pi = cosine_topk(torch.from_numpy(q), torch.from_numpy(gal), mask, k)
    np.testing.assert_array_equal(ti.numpy(), pi.numpy())


@pytest.mark.parametrize("n", [2, 3, 8])
def test_ties_resolve_to_the_lowest_row(n):
    """A row duplicated into later shards: every copy scores the same,
    and both packages return the lowest global row."""
    rng = np.random.default_rng(7)
    gal = _unit(rng, 24 * n)
    rows_per = 24
    picks = [3, 17]
    for p in picks:
        for s in range(1, n):
            gal[p + s * rows_per] = gal[p]
    q = gal[picks]
    jmesh, tmesh = _meshes(n)
    js, ji = JS.sharded_cosine_topk(jmesh, q, JS.shard_gallery(jmesh, gal),
                                    jax.numpy.int32(gal.shape[0]), k=2)
    ts, ti = TS.sharded_cosine_topk(tmesh, torch.from_numpy(q), torch.from_numpy(gal),
                                    gal.shape[0], k=2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[:, 0].tolist() == picks
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("start", [0, 64, 172, 300 - 128, 299])
def test_update_sharded_rows_straddles_shards(start):
    """Three shards of 100 rows: a 128-row block written at ``start``
    lands in every shard it touches, as GSPMD's sharded update does (and
    a start past the end is clamped, as ``dynamic_update_slice`` does)."""
    rng = np.random.default_rng(start)
    gal = rng.standard_normal((300, D)).astype(np.float32)
    block = rng.standard_normal((128, D)).astype(np.float32)
    jmesh, tmesh = _meshes(3)
    want = np.asarray(JS.update_sharded_rows(JS.shard_gallery(jmesh, gal), block, start))
    shards = TS.shard_gallery(tmesh, torch.from_numpy(gal))
    got = TS.update_sharded_rows(shards, torch.from_numpy(block), start)
    assert got is shards and len(got) == 3 and all(s.shape == (100, D) for s in got)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_sharded_view_matches_jax_after_enrolments(n):
    """The view over a 256-row gallery (n = 3 pads it to 258: 86 rows a
    shard, so 128-row enrolment blocks straddle shards): queries equal
    JAX's view, and an incremental refresh equals a full re-shard."""
    rng = np.random.default_rng(n)
    rows = _unit(rng, 230)
    jg, tg = JGallery(D, capacity=256), DeviceGallery(D, capacity=256, device="cpu")
    for i in range(100):
        jg.add(rows[i], f"p{i}", i + 1)
        tg.add(rows[i], f"p{i}", i + 1)
    jmesh, tmesh = _meshes(n)
    jview, tview = JView(jg, jmesh), ShardedGalleryView(tg, tmesh)
    assert tview.count == 100 and tview.labels is tg.labels
    for i in range(100, 230):  # enrolments after the view was built
        jg.add(rows[i], f"p{i}", i + 1)
        tg.add(rows[i], f"p{i}", i + 1)
    q = np.concatenate([rows[[5, 150, 229]], _unit(rng, 3)])
    for k in (1, 5):
        jids, jd = jview.query_batch(q, k=k)
        tids, td = tview.query_batch(q, k=k)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_allclose(td, jd, atol=1e-6)
        lids, _ = tg.query_batch(q, k=k)
        np.testing.assert_array_equal(tids[:, 0], lids[:, 0])
    assert tids[:3, 0].tolist() == [5, 150, 229]
    incremental = torch.cat(tview._gal_sharded)
    tview.refresh(force=True)
    assert torch.equal(incremental, torch.cat(tview._gal_sharded))
    ids, dists = tview.query(rows[77])
    assert ids.shape == (1, 1) and int(ids[0, 0]) == 77 and abs(float(dists[0, 0])) < 1e-3  # bf16
    empty = ShardedGalleryView(DeviceGallery(D, capacity=256, device="cpu"), tmesh)
    assert empty.query_batch(q) == (None, None)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_sharded_view_sends_its_queries_through_the_staging(n, monkeypatch):
    """The view's queries go to the first shard's device through
    ``HostStaging.upload`` (on a card a pinned buffer copied up without a
    wait, as JAX's ``device_put``), once a call; the view itself makes no
    ``torch.from_numpy`` and no ``Tensor.to`` (a copy out of pageable
    memory, which waits for the card).  The answers still equal JAX's
    view: indices exact, similarities within 1e-6."""
    from fire_tpu_torch.gallery import index as TI
    from fire_tpu_torch.runtime.graphs import HostStaging

    rng = np.random.default_rng(40 + n)
    rows = _unit(rng, 200)
    jg, tg = JGallery(D, capacity=256), DeviceGallery(D, capacity=256, device="cpu")
    for i, r in enumerate(rows):
        jg.add(r, f"p{i}", i + 1)
        tg.add(r, f"p{i}", i + 1)
    jmesh, tmesh = _meshes(n)
    jview, tview = JView(jg, jmesh), ShardedGalleryView(tg, tmesh)
    tview.refresh()  # enrolments are flushed here, not by the queries below

    uploads, moves = [], []
    real_upload, real_to, real_from_numpy = HostStaging.upload, torch.Tensor.to, torch.from_numpy

    def upload(staging, x, device, *args, **kw):
        uploads.append((type(x), torch.device(device)))
        return real_upload(staging, x, device, *args, **kw)

    def in_view(what):
        caller = sys._getframe(2)
        if os.path.samefile(caller.f_code.co_filename, TI.__file__):
            moves.append((what, caller.f_code.co_name, caller.f_lineno))

    def to(t, *args, **kw):
        in_view("Tensor.to")
        return real_to(t, *args, **kw)

    def from_numpy(a):
        in_view("torch.from_numpy")
        return real_from_numpy(a)

    monkeypatch.setattr(HostStaging, "upload", upload)
    monkeypatch.setattr(torch.Tensor, "to", to)
    monkeypatch.setattr(torch, "from_numpy", from_numpy)
    q = np.concatenate([rows[[3, 120, 199]], _unit(rng, 5)])
    for k in (1, 5):
        jids, jd = jview.query_batch(q, k=k)
        tids, td = tview.query_batch(q, k=k)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_allclose(td, jd, atol=1e-6)
    assert tids[:3, 0].tolist() == [3, 120, 199]
    assert uploads == [(np.ndarray, tview._gal_sharded[0].device)] * 2
    assert moves == []
