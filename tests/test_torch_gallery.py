"""Gallery persistence and query semantics across the two packages.

A gallery saved by either package (compacted snapshot triplet, and
snapshot + incremental journal) loads in the other with equal rows and
labels; queries agree."""

import numpy as np
import pytest

from fire_tpu.gallery.index import DeviceGallery as JGallery
from fire_tpu.gallery.store import FaceStore as JStore
from fire_tpu_torch.gallery.index import DeviceGallery
from fire_tpu_torch.gallery.store import FaceStore

DIM = 32


def _paths(d):
    return dict(index_path=str(d / "idx.bin"), labels_path=str(d / "labels.pkl"),
                db_ids_path=str(d / "ids.pkl"))


def _fill(g, rng, n, start=0):
    rows = rng.standard_normal((n, DIM)).astype(np.float32)
    for i in range(n):
        g.add(rows[i], f"id{start + i}", start + i + 1)
    return rows


def _make(pkg, d):
    return (JGallery(DIM, capacity=500, **_paths(d)) if pkg == "jax"
            else DeviceGallery(DIM, capacity=500, device="cpu", **_paths(d)))


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("journal", [False, True])
def test_saved_gallery_loads_in_other_package(tmp_path, writer, reader, journal):
    rng = np.random.default_rng(0)
    w = _make(writer, tmp_path)
    rows = _fill(w, rng, 20)
    w.save(compact=True)
    if journal:  # rows after the snapshot go to the journal
        rows = np.concatenate([rows, _fill(w, rng, 5, start=20)])
        w.save()
        assert (tmp_path / "idx.bin.journal").exists()
    r = _make(reader, tmp_path)
    assert r.count == 25 if journal else r.count == 20
    assert r.labels == w.labels and r.db_ids == w.db_ids
    unit = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    got = np.asarray(r._gal[: r.count]) if reader == "jax" else r._gal[: r.count].numpy()
    np.testing.assert_allclose(got, unit, atol=1e-6)
    ids, dists = r.query_batch(unit[[3, 7]], k=1)
    assert ids[:, 0].tolist() == [3, 7] and np.all(dists < 1e-2)


def test_queries_and_relabel_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    j, t = JGallery(DIM, capacity=500), DeviceGallery(DIM, capacity=500, device="cpu")
    rows = rng.standard_normal((40, DIM)).astype(np.float32)
    rows[30] = rows[4] + 0.01  # a near-duplicate group
    for g in (j, t):
        for i in range(40):
            g.add(rows[i], "Unknown_x" if i == 30 else f"id{i}", i + 1)
    q = rng.standard_normal((6, DIM)).astype(np.float32)
    q[0] = rows[4]
    for k in (1, 5):
        ji, jd = j.query_batch(q, k=k)
        ti, td = t.query_batch(q, k=k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, atol=1e-3)
    ref = rows[4] / np.linalg.norm(rows[4])
    assert t.find_similar(ref, 0.9) == j.find_similar(ref, 0.9) == [4, 30]
    js = JStore(str(tmp_path / "j.db"), embedding_dim=DIM)
    ts = FaceStore(str(tmp_path / "t.db"), embedding_dim=DIM)
    for store in (js, ts):
        for i in range(40):
            store.add("x", rows[i])
    j.update_label(4, "alice", js)
    t.update_label(4, "alice", ts)
    assert t.labels == j.labels and t.labels[30] == "alice"
    assert ts.load_all() == js.load_all()
    assert DeviceGallery(DIM, device="cpu").query(rows[0]) == (None, None)
