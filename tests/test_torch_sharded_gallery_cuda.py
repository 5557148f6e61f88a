"""The serving paths over several cards: the row-sharded gallery view
(``gallery/index.py`` ``ShardedGalleryView``) and the multi-stream step
(``parallel/multistream.py``) on a mesh of the card repeated and, where
the machine has them, on distinct cards.

Needs an NVIDIA card and nvcc, and skips without them; the distinct-card
cases skip on a machine with fewer cards.  This file imports no JAX, so
it runs on the machine with the cards, where tests/conftest.py (which
imports JAX) must be left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sharded_gallery_cuda.py -q

A sharded query synchronises where JAX's reads back, twice (the indices
and the similarities); its similarities are within float32's rounding
of a 512-term sum (two orders: 6.1e-5) of ``DeviceGallery.query_batch``
(K1 at k = 1) and its indices equal wherever a rank wins by more than
1e-3.  Two streams over two distinct cards equal the same two streams on
the card repeated (ids equal, boxes within 1 px, sims within 2e-3), and
an identity enrolled from the first stream is matched in the second, on
the other card."""

import numpy as np
import pytest
import torch

from chip_smoke import _count_syncs
from fire_tpu_torch.gallery.index import DeviceGallery, ShardedGalleryView
from fire_tpu_torch.parallel.mesh import make_mesh
from fire_tpu_torch.parallel.multistream import MultiStreamEngine
from test_torch_readback_pool import MAXF, _fake_engine, _frames, _setup

pytestmark = pytest.mark.cuda

D = 512
ROWS = 20_000
# two float32 sums of the same D products of unit rows, in different
# orders (K1's wgmma tiles, cuBLAS's kernel for a shard's rows), each lie
# within (D - 1)·2⁻²⁴ of the exact sum
SUM_ORDER_TOL = 2 * (D - 1) * 2.0**-24


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the sharded serving paths run there only")
    return torch.device("cuda")


def _cards(n: int) -> list:
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} distinct cards, the machine has {torch.cuda.device_count()}")
    return [f"cuda:{i}" for i in range(n)]


def _unit(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def gallery_rows():
    rng = np.random.default_rng(18)
    return _unit(rng, ROWS), rng


def _gallery(rows) -> DeviceGallery:
    gal = DeviceGallery(D, capacity=ROWS + 512, device="cuda")
    gal.load_rows([(i + 1, f"p{i}", r.tobytes()) for i, r in enumerate(rows)])
    return gal


@pytest.mark.usefixtures("cuda_device")
@pytest.mark.parametrize("mesh", ["cuda:0 x1", "cuda:0 x2", "cuda:0 x3", "cuda:0 x4",
                                  "2 cards", "3 cards", "4 cards"])
def test_a_sharded_query_waits_only_for_its_two_readbacks(gallery_rows, mesh):
    rows, rng = gallery_rows
    devices = (["cuda:0"] * int(mesh[-1]) if mesh.startswith("cuda:0")
               else _cards(int(mesh[0])))
    view = ShardedGalleryView(_gallery(rows), make_mesh(devices=devices))
    for m in (1, 8, 64):
        q = _unit(rng, m)
        for k in (1, 5):
            view.query_batch(q, k=k)  # the first call of a shape makes its pinned buffers
            _, syncs = _count_syncs(lambda: view.query_batch(q, k=k))
            assert len(syncs) == 2, (mesh, m, k, syncs)


@pytest.mark.usefixtures("cuda_device")
@pytest.mark.parametrize("mesh", ["cuda:0 x3", "2 cards", "4 cards"])
def test_the_sharded_view_equals_the_device_gallery(gallery_rows, mesh):
    rows, rng = gallery_rows
    devices = (["cuda:0"] * int(mesh[-1]) if mesh.startswith("cuda:0")
               else _cards(int(mesh[0])))
    gal = _gallery(rows)
    view = ShardedGalleryView(gal, make_mesh(devices=devices))
    g16 = gal.gal_matmul[:ROWS].float()
    for m in (1, 8, 64):
        q = _unit(rng, m)
        q[: m // 2] = rows[rng.integers(0, ROWS, m // 2)]  # half are gallery rows
        full = torch.from_numpy(q).cuda().to(torch.bfloat16).float() @ g16.T
        top = torch.topk(full, 6, dim=1).values.cpu().numpy()
        gaps = top[:, :-1] - top[:, 1:]
        for k in (1, 5):
            ids_g, d_g = gal.query_batch(q, k=k)
            ids_v, d_v = view.query_batch(q, k=k)
            assert float(np.abs(d_v - d_g).max()) <= SUM_ORDER_TOL, (mesh, m, k)
            decisive = gaps[:, :k] > 1e-3
            decisive[:, 1:] &= gaps[:, : k - 1] > 1e-3
            np.testing.assert_array_equal(ids_v[decisive], ids_g[decisive])


def _compare(got, want):
    for f in ("tid", "gid", "mask", "enroll"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert int(np.abs(got.boxes.astype(np.int64) - want.boxes).max()) <= 1
    assert float(np.abs(got.sim - want.sim).max()) <= 2e-3


@pytest.mark.usefixtures("cuda_device")
def test_two_streams_on_two_cards_equal_the_card_repeated():
    devices = _cards(2)
    cfg, gallery = _setup("cuda")
    engines = {name: MultiStreamEngine(_fake_engine("cuda"), gallery, cfg,
                                       make_mesh(devices=devs), encode_k=MAXF)
               for name, devs in (("repeated", ["cuda:0"] * 2), ("distinct", devices))}
    # step 0: identities 3 and 4, neither in the gallery, both flagged
    frames = np.stack([_frames(0), _frames(1)])
    out = {name: e.process_batches(frames) for name, e in engines.items()}
    for got, want in zip(out["distinct"], out["repeated"]):
        _compare(got, want)
    first = out["distinct"][0]
    assert first.enroll.any()
    gallery.add(first.enroll_emb[int(np.nonzero(first.enroll_frame >= 0)[0][0])], "person3",
                db_id=2)
    row = gallery.count - 1
    captures = {name: len(list(e.graphs)) for name, e in engines.items()}
    assert captures["distinct"] == 2  # one step graph on each card
    # step 1: the second stream, on the second card, shows identity 3
    frames = np.stack([_frames(2), _frames(0)])
    out = {name: e.process_batches(frames) for name, e in engines.items()}
    for got, want in zip(out["distinct"], out["repeated"]):
        _compare(got, want)
    second = out["distinct"][1]
    assert (second.gid[second.mask] == row).any()  # through the replica on cuda:1
    assert {name: len(list(e.graphs)) for name, e in engines.items()} == captures
