"""The tracker scan (``fire_tpu_torch.track.scan``) on the CPU against
JAX's ``lax.scan``.

* ``sort_scan_plain`` against a ``lax.scan`` of ``fire_tpu.track.sort.
  sort_step`` on numpy-seeded sequences: Hungarian with conflicted
  frames (JAX's JV branch taken), greedy, T ∈ {16, 64, 192},
  K ∈ {8, 128} (K > T solves transposed), a full table refusing spawns,
  and frame skip's all-False coast frames.  ids, masks, provenance, ages,
  active masks and next_id equal on every frame; boxes within 1 px; the
  active tracks' KF state to atol 1e-3, rtol 1e-5.
* ``track_scan_plain`` and the batched step's ``_track_scan`` against
  ``fire_tpu.pipeline.batch_engine._track_scan`` over three chained
  batches whose enrolments overflow ``MAX_ENROLL``.
* ``emb_src`` gathered into embeddings equals the in-loop ``temb`` the
  scan carried before; the epilogue's scatter equals the boolean index.
* The wrapper on CPU tensors takes the plain version and updates in
  place; its argument checks; the launch plan for every T, K >= 1
  within shared memory; a failed launch raises, never falling back.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fire_tpu.pipeline.batch_engine as JBE
from fire_tpu.config import TrackerConfig as JTrackerConfig
from fire_tpu.track import assignment as JA
from fire_tpu.track import sort as JS
from fire_tpu_torch.bench.tracker import random_sequence
from fire_tpu_torch.config import TrackerConfig
from fire_tpu_torch.pipeline import batch_engine as TBE
from fire_tpu_torch.track import scan as K2
from fire_tpu_torch.track import sort as TS
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conflicted(table, boxes, mask, cfg):
    """Whether lap_assign takes its JV branch on this frame (JAX's own
    fast-path test, from the predicted table)."""
    tp, trk = JS.predict_tracks(table, cfg)
    cost = JA.cost_matrix(boxes, trk, max_distance=cfg.max_distance)
    d, t = cost.shape
    if d <= t:
        c, rows = jnp.where(tp.active[None, :], cost, JA._PAD), mask
    else:
        c, rows = jnp.where(mask[None, :], cost.T, JA._PAD), tp.active
    jmin = jnp.argmin(c, axis=1)
    onehot = rows[:, None] & (jmin[:, None] == jnp.arange(c.shape[1])[None, :])
    return jnp.any(onehot.sum(axis=0) > 1)


def jax_sort_scan(jcfg, boxes, mask):
    """A ``lax.scan`` of ``sort_step``: the final table, the stacked
    outputs and each frame's JV flag."""
    def step(tb, fr):
        b, m = fr
        jv = _conflicted(tb, b, m, jcfg)
        tb, out = JS.sort_step(tb, b, m, jcfg)
        return tb, (out, jv)

    table, (out, jv) = jax.jit(lambda t, b, m: jax.lax.scan(step, t, (b, m)))(
        JS.make_table(jcfg), jnp.asarray(boxes), jnp.asarray(mask))
    return table, out, np.asarray(jv)


def assert_tracks_equal(out, jout, table, jtable, frames=None):
    """The tolerances of tests/test_torch_track.py, frame by frame."""
    for name in ("tid", "mask", "src_det", "age"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                      err_msg=name)
    m = np.asarray(jout.mask)
    assert np.abs(out.boxes.numpy()[m] - np.asarray(jout.boxes)[m]).max(initial=0) <= 1
    act = np.asarray(jtable.active)
    np.testing.assert_array_equal(table.active.numpy(), act)
    np.testing.assert_allclose(table.x.numpy()[act], np.asarray(jtable.x)[act], atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(table.p.numpy()[act], np.asarray(jtable.p)[act], atol=1e-3, rtol=1e-5)
    assert int(table.next_id) == int(jtable.next_id)


# (name, assignment, T, K, frames, objects, sequence keywords)
CASES = [
    ("hungarian_T16_K8", "hungarian", 16, 8, 40, 7, dict(area=300.0, size=(60, 120))),
    ("greedy_T16_K8", "greedy", 16, 8, 40, 7, dict(area=300.0, size=(60, 120))),
    ("hungarian_T64_K8", "hungarian", 64, 8, 30, 6, {}),
    ("hungarian_T16_K128_full_table", "hungarian", 16, 128, 12, 40, dict(area=500.0)),
    ("greedy_T16_K128_full_table", "greedy", 16, 128, 12, 40, dict(area=500.0)),
    ("hungarian_T192_K128_crowd", "hungarian", 192, 128, 8, 110,
     dict(area=700.0, size=(50, 90), speed=4.0)),
    ("hungarian_T64_K8_skip3", "hungarian", 64, 8, 36, 6, dict(skip=3)),
]


@pytest.mark.parametrize("name,assignment,t,k,n_frames,n_obj,kw", CASES, ids=[c[0] for c in CASES])
def test_sort_scan_plain_matches_jax_scan(name, assignment, t, k, n_frames, n_obj, kw):
    boxes, mask = random_sequence(len(name), n_frames, k, n_obj, **kw)
    jcfg = JTrackerConfig(assignment=assignment, max_tracks=t)
    cfg = TrackerConfig(assignment=assignment, max_tracks=t)
    jtable, jout, jv = jax_sort_scan(jcfg, boxes, mask)
    table, out = K2.sort_scan_plain(TS.make_table(cfg), torch.from_numpy(boxes),
                                    torch.from_numpy(mask), cfg)
    assert out.tid.shape == (n_frames, t) and out.boxes.shape == (n_frames, t, 4)
    assert_tracks_equal(out, jout, table, jtable)
    assert int(np.asarray(jout.mask).sum()) > 0
    if assignment == "hungarian" and "skip" not in name:
        assert jv.any(), "no frame took JAX's JV branch"
    if "full_table" in name:
        assert bool(np.asarray(jtable.active).all()) and int(mask.sum(1).max()) > t
    if "skip" in name:
        assert not mask[0::3].any() and not mask[1::3].any() and mask[2::3].any()


def _identity_inputs(seed, boxes, mask, dim=8, sim_hi=0.9):
    rng = np.random.default_rng(seed)
    b, k = mask.shape
    det_gid = rng.integers(0, 50, (b, k)).astype(np.int32)
    det_sim = rng.uniform(0.3, sim_hi, (b, k)).astype(np.float32)
    det_emb = rng.standard_normal((b, k, dim)).astype(np.float32)
    has_emb = mask & (rng.random((b, k)) < 0.8)
    return det_gid, det_sim, det_emb, has_emb


def test_track_scan_matches_jax_over_chained_batches():
    """Three batches of 12 frames, T = 16, K = 12: a dozen tracks confirm
    together, so enrolments overflow MAX_ENROLL = 8 and the starvation
    guard re-fires them in the next batch."""
    t, k, dim, thr, trig = 16, 12, 8, 0.7, 1
    cfg, jcfg = TrackerConfig(max_tracks=t), JTrackerConfig(max_tracks=t)
    boxes, mask = random_sequence(5, 36, k, 12, area=800.0, size=(40, 60), speed=3.0, dropout=0.05,
                           births=False)
    gid, sim, emb, has = _identity_inputs(6, boxes, mask, dim, sim_hi=0.72)
    jstate = JBE.make_stream_state(jcfg, dim)
    state = TBE.make_stream_state(cfg, dim)
    overflowed = False
    for lo in range(0, 36, 12):
        sl = slice(lo, lo + 12)
        jargs = [jnp.asarray(x[sl]) for x in (boxes, mask, gid, sim, emb, has)]
        jstate, jres = JBE._track_scan(jstate, *jargs, jcfg, thr, trig)
        targs = [torch.from_numpy(np.ascontiguousarray(x[sl]))
                 for x in (boxes, mask, gid, sim, emb, has)]
        snap = TBE.StreamState(TS.TrackTable(*(x.clone() for x in state.table)),
                               *(x.clone() for x in state[1:]))
        state, res = TBE._track_scan(state, *targs, cfg, thr, trig)
        for name, got, want in zip(TBE.BatchResults._fields, res, jres):
            want = np.asarray(want)
            if name == "boxes":
                m = np.asarray(jres.mask)
                assert np.abs(got.numpy()[m] - want[m]).max(initial=0) <= 1
            elif got.dtype.is_floating_point:
                np.testing.assert_allclose(got.numpy(), want, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        for name in ("gid", "unk", "pending"):
            np.testing.assert_array_equal(getattr(state, name).numpy(),
                                          np.asarray(getattr(jstate, name)), err_msg=name)
        np.testing.assert_allclose(state.last_emb.numpy(), np.asarray(jstate.last_emb), atol=1e-6)
        overflowed |= int(np.asarray(jres.enroll).sum()) > TBE.MAX_ENROLL

        # the plain scan from the same state gives the same per-frame outputs
        ident = K2.IdentityState(snap.gid, snap.sim, snap.unk, snap.pending)
        _, _, out, iout = K2.track_scan_plain(snap.table, ident, *targs[:4], targs[5], cfg, thr,
                                              trig)
        np.testing.assert_array_equal(out.tid.numpy(), np.asarray(jres.tid))
        np.testing.assert_array_equal(out.mask.numpy(), np.asarray(jres.mask))
        np.testing.assert_array_equal(iout.gid.numpy(), np.asarray(jres.gid))
        np.testing.assert_array_equal(iout.enroll.numpy(), np.asarray(jres.enroll))
        np.testing.assert_allclose(iout.sim.numpy(), np.asarray(jres.sim), atol=1e-6)
    assert overflowed, "no batch overflowed MAX_ENROLL"


def _temb_reference(table, last_emb, boxes, mask, det_has_emb, det_emb, cfg):
    """The in-loop embedding the scan carried before emb_src: temb per frame."""
    k = boxes.shape[1]
    out = []
    for f in range(boxes.shape[0]):
        table, o = TS.sort_step(table, boxes[f], mask[f], cfg)
        has_det = (o.src_det >= 0) & table.active
        dft = torch.clamp(o.src_det, 0, k - 1).long()
        has_emb = has_det & det_has_emb[f][dft]
        last_emb = torch.where(has_emb[:, None], det_emb[f][dft], last_emb)
        out.append(last_emb)
    return torch.stack(out)


@pytest.mark.parametrize("skip", [1, 3])
def test_emb_src_gathers_the_in_loop_embeddings(skip):
    t, k, dim = 16, 8, 8
    cfg = TrackerConfig(max_tracks=t)
    boxes, mask = random_sequence(11, 30, k, 7, area=400.0, skip=skip)
    gid, sim, emb, has = (torch.from_numpy(x) for x in _identity_inputs(12, boxes, mask, dim))
    boxes, mask = torch.from_numpy(boxes), torch.from_numpy(mask)
    last = torch.from_numpy(np.random.default_rng(13).standard_normal((t, dim)).astype(np.float32))
    # a table mid-stream: some tracks live and carrying an embedding already
    table = TS.make_table(cfg)
    for f in range(5):
        table, _ = TS.sort_step(table, boxes[f], mask[f], cfg)
    ident = K2.IdentityState(torch.full((t,), -1, dtype=torch.int32), torch.zeros(t),
                             torch.zeros(t, dtype=torch.int32), torch.zeros(t, dtype=torch.bool))
    want = _temb_reference(table, last, boxes[5:], mask[5:], has[5:], emb[5:], cfg)
    _, _, _, iout = K2.track_scan_plain(table, ident, boxes[5:], mask[5:], gid[5:], sim[5:],
                                        has[5:], cfg, 0.7, 1)
    got = K2.gather_emb(iout.emb_src, emb[5:], last)
    assert bool((iout.emb_src == -1).any()) and bool((iout.emb_src >= 0).any())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # a subset by flat (frame, slot) index, as the epilogue takes them
    flat = torch.tensor([0, 5, t + 3, 7 * t + 1])
    sub = K2.gather_emb(iout.emb_src.reshape(-1)[flat], emb[5:], last, slot=flat % t)
    torch.testing.assert_close(sub, want.reshape(-1, dim)[flat], rtol=0, atol=0)


@pytest.mark.parametrize("seed", range(4))
def test_delivered_scatter_matches_the_boolean_index(seed):
    rng = np.random.default_rng(seed)
    t = 16
    e_slot = torch.from_numpy(rng.integers(0, t, TBE.MAX_ENROLL).astype(np.int32))
    valid = torch.from_numpy(rng.random(TBE.MAX_ENROLL) < 0.6)
    want = torch.zeros(t, dtype=torch.bool)
    want[e_slot[valid].long()] = True
    assert torch.equal(TBE.delivered_slots(valid, e_slot, t), want)


# ------------------------------------------------------------------ wrapper --


def _small_case(t=16, k=8, n=10):
    cfg = TrackerConfig(max_tracks=t)
    boxes, mask = random_sequence(21, n, k, 6, area=300.0)
    return cfg, torch.from_numpy(boxes), torch.from_numpy(mask)


def test_sort_scan_on_cpu_takes_the_plain_version_in_place():
    cfg, boxes, mask = _small_case()
    before = K2.launches
    table = TS.make_table(cfg)
    ids = [id(x) for x in table]
    got_table, out = K2.sort_scan(table, boxes, mask, cfg)
    want_table, want = K2.sort_scan_plain(TS.make_table(cfg), boxes, mask, cfg)
    assert [id(x) for x in got_table] == ids  # the same tensors, updated
    for a, b in zip(got_table, want_table):
        assert torch.equal(a, b)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert K2.launches == before and K2._fn is None


def test_track_scan_on_cpu_takes_the_plain_version_in_place():
    cfg, boxes, mask = _small_case()
    gid, sim, emb, has = (torch.from_numpy(x) for x in _identity_inputs(3, boxes.numpy(),
                                                                          mask.numpy()))
    state = TBE.make_stream_state(cfg, 8)
    ident = K2.IdentityState(state.gid, state.sim, state.unk, state.pending)
    table, ident2, out, iout = K2.track_scan(state.table, ident, boxes, mask, gid, sim, has, cfg,
                                             0.7, 1)
    ref = TBE.make_stream_state(cfg, 8)
    rt, ri, rout, riout = K2.track_scan_plain(
        ref.table, K2.IdentityState(ref.gid, ref.sim, ref.unk, ref.pending), boxes, mask, gid,
        sim, has, cfg, 0.7, 1)
    assert table is state.table and ident2 is ident and state.gid is ident.gid
    for a, b in zip((*table, *ident, *out, *iout), (*rt, *ri, *rout, *riout)):
        assert torch.equal(a, b)
    assert int(state.table.active.sum()) > 0 and int(state.gid.max()) >= 0


def test_wrapper_checks_its_arguments():
    cfg, boxes, mask = _small_case()
    table = TS.make_table(cfg)
    with pytest.raises(ValueError, match="boxes"):
        K2.sort_scan(table, boxes.double(), mask, cfg)
    with pytest.raises(ValueError, match=r"boxes .* must be \(B, K, 4\)"):
        K2.sort_scan(table, boxes[..., :3], mask, cfg)
    with pytest.raises(ValueError, match="B >= 1"):
        K2.sort_scan(table, boxes[:0], mask[:0], cfg)
    with pytest.raises(ValueError, match="mask"):
        K2.sort_scan(table, boxes, mask.to(torch.uint8), cfg)
    with pytest.raises(ValueError, match="mask"):
        K2.sort_scan(table, boxes, mask[:, :-1], cfg)
    with pytest.raises(ValueError, match="not contiguous"):
        K2.sort_scan(table, boxes.transpose(0, 1).contiguous().transpose(0, 1), mask, cfg)
    with pytest.raises(ValueError, match="table.tid"):
        K2.sort_scan(table._replace(tid=table.tid.long()), boxes, mask, cfg)
    with pytest.raises(ValueError, match="table.p"):
        K2.sort_scan(table._replace(p=table.p[:-1]), boxes, mask, cfg)
    with pytest.raises(ValueError, match="is on meta"):
        K2.sort_scan(table._replace(x=table.x.to("meta")), boxes, mask, cfg)
    with pytest.raises(ValueError, match="the CPU or a CUDA device"):
        K2.sort_scan(table, boxes.to("meta"), mask.to("meta"), cfg)
    with pytest.raises(ValueError, match="stats"):
        K2.sort_scan(table, boxes, mask, cfg, stats=torch.zeros(len(K2.STATS), dtype=torch.int64))
    gid = torch.zeros(mask.shape, dtype=torch.int32)
    ident = K2.IdentityState(torch.zeros(16, dtype=torch.int32), torch.zeros(16),
                             torch.zeros(16, dtype=torch.int32), torch.zeros(16, dtype=torch.bool))
    with pytest.raises(ValueError, match="det_sim"):
        K2.track_scan(table, ident, boxes, mask, gid, gid, mask, cfg, 0.7, 1)
    with pytest.raises(ValueError, match="pending"):
        K2.track_scan(table, ident._replace(pending=ident.pending[:4]), boxes, mask, gid,
                      gid.float(), mask, cfg, 0.7, 1)


@pytest.mark.parametrize("t,k", [(1, 1), (64, 8), (64, 32), (192, 128), (256, 128), (192, 192),
                                 (512, 256), (1024, 64)])
def test_launch_plan_limits(t, k):
    """Every T, K >= 1 has a plan within the block's shared memory: the
    arrays that do not fit go to scratch (the cost first) or, for P and x,
    stay in the table; the main path's (64, 8) and the crowd's (192, 128)
    keep everything in shared memory."""
    plan = K2.launch_plan(t, k)
    assert plan.shared_bytes <= K2.MAX_SHARED_BYTES
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 32 * K2.MAX_WARPS
    assert len(plan.where) == len(plan.offsets) == len(K2.ARRAYS)
    spilled = plan.placed("scratch") + plan.placed("table")
    if (t, k) in ((1, 1), (64, 8), (64, 32), (192, 128)):
        assert spilled == () and plan.scratch_bytes == 0
    else:  # spilled in order: the cost before P before x
        order = [n for n in K2.SPILL_ORDER if n in spilled]
        assert order == list(K2.SPILL_ORDER[:len(order)]) and "cost" in plan.placed("scratch")
    assert set(plan.placed("table")) <= {"p", "x"}
    assert plan.chunk_frames > 0 and plan.chunk_frames * k % 16 == 0
    # the arrays in each space lie apart, 16-byte aligned, inside it
    for space, start, end in (("shared", K2.MISC_BYTES, plan.shared_bytes),
                              ("scratch", 0, plan.scratch_bytes)):
        spans = sorted((off, off + K2._array_bytes(n, t, k, plan.chunk_frames, w))
                       for n, w, off in zip(K2.ARRAYS, plan.where, plan.offsets) if w == space)
        for (lo, hi), nxt in zip(spans, spans[1:] + [(end, end)]):
            assert start <= lo and lo % 16 == 0 and hi <= nxt[0]


def test_launch_plan_reads_unstaged_detections_past_any_chunk():
    """K so large that even one frame's staging buffers do not fit beside
    the counters: every array leaves shared memory and the detections are
    read where they lie (chunk_frames 0)."""
    plan = K2.launch_plan(8, 8192)
    assert plan.chunk_frames == 0 and plan.shared_bytes <= K2.MAX_SHARED_BYTES
    assert plan.placed("shared") == ("chunks",) and plan.placed("table") == ("p", "x")


def test_launch_plan_refuses_nonpositive_sizes():
    for t, k in ((0, 8), (64, 0), (-1, 1)):
        with pytest.raises(ValueError, match="at least 1"):
            K2.launch_plan(t, k)


def test_a_failed_launch_raises_and_never_takes_the_plain_version(monkeypatch):
    """The wrapper's launch path with the kernel binding returning an
    error code (as a refused launch does): RuntimeError, nothing counted,
    and the plain loop never called."""
    cfg, boxes, mask = _small_case()
    table = TS.make_table(cfg)

    def plain(*args, **kw):
        raise AssertionError("the plain version was reached from a kernel launch")

    monkeypatch.setattr(K2, "sort_scan_plain", plain)
    monkeypatch.setattr(K2, "track_scan_plain", plain)
    monkeypatch.setattr(K2, "_kernel", lambda: (lambda *args: 20001))
    monkeypatch.setattr(K2, "raw_stream", lambda index: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    before = K2.launches
    with pytest.raises(RuntimeError, match="launch failed: code 20001"):
        K2._launch(table, boxes, mask, cfg)
    assert K2.launches == before


def test_module_imports_without_nvcc_or_gpu(tmp_path):
    """Importing the wrapper builds nothing and needs neither nvcc nor a
    card; a CPU scan runs the plain version."""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="", CUDA_HOME=str(tmp_path))
    code = ("import torch; from fire_tpu_torch.track import scan, sort; "
            "from fire_tpu_torch.config import TrackerConfig; c = TrackerConfig(max_tracks=8); "
            "t, o = scan.sort_scan(sort.make_table(c), torch.zeros(2, 4, 4), "
            "torch.zeros(2, 4, dtype=torch.bool), c); "
            "assert scan.launches == 0 and scan._fn is None and o.tid.shape == (2, 8); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
