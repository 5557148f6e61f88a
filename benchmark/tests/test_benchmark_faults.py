"""A run with the timed path broken underneath comes out not correct:
the rest of a run, with one fault planted in the program for each fault
a cell can have (an answer altered where it is produced; the tracker's
labels swapped between faces, or no encode for a new face; in the
four-card cell the exchange between cards left out; in the batched cell
half of each batch left out).  On the CPU at a small size, and on the
card at the cells' own size through ``fault_run.py`` (``cuda``)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cpu_cell import run_cpu
from harness import spec

LIVE = "yunet640-facenet512-g100k.live"
CARDS = "yunet640-facenet512-g100k.live-4cards"
CROWD = "yunet640-facenet512-g100k.crowd-b64"


def scores_altered(mp):
    from fire_tpu_torch.models.detections import Detections
    from fire_tpu_torch.pipeline.engine import DeviceEngine

    orig = DeviceEngine.detect

    def detect(self, frame, variant="detect"):
        d = orig(self, frame, variant)
        return Detections(d.boxes_xywh, d.landmarks, torch.where(d.mask, 0.91, d.scores), d.mask)
    mp.setattr(DeviceEngine, "detect", detect)


def embeddings_altered(mp):
    from fire_tpu_torch.pipeline.engine import DeviceEngine

    orig = DeviceEngine._encode_crops

    def enc(self, *a, **k):
        e = orig(self, *a, **k)
        return np.roll(e, 1, axis=1)
    mp.setattr(DeviceEngine, "_encode_crops", enc)


def top1_altered(mp):
    from fire_tpu_torch.gallery import index

    orig = index.cosine_top1

    def top1(q, g, count):
        sims, idx = orig(q, g, count)
        return sims, (idx + 1) % count
    mp.setattr(index, "cosine_top1", top1)


def four_shards_on_the_cpu(mp):
    """The four-card cell's mesh as four shards on the one CPU device."""
    from fire_tpu_torch.parallel import mesh
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition

    mp.setattr(FaceRecognition, "_default_mesh",
               lambda self: mesh.make_mesh(devices=[self.device] * 4))


def exchange_left_out(mp):
    """Each query answered from the first card's shard alone."""
    from fire_tpu_torch.ops.gallery_match import cosine_topk
    from fire_tpu_torch.parallel import sharded_gallery

    def local_only(m, queries, gallery, valid, k=1, axis="dp"):
        g = gallery[0]
        mask = torch.arange(g.shape[0], device=g.device) < int(valid)
        return cosine_topk(queries, g, mask, k)
    mp.setattr(sharded_gallery, "sharded_cosine_topk", local_only)


def labels_swapped(mp):
    """On every other frame the per-frame tracker hands each track's id,
    and so its label, to the next face of the frame."""
    from fire_tpu_torch.track.sort import Sort

    orig = Sort.update
    calls = [0]

    def update(self, dets):
        tracks = orig(self, dets)
        calls[0] += 1
        if calls[0] % 2:
            return tracks
        ids = [t["id"] for t in tracks]
        return [dict(t, id=ids[(i + 1) % len(ids)]) for i, t in enumerate(tracks)]
    mp.setattr(Sort, "update", update)


def encodes_skipped(mp):
    """The per-frame path never encodes a new face: every track counts as
    labelled already, as "Unknown"."""
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition

    class AllLabelled(dict):
        def __contains__(self, key):
            return True

        def __missing__(self, key):
            return "Unknown"

    orig = FaceRecognition.recognize_faces

    def recognize_faces(self, image, rename_label=None):
        if not isinstance(self.track_id_to_label, AllLabelled):
            self.track_id_to_label = AllLabelled()
        return orig(self, image, rename_label)
    mp.setattr(FaceRecognition, "recognize_faces", recognize_faces)


def batch_labels_swapped(mp):
    """The batched tracker's rows rotated among each frame's tracks."""
    from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine

    orig = BatchStreamEngine._unpack

    def unpack(self, read, b):
        r = orig(self, read, b)
        gid, sim = r.gid.copy(), r.sim.copy()
        for f in range(gid.shape[0]):
            on = np.nonzero(r.mask[f])[0]
            gid[f, on], sim[f, on] = np.roll(r.gid[f, on], 1), np.roll(r.sim[f, on], 1)
        return r._replace(gid=gid, sim=sim)
    mp.setattr(BatchStreamEngine, "_unpack", unpack)


def batch_encodes_skipped(mp):
    """The batched step labels and enrols no face."""
    from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine

    orig = BatchStreamEngine._unpack

    def unpack(self, read, b):
        r = orig(self, read, b)
        return r._replace(gid=np.full_like(r.gid, -1), enroll=np.zeros_like(r.enroll),
                          enroll_frame=np.full_like(r.enroll_frame, -1))
    mp.setattr(BatchStreamEngine, "_unpack", unpack)


def batch_sims_altered(mp):
    from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine

    orig = BatchStreamEngine._unpack

    def unpack(self, read, b):
        r = orig(self, read, b)
        return r._replace(sim=np.where(r.gid >= 0, r.sim - 0.05, r.sim).astype(np.float32))
    mp.setattr(BatchStreamEngine, "_unpack", unpack)


def half_batch_left_out(mp):
    from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine

    orig = BatchStreamEngine.step

    def step(self, engine, gal, count, state, frames, rung=None):
        h = frames.shape[0] // 2
        return orig(self, engine, gal, count, state, torch.cat([frames[:h], frames[:h]]), rung)
    mp.setattr(BatchStreamEngine, "step", step)


# faces that stay for the loop, so that each is tracked for many frames
# of the short window the CPU runs
STAY = {"turnover": 0.0, "count_walk": 0.0, "faces": [2, 3], "min_label_frames": 6}


@pytest.mark.parametrize("workload,fault", [
    (LIVE, scores_altered), (LIVE, embeddings_altered), (LIVE, top1_altered),
    (LIVE, labels_swapped), (LIVE, encodes_skipped), (CARDS, exchange_left_out),
    (CROWD, batch_sims_altered), (CROWD, half_batch_left_out), (CROWD, batch_labels_swapped),
    (CROWD, batch_encodes_skipped)])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    # enough rows that the enrolled ones land on the last of four shards;
    # for a batch's left-out half, faces that move as far between its
    # halves as in the cell's batch of 64 (32 frames at up to 4 px)
    rows = {"gallery_rows": 80_000} if workload == CARDS else {}
    if workload == CARDS:
        four_shards_on_the_cpu(monkeypatch)
    mix = {"batch_size": 16, "speed_px": 14} if fault is half_batch_left_out else {}
    if fault in (labels_swapped, encodes_skipped):
        mix = STAY
    out = run_cpu(workload, seconds=4.0, config=rows, mix=mix)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload,mix", [(LIVE, {}), (LIVE, STAY), (CARDS, {}), (CROWD, {})])
def test_sound_run_is_correct(workload, mix):
    out = run_cpu(workload, seconds=4.0, mix=mix)
    assert out["correct"] is True, (out["checks"], out["info"])


@pytest.fixture
def cards():
    """The number of cards, skipping without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.cuda.device_count()


ON_THE_CARD = [(LIVE, "labels_swapped"), (LIVE, "encodes_skipped"),
               ("retina512-facenet512-g100k.live", "labels_swapped"),
               (CARDS, "exchange_left_out")]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", ON_THE_CARD)
def test_fault_is_not_correct_on_the_card(cards, workload, fault):
    """At the cell's own size: the run comes out not correct."""
    if cards < spec.cell(spec.load_benchmark(), workload)["chips"]:
        pytest.skip(f"{workload} needs more cards than {cards}")
    p = subprocess.run([sys.executable, os.path.join(os.path.dirname(__file__), "fault_run.py"),
                        fault, "--workload", workload, "--seed", "2718281828", "--seconds", "5",
                        "--trace", "0"], capture_output=True, text=True, cwd=spec.ROOT,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    print(json.dumps({"workload": workload, "fault": fault, "checks": out["checks"]}))
    assert out["correct"] is False, out["checks"]
