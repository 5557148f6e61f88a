"""Whether the timed path's answers are right: the recorded answers of
the window against the plain reference (:mod:`reference.pipeline`).

A run is judged in two steps.  :func:`items` draws from the seed the
answers to judge out of what the window recorded; :func:`judge` has the
reference answer the same questions and returns the numbers compared.
Each stage is judged from its own inputs, the way a served model's
tokens are judged from the prompt and the tokens served before them:

* detection (per frame): the reference detects on the same frame; each
  detection is paired with the other side's by IoU, and the number is
  the gap of the score's logit (a detection the other side lacks counts
  with its margin over the threshold); the boxes' corner gaps, in
  pixels, are reported beside it;
* the encoder (per frame): the reference embeds the crops of the boxes
  the program encoded, and the number is ``1 - cos`` of the two;
* the gallery's top-1 (per frame): for each query the program answered,
  the reference's float64 similarities of the program's embedding to
  every row the gallery held then; the number is the wider of the gap
  between the program's similarity and the reference's for the row it
  named, and of how far that row lies below the reference's best;
* the batched step (whose detections and embeddings stay on the card):
  for each track that received its identity in the window, the
  reference runs detection, crop and encoder on the frame where it did,
  takes the detection that overlaps the track's box, and judges the row
  and similarity the program reported the same way; each enrolment's
  embedding is compared with the reference's of the same face;
* the labels every frame handed back (both paths), against the loop's
  ground truth (the rendered faces): how often a face's label changes
  from one frame to the next while it stays in view (a label swapped or
  carried to another face), and the share of faces visible for many
  frames in a row that never carried a label (encodes skipped).

Rows that the program appended to the gallery (enrolments) are its own
state: the reference takes them as the program wrote them and judges
each where it was made (the enrolment's embedding, above).  The seed's
rows are the benchmark's.  The control is the reference in float8 put
in the program's place (:func:`stand_in`): it answers the same items,
and :func:`judge` and :func:`correct` judge its answers unchanged; the
labels stay the program's tracker's.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from harness.drive import SEED_LABEL


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xywh boxes (N, 4) x (M, 4)."""
    ax2, ay2 = a[:, None, 0] + a[:, None, 2], a[:, None, 1] + a[:, None, 3]
    bx2, by2 = b[None, :, 0] + b[None, :, 2], b[None, :, 1] + b[None, :, 3]
    iw = np.clip(np.minimum(ax2, bx2) - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    ih = np.clip(np.minimum(ay2, by2) - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = iw * ih
    union = a[:, None, 2] * a[:, None, 3] + b[None, :, 2] * b[None, :, 3] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def _logit(p):
    p = np.clip(np.asarray(p, np.float64), 1e-7, 1 - 1e-7)
    return np.log(p) - np.log1p(-p)


def pair(a: np.ndarray, b: np.ndarray, min_iou: float = 0.5):
    """Greedy pairs (i, j) of boxes ``a`` and ``b`` by descending IoU."""
    if len(a) == 0 or len(b) == 0:
        return []
    m = _iou(a, b)
    out, used_a, used_b = [], set(), set()
    for flat in np.argsort(-m, axis=None, kind="stable"):
        i, j = divmod(int(flat), m.shape[1])
        if m[i, j] < min_iou:
            break
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        out.append((i, j))
    return out


def detection_gaps(prog_boxes, prog_scores, ref_boxes, ref_scores, threshold: float):
    """The score-logit gap of each of one frame's detections and the
    widest corner gap (px) of each pair.  A detection without a partner
    counts with its logit's margin over the threshold, unless it
    overlaps a paired detection (a box NMS kept on one side beside the
    pair's: a rounding tie)."""
    pairs = pair(prog_boxes, ref_boxes)
    logit_gap, box_gap = [], []
    for i, j in pairs:
        logit_gap.append(abs(float(_logit(prog_scores[i]) - _logit(ref_scores[j]))))
        box_gap.append(float(np.abs(prog_boxes[i] - np.trunc(ref_boxes[j])).max()))
    t = float(_logit(threshold))
    for boxes, scores, taken, other in ((prog_boxes, prog_scores, {p[0] for p in pairs},
                                         ref_boxes[[p[1] for p in pairs]]),
                                        (ref_boxes, ref_scores, {p[1] for p in pairs},
                                         prog_boxes[[p[0] for p in pairs]])):
        for i in range(len(boxes)):
            if i in taken:
                continue
            if len(other) and _iou(boxes[i : i + 1], other).max() > 0.1:
                continue
            logit_gap.append(float(_logit(scores[i])) - t)
    return logit_gap, box_gap


def _sample(rng: np.random.Generator, n: int, k: int, must: Optional[int] = None) -> List[int]:
    """``k`` of ``range(n)`` drawn from ``rng``, with ``must`` among them."""
    if n <= k:
        return list(range(n))
    pick = set(rng.choice(n, size=k, replace=False).tolist())
    if must is not None and must not in pick:
        pick.pop()
        pick.add(must)
    return sorted(pick)


def match_gaps(s_ref: np.ndarray, ids, sims) -> np.ndarray:
    """How far each answer ``(id, sim)`` lies from the reference's
    similarities ``s_ref`` (Q, R): the wider of the gap between the
    reported similarity and the reference's for the row it names, and of
    how far that row lies below the reference's best."""
    named = s_ref[np.arange(len(ids)), ids]
    return np.maximum(np.abs(np.asarray(sims) - named), s_ref.max(axis=1) - named)


def _born_labelled(batches, batch: int, loop_len: int):
    """Tracks born in the window that took a gallery row at birth, when
    the track's box is its detection's (truncated to pixels):
    ``(loop frame, box xywh, row, similarity, batch index)``."""
    if not batches:
        return []
    seen = set(int(t) for t in batches[0].tid[0])
    items = []
    for j, res in enumerate(batches):
        for f in range(res.tid.shape[0]):
            for s in range(res.tid.shape[1]):
                tid = int(res.tid[f, s])
                if tid in seen:
                    continue
                seen.add(tid)
                box = res.boxes[f, s].astype(np.float64)
                if res.gid[f, s] >= 0 and box[2] > 0 and box[3] > 0:
                    items.append(((j * batch + f) % loop_len, box, int(res.gid[f, s]),
                                  float(res.sim[f, s]), j))
    return items


def _enrolments(batches, batch: int, loop_len: int):
    """Each enrolment of the window: ``(loop frame, track box, unit
    embedding)``."""
    items = []
    for j, res in enumerate(batches):
        for e in range(len(res.enroll_frame)):
            f = int(res.enroll_frame[e])
            if f < 0:
                continue
            s = int(res.enroll_slot[e])
            v = res.enroll_emb[e].astype(np.float64)
            n = np.linalg.norm(v)
            if n > 0:
                items.append(((j * batch + f) % loop_len, res.boxes[f, s].astype(np.float64),
                              v / n))
    return items


def _face(ref, frame, fidx, track_box, cache):
    """The reference's detection box of the face under ``track_box``
    (None when no detection overlaps it by half), taken at a score
    threshold of 0.5 so that a face the program found just above the
    configuration's threshold is still found; ``cache`` keeps each
    frame's detections."""
    key = (id(ref), fidx)
    if key not in cache:
        cache[key] = ref.detect(frame, threshold=0.5)
    d = cache[key]
    p = pair(track_box[None], d["boxes"])
    return d["boxes"][p[0][1]] if p else None


def _label_items(loop, rec, n_rows: int, min_frames: int, reach: float, memory: int) -> dict:
    """The labels the frames handed back, against the loop's ground
    truth.  Each labelled box is paired with the rendered face it covers.
    An enrolled row belongs to the identity of the face that first
    carried its label (the face it was enrolled for); a seed row to
    none.  Over the window's frames: ``label_changes``, the share of a
    face's steps from one labelled frame to the next in which its label
    changed (a track keeps its label for its life), and
    ``unlabelled_actors`` (see :func:`items`); printed beside them, how
    many of the distinct (face, row) pairs name a row enrolled for
    another identity (``wrong_pairs``: the network takes some faces of
    two identities for one above the threshold, so this is no fault).
    The warm-up's pass of the loop, which the window continues, is read
    first for the rows' identities and the faces' visits.

    A face that appears within ``reach`` pixels (centre to centre) of
    one that vanished at most ``memory`` frames before may take over the
    track that still coasts there, and with it that face's label: the
    tracker pairs a detection with a track by overlap and distance, as
    SORT does.  Such a visit's labels are the tracker's to give and are
    not judged.  A box that covers no rendered face (a track coasting on
    after its face has gone) is counted, not judged."""
    enrolled = {lab: n_rows + k for k, lab in enumerate(rec.added_labels)}

    def row_of(label):
        if label in enrolled:
            return enrolled[label]
        if label.startswith(SEED_LABEL) and label[len(SEED_LABEL):].isdigit():
            return int(label[len(SEED_LABEL):])
        return None  # "Unknown"

    identity: Dict[int, int] = {}  # enrolled row -> the identity it was enrolled for
    pairs: Dict[tuple, bool] = {}  # (actor, row) -> the row was enrolled for another identity
    # actor -> [window frames, labelled in the window, taken over, in the window, last row]
    # of its visit
    runs: Dict[int, list] = {}
    steps = changes = 0             # a face's label from one frame to its next, in the window
    visits: List[list] = []
    last: Dict[int, np.ndarray] = {}  # actor -> its box's centre when last seen
    gone: List[tuple] = []         # (frame number, centre) of faces that vanished
    boxes_n = stray = 0
    recorded = [(x, False) for x in rec.warm_labels] + [(x, True) for x in rec.labels]
    for k, ((fidx, faces, _n_added), judged) in enumerate(recorded):
        truth = loop.truth[fidx]
        centres = {int(t[0]): t[2:4] + t[4:6] / 2 for t in truth}
        for a in set(runs) - set(centres):
            v = runs.pop(a)
            if v[3]:
                visits.append(v)
            gone.append((k, last[a]))
        gone = [g for g in gone if k - g[0] <= memory]
        for a, c in centres.items():
            if a not in runs:
                runs[a] = [0, False, any(np.hypot(*(c - g[1])) <= reach for g in gone), False,
                           None]
            runs[a][0] += judged
            runs[a][3] |= judged
        last.update(centres)
        boxes = np.asarray([f[0] for f in faces], np.float64).reshape(-1, 4)
        paired = dict(pair(boxes, truth[:, 2:6], min_iou=0.3))
        if judged:
            boxes_n += len(faces)
            stray += len(faces) - len(paired)
        labelled = set()
        for i, j in paired.items():
            row = row_of(faces[i][1])
            if row is None:
                continue
            actor, ident = int(truth[j, 0]), int(truth[j, 1])
            labelled.add(actor)
            if row >= n_rows:
                identity.setdefault(row, ident)
            v = runs[actor]
            if judged:
                v[1] = True
                if not v[2]:
                    pairs.setdefault((actor, row), identity.get(row) != ident)
                if v[4] is not None:
                    steps += 1
                    changes += row != v[4]
            v[4] = row
        for a in set(runs) - labelled:
            runs[a][4] = None
    visits.extend(v for v in runs.values() if v[3])
    long = [v for v in visits if v[0] >= min_frames]
    return {"label_changes": changes / steps if steps else 0.0,
            "unlabelled_actors": sum(not v[1] for v in long) / len(long) if long else 0.0,
            "label_counts": {"faces": boxes_n, "stray": stray, "visits": len(long),
                             "taken_over": sum(v[2] for v in visits), "steps": steps,
                             "changes": changes, "pairs": len(pairs),
                             "wrong_pairs": sum(pairs.values())}}


def items(mode: str, loop, rec, n_rows: int, cfg: dict, mix: dict, rng,
          n_items: int) -> dict:
    """The answers of the window to judge, drawn from ``rng``.

    Per frame: ``dets`` (loop frame, boxes, scores) with the frame of
    most faces among them, ``encs`` (loop frame, boxes, embeddings,
    (ids, sims, rows held) of the frame's query or None) likewise.
    Batched: ``born`` (loop frame, track box, row, similarity, rows
    held) and ``enrols`` (loop frame, track box, unit embedding).  Both:
    ``label_changes`` (see :func:`_label_items`) and
    ``unlabelled_actors``, the share of the faces' visits (frames in a
    row in which one face is visible) of ``min_label_frames`` frames or
    more in the window in which that face never carried a gallery
    label."""
    out = {"n_rows": n_rows}
    if mode == "per_frame":
        most = int(np.argmax([len(d[1]) for d in rec.dets])) if rec.dets else None
        out["dets"] = [rec.dets[i] for i in _sample(rng, len(rec.dets), n_items, most)]
        queries = {q[0]: q for q in rec.queries}
        most = int(np.argmax([len(e[1]) for e in rec.encs])) if rec.encs else None
        out["encs"] = []
        for i in _sample(rng, len(rec.encs), n_items, most):
            fidx, boxes, emb, step = rec.encs[i]
            q = queries.get(step)
            q = (q[1], q[2], n_rows + q[3]) if q is not None and len(q[1]) == len(emb) else None
            out["encs"].append((fidx, boxes, emb, q))
    else:
        b, n = mix["batch_size"], len(loop.frames)
        tracks = _born_labelled(rec.batches, b, n)
        out["born"] = [tracks[i][:4] + (n_rows + rec.submits[tracks[i][4]],)
                       for i in _sample(rng, len(tracks), n_items)]
        enrols = _enrolments(rec.batches, b, n)
        out["enrols"] = [enrols[i] for i in _sample(rng, len(enrols), max(1, n_items // 3))]
    out.update(_label_items(loop, rec, n_rows, int(mix["min_label_frames"]),
                            float(cfg["max_distance"]), int(cfg["max_age"]) + 1))
    return out


def stand_in(ctrl, loop, it: dict) -> dict:
    """The same items answered by ``ctrl`` (the control) in the
    program's place: its detections, its embeddings of the same boxes,
    its top-1 over the same rows; for the batched step its own detection
    under each track's box.  What the tracker did (which boxes carried
    labels) stays the program's."""
    out = dict(it)
    cache: dict = {}
    fr = loop.frames
    if "dets" in it:
        out["dets"] = []
        for fidx, _b, _s in it["dets"]:
            d = ctrl.detect(fr[fidx])
            out["dets"].append((fidx, np.trunc(d["boxes"]), d["scores"]))
        out["encs"] = []
        for fidx, boxes, _e, q in it["encs"]:
            emb = ctrl.embed(fr[fidx], boxes)
            if q is not None:
                s = ctrl.sims(emb, q[2])
                ids = np.argmax(s, axis=1)
                q = (ids, s[np.arange(len(ids)), ids], q[2])
            out["encs"].append((fidx, boxes, emb, q))
    if "born" in it:
        out["born"] = []
        for fidx, box, _g, _s, n_at in it["born"]:
            sbox = _face(ctrl, fr[fidx], fidx, box, cache)
            gid, sim = -1, 0.0
            if sbox is not None:
                s = ctrl.sims(ctrl.embed(fr[fidx], sbox[None]), n_at)[0]
                gid, sim = int(np.argmax(s)), float(s.max())
            out["born"].append((fidx, box, gid, sim, n_at))
        out["enrols"] = []
        for fidx, box, v in it["enrols"]:
            sbox = _face(ctrl, fr[fidx], fidx, box, cache)
            v = ctrl.embed(fr[fidx], sbox[None])[0] if sbox is not None else np.zeros_like(v)
            out["enrols"].append((fidx, box, v))
    return out


# numbers taken as the mean over their items (the rest: the widest).
# The detection and top-1 numbers: the widest detection gap is ruled by
# the few scores at the flat end of their sigmoid or softmax, where one
# rounding of a logit moves it by a tenth, the widest per-frame top-1
# gap by rows enrolled twice for one face, whose similarities tie within
# rounding, and the widest batched one by the reference's box lying a
# few pixels from the program's (it cannot crop the box the program's
# detector gave, which stays on the card).
MEAN = ("det_logit_gap", "match_gap")


def judge(ref, loop, it: dict, cfg: dict):
    """The numbers of the answers in ``it`` against ``ref``: (numbers,
    counts).  The counts say how many items were judged, how many the
    reference found no face for (``unpaired``), and for every number its
    count, mean, median, 90th percentile and widest (``spread``)."""
    vals: Dict[str, list] = {k: [] for k in ("det_logit_gap", "emb_cos_gap", "match_gap",
                                             "enrol_cos_gap", "det_box_px")}
    counts = {"judged": 0, "unpaired": 0, **it["label_counts"]}
    fr = loop.frames
    cache: dict = {}
    for fidx, boxes, scores in it.get("dets", ()):
        r = ref.detect(fr[fidx])
        lg, bg = detection_gaps(boxes, scores, r["boxes"], r["scores"], cfg["det_threshold"])
        vals["det_logit_gap"].extend(lg)
        vals["det_box_px"].extend(bg)
        counts["judged"] += 1
    for fidx, boxes, emb, q in it.get("encs", ()):
        e_ref = ref.embed(fr[fidx], boxes)
        cos = np.sum(e_ref * emb, axis=1) / np.linalg.norm(emb, axis=1)
        vals["emb_cos_gap"].extend((1.0 - cos).tolist())
        counts["judged"] += len(boxes)
        if q is not None:
            vals["match_gap"].extend(match_gaps(ref.sims(emb, q[2]), q[0], q[1]).tolist())
    for fidx, box, gid, sim, n_at in it.get("born", ()):
        rbox = _face(ref, fr[fidx], fidx, box, cache)
        if rbox is None or gid < 0:
            counts["unpaired"] += 1
            vals["match_gap"].append(1.0)
            continue
        s_ref = ref.sims(ref.embed(fr[fidx], rbox[None]), n_at)
        vals["match_gap"].extend(match_gaps(s_ref, [gid], [sim]).tolist())
        counts["judged"] += 1
    for fidx, box, v in it.get("enrols", ()):
        rbox = _face(ref, fr[fidx], fidx, box, cache)
        if rbox is None:
            counts["unpaired"] += 1
            vals["enrol_cos_gap"].append(1.0)
            continue
        vals["enrol_cos_gap"].append(float(1.0 - ref.embed(fr[fidx], rbox[None])[0] @ v))
        counts["judged"] += 1
    numbers = {k: (float(np.mean(v)) if k in MEAN else float(max(v))) if v else 0.0
               for k, v in vals.items() if k != "det_box_px"}
    numbers["label_changes"] = float(it["label_changes"])
    numbers["unlabelled_actors"] = float(it["unlabelled_actors"])
    counts["spread"] = {k: [len(v), float(np.mean(v)), float(np.median(v)),
                            float(np.percentile(v, 90)), float(max(v))]
                        for k, v in vals.items() if v}
    return numbers, counts


def checks(numbers: dict, limits: dict) -> dict:
    """Each number the configuration limits, beside its limit."""
    return {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}


def correct(checked: dict, counts: dict) -> bool:
    """Some items judged, a face found for each, every number within its
    limit."""
    return (counts["judged"] > 0 and not counts["unpaired"]
            and all(c["value"] <= c["limit"] for c in checked.values()))
