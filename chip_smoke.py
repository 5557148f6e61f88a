#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``fire_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, one card

It takes no arguments.  Phases, in order, each printing one JSON line:

1. ``env``: torch / CUDA versions, the card's name and power limit.
2. ``build``: compiles kernel K1 (``fire_tpu_torch/csrc/cosine_top1.cu``)
   with nvcc for sm_90a.
3. ``kernels``: K1 against its plain PyTorch version on the card at the
   batched path's shapes (M queries × the 100,352-row padded gallery ×
   512), with kernel, plain, library and bound times.
4. ``main_path``: ``FaceRecognition.process_frames(batch_size=64)`` at full
   width (YuNet-64 at 640², FaceNet-512, 99,900-row gallery, committed
   trained weights) over rendered 1-face 1080p scenes; K1's launch count
   is set to 0 just before and read just after.  One more batch then runs
   under ``torch.profiler`` for the device's busy time and its idle share
   of that batch's wall time (a ``trace`` line).
5. ``cross_device``: one 8-frame batched step on the card and on the CPU
   in float32, compared.

Any failed check raises and the script exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Nothing of JAX or ``fire_tpu`` is
imported.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "build", "kernels", "main_path", "cross_device")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 and dense bf16.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

N_GALLERY = 99_900
PADDED_ROWS = 100_352  # DeviceGallery pads 100,000 to 49 × 2048
DIM = 512
BATCH = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def k1_bound_ms(m: int, count: int) -> tuple:
    """Least time on the card for this call's work: the live gallery
    rows and the bf16 queries read once, the outputs written once, and
    2·M·count·D FLOP at the dense bf16 rate."""
    nbytes = count * DIM * 2 + m * DIM * 2 + m * 8
    flops = 2.0 * m * count * DIM
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def unit_rows(rng, n: int, d: int):
    import numpy as np

    g = rng.standard_normal((n, d)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    return g


# ------------------------------------------------------------------ phases --


def phase_env(ctx) -> None:
    import torch

    ctx["smi"] = nvidia_smi_line()
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": ctx["smi"]})


def phase_build(ctx) -> None:
    from fire_tpu_torch.ops import cosine_top1 as k1

    lib = k1.library_path()
    if os.path.exists(lib):
        os.remove(lib)  # always prove the build from the checkout's source
    t0 = time.time()
    k1.build()
    secs = time.time() - t0
    ptxas = [ln.strip() for ln in k1.build_log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "kernel": k1.NAME, "arch": "sm_90a", "seconds": round(secs, 3),
          "ptxas": ptxas})


def phase_kernels(ctx) -> None:
    import numpy as np
    import torch

    from fire_tpu_torch.ops import cosine_top1 as k1

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gal = torch.from_numpy(unit_rows(rng, PADDED_ROWS, DIM)).to(dev)
    gal[N_GALLERY:] = 0.0  # padding rows, as in DeviceGallery
    g16 = gal.to(torch.bfloat16)
    results = []

    def one(name, q, g, count, time_it):
        launches0 = k1.launches
        sims, idx = k1.cosine_top1(q, g, count)
        torch.cuda.synchronize()
        ps, pi = k1.plain_cosine_top1(q, g, count)
        # top-2 gap of the plain product: the index must agree wherever
        # the best row wins by more than the sims' tolerance
        full = q.to(torch.bfloat16).float() @ g.to(torch.bfloat16).float().T
        full[:, count:] = -2.0
        top2 = torch.topk(full, 2, dim=1).values
        gap = top2[:, 0] - top2[:, 1]
        err = float((sims - ps).abs().max())
        decisive = gap > 1e-3
        idx_ok = bool((idx[decisive] == pi[decisive]).all())
        check(err <= 1e-3, f"K1 {name}: sims differ from the plain version by {err}")
        check(idx_ok, f"K1 {name}: index differs from the plain version")
        rec = {"case": name, "M": int(q.shape[0]), "N": int(g.shape[0]), "D": DIM,
               "count": count, "max_abs_err": err, "index_equal_where_decisive": idx_ok}
        if time_it:
            reps = 20 if q.shape[0] <= 256 else 5
            qb, gb = q.to(torch.bfloat16), g
            rec["kernel_ms"] = cuda_ms(lambda: k1.cosine_top1(q, g, count), reps)
            rec["plain_ms"] = cuda_ms(lambda: k1.plain_cosine_top1(q, g, count), reps)
            rec["library_ms"] = cuda_ms(
                lambda: torch.max(torch.matmul(qb, gb[:count].T), dim=1), reps)
            rec["bound_ms"], rec["bound_by"] = k1_bound_ms(int(q.shape[0]), count)
        rec["launches"] = k1.launches - launches0
        results.append(rec)
        emit({"phase": "kernels", "kernel": k1.NAME, **rec})

    for m in (1, 64, 128, 256, 2048):
        q = torch.from_numpy(unit_rows(rng, m, DIM)).to(dev)
        one(f"M={m}", q, g16, N_GALLERY, time_it=True)
    q = torch.from_numpy(unit_rows(rng, 128, DIM)).to(dev)
    one("count=0", q, g16, 0, time_it=False)
    one("count=12345", q, g16, 12_345, time_it=False)
    s0, i0 = k1.cosine_top1(q, g16, 0)
    check(bool((s0 == -2.0).all()) and bool((i0 == 0).all()), "K1 count=0: not (-2, 0)")
    # ties: duplicated rows, in the same and in a far chunk, after the
    # original; a query equal to the row must get the lowest index
    dup = gal.clone()
    picks = torch.tensor([5, 50_000, 70_000], device=dev)
    dup[picks + 17] = dup[picks]
    dup[picks + 25_000] = dup[picks]
    sims, idx = k1.cosine_top1(dup[picks], dup.to(torch.bfloat16), N_GALLERY)
    check(idx.tolist() == picks.tolist(), f"K1 ties: {idx.tolist()} != {picks.tolist()}")
    results.append({"case": "ties", "idx": idx.tolist()})
    emit({"phase": "kernels", "kernel": k1.NAME, "case": "ties", "idx": idx.tolist()})
    ctx["k1"] = results


def _frames(seed: int, n_scenes: int, per_scene: int):
    import numpy as np

    from fire_tpu_torch.train.scenes import compose_scene, make_identities

    idents = make_identities(8, seed=seed)
    rng = np.random.default_rng(seed)
    scenes = [compose_scene(rng, idents, hw=(1080, 1920), n_faces=(1, 1), face_px=(180, 360))[0]
              for _ in range(n_scenes)]
    return [s for s in scenes for _ in range(per_scene)]


def _gallery_rows():
    import numpy as np

    g = unit_rows(np.random.default_rng(0), N_GALLERY, DIM)
    return [(i + 1, f"person_{i}", g[i].tobytes()) for i in range(N_GALLERY)]


def phase_main_path(ctx) -> None:
    import torch

    from fire_tpu_torch.config import TrackerConfig
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition

    wt = os.path.join(REPO, "weights_trained")
    storage = ctx["tmp"]
    fr = FaceRecognition(
        detector_type="yunet", encoder_model_type="512", similarity_threshold=0.7,
        unknown_trigger_count=1, detection_interval=1, enable_logging=False,
        storage_root=storage, tracker_cfg=TrackerConfig(assignment="hungarian"),
        trained_detector=os.path.join(wt, "yunet_synth.msgpack"),
        trained_encoder=os.path.join(wt, "facenet512_synth.msgpack"), device="cuda")
    fr.gallery.load_rows(_gallery_rows())
    check(fr.gallery.count == N_GALLERY and fr.gallery.padded == PADDED_ROWS, "gallery size")

    # warm-up batch (cuDNN plans, allocator) on other identities
    fr.process_frames(_frames(seed=1, n_scenes=2, per_scene=BATCH // 2), annotate=False,
                      batch_size=BATCH)
    sql_before = fr.db_manager.count()

    per_scene = 32
    frames = _frames(seed=0, n_scenes=2 * BATCH // per_scene, per_scene=per_scene)
    faces_per_frame = []
    k1.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr.process_frames(frames, annotate=False, batch_size=BATCH,
                      on_frame=lambda f, faces: faces_per_frame.append(len(faces)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.launches
    n_batches = len(frames) // BATCH
    sql_after = fr.db_manager.count()

    # warm-up: a scene's first min_hits frames carry no confirmed track
    warm = TrackerConfig().min_hits
    after = [n for i, n in enumerate(faces_per_frame) if i % per_scene >= warm]
    tracked = sum(1 for n in after if n > 0) / max(len(after), 1)
    check(len(faces_per_frame) == len(frames), "every frame produced a result")
    check(launches >= n_batches, f"K1 launched {launches} times for {n_batches} batches")
    check(tracked >= 0.9, f"faces tracked in {tracked:.3f} of the frames after warm-up")
    check(sql_after > sql_before, "enrolments reached SQLite")
    totals = fr.timer.totals
    stages = {k: round(v / n_batches * 1e3, 3) for k, v in totals.items()}
    rec = {"phase": "main_path", "frames": len(frames), "batch": BATCH, "batches": n_batches,
           "frames_per_s": len(frames) / wall, "wall_s": wall, "k1_launches": launches,
           "tracked_fraction": tracked, "sqlite_rows_added": sql_after - sql_before,
           "gallery_count": fr.gallery.count, "stage_ms_per_batch": stages,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    ctx["k1_launches"] = launches
    emit(rec)
    try:
        trace = trace_one_batch(fr, _frames(seed=3, n_scenes=2, per_scene=BATCH // 2))
    finally:
        fr.close()
    emit(trace)


def trace_one_batch(fr, frames) -> dict:
    """One more batch of the main path under ``torch.profiler``: the
    device's busy time (the union of its kernel and copy intervals), its
    idle share of the traced wall time, and the kernels that take the
    most device time.  A trace that holds no device activity is reported
    as not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fr.process_frames(frames, annotate=False, batch_size=BATCH)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in dev:
        name = e.name[:80]
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy_ms = busy_us / 1e3 if dev else None
    return {"phase": "trace", "frames": len(frames), "traced_wall_ms": wall_ms,
            "device_events": len(dev), "device_busy_ms": busy_ms,
            "idle_share_traced": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
            "top_device_ms": {k: v / 1e3 for k, v in top}}


def phase_cross_device(ctx) -> None:
    import numpy as np
    import torch

    from fire_tpu_torch.config import EngineConfig, RecognizerConfig
    from fire_tpu_torch.gallery.index import DeviceGallery
    from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine
    from fire_tpu_torch.pipeline.engine import DeviceEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    wt = os.path.join(REPO, "weights_trained")
    cfg = RecognizerConfig(
        detector_type="yunet", encoder_model_type="512", similarity_threshold=0.7,
        unknown_trigger_count=1, detection_interval=1, weights_dir=None,
        engine=EngineConfig(compute_dtype="float32", strict_f32_preprocess=True),
    ).with_embedding_dim()
    frames = np.stack(_frames(seed=2, n_scenes=1, per_scene=8))
    rows = _gallery_rows()
    sides = {}
    for dev in ("cuda", "cpu"):
        eng = DeviceEngine(cfg, device=dev)
        eng.load_trained_detector(os.path.join(wt, "yunet_synth.msgpack"))
        eng.load_trained_encoder(os.path.join(wt, "facenet512_synth.msgpack"))
        gal = DeviceGallery(DIM, device=dev)
        gal.load_rows(rows)
        sides[dev] = (BatchStreamEngine(eng, gal, cfg), gal)

    def run_both():
        out = {d: bse.process_batch(frames) for d, (bse, _) in sides.items()}
        a, b = out["cuda"], out["cpu"]
        for f in ("tid", "gid", "mask", "enroll"):
            check(np.array_equal(getattr(a, f), getattr(b, f)), f"cross_device: {f} differs")
        box_err = int(np.abs(a.boxes.astype(np.int64) - b.boxes).max())
        sim_err = float(np.abs(a.sim - b.sim).max())
        check(box_err <= 1, f"cross_device: boxes differ by {box_err} px")
        check(sim_err <= 2e-3, f"cross_device: sims differ by {sim_err}")
        return a, b, box_err, sim_err

    a, b, be1, se1 = run_both()
    check(bool(a.mask.any()) and bool(a.enroll.any()), "cross_device: the face was tracked and flagged")
    # second round: the flagged face enrolled on both sides → it matches
    emb = b.enroll_emb[int(np.nonzero(b.enroll_frame >= 0)[0][0])]
    for bse, gal in sides.values():
        gal.add(emb, "probe", N_GALLERY + 1)
        bse.reset()
    a, b, be2, se2 = run_both()
    check(bool((a.gid[a.mask] == N_GALLERY).any()), "cross_device: the enrolled face matched")
    emit({"phase": "cross_device", "frames": len(frames), "dtype": "float32", "tf32": False,
          "box_err_px": max(be1, be2), "sim_err": max(se1, se2),
          "matched_gid": N_GALLERY})


# -------------------------------------------------------------------- main --


def kernel_summary(ctx) -> dict:
    """The contract line: K1 at the main path's shape (M = one query per
    frame of a 64-frame batch, the smallest compaction rung)."""
    from fire_tpu_torch.ops import cosine_top1 as k1

    main = next(r for r in ctx["k1"] if r.get("case") == f"M={BATCH}")
    worst = max(r["max_abs_err"] for r in ctx["k1"] if "max_abs_err" in r)
    return {"kernels": [{
        "name": k1.NAME, "route": "cuda", "source": "fire_tpu_torch/csrc/cosine_top1.cu",
        "replaces": "fire_tpu/ops/pallas_topk.py:61", "launches": ctx["k1_launches"],
        "max_abs_err": worst, "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"]}]}


def main() -> int:
    if len(sys.argv) > 1:
        print(f"chip_smoke.py takes no arguments: {sys.argv[1:]}", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "fire_tpu_torch")):
        print("chip_smoke.py: fire_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    ctx = {"tmp": tempfile.mkdtemp(prefix="fire_chip_smoke_")}
    try:
        for name in PHASES:
            globals()[f"phase_{name}"](ctx)
    finally:
        shutil.rmtree(ctx["tmp"], ignore_errors=True)
    print(json.dumps(kernel_summary(ctx)))
    print(ctx["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
