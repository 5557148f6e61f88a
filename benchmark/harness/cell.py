"""One run of one cell: set-up, the measured window, the metrics, and
the comparison with the reference that decides ``correct``."""

from __future__ import annotations

import gc
import time
from typing import Optional

import numpy as np
import torch

from harness import check, drive, spec, trace, traffic, work
from reference.pipeline import Reference


def _record(mode: str, cfg: dict, mix: dict, loop, res: dict, rec, tracer, setup_s: float,
            macs: dict) -> dict:
    """What the metric readers read: the measured window's timings, the
    traced batches' or frames' summary, and the work the inputs
    needed."""
    faces = loop.faces_per_frame()
    enc_k = cfg["encode_k"] if mode == "batched" else cfg["max_faces"]
    idx = np.asarray(res["loop_idx"], np.int64)
    n = int(res["measured"])
    encoded = np.minimum(faces[idx[:n]], enc_k)
    rows = cfg["gallery_rows"] + len(rec.added)
    r = {"mode": mode, "setup_s": setup_s, "window_s": res["window_s"], "measured": n,
         "work": {"detector_macs": macs["detector"], "encoder_macs": macs["encoder"],
                  "frames": n, "faces": int(encoded.sum()), "gallery_rows": rows,
                  "dim": 512, "batch": mix.get("batch_size", 1), "encode_k": enc_k,
                  "tracks": cfg["max_tracks"]}}
    if mode == "per_frame":
        r["latency_ms"] = [x * 1e3 for x in res["latency_s"]]
        r["stages_ms"] = {k: [x * 1e3 for x in v] for k, v in res["stages_s"].items()}
    else:
        r["timer_ms"] = {k: v * 1e3 for k, v in res["timer_s"].items()}
        r["timed_batches"] = res["timed_batches"]
    r["trace"] = None
    if tracer.prof is not None:
        summ = trace.summarize(tracer.prof, tracer.t1 - tracer.t0)
        summ["k1_s"] = trace.kernel_seconds(summ, work.K1_KERNELS)
        summ["k2_s"] = trace.kernel_seconds(summ, work.K2_KERNELS)
        traced = idx[n:]
        b = mix.get("batch_size", 1)
        per_batch = [int(np.minimum(faces[traced[i : i + b]], enc_k).sum())
                     for i in range(0, len(traced), b)]
        summ["k1_bound_s"] = sum(work.k1_bound_s(m, rows, 512) for m in per_batch if m)
        summ["k2_bound_s"] = (len(traced) // b) * work.k2_bound_s(b, cfg["max_tracks"], enc_k)
        summ["frames"] = int(len(traced))
        r["trace"] = summ
    return r


def run(workload: str, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda", control: bool = False, overrides: Optional[dict] = None,
        bench: Optional[dict] = None, root: str = spec.ROOT) -> dict:
    """Run ``workload`` once; returns the result object the command
    prints (with ``control`` the control's numbers beside it)."""
    bench = bench or spec.load_benchmark(root)
    w = spec.cell(bench, workload)
    cfg = spec.config(bench, w["config"], root)
    mix = spec.mix(w["traffic"])
    ov = overrides or {}
    cfg.update(ov.get("config", {}))
    mix.update(ov.get("mix", {}))
    mode = mix["mode"]
    device = torch.device(device)

    rec = drive.Recorder()
    rec.install()
    phases = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    loop = traffic.render(mix, seed, device)
    phases["traffic"] = time.perf_counter() - t
    errors = drive.ErrorCount()
    with drive.quiet_program_logs(errors):
        t = time.perf_counter()
        system = drive.System(cfg, w["chips"], seed, root, device, ov.get("engine"))
        phases["system"] = time.perf_counter() - t
        t = time.perf_counter()
        drive.warm_up(system, loop, mix, rec)
        drive._sync_all()
        phases["warm_up"] = time.perf_counter() - t
        setup_s = time.perf_counter() - t_start
        enrolled_before = len(rec.added)
        tracer = drive.Tracer(traced)
        if mode == "batched":
            res = drive.window_batched(system, loop, rec, seconds, mix["batch_size"], tracer,
                                       mix["trace_batches"])
        else:
            res = drive.window_per_frame(system, loop, rec, seconds, tracer,
                                         mix["trace_frames"])
        drive._sync_all()
    peak = drive.memory_peak_bytes()
    macs = work.network_macs(cfg["detector"], cfg["input_px"])
    record = _record(mode, cfg, mix, loop, res, rec, tracer, setup_s, macs)
    rows = system.rows
    system.close()
    del system
    tracer.prof = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison, after the window, with the program's state freed
    t_check = time.perf_counter()
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 0xC4EC])
    it = check.items(mode, loop, rec, len(rows), cfg, mix, rng, int(mix["check_items"]))
    ref = Reference(cfg, root, device)
    ref.set_gallery(rows, rec.added)
    numbers, counts = check.judge(ref, loop, it, cfg)
    limits = cfg["limits"][mode]
    checks = check.checks(numbers, limits)
    correct = check.correct(checks, counts) and res["failed"] == 0 and errors.n == 0
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"] + errors.n)}
    out["metrics"] = spec.read_metrics(bench, workload,
                                       "per_layer" if traced else "end_to_end", record)
    out["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                     "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                     "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
    if record["trace"] is not None:
        t = record["trace"]
        out["device"]["busy_s"] = t["busy_s"]
        out["device"]["window_s"] = t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    info = {"check_s": None, "counts": counts, "errors": errors.n, "last_error": errors.last,
            "enrolled": [enrolled_before, len(rec.added) - enrolled_before],
            "faces_per_frame": float(loop.faces_per_frame().mean()), "setup_phases_s": phases,
            "measured": res["measured"], "window_s": res["window_s"],
            "batch_s": res.get("batch_s")}
    if control:
        ctrl = Reference(cfg, root, device, quant="fp8")
        ctrl.set_gallery(rows, rec.added)
        c_numbers, c_counts = check.judge(ref, loop, check.stand_in(ctrl, loop, it), cfg)
        info["control"] = {"numbers": c_numbers, "counts": c_counts,
                           "correct": check.correct(check.checks(c_numbers, limits), c_counts)}
    info["check_s"] = time.perf_counter() - t_check
    info["setup_s"] = setup_s
    out["info"] = info
    out["checks"] = checks
    return out
