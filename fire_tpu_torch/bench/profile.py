"""``python -m fire_tpu_torch.bench profile``: the port of
``tools/profile_step.py``, stage-level times and the bf16 share of the
batched step.

It times the full B-frame step (``BatchStreamEngine.step``, the
headline's unit of work), then each stage alone at the same shapes
(``profile_step.py:150-253``): the detector (letterbox, YuNet, decode +
NMS, batched over the frames), the fused crop + FaceNet-512 of every
slot, the compacted encode at each bucket of the ladder, kernel K1 and
the tracker scan; each the best of 20 calls after 3 warm-ups, waited for.
``fusion_gain_ms`` is the sum of the stages less the full step.

Where ``profile_step.py:52-63`` asks XLA's cost analysis for the step's
FLOPs, the port counts them from the shapes (forward MACs × 2): the
detector on B frames, FaceNet on the chosen bucket's crops and K1's
product of those crops with the live gallery.  The share of the card's
dense bf16 peak (``BF16_FLOP_PER_S``) is that count over the full
step's time.  The two keys keep ``profile_step.py``'s names:
``xla_flops_estimate`` holds this count and ``mfu_vs_197T_bf16`` the
share of the H100's 989 TFLOP/s.

``--trained`` profiles the headline's workload (committed weights on
rendered 1-face scenes), ``--tiny`` a small model on small frames on the
CPU (a smoke of the tool itself; numbers are meaningless), ``--trace
DIR`` writes a ``torch.profiler`` trace of 3 full steps to DIR.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from fire_tpu_torch.bench.common import (BF16_FLOP_PER_S, WEIGHTS, forward_macs, log, parser,
                                         print_result, sync, unit_rows)


def _time_fn(fn, device, n: int = 20, warmup: int = 3) -> float:
    """``profile_step.py:39-49``: seconds of the best of ``n`` calls by the
    host clock, each waited for."""
    for _ in range(warmup):
        fn()
        sync(device)
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def build(device, batch: int = 256, tiny: bool = False, trained: bool = False):
    """``profile_step.py:96-148``: the engine, the gallery, the gallery's
    rows and the frames on ``device``."""
    from fire_tpu_torch.config import EngineConfig, RecognizerConfig
    from fire_tpu_torch.gallery.index import DeviceGallery
    from fire_tpu_torch.pipeline.engine import DeviceEngine

    dim = 128 if tiny else 512
    cfg = RecognizerConfig(
        detector_type="yunet", encoder_model_type="128" if tiny else "512",
        similarity_threshold=0.7, unknown_trigger_count=1, weights_dir=None,
        engine=(EngineConfig(detect_size=(64, 64), encode_size=(96, 96), compute_dtype="float32")
                if tiny else EngineConfig()),
    ).with_embedding_dim()
    if tiny:
        from fire_tpu_torch.models.facenet import tiny_facenet
        from fire_tpu_torch.models.yunet import YuNet

        eng = DeviceEngine(cfg, device, detector=YuNet(width=8), encoder=tiny_facenet(dim))
        n_rows, capacity, frame_hw = 1000, 2048, (64, 64)
    else:
        eng = DeviceEngine(cfg, device)
        n_rows, capacity, frame_hw = 99_900, 100_000, (1080, 1920)
    gal = DeviceGallery(dim, capacity=capacity, device=device)
    rng = np.random.default_rng(0)
    rows = unit_rows(rng, n_rows, dim)
    gal.load_rows((i + 1, f"p{i}", rows[i].tobytes()) for i in range(rows.shape[0]))
    if trained and not tiny:
        from fire_tpu_torch.train.scenes import compose_scene, make_identities

        eng.load_trained_detector(os.path.join(WEIGHTS, "yunet_synth.msgpack"))
        eng.load_trained_encoder(os.path.join(WEIGHTS, "facenet512_synth.msgpack"))
        idents = make_identities(8, seed=0)
        scenes = np.stack([
            compose_scene(rng, idents, hw=frame_hw, n_faces=(1, 1),
                          face_px=(180, 360))[0].astype(np.uint8)
            for _ in range(8)])
        host_frames = np.tile(scenes, (max(1, batch // 8 + 1), 1, 1, 1))[:batch]
        log("trained weights + rendered 1-face scenes loaded")
    else:
        host_frames = rng.integers(0, 255, (batch, *frame_hw, 3), np.uint8)
    frames = torch.from_numpy(host_frames).to(device)
    return cfg, eng, gal, rows, frames


@torch.inference_mode()
def run(device=None, batch: int = 256, tiny: bool = False, trained: bool = False,
        trace=None) -> dict:
    """Returns the JSON record of ``profile_step.py:267-280``."""
    from fire_tpu_torch.config import TrackerConfig
    from fire_tpu_torch.device import resolve_device
    from fire_tpu_torch.ops.boxes import top_k_stable
    from fire_tpu_torch.ops.cosine_top1 import cosine_top1
    from fire_tpu_torch.ops.gallery_match import l2_normalize
    from fire_tpu_torch.ops.image import bgr_to_rgb, crop_and_resize_mm, crop_selected_rows
    from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine, _bucket_ladder, _track_scan

    device = resolve_device(device)
    b = 4 if tiny else batch
    cfg, eng, gal, rows, frames = build(device, b, tiny, trained)
    frame_hw = tuple(frames.shape[1:3])
    dim = cfg.embedding_dim

    # ---- full step ----
    bse = BatchStreamEngine(eng, gal, cfg)
    k = bse.encode_k
    gal_op, count = gal.gal_matmul, gal.count

    def full():
        return bse.step(eng, gal_op, count, bse.state, frames)[1]

    t_full = _time_fn(full, device)
    log(f"full step B={b}: {t_full * 1e3:.1f} ms -> {b / t_full:.0f} fps")
    if trace:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(trace, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                full()
            sync(device)
        prof.export_chrome_trace(os.path.join(trace, "profile_step.json"))
        log(f"profiler trace written to {trace}")

    # ---- stages alone, at the shapes inside the step ----
    det = eng._build_detect(frame_hw)
    t_det = _time_fn(lambda: det(frames), device)

    size = cfg.engine.encode_size
    boxes = torch.tensor([[10.0, 10.0, 120.0, 120.0]], device=device).repeat(b, k, 1)

    def enc_stage():
        crops = torch.stack([crop_and_resize_mm(frames[i], boxes[i], size) for i in range(b)])
        flat = bgr_to_rgb(crops / 255.0).reshape(-1, *size, 3)
        return l2_normalize(eng.encode(flat).float())

    t_enc = _time_fn(enc_stage, device)

    # compacted encoder per bucket: one real detection a frame
    nk = b * k
    fs_host = np.full((nk,), -1.0, np.float32)
    fs_host[::k] = 1.0
    flat_scores = torch.from_numpy(fs_host).to(device)
    boxes_flat = torch.tensor([[400.0, 300.0, 280.0, 280.0]], device=device).repeat(nk, 1)

    def enc_compact(m):
        top_s, top_idx = top_k_stable(flat_scores, m)
        crops = crop_selected_rows(frames, top_idx // k, boxes_flat[top_idx], size)
        flat = bgr_to_rgb(crops / 255.0).reshape(-1, *size, 3)
        return l2_normalize(eng.encode(flat).float()) * (top_s >= 0.0)[:, None]

    ladder = _bucket_ladder(nk, None)
    enc_buckets = {}
    for m in ladder:
        enc_buckets[m] = round(_time_fn(lambda m=m: enc_compact(m), device) * 1e3, 2)
        log(f"  compacted encoder m={m}: {enc_buckets[m]} ms")

    # which rung would the step pick on these frames and weights?
    n_real = int(torch.clamp(det(frames).mask.sum(dim=-1), max=k).sum())
    chosen = next((m for m in ladder if m >= n_real), nk)
    log(f"  real detections in batch: {n_real} -> bucket {chosen}")

    q = torch.from_numpy(rows[:nk].copy()).to(device)
    t_gal = _time_fn(lambda: cosine_top1(q, gal_op, count), device)

    tcfg = TrackerConfig()
    emb = torch.zeros((b, k, dim), device=device)
    mask = torch.zeros((b, k), dtype=torch.bool, device=device)
    gid = torch.zeros((b, k), dtype=torch.int32, device=device)
    sim = torch.zeros((b, k), device=device)
    bx = torch.zeros((b, k, 4), device=device)
    t_scan = _time_fn(lambda: _track_scan(bse.state, bx, mask, gid, sim, emb, mask, tcfg, 0.7, 1),
                      device)

    # ---- FLOPs from the shapes, and the bf16 share ----
    det_hw = eng._detect_input
    det_macs = forward_macs(eng.detector, torch.zeros((1, *det_hw, 3), device=device)) * b
    enc_macs = forward_macs(eng.encoder, torch.zeros((1, *size, 3), device=device)) * chosen
    flops = 2.0 * (det_macs + enc_macs + chosen * count * dim)
    share = flops / t_full / BF16_FLOP_PER_S

    stages = {
        "detector_ms": round(t_det * 1e3, 2),
        "encoder_ms": round(t_enc * 1e3, 2),
        "gallery_k1_top1_ms": round(t_gal * 1e3, 2),
        "tracker_scan_ms": round(t_scan * 1e3, 2),
    }
    sum_stages = t_det + t_enc + t_gal + t_scan
    out = {
        "batch": b,
        "trained_workload": bool(trained),
        "full_step_ms": round(t_full * 1e3, 2),
        "fps": round(b / t_full, 1),
        "stages_separate": stages,
        "encoder_compacted_ms_by_bucket": enc_buckets,
        "real_detections_in_batch": n_real,
        "chosen_bucket": chosen,
        "sum_stages_ms": round(sum_stages * 1e3, 2),
        "fusion_gain_ms": round((sum_stages - t_full) * 1e3, 2),
        "xla_flops_estimate": flops,
        "mfu_vs_197T_bf16": round(share, 4),
    }
    for key, v in out.items():
        log(f"  {key}: {v}")
    return out


def main(argv=None) -> int:
    ap = parser("tools/profile_step.py on the port: stage ms and the bf16 share of the step")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--trace", default=None, help="also write a torch.profiler trace to this dir")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny models and shapes: a CPU smoke of the profiler itself "
                         "(numbers are meaningless)")
    ap.add_argument("--trained", action="store_true",
                    help="profile the bench headline's workload: committed trained weights on "
                         "rendered 1-face scenes")
    args = ap.parse_args(argv)
    print_result(run(args.device, args.batch, args.tiny, args.trained, args.trace), args.device)
    return 0
