#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``fire_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, one card

It takes no arguments and needs one card.  On a machine with several,
the serving phases (the recognizer's own sharded gallery view,
``multistream``, ``sharded_gallery``) and the training phases
(``train_sharded``, ``dryrun``) also run over distinct cards.  Phases,
in order, each printing one JSON line:

1. ``env``: torch / CUDA versions, the card's name and power limit.
2. ``build``: compiles kernels K1 (``fire_tpu_torch/csrc/cosine_top1.cu``),
   K2 (``csrc/track_scan.cu``) and K3 (``csrc/bn_act.cu``) and the step
   graph's library
   (``csrc/step_graph.cu``) with nvcc for sm_90a, and beside them the
   host AES-128-CBC library of the at-rest encryption
   (``csrc/aes128_cbc.cpp``) and the host LAP / NMS library with the host
   C++ compiler, all at once; fails if ptxas reports a spill.
3. ``kernels``: K1 against its plain PyTorch version on the card at the
   host query path's and the batched path's shapes (M = 1…2048 queries ×
   the 100,352-row padded gallery × 512), with its launch plan and its
   kernel (called one by one, and replayed from a CUDA graph), plain,
   library and bound times, at M = 64 and 2048 also in the device-count
   form the step graph launches; then small and ragged counts (in both
   forms), a gallery that ends inside a tile, an empty gallery and
   duplicated rows.
   Then K2, the tracker scan, against its plain version (the ``sort_step``
   loop) on seeded sequences: B = 256 / T = 64 / K = 8 Hungarian, a crowd
   at B = 32 / T = 192 / K = 128 whose frames need the JV solve, B = 128 /
   T = 32 / K = 8 greedy, B = 64 / T = 64 / K = 8 with the identity
   bookkeeping and more enrolments than ``MAX_ENROLL``, the per-frame
   path's B = 1 / K = 32, and track tables beyond one block's shared
   memory (T = 256 / K = 128, T = K = 192, T = 512 / K = 256, the cost and
   at T = 512 P outside it): integers and boxes equal on every frame, the
   KF state equal too (max error 0.0); ms a launch of each, by CUDA
   events, called one by one and replayed from a CUDA graph, beside the
   plain version's and the bound; thread 0's cycles by phase a frame (and
   in µs at the clock the launch ran at), and where the launch plan put
   each array.
   Then K3, inference BatchNorm with its ReLU and residual in one bf16
   pass, at the shapes RetinaFace (512²), YuNet (640²) and FaceNet (8 and
   64 crops of 160²) give it, one frame and the batched path's 64: bitwise against its plain version, ms
   called one by one and replayed from a CUDA graph, the bound from the
   bytes it moves, plain ms, and the library chain it replaces (cast,
   cuDNN's float32 ``F.batch_norm``, cast, residual, ReLU); and K3's
   PReLU route at two IResNet-100 shapes (112²: the stem, a layer-3
   ``bn2``), against the chain with ``F.prelu``, and the residual route
   at a third (a layer-1 ``bn3`` with the shortcut at four faces).
4. ``main_path``: ``FaceRecognition.process_frames(batch_size=64)`` at full
   width (YuNet-64 at 640², FaceNet-512, 99,900-row gallery, committed
   trained weights) over rendered 1-face 1080p scenes; K1's and K2's
   launch counts are set to 0 just before and read just after (K2: one a
   batch; each replay of the step graph counts its launches), with each
   step graph's capture seconds and pool.  Then the synchronising
   operations of one warm ``submit`` (``torch.cuda.set_sync_debug_mode(
   "warn")``, stage timer off): none with the bucket ladder, with
   ``encode_budget=64`` and for two streams; the batch's ``submit`` and
   ``collect`` wall times.  Then the step graph against the eager step
   (its plain version) on batches that reach each rung of B = 64's
   ladder (64, 256, 512), across an enrolment (matched with no new
   capture) and for two streams; the eager step's device time by stage
   (the graph replays as one stage).  Then five distinct batches
   submitted before any is collected, each equal to a second engine's
   one-at-a-time result, and the same for five steps of two streams.
5. ``retina_path``: the same batched path and frames with the RetinaFace
   slot (ResNet-50 + FPN + SSH at 512², committed weights).
6. ``frame_path``: ``process_frames(batch_size=0)``, the per-frame loop
   (detect → host ``Sort`` → encode new tracks → K1 at M = 1…8 → unknown
   lifecycle), over 64 rendered 1080p frames with 1–3 faces against the
   same gallery; frames/s and ms per frame by stage.  A second, shorter
   run uses ``detection_interval=3`` and ``align_video=True`` (coasting
   and landmark-aligned encoding).  K2 launches once a frame (``Sort.update``
   at B = 1); K3 exactly once a BatchNorm of each detect and encode
   replayed.  Detect, each encoder
   bucket and the tracker step replay
   CUDA graphs (``runtime/graphs.py``), captured at the first frame of
   each key and never again (capture seconds and pool bytes recorded).
   Then 16 more frames, each under ``set_sync_debug_mode``: a frame that
   neither enrols nor captures synchronises no more often than JAX reads
   back for it (detect 1, tracker 1, an encode call 1, a gallery query 2).
   Then ``frame graph vs eager``: the same frames through a recognizer
   replaying the graphs and one run eagerly (the plain version), for each
   of the two runs: tracks, boxes, confidences, embeddings and SQLite rows
   bitwise equal, labels up to their random names.
7. ``retina_frame``: the per-frame loop's first run with RetinaFace, with
   the same graph, sync and graph-vs-eager checks.
8. ``image_mode``: ``fire_tpu_torch.cli.main`` in process on a rendered
   1080p BMP: enrol, recognise, relabel (``--label``), then the default
   command (BlazeFace at 192²); detect and encode replay graphs (each
   command's engine captures its own); then, untimed, each engine call of
   a YuNet and a default command against the same call run eagerly,
   bitwise.
8a. ``iresnet_path``: ArcFace IResNet-100 in the encoder slot at full
   size (112² crops, the random init) behind the trained YuNet: an
   encode makes 153 K3 launches, 50 on the PReLU route, replayed and
   eager, the replay bitwise equal to the eager call; ``recognize_faces``,
   ``extract_faces`` (112² crops), ``add_face``, ``process_frames`` at
   B = 2 and ``--encoder iresnet100`` image mode through the CLI.
9. ``default_command``: ``cli.main`` image mode without ``--encoder``
   (the random-init FaceNet-128 and its params cache), twice on fresh
   storage: the first call writes the cache, the second reads it; the
   graph's embedding equals the eager call's.
10. ``encrypted``: ``FaceRecognition(encryption_password=...)`` on the
   99,900-row gallery: enrolment, close, reopen, an encrypted BMP save, a
   wrong password; AES MB/s and the seconds of the 204 MB snapshot.
11. ``multistream``: ``process_videos``'s loop (fed in-RAM captures) at
   full width on the 99,900-row gallery with S = 1, 2, 4 streams on a
   mesh of this one card repeated S times, B = 64 1080p frames per
   stream, two measured batches after a warm-up; streams 0 and 1 show
   one identity, which must enrol once; aggregate and per-stream
   frames/s and K1's and K2's launches per S (K2: one a batch a stream),
   each S's step graph captured in a warm-up run first, none in the
   measured run.  Before that, at the engine level, every stream of a
   4-stream step equals a single-stream engine on the same frames, and
   an ended stream runs on a zeroed input with no new capture.  With
   more than one card, the same for S = 2 and 4 over distinct cards
   (JAX's default mesh for ``process_videos``), after an engine-level
   check: each stream equal to the same stream on the card repeated
   (ids equal, boxes within 1 px, sims within 2e-3), and a face enrolled
   from stream 0 matched in the streams on the other cards with no new
   capture.
12. ``sharded_gallery``: ``ShardedGalleryView`` over 1…4 shards on this
   card, and over the first 2, 3 and 4 distinct cards where there are
   more, against ``DeviceGallery.query_batch`` at M = 1, 8, 64 and
   k = 1, 5 on the 99,900-row gallery; each query makes two
   synchronising calls, JAX's two readbacks (``set_sync_debug_mode``),
   and launches no K1; incremental refreshes (300 enrolments across a
   3-shard boundary, then the rest) equal a full re-shard bitwise; the
   sharded query's time beside K1's.
13. ``importers``: the committed YuNet, FaceNet-512 and BlazeFace-192
   weights exported by the port's writer into a ``weights_dir``
   (BlazeFace as ``.tflite`` and as ``.onnx``): ``FaceRecognition``
   imports them and detects and embeds as the msgpack-loaded engine
   does; a FaceNet of other depths runs through the ONNX executor and
   matches the module; ``python -m fire_tpu_torch.verify_onnx`` passes on
   each file.
14. ``native``: the port's host C++ library (``csrc/fire_native.cc``):
   ``linear_sum_assignment`` against SciPy on 200 random cost matrices,
   ties included (equal indices where the optimum is unique, equal cost
   everywhere), and ``host_nms`` against its NumPy version with and
   without ``plus_one`` / ``suppress_equal``.
15. ``label_text``: a rendered 1080p frame annotated without OpenCV
   (hidden where it is installed): label text appears above every box
   and equals what the glyph atlas gives for the same strings.
16. ``eval_detect``: ``python -m fire_tpu_torch.eval_detect``'s run in
   process: the committed YuNet on 64 rendered 480×640 scenes; precision
   at least 0.9.
17. ``calibrate``: ``fire_tpu_torch.calibrate`` with the committed YuNet
   and FaceNet-512, 24 identities × 10 views; genuine p50 above imposter
   p98.
18. ``eval_auc``: ``train.synth.generate`` (16 identities, 6 held-out
   images each) into a temporary folder, its PNGs reread bitwise without
   OpenCV, then ``encode_directory`` and ``identification_auc`` with the
   committed FaceNet-512; cosine AUC above 0.9.
19. ``eval_e2e``: the JAX README's end-to-end accuracy run (seed 0, 120
   rendered 1080p frames, 4 identities, faces at 140 px; an XVID file
   where OpenCV is installed, as JAX scores it, else the frames) through
   the per-frame path and the batched path at B = 64, committed weights:
   detection recall ≥ 0.85, precision ≥ 0.95 and identity consistency
   ≥ 0.80 on both, and through the XVID file the per-frame row exactly
   JAX's recorded 0.917 / 1.000 / 0.884 / 0.75; K1's launches on each.
20. ``train_encoder``: ``python -m fire_tpu_torch.train``'s ``main`` for
   two epochs of a rendered identity dataset (32 × 8 PNGs) at full width
   (FaceNet-512, B = 64, 160², bf16), its file loaded into a
   ``DeviceEngine`` that embeds; then the step alone memorises one batch
   (the loss falls below half in 30 steps): ms a step, images/s, peak
   memory, share of the bf16 peak.  Both replay the step's CUDA graph,
   captured at its first call (capture seconds and pool recorded).
21. ``train_sharded``: the dp×mp-sharded ArcFace step on a (2, 2) mesh
   (four distinct cards where there are four, else this card repeated):
   FaceNet-512, B = 64, 160².  (a) One step's loss, gradients and
   BatchNorm statistics against the one-device step from one state on
   one batch, float32 with TF32 off.  (b) In bf16 with AdamW it memorises
   one batch as ``train_encoder``'s step does, beside that step's
   numbers.  (c) At C = 100,000 identities, the one-device and the
   (2, 2) step: ms a step, the peak memory of each device, and each
   ``mp`` block's columns and bytes on its own device.  Both steps
   replay their graphs (over distinct cards one graph spans the four),
   the eager step's ms beside them.  Two eager runs from one state, and
   the graph against the eager step, bitwise over 5 float32 steps.
22. ``dryrun``: ``fire_tpu_torch.dryrun``, the counterpart of
   ``__graft_entry__.py``.  ``entry()``: FaceNet-512 in bf16 at full
   width on 8 × 160², ms a call, and unit rows at cosine ≥ 0.999 to the
   CPU's.  Then ``dryrun_multichip(8)`` on this card repeated eight times,
   (dp, mp) = (4, 2), TF32 off: the ArcFace step, the row-sharded top-k,
   S = 4 streams with the stand-in engine and with the real YuNet and
   FaceNet graphs (each equal to the single-stream engine) and
   ``process_videos``; seconds a plane and K1's and K2's launches (K2:
   one a stream step).  The stand-in and real-model planes run again
   on the card with K1 and K2 swapped for their plain versions, and on
   ``["cpu"] * 8``: masks, track and gallery ids equal, similarities
   within 1e-3, boxes within 1e-3 of the card's plain run and within 1 px
   of the CPU's (the CPU's ``exp`` may round a box edge a pixel apart).
   With four cards, ``dryrun_multichip(4)`` on four distinct ones, its
   train plane one graph over the four.
23. ``train_detectors``: YuNet-64 (320², B = 32), BlazeFace (192² from
   480×640, B = 64) and RetinaFace (512² from 480×640, B = 8): each
   pool step memorises one batch as above, then the trainer's ``main``
   runs a few dozen steps on a small pool; BlazeFace and RetinaFace
   fine-tune the committed weights, and their held-out P/R stays within
   0.15 of the starting weights'.  Each step replays its graph, the
   device scene pool bound to it.
24. ``train_graph`` (``train graph vs eager``): each of the four
   one-device training steps at the full width above, its graph against
   the eager step (the graph's plain version) from one state: 5 steps in
   float32 with TF32 off and cuDNN deterministic, losses, parameters,
   BatchNorm statistics, moments and counts bitwise equal after every
   step (the detectors' cosine schedule ends within them), the build
   leaving the state as it was and the caller's tensors unwritten; then
   at bf16, ms a step eager and graphed, build and capture seconds and
   the pool the capture took.
25. ``bench``: the measurement plane, ``fire_tpu_torch.bench``, through
   its functions at cut trials: the gallery A/B with K1 held to its plain
   version on the bench's inputs, the headline's legs at B = 128 and 256
   (1 warm-up, 2 trials of 2 steps), one trial each of full cost, frame
   skip and in RAM, the tracker A/B and the crowd curve at 1 and 16 faces
   a frame; K1's and K2's launches per bench (K2: one a batch).
26. ``trace``: one more batch of the batched path and 16 frames of the
   per-frame path under ``torch.profiler``, with YuNet and with
   RetinaFace (the per-frame frames twice: first sight, with its
   enrolments, then again after their tracks died), then one full-width
   ArcFace step on one device, eager and replaying its graph (at most 10
   host launch calls), and the same two on the (2, 2) mesh (over four
   distinct cards one graph spans them), for the device's busy
   time, its idle share of the traced wall time and the host's launch
   calls (ten ``trace`` lines).  It runs after every timed phase: the profiler leaves
   launches slower.
27. ``cross_device``: one 8-frame batched step, a 2-stream step, the
   per-frame engine calls (``detect_faces``, ``encode_boxes``,
   ``encode_landmarks``, ``extract_faces``, BlazeFace and RetinaFace
   ``detect``), the random-init FaceNet-128, the ONNX executor on a
   YuNet graph, and one ArcFace and one YuNet pool training step (loss
   and gradients; the card's replaying its graph), on the card and on
   the CPU in float32, compared.

The recognizer logs an error and goes on where a frame, an image or an
enrolment fails, as JAX's does; every phase therefore runs with a
handler on its logger, and an ERROR record fails the phase.  Between
phases the memory their engines and step graphs held is given back to
the card (``torch.cuda.empty_cache``), for the next phase's
subprocesses.

Any failed check raises and the script exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Nothing of JAX or ``fire_tpu`` is
imported.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "build", "kernels", "main_path", "retina_path", "frame_path", "retina_frame",
          "image_mode", "iresnet_path", "default_command", "encrypted", "multistream", "sharded_gallery",
          "importers", "native", "label_text", "eval_detect", "calibrate", "eval_auc",
          "eval_e2e", "train_encoder", "train_sharded", "dryrun", "train_detectors",
          "train_graph", "bench", "trace", "cross_device")

N_GALLERY = 99_900
PADDED_ROWS = 100_352  # DeviceGallery pads 100,000 to 49 × 2048
DIM = 512
BATCH = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


class _ErrorRecords(logging.Handler):
    def __init__(self):
        super().__init__(logging.ERROR)
        self.messages = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


@contextlib.contextmanager
def recognizer_errors_fail(phase: str):
    """The recognizer logs a failed frame, image or enrolment and goes
    on (as JAX's does): any ERROR record it logs inside the block fails
    ``phase``."""
    logger = logging.getLogger("fire_tpu_torch.pipeline.recognizer")
    handler, level = _ErrorRecords(), logger.level
    logger.addHandler(handler)
    logger.setLevel(min(logger.getEffectiveLevel(), logging.ERROR))
    try:
        yield
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    check(not handler.messages, f"{phase}: the recognizer logged errors: {handler.messages[:5]}")


def event_ms(enqueue, calls: int) -> float:
    """CUDA events around ``enqueue()``, which launches ``calls`` calls:
    the time of one, in ms."""
    import torch

    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    enqueue()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / calls


def median(values) -> float:
    return sorted(values)[len(values) // 2]


def cuda_ms_each(fns: dict, reps: int, warmup: int = 2, rounds: int = 5) -> dict:
    """Time of one call of each function, ``reps`` calls made back to
    back: the functions take turns for ``rounds`` rounds, and each gets
    its median round.  The host that makes the calls shares its cores,
    so a single run of a 40 µs call can catch a slow moment; the turns
    spread each function's rounds out."""
    def run(fn):
        for _ in range(reps):
            fn()

    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(event_ms(lambda: run(fn), reps))
    return {name: median(ts) for name, ts in times.items()}


def graph_ms(fn, reps: int, rounds: int = 5) -> float:
    """Time of one call with the host taken out: ``reps`` calls are
    captured once into a CUDA graph, and the graph is replayed.  The
    median of ``rounds`` replays."""
    import torch

    fn()  # first-use work (the build, the shared-memory attribute) stays out of the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return median([event_ms(graph.replay, reps) for _ in range(rounds)])


def k1_bound_ms(m: int, count: int) -> tuple:
    """Least time on the card for this call's work: the live gallery
    rows and the bf16 queries read once, the outputs written once, and
    2·M·count·D FLOP at the dense bf16 rate."""
    from fire_tpu_torch.bench.common import BF16_FLOP_PER_S, HBM_BYTES_PER_S

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

    from fire_tpu_torch.bench.common import nvidia_smi_line

    ctx["smi"] = nvidia_smi_line()
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": ctx["smi"]})


def phase_build(ctx) -> None:
    """K1, K2 and the step graph's library with nvcc, the AES and native
    libraries with the host compiler, started together; each from the
    checkout's source, never from an old build."""
    from concurrent.futures import ThreadPoolExecutor

    from fire_tpu_torch.gallery import crypto
    from fire_tpu_torch.ops import bn_act as k3
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.runtime import native
    from fire_tpu_torch.runtime import step_graph
    from fire_tpu_torch.track import scan as k2

    def timed(build, path):
        if os.path.exists(path):
            os.remove(path)  # always prove the build from the checkout's source
        t0 = time.time()
        build()
        return time.time() - t0

    with ThreadPoolExecutor(6) as pool:
        k1_job = pool.submit(timed, k1.build, k1.library_path())
        k2_job = pool.submit(timed, k2.build, k2.library_path())
        k3_job = pool.submit(timed, k3.build, k3.library_path())
        graph_job = pool.submit(timed, step_graph.build, step_graph.library_path())
        aes_job = pool.submit(timed, crypto.build, crypto.library_path())
        native_job = pool.submit(timed, native.load_native, native.library_path())
        secs, aes_secs, native_secs = k1_job.result(), aes_job.result(), native_job.result()
        k2_secs, k3_secs, graph_secs = k2_job.result(), k3_job.result(), graph_job.result()
    check(native.load_native() is not None, "build: the native library did not build")

    def report(kernel, seconds):
        ptxas = [ln.strip() for ln in kernel.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        clean = "0 bytes spill stores, 0 bytes spill loads"
        spills = [ln for ln in ptxas if "spill" in ln and clean not in ln]
        check(bool(ptxas) and not spills, f"{kernel.NAME} build: ptxas reports spills: {spills}")
        return ptxas, {"seconds": round(seconds, 3),
                       "registers": [int(ln.split("Used ")[1].split()[0]) for ln in ptxas
                                     if "Used " in ln]}

    ptxas, ctx["k1_build"] = report(k1, secs)
    k2_ptxas, ctx["k2_build"] = report(k2, k2_secs)
    k3_ptxas, ctx["k3_build"] = report(k3, k3_secs)
    graph_ptxas, graph_build = report(step_graph, graph_secs)
    emit({"phase": "build", "kernel": k1.NAME, "arch": "sm_90a", "nvcc_flags": list(k1.NVCC_FLAGS),
          "ptxas": ptxas, **ctx["k1_build"],
          "k2": {"kernel": k2.NAME, "nvcc_flags": list(k2.NVCC_FLAGS), "ptxas": k2_ptxas,
                 **ctx["k2_build"]},
          "k3": {"kernel": k3.NAME, "nvcc_flags": list(k3.NVCC_FLAGS), "ptxas": k3_ptxas,
                 **ctx["k3_build"]},
          "step_graph_library": {"source": "fire_tpu_torch/csrc/step_graph.cu",
                                 "nvcc_flags": list(step_graph.NVCC_FLAGS),
                                 "ptxas": graph_ptxas, **graph_build},
          "aes_library": {"source": "fire_tpu_torch/csrc/aes128_cbc.cpp",
                          "flags": list(crypto.CXX_FLAGS), "seconds": round(aes_secs, 3),
                          "backend": crypto.backend()},
          "native_library": {"source": "fire_tpu_torch/csrc/fire_native.cc",
                             "seconds": round(native_secs, 3)}})


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

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def one(name, q, g, count, time_it, device_count=False):
        launches0 = k1.launches
        # the device-count form (what a step graph launches): the kernel
        # reads the count on the card, over a plan for all N rows
        n = torch.tensor(count, dtype=torch.int32, device=dev) if device_count else count
        sims, idx = k1.cosine_top1(q, g, n)
        torch.cuda.synchronize()  # a fault of this case shows here, not later
        ps, pi = k1.plain_cosine_top1(q, g, n)
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
        plan = k1.launch_plan(int(q.shape[0]), g.shape[0] if device_count else count, DIM, sms)
        rec = {"case": name, "M": int(q.shape[0]), "N": int(g.shape[0]), "D": DIM,
               "count": count, "device_count": device_count, "max_abs_err": err,
               "index_equal_where_decisive": idx_ok,
               "plan": {**plan._asdict(), "blocks": plan.blocks}}
        if time_it:
            reps = 20 if q.shape[0] <= 512 else 5
            qb, gb = q.to(torch.bfloat16), g
            rec.update(cuda_ms_each({
                "kernel_ms": lambda: k1.cosine_top1(q, g, n),
                "plain_ms": lambda: k1.plain_cosine_top1(q, g, n),
                "library_ms": lambda: torch.max(torch.matmul(qb, gb[:count].T), dim=1)}, reps))
            # the same launches replayed from a CUDA graph: what the card
            # alone takes, where kernel_ms also holds the host that launches them
            rec["kernel_device_ms"] = graph_ms(lambda: k1.cosine_top1(q, g, n), reps)
            rec["bound_ms"], rec["bound_by"] = k1_bound_ms(int(q.shape[0]), count)
            rec["kernel_over_bound"] = rec["kernel_ms"] / rec["bound_ms"]
            rec["kernel_over_library"] = rec["kernel_ms"] / rec["library_ms"]
        rec["launches"] = k1.launches - launches0
        results.append(rec)
        emit({"phase": "kernels", "kernel": k1.NAME, **rec})

    # M = 1…8: the host k=1 query path; 64: the main path's rung at one face
    # per frame; 512 = 64 frames × 8 faces, its top rung; 2048: B=256's
    for m in (1, 8, 64, 128, 256, 512, 2048):
        q = torch.from_numpy(unit_rows(rng, m, DIM)).to(dev)
        one(f"M={m}", q, g16, N_GALLERY, time_it=True)
        if m in (BATCH, 2048):  # the step graph's form at the main path's rung, and B = 256's top
            one(f"M={m} device count", q, g16, N_GALLERY, time_it=True, device_count=True)
    q = torch.from_numpy(unit_rows(rng, 128, DIM)).to(dev)
    one("count=0", q, g16, 0, time_it=False)
    one("count=1", q, g16, 1, time_it=False)  # inside the first chunk's first tile
    one("count=12345", q, g16, 12_345, time_it=False)
    # a gallery that ends inside a tile: the copy's zero fill past N, at full width
    ragged = g16[: PADDED_ROWS - 40]
    one("N=100312", q, ragged, PADDED_ROWS - 40, time_it=False)
    one("bf16 queries", q.to(torch.bfloat16), g16, N_GALLERY, time_it=False)
    for count in (0, 1, 2047, 2048, PADDED_ROWS):
        one(f"count={count} device count", q, g16, count, time_it=False, device_count=True)
    s0, i0 = k1.cosine_top1(q, g16, 0)
    check(bool((s0 == -2.0).all()) and bool((i0 == 0).all()), "K1 count=0: not (-2, 0)")
    # ties: a row duplicated after the original, 8 rows on (the same
    # thread's second row), in the same tile, 64 and 128 rows on (the other
    # warpgroup, the next tile) and in a far chunk; a query equal to the
    # row must get the lowest index
    picks = torch.tensor([5, 50_000, 70_000], device=dev)
    ties = {}
    for offs in ((8,), (17, 25_000), (64,), (128,)):
        dup = gal.clone()
        for off in offs:
            dup[picks + off] = dup[picks]
        sims, idx = k1.cosine_top1(dup[picks], dup.to(torch.bfloat16), N_GALLERY)
        torch.cuda.synchronize()
        check(idx.tolist() == picks.tolist(),
              f"K1 ties at +{offs}: {idx.tolist()} != {picks.tolist()}")
        ties["+" + ",+".join(map(str, offs))] = idx.tolist()
    results.append({"case": "ties", "idx": ties})
    emit({"phase": "kernels", "kernel": k1.NAME, "case": "ties", "idx": ties})
    ctx["k1"] = results
    ctx["k2"] = [k2_case(dev, *case) for case in K2_CASES]
    check(ctx["k2"][1]["stats"]["jv_frames"] > 0, "K2: no frame of the crowd took the JV solve")
    check(ctx["k2"][3]["enrolments"] > 8, "K2: the identity case did not overflow MAX_ENROLL")
    ctx["k3"] = [k3_case(dev, *case) for case in K3_CASES]


# (case, shape, residual, act, scale): the layers of RetinaFace at 512²
# (the stem; stage 1's and stage 4's last 1×1 with the shortcut; an SSH
# branch; the stem and stage 1 again at the batched path's 64 frames),
# YuNet at 640² (the stem, a 64-channel unit at stride 8; the stem at 64
# frames), FaceNet-512 (stem0 at 8 and at 64 crops, the 1792-channel block,
# the 2-D bottleneck; no scale), ArcFace IResNet-100 at 112² (on the
# PReLU route the stem and a layer-3 block's bn2; a layer-1 block's bn3
# with the shortcut at four faces).  ``act`` is True (ReLU), False or
# "prelu".
K3_CASES = (
    ("RetinaFace stem", (1, 64, 256, 256), False, True, True),
    ("RetinaFace stage1 bn3", (1, 256, 128, 128), True, True, True),
    ("RetinaFace stem B=64", (64, 64, 256, 256), False, True, True),
    ("RetinaFace stage1 bn3 B=64", (64, 256, 128, 128), True, True, True),
    ("RetinaFace stage4 bn3", (1, 2048, 16, 16), True, True, True),
    ("RetinaFace SSH s8", (1, 128, 64, 64), False, False, True),
    ("YuNet stem", (1, 16, 320, 320), False, True, True),
    ("YuNet unit s8", (1, 64, 80, 80), False, True, True),
    ("YuNet stem B=64", (64, 16, 320, 320), False, True, True),
    ("FaceNet stem0 B=8", (8, 32, 79, 79), False, True, False),
    ("FaceNet stem0 B=64", (64, 32, 79, 79), False, True, False),
    ("FaceNet block8 B=8", (8, 1792, 3, 3), False, True, False),
    ("FaceNet bottleneck B=8", (8, 512), False, False, False),
    ("IResNet stem PReLU", (1, 64, 112, 112), False, "prelu", True),
    ("IResNet layer3 bn2 PReLU", (1, 256, 14, 14), False, "prelu", True),
    ("IResNet layer1 bn3 B=4", (4, 64, 56, 56), True, False, True),
)


def k3_case(dev, name, shape, residual, act, use_scale) -> dict:
    """K3 at one layer's shape: bitwise against its plain version, then
    timed against it and against the library chain it replaces (with a
    PReLU: the float32 BatchNorm, its cast, the add and ``F.prelu``)."""
    import torch
    import torch.nn.functional as F

    from fire_tpu_torch.bench.common import HBM_BYTES_PER_S
    from fire_tpu_torch.ops import bn_act as k3

    gen = torch.Generator().manual_seed(sum(shape))
    c = shape[1]

    def activation():
        t = (2 * torch.randn(shape, generator=gen) + 0.3).to(dev, torch.bfloat16)
        return t.to(memory_format=torch.channels_last) if len(shape) == 4 else t

    x = activation()
    r = activation() if residual else None
    mean = (0.3 * torch.randn(c, generator=gen)).to(dev)
    var = (0.5 + torch.rand(c, generator=gen)).to(dev)
    scale = ((1 + 0.3 * torch.randn(c, generator=gen)) if use_scale else torch.ones(c)).to(dev)
    bias = (0.2 * torch.randn(c, generator=gen)).to(dev)
    eps = 1e-5 if use_scale else 1e-3
    relu = act is True
    slope = (0.25 + 0.1 * torch.randn(c, generator=gen)).to(dev) if act == "prelu" else None
    params = (mean, var, scale, bias, eps)
    got = k3.bn_act(x, *params, r, relu, slope)
    torch.cuda.synchronize()  # a fault of this case shows here, not later
    want = k3.plain_bn_act(x, *params, r, relu, slope)
    differ = int((got.contiguous().view(torch.int16) != want.contiguous().view(torch.int16)).sum())
    check(differ == 0, f"K3 {name}: {differ} bf16 values differ from the plain version")

    def library():
        y = F.batch_norm(x.float(), mean, var, scale, bias, False, 0.0, eps).to(torch.bfloat16)
        y = y + r if residual else y
        if slope is not None:
            return F.prelu(y, slope.to(y.dtype))
        return torch.relu(y) if relu else y

    lib_err = float((library().float() - got.float()).abs().max())
    plan = k3.launch_plan(x.numel() // c, c, 8 if c % 8 == 0 else 1,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    rec = {"case": name, "shape": list(shape), "residual": residual, "relu": relu,
           "prelu": slope is not None, "scale": use_scale, "bf16_values_differing": differ,
           "max_abs_diff_vs_library": lib_err, "plan": {**plan._asdict(), "threads": plan.threads}}
    rec.update(cuda_ms_each({"kernel_ms": lambda: k3.bn_act(x, *params, r, relu, slope),
                             "plain_ms": lambda: k3.plain_bn_act(x, *params, r, relu, slope),
                             "library_ms": library}, reps=20))
    rec["kernel_device_ms"] = graph_ms(lambda: k3.bn_act(x, *params, r, relu, slope), 20)
    rec["library_device_ms"] = graph_ms(library, 20)
    nbytes = x.numel() * (6 if residual else 4) + 4 * (5 if slope is not None else 4) * c
    rec["bound_ms"], rec["bound_by"] = nbytes / HBM_BYTES_PER_S * 1e3, "bytes"
    rec["kernel_over_bound"] = rec["kernel_device_ms"] / rec["bound_ms"]
    rec["library_over_kernel"] = rec["library_device_ms"] / rec["kernel_device_ms"]
    emit({"phase": "kernels", "kernel": k3.NAME, **rec})
    return rec


# (case, assignment, T, K, B, objects, identity, frames tracked before, sequence keywords)
K2_CASES = (
    ("B=256 T=64 K=8", "hungarian", 64, 8, 256, 10, False, 0, {}),
    ("B=32 T=192 K=128 crowd", "hungarian", 192, 128, 32, 160, False, 0,
     dict(area=700.0, size=(50, 90), speed=4.0)),
    ("B=128 T=32 K=8 greedy", "greedy", 32, 8, 128, 10, False, 0, {}),
    ("B=64 T=64 K=8 identity", "hungarian", 64, 8, 64, 20, True, 0, {}),
    ("B=1 T=64 K=32 per-frame", "hungarian", 64, 32, 1, 8, False, 30, {}),
    # tables beyond one block's shared memory: the cost (and from T = 512 P) out of it
    ("B=6 T=256 K=128 capacity", "hungarian", 256, 128, 6, 200, False, 2,
     dict(area=700.0, size=(50, 90), speed=4.0)),
    ("B=6 T=192 K=192 capacity", "hungarian", 192, 192, 6, 240, False, 2,
     dict(area=800.0, size=(50, 90), speed=4.0)),
    ("B=4 T=512 K=256 capacity", "hungarian", 512, 256, 4, 400, False, 2,
     dict(area=1100.0, size=(50, 90), speed=4.0)),
)
# float operations of K2's arithmetic, counted from csrc/track_scan.cu: a
# track's predict and box, one (detection, track) cost, a KF update with its
# 4x4 inverse, one column of one Dijkstra step
K2_FLOPS = {"predict": 294, "pair": 30, "update": 1550, "relax": 6}


def k2_bound_ms(b: int, k: int, t: int, identity: bool, stats: dict) -> tuple:
    """Least time on the card for one scan: the detections and the table
    read once, the table and the per-frame outputs written once, against
    the float operations this run's data needed (the kernel's own counts)
    at the float32 rate."""
    from fire_tpu_torch.bench.common import F32_FLOP_PER_S, HBM_BYTES_PER_S

    table = t * (10 + 100) * 4 + t * 5 * 4 + t + 4
    nbytes = b * k * 17 + 2 * table + b * t * 29
    if identity:
        nbytes += b * k * 9 + 2 * t * 13 + b * t * 13
    flops = (stats["predicted"] * K2_FLOPS["predict"] + b * k * t * K2_FLOPS["pair"]
             + stats["updated"] * K2_FLOPS["update"]
             + stats["dijkstra_steps"] * max(k, t) * K2_FLOPS["relax"]
             + (stats["greedy_rounds"] + b) * k * t)  # arg-mins over the cost
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k2_phases(stats: dict, b: int, device_ms: float) -> dict:
    """Thread 0's clock64 cycles by phase (the kernel's ``cyc_*`` counts)
    a frame, and in µs a frame at the clock the launch ran at: its whole
    count over the same launch's time on the card alone."""
    mhz = stats["cyc_total"] / (device_ms * 1e3)
    out = {"sm_mhz": mhz, "cycles_total": stats["cyc_total"]}
    for name in (n for n in stats if n.startswith("cyc_") and n != "cyc_total"):
        out[name[4:]] = {"cycles_per_frame": stats[name] / b, "us_per_frame": stats[name] / b / mhz}
    return out


def k2_case(dev, case, assignment, t, k, b, n_obj, identity, warm, kw) -> dict:
    """K2 against its plain version on one seeded sequence (the first
    ``warm`` frames tracked by the plain version first), then both timed
    by CUDA events, each launch from the same starting state."""
    import numpy as np
    import torch

    from fire_tpu_torch.bench.tracker import random_sequence
    from fire_tpu_torch.config import TrackerConfig
    from fire_tpu_torch.pipeline.batch_engine import make_stream_state
    from fire_tpu_torch.track import scan as k2

    cfg = TrackerConfig(assignment=assignment, max_tracks=t)
    boxes, mask = random_sequence(len(case), warm + b, k, n_obj, **kw)
    boxes, mask = torch.from_numpy(boxes).to(dev), torch.from_numpy(mask).to(dev)
    init = make_stream_state(cfg, 1, dev)
    if warm:
        init = init._replace(table=k2.sort_scan_plain(init.table, boxes[:warm], mask[:warm],
                                                      cfg)[0])
    boxes, mask = boxes[warm:].contiguous(), mask[warm:].contiguous()
    rng = np.random.default_rng(len(case))
    det = tuple(torch.from_numpy(x).to(dev) for x in (
        rng.integers(0, N_GALLERY, (b, k)).astype(np.int32),
        rng.uniform(0.3, 0.75, (b, k)).astype(np.float32),
        mask.cpu().numpy() & (rng.random((b, k)) < 0.8)))

    def fresh():
        table = type(init.table)(*(x.clone() for x in init.table))
        ident = k2.IdentityState(*(x.clone() for x in (init.gid, init.sim, init.unk,
                                                        init.pending)))
        return table, ident

    def kernel(stats=None):
        """(table, identity, outputs, identity outputs), the identity's None without it."""
        table, ident = fresh()
        if identity:
            return k2.track_scan(table, ident, boxes, mask, *det, cfg, 0.7, 1, stats=stats)
        table, out = k2.sort_scan(table, boxes, mask, cfg, stats=stats)
        return table, None, out, None

    def plain():
        table, ident = fresh()
        if identity:
            return k2.track_scan_plain(table, ident, boxes, mask, *det, cfg, 0.7, 1)
        table, out = k2.sort_scan_plain(table, boxes, mask, cfg)
        return table, None, out, None

    stats_t = torch.zeros(len(k2.STATS), dtype=torch.int64, device=dev)
    launches0 = k2.launches
    got = kernel(stats_t)
    torch.cuda.synchronize()  # a fault of this case shows here, not later
    check(k2.launches == launches0 + 1, f"K2 {case}: {k2.launches - launches0} launches")
    wanted = []  # the plain version's one run, timed by CUDA events
    plain_ms = event_ms(lambda: wanted.append(plain()), 1)
    want = wanted[0]
    stats = dict(zip(k2.STATS, stats_t.tolist()))
    (table, ident, out, iout), (ptable, pident, pout, piout) = got, want
    for name in ("tid", "mask", "src_det", "age"):
        check(torch.equal(getattr(out, name), getattr(pout, name)),
              f"K2 {case}: {name} differs from the plain version")
    for name in ("tid", "age", "tsu", "hits", "streak", "active", "next_id"):
        check(torch.equal(getattr(table, name), getattr(ptable, name)),
              f"K2 {case}: the table's {name} differs from the plain version's")
    box_err = int((out.boxes - pout.boxes).abs().max()) if b else 0
    check(box_err == 0, f"K2 {case}: boxes differ by {box_err} px")
    act = ptable.active
    err = {}
    for name in ("x", "p"):  # the same roundings in the same order: equal
        a, w = getattr(table, name)[act], getattr(ptable, name)[act]
        err[name] = float((a - w).abs().max()) if a.numel() else 0.0
        check(err[name] == 0.0, f"K2 {case}: the active tracks' {name} differs from the plain "
              f"version's by {err[name]}")
    enrolments = 0
    if identity:
        for name, a, w in zip(iout._fields + ident._fields, (*iout, *ident), (*piout, *pident)):
            check(torch.equal(a, w), f"K2 {case}: {name} differs from the plain version")
        enrolments = int(iout.enroll.sum())

    # each timed call starts from the same state, restored into one working copy
    work = fresh()
    start = (*init.table, init.gid, init.sim, init.unk, init.pending)

    def restore():
        for dst, src in zip((*work[0], *work[1]), start):
            dst.copy_(src)

    def launch():
        if identity:
            k2.track_scan(*work, boxes, mask, *det, cfg, 0.7, 1)
        else:
            k2.sort_scan(work[0], boxes, mask, cfg)

    def timed(fn, reps):
        times = []
        for _ in range(reps):
            restore()
            torch.cuda.synchronize()
            times.append(event_ms(fn, 1))
        return median(times)

    kernel_ms = timed(launch, 9)
    # the card alone: replays of (restore, launch) less replays of the restore
    device_ms = graph_ms(lambda: (restore(), launch()), 10) - graph_ms(restore, 10)
    bound_ms, bound_by = k2_bound_ms(b, k, t, identity, stats)
    rec = {"case": case, "assignment": assignment, "B": b, "T": t, "K": k, "identity": identity,
           "frames_tracked_before": warm, "box_err_px": box_err, "x_err": err["x"],
           "p_err": err["p"], "max_abs_err": max(err.values()), "stats": stats,
           "enrolments": enrolments, "confirmed": int(out.mask.sum()), "ms": kernel_ms,
           "device_ms": device_ms, "device_ms_per_frame": device_ms / b, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "device_ms_over_bound": device_ms / bound_ms,
           "phases": k2_phases(stats, b, device_ms), "launch_plan": k2.launch_plan(t, k)._asdict()}
    emit({"phase": "kernels", "kernel": k2.NAME, **rec})
    return rec



def _frames(seed: int, n_scenes: int, per_scene: int, n_faces=(1, 1)):
    import numpy as np

    from fire_tpu_torch.train.scenes import compose_scene, make_identities

    idents = make_identities(8, seed=seed)
    rng = np.random.default_rng(seed)
    scenes = [compose_scene(rng, idents, hw=(1080, 1920), n_faces=n_faces, face_px=(180, 360))[0]
              for _ in range(n_scenes)]
    return [s for s in scenes for _ in range(per_scene)]


def _gallery_rows(ctx):
    import numpy as np

    if "gallery_rows" not in ctx:
        g = unit_rows(np.random.default_rng(0), N_GALLERY, DIM)
        ctx["gallery_rows"] = [(i + 1, f"person_{i}", g[i].tobytes()) for i in range(N_GALLERY)]
    return ctx["gallery_rows"]


def _trained(name: str) -> str:
    return os.path.join(REPO, "weights_trained", name)


def _tracked_fraction(faces_per_frame, per_scene: int, warm: int) -> float:
    """Share of the frames past each scene's first ``warm`` (the tracker
    confirms nothing earlier) that carry at least one face."""
    after = [n for i, n in enumerate(faces_per_frame) if i % per_scene >= warm]
    return sum(1 for n in after if n > 0) / max(len(after), 1)


class _QuerySizes:
    """Records the query count M of every K1 call the gallery makes while
    it is active (the gallery module's own reference to the wrapper is
    swapped for one that notes M and calls through), in ``k1``, and of
    every k = 1 query of a non-empty ``ShardedGalleryView`` (the queries
    the gallery itself would send to K1), in ``view``.  The
    recognizer queries through the view when the machine has more than
    one card, as JAX's does with more than one chip: its per-shard
    search is plain torch, as JAX's is ``jnp.dot`` and ``lax.top_k``,
    so those queries launch no K1."""

    def __enter__(self):
        from fire_tpu_torch.gallery import index

        self.k1, self.view = [], []
        self._index, self._real = index, (index.cosine_top1, index.ShardedGalleryView.query_batch)
        real_k1, real_view = self._real

        def noting(q, g, count):
            self.k1.append(int(q.shape[0]))
            return real_k1(q, g, count)

        def noting_view(view, embeddings, k=1):
            if view.count and k == 1:
                self.view.append(len(embeddings))
            return real_view(view, embeddings, k)

        index.cosine_top1, index.ShardedGalleryView.query_batch = noting, noting_view
        return self

    def __exit__(self, *exc):
        self._index.cosine_top1, self._index.ShardedGalleryView.query_batch = self._real


def _check_queries(what: str, k1: tuple, view: tuple, want: int, exact: bool = False,
                   max_m: int = 0) -> None:
    """The recognizer's identity queries, ``k1`` and ``view`` each a pair
    (queries, their sizes M).  On one card they go through K1 and never
    through the sharded view; on several, where the recognizer adopts the
    view by itself as JAX's does, through the view and never K1.  ``want``
    of them at least (exactly, with ``exact``), and with ``max_m`` each of
    M 1…``max_m``."""
    import torch

    if torch.cuda.device_count() > 1:
        route, (n, sizes), other = "the sharded view", view, k1[0]
    else:
        route, (n, sizes), other = "K1", k1, view[0]
    check((n == want if exact else n >= want) and other == 0
          and (not max_m or 1 <= max(sizes, default=0) <= max_m),
          f"{what}: {n} queries through {route} at M {sorted(set(sizes))} for "
          f"{'' if exact else 'at least '}{want}, {other} through the other route")


class _Calls:
    """Counts the calls of ``owner.name`` while active (the attribute is
    swapped for a wrapper that counts and calls through)."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.n = owner, name, 0

    def __enter__(self):
        self._real = real = getattr(self.owner, self.name)

        def counting(*args, **kw):
            self.n += 1
            return real(*args, **kw)

        setattr(self.owner, self.name, counting)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._real)


class _batch_steps:
    """Counts the batches stepped, one per stream: each eager
    ``BatchStreamEngine.step`` and each stream of a ``StepGraph`` replay
    (the warm-up and the capture of a graph call neither)."""

    def __enter__(self):
        from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine, StepGraph

        self.n, owner = 0, self
        self._real = step, replay = BatchStreamEngine.step, StepGraph.replay

        def counting_step(*args, **kw):
            owner.n += 1
            return step(*args, **kw)

        def counting_replay(graph):
            owner.n += len(graph.packed)
            return replay(graph)

        BatchStreamEngine.step, StepGraph.replay = counting_step, counting_replay
        return self

    def __exit__(self, *exc):
        from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine, StepGraph

        BatchStreamEngine.step, StepGraph.replay = self._real


YUNET = dict(detector_type="yunet", trained_detector=_trained("yunet_synth.msgpack"))


def _retina():
    from fire_tpu_torch.config import EngineConfig

    # the CLI's sizing rule: the committed weights are trained at 512²
    return dict(detector_type="retinaface", engine_cfg=EngineConfig(retinaface_size=(512, 512)),
                trained_detector=_trained("retinaface_synth.msgpack"))


def _batched_run(ctx, storage: str, detector: dict):
    """``process_frames(batch_size=64)`` at full width against the
    99,900-row gallery, after a warm-up batch.  Returns the recognizer
    (still open) and what the phase checks and prints."""
    import torch

    from fire_tpu_torch.config import TrackerConfig
    from fire_tpu_torch.ops import bn_act as k3
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition
    from fire_tpu_torch.track import scan as k2

    fr = FaceRecognition(
        encoder_model_type="512", similarity_threshold=0.7,
        unknown_trigger_count=1, detection_interval=1, enable_logging=False,
        storage_root=storage, tracker_cfg=TrackerConfig(assignment="hungarian"),
        trained_encoder=_trained("facenet512_synth.msgpack"), device="cuda", **detector)
    fr.gallery.load_rows(_gallery_rows(ctx))
    check(fr.gallery.count == N_GALLERY and fr.gallery.padded == PADDED_ROWS, "gallery size")

    # warm-up batch (cuDNN plans, allocator) on other identities
    fr.process_frames(_frames(seed=1, n_scenes=2, per_scene=BATCH // 2), annotate=False,
                      batch_size=BATCH)
    sql_before = fr.db_manager.count()

    per_scene = 32
    n_scenes = 2 * BATCH // per_scene
    frames = _frames(seed=0, n_scenes=n_scenes, per_scene=per_scene)
    faces_per_frame = []
    torch.cuda.reset_peak_memory_stats()
    with _batch_steps() as steps:
        k1.reset_launches()
        k2.reset_launches()
        k3_0 = k3.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr.process_frames(frames, annotate=False, batch_size=BATCH,
                          on_frame=lambda f, faces: faces_per_frame.append(len(faces)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, k2_launches, k3_launches = k1.launches, k2.launches, k3.launches - k3_0
    n_batches = len(frames) // BATCH
    added = fr.db_manager.count() - sql_before

    # warm-up: a scene's first min_hits frames carry no confirmed track
    tracked = _tracked_fraction(faces_per_frame, per_scene, TrackerConfig().min_hits)
    name = fr.cfg.detector_type
    check(len(faces_per_frame) == len(frames), f"{name}: every frame produced a result")
    check(launches >= n_batches, f"{name}: K1 launched {launches} times for {n_batches} batches")
    check(k2_launches == steps.n == n_batches,
          f"{name}: K2 launched {k2_launches} times for {steps.n} steps of {n_batches} batches")
    # a step detects its frames once and encodes its crops once, graphed or eager
    k3_per_step = _bn_layers(fr.engine._detector_net) + _bn_layers(fr.engine._encoder_net)
    check(k3_launches == k3_per_step * steps.n,
          f"{name}: K3 launched {k3_launches} times in {steps.n} steps of "
          f"{k3_per_step} BatchNorms")
    check(tracked >= 0.9, f"{name}: faces tracked in {tracked:.3f} of the frames after warm-up")
    # each scene's one face is enrolled at most once, and something is
    check(1 <= added <= n_scenes, f"{name}: {added} enrolments for {n_scenes} one-face scenes")
    totals = fr.timer.totals
    stages = {k: round(v / n_batches * 1e3, 3) for k, v in totals.items()}
    return fr, {"graphs": graph_records(fr._batch_engines), "frames": len(frames),
                "batch": BATCH, "batches": n_batches,
                "frames_per_s": len(frames) / wall, "wall_s": wall, "k1_launches": launches,
                "k2_launches": k2_launches, "k3_launches": k3_launches,
                "k3_launches_per_step": k3_per_step, "tracked_fraction": tracked, "sqlite_rows_added": added,
                "gallery_count": fr.gallery.count, "stage_ms_per_batch": stages,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_main_path(ctx) -> None:
    fr, rec = _batched_run(ctx, ctx["tmp"], YUNET)
    ctx["k1_launches"] = rec["k1_launches"]
    ctx["k2_launches"] = rec["k2_launches"]
    ctx["k3_launches"] = rec["k3_launches"]
    ctx["fr"] = fr  # the trace phase runs it once more, then closes it
    emit({"phase": "main_path", **rec})
    emit({"phase": "main_path", "check": "submit syncs", **submit_syncs(fr)})
    emit({"phase": "main_path", "check": "graph vs eager", **graph_vs_eager(fr)})
    emit({"phase": "main_path", "check": "eager stages", **eager_stages(fr)})
    emit({"phase": "main_path", "check": "outstanding tokens", **outstanding_tokens(fr)})


class _graph_builds:
    """Records every step graph built while active: its streams, the
    shape of its first stream's frames, capture seconds and the memory
    the capture added to the device's graph pool."""

    def __enter__(self):
        from fire_tpu_torch.pipeline.batch_engine import StepGraph

        self.records = []
        self._real = real = StepGraph.__init__

        def noting(graph, *args, **kw):
            real(graph, *args, **kw)
            self.records.append({"streams": len(graph.frames),
                                 "frames": list(graph.frames[0].shape),
                                 "capture_s": graph.capture_s,
                                 "pool_gb": graph.pool_bytes / 1e9})

        StepGraph.__init__ = noting
        return self.records

    def __exit__(self, *exc):
        from fire_tpu_torch.pipeline.batch_engine import StepGraph

        StepGraph.__init__ = self._real


def graph_records(engines) -> list:
    """Each step graph of the recognizer's kept batch engines: its
    streams and frames' shape, capture seconds and the memory the capture
    reserved."""
    return [{"streams": key[1], "frames": list(key[2]), "capture_s": g.capture_s,
             "pool_gb": g.pool_bytes / 1e9}
            for engine in engines.values() for key, g in engine.graphs]


def eager_stages(fr, reps: int = 3) -> dict:
    """The per-stage device times of the main path's batch, from the
    eager step (the graph replays as one stage): CUDA events around each
    stage, ms a batch, the median of ``reps`` steps after a warm one."""
    import numpy as np
    import torch

    from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine, clone_state
    from fire_tpu_torch.pipeline.timing import StageTimer

    frames = torch.from_numpy(np.stack(_frames(seed=0, n_scenes=2, per_scene=BATCH // 2))).cuda()
    bse = BatchStreamEngine(fr.engine, fr.gallery, fr.cfg)
    runs = []
    for i in range(reps + 1):
        bse.timer = StageTimer()
        with torch.inference_mode():
            bse.step(fr.engine, fr.gallery.gal_matmul, fr.gallery.count_dev,
                     clone_state(bse.state), frames)
        bse.timer.resolve()
        if i:
            runs.append(bse.timer.totals)
    return {"source": "eager step (the graph's plain version), CUDA events a stage",
            "batch": BATCH,
            "stage_ms_per_batch": {k: median([r[k] for r in runs]) * 1e3 for k in runs[0]}}


def outstanding_tokens(fr, n: int = 5, batch: int = 16) -> dict:
    """Five distinct batches submitted to a ``BatchStreamEngine`` before
    any is collected, then collected in order, each against
    ``process_batch`` on a second engine one batch at a time; then five
    steps of a two-stream ``MultiStreamEngine`` (this card twice) against
    ``process_batches`` on a second one.  Every field equal (floats to
    1e-6): each token owns its readback buffer until it is collected."""
    import numpy as np

    from fire_tpu_torch.parallel.mesh import make_mesh
    from fire_tpu_torch.parallel.multistream import MultiStreamEngine
    from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine

    batches = [np.stack(_identity_frames(i, 900 + i, 2, batch // 2)) for i in range(n)]

    def same(got, want, what):
        for name in got._fields:
            g, w = getattr(got, name), getattr(want, name)
            ok = (np.array_equal(g, w) if g.dtype.kind != "f"
                  else float(np.abs(g - w).max(initial=0.0)) <= 1e-6)
            check(ok, f"outstanding tokens: {what}: {name} differs from the one-at-a-time run")

    bse, ref = (BatchStreamEngine(fr.engine, fr.gallery, fr.cfg) for _ in range(2))
    tokens = [bse.submit(x) for x in batches]
    buffers = len({t[0].host.data_ptr() for t in tokens})
    check(buffers == n, f"outstanding tokens: {n} tokens hold {buffers} buffers")
    confirmed = 0
    for i, (token, x) in enumerate(zip(tokens, batches)):
        got = bse.collect(token)
        same(got, ref.process_batch(x), f"batch {i}")
        confirmed += int(got.mask.sum())
    check(confirmed > 0, "outstanding tokens: no track confirmed")
    mesh = make_mesh(devices=["cuda:0"] * 2)
    mse, mref = (MultiStreamEngine(fr.engine, fr.gallery, fr.cfg, mesh) for _ in range(2))
    steps = [np.stack([batches[i], batches[(i + 1) % n]]) for i in range(n)]
    tokens = [mse.submit(x) for x in steps]
    for i, (token, x) in enumerate(zip(tokens, steps)):
        for s, (got, want) in enumerate(zip(mse.collect(token), mref.process_batches(x))):
            same(got, want, f"step {i} stream {s}")
    return {"tokens": n, "batch": batch, "buffers": buffers, "confirmed": confirmed,
            "multistream": {"streams": 2, "steps": n}}


def _count_syncs(fn):
    """``fn()``'s result and the synchronising CUDA operations it made
    (``torch.cuda.set_sync_debug_mode("warn")``, where each is a warning),
    each named by the lines that called it."""
    import traceback
    import warnings

    import torch

    syncs = []

    def note(message, category, filename, lineno, file=None, line=None):
        # torch's own words; its one-time note that the mode is a prototype is not a sync
        if "called a synchronizing cuda operation" in str(message).lower():
            syncs.append(" < ".join(f"{os.path.relpath(fr.filename, REPO)}:{fr.lineno}"
                                    for fr in traceback.extract_stack()[-5:-1][::-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, syncs


def submit_syncs(fr) -> dict:
    """The synchronising operations of one warm ``BatchStreamEngine.submit``
    of 64 host frames (numpy, 1080p) on the main path's engine and gallery,
    stage timer off, counted by ``torch.cuda.set_sync_debug_mode("warn")``:
    none with the bucket ladder (the rung is chosen on the card, inside
    the step graph) and none with ``encode_budget=64``; none either for
    one ``MultiStreamEngine.submit`` of two streams on this card.  With the
    wall times of that ``submit`` and of the ``collect`` after it."""
    import numpy as np
    import torch

    from fire_tpu_torch.parallel.mesh import make_mesh
    from fire_tpu_torch.parallel.multistream import MultiStreamEngine
    from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine

    frames = [np.stack(_frames(seed=8 + i, n_scenes=2, per_scene=BATCH // 2)) for i in range(2)]
    mesh = make_mesh(devices=["cuda:0"] * 2)
    engines = (("ladder", BatchStreamEngine(fr.engine, fr.gallery, fr.cfg), frames),
               ("encode_budget=64",
                BatchStreamEngine(fr.engine, fr.gallery, fr.cfg, encode_budget=64), frames),
               ("two streams", MultiStreamEngine(fr.engine, fr.gallery, fr.cfg, mesh),
                [np.stack([x, x[::-1]]) for x in frames]))
    out = {}
    for name, engine, batches in engines:
        engine.collect(engine.submit(batches[0]))  # warm: the capture, the pinned buffers
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        token, syncs = _count_syncs(lambda: engine.submit(batches[1]))
        t_submit = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = engine.collect(token)
        t_collect = time.perf_counter() - t0
        confirmed = int(sum(r.mask.sum() for r in (res if isinstance(res, list) else [res])))
        out[name] = {"syncs": len(syncs), "at": syncs, "submit_ms": t_submit * 1e3,
                     "collect_ms": t_collect * 1e3, "confirmed": confirmed}
        check(not syncs, f"submit syncs ({name}): {len(syncs)} where none was expected, at {syncs}")
        check(confirmed > 0, f"submit syncs ({name}): no track confirmed")
    return {"batch": BATCH, **out}


def _crowd_frames(seed: int, faces: int, n: int):
    """``n`` 1080p frames of ``faces`` faces each that fit without overlap
    (the crowd bench's scenes), 8 scenes taking turns."""
    from fire_tpu_torch.bench.crowd import crowd_scenes
    from fire_tpu_torch.train.scenes import make_identities

    import numpy as np

    scenes = crowd_scenes(np.random.default_rng(seed), make_identities(16, seed=seed), faces,
                          hw=(1080, 1920))
    return np.stack([scenes[i % len(scenes)][0] for i in range(n)])


def _same_results(got, want, what: str) -> dict:
    """Ids, masks, enrol flags and track ids equal; boxes within 1 px,
    similarities within 1e-3."""
    import numpy as np

    for f in ("tid", "gid", "mask", "enroll", "enroll_frame", "enroll_slot"):
        check(np.array_equal(getattr(got, f), getattr(want, f)), f"{what}: {f} differs")
    box = int(np.abs(got.boxes.astype(np.int64) - want.boxes).max())
    sim = float(np.abs(got.sim - want.sim).max())
    check(box <= 1 and sim <= 1e-3, f"{what}: boxes {box} px, sims {sim} apart")
    return {"box_err_px": box, "sim_err": sim}


def graph_vs_eager(fr) -> dict:
    """The step graph against its plain version, the eager step, at full
    width on the 99,900-row gallery.  B = 64's ladder is (64, 256, 512):
    half a batch of one-face scenes (the rest blank), three faces a frame
    and eight faces a frame reach its three rungs, which the graph
    records on the card.  Each replay's results equal the eager step's on
    a copy of the same state.  Then a face the replay flagged is enrolled
    into the gallery, and the next replay matches it without a new
    capture.  Then two streams on this card, one graph for both, against
    the eager step of each."""
    import numpy as np
    import torch

    from fire_tpu_torch.parallel.mesh import make_mesh
    from fire_tpu_torch.parallel.multistream import MultiStreamEngine
    from fire_tpu_torch.pipeline import batch_engine as be

    one = np.stack(_frames(seed=30, n_scenes=1, per_scene=BATCH))
    one[BATCH // 2:] = 0
    batches = [one, _crowd_frames(31, 3, BATCH), _crowd_frames(32, 8, BATCH)]
    gallery = fr.gallery

    def eager(engine, frames, state):
        with torch.inference_mode():
            _, packed = engine.step(engine.engine, gallery.gal_matmul, gallery.count_dev,
                                    be.clone_state(state), torch.from_numpy(frames).cuda())
        return be.unpack_results(packed.cpu().numpy(), frames.shape[0], engine.tcfg.max_tracks,
                                 engine.cfg.embedding_dim)

    bse = be.BatchStreamEngine(fr.engine, gallery, fr.cfg)
    rungs, errs = [], []
    for i, frames in enumerate(batches + batches[:1]):
        want = eager(bse, frames, bse.state)
        got = bse.process_batch(frames)
        graph = next(g for _, g in bse.graphs)
        rungs.append(int(graph.rungs[0]))
        errs.append(_same_results(got, want, f"graph vs eager, batch {i} (rung {rungs[-1]})"))
    check(sorted(set(rungs)) == [0, 1, 2], f"graph vs eager: rungs reached {rungs}")
    # an enrolment between two replays
    flagged = np.nonzero(got.enroll_frame >= 0)[0]
    check(len(flagged) > 0, "graph vs eager: no face flagged for enrolment")
    emb = got.enroll_emb[flagged[0]] / np.linalg.norm(got.enroll_emb[flagged[0]])
    row = gallery.count
    fr.enroll_unknown_now(emb, rename_label="graph check")
    check(gallery.count == row + 1, "graph vs eager: the enrolment did not reach the gallery")
    want = eager(bse, batches[0], bse.state)
    got = bse.process_batch(batches[0])
    errs.append(_same_results(got, want, "graph vs eager after an enrolment"))
    check(len(list(bse.graphs)) == 1, "graph vs eager: the enrolment caused a new capture")
    check(bool((got.gid[got.mask] == row).any()), "graph vs eager: the enrolled face not matched")
    # two streams, one graph
    mse = MultiStreamEngine(fr.engine, gallery, fr.cfg, make_mesh(devices=["cuda:0"] * 2))
    for step in range(2):
        frames = np.stack([batches[2 * step], batches[1]])
        want = [eager(mse.inner, frames[s], mse.states[s]) for s in range(2)]
        got2 = mse.process_batches(frames)
        for s in range(2):
            errs.append(_same_results(got2[s], want[s], f"two streams, step {step}, stream {s}"))
    graph = next(g for _, g in bse.graphs)
    return {"rungs": rungs, "box_err_px": max(e["box_err_px"] for e in errs),
            "sim_err": max(e["sim_err"] for e in errs), "enrolled_row_matched": row,
            "captures": len(list(bse.graphs)), "two_stream_captures": len(list(mse.graphs)),
            "capture_s": graph.capture_s, "pool_gb": graph.pool_bytes / 1e9}


def phase_retina_path(ctx) -> None:
    """The batched path with RetinaFace at 512² (its detect stage is
    ResNet-50 + FPN + SSH over 64 frames, then decode + NMS)."""
    fr, rec = _batched_run(ctx, os.path.join(ctx["tmp"], "retina_path"), _retina())
    ctx["fr_retina"] = fr  # traced too, then closed, by the trace phase
    ctx["k1_launches_retina_path"] = rec["k1_launches"]
    ctx["k2_launches_retina_path"] = rec["k2_launches"]
    ctx["k3_launches_retina_path"] = rec["k3_launches"]
    emit({"phase": "retina_path", "detector": "retinaface-512", **rec})


def phase_bench(ctx) -> None:
    """The measurement plane, ``fire_tpu_torch.bench``, through its own
    functions at cut trials: the gallery A/B (K1's results there against
    its plain version), the headline at B = 128 and 256 (1 warm-up, 2
    trials of 2 steps, a 2-step chain), one trial each of the full-cost,
    frame-skip and in-RAM legs, the tracker A/B (2 trials) and the crowd
    curve at 1 and 16 faces a frame (2 trials).  K1's launches are counted
    per bench, comparisons left out.  Gates: K1 equal to the plain version
    (|Δsim| ≤ 1e-5, equal indices), every frames/s above 0, and the
    detector's faces a frame at 1 face within 0.1 of 1.  (The crowd's own
    ``detected_per_frame`` counts confirmed tracks, as the JAX tool's
    does; its scenes change every frame, so that stays near 0.)"""
    import numpy as np
    import torch

    from fire_tpu_torch.bench import common, crowd, gallery, headline, tracker
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.track import scan as k2
    from fire_tpu_torch.train.scenes import make_identities
    from fire_tpu_torch.utils import imageio

    dev = torch.device("cuda")
    t_phase = time.perf_counter()

    inputs = gallery.make_inputs(dev)
    k1.reset_launches()
    rec = gallery.run(dev, inputs=inputs)
    launches = k1.launches
    for b, q in inputs["queries"].items():
        sims, idx = k1.cosine_top1(q, inputs["gal16"], inputs["count"])
        ps, pi = k1.plain_cosine_top1(q, inputs["gal16"], inputs["count"])
        err = float((sims - ps).abs().max())
        rec[f"k1_vs_plain_B{b}"] = {"max_abs_err": err, "index_equal": bool((idx == pi).all())}
        check(err <= 1e-5, f"bench gallery: K1 differs from the plain version by {err} at M={b}")
        check(rec[f"k1_vs_plain_B{b}"]["index_equal"],
              f"bench gallery: K1's indices differ from the plain version's at M={b}")
    ctx["k1_launches_bench"] = {"gallery": launches}
    emit({"phase": "bench", "bench": "gallery", **rec, "k1_launches": launches})
    del inputs

    fr, frames = common.setup_headline(os.path.join(ctx["tmp"], "bench"), dev)
    with contextlib.closing(fr), _batch_steps() as steps, _graph_builds() as graphs:
        k1.reset_launches()
        k2.reset_launches()
        legs = {}
        for b in (128, 256):
            got = headline.headline_leg(fr, common.stage(frames, b, dev), warmup=1, trials=2,
                                        steps=2, chain=2, chain_reps=1)
            legs[f"headline_B{b}"] = {**common.spread(got["trial_fps"]),
                                      "device_ms_per_batch": got["chain_ms"],
                                      "device_ms_per_batch_cuda_events": got["chain_event_ms"]}
        legs["fullcost_fps"] = headline.engine_leg(fr, common.stage(frames, 128, dev), 1, 1, 2,
                                                   encode_buckets=())
        legs["frameskip_fps"] = headline.engine_leg(fr, common.stage(frames, 96, dev), 1, 1, 2,
                                                    detection_interval=3)
        save = os.path.join(ctx["tmp"], "bench", "out_inram.avi") if imageio.has_cv2() else None
        inram, host_plane, projected = headline.inram_leg(
            fr, frames, save, n_frames=128, batch_size=64,
            device_ms_b128=legs["headline_B128"]["device_ms_per_batch"])
        legs.update(e2e_inram_fps=inram, host_plane_ms_per_frame=host_plane,
                    projected_colocated_e2e_fps=projected,
                    inram_writer="XVID (cv2)" if save else "none (no cv2)")
        launches, k2_launches = k1.launches, k2.launches
    fps = [legs[f"headline_B{b}"]["min"] for b in (128, 256)]
    fps += legs["fullcost_fps"] + legs["frameskip_fps"] + [inram]
    ctx["k1_launches_bench"]["headline"] = launches
    ctx["k2_launches_bench"] = {"headline": k2_launches}
    emit({"phase": "bench", "bench": "headline", **legs, "k1_launches": launches,
          "k2_launches": k2_launches, "batch_steps": steps.n, "graphs": graphs})
    check(all(v > 0 for v in fps), f"bench headline: a frames/s is not above 0: {fps}")
    check(launches > 0, "bench headline: K1 was not launched")
    check(k2_launches == steps.n > 0,
          f"bench headline: K2 launched {k2_launches} times for {steps.n} batch steps")

    k2.reset_launches()
    rec = tracker.run(dev, batch=128, trials=2)
    ctx["k2_launches_bench"]["tracker"] = k2.launches
    emit({"phase": "bench", "bench": "tracker", **rec, "k2_launches": k2.launches})
    check(all(v > 0 for v in rec["variants"].values()), f"bench tracker: {rec}")
    # one launch a scan: each variant's warm-up and its two trials
    check(k2.launches == 3 * len(tracker.VARIANTS), f"bench tracker: K2 launched {k2.launches} "
          f"times for {3 * len(tracker.VARIANTS)} scans")

    fr, bse, rng = crowd.setup_crowd(os.path.join(ctx["tmp"], "bench_crowd"), dev)
    with contextlib.closing(fr), _batch_steps() as steps, _graph_builds() as graphs:
        idents = make_identities(32, seed=0)
        k1.reset_launches()
        k2.reset_launches()
        curve = []
        for n in (1, 16):
            batch = common.stage([s[0].astype(np.uint8) for s in crowd.crowd_scenes(
                rng, idents, n)], 32, dev)
            ms, tracked = crowd.measure(bse, batch, trials=2)
            with torch.inference_mode():
                found = float(fr.engine._build_detect(tuple(batch.shape[1:3]))(batch).mask.sum())
            curve.append({"faces_per_frame": n, "ms_per_frame": ms, "detected_per_frame": tracked,
                          "detector_faces_per_frame": found / 32})
        launches, k2_launches = k1.launches, k2.launches
    ctx["k1_launches_bench"]["crowd"] = launches
    ctx["k2_launches_bench"]["crowd"] = k2_launches
    emit({"phase": "bench", "bench": "crowd", "batch": 32, "curve": curve, "k1_launches": launches,
          "k2_launches": k2_launches, "batch_steps": steps.n, "graphs": graphs,
          "seconds": time.perf_counter() - t_phase})
    check(k2_launches == steps.n > 0,
          f"bench crowd: K2 launched {k2_launches} times for {steps.n} batch steps")
    check(abs(curve[0]["detector_faces_per_frame"] - 1.0) <= 0.1,
          f"bench crowd: the detector found {curve[0]['detector_faces_per_frame']} faces a "
          "frame in 1-face scenes")
    check(all(c["ms_per_frame"] > 0 for c in curve) and launches > 0, f"bench crowd: {curve}")


def phase_trace(ctx) -> None:
    """One more batch of the batched path, then 16 frames of the
    per-frame path, under ``torch.profiler``, with YuNet and with
    RetinaFace; then one full-width ArcFace step on one device, eager
    and then replaying its graph (captured before the trace), and the
    same two on the (2, 2) mesh of ``train_sharded`` (its graph captured
    there; over four distinct cards one graph spans them).  The profiler leaves
    launches slower for the rest of the process, so this phase comes
    after every phase that reports a time."""

    for key, detector in (("fr", "yunet-640"), ("fr_retina", "retinaface-512")):
        fr = ctx.pop(key)
        try:
            emit({**trace_frames(fr, _frames(seed=3, n_scenes=2, per_scene=BATCH // 2)),
                  "detector": detector})
            fr.process_frames(_frames(seed=6, n_scenes=1, per_scene=8, n_faces=(1, 3)),
                              annotate=False, batch_size=0)  # warm-up of this path
            frames = _frames(seed=7, n_scenes=2, per_scene=8, n_faces=(1, 3))
            emit({**trace_frames(fr, frames, batch_size=0), "detector": detector})
            # the same frames again once their tracks have died: every key
            # captured and every face enrolled before
            fr.process_frames([frames[0] * 0] * (fr.tracker_cfg.max_age + 2), annotate=False,
                              batch_size=0)
            emit({**trace_frames(fr, frames, batch_size=0), "detector": detector,
                  "window": "steady: the frames seen before"})
        finally:
            fr.close()
    step, state, images, labels = ctx.pop("arcface")
    step._graphed = lambda device: False  # the eager step first, then its graph
    state = trace_train_step(step, state, images, labels, "arcface train step, eager")
    del step._graphed
    state, _ = step(state, images, labels)  # the capture, outside the trace
    state = trace_train_step(step, state, images, labels, "arcface train step, graph",
                             max_launch_calls=10)
    step.release_graphs()
    trace_sharded_step(ctx)


def trace_sharded_step(ctx) -> None:
    """The sharded ArcFace step of ``train_sharded`` (its graph captured
    there) under ``torch.profiler``, eager and then replaying its graph."""
    step, state, images, labels = ctx.pop("arcface_sharded")
    check(len(step.graphs) == 1, f"trace: the sharded step holds {len(step.graphs)} graphs")
    step._graphed = lambda device: False
    state = trace_train_step(step, state, images, labels, "arcface train step, (2, 2) mesh, eager")
    del step._graphed
    state = trace_train_step(step, state, images, labels,
                             "arcface train step, (2, 2) mesh, graph", max_launch_calls=10)
    check(len(step.graphs) == 1, f"trace: the sharded step captured again ({len(step.graphs)})")
    step.release_graphs()


def trace_train_step(step, state, images, labels, path: str, max_launch_calls=None):
    """One ArcFace step under ``torch.profiler``, summed up by
    :func:`device_summary`; a graphed step's host launch calls (graph
    launches and copies) at most ``max_launch_calls``.  Returns the state."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _sync_all()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, images, labels)
        _sync_all()
        wall_ms = (time.perf_counter() - t0) * 1e3
    summary = device_summary(prof, wall_ms)
    calls = sum(summary["host_launch_calls"].values())
    emit({"phase": "trace", "path": path, "model": "facenet-512",
          "batch": int(images.shape[0]), **summary, "host_launch_calls_total": calls})
    check(bool(torch.isfinite(loss)), f"trace: the traced {path}'s loss is not finite")
    if max_launch_calls is not None:
        check(calls <= max_launch_calls,
              f"trace: the {path} made {calls} host launch calls: {summary['host_launch_calls']}")
    return state


def trace_frames(fr, frames, batch_size: int = BATCH) -> dict:
    """A few more frames of a path under ``torch.profiler``, summed up by
    :func:`device_summary`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    enrolled = fr.gallery.count
    with _frame_graphs() as built, profile(activities=[ProfilerActivity.CPU,
                                                       ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fr.process_frames(frames, annotate=False, batch_size=batch_size)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    summary = device_summary(prof, wall_ms)
    return {"phase": "trace", "path": "batched" if batch_size else "per-frame",
            "frames": len(frames), "enrolled_in_window": fr.gallery.count - enrolled,
            "captured_in_window": [b["kind"] for b in built.builds], **summary,
            "host_launch_calls_per_frame": sum(summary["host_launch_calls"].values()) / len(frames),
            "device_events_per_frame": summary["device_events"] / len(frames)}


def device_summary(prof, wall_ms: float) -> dict:
    """From a finished ``torch.profiler`` run over ``wall_ms`` of host
    time: the device's busy time (the union of its kernel and copy
    intervals), its idle share, and the kernels that take the most device
    time.  A trace that holds no device activity is reported as not
    measured (None)."""
    from torch.autograd import DeviceType

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
    # the host's calls that put work on the card: kernel launches, copies,
    # graph launches (one graph launch runs all of its kernels)
    host = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith(("cuda", "cu")) and (
                "Launch" in e.name or "Memcpy" in e.name or "Memset" in e.name):
            host[e.name] = host.get(e.name, 0) + 1
    return {"traced_wall_ms": wall_ms, "device_events": len(dev), "device_busy_ms": busy_ms,
            "idle_share_traced": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
            "host_launch_calls": host, "top_device_ms": {k: v / 1e3 for k, v in top}}


def _bn_layers(module) -> int:
    from fire_tpu_torch.models.layers import BatchNorm

    return sum(isinstance(m, BatchNorm) for m in module.modules())


def _graph_kind(key) -> str:
    """What a per-frame graph's key runs: ``detect``, ``detect extract``,
    ``encode_boxes 4`` (the bucket), ``encode_faces 8``, ``tracker step``."""
    if len(key) == 4:  # Sort: (device, cfg, max_dets, piece)
        return f"tracker {key[3]}"
    jit = key[1]
    if isinstance(jit[0], str):
        name = {"encb": "encode_boxes", "encl": "encode_landmarks", "encf": "encode_faces"}[jit[0]]
        return f"{name} {jit[1][0] if jit[0] == 'encf' else jit[2]}"
    return "detect" if isinstance(jit[0], int) else f"detect {jit[1]}"


class _frame_graphs:
    """While active, records every per-frame graph built (its kind, the
    recognizer's frame index then, capture seconds and the bytes the
    capture added to the device's pool), counts the replays by kind
    (detect, encode_*, tracker; of ``fr``'s graphs captured earlier too),
    and counts recaptures: a key captured again by a cache that had
    captured it before."""

    def __init__(self, fr=None):
        self.fr = fr

    def __enter__(self):
        import weakref

        from fire_tpu_torch.runtime import graphs

        self.builds, self.replays, self.recaptures = [], {}, 0
        kind_of, seen, owner = {}, weakref.WeakKeyDictionary(), self
        if self.fr is not None:  # graphs its engine captured before (an engine shared by runs)
            for key, graph in (*self.fr.engine.graphs, *self.fr.face_tracker.graphs):
                kind_of[id(graph)] = _graph_kind(key)
        self._real = get, replay = graphs.GraphCache.get, graphs.CapturedCall.replay

        def noting_get(cache, key, build, *devices):
            fresh = cache.find(key) is None
            graph = get(cache, key, build, *devices)
            if fresh and isinstance(graph, graphs.CapturedCall):
                keys = seen.setdefault(cache, set())
                owner.recaptures += key in keys
                keys.add(key)
                kind_of[id(graph)] = kind = _graph_kind(key)
                owner.builds.append({
                    "kind": kind, "frame": owner.fr.frame_index if owner.fr is not None else None,
                    "capture_s": graph.capture_s, "pool_gb": graph.pool_bytes / 1e9})
            return graph

        def counting_replay(graph):
            kind = kind_of.get(id(graph), "other").split()[0]
            owner.replays[kind] = owner.replays.get(kind, 0) + 1
            return replay(graph)

        graphs.GraphCache.get, graphs.CapturedCall.replay = noting_get, counting_replay
        return self

    def __exit__(self, *exc):
        from fire_tpu_torch.runtime import graphs

        graphs.GraphCache.get, graphs.CapturedCall.replay = self._real

    def record(self) -> dict:
        return {"captures": len(self.builds), "recaptures": self.recaptures,
                "capture_s_total": sum(b["capture_s"] for b in self.builds),
                "capture_s_max": max((b["capture_s"] for b in self.builds), default=0.0),
                "pool_gb_total": sum(b["pool_gb"] for b in self.builds),
                "replays": dict(self.replays),
                "captured": sorted({b["kind"] for b in self.builds})}

    def check(self, name: str, expect=("detect", "tracker", "encode_boxes")) -> None:
        check(self.recaptures == 0, f"{name}: {self.recaptures} keys captured again")
        for kind in expect:
            check(self.replays.get(kind, 0) > 0,
                  f"{name}: no {kind} graph replayed ({self.record()})")


def _same_faces_dicts(a, b) -> bool:
    """``detect_faces`` results equal: boxes, confidences, landmarks."""
    import numpy as np

    return len(a) == len(b) and all(
        x["bbox"] == y["bbox"] and x["confidence"] == y["confidence"]
        and np.array_equal(x["landmarks"], y["landmarks"]) for x, y in zip(a, b))


class _engine_vs_eager:
    """While active, each ``DeviceEngine.detect_faces`` / ``encode_*``
    call runs as called (on a card, a graph replay), then again on the
    same engine and arguments run eagerly (the plain version, ``_graphed``
    off); the two must be bitwise equal.  ``calls`` counts them by name."""

    NAMES = ("detect_faces", "encode_boxes", "encode_landmarks", "encode_faces")

    def __enter__(self):
        import numpy as np

        from fire_tpu_torch.pipeline.engine import DeviceEngine

        self.calls = {}
        self._real = {n: getattr(DeviceEngine, n) for n in self.NAMES}
        for name, real in self._real.items():
            def twice(eng, *args, real=real, name=name):
                out = real(eng, *args)
                eng._graphed = lambda device: False
                try:
                    want = real(eng, *args)
                finally:
                    del eng._graphed
                same = (_same_faces_dicts(out, want) if name == "detect_faces"
                        else np.array_equal(out, want))
                check(same, f"{name}: the graph's result differs from the eager call's")
                self.calls[name] = self.calls.get(name, 0) + 1
                return out

            setattr(DeviceEngine, name, twice)
        return self

    def __exit__(self, *exc):
        from fire_tpu_torch.pipeline.engine import DeviceEngine

        for name, real in self._real.items():
            setattr(DeviceEngine, name, real)


def frame_syncs(fr, frames) -> dict:
    """The synchronising CUDA calls of each of ``frames`` through
    ``fr.recognize_faces`` (``torch.cuda.set_sync_debug_mode("warn")``),
    on a second pass over them (the first captures any key they need)
    against what JAX reads back for that frame: detect 1 on a detecting
    frame, the tracker 1 (2 under ``hungarian_host``), each encode call 1,
    each gallery query 2.  Enrolment is held off meanwhile (the unknown
    trigger raised), so a frame with a new track is detect, track, encode
    and query alone; a frame that still enrols or captures is not held to
    the count.  Returns the counts."""
    eng, matcher = fr.engine, fr._matcher
    calls = {"encode": 0, "query": 0}
    real = {n: getattr(eng, n) for n in ("encode_boxes", "encode_landmarks")}
    real_query = matcher.query_batch

    def counting(name):
        def call(*args, **kw):
            calls["encode"] += 1
            return real[name](*args, **kw)
        return call

    def counting_query(*args, **kw):
        calls["query"] += 1
        return real_query(*args, **kw)

    for name in real:
        setattr(eng, name, counting(name))
    matcher.query_batch = counting_query
    tracker = 2 if fr.tracker_cfg.assignment == "hungarian_host" else 1
    rows, trigger = [], fr.unknown_trigger_count
    fr.unknown_trigger_count = 1 << 30
    try:
        with _frame_graphs(fr) as built:
            for frame in frames:  # a first pass captures what the frames need
                fr.recognize_faces(frame)
            for frame in frames:
                calls.update(encode=0, query=0)
                n_gal, n_built = fr.gallery.count, len(built.builds)
                _, syncs = _count_syncs(lambda: fr.recognize_faces(frame))
                detecting = fr.frame_index % fr.detection_interval == 0
                rows.append({"syncs": len(syncs), "at": syncs,
                             "budget": int(detecting) + tracker + calls["encode"]
                             + 2 * calls["query"],
                             "encodes": calls["encode"], "queries": calls["query"],
                             "enrolled": fr.gallery.count - n_gal,
                             "captured": [b["kind"] for b in built.builds[n_built:]]})
                rows[-1]["steady"] = not (rows[-1]["enrolled"] or rows[-1]["captured"])
    finally:
        fr.unknown_trigger_count = trigger
        for name in real:
            delattr(eng, name)
        del matcher.query_batch
    steady = [r for r in rows if r["steady"]]
    over = [r for r in steady if r["syncs"] > r["budget"]]
    check(not over, f"frame syncs: above JAX's readbacks on {len(over)} frames: {over[:2]}")
    full = [r for r in steady if r["encodes"] and r["queries"]]
    check(len(full) > 0, "frame syncs: no steady frame encoded and matched a new track: "
          f"{[(r['encodes'], r['queries'], r['enrolled'], r['captured']) for r in rows]}")
    worst = max(full, key=lambda r: r["syncs"])
    return {"frames": len(rows), "steady_frames": len(steady),
            "max_syncs_steady": max(r["syncs"] for r in steady),
            "syncs_new_track_frame": worst["syncs"], "budget_new_track_frame": worst["budget"],
            "at_new_track_frame": worst["at"],
            "syncs_by_frame": [r["syncs"] for r in rows],
            "budget_by_frame": [r["budget"] for r in rows]}


def _recording(fr):
    """``fr``'s per-frame outputs as it runs: each tracker update's tracks
    and each encode call's embeddings, in order."""
    seen = {"tracks": [], "embeddings": []}
    update = fr.face_tracker.update

    def noting_update(dets):
        out = update(dets)
        seen["tracks"].append(out)
        return out

    fr.face_tracker.update = noting_update
    for name in ("encode_boxes", "encode_landmarks"):
        real = getattr(fr.engine, name)

        def noting(frame, rows, real=real, name=name):
            out = real(frame, rows)
            seen["embeddings"].append((name, out.copy()))
            return out

        setattr(fr.engine, name, noting)
    return seen


def _frame_engine(detector: dict):
    """The engine a per-frame phase's recognizers share (FaceNet-512 and
    ``detector``, committed weights): one engine start a phase, its
    graphs kept across the phase's runs until ``release_graphs()``."""
    from fire_tpu_torch.config import EngineConfig, RecognizerConfig
    from fire_tpu_torch.pipeline.engine import DeviceEngine

    cfg = RecognizerConfig(detector_type=detector["detector_type"], encoder_model_type="512",
                           engine=detector.get("engine_cfg") or EngineConfig())
    eng = DeviceEngine(cfg.with_embedding_dim(), device="cuda")
    eng.load_trained_encoder(_trained("facenet512_synth.msgpack"))
    eng.load_trained_detector(detector["trained_detector"])
    return eng


def _on_engine(detector: dict) -> dict:
    """A recognizer's keywords for ``detector`` on an engine given to it."""
    return {k: v for k, v in detector.items() if k != "trained_detector"}


def frame_graph_vs_eager(storage: str, frames, detector: dict, engine, **fr_kw) -> dict:
    """The same frames through two recognizers on ``engine`` at full
    width on fresh storage, one replaying the per-frame graphs and one
    with the engine and its tracker run eagerly (their plain version,
    ``_graphed`` off): tracks, boxes, confidences and embeddings bitwise
    equal frame by frame, labels equal up to their random names (a
    bijection), and the same SQLite rows, embeddings bitwise."""
    import sqlite3

    import numpy as np

    from fire_tpu_torch.pipeline.recognizer import FaceRecognition

    runs = {}
    for mode in ("graph", "eager"):
        fr = FaceRecognition(
            encoder_model_type="512", similarity_threshold=0.7, unknown_trigger_count=1,
            enable_logging=False, storage_root=os.path.join(storage, mode), engine=engine,
            device="cuda", **_on_engine(detector), **fr_kw)
        try:
            if mode == "eager":
                engine._graphed = fr.face_tracker._graphed = lambda device: False
            seen = _recording(fr)
            with _frame_graphs(fr) as built:
                seen["faces"] = [fr.recognize_faces(f) for f in frames]
            seen["graphs"] = built.record()
            stem = f"{fr.cfg.detector_type}_512"
            db = os.path.join(storage, mode, f"{stem}_unencrypted", "db",
                              f"face_embeddings_{stem}.db")
        finally:
            for name in ("_graphed", "encode_boxes", "encode_landmarks"):  # _recording's too
                engine.__dict__.pop(name, None)
            fr.close()
        con = sqlite3.connect(db)
        try:
            seen["rows"] = list(con.execute("SELECT id, label, embedding FROM faces ORDER BY id"))
        finally:
            con.close()
        runs[mode] = seen
    g, e = runs["graph"], runs["eager"]
    check(g["tracks"] == e["tracks"], "frame graph vs eager: the tracks differ")
    check(len(g["embeddings"]) == len(e["embeddings"]) > 0
          and all(a[0] == b[0] and np.array_equal(a[1], b[1])
                  for a, b in zip(g["embeddings"], e["embeddings"])),
          "frame graph vs eager: the embeddings differ")
    labels = {}
    for f, (a, b) in enumerate(zip(g["faces"], e["faces"])):
        check([(d["bbox"], d["confidence"]) for d in a] == [(d["bbox"], d["confidence"])
                                                             for d in b],
              f"frame graph vs eager: frame {f}'s boxes or confidences differ")
        for da, db_ in zip(a, b):
            check(labels.setdefault(da["label"], db_["label"]) == db_["label"],
                  f"frame graph vs eager: frame {f}'s labels differ")
    check(len(set(labels.values())) == len(labels), "frame graph vs eager: labels merge")
    check(len(g["rows"]) == len(e["rows"]) > 0
          and all(ra[0] == rb[0] and labels.get(ra[1], ra[1]) == rb[1] and ra[2] == rb[2]
                  for ra, rb in zip(g["rows"], e["rows"])),
          "frame graph vs eager: the SQLite rows differ")
    check(not e["graphs"]["captures"], "frame graph vs eager: the eager run captured")
    return {"frames": len(frames), "tracker_updates": len(g["tracks"]),
            "encode_calls": len(g["embeddings"]), "faces": sum(len(x) for x in g["faces"]),
            "labels": len(labels), "sqlite_rows": len(g["rows"]), "bitwise_equal": True,
            "graphs": g["graphs"]}


def _per_frame_run(ctx, storage: str, frames, per_scene: int, warmup, detector: dict,
                   engine, **fr_kw) -> dict:
    """One ``process_frames(batch_size=0)`` run at full width on
    ``engine`` against the 99,900-row gallery; returns what the phase
    checks and prints."""
    import numpy as np
    import torch

    from fire_tpu_torch.ops import bn_act as k3
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition
    from fire_tpu_torch.track import scan as k2
    from fire_tpu_torch.track.sort import Sort

    fr = FaceRecognition(
        encoder_model_type="512", similarity_threshold=0.7,
        unknown_trigger_count=1, enable_logging=False, storage_root=storage, engine=engine,
        device="cuda", **_on_engine(detector), **fr_kw)
    try:
        fr.gallery.load_rows(_gallery_rows(ctx))
        check(fr.gallery.count == N_GALLERY and fr.gallery.padded == PADDED_ROWS, "gallery size")
        with _frame_graphs(fr) as built:
            # the graphs' captures, cuDNN plans, the allocator, and the first
            # enrolment, which writes the hydrated gallery's first snapshot
            # (204 MB) to disk
            fr.process_frames(warmup, annotate=False, batch_size=0)
            check(fr.counters["unknown_enrolled"] > 0, "frame_path: the warm-up enrolled nothing")
            warm_captures = len(built.builds)
            sql_before = fr.db_manager.count()
            counters_before = dict(fr.counters)

            # frames on which a track was encoded, by either crop
            encode_frames = {"boxes": set(), "landmarks": set()}
            for kind in encode_frames:
                real = getattr(fr.engine, f"encode_{kind}")

                def noting(frame, per_face, real=real, seen=encode_frames[kind]):
                    seen.add(fr.frame_index)
                    return real(frame, per_face)

                setattr(fr.engine, f"encode_{kind}", noting)

            faces_per_frame = []
            k1.reset_launches()
            k2.reset_launches()
            k3_0, replays0 = k3.launches, dict(built.replays)
            with _QuerySizes() as sizes, _Calls(Sort, "update") as updates:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fr.process_frames(frames, annotate=False, batch_size=0,
                                  on_frame=lambda f, faces: faces_per_frame.append(len(faces)))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches, k2_launches, k3_launches = k1.launches, k2.launches, k3.launches - k3_0
            replayed = {k: v - replays0.get(k, 0) for k, v in built.replays.items()}
        # each detect and each encode replays its network's BatchNorms once each
        k3_expected = (_bn_layers(fr.engine._detector_net) * replayed.get("detect", 0)
                       + _bn_layers(fr.engine._encoder_net) * sum(
                           v for k, v in replayed.items() if k.startswith("encode_")))
        for kind in encode_frames:
            delattr(fr.engine, f"encode_{kind}")
        n = len(frames)
        stage_ms = {k: v / n * 1e3 for k, v in fr.timer.totals.items()}
        stage_ms["other (H2D copy, enrolment, host loop)"] = (wall / n * 1e3
                                                             - sum(stage_ms.values()))
        rec = {
            "frames": n, "frames_per_s": n / wall, "ms_per_frame": wall / n * 1e3,
            "stage_ms_per_frame": stage_ms, "k1_launches": launches,
            "k2_launches": k2_launches, "k3_launches": k3_launches,
            "k3_launches_per_frame": k3_launches / len(frames),
            "k3_launches_expected": k3_expected, "graph_replays": replayed,
            "tracker_updates": updates.n,
            "k1_query_sizes": sorted(set(sizes.k1)), "view_query_sizes": sorted(set(sizes.view)),
            "view_queries": len(sizes.view),
            "encode_frames": len(encode_frames["boxes"] | encode_frames["landmarks"]),
            "encode_frames_aligned": len(encode_frames["landmarks"]),
            "results": len(faces_per_frame), "faces_per_frame_max": max(faces_per_frame, default=0),
            # a track is confirmed min_hits detections after its first one
            "tracked_fraction": _tracked_fraction(
                faces_per_frame, per_scene,
                fr.tracker_cfg.min_hits * fr.detection_interval + fr.detection_interval - 1),
            "sqlite_rows_added": fr.db_manager.count() - sql_before,
            "counters": {k: v - counters_before[k] for k, v in fr.counters.items()},
            "graphs": built.record(),
            "graphs_captured_in_timed_run": [b["kind"] for b in built.builds[warm_captures:]],
            "_graphs": built,
        }
        # then blank frames until every track has died, and the first scene
        # again: new tracks, matched in the caches and the gallery (no
        # enrolment)
        blank = [np.zeros_like(frames[0])] * (fr.tracker_cfg.max_age + 2)
        rec["syncs"] = frame_syncs(fr, blank + frames[: 8 * fr.detection_interval])
        # the tracker's frame alone: its graph (K2 and the packing) replayed
        # back to back on the last frame's detections, CUDA events
        step = next(g for key, g in fr.face_tracker.graphs if key[-1] == "step")
        rec["tracker_graph_replay_ms"] = cuda_ms_each({"replay": step.replay}, reps=50)["replay"]
        return rec
    finally:
        fr.close()


def _check_per_frame(rec: dict, name: str, built: "_frame_graphs",
                     encode=("encode_boxes",)) -> None:
    """The run's checks; ``built``: its graphs, which detect, the tracker
    and ``encode`` must have replayed, each key captured once."""
    built.check(name, ("detect", "tracker") + tuple(encode))
    check(rec["results"] == rec["frames"], f"{name}: every frame produced a result")
    check(rec["k3_launches"] == rec["k3_launches_expected"] > 0,
          f"{name}: K3 launched {rec['k3_launches']} times where the detect and encode "
          f"replays {rec['graph_replays']} hold {rec['k3_launches_expected']}")
    check(rec["k2_launches"] == rec["tracker_updates"] > 0,
          f"{name}: K2 launched {rec['k2_launches']} times for {rec['tracker_updates']} "
          "tracker updates")
    check(rec["tracked_fraction"] >= 0.9,
          f"{name}: faces tracked in {rec['tracked_fraction']:.3f} of the frames after warm-up")
    check(rec["sqlite_rows_added"] > 0, f"{name}: enrolments reached SQLite")
    check(rec["encode_frames"] > 0, f"{name}: no frame with a new track")
    _check_queries(f"{name}: frames with a new track", (rec["k1_launches"], rec["k1_query_sizes"]),
                   (rec["view_queries"], rec["view_query_sizes"]), rec["encode_frames"], max_m=8)
    check(rec["counters"]["tier1_track_cache"] > 0, f"{name}: the track cache was never hit")


def phase_frame_path(ctx) -> None:
    """The per-frame loop on 64 frames (2 scenes × 32, 1–3 faces), then a
    shorter run that skips detection on two frames of three and encodes
    landmark-aligned crops; every run on one engine."""
    eng = _frame_engine(YUNET)
    try:
        per_scene = 32
        warmup = _frames(seed=1, n_scenes=2, per_scene=8, n_faces=(1, 3))
        rec = _per_frame_run(ctx, os.path.join(ctx["tmp"], "frame_path"),
                             _frames(seed=0, n_scenes=2, per_scene=per_scene, n_faces=(1, 3)),
                             per_scene, warmup, YUNET, eng, detection_interval=1)
        built = rec.pop("_graphs")
        emit({"phase": "frame_path", "run": "detect every frame, box crops", **rec})
        _check_per_frame(rec, "frame_path", built)
        check(rec["tracker_updates"] == rec["frames"],
              f"frame_path: {rec['tracker_updates']} tracker updates for {rec['frames']} frames")
        ctx["k1_launches_frame_path"] = rec["k1_launches"]
        ctx["k2_launches_frame_path"] = rec["k2_launches"]
        ctx["k3_launches_frame_path"] = rec["k3_launches"]
        emit({"phase": "frame_path", "check": "frame graph vs eager",
              "run": "detect every frame, box crops",
              **frame_graph_vs_eager(os.path.join(ctx["tmp"], "frame_path_vs_eager"),
                                     _frames(seed=0, n_scenes=2, per_scene=12, n_faces=(1, 3)),
                                     YUNET, eng, detection_interval=1)})

        per_scene = 36
        rec = _per_frame_run(ctx, os.path.join(ctx["tmp"], "frame_path_aligned"),
                             _frames(seed=4, n_scenes=2, per_scene=per_scene, n_faces=(1, 3)),
                             per_scene, _frames(seed=1, n_scenes=1, per_scene=18, n_faces=(1, 3)),
                             YUNET, eng, detection_interval=3, align_video=True)
        built = rec.pop("_graphs")
        emit({"phase": "frame_path", "run": "detection_interval=3, align_video", **rec})
        _check_per_frame(rec, "frame_path (interval 3, aligned)", built, ("encode_landmarks",))
        check(rec["encode_frames_aligned"] > 0, "frame_path: no landmark-aligned crop was encoded")
        emit({"phase": "frame_path", "check": "frame graph vs eager",
              "run": "detection_interval=3, align_video",
              **frame_graph_vs_eager(os.path.join(ctx["tmp"], "frame_path_aligned_vs_eager"),
                                     _frames(seed=4, n_scenes=2, per_scene=15, n_faces=(1, 3)),
                                     YUNET, eng, detection_interval=3, align_video=True)})
    finally:
        eng.release_graphs()


def phase_retina_frame(ctx) -> None:
    """The per-frame loop's first run (64 frames, 1–3 faces, detect every
    frame) with RetinaFace at 512²."""
    per_scene = 32
    detector = _retina()
    eng = _frame_engine(detector)
    try:
        rec = _per_frame_run(ctx, os.path.join(ctx["tmp"], "retina_frame"),
                             _frames(seed=0, n_scenes=2, per_scene=per_scene, n_faces=(1, 3)),
                             per_scene, _frames(seed=1, n_scenes=2, per_scene=8, n_faces=(1, 3)),
                             detector, eng, detection_interval=1)
        built = rec.pop("_graphs")
        emit({"phase": "retina_frame", "detector": "retinaface-512",
              "run": "detect every frame, box crops", **rec})
        _check_per_frame(rec, "retina_frame", built)
        ctx["k1_launches_retina_frame"] = rec["k1_launches"]
        ctx["k2_launches_retina_frame"] = rec["k2_launches"]
        ctx["k3_launches_retina_frame"] = rec["k3_launches"]
        emit({"phase": "retina_frame", "check": "frame graph vs eager",
              **frame_graph_vs_eager(os.path.join(ctx["tmp"], "retina_frame_vs_eager"),
                                     _frames(seed=0, n_scenes=2, per_scene=12, n_faces=(1, 3)),
                                     detector, eng, detection_interval=1)})
    finally:
        eng.release_graphs()


def _iou_xywh(a, b) -> float:
    iw = min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0])
    ih = min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1])
    if iw <= 0 or ih <= 0:
        return 0.0
    return float(iw * ih / (a[2] * a[3] + b[2] * b[3] - iw * ih))


def phase_image_mode(ctx) -> None:
    """``python -m fire_tpu_torch --mode image`` in process: a rendered
    short-range 1080p scene (faces of 420–700 px, the scale the
    committed BlazeFace weights are trained at) as a BMP; YuNet twice
    (enrol, then recognise), ``--label``, then the default detector."""
    import contextlib
    import io
    import sqlite3

    import numpy as np
    import torch

    from fire_tpu_torch import cli
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition
    from fire_tpu_torch.train.scenes import compose_scene, make_identities
    from fire_tpu_torch.utils import imageio

    work = os.path.join(ctx["tmp"], "image_mode")
    os.makedirs(work)
    scene, gt_boxes = compose_scene(np.random.default_rng(3), make_identities(8, seed=3),
                                    hw=(1080, 1920), n_faces=(1, 2), face_px=(420, 700))[:2]
    src, out = os.path.join(work, "scene.bmp"), os.path.join(work, "out.bmp")
    imageio.imwrite(src, scene)

    seen = []
    real = FaceRecognition.process_image

    def noting(self, **kw):
        seen.append(real(self, **kw))
        return seen[-1]

    def labels(stem):
        db = os.path.join(work, "storage", f"{stem}_512_unencrypted", "db",
                          f"face_embeddings_{stem}_512.db")
        con = sqlite3.connect(db)
        try:
            return [r[0] for r in con.execute("SELECT label FROM faces ORDER BY id")]
        finally:
            con.close()

    def run(*argv):
        """One command; returns (its faces, wall seconds, its stage table)."""
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["--mode", "image", "--input", src, "--encoder", "512", *argv])
        torch.cuda.synchronize()
        stages = {k.strip(): float(v.split()[0]) for k, v in
                  (ln.split(":") for ln in buf.getvalue().splitlines() if ln.endswith("seconds"))}
        return seen[-1], time.perf_counter() - t0, stages

    cwd = os.getcwd()
    FaceRecognition.process_image = noting
    k1.reset_launches()
    try:
        os.chdir(work)  # storage/ is made under the working directory
        with _QuerySizes() as sizes, _frame_graphs() as built:
            first, t_first, st_first = run("--detector", "yunet", "--save", out)
            enrolled = labels("yunet")
            second, t_second, st_second = run("--detector", "yunet", "--save", out)
            after_second = labels("yunet")
            _, t_label, _ = run("--detector", "yunet", "--label", "alice")
            relabelled = labels("yunet")
            default, t_default, st_default = run()  # BlazeFace at 192²
        launches = k1.launches
        # untimed: each engine call of both detectors' commands against its
        # plain version, the eager call on the same engine and inputs
        with _engine_vs_eager() as twice:
            run("--detector", "yunet")
            run()
    finally:
        os.chdir(cwd)
        FaceRecognition.process_image = real
    built.check("image_mode", ("detect", "encode_boxes"))
    check(twice.calls.get("detect_faces", 0) == 2 and twice.calls.get("encode_boxes", 0) == 2,
          f"image_mode: graph vs eager ran {twice.calls}")

    n = len(gt_boxes)
    check(len(first) == n == len(enrolled), f"image_mode: {len(first)} faces, rendered {n}")
    check(all(l.startswith("Unknown_") for l in enrolled), "image_mode: first run enrols")
    check([d["label"] for d in second] == [d["label"] for d in first] and after_second == enrolled,
          "image_mode: the second run recognises the same labels and enrols none")
    check(relabelled == ["alice"] * n, f"image_mode: --label gave {relabelled}")
    saved = imageio.imread(out)
    check(saved is not None and saved.shape == scene.shape, "image_mode: out.bmp")
    for d in second:
        x, y, w, h = d["bbox"]
        box = np.s_[y : y + h + 2, x : x + w + 2]
        check(bool((saved[box] != scene[box]).any()), "image_mode: out.bmp carries no box")
    ious = [max((_iou_xywh(g, d["bbox"]) for d in default), default=0.0) for g in gt_boxes]
    check(len(default) == n and min(ious) >= 0.5,
          f"image_mode: default detector found {len(default)} of {n} faces, IoU {ious}")
    # the second run queries once for all its faces, --label once per face
    _check_queries("image_mode", (launches, sizes.k1), (len(sizes.view), sizes.view), 1 + n,
                   exact=True, max_m=8)
    ctx["k1_launches_image_mode"] = launches
    emit({"phase": "image_mode", "faces": n, "k1_launches": launches,
          "k1_query_sizes": sizes.k1, "view_query_sizes": sizes.view,
          "seconds": {"yunet, first (enrols)": t_first, "yunet, second (recognises)": t_second,
                      "yunet, --label + shrink_db_ids": t_label,
                      "default (blazeface-192)": t_default},
          "stage_seconds": {"yunet, first": st_first, "yunet, second": st_second,
                            "default": st_default},
          "default_detector_iou": ious, "graphs": built.record(),
          "graph_vs_eager_calls": twice.calls, "graph_vs_eager_bitwise_equal": True})


def _one_face_bmp(work: str, seed: int):
    """A rendered short-range 1080p scene with one face, as a BMP."""
    import numpy as np

    from fire_tpu_torch.train.scenes import compose_scene, make_identities
    from fire_tpu_torch.utils import imageio

    os.makedirs(work, exist_ok=True)
    scene = compose_scene(np.random.default_rng(seed), make_identities(8, seed=seed),
                          hw=(1080, 1920), n_faces=(1, 1), face_px=(420, 700))[0]
    src = os.path.join(work, "scene.bmp")
    imageio.imwrite(src, scene)
    return scene, src


IRESNET_K3 = (153, 50)  # IResNet-100's K3 launches an encode, and those on the PReLU route


def phase_iresnet_path(ctx) -> None:
    """ArcFace IResNet-100 in the encoder slot at full size (the random
    init; the 112² crops from the encoder, with no engine configuration) behind the trained YuNet on a rendered 1080p scene:
    an encode makes 153 K3 launches, 50 of them on the PReLU route,
    replayed and eager, and the replay equals the eager call bitwise;
    ``recognize_faces``, ``extract_faces`` (every aligned crop 112²),
    ``add_face``, ``process_frames`` at B = 2 and image mode through the
    command line (``--encoder iresnet100``) serve it."""
    import numpy as np
    import torch

    from fire_tpu_torch import cli
    from fire_tpu_torch.ops import bn_act as k3
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition
    from fire_tpu_torch.train.scenes import compose_scene, make_identities
    from fire_tpu_torch.utils import imageio

    work = os.path.join(ctx["tmp"], "iresnet_path")
    os.makedirs(work)
    scene = compose_scene(np.random.default_rng(11), make_identities(6, seed=11),
                          hw=(1080, 1920), n_faces=(2, 3), face_px=(160, 260),
                          occlusion_prob=0.0)[0]
    t0 = time.perf_counter()
    fr = FaceRecognition(
        detector_type="yunet", encoder_model_type="iresnet100", similarity_threshold=0.7,
        unknown_trigger_count=1, detection_interval=1, weights_dir=None, enable_logging=False,
        storage_root=os.path.join(work, "storage"), device="cuda",
        trained_detector=os.path.join(REPO, "weights_trained", "yunet_synth.msgpack"))
    setup_s = time.perf_counter() - t0
    eng = fr.engine
    check(fr.embedding_dim == 512 and fr.cfg.engine.encode_size == (112, 112),
          f"iresnet_path: width {fr.embedding_dim}, crops {fr.cfg.engine.encode_size}")

    def counted(fn):
        n0, p0 = k3.launches, k3.prelu_launches
        out = fn()
        torch.cuda.synchronize()
        return out, (k3.launches - n0, k3.prelu_launches - p0)

    with recognizer_errors_fail("iresnet_path"):
        for _ in range(6):
            faces = fr.recognize_faces(scene)
        boxes = np.asarray([f["bbox"] for f in eng.detect_faces(scene)], np.float32)
        check(len(boxes) >= 2, f"iresnet_path: {len(boxes)} faces detected")
        eng.encode_boxes(scene, boxes)  # the bucket's capture
        graph, graph_k3 = counted(lambda: eng.encode_boxes(scene, boxes))
        eng._graphed = lambda device: False
        try:
            eager, eager_k3 = counted(lambda: eng.encode_boxes(scene, boxes))
        finally:
            del eng._graphed
        check(graph_k3 == eager_k3 == IRESNET_K3,
              f"iresnet_path: K3 (all, PReLU) a replay {graph_k3}, eager {eager_k3}")
        check(np.array_equal(graph, eager), "iresnet_path: the encode replay != eager")
        crops = fr.extract_faces(scene, align=True)
        check(crops and all(c.shape == (112, 112, 3) for c in crops),
              f"iresnet_path: aligned crops {[c.shape for c in crops]}")
        added = fr.add_face(scene, "iresnet_person")
        batched = []
        fr.process_frames([scene] * 8, annotate=False, batch_size=2,
                          on_frame=lambda _f, fs: batched.append(len(fs)))
        check(len(batched) == 8, f"iresnet_path: {len(batched)} batched frames")
        labels = [f.get("label") for f in faces]
    fr.close()
    del fr, eng
    src, out = os.path.join(work, "scene.bmp"), os.path.join(work, "out.bmp")
    imageio.imwrite(src, scene)
    cwd = os.getcwd()
    try:
        os.chdir(work)  # storage/ is made under the working directory
        with recognizer_errors_fail("iresnet_path image mode"):
            cli.main(["--mode", "image", "--input", src, "--detector", "yunet",
                      "--encoder", "iresnet100", "--save", out])
    finally:
        os.chdir(cwd)
    check(os.path.exists(out), "iresnet_path: image mode wrote no output")
    emit({"phase": "iresnet_path", "setup_s": setup_s, "faces": len(boxes), "labels": labels,
          "k3_per_encode": list(graph_k3), "k3_per_encode_eager": list(eager_k3),
          "replay_equals_eager": True, "crops": [list(c.shape) for c in crops],
          "add_face": bool(added), "batched_faces": batched,
          "embedding_norms": np.linalg.norm(graph, axis=1).round(4).tolist()})
    torch.cuda.empty_cache()


def phase_default_command(ctx) -> None:
    """``python -m fire_tpu_torch --mode image --input scene.bmp
    --detector yunet`` without ``--encoder``: no 128-d weights are
    committed, so the encoder is the random init of seed 0.  Twice in
    one process on fresh storage: the first call writes the params
    cache, the second reads it.  The face's embedding must be bitwise the
    same in both calls and in an engine materialized here, and the face
    must enrol, then be recognised."""
    import contextlib
    import io
    import sqlite3

    import numpy as np
    import torch

    from fire_tpu_torch import cli
    from fire_tpu_torch.config import RecognizerConfig
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.pipeline import engine as E

    work = os.path.join(ctx["tmp"], "default_command")
    scene, src = _one_face_bmp(work, seed=13)
    cache = os.path.join(work, "storage", "yunet_128_unencrypted", "params",
                         "params_yunet_128.msgpack")
    calls = {"materialize": 0}
    embs, boxes_seen = [], []
    real_mat, real_enc = E.materialize, E.DeviceEngine.encode_boxes

    def counting(tree, seed):
        calls["materialize"] += 1
        return real_mat(tree, seed)

    def noting(self, frame, boxes):
        out = real_enc(self, frame, boxes)
        embs.append(out.copy())
        boxes_seen.append(np.array(boxes))
        return out

    def labels():
        con = sqlite3.connect(os.path.join(work, "storage", "yunet_128_unencrypted", "db",
                                           "face_embeddings_yunet_128.db"))
        try:
            return [r[0] for r in con.execute("SELECT label FROM faces ORDER BY id")]
        finally:
            con.close()

    cwd = os.getcwd()
    E.materialize, E.DeviceEngine.encode_boxes = counting, noting
    k1.reset_launches()
    seconds, materialized = [], []
    built = _frame_graphs().__enter__()
    sizes = _QuerySizes().__enter__()
    try:
        os.chdir(work)
        for _ in range(2):
            before = calls["materialize"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["--mode", "image", "--input", src, "--detector", "yunet"])
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            materialized.append(calls["materialize"] - before)
            if len(seconds) == 1:
                check(os.path.exists(cache), "default_command: the first call wrote no params cache")
                cache_mtime = os.path.getmtime(cache)
                enrolled = labels()
    finally:
        sizes.__exit__(None, None, None)
        built.__exit__(None, None, None)
        os.chdir(cwd)
        E.materialize, E.DeviceEngine.encode_boxes = real_mat, real_enc
    launches = k1.launches
    built.check("default_command", ("detect", "encode_boxes"))
    check(materialized == [2, 0], f"default_command: materialize calls per run {materialized}")
    check(os.path.getmtime(cache) == cache_mtime, "default_command: the second call rewrote the cache")
    check(len(embs) == 2 and embs[0].shape == (1, 128), f"default_command: embeddings {len(embs)}")
    check(np.array_equal(embs[0], embs[1]), "default_command: embeddings differ between the calls")
    # the same weights materialized here, with no cache
    cfg = RecognizerConfig(detector_type="yunet", weights_dir=None).with_embedding_dim()
    eng = E.DeviceEngine(cfg, device="cuda")
    here = eng.encode_boxes(scene, boxes_seen[0])
    check(np.array_equal(here, embs[0]),
          f"default_command: materialize(seed 0) embeds differently, max "
          f"{float(np.abs(here - embs[0]).max())}")
    eng._graphed = lambda device: False  # the plain version: the same call run eagerly
    check(np.array_equal(eng.encode_boxes(scene, boxes_seen[0]), here),
          "default_command: the encode graph differs from the eager call")
    check(len(enrolled) == 1 and enrolled[0].startswith("Unknown_"),
          f"default_command: the first call enrolled {enrolled}")
    check(labels() == enrolled, "default_command: the second call did not recognise the face")
    # the second call queries once
    _check_queries("default_command", (launches, sizes.k1), (len(sizes.view), sizes.view), 1,
                   exact=True)
    ctx["k1_launches_default_command"] = launches
    emit({"phase": "default_command", "encoder": "facenet128 random-init (seed 0)",
          "seconds": {"first (writes the cache)": seconds[0], "second (reads it)": seconds[1]},
          "params_cache_bytes": os.path.getsize(cache), "k1_launches": launches,
          "view_queries": len(sizes.view), "embedding_bitwise_equal": True, "graph_vs_eager_bitwise_equal": True,
          "enrolled": enrolled, "graphs": built.record()})


def phase_encrypted(ctx) -> None:
    """``FaceRecognition(encryption_password=...)`` at full width on the
    99,900-row gallery: an image enrols a face (the first encrypted
    snapshot, 204 MB), close, reopen; the reopened gallery must be
    bitwise the same and K1 must return the same (sim, idx) on it; an
    encrypted BMP save decrypts to the plain BMP's bytes; a wrong
    password gives an empty store and gallery.  Also the AES rate and
    the seconds of one encrypt and one decrypt of the snapshot."""
    import io

    import numpy as np
    import torch

    from fire_tpu_torch.gallery import crypto
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition
    from fire_tpu_torch.utils import imageio

    work = os.path.join(ctx["tmp"], "encrypted")
    scene, src = _one_face_bmp(work, seed=17)
    kw = dict(detector_type="yunet", encoder_model_type="512", similarity_threshold=0.7,
              unknown_trigger_count=1, detection_interval=1, enable_logging=False,
              storage_root=os.path.join(work, "storage"), device="cuda",
              trained_detector=_trained("yunet_synth.msgpack"),
              trained_encoder=_trained("facenet512_synth.msgpack"))
    password = "chip-smoke-password"
    k1.reset_launches()
    times = {}
    fr = FaceRecognition(encryption_password=password, **kw)
    fr.gallery.load_rows(_gallery_rows(ctx))
    t0 = time.perf_counter()
    first = fr.process_image(src, annotate=False)  # enrols: the first snapshot
    times["enrol (first encrypted snapshot)"] = time.perf_counter() - t0
    check(len(first) == 1 and first[0]["label"].startswith("Unknown_"),
          f"encrypted: the image gave {first}")
    t0 = time.perf_counter()
    fr.close()
    times["close"] = time.perf_counter() - t0
    count = fr.gallery.count
    check(count == N_GALLERY + 1, f"encrypted: gallery count {count}")
    before = fr.gallery._gal[:count].clone()

    t0 = time.perf_counter()
    fr2 = FaceRecognition(encryption_password=password, **kw)
    times["reopen"] = time.perf_counter() - t0
    check(fr2.gallery.count == count and fr2.gallery.labels == fr.gallery.labels
          and fr2.gallery.db_ids == fr.gallery.db_ids, "encrypted: reopened labels or ids differ")
    check(torch.equal(fr2.gallery._gal[:count], before), "encrypted: reopened rows differ")
    check(fr2.db_manager.count() == 1, f"encrypted: SQLite holds {fr2.db_manager.count()} rows")
    q = torch.from_numpy(unit_rows(np.random.default_rng(5), 8, DIM)).cuda()
    q[0] = before[count - 1]  # the enrolled face itself
    a = k1.cosine_top1(q, fr.gallery.gal_matmul, count)
    b = k1.cosine_top1(q, fr2.gallery.gal_matmul, count)
    torch.cuda.synchronize()
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and int(b[1][0]) == count - 1,
          "encrypted: K1 differs on the reopened gallery")
    out = os.path.join(work, "out.bmp")
    second = fr2.process_image(src, annotate=False, save_path=out)
    check([d["label"] for d in second] == [d["label"] for d in first],
          "encrypted: the reopened store did not recognise the face")
    # JPEG bytes whatever the name, as JAX saves, where OpenCV can encode them
    saved_as = ".jpg" if imageio.has_cv2() else ".bmp"
    check(crypto.Encryptor(password).read_and_decrypt(out) == imageio.imencode(saved_as, scene),
          f"encrypted: the saved image does not decrypt to the plain {saved_as} bytes")
    fr2.close()
    launches = k1.launches - 2  # the two comparison launches above do not count

    # the snapshot's bytes: one encrypt and one decrypt, then AES alone
    buf = io.BytesIO()
    np.save(buf, before.cpu().numpy())
    snap = buf.getvalue()
    enc = crypto.Encryptor(password)
    t0 = time.perf_counter()
    blob = enc.encrypt_data(snap)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(enc.decrypt_data(blob) == snap, "encrypted: snapshot round trip")
    t_dec = time.perf_counter() - t0
    t0 = time.perf_counter()
    crypto.derive_key(password.encode(), b"0" * 16)
    t_kdf = time.perf_counter() - t0
    key, iv = os.urandom(16), os.urandom(16)
    t0 = time.perf_counter()
    ct = crypto.aes128_cbc_encrypt(key, iv, snap)
    t_aes_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    crypto.aes128_cbc_decrypt(key, iv, ct)
    t_aes_dec = time.perf_counter() - t0

    # a wrong password: an empty store and gallery, no exception (last:
    # its start-up writes an empty snapshot over the files)
    wrong = FaceRecognition(encryption_password="not-the-password", **kw)
    check(wrong.gallery.count == 0 and wrong.db_manager.count() == 0,
          "encrypted: a wrong password opened something")
    wrong.close()
    ctx["k1_launches_encrypted"] = launches
    mb = len(snap) / 1e6
    emit({"phase": "encrypted", "aes_backend": crypto.backend(), "snapshot_mb": mb,
          "encrypted_blob_mb": len(blob) / 1e6,
          "seconds": {**times, "encrypt_data(snapshot)": t_enc, "decrypt_data(snapshot)": t_dec,
                      f"pbkdf2 ({crypto.PBKDF2_ITERATIONS:,} iterations)": t_kdf},
          "aes_mb_per_s": {"cbc encrypt": mb / t_aes_enc, "cbc decrypt": mb / t_aes_dec},
          "k1_launches": launches, "gallery_count": count})


def _identity_frames(ident: int, render_seed: int, n_scenes: int, per_scene: int):
    """1080p scenes of one face, all of identity ``ident`` (of 8 made
    from seed 40), each scene held ``per_scene`` frames."""
    import numpy as np

    from fire_tpu_torch.train.scenes import compose_scene, make_identities

    idents = make_identities(8, seed=40)
    rng = np.random.default_rng(render_seed)
    scenes = [compose_scene(rng, [idents[ident]], hw=(1080, 1920), n_faces=(1, 1),
                            face_px=(180, 360))[0] for _ in range(n_scenes)]
    return [s for s in scenes for _ in range(per_scene)]


def _multistream_engine_check(fr) -> dict:
    """Four streams of one 64-frame batch through ``MultiStreamEngine`` on
    a mesh of this card repeated (one step graph for the four), against
    four single-stream engines on the same frames and gallery; then a
    second step with stream 3 ended (its slot holds 255s, which it must
    never read; the graph's input for it is zeroed on the card)."""
    import numpy as np

    from fire_tpu_torch.parallel.mesh import make_mesh
    from fire_tpu_torch.parallel.multistream import MultiStreamEngine
    from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine

    s = 4
    mse = MultiStreamEngine(fr.engine, fr.gallery, fr.cfg, make_mesh(devices=["cuda:0"] * s))
    singles = [BatchStreamEngine(fr.engine, fr.gallery, fr.cfg) for _ in range(s)]
    steps = [np.stack([np.stack(_identity_frames(i, 500 + 10 * step + i, 1, BATCH))
                       for i in range(s)]) for step in range(2)]
    active = [True, True, True, False]
    steps[1][3] = 255
    worst = {"box_err_px": 0, "sim_err": 0.0}
    for step, frames in enumerate(steps):
        got = mse.collect(mse.submit(frames, active=None if step == 0 else active))
        for i in range(s):
            ref = singles[i].process_batch(frames[i] if step == 0 or active[i]
                                           else np.zeros_like(frames[i]))
            for f in ("tid", "gid", "mask", "enroll", "enroll_frame", "enroll_slot"):
                check(np.array_equal(getattr(got[i], f), getattr(ref, f)),
                      f"multistream: stream {i} step {step}: {f} differs from its single stream")
            worst["box_err_px"] = max(worst["box_err_px"],
                                      int(np.abs(got[i].boxes - ref.boxes).max()))
            worst["sim_err"] = max(worst["sim_err"], float(np.abs(got[i].sim - ref.sim).max()))
    check(worst["box_err_px"] == 0 and worst["sim_err"] <= 1e-6,
          f"multistream: boxes / sims differ from the single streams: {worst}")
    # the ended stream's slot of the graph's input is zeroed on the card:
    # no upload, no new capture
    check(len(list(mse.graphs)) == 1, f"multistream: {len(list(mse.graphs))} captures")
    # the ended stream's track coasts max_age frames, then nothing is left
    check(all(got[i].mask.any() for i in range(3)) and not got[3].mask[BATCH // 2:].any(),
          "multistream: live streams tracked their face, the ended one nothing")
    return {"streams": s, "batch": BATCH, **worst, "captures": 1}


def _distinct_multistream_check(fr, ctx, s: int) -> dict:
    """``MultiStreamEngine`` with S = ``s`` streams over the first ``s``
    distinct cards against the same streams on this card repeated, on a
    gallery of its own (the 99,900 rows): two steps of 64 1080p frames.
    In the first, stream i shows identity i, new to this gallery; stream
    0's flagged face is then enrolled, and in the second every stream
    shows that render of it (the others after 8 blank frames, so that
    their tracks end), so the streams on the other cards match the row
    through their gallery replicas, with no new capture on any card.
    Every stream's ids equal, boxes within 1 px, sims within 2e-3 (the
    tolerances of the card-against-CPU check)."""
    import numpy as np

    from fire_tpu_torch.gallery.index import DeviceGallery
    from fire_tpu_torch.parallel.mesh import make_mesh
    from fire_tpu_torch.parallel.multistream import MultiStreamEngine

    gal = DeviceGallery(DIM, device="cuda")
    gal.load_rows(_gallery_rows(ctx))
    meshes = {"repeated": ["cuda:0"] * s, "distinct": [f"cuda:{i}" for i in range(s)]}
    engines = {name: MultiStreamEngine(fr.engine, gal, fr.cfg, make_mesh(devices=devices))
               for name, devices in meshes.items()}
    # renders the loop above enrols from, new to this gallery
    first = np.stack([np.stack(_identity_frames(ident, seed, 1, BATCH))
                      for ident, seed in [(0, 100), (1, 200), (2, 400), (3, 401)][:s]])
    worst = {"box_err_px": 0, "sim_err": 0.0}

    def both(frames, step):
        out = {name: e.process_batches(frames) for name, e in engines.items()}
        for i, (got, want) in enumerate(zip(out["distinct"], out["repeated"])):
            for f in ("tid", "gid", "mask", "enroll"):
                check(np.array_equal(getattr(got, f), getattr(want, f)),
                      f"multistream {s} cards: stream {i} step {step}: {f} differs from "
                      "the card repeated")
            worst["box_err_px"] = max(worst["box_err_px"], int(
                np.abs(got.boxes.astype(np.int64) - want.boxes).max()))
            worst["sim_err"] = max(worst["sim_err"], float(np.abs(got.sim - want.sim).max()))
        check(worst["box_err_px"] <= 1 and worst["sim_err"] <= 2e-3,
              f"multistream {s} cards: step {step}: against the card repeated {worst}")
        return out["distinct"]

    got = both(first, 0)
    flagged = [bool(r.enroll.any()) for r in got]
    check(all(flagged), f"multistream {s} cards: new faces flagged by stream {flagged}, tracked "
                        f"{[bool(r.mask.any()) for r in got]}")
    row = gal.count
    gal.add(got[0].enroll_emb[int(np.nonzero(got[0].enroll_frame >= 0)[0][0])], "stream 0",
            N_GALLERY + 1)
    captures = {name: len(list(e.graphs)) for name, e in engines.items()}
    check(captures["distinct"] == s, f"multistream {s} cards: {captures} step graphs")
    second = np.stack([first[0]] * s)
    second[1:, :8] = 0  # blank frames first: the other streams' tracks die (max_age 4)
    got = both(second, 1)
    # stream 0 keeps its unmatched track; each other stream sees a new face
    matched = [bool((r.gid[r.mask] == row).any()) for r in got[1:]]
    check(all(matched), f"multistream {s} cards: the row enrolled from stream 0 matched in "
                        f"streams 1… {matched}")
    after = {name: len(list(e.graphs)) for name, e in engines.items()}
    check(after == captures, f"multistream {s} cards: new captures {captures} -> {after}")
    return {"streams": s, "devices": meshes["distinct"], "batch": BATCH, **worst,
            "enrolled_row": row, "matched_on": meshes["distinct"][1:],
            "step_graphs": captures["distinct"]}


def phase_multistream(ctx) -> None:
    """``process_videos``'s loop with S = 1, 2, 4 streams of 1080p on this
    one card (a mesh of ``cuda:0`` repeated S times), at full width on the
    99,900-row gallery.  Streams 0 and 1 show one identity (the same
    render: two cameras on one person, flagged in the same step against
    the same gallery snapshot), the others their own; each S uses
    identities not seen before, so the shared one must enrol exactly once,
    through the host's window of recent enrolments.  Each stream holds its
    render for both batches (the synthetic encoder does not promise
    another render of a face above the 0.7 threshold).  With more than
    one card, S = 2 and 4 over distinct cards, one a card (JAX's default
    mesh for ``process_videos``), on a second recognizer with the same
    streams, after :func:`_distinct_multistream_check`."""
    import torch

    from fire_tpu_torch.config import TrackerConfig
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.parallel.mesh import make_mesh
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition
    from fire_tpu_torch.pipeline.stream import FrameSequenceCapture
    from fire_tpu_torch.track import scan as k2

    def recognizer(name):
        fr = FaceRecognition(
            encoder_model_type="512", similarity_threshold=0.7, unknown_trigger_count=1,
            detection_interval=1, enable_logging=False,
            storage_root=os.path.join(ctx["tmp"], name),
            tracker_cfg=TrackerConfig(assignment="hungarian"),
            trained_encoder=_trained("facenet512_synth.msgpack"), device="cuda", **YUNET)
        fr.gallery.load_rows(_gallery_rows(ctx))
        check(fr.gallery.count == N_GALLERY, f"{name}: gallery size")
        return fr

    def run(fr, streams, tag, devices):
        """One call of the loop on ``devices``; returns (wall s, labels
        seen per stream)."""
        fr.mesh = make_mesh(devices=devices)
        caps = [FrameSequenceCapture(f) for f in streams]
        labels = [set() for _ in streams]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr._process_streams_batched(
            caps, [f"{tag} stream {i}" for i in range(len(streams))], annotate=False,
            save_path=None, batch_size=BATCH,
            on_frame=lambda i, f, faces: labels[i].update(d["label"] for d in faces))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, [l - {"Unknown"} for l in labels]

    def warm_up(fr, counts, devices_for):
        """Per S of ``counts``, one run on the mesh ``devices_for(S)``:
        cuDNN plans, the first 204 MB snapshot, the step graph on each
        card (identity 7)."""
        for n_streams in counts:
            run(fr, [_identity_frames(7, 900, 1, BATCH)] * n_streams, f"warm-up S={n_streams}",
                devices_for(n_streams))

    def measure(fr, counts, devices_for):
        """For each S of ``counts``, two batches a stream on the mesh
        ``devices_for(S)``, streams 0 and 1 showing one identity, the
        others their own; the loop's frames/s and K1's and K2's
        launches."""
        shared = {1: 0, 2: 1, 4: 2}  # the identity streams 0 and 1 share, by S
        others = {4: [3, 4]}
        out, launches = {}, {}
        for n_streams in counts:
            idents = [shared[n_streams]] * min(n_streams, 2) + others.get(n_streams, [])
            streams = [_identity_frames(ident, 100 * n_streams + max(i - 1, 0), 1, 2 * BATCH)
                       for i, ident in enumerate(idents)]
            rows_before = fr.db_manager.count()
            k1.reset_launches()
            k2.reset_launches()
            with _batch_steps() as steps, _graph_builds() as builds:
                wall, labels = run(fr, streams, f"S={n_streams}", devices_for(n_streams))
            launches[n_streams] = k1.launches, k2.launches
            added = fr.db_manager.count() - rows_before
            n_frames = sum(len(f) for f in streams)
            what = f"multistream S={n_streams} on {devices_for(n_streams)}"
            check(all(labels), f"{what}: a stream labelled no face {labels}")
            if n_streams > 1:
                check(labels[0] == labels[1] and len(labels[0]) == 1,
                      f"{what}: the shared identity got labels {labels[0] | labels[1]}")
            check(1 <= added <= len(set(idents)),
                  f"{what}: {added} enrolments for {len(set(idents))} identities")
            check(k1.launches >= 2 * n_streams, f"{what}: K1 launched {k1.launches} times")
            check(k2.launches == steps.n == 2 * n_streams,
                  f"{what}: K2 launched {k2.launches} times for {steps.n} stream steps")
            # the warm-up captured each card's step graph: none is new
            check(not builds, f"{what}: {len(builds)} new step graph captures")
            out[n_streams] = {
                "devices": devices_for(n_streams), "frames": n_frames, "wall_s": wall,
                "aggregate_frames_per_s": n_frames / wall,
                "per_stream_frames_per_s": n_frames / n_streams / wall,
                "sqlite_rows_added": added, "k1_launches": k1.launches,
                "k2_launches": k2.launches, "new_captures": len(builds),
                # the loop's "device step (S streams)" stage: the wait in
                # collect, after submit has issued all S steps
                "collect_ms_per_batch":
                    fr.timer.totals.get("device step (S streams)", 0.0) / 2 * 1e3}
        return out, launches

    n_cards = torch.cuda.device_count()
    distinct = [n for n in (2, 4) if n <= n_cards]
    skipped = {n: f"not run: {n_cards} card(s)" for n in (2, 4) if n > n_cards}
    cards = lambda n: [f"cuda:{i}" for i in range(n)]  # noqa: E731
    repeated = lambda n: ["cuda:0"] * n  # noqa: E731
    rec = {"phase": "multistream", "detector": "yunet-640", "batch": BATCH, "card": ctx["smi"],
           "distinct_engine_check": dict(skipped), "by_streams_distinct_cards": dict(skipped)}
    fr = recognizer("multistream")
    try:
        warm_up(fr, (1, 2, 4), repeated)
        rec["engine_check"] = _multistream_engine_check(fr)
        rec["by_streams"], launches = measure(fr, (1, 2, 4), repeated)
        ctx["k1_launches_multistream"] = sum(l[0] for l in launches.values())
        ctx["k2_launches_multistream"] = sum(l[1] for l in launches.values())
        for n in distinct:
            rec["distinct_engine_check"][n] = _distinct_multistream_check(fr, ctx, n)
    finally:
        fr.close()
    if distinct:
        # the same streams on a second recognizer, so that their identities
        # are new to it too
        fr = recognizer("multistream_distinct")
        try:
            warm_up(fr, distinct, cards)
            measured, launches = measure(fr, distinct, cards)
            rec["by_streams_distinct_cards"].update(measured)
        finally:
            fr.close()
        ctx["k1_launches_multistream_distinct"] = sum(l[0] for l in launches.values())
        ctx["k2_launches_multistream_distinct"] = sum(l[1] for l in launches.values())
    else:
        ctx["k1_launches_multistream_distinct"] = None
        ctx["k2_launches_multistream_distinct"] = None
    emit(rec)


def _view_meshes() -> tuple:
    """The sharded view's meshes: this card repeated 1…4 times, and the
    first 2, 3 and 4 distinct cards, each where the machine has them;
    and the distinct meshes it lacks the cards for, each with why."""
    import torch

    n_cards = torch.cuda.device_count()
    meshes = {f"cuda:0 x{n}": ["cuda:0"] * n for n in (1, 2, 3, 4)}
    meshes.update({f"{n} cards": [f"cuda:{i}" for i in range(n)]
                   for n in (2, 3, 4) if n <= n_cards})
    skipped = {f"{n} cards": f"not run: {n_cards} card(s)" for n in (2, 3, 4) if n > n_cards}
    return meshes, skipped


def phase_sharded_gallery(ctx) -> None:
    """``ShardedGalleryView`` over 1, 2, 3 and 4 shards of the gallery on
    this card, and over the first 2, 3 and 4 distinct cards where the
    machine has them, against ``DeviceGallery.query_batch`` (K1 for
    k = 1); the synchronising calls of each mesh's query, held to JAX's
    two readbacks."""
    import numpy as np
    import torch

    from fire_tpu_torch.gallery.index import DeviceGallery, ShardedGalleryView
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.parallel.mesh import make_mesh

    rows = _gallery_rows(ctx)
    gal = DeviceGallery(DIM, device="cuda")
    first = 66_850  # 300 enrolments from here cross the 3-shard boundary at 66,902
    gal.load_rows(rows[:first])
    meshes, skipped = _view_meshes()
    views = {name: ShardedGalleryView(gal, make_mesh(devices=devices))
             for name, devices in meshes.items()}

    def same_as_full_reshard(stage):
        for name, view in views.items():
            view.refresh()
            fresh = ShardedGalleryView(gal, view.mesh)
            check(all(torch.equal(a, b) for a, b in zip(view._gal_sharded, fresh._gal_sharded)),
                  f"sharded_gallery: {name} after {stage}: incremental != full re-shard")

    for db_id, label, blob in rows[first : first + 300]:
        gal.add(np.frombuffer(blob, np.float32), label, db_id)
    same_as_full_reshard("300 enrolments")
    gal.load_rows(rows[first + 300 :])
    check(gal.count == N_GALLERY, "sharded_gallery: gallery size")
    same_as_full_reshard("hydrating the rest")
    for name in ("cuda:0 x3", "3 cards"):
        check(name not in views or views[name]._gal_sharded[0].shape[0] == 33_451,
              f"sharded_gallery: {name}: 3-shard padding")

    rng = np.random.default_rng(8)
    g16 = gal.gal_matmul[:N_GALLERY].float()
    cases, times, syncs = [], {}, {name: {} for name in views}
    for m in (1, 8, 64):
        q = unit_rows(rng, m, DIM)
        for j, i in enumerate(rng.integers(0, N_GALLERY, m // 2)):  # half are gallery rows
            q[j] = np.frombuffer(rows[i][2], np.float32)
        full = torch.from_numpy(q).cuda().to(torch.bfloat16).float() @ g16.T
        top = torch.topk(full, 6, dim=1).values.cpu().numpy()
        for k in (1, 5):
            ids_g, d_g = gal.query_batch(q, k=k)
            # a rank's index is decided where it beats both neighbours by 1e-3
            gaps = top[:, :-1] - top[:, 1:]
            decisive = np.ones((m, k), bool)
            decisive &= gaps[:, :k] > 1e-3
            decisive[:, 1:] &= gaps[:, : k - 1] > 1e-3
            for name, view in views.items():
                k1.reset_launches()
                ids_v, d_v = view.query_batch(q, k=k)
                # JAX's query reads back twice (indices, similarities); the
                # upload and the cross-card copies wait for nothing
                _, at = _count_syncs(lambda: view.query_batch(q, k=k))
                check(k1.launches == 0, f"sharded_gallery: {name}: K1 in the view")
                err = float(np.abs(d_v - d_g).max())
                # rounding only, the same on every run of this seed and gallery
                # (PERF.md §6 says why 1e-6 holds here; other data may reach
                # two float32 orders' bound, 6.1e-5, as the card test allows)
                check(err <= 1e-6, f"sharded_gallery: {name} M={m} k={k}: sims differ {err}")
                check(bool((ids_v[decisive] == ids_g[decisive]).all()),
                      f"sharded_gallery: {name} M={m} k={k}: indices differ")
                check(len(at) == 2, f"sharded_gallery: {name} M={m} k={k}: {len(at)} "
                                    f"synchronising calls, JAX reads back twice: {at}")
                syncs[name][f"M={m}, k={k}"] = len(at)
                cases.append({"mesh": name, "M": m, "k": k, "max_abs_err": err,
                              "decisive": int(decisive.sum())})
        for name, view in views.items():
            times[f"M={m}, {name}"] = median(_host_ms(lambda: view.query_batch(q, k=1)))
        times[f"M={m}, K1 (DeviceGallery)"] = median(_host_ms(lambda: gal.query_batch(q, k=1)))
    emit({"phase": "sharded_gallery", "rows": N_GALLERY, "meshes": {**meshes, **skipped},
          "cases": len(cases), "worst_sim_err": max(c["max_abs_err"] for c in cases),
          "syncs_per_query": syncs, "k1_launches_view": 0, "query_ms_host_clock_k1": times,
          "incremental_refresh_equals_full": True, "card": ctx["smi"]})


def _host_ms(fn, reps: int = 10):
    """Host-clock ms of each of ``reps`` calls of ``fn``, which ends in a
    readback (so the clock covers finished work)."""
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_importers(ctx) -> None:
    """The committed weights through the port's exporter and back in
    through ``weights_dir``; the executor on a FaceNet of other depths;
    ``python -m fire_tpu_torch.verify_onnx`` on each file, run beside."""
    import numpy as np
    import torch

    from fire_tpu_torch.config import EngineConfig, RecognizerConfig
    from fire_tpu_torch.models.facenet import FaceNet, tiny_facenet
    from fire_tpu_torch.models.onnx_export import export_blazeface, export_facenet, export_yunet
    from fire_tpu_torch.models.tflite_import import write_tflite_blazeface
    from fire_tpu_torch.pipeline.engine import DeviceEngine, OnnxEncoder
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition
    from fire_tpu_torch.weights import (flax_shapes, from_flax_facenet, load_into, materialize,
                                        read_msgpack)

    work = os.path.join(ctx["tmp"], "importers")
    wdir, tdir, bdir, xdir = (os.path.join(work, d)
                              for d in ("weights", "blaze_tflite", "blaze_onnx", "executor"))
    t0 = time.perf_counter()
    blaze = read_msgpack(_trained("blazeface192_synth.msgpack"))
    other = FaceNet(embed_dim=512, depths=(2, 2, 2))
    other_tree = materialize(flax_shapes(other, unit_bn_scale=True), seed=3)
    files = {
        os.path.join(wdir, "facenet512.onnx"):
            export_facenet(read_msgpack(_trained("facenet512_synth.msgpack")), embed_dim=512),
        os.path.join(wdir, "face_detection_yunet_2023mar.onnx"):
            export_yunet(read_msgpack(_trained("yunet_synth.msgpack"))),
        os.path.join(bdir, "blazeface.onnx"): export_blazeface(blaze),
        os.path.join(xdir, "facenet512.onnx"):
            export_facenet(other_tree, embed_dim=512, depths=(2, 2, 2)),
    }
    files[os.path.join(tdir, "face_detection_short_range.tflite")] = write_tflite_blazeface(
        blaze["params"])
    for path, blob in files.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(blob)
    out = {"export_s": time.perf_counter() - t0,
           "files_mb": {os.path.relpath(p, work): len(b) / 1e6 for p, b in files.items()}}

    gates = {"facenet512": [os.path.join(wdir, "facenet512.onnx")],
             "yunet": [os.path.join(wdir, "face_detection_yunet_2023mar.onnx"), "--role", "yunet"],
             "blazeface": [os.path.join(bdir, "blazeface.onnx")]}
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "fire_tpu_torch.verify_onnx", *args, "--n", "2"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for name, args in gates.items()}
    try:
        # FaceRecognition imports YuNet and FaceNet-512 from the files;
        # the engine of the committed msgpack files is the reference
        t0 = time.perf_counter()
        imp = FaceRecognition(detector_type="yunet", encoder_model_type="512", weights_dir=wdir,
                              enable_logging=False, device="cuda",
                              storage_root=os.path.join(work, "storage"))
        out["facerecognition_start_s"] = time.perf_counter() - t0
        src = imp.engine.weight_source
        check(src == {"encoder": f"onnx-import:{wdir}/facenet512.onnx",
                      "detector": f"onnx-import:{wdir}/face_detection_yunet_2023mar.onnx"},
              f"importers: weight sources {src}")
        ref = DeviceEngine(RecognizerConfig(detector_type="yunet", encoder_model_type="512",
                                            weights_dir=None).with_embedding_dim(), device="cuda")
        ref.load_trained_detector(_trained("yunet_synth.msgpack"))
        ref.load_trained_encoder(_trained("facenet512_synth.msgpack"))
        emb_err, n_faces = 0.0, 0
        for frame in _frames(seed=21, n_scenes=8, per_scene=1):
            a, b = imp.engine.detect_faces(frame), ref.detect_faces(frame)
            check([d["bbox"] for d in a] == [d["bbox"] for d in b],
                  "importers: the imported YuNet found other boxes")
            if a:
                boxes = np.asarray([d["bbox"] for d in a], np.float32)
                emb_err = max(emb_err, float(np.abs(imp.engine.encode_boxes(frame, boxes)
                                                    - ref.encode_boxes(frame, boxes)).max()))
                n_faces += len(a)
        check(n_faces >= 4 and emb_err <= 1e-3,
              f"importers: {n_faces} faces in 8 frames, embeddings differ by {emb_err}")
        out.update(frames=8, faces=n_faces, max_abs_emb_err=emb_err)
        imp.close()

        # BlazeFace from the .tflite and from the .onnx: pinned to 128²,
        # the same heads and boxes as the msgpack weights at 128²
        x = torch.rand((2, 128, 128, 3), device="cuda", generator=torch.Generator("cuda").manual_seed(0))
        bref = DeviceEngine(RecognizerConfig(
            detector_type="mediapipe", encoder_model_type="512", weights_dir=None,
            engine=EngineConfig(blazeface_size=(128, 128))).with_embedding_dim(),
            device="cuda", encoder=tiny_facenet(512))
        bref.load_trained_detector(_trained("blazeface192_synth.msgpack"))
        scenes = [_one_face_scene(seed) for seed in (31, 32)]
        for kind, d in (("tflite", tdir), ("onnx", bdir)):
            eng = DeviceEngine(RecognizerConfig(detector_type="mediapipe", encoder_model_type="512",
                                                weights_dir=d).with_embedding_dim(),
                               device="cuda", encoder=tiny_facenet(512))
            src = eng.weight_source["detector"]
            check(src.startswith(f"{kind}-import:") and tuple(eng._detect_input) == (128, 128),
                  f"importers: BlazeFace {kind}: {src}, {eng._detect_input}")
            with torch.no_grad():
                heads_equal = all(torch.equal(p, q) for p, q in zip(eng.detector(x),
                                                                    bref.detector(x)))
            check(heads_equal, f"importers: BlazeFace {kind}: heads differ from the msgpack's")
            check(all([f["bbox"] for f in eng.detect_faces(s)]
                      == [f["bbox"] for f in bref.detect_faces(s)] for s in scenes),
                  f"importers: BlazeFace {kind}: boxes differ from the msgpack's")
            out[f"blazeface_{kind}"] = src.split(":")[0]

        # a FaceNet of other depths runs through the executor; TF32 off
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            ex = DeviceEngine(RecognizerConfig(
                detector_type="yunet", encoder_model_type="512", weights_dir=xdir,
                engine=EngineConfig(compute_dtype="float32")).with_embedding_dim(), device="cuda")
            check(ex.weight_source["encoder"] == f"onnx-exec:{xdir}/facenet512.onnx"
                  and isinstance(ex.encoder, OnnxEncoder),
                  f"importers: executor fallback {ex.weight_source}")
            load_into(other, from_flax_facenet(other_tree))
            other = other.cuda().eval()
            crops = np.random.default_rng(4).uniform(0, 1, (4, 160, 160, 3)).astype(np.float32)
            with torch.no_grad():
                want = other(torch.from_numpy(crops).cuda()).cpu().numpy()
                got = ex.encoder(torch.from_numpy(crops).cuda()).cpu().numpy()
            err = float(np.abs(got - want).max())
            check(err <= 1e-3 * max(1.0, float(np.abs(want).max())),
                  f"importers: the executor's FaceNet differs from the module by {err}")
            out["executor_facenet"] = {"depths": [2, 2, 2], "max_abs_err": err,
                                       "max_abs_value": float(np.abs(want).max())}
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    finally:
        verdicts = {name: (proc.communicate(timeout=600), proc.returncode)
                    for name, proc in procs.items()}
    out["verify_onnx"] = {}
    for name, ((stdout, stderr), rc) in verdicts.items():
        lines = stdout.strip().splitlines()
        check(rc == 0 and lines and json.loads(lines[-1])["ok"] is True,
              f"importers: verify_onnx {name}: rc {rc}, {lines[-1:]}, {stderr[-600:]}")
        out["verify_onnx"][name] = json.loads(lines[-1])
    emit({"phase": "importers", **out})


def phase_native(ctx) -> None:
    """The host LAP and NMS of ``csrc/fire_native.cc`` against SciPy and
    NumPy (a tie can have several optimal assignments: there the costs
    must agree)."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment as scipy_lap

    from fire_tpu_torch.runtime import native

    rng = np.random.default_rng(0)
    same_idx = ties = 0
    t_native = t_scipy = 0.0
    for k in range(200):
        n, m = (int(v) for v in rng.integers(1, 65, 2))
        tie = k % 2 == 1
        c = rng.integers(0, 4, (n, m)).astype(np.float64) if tie else rng.random((n, m))
        t0 = time.perf_counter()
        r, col = native.linear_sum_assignment(c)
        t1 = time.perf_counter()
        sr, sc = scipy_lap(c)
        t_native, t_scipy = t_native + t1 - t0, t_scipy + time.perf_counter() - t1
        check(len(r) == min(n, m) and len(set(col.tolist())) == len(col),
              f"native: LAP {n}x{m} is not an assignment")
        check(abs(c[r, col].sum() - c[sr, sc].sum()) <= 1e-9 * max(1.0, c.sum()),
              f"native: LAP {n}x{m} cost {c[r, col].sum()} vs SciPy {c[sr, sc].sum()}")
        same = np.array_equal(r, sr) and np.array_equal(col, sc)
        check(same or tie, f"native: LAP {n}x{m} indices differ from SciPy without ties")
        same_idx += same
        ties += tie
    nms_cases = 0
    for seed in range(20):
        g = np.random.default_rng(100 + seed)
        n = int(g.integers(1, 300))
        xy = g.uniform(0, 1000, (n, 2))
        boxes = np.concatenate([xy, xy + g.uniform(10, 200, (n, 2))], axis=1).astype(np.float32)
        boxes[n // 2 :] = boxes[: n - n // 2]
        scores = g.random(n).astype(np.float32)
        scores[1::4] = scores[0]
        for plus_one in (False, True):
            for suppress_equal in (False, True):
                thr = float(g.choice([0.0, 0.3, 0.5, 1.0]))
                got = native.host_nms(boxes, scores, thr, plus_one, suppress_equal)
                ref = native.host_nms_numpy(boxes, scores, thr, plus_one, suppress_equal)
                check(np.array_equal(got, ref), f"native: host_nms differs (seed {seed}, "
                      f"plus_one={plus_one}, suppress_equal={suppress_equal}, thr={thr})")
                nms_cases += 1
    emit({"phase": "native", "lap_cases": 200, "lap_tie_cases": ties,
          "lap_same_indices_as_scipy": same_idx, "lap_ms_native": t_native / 200 * 1e3,
          "lap_ms_scipy": t_scipy / 200 * 1e3, "nms_cases": nms_cases})


@contextlib.contextmanager
def _without_cv2():
    """``import cv2`` raises inside the block, as where OpenCV is not
    installed."""
    import builtins

    real = builtins.__import__

    def guarded(name, *args, **kw):
        if name.split(".")[0] == "cv2":
            raise ImportError("cv2 is hidden for this check")
        return real(name, *args, **kw)

    builtins.__import__ = guarded
    try:
        yield
    finally:
        builtins.__import__ = real


def phase_label_text(ctx) -> None:
    """``annotate_faces`` and ``visualize_detections`` on a rendered
    1080p frame without OpenCV (hidden where it is installed): text above
    every box, equal to the boxes plus the atlas's text for the same
    strings.  Where OpenCV is installed, also how many pixels its own
    ``putText`` (which the annotators then use) differs from the atlas,
    which replays the OpenCV release the atlas was made with."""
    import numpy as np

    from fire_tpu_torch.pipeline import annotate, text_atlas
    from fire_tpu_torch.train.scenes import compose_scene, make_identities
    from fire_tpu_torch.utils import imageio

    installed = None
    if imageio.has_cv2():
        import cv2

        installed = cv2.__version__

    frame, boxes, lms = compose_scene(np.random.default_rng(8), make_identities(8, seed=8),
                                      hw=(1080, 1920), n_faces=(3, 3), face_px=(120, 300))
    faces = [{"label": f"Unknown_{i:08x}", "confidence": 0.5 + i / 10,
              "bbox": [int(v) for v in b], "landmarks": lm.astype(np.int32)}
             for i, (b, lm) in enumerate(zip(boxes, lms))]
    with _without_cv2():
        t0 = time.perf_counter()
        out = annotate.annotate_faces(frame, faces, with_confidence=True)
        ms = (time.perf_counter() - t0) * 1e3
        vis = annotate.visualize_detections(frame, faces)
    installed_differs = None
    if installed is not None:
        installed_differs = int((annotate.annotate_faces(frame, faces, with_confidence=True)
                                 != out).any(-1).sum())
    boxed, want, want_vis = frame.copy(), frame.copy(), frame.copy()
    for f in faces:
        x, y, w, h = f["bbox"]
        annotate.draw_rectangle(boxed, (x, y), (x + w, y + h), annotate.GREEN)
        annotate.draw_rectangle(want, (x, y), (x + w, y + h), annotate.GREEN)
        text_atlas.put_text(want, f"{f['label']} ({f['confidence']:.2f})", (x, y - 10),
                            annotate.GREEN, 2)
        annotate.draw_rectangle(want_vis, (x, y), (x + w, y + h), annotate.GREEN)
        for p in f["landmarks"]:
            annotate.draw_dot(want_vis, (int(p[0]), int(p[1])), annotate.RED)
        text_atlas.put_text(want_vis, f"{f['confidence']:.4f}", (x, y - 10), annotate.RED, 1)
    text_px = []
    for f in faces:
        x, y, w, h = f["bbox"]
        above = np.s_[max(y - 25, 0) : max(y - 3, 0), x : x + 150]
        text_px.append(int((out[above] != boxed[above]).any(axis=-1).sum()))
    emit({"phase": "label_text", "opencv_installed": installed, "faces": len(faces),
          "text_pixels_above_boxes": text_px, "annotate_ms_1080p": ms,
          "atlas_opencv": str(text_atlas.load_atlas()["opencv"]),
          "installed_opencv_pixels_differing_from_atlas": installed_differs,
          "pixels_differing_from_atlas": {"annotate_faces": int((out != want).any(-1).sum()),
                                          "visualize_detections": int((vis != want_vis).any(-1)
                                                                      .sum())}})
    check(min(text_px) > 100, f"label_text: text pixels above the boxes {text_px}")
    check(np.array_equal(out, want), "label_text: annotate_faces differs from the atlas")
    check(np.array_equal(vis, want_vis), "label_text: visualize_detections differs from the atlas")


def _yunet_facenet_engine():
    from fire_tpu_torch.config import RecognizerConfig
    from fire_tpu_torch.pipeline.engine import DeviceEngine

    eng = DeviceEngine(RecognizerConfig(detector_type="yunet", encoder_model_type="512",
                                        weights_dir=None).with_embedding_dim(), device="cuda")
    eng.load_trained_detector(_trained("yunet_synth.msgpack"))
    eng.load_trained_encoder(_trained("facenet512_synth.msgpack"))
    return eng


def phase_eval_detect(ctx) -> None:
    """``python -m fire_tpu_torch.eval_detect --trained_detector
    weights_trained/yunet_synth.msgpack`` in process (64 scenes of
    480×640, faces of 24–192 px)."""
    import torch

    from fire_tpu_torch import eval_detect

    args = eval_detect.build_parser().parse_args(
        ["--trained_detector", _trained("yunet_synth.msgpack")])
    t0 = time.perf_counter()
    rec = eval_detect.evaluate(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)  # the entry point's own line
    emit({"phase": "eval_detect", **rec, "seconds": secs,
          "jax_v5e_recorded": {"scenes": 48, "precision": 1.0, "recall": 0.882,
                               "mean_iou": 0.864, "source": "README.md:140-145"}})
    check(rec["precision"] >= 0.9, f"eval_detect: precision {rec['precision']:.3f} < 0.9")


def phase_calibrate(ctx) -> None:
    """``fire_tpu_torch.calibrate`` with the committed YuNet and
    FaceNet-512: 24 identities × 10 views of seed 777."""
    import torch

    from fire_tpu_torch import calibrate

    eng = _yunet_facenet_engine()
    t0 = time.perf_counter()
    rec = calibrate.calibrate(eng, n_identities=24, views=10, seed=777)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    gen, imp = rec["genuine"]["p50"], rec["imposter"]["p98"]
    emit({"phase": "calibrate", "genuine_p50": gen, "imposter_p98": imp,
          "youden_threshold": rec["youden_threshold"],
          "suggested_threshold": rec["suggested_threshold"], "n_genuine": rec["n_genuine"],
          "n_imposter": rec["n_imposter"], "sweep": rec["sweep"], "seconds": secs,
          "jax_v5e_recorded": {"genuine_p50": 0.913, "imposter_p98": 0.671,
                               "youden_threshold": 0.674, "source": "README.md:265-268"}})
    check(gen > imp, f"calibrate: genuine p50 {gen} is not above imposter p98 {imp}")


def phase_eval_auc(ctx) -> None:
    """``generate`` (16 identities × 6 held-out PNGs), reread without
    OpenCV and compared with the rendered images, then
    ``encode_directory`` + ``identification_auc`` with the committed
    FaceNet-512."""
    import numpy as np
    import torch

    from fire_tpu_torch.eval import encode_directory, identification_auc
    from fire_tpu_torch.train import synth
    from fire_tpu_torch.utils import imageio

    out = os.path.join(ctx["tmp"], "eval_auc")
    n_ids, n_train, n_test, size, seed = 16, 0, 6, 160, 0
    t0 = time.perf_counter()
    _, test_root = synth.generate(out, n_ids, n_train, n_test, size, seed)
    t_gen = time.perf_counter() - t0
    # the same draws again: every held-out PNG must read back as rendered
    id_rng = np.random.default_rng(seed)
    for i in range(n_ids):
        p = synth._identity_params(id_rng)
        aug = np.random.default_rng(seed * 77_003 + i)
        for _ in range(n_train):
            synth.render_identity(p, aug, size)
        for k in range(n_test):
            img = imageio.imread(os.path.join(test_root, f"id{i:04d}", f"test_{k:03d}.png"))
            check(np.array_equal(img, synth.render_identity(p, aug, size)[..., ::-1]),
                  f"eval_auc: id{i:04d}/test_{k:03d}.png does not read back as rendered")
    eng = _yunet_facenet_engine()
    t0 = time.perf_counter()
    embs, labels = encode_directory(eng, test_root)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    auc = identification_auc(embs, labels)
    emit({"phase": "eval_auc", "identities": n_ids, "images": len(labels), "auc": auc,
          "opencv_installed": imageio.has_cv2(), "seconds": {"generate": t_gen, "encode": t_enc},
          "jax_v5e_recorded": {"identities": 64, "images": 384, "cosine_auc": 0.9986,
                               "source": "README.md:99-104"}})
    check(len(labels) == n_ids * n_test, f"eval_auc: {len(labels)} images encoded")
    check(auc["cosine"] > 0.9, f"eval_auc: cosine AUC {auc['cosine']:.4f} <= 0.9")


JAX_E2E_V5E = {"det_recall": 0.917, "det_precision": 1.0, "id_consistency": 0.884,
               "id_separation": 0.75, "source": "README.md:248-250 (XVID-decoded frames; "
               "per-frame and batched B=24 alike)"}


def phase_eval_e2e(ctx) -> None:
    """The JAX README's end-to-end accuracy run through both paths of the
    port: seed 0, 120 rendered 1080p frames of 4 identities with faces at
    140 px, committed YuNet and FaceNet-512, similarity 0.7, trigger 1.
    Where OpenCV is installed the video goes through an XVID file, as JAX
    scores it; without, the rendered frames are scored."""
    import torch

    from fire_tpu_torch import eval_e2e
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.pipeline.recognizer import FaceRecognition
    from fire_tpu_torch.train.scenes import make_identities

    work = os.path.join(ctx["tmp"], "eval_e2e")
    os.makedirs(work)
    t0 = time.perf_counter()
    video, gt = eval_e2e.render_video(work, "gt.avi", make_identities(4, seed=50), (1080, 1920),
                                      120, 140, 0)
    t_render = time.perf_counter() - t0
    runs, secs = {}, {"render": t_render}
    for name, batch in (("per-frame", 0), ("batched B=64", BATCH)):
        fr = FaceRecognition(
            detector_type="yunet", encoder_model_type="512", similarity_threshold=0.7,
            unknown_trigger_count=1, detection_interval=1, enable_logging=False,
            storage_root=os.path.join(work, f"storage_{batch}"), weights_dir=None,
            trained_detector=_trained("yunet_synth.msgpack"),
            trained_encoder=_trained("facenet512_synth.msgpack"), device="cuda")
        k1.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _QuerySizes() as sizes:
            m = eval_e2e.score_video(fr, video, gt, batch_size=batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m["k1_launches"], m["k1_query_sizes"] = k1.launches, sorted(set(sizes.k1))
        m["view_queries"], m["view_query_sizes"] = len(sizes.view), sorted(set(sizes.view))
        fr.close()
        m["frames_per_s"] = m["frames"] / wall
        secs[name] = wall
        runs[name] = m
        ctx[f"k1_launches_eval_e2e_{'batched' if batch else 'frame'}"] = m["k1_launches"]
    emit({"phase": "eval_e2e", "frames": 120, "hw": [1080, 1920], "identities": 4,
          "face_px": 140, "scored": "video file" if isinstance(video, str) else "rendered frames",
          "runs": runs, "seconds": secs, "jax_v5e_recorded": JAX_E2E_V5E})
    for name, m in runs.items():
        check(m["frames"] == 120, f"eval_e2e {name}: {m['frames']} frames scored")
        if name == "per-frame":
            _check_queries(f"eval_e2e {name}", (m["k1_launches"], m["k1_query_sizes"]),
                           (m["view_queries"], m["view_query_sizes"]), 1)
        else:  # the batched step launches K1 in its graph on every card count
            check(m["k1_launches"] >= 1, f"eval_e2e {name}: K1 was never launched")
        for key, floor in (("det_recall", 0.85), ("det_precision", 0.95),
                           ("id_consistency", 0.80)):
            check(m[key] >= floor, f"eval_e2e {name}: {key} {m[key]:.3f} < {floor}")
    if isinstance(video, str):  # scored as JAX scores it: its recorded row, exactly
        got = {k: round(runs["per-frame"][k], 3) for k in ("det_recall", "det_precision",
                                                           "id_consistency", "id_separation")}
        check(got == {k: JAX_E2E_V5E[k] for k in got},
              f"eval_e2e per-frame: {got}, JAX's recorded row {JAX_E2E_V5E}")


# ---------------------------------------------------------------- training --

MEMO_STEPS = 30  # steps of each fixed-batch memorisation
MEMO_WARMUP = 5  # of them, untimed (first-use allocations, cuDNN's choices, the capture)


def step_graphs(step) -> dict:
    """A training step's CUDA graphs (``GraphedStep.graphs``): keys,
    capture seconds and what the captures added to the pools, in all
    and by device."""
    calls = [g for _, g in step.graphs]
    by_device = {}
    for g in calls:
        for d, b in g.pool_bytes_by_device.items():
            by_device[d] = by_device.get(d, 0) + b / 1e9
    return {"keys": len(calls), "capture_s": [g.capture_s for g in calls],
            "cards": [[str(d) for d in g.devices] for g in calls],
            "pool_gb": sum(g.pool_bytes for g in calls) / 1e9, "pool_gb_by_device": by_device}


def _sync_all() -> None:
    """Wait for every card of the machine: a sharded step's blocks and
    updates live on each card of its mesh."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def memorise(step, state, args, batch: int, macs: int, base_bytes: int) -> tuple:
    """``MEMO_STEPS`` steps of ``step(state, *args)`` on one fixed batch:
    the losses, ms per step and images/s over the steps after
    ``MEMO_WARMUP`` (host clock around synchronised work), the peak device
    memory above ``base_bytes`` (what was allocated before the model was
    built: earlier phases' tensors), and the bf16 share: forward MACs × 2
    × 3 (forward and backward) FLOP a step over the dense bf16 peak."""
    import torch

    from fire_tpu_torch.bench.common import BF16_FLOP_PER_S

    _sync_all()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(MEMO_STEPS):
        if i == MEMO_WARMUP:
            _sync_all()
            t0 = time.perf_counter()
        state, loss, *_ = step(state, *args)
        losses.append(loss)
    _sync_all()
    ms = (time.perf_counter() - t0) * 1e3 / (MEMO_STEPS - MEMO_WARMUP)
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f"memorise: non-finite losses {losses}")
    return state, {
        "steps": MEMO_STEPS, "batch": batch, "loss_first": losses[0], "loss_last": losses[-1],
        "ms_per_step": ms, "images_per_s": batch / (ms / 1e3),
        "peak_mem_gb": (torch.cuda.max_memory_allocated() - base_bytes) / 1e9,
        "forward_gmac": macs / 1e9,
        "bf16_peak_share": macs * 2 * 3 / (ms / 1e3) / BF16_FLOP_PER_S}


def phase_train_encoder(ctx) -> None:
    """``python -m fire_tpu_torch.train``'s ``main`` for two epochs of a
    ``train.synth`` dataset (32 identities × 8 PNGs) at full width:
    FaceNet-512, B = 64, 160², bf16; its file loads into a
    ``DeviceEngine`` that embeds.  Then the step alone memorises one
    fixed batch: the loss falls below half in ``MEMO_STEPS`` steps; ms
    a step, images/s, peak memory, share of the bf16 peak.  Both run
    through the step's CUDA graph (one key), released at the end."""
    import numpy as np
    import torch

    from fire_tpu_torch.bench.common import forward_macs
    from fire_tpu_torch.config import RecognizerConfig
    from fire_tpu_torch.models.facenet import facenet_512
    from fire_tpu_torch.pipeline.engine import DeviceEngine
    from fire_tpu_torch.train import __main__ as arcface_cli
    from fire_tpu_torch.train import optim, synth
    from fire_tpu_torch.train.data import IdentityFolderDataset, batches
    from fire_tpu_torch.train.trainer import JAX_INIT_SEED, init_state, make_train_step

    work = os.path.join(ctx["tmp"], "train_encoder")
    t0 = time.perf_counter()
    train_root, _ = synth.generate(work, 32, 8, 0, 160, seed=1)
    t_render = time.perf_counter() - t0
    out = os.path.join(work, "facenet512.msgpack")
    t0 = time.perf_counter()
    arcface_cli.main(["--data", train_root, "--encoder", "512", "--epochs", "2", "--batch",
                      str(BATCH), "--out", out, "--log_every", "4", "--device", "cuda"])
    t_cli = time.perf_counter() - t0

    ds = IdentityFolderDataset(train_root)
    images_u8, labels = next(batches(ds, BATCH, (160, 160), seed=0))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = facenet_512().cuda()
    opt = optim.adamw(1e-3)
    state = init_state(model, JAX_INIT_SEED, ds.num_classes, opt)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
    images = torch.from_numpy(images_u8).cuda().float() / 255.0
    labels_t = torch.from_numpy(labels).cuda()
    macs = forward_macs(model, images)
    state, memo = memorise(step, state, (images, labels_t), BATCH, macs, base)
    memo["graphs"] = step_graphs(step)
    check(memo["graphs"]["keys"] == 1, f"train_encoder: the step's graphs {memo['graphs']}")
    step.release_graphs()  # the trace phase captures again
    ctx["arcface"] = (step, state, images, labels_t)  # traced by the trace phase
    ctx["arcface_memo"] = memo  # beside the sharded step's (train_sharded)

    eng = DeviceEngine(RecognizerConfig(detector_type="yunet", encoder_model_type="512",
                                        weights_dir=None).with_embedding_dim(), device="cuda")
    eng.load_trained_encoder(out)
    emb = eng.encode_faces(images_u8[:8].astype(np.float32) / 255.0)
    emit({"phase": "train_encoder", "model": "facenet-512 (5/10/5, stem 32)", "hw": [160, 160],
          "compute": "bf16, float32 masters", "classes": ds.num_classes,
          "cli": {"epochs": 2, "images": len(ds), "steps": 2 * (len(ds) // BATCH),
                  "seconds": t_cli, "out_mb": os.path.getsize(out) / 1e6},
          "memorise": memo, "render_seconds": t_render, "embed_shape": list(emb.shape)})
    check(emb.shape == (8, 512) and bool(np.isfinite(emb).all()),
          f"train_encoder: the trained encoder embeds {emb.shape}")
    check(eng.weight_source["encoder"] == f"trained:{out}", "train_encoder: the file did not load")
    check(memo["loss_last"] < 0.5 * memo["loss_first"],
          f"train_encoder: the loss went {memo['loss_first']:.3f} → {memo['loss_last']:.3f}")


SHARDED_MESH = (2, 2)  # the JAX CLI's mesh for four devices
BIG_CLASSES = 100_000  # identities the classifier's mp split exists for
BIG_TIMED = 7  # timed steps at BIG_CLASSES, after 2 untimed


def _sharded_mesh():
    """A (2, 2) mesh over four distinct cards where there are four, else
    over this card repeated."""
    import torch

    from fire_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(4)] if n >= 4 else ["cuda:0"] * 4
    return make_mesh(SHARDED_MESH, devices=devices)


def _reset_peaks(devices) -> dict:
    """Synchronise ``devices``, reset their peak statistics and return
    what each holds now."""
    import torch

    base = {}
    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
        base[str(d)] = torch.cuda.memory_allocated(d)
    return base


def _peaks_gb(base: dict) -> dict:
    """Each device's peak allocation since :func:`_reset_peaks`, above
    what it held then, in GB."""
    import torch

    return {d: (torch.cuda.max_memory_allocated(d) - b) / 1e9 for d, b in base.items()}


def _sharded_parity(mesh) -> dict:
    """(a): one step's loss, gradients and BatchNorm statistics of the
    sharded step against the one-device step, FaceNet-512 at B = 64,
    160², C = 32, from one state (a seeded numpy init) on one batch,
    float32 with TF32 off.  The loss is gated at rtol 1e-4 and each
    gradient tensor at 5e-2 relative L2, with ``_cross_device_training``'s
    rule for tensors whose gradient is zero but for rounding."""
    import numpy as np
    import torch

    from fire_tpu_torch.models.facenet import facenet_512
    from fire_tpu_torch.parallel.mesh import column_devices, split_columns
    from fire_tpu_torch.train.trainer import (arcface_loss, model_batch_stats,
                                              sharded_arcface_loss)
    from fire_tpu_torch.weights import flax_shapes, load_flax, materialize

    rng = np.random.default_rng(31)
    home = mesh.devices[0, 0]
    images = torch.tensor(rng.random((BATCH, 160, 160, 3)).astype(np.float32), device=home)
    labels = torch.tensor(np.arange(BATCH) % 32, device=home)
    classifier = (rng.standard_normal((DIM, 32)) * 0.01).astype(np.float32)
    variables = materialize(flax_shapes(facenet_512()), seed=32)

    def one_step(sharded: bool):
        model = facenet_512()
        load_flax(model, variables)
        model.to(home)
        cls = torch.tensor(classifier, device=home, requires_grad=True)
        if sharded:
            blocks = split_columns(cls, column_devices(mesh))
            loss = sharded_arcface_loss(model, blocks, images, labels, mesh)
        else:
            blocks = [cls]
            loss = arcface_loss(model, cls, images, labels)
        n = len(list(model.parameters()))
        g = torch.autograd.grad(loss, list(model.parameters()) + blocks)
        grads = [t.double().cpu().numpy() for t in g[:n]] + [
            torch.cat([t.to(home) for t in g[n:]], dim=1).double().cpu().numpy()]
        stats = [t.double().cpu().numpy() for t in model_batch_stats(model)]
        return loss.item(), grads, stats

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (l1, g1, s1), (l2, g2, s2) = one_step(False), one_step(True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    scale = max(float(np.abs(b).max()) for b in g1)
    live = [(a, b) for a, b in zip(g2, g1) if np.abs(b).max() > 1e-4 * scale]
    rel_l2 = max(float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in live)
    worst = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in live)
    rec = {"loss_one_device": l1, "loss_sharded": l2, "tensors": len(live),
           "worst_rel_l2": rel_l2, "worst_element_of_max": worst,
           "batch_stats_max_abs_diff": max(float(np.abs(a - b).max()) for a, b in zip(s2, s1))}
    check(abs(l2 - l1) <= 1e-4 * abs(l1), f"train_sharded: loss {l2} vs one device {l1}")
    check(rel_l2 <= 5e-2, f"train_sharded: gradients differ by {rel_l2} (relative L2)")
    return rec


def _eager_twice(build) -> dict:
    """Two eager runs of ``TRAIN_GRAPH_STEPS`` float32 steps from one
    state: the loss and every state tensor bitwise equal after each step
    (gated), and the count that differ by step.  Over distinct cards the
    backward's gradient terms from several cards must add in one order
    (the step runs its backward on the calling thread)."""
    import torch

    runs = []
    for _ in range(2):
        step, state, args = build(None)
        step._graphed = lambda device: False
        after = []
        for i in range(TRAIN_GRAPH_STEPS):
            state, loss = step(state, *args(i))
            _sync_all()
            after.append([loss.clone()] + [t.detach().clone() for t in _state_tensors(state)])
        runs.append(after)
        del step, state
        gc.collect()
    differ = [sum(not torch.equal(a, b) for a, b in zip(x, y)) for x, y in zip(*runs)]
    check(not any(differ), f"train_sharded: two eager runs from one state differ in "
                           f"{differ} of {len(runs[0][0])} tensors after each step")
    return {"steps": TRAIN_GRAPH_STEPS, "tensors": len(runs[0][0]),
            "tensors_differing_by_step": differ, "bitwise_equal": not any(differ)}


def _eager_ms(step, state, args, timed: int) -> tuple:
    """ms a step of a graphed training step run eagerly on ``state``
    (``_graphed`` off on the instance): one untimed step, then ``timed``
    by the host clock around steps synchronised on every card.  Returns
    the state and the record."""
    import torch

    step._graphed = lambda device: False
    try:
        times = []
        for i in range(1 + timed):
            _sync_all()
            t0 = time.perf_counter()
            state, loss = step(state, *args)
            _sync_all()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
    finally:
        del step._graphed
    check(bool(torch.isfinite(loss)), f"train_sharded: eager loss {float(loss)}")
    return state, {"ms_per_step": median(times), "ms_steps": times}


def _big_classifier_steps(mesh, images, labels) -> dict:
    """(d): the one-device and the sharded step at ``BIG_CLASSES``
    identities, bf16 with AdamW, each replaying its graph (the sharded
    one over every card of the mesh): ms a step (median of ``BIG_TIMED``
    after two untimed, the capture among them), the graphs' capture
    seconds and pool by device, each device's peak memory above what it
    held before, and each ``mp`` block of the sharded state: its
    columns, its bytes and its moments' bytes, on its own device; then
    the sharded step run eagerly on the same state."""
    import torch

    from fire_tpu_torch.models.facenet import facenet_512
    from fire_tpu_torch.parallel.mesh import column_devices
    from fire_tpu_torch.train import optim
    from fire_tpu_torch.train.trainer import JAX_INIT_SEED, init_state, make_train_step

    out = {}
    devices = mesh.distinct_devices()
    for name, m in (("one_device", None), ("sharded", mesh)):
        base = _reset_peaks(devices)
        model = facenet_512().to(mesh.devices[0, 0])
        opt = optim.adamw(1e-3)
        state = init_state(model, JAX_INIT_SEED, BIG_CLASSES, opt, mesh=m)
        step = make_train_step(model, opt, mesh=m, compute_dtype=torch.bfloat16)
        times, losses = [], []
        for i in range(2 + BIG_TIMED):
            _sync_all()
            t0 = time.perf_counter()
            state, loss = step(state, images, labels)
            _sync_all()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        check(all(math.isfinite(v) for v in losses), f"train_sharded: {name} losses {losses}")
        rec = {"ms_per_step": median(times), "ms_steps": times, "loss_first": losses[0],
               "loss_last": losses[-1], "peak_mem_gb": _peaks_gb(base),
               "graphs": step_graphs(step)}
        check(rec["graphs"]["keys"] == 1, f"train_sharded: {name} graphs {rec['graphs']}")
        if m is not None:
            n = len(state.params)
            adam = state.opt_state[0]
            blocks = []
            for j, dev in enumerate(column_devices(m)):
                b, mu, nu = state.classifier[j], adam.mu[n + j], adam.nu[n + j]
                check(b.device == mu.device == nu.device == dev,
                      f"train_sharded: block {j} on {b.device}, moments on {mu.device} / "
                      f"{nu.device}, mesh column on {dev}")
                blocks.append({"device": str(dev), "columns": b.shape[1],
                               "bytes": b.numel() * b.element_size(),
                               "moment_bytes": mu.numel() * 4 + nu.numel() * 4})
            check(sum(r["columns"] for r in blocks) == BIG_CLASSES,
                  f"train_sharded: the blocks hold {[r['columns'] for r in blocks]} columns")
            rec["blocks"] = blocks
            state, rec["eager"] = _eager_ms(step, state, (images, labels), BIG_TIMED)
            rec["graph_over_eager"] = rec["ms_per_step"] / rec["eager"]["ms_per_step"]
        step.release_graphs()
        out[name] = rec
        del model, state, step
        torch.cuda.empty_cache()
    return out


def phase_train_sharded(ctx) -> None:
    """The dp×mp-sharded ArcFace step at full width (FaceNet-512, B = 64,
    160²) on a (2, 2) mesh, four distinct cards where there are four,
    else this card repeated: (a) parity with the one-device step, (b)
    two eager runs from one state against each other, and its graph
    against its eager step, each bitwise over 5 float32 steps with TF32
    off and cuDNN deterministic, (c) a bf16 AdamW memorisation through
    the graph beside ``train_encoder``'s, then the eager step's ms on the
    same state, (d) C = 100,000 identities, graphed and eager.  Over
    distinct cards each graph spans the four.  K1's launches over the
    phase (training has no gallery)."""
    import numpy as np
    import torch

    from fire_tpu_torch.bench.common import forward_macs
    from fire_tpu_torch.models.facenet import facenet_512
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.train import optim
    from fire_tpu_torch.train.trainer import JAX_INIT_SEED, init_state, make_train_step

    k1.reset_launches()
    mesh = _sharded_mesh()
    devices = mesh.distinct_devices()
    t0 = time.perf_counter()
    parity = _sharded_parity(mesh)
    t_parity = time.perf_counter() - t0

    distinct = len(devices) > 1
    t0 = time.perf_counter()
    with _exact_float32():
        build = _arcface_build(mesh)
        twice = _eager_twice(build)
        gc.collect()
        exact = _graph_vs_eager_bitwise(build)
    gc.collect()
    torch.cuda.empty_cache()
    t_exact = time.perf_counter() - t0

    _, _, images, labels = ctx["arcface"]
    classes = int(labels.max().item()) + 1
    base = _reset_peaks(devices)
    model = facenet_512().to(mesh.devices[0, 0])
    opt = optim.adamw(1e-3)
    state = init_state(model, JAX_INIT_SEED, classes, opt, mesh=mesh)
    step = make_train_step(model, opt, mesh=mesh, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    state, memo = memorise(step, state, (images, labels), BATCH, forward_macs(model, images),
                           base[str(mesh.devices[0, 0])])
    memo["peak_mem_gb_by_device"] = _peaks_gb(base)
    memo["graphs"] = step_graphs(step)
    check(memo["graphs"]["keys"] == 1, f"train_sharded: the step's graphs {memo['graphs']}")
    state, memo["eager"] = _eager_ms(step, state, (images, labels), 5)
    memo["graph_over_eager"] = memo["ms_per_step"] / memo["eager"]["ms_per_step"]
    t_memo = time.perf_counter() - t0
    ctx["arcface_sharded"] = (step, state, images, labels)  # traced by the trace phase
    del model, state, step

    big_labels = torch.tensor(np.random.default_rng(33).integers(0, BIG_CLASSES, BATCH),
                              device=images.device)
    t0 = time.perf_counter()
    big = _big_classifier_steps(mesh, images, big_labels)
    t_big = time.perf_counter() - t0
    ctx["k1_launches_train_sharded"] = k1.launches
    one = ctx["arcface_memo"]
    emit({"phase": "train_sharded", "card": ctx["smi"], "mesh": mesh.shape,
          "cards": "distinct" if distinct else "one card repeated",
          "step": "one CUDA graph over the four cards" if distinct else "CUDA graph",
          "devices": [str(d) for d in mesh.devices.reshape(-1)],
          "model": "facenet-512 (5/10/5, stem 32)", "hw": [160, 160], "batch": BATCH,
          "parity": parity,
          "graph_vs_eager_float32": exact, "eager_twice_float32": twice,
          "memorise": {"sharded": memo, "one_device": one, "classes": classes,
                       "compute": "bf16, float32 masters, adamw(1e-3)",
                       "ms_ratio": memo["ms_per_step"] / one["ms_per_step"]},
          "classes_100k": big, "k1_launches": k1.launches,
          "seconds": {"parity": t_parity, "graph_vs_eager": t_exact, "memorise": t_memo,
                      "classes_100k": t_big}})
    check(memo["loss_last"] < 0.5 * memo["loss_first"],
          f"train_sharded: the loss went {memo['loss_first']:.3f} → {memo['loss_last']:.3f}")


def _entry_check() -> dict:
    """``dryrun.entry()`` on the card: (8, 512), finite; ms a call (CUDA
    events, median of 5 after a warm call); on seeded random images unit
    rows at cosine ≥ 0.999 to the same forward on the CPU."""
    import numpy as np
    import torch

    from fire_tpu_torch import dryrun

    fn, args = dryrun.entry()
    out = fn(*args)
    check(tuple(out.shape) == (8, 512) and bool(torch.isfinite(out).all()),
          f"dryrun: entry() gave {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    ms = median([event_ms(lambda: fn(*args), 1) for _ in range(5)])
    x = np.random.default_rng(21).random((8, 160, 160, 3)).astype(np.float32)
    card = fn(args[0], torch.tensor(x, device="cuda")).cpu().numpy()
    cpu_fn, (cpu_model, _) = dryrun.entry("cpu")
    ref = cpu_fn(cpu_model, torch.tensor(x)).numpy()
    norm_err = float(np.abs(np.linalg.norm(card, axis=1) - 1.0).max())
    min_cos = float(((card * ref).sum(1) / np.linalg.norm(ref, axis=1)).min())
    check(norm_err <= 1e-3 and min_cos >= 0.999,
          f"dryrun: entry() rows off unit norm by {norm_err}, cosine to the CPU {min_cos}")
    return {"model": "facenet-512 bf16", "shape": list(out.shape), "ms_per_call": ms,
            "max_norm_err": norm_err, "min_cos_vs_cpu": min_cos}


@contextlib.contextmanager
def _plain_kernels():
    """K1 and K2 swapped for their plain versions where the batched step
    calls them, on whatever device the step runs, and the step run
    eagerly there: the graph's plain version (the plain tracker reads the
    card for its assignment, which no graph can hold).  The per-frame
    engine and tracker run eagerly too."""
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.pipeline import batch_engine as be
    from fire_tpu_torch.pipeline.engine import DeviceEngine
    from fire_tpu_torch.track import scan as k2
    from fire_tpu_torch.track.sort import Sort

    def track_scan(table, ident, *args):  # in place, as the wrapper updates them
        new_table, new_ident, out, iout = k2.track_scan_plain(table, ident, *args)
        for dst, src in zip((*table, *ident), (*new_table, *new_ident)):
            dst.copy_(src)
        return table, ident, out, iout

    owners = (be.BatchStreamEngine, DeviceEngine, Sort)
    real = be.cosine_top1, be.track_scan, [o._graphed for o in owners]
    be.cosine_top1, be.track_scan = k1.plain_cosine_top1, track_scan
    for owner in owners:
        owner._graphed = lambda self, device: False
    try:
        yield
    finally:
        be.cosine_top1, be.track_scan = real[:2]
        for owner, graphed in zip(owners, real[2]):
            owner._graphed = graphed


def _compare_streams(plane: str, card, other, what: str, box_tol: float) -> dict:
    """Masks, track ids and gallery ids equal; boxes within ``box_tol``,
    similarities within 1e-3.  Returns the errors and where boxes differ."""
    import numpy as np

    check(len(card) == len(other), f"dryrun {plane}: {len(card)} streams vs {len(other)} ({what})")
    box_err, sim_err, differ = 0.0, 0.0, []
    for s, (a, b) in enumerate(zip(card, other)):
        for f in ("mask", "tid", "gid"):
            check(np.array_equal(getattr(a, f), getattr(b, f)),
                  f"dryrun {plane}: stream {s} {f} differs ({what})")
        d = np.abs(a.boxes.astype(np.float64) - b.boxes)
        box_err = max(box_err, float(d.max()))
        sim_err = max(sim_err, float(np.abs(a.sim - b.sim).max()))
        differ += [{"stream": s, "frame": int(f), "track": int(t), "card": a.boxes[f, t].tolist(),
                    "other": b.boxes[f, t].tolist()}
                   for f, t in zip(*np.nonzero(d.max(-1)))]
    check(box_err <= box_tol and sim_err <= 1e-3,
          f"dryrun {plane}: boxes {box_err}, sims {sim_err} ({what}): {differ[:4]}")
    return {"box_err": box_err, "sim_err": sim_err, "boxes_differ": len(differ),
            "first_differ": differ[:2]}


def _dryrun_vs_plain(summary) -> dict:
    """The card's stand-in and real-model planes (i) against the same
    planes on the card with K1 and K2 swapped for their plain versions:
    boxes within 1e-3; (ii) against the CPU's run (``["cpu"] * 8``),
    where the wrappers run the plain versions: boxes within 1 px, as
    ``cross_device`` holds them.  The box is ``trunc`` of a sum with
    ``exp`` of the KF's log area, and the CPU's ``exp`` may round an ulp
    away from the card's (the phase records both at log 100): a box edge
    at a whole pixel can land a pixel apart.  Masks, track and gallery
    ids equal in both."""
    from fire_tpu_torch import dryrun

    card_mesh = dryrun.dryrun_mesh(8, ["cuda:0"] * 8)
    cpu_mesh = dryrun.dryrun_mesh(8, ["cpu"] * 8)
    out = {}
    for plane in ("standin", "real"):
        run = getattr(dryrun, f"{plane}_plane")
        with _plain_kernels():
            plain = run(card_mesh)
        cpu = run(cpu_mesh)
        card = summary[plane]
        out[plane] = {"streams": len(card),
                      "confirmed": int(sum(r.mask.sum() for r in card)),
                      "vs_plain_on_card": _compare_streams(plane, card, plain, "plain on the card",
                                                           1e-3),
                      "vs_cpu": _compare_streams(plane, card, cpu, "the CPU", 1.0)}
    return out


def phase_dryrun(ctx) -> None:
    """``fire_tpu_torch.dryrun`` (``__graft_entry__.py``'s counterpart):
    ``entry()`` at full width in bf16, then ``dryrun_multichip(8)`` on
    this card repeated eight times, K1's and K2's launches counted, its
    stand-in and real-model planes held against their plain versions on
    the card and against the CPU (:func:`_dryrun_vs_plain`); with four
    cards, ``dryrun_multichip(4)`` on four distinct ones.  TF32 is off
    for the dry run so that its float32 convolutions compare with the
    CPU's."""
    import io

    import torch

    from fire_tpu_torch import dryrun
    from fire_tpu_torch.ops import cosine_top1 as k1
    from fire_tpu_torch.track import scan as k2

    rec = {"phase": "dryrun", "entry": _entry_check()}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        closing = io.StringIO()  # the closing line: into this phase's record, not stdout
        with _batch_steps() as steps, contextlib.redirect_stdout(closing):
            k1.reset_launches()
            k2.reset_launches()
            t0 = time.perf_counter()
            summary = dryrun.dryrun_multichip(8, devices=["cuda:0"] * 8)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, k2_launches = k1.launches, k2.launches
        check(launches > 0, "dryrun: K1 was not launched")
        check(k2_launches == steps.n > 0,
              f"dryrun: K2 launched {k2_launches} times for {steps.n} stream steps")
        t0 = time.perf_counter()
        rec["vs_plain"] = _dryrun_vs_plain(summary)
        rec["vs_plain"]["seconds"] = time.perf_counter() - t0
        # why a CPU box may sit a pixel apart: exp of the stand-in track's
        # log area, log(10 · 10) in float32, on each device
        log_area = torch.tensor(4.6051702)
        rec["vs_plain"]["exp_log_area"] = {"card": torch.exp(log_area.cuda()).item(),
                                           "cpu": torch.exp(log_area).item()}
        if torch.cuda.device_count() >= 4:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), _train_builds() as builds:
                four = dryrun.dryrun_multichip(4)
            builds = [b for b in builds if b["training"]]
            check(len(builds) == 1 and len(builds[0]["cards"]) == 4,
                  f"dryrun: the four-card train plane's graphs {builds}")
            rec["four_cards"] = {"devices": [f"cuda:{i}" for i in range(4)],
                                 "mesh": four["mesh"], "loss": four["loss"],
                                 "train_plane_graphs": builds,
                                 "seconds_by_plane": four["seconds"],
                                 "wall_s": time.perf_counter() - t0}
        else:
            rec["four_cards"] = f"not run: {torch.cuda.device_count()} card(s)"
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    ctx["k1_launches_dryrun"], ctx["k2_launches_dryrun"] = launches, k2_launches
    rec.update({"devices": ["cuda:0"] * 8, "mesh": summary["mesh"], "loss": summary["loss"],
                "self_matches": summary["self_matches"], "streams": summary["streams"],
                "cli_outputs": summary["cli_outputs"], "seconds_by_plane": summary["seconds"],
                "wall_s": wall, "k1_launches": launches, "k2_launches": k2_launches,
                "batch_steps": steps.n, "closing_line": closing.getvalue().strip(),
                "card": ctx["smi"]})
    emit(rec)


def _scene_pool(hw, n: int, max_faces: int, face_px, seed: int):
    """``n`` rendered scenes as the trainers' device pool (uint8 frames,
    padded GT) on the card."""
    import numpy as np
    import torch

    from fire_tpu_torch.train.detect import pad_gt
    from fire_tpu_torch.train.scenes import compose_scene, make_identities

    idents = make_identities(16, seed=seed)
    rng = np.random.default_rng(seed)
    scenes = [compose_scene(rng, idents, hw=hw, n_faces=(1, max_faces), face_px=face_px)
              for _ in range(n)]
    padded = [pad_gt(b, l, max_faces) for _, b, l in scenes]
    return [torch.from_numpy(np.stack([s[0].astype(np.uint8) for s in scenes])).cuda()] + [
        torch.from_numpy(np.stack([p[i] for p in padded])).cuda() for i in range(3)]


def _detector_run(name: str, model, make_step, hw, scene_hw, batch: int, max_faces: int,
                  face_px, lr: float, default_steps: int, with_stats: bool) -> dict:
    """Fixed-batch memorisation of one detector trainer's pool step at its
    default batch and size, with the trainer's own optimiser, through the
    step's CUDA graph (the pool bound), released at the end."""
    import torch

    from fire_tpu_torch.bench.common import forward_macs
    from fire_tpu_torch.train import optim
    from fire_tpu_torch.train.trainer import model_batch_stats
    from fire_tpu_torch.weights import flax_shapes, load_flax, materialize

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = model.cuda()
    load_flax(model, materialize(flax_shapes(model), seed=0))
    opt = optim.chain(optim.clip_by_global_norm(5.0),
                      optim.adamw(optim.cosine_decay_schedule(lr, default_steps, 0.05)))
    params = list(model.parameters())
    state = ((params, model_batch_stats(model), opt.init(params)) if with_stats
             else (params, opt.init(params)))
    step = make_step(model, opt)
    pool = _scene_pool(scene_hw, batch, max_faces, face_px, seed=11)
    idx = torch.arange(batch, device="cuda")
    x = torch.zeros((1, *hw, 3), device="cuda")
    macs = forward_macs(model, x) * batch
    _, memo = memorise(step, state, (*pool, idx), batch, macs, base)
    memo["graphs"] = step_graphs(step)
    check(memo["graphs"]["keys"] == 1, f"train_detectors {name}: graphs {memo['graphs']}")
    step.release_graphs()
    check(memo["loss_last"] < 0.5 * memo["loss_first"],
          f"train_detectors {name}: the loss went {memo['loss_first']:.3f} → "
          f"{memo['loss_last']:.3f}")
    return memo


def phase_train_detectors(ctx) -> None:
    """Each detector trainer at full width, its default batch and size:
    YuNet-64 at 320², B = 32; BlazeFace at 192² letterboxed from 480×640,
    B = 64; RetinaFace (ResNet-50) at 512² letterboxed from 480×640,
    B = 8.  For each, a fixed-batch memorisation of the pool step (the
    loss falls below half; ms a step, images/s, peak memory), then the
    trainer's ``main`` for a few dozen steps on a 64-scene pool.  BlazeFace
    and RetinaFace fine-tune the committed weights (``--init_from``) at lr
    1e-5, and their held-out P/R through ``detect_faces`` (the trainer's
    ``--eval_scenes``) stays within 0.15 of the starting weights' P/R,
    measured here on the same scenes."""
    import torch

    from fire_tpu_torch.config import RecognizerConfig
    from fire_tpu_torch.models.blazeface import BlazeFace
    from fire_tpu_torch.models.retinaface import RetinaFace
    from fire_tpu_torch.models.yunet import YuNet
    from fire_tpu_torch.pipeline.engine import DeviceEngine
    from fire_tpu_torch.train import detect, detect_blaze, detect_retina
    from fire_tpu_torch.train.scenes import make_identities

    bf16 = torch.bfloat16
    work = os.path.join(ctx["tmp"], "train_detectors")
    os.makedirs(work)
    pool_args = ["--pool", "64", "--device_pool", "64", "--gen_threads", "2", "--log_every",
                 "8", "--device", "cuda"]
    rec = {}

    t0 = time.perf_counter()
    memo = _detector_run(
        "yunet", YuNet(), lambda m, o: detect.make_pool_train_step(m, o, (320, 320),
                                                                   compute_dtype=bf16),
        (320, 320), (320, 320), 32, 3, (24, 192), 2e-3, 3000, True)
    out = os.path.join(work, "yunet.msgpack")
    detect.main(["--steps", "24", "--out", out, "--eval_scenes", "0", *pool_args])
    eng = DeviceEngine(RecognizerConfig(weights_dir=None).with_embedding_dim(), device="cuda")
    eng.load_trained_detector(out)
    found = eng.detect_faces(_frames(seed=12, n_scenes=1, per_scene=1)[0])
    rec["yunet"] = {"width": 64, "hw": [320, 320], "memorise": memo,
                    "main": {"steps": 24, "faces_found_by_24_step_weights": len(found)},
                    "seconds": time.perf_counter() - t0}

    fine_tunes = (
        ("blazeface", BlazeFace, detect_blaze, "blazeface192_synth.msgpack", 64, 2, (140, 480),
         2e-3, 4000, False, (192, 192), detect_blaze.engine_config(192), 32,
         lambda m, o: detect_blaze.make_blaze_pool_train_step(m, o, input_px=192,
                                                              compute_dtype=bf16),
         ["--input_px", "192"]),
        ("retinaface", RetinaFace, detect_retina, "retinaface_synth.msgpack", 8, 3, (40, 360),
         1e-3, 3000, True, (512, 512), detect_retina.engine_config((512, 512)), 24,
         lambda m, o: detect_retina.make_retina_pool_train_step(m, o, (512, 512),
                                                                compute_dtype=bf16),
         ["--save_every", "0"]),
    )
    for (name, model, module, committed, batch, max_faces, face_px, lr, default_steps,
         with_stats, hw, cfg, n_eval, make_step, extra) in fine_tunes:
        t0 = time.perf_counter()
        memo = _detector_run(name, model(), make_step, hw, (480, 640), batch, max_faces, face_px,
                             lr, default_steps, with_stats)
        torch.cuda.empty_cache()
        scenes = detect.eval_scenes(make_identities(200, seed=0), n_eval, 0, (480, 640),
                                    max_faces, face_px)
        start = detect.held_out_pr(cfg, _trained(committed), scenes, "cuda")
        out = os.path.join(work, f"{name}.msgpack")
        tuned = module.main(["--steps", "16", "--init_from", _trained(committed), "--lr", "1e-5",
                             "--out", out, "--eval_scenes", str(n_eval), *extra, *pool_args])
        rec[name] = {"hw": list(hw), "scene_hw": [480, 640], "memorise": memo,
                     "fine_tune": {"steps": 16, "lr": 1e-5, "eval_scenes": n_eval,
                                   "start": start, "tuned": tuned},
                     "seconds": time.perf_counter() - t0}
        for k in ("precision", "recall"):
            check(abs(tuned[k] - start[k]) <= 0.15,
                  f"train_detectors {name}: held-out {k} {start[k]:.3f} → {tuned[k]:.3f}")
    emit({"phase": "train_detectors", "compute": "bf16, float32 masters", **rec})


TRAIN_GRAPH_STEPS = 5  # steps of each graph-vs-eager comparison
TRAIN_TIMED = 5  # timed steps of each side, after 3 untimed


@contextlib.contextmanager
def _train_builds():
    """While active, every training graph built records its build's wall
    seconds (warm-up and capture), its capture seconds and pool bytes,
    and whether building it left the tensors it writes bitwise as they
    were."""
    import torch

    from fire_tpu_torch.runtime import graphs

    real, builds = graphs.CapturedCall, []

    class Recording(real):
        def __init__(self, fn, inputs, pool, state=(), writes=None, others=()):
            before = [t.detach().clone() for t in writes or ()]
            t0 = time.perf_counter()
            super().__init__(fn, inputs, pool, state, writes, others)
            _sync_all()
            builds.append({"build_s": time.perf_counter() - t0, "capture_s": self.capture_s,
                           "pool_gb": self.pool_bytes / 1e9,
                           "pool_gb_by_device": {d: b / 1e9 for d, b in
                                                 self.pool_bytes_by_device.items()},
                           "device": str(self.device),
                           "cards": [str(d) for d in self.devices],
                           "training": writes is not None,
                           "kept_state": all(torch.equal(a, b)
                                             for a, b in zip(before, writes or ()))})

    graphs.CapturedCall = Recording
    try:
        yield builds
    finally:
        graphs.CapturedCall = real


def _full_width_trainers() -> dict:
    """The four one-device training steps at the JAX command lines'
    defaults: name → ``build(compute_dtype)`` giving a fresh ``(step,
    state, args_of)`` (the same state at every call), ``args_of(i)`` the
    arguments of step i after the state.  The detectors' cosine schedule
    ends after 4 steps, so that each step's learning rate differs and a
    value frozen at the capture would show."""
    import numpy as np
    import torch

    from fire_tpu_torch.models.blazeface import BlazeFace
    from fire_tpu_torch.models.retinaface import RetinaFace
    from fire_tpu_torch.models.yunet import YuNet
    from fire_tpu_torch.train import detect, detect_blaze, detect_retina, optim
    from fire_tpu_torch.train.trainer import model_batch_stats
    from fire_tpu_torch.weights import flax_shapes, load_flax, materialize

    def detector(model_fn, make_step, scene_hw, batch, max_faces, face_px, lr, with_stats):
        host = []

        def build(dtype):
            model = model_fn().cuda()
            load_flax(model, materialize(flax_shapes(model), seed=0))
            opt = optim.chain(optim.clip_by_global_norm(5.0),
                              optim.adamw(optim.cosine_decay_schedule(lr, 4, 0.05)))
            params = list(model.parameters())
            state = ((params, model_batch_stats(model), opt.init(params)) if with_stats
                     else (params, opt.init(params)))
            if not host:
                host.extend(t.cpu() for t in _scene_pool(scene_hw, batch, max_faces, face_px,
                                                         seed=12))
            pool = [t.cuda() for t in host]
            idx = [torch.tensor(np.random.default_rng(42 + i).permutation(batch), device="cuda")
                   for i in range(TRAIN_GRAPH_STEPS)]
            return (make_step(model, opt, dtype), state,
                    lambda i: (*pool, idx[i % TRAIN_GRAPH_STEPS]))

        return build

    return {
        "arcface": _arcface_build(),
        "yunet": detector(YuNet, lambda m, o, d: detect.make_pool_train_step(
            m, o, (320, 320), compute_dtype=d), (320, 320), 32, 3, (24, 192), 2e-3, True),
        "blazeface": detector(BlazeFace, lambda m, o, d: detect_blaze.make_blaze_pool_train_step(
            m, o, input_px=192, compute_dtype=d), (480, 640), 64, 2, (140, 480), 2e-3, False),
        "retinaface": detector(RetinaFace, lambda m, o, d: detect_retina.make_retina_pool_train_step(
            m, o, (512, 512), compute_dtype=d), (480, 640), 8, 3, (40, 360), 1e-3, True),
    }


def _arcface_build(mesh=None):
    """``build(compute_dtype)`` of the ArcFace step at full width
    (FaceNet-512, B = 64, 160², C = 32): a fresh ``(step, state,
    args_of)`` on one card, or on ``mesh`` (the model on its first
    device, the state laid out on it), the same state at every call."""
    import numpy as np
    import torch

    from fire_tpu_torch.models.facenet import facenet_512
    from fire_tpu_torch.train import optim
    from fire_tpu_torch.train.trainer import JAX_INIT_SEED, init_state, make_train_step

    home = "cuda" if mesh is None else mesh.devices[0, 0]
    rng = np.random.default_rng(41)
    faces = rng.random((BATCH, 160, 160, 3)).astype(np.float32)
    perms = [rng.permutation(BATCH) for _ in range(TRAIN_GRAPH_STEPS)]

    def build(dtype):
        model = facenet_512().to(home)
        opt = optim.adamw(1e-3)
        state = init_state(model, JAX_INIT_SEED, 32, opt, mesh=mesh)
        images = torch.tensor(faces, device=home)
        labels = torch.tensor(np.arange(BATCH) % 32, dtype=torch.int32, device=home)
        batches = [(images[p], labels[p]) for p in perms]
        return (make_train_step(model, opt, mesh=mesh, compute_dtype=dtype), state,
                lambda i: batches[i % TRAIN_GRAPH_STEPS])

    return build


@contextlib.contextmanager
def _exact_float32():
    """float32 kept float32 (TF32 off) and cuDNN deterministic, as the
    card tests compare a graph with its eager step."""
    import torch

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags


def _state_tensors(state) -> list:
    import torch
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]


def _graph_vs_eager_bitwise(build) -> dict:
    """``TRAIN_GRAPH_STEPS`` steps of the eager step, then of a graph,
    from one state, float32: losses, parameters, BatchNorm statistics,
    moments and counts bitwise equal after every step (the eager side's
    kept as copies on the card, and its model freed before the graph is
    built); the build left the state as it was; the caller's tensors
    unchanged.  Peak memory of an eager step beside the graph's pool."""
    import torch

    ms = {"eager": [], "graph": []}

    def run(step, state, args, side):
        after = []
        for i in range(TRAIN_GRAPH_STEPS):
            _sync_all()
            t0 = time.perf_counter()
            state, loss, *_ = step(state, *args(i))
            _sync_all()
            ms[side].append((time.perf_counter() - t0) * 1e3)
            after.append([loss.clone()] + [t.detach().clone() for t in _state_tensors(state)])
        return state, after

    eager, state, args = build(None)
    eager._graphed = lambda device: False
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, want = run(eager, state, args, "eager")
    eager_peak = torch.cuda.max_memory_allocated() - base
    del eager, state, args
    gc.collect()
    torch.cuda.empty_cache()
    with _train_builds() as builds:
        graphed, state, args = build(None)
        callers = [t.clone() for i in range(TRAIN_GRAPH_STEPS) for t in args(i)]
        state, got = run(graphed, state, args, "graph")
        for i, (a, b) in enumerate(zip(want, got)):
            check(torch.equal(a[0], b[0]),
                  f"train graph vs eager: step {i} loss {float(b[0])} vs {float(a[0])}")
            same = [torch.equal(x, y) for x, y in zip(a[1:], b[1:])]
            check(all(same), f"train graph vs eager: step {i}: {same.count(False)} of "
                             f"{len(same)} state tensors differ")
        counts = [int(t) for t in _state_tensors(state) if t.dtype == torch.int32]
        check(counts and set(counts) == {TRAIN_GRAPH_STEPS}, f"train graph: counts {counts}")
        kept = all(torch.equal(a, b) for a, b in zip(
            callers, [t for i in range(TRAIN_GRAPH_STEPS) for t in args(i)]))
        check(kept, "train graph vs eager: a replay wrote a caller's tensor")
        graphs = step_graphs(graphed)
        graphed.release_graphs()
    check(len(builds) == 1 and builds[0]["kept_state"],
          f"train graph vs eager: building moved the state ({builds})")
    return {"steps": TRAIN_GRAPH_STEPS, "bitwise_equal": True, "counts": counts[0],
            "build": builds[0], "graphs": graphs, "eager_peak_gb": eager_peak / 1e9,
            "ms_per_step_f32": {k: median(v[1:]) for k, v in ms.items()}}


def _timed_sides(build) -> dict:
    """At the command line's bf16: ms a step of the eager step, then of
    the graph on the same step and state (3 untimed steps, the capture
    among them, then ``TRAIN_TIMED`` timed by the host clock around
    synchronised steps), the build's seconds and pool."""
    import torch

    with _train_builds() as builds:
        step, state, args = build(torch.bfloat16)
        out = {}
        for side in ("eager", "graph"):
            if side == "eager":
                step._graphed = lambda device: False
            else:
                del step._graphed
            times = []
            for i in range(3 + TRAIN_TIMED):
                _sync_all()
                t0 = time.perf_counter()
                state, loss, *_ = step(state, *args(i))
                _sync_all()
                if i >= 3:
                    times.append((time.perf_counter() - t0) * 1e3)
            check(bool(torch.isfinite(loss)), f"train graph: {side} bf16 loss {float(loss)}")
            out[side] = {"ms_per_step": median(times), "ms_steps": times}
        step.release_graphs()
    out["build"] = builds[0]
    out["graph_over_eager"] = out["graph"]["ms_per_step"] / out["eager"]["ms_per_step"]
    return out


def phase_train_graph(ctx) -> None:
    """``train graph vs eager``: each one-device training step at full
    width (ArcFace FaceNet-512 B = 64 at 160²; YuNet-64 at 320², B = 32;
    BlazeFace 192² from 480×640, B = 64; RetinaFace 512² from 480×640,
    B = 8): the graph against the eager step, bitwise over 5 steps in
    float32 with TF32 off and cuDNN deterministic (the card tests'
    comparison); then at bf16, ms a step eager and graphed, the build's
    and the capture's seconds and the pool the capture took.  Every
    graph is released at the end of its check."""
    import torch

    rec = {"phase": "train_graph", "check": "train graph vs eager", "card": ctx["smi"]}
    for name, build in _full_width_trainers().items():
        t0 = time.perf_counter()
        with _exact_float32():
            exact = _graph_vs_eager_bitwise(build)
        gc.collect()
        torch.cuda.empty_cache()
        rec[name] = {"float32_bitwise": exact, "bf16": _timed_sides(build),
                     "seconds": time.perf_counter() - t0}
        gc.collect()
        torch.cuda.empty_cache()
    emit(rec)


def _one_face_scene(seed: int):
    """A rendered short-range 1080p scene with one face (420–700 px)."""
    import numpy as np

    from fire_tpu_torch.train.scenes import compose_scene, make_identities

    return compose_scene(np.random.default_rng(seed), make_identities(8, seed=seed),
                         hw=(1080, 1920), n_faces=(1, 1), face_px=(420, 700))[0]


def phase_cross_device(ctx) -> None:
    import numpy as np
    import torch

    from fire_tpu_torch.config import EngineConfig, RecognizerConfig
    from fire_tpu_torch.gallery.index import DeviceGallery
    from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine
    from fire_tpu_torch.pipeline.engine import DeviceEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = RecognizerConfig(
        detector_type="yunet", encoder_model_type="512", similarity_threshold=0.7,
        unknown_trigger_count=1, detection_interval=1, weights_dir=None,
        engine=EngineConfig(compute_dtype="float32", strict_f32_preprocess=True),
    ).with_embedding_dim()
    frames = np.stack(_frames(seed=2, n_scenes=1, per_scene=8))
    rows = _gallery_rows(ctx)
    sides = {}
    for dev in ("cuda", "cpu"):
        eng = DeviceEngine(cfg, device=dev)
        eng.load_trained_detector(_trained("yunet_synth.msgpack"))
        eng.load_trained_encoder(_trained("facenet512_synth.msgpack"))
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
    per_frame = _cross_device_per_frame({d: bse.engine for d, (bse, _) in sides.items()}, cfg)
    multi = _cross_device_multistream(sides, cfg)
    executor = _cross_device_executor()
    training = _cross_device_training()
    emit({"phase": "cross_device", "frames": len(frames), "dtype": "float32", "tf32": False,
          "box_err_px": max(be1, be2), "sim_err": max(se1, se2),
          "matched_gid": N_GALLERY, "per_frame": per_frame, "multistream": multi,
          "executor": executor, "training": training})


def _cross_device_training() -> dict:
    """One ArcFace step (FaceNet-512, B = 8, 160²) and one YuNet pool
    step (YuNet-64, B = 4, 320²) from one state, Adam 1e-3, on the card
    through the step's CUDA graph and on the CPU eagerly, float32 with
    TF32 off: the losses at rtol 1e-4, and each gradient tensor within
    5e-2 of the CPU's in relative L2 norm.  A step's gradient is read
    from Adam's first moment after it, ``(1 − b1)·g`` (one rounding of
    ``0.1·g``).  Tensors whose largest gradient is under 1e-4 of the
    model's are left out: a bias just before a BatchNorm has a gradient
    of zero but for rounding (3.9e-6 of the largest at most on the CPU in
    this step, every other tensor's 1.7e-3 at least).  The gradients of
    this step are ill-conditioned in float32: BatchNorm's fast variance
    ``E[x²] − E[x]²`` cancels where activations have a large mean, so the
    CPU's own float32 gradients of this ArcFace step are up to 1.5e-2
    (relative L2) from JAX's in float64, and single elements up to 0.12
    of the tensor's largest gradient (``tools/torch_train_precision.py``);
    the card sums in another order and lands as far on the other side.
    The largest element error is reported too."""
    import numpy as np
    import torch

    from fire_tpu_torch.models.facenet import facenet_512
    from fire_tpu_torch.models.yunet import YuNet
    from fire_tpu_torch.train import optim
    from fire_tpu_torch.train.detect import make_pool_train_step, pad_gt
    from fire_tpu_torch.train.scenes import compose_scene, make_identities
    from fire_tpu_torch.train.trainer import TrainState, make_train_step, model_batch_stats
    from fire_tpu_torch.weights import flax_shapes, load_flax, materialize

    rng = np.random.default_rng(21)
    faces = rng.random((8, 160, 160, 3)).astype(np.float32)
    labels = np.arange(8) % 4
    classifier = (rng.standard_normal((512, 4)) * 0.01).astype(np.float32)
    idents = make_identities(4, seed=22)
    scenes = [compose_scene(np.random.default_rng(s), idents, hw=(320, 320), n_faces=(1, 3),
                            face_px=(24, 192)) for s in range(4)]
    pool = [np.stack([sc[0] for sc in scenes]).astype(np.uint8)] + [
        np.stack([pad_gt(b, l, 3)[i] for _, b, l in scenes]) for i in range(3)]
    variables = {"facenet": materialize(flax_shapes(facenet_512()), seed=23),
                 "yunet": materialize(flax_shapes(YuNet()), seed=24)}
    b1 = 0.9

    def grads(opt_state):  # Adam's first moment after one step: (1 − b1)·g
        return [(t / (1.0 - b1)).double().cpu().numpy() for t in opt_state[0].mu]

    def steps(dev):
        out = {}
        model = facenet_512()
        load_flax(model, variables["facenet"])
        model.to(dev)
        opt = optim.adam(1e-3)
        cls = torch.tensor(classifier, device=dev, requires_grad=True)
        params = list(model.parameters())
        state = TrainState(params, model_batch_stats(model), cls, opt.init(params + [cls]), 0)
        step = make_train_step(model, opt)
        state, loss = step(state, torch.tensor(faces, device=dev),
                           torch.tensor(labels, device=dev))
        out["arcface"] = (loss.item(), grads(state.opt_state), len(step.graphs))
        step.release_graphs()
        model = YuNet()
        load_flax(model, variables["yunet"])
        model.to(dev)
        params = list(model.parameters())
        step = make_pool_train_step(model, opt, (320, 320))
        state, loss, _ = step((params, model_batch_stats(model), opt.init(params)),
                              *(torch.tensor(a, device=dev) for a in pool), np.arange(4))
        out["yunet"] = (loss.item(), grads(state[2]), len(step.graphs))
        step.release_graphs()
        return out

    card, cpu = steps("cuda"), steps("cpu")
    rec = {}
    for name in card:
        (la, ga, keys), (lb, gb, _) = card[name], cpu[name]
        check(keys == 1, f"cross_device: the card's {name} step did not replay a graph")
        scale = max(float(np.abs(b).max()) for b in gb)
        live = [(a, b) for a, b in zip(ga, gb) if np.abs(b).max() > 1e-4 * scale]
        rel_l2 = max(float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in live)
        worst = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in live)
        rec[name] = {"card": "graph", "loss_card": la, "loss_cpu": lb, "tensors": len(live),
                     "worst_rel_l2": rel_l2, "worst_element_of_max": worst}
        check(abs(la - lb) <= 1e-4 * abs(lb), f"cross_device: {name} loss {la} vs {lb}")
        check(rel_l2 <= 5e-2, f"cross_device: {name} gradients differ by {rel_l2} (relative L2)")
    return rec


def _cross_device_multistream(sides: dict, cfg) -> dict:
    """One 2-stream step of 4 frames a stream, on a mesh of the card
    repeated and of the CPU repeated: the same ids, boxes within 1 px."""
    import numpy as np

    from fire_tpu_torch.parallel.mesh import make_mesh
    from fire_tpu_torch.parallel.multistream import MultiStreamEngine

    frames = np.stack([np.stack(_frames(seed=40 + i, n_scenes=1, per_scene=6)) for i in range(2)])
    out = {}
    for dev, (bse, gal) in sides.items():
        mesh = make_mesh(devices=["cuda:0" if dev == "cuda" else "cpu"] * 2)
        out[dev] = MultiStreamEngine(bse.engine, gal, cfg, mesh).process_batches(frames)
    box_err, sim_err = 0, 0.0
    for a, b in zip(out["cuda"], out["cpu"]):
        for f in ("tid", "gid", "mask", "enroll"):
            check(np.array_equal(getattr(a, f), getattr(b, f)),
                  f"cross_device: multistream {f} differs")
        box_err = max(box_err, int(np.abs(a.boxes.astype(np.int64) - b.boxes).max()))
        sim_err = max(sim_err, float(np.abs(a.sim - b.sim).max()))
    check(box_err <= 1 and sim_err <= 2e-3 and any(r.mask.any() for r in out["cuda"]),
          f"cross_device: multistream boxes {box_err} px, sims {sim_err}")
    return {"streams": 2, "frames_per_stream": 6, "box_err_px": box_err, "sim_err": sim_err}


def _cross_device_executor() -> dict:
    """The ONNX executor on the committed YuNet exported as ONNX, one
    640² input, on the card and on the CPU."""
    import numpy as np

    from fire_tpu_torch.models.onnx_exec import OnnxModel
    from fire_tpu_torch.models.onnx_export import export_yunet
    from fire_tpu_torch.models.onnx_import import read_onnx_bytes
    from fire_tpu_torch.weights import read_msgpack

    graph = read_onnx_bytes(export_yunet(read_msgpack(_trained("yunet_synth.msgpack"))))
    x = np.random.default_rng(13).uniform(0, 255, (1, 3, 640, 640)).astype(np.float32)
    outs = {dev: [t.cpu().numpy() for t in OnnxModel(graph, device=dev)(x)]
            for dev in ("cuda", "cpu")}
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs["cuda"], outs["cpu"]))
    check(err <= 1e-3, f"cross_device: the executor's YuNet differs by {err}")
    return {"graph": "yunet-640 (committed weights)", "outputs": len(graph.outputs),
            "max_abs_err": err}


def _cross_device_per_frame(yunet: dict, cfg) -> dict:
    """The per-frame engine calls on the card against the CPU, float32:
    boxes and landmarks within 1 px, cosine of paired embeddings at
    least 0.9999.  ``yunet`` maps a device name to a loaded engine."""
    import dataclasses

    import numpy as np

    from fire_tpu_torch.config import EngineConfig
    from fire_tpu_torch.pipeline.engine import DeviceEngine
    from fire_tpu_torch.train.scenes import compose_scene, make_identities

    def min_cos(a, b):
        return float(((a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)).min())

    out = {}
    frame = _frames(seed=5, n_scenes=1, per_scene=1, n_faces=(2, 3))[0]
    dets = {d: e.detect_faces(frame) for d, e in yunet.items()}
    a, b = dets["cuda"], dets["cpu"]
    check(len(a) == len(b) > 0, f"cross_device: detect_faces found {len(a)} vs {len(b)}")
    out["detect_faces"] = {
        "faces": len(a),
        "box_err_px": int(max(np.abs(np.subtract(x["bbox"], y["bbox"])).max()
                              for x, y in zip(a, b))),
        "landmark_err_px": int(max(np.abs(x["landmarks"] - y["landmarks"]).max()
                                   for x, y in zip(a, b)))}
    check(out["detect_faces"]["box_err_px"] <= 1 and out["detect_faces"]["landmark_err_px"] <= 1,
          f"cross_device: detect_faces {out['detect_faces']}")
    boxes = np.asarray([d["bbox"] for d in b], np.float32)
    lms3 = np.stack([d["landmarks"][[1, 0, 2]] for d in b]).astype(np.float32)
    for name, arg in (("encode_boxes", boxes), ("encode_landmarks", lms3)):
        e = {d: getattr(eng, name)(frame, arg) for d, eng in yunet.items()}
        out[name] = {"min_cos": min_cos(e["cuda"], e["cpu"])}
        check(out[name]["min_cos"] >= 0.9999, f"cross_device: {name} {out[name]}")
    for align in (True, False):
        crops = {d: eng.extract_faces(frame, align=align) for d, eng in yunet.items()}
        check(len(crops["cuda"]) == len(crops["cpu"]) == len(a),
              "cross_device: extract_faces count")
        err = float(max(np.abs(x - y).mean() for x, y in zip(crops["cuda"], crops["cpu"])))
        out[f"extract_faces(align={align})"] = {"mean_abs_err": err}
        check(err <= 2e-3, f"cross_device: extract_faces(align={align}) differs by {err}")

    # BlazeFace at 192² on a short-range scene (the scale its weights know)
    bcfg = dataclasses.replace(
        cfg, detector_type="mediapipe",
        engine=EngineConfig(compute_dtype="float32", strict_f32_preprocess=True,
                            blazeface_size=(192, 192)))
    scene = compose_scene(np.random.default_rng(9), make_identities(8, seed=9), hw=(1080, 1920),
                          n_faces=(2, 2), face_px=(420, 700))[0]
    found = {}
    for dev in yunet:
        eng = DeviceEngine(bcfg, device=yunet[dev].device, encoder=yunet[dev].encoder)
        eng.load_trained_detector(_trained("blazeface192_synth.msgpack"))
        eng.weight_source["encoder"] = yunet[dev].weight_source["encoder"]
        d = eng.detect(scene)
        keep = d.mask.cpu().numpy()
        found[dev] = (d.boxes_xywh.cpu().numpy()[keep], d.landmarks.cpu().numpy()[keep],
                      d.scores.cpu().numpy()[keep])
    (ba, la, sa), (bb, lb, sb) = found["cuda"], found["cpu"]
    check(len(ba) == len(bb) > 0, f"cross_device: BlazeFace found {len(ba)} vs {len(bb)}")
    out["blazeface_detect"] = {"faces": len(ba), "box_err_px": float(np.abs(ba - bb).max()),
                               "landmark_err_px": float(np.abs(la - lb).max()),
                               "score_err": float(np.abs(sa - sb).max())}
    check(out["blazeface_detect"]["box_err_px"] <= 1.0
          and out["blazeface_detect"]["landmark_err_px"] <= 1.0,
          f"cross_device: BlazeFace {out['blazeface_detect']}")

    # RetinaFace at 512², committed weights, on a 1080p frame of 1–3 faces:
    # the same faces kept, IoU >= 0.9 box by box, landmarks within 2 px
    rcfg = dataclasses.replace(
        cfg, detector_type="retinaface",
        engine=EngineConfig(compute_dtype="float32", strict_f32_preprocess=True,
                            retinaface_size=(512, 512)))
    frame = _frames(seed=11, n_scenes=1, per_scene=1, n_faces=(1, 3))[0]
    found = {}
    for dev in yunet:
        eng = DeviceEngine(rcfg, device=yunet[dev].device, encoder=yunet[dev].encoder)
        eng.load_trained_detector(_trained("retinaface_synth.msgpack"))
        d = eng.detect(frame)
        keep = d.mask.cpu().numpy()
        found[dev] = (d.boxes_xywh.cpu().numpy()[keep], d.landmarks.cpu().numpy()[keep])
    (ba, la), (bb, lb) = found["cuda"], found["cpu"]
    check(len(ba) == len(bb) > 0, f"cross_device: RetinaFace found {len(ba)} vs {len(bb)}")
    ious = [_iou_xywh(x, y) for x, y in zip(ba, bb)]
    out["retinaface_detect"] = {"faces": len(ba), "min_iou": min(ious),
                                "landmark_err_px": float(np.abs(la - lb).max())}
    check(min(ious) >= 0.9 and out["retinaface_detect"]["landmark_err_px"] <= 2.0,
          f"cross_device: RetinaFace {out['retinaface_detect']}")

    # the random-init FaceNet-128 (seed 0) at B = 4
    ecfg = dataclasses.replace(cfg, encoder_model_type="128").with_embedding_dim()
    crops = np.random.default_rng(12).uniform(0, 1, (4, 160, 160, 3)).astype(np.float32)
    embs = {dev: DeviceEngine(ecfg, device=dev).encode_faces(crops) for dev in yunet}
    out["facenet128_random_init"] = {"batch": 4, "min_cos": min_cos(embs["cuda"], embs["cpu"])}
    check(out["facenet128_random_init"]["min_cos"] >= 0.999,
          f"cross_device: random-init FaceNet-128 {out['facenet128_random_init']}")
    return out


# -------------------------------------------------------------------- main --


def kernel_summary(ctx) -> dict:
    """The contract line: K1 at the main path's shape (M = one query per
    frame of a 64-frame batch, the smallest compaction rung) in the form
    the step graph launches (the count read on the card), its int-count
    form's times beside, then K2
    (:func:`k2_summary`).  K1 with its
    launch counts on every path: batched (YuNet, RetinaFace), per-frame
    (YuNet, RetinaFace), image mode, the default command, encrypted, the
    multi-stream runs (S = 1, 2, 4 together on this card repeated; S = 2
    and 4 over distinct cards, None with one card), the end-to-end accuracy
    run (per-frame and batched), the sharded training step, the dry run
    and the bench phase (gallery, headline, crowd)."""
    from fire_tpu_torch.ops import cosine_top1 as k1

    main = next(r for r in ctx["k1"] if r.get("case") == f"M={BATCH} device count")
    host_count = next(r for r in ctx["k1"] if r.get("case") == f"M={BATCH}")
    worst = max(r["max_abs_err"] for r in ctx["k1"] if "max_abs_err" in r)
    return {"kernels": [{
        "name": k1.NAME, "route": "cuda", "source": "fire_tpu_torch/csrc/cosine_top1.cu",
        "replaces": "fire_tpu/ops/pallas_topk.py:61", "launches": ctx["k1_launches"],
        "launches_frame_path": ctx["k1_launches_frame_path"],
        "launches_image_mode": ctx["k1_launches_image_mode"],
        "launches_retina_path": ctx["k1_launches_retina_path"],
        "launches_retina_frame": ctx["k1_launches_retina_frame"],
        "launches_default_command": ctx["k1_launches_default_command"],
        "launches_encrypted": ctx["k1_launches_encrypted"],
        "launches_multistream": ctx["k1_launches_multistream"],
        "launches_multistream_distinct_cards": ctx["k1_launches_multistream_distinct"],
        "launches_eval_e2e_frame": ctx["k1_launches_eval_e2e_frame"],
        "launches_eval_e2e_batched": ctx["k1_launches_eval_e2e_batched"],
        "launches_train_sharded": ctx["k1_launches_train_sharded"],
        "launches_dryrun": ctx["k1_launches_dryrun"],
        "launches_bench": ctx["k1_launches_bench"],
        "max_abs_err": worst, "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "device_ms": main["kernel_device_ms"],
        "plan": main["plan"], "host_count_ms": host_count["kernel_ms"],
        "host_count_device_ms": host_count["kernel_device_ms"], **ctx["k1_build"]},
        k2_summary(ctx), k3_summary(ctx)]}


def k2_summary(ctx) -> dict:
    """K2 at the main path's shape (B = 64, T = 64, K = 8, identity), with
    its launch counts on every path and its time at every case's shape."""
    from fire_tpu_torch.track import scan as k2

    main = next(r for r in ctx["k2"] if r["identity"])
    return {
        "name": k2.NAME, "route": "cuda", "source": "fire_tpu_torch/csrc/track_scan.cu",
        "replaces": "fire_tpu/pipeline/batch_engine.py:131 (lax.scan of sort_step; no Pallas "
                    "kernel)",
        "launches": ctx["k2_launches"],
        "launches_retina_path": ctx["k2_launches_retina_path"],
        "launches_frame_path": ctx["k2_launches_frame_path"],
        "launches_retina_frame": ctx["k2_launches_retina_frame"],
        "launches_multistream": ctx["k2_launches_multistream"],
        "launches_multistream_distinct_cards": ctx["k2_launches_multistream_distinct"],
        "launches_dryrun": ctx["k2_launches_dryrun"],
        "launches_bench": ctx["k2_launches_bench"],
        "max_abs_err": max(r["max_abs_err"] for r in ctx["k2"]),
        "box_err_px": max(r["box_err_px"] for r in ctx["k2"]),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None, "device_ms": main["device_ms"],
        "ms_by_case": {r["case"]: r["ms"] for r in ctx["k2"]},
        "device_ms_by_case": {r["case"]: r["device_ms"] for r in ctx["k2"]},
        "outside_shared_by_case": {r["case"]: [n for n, w in zip(k2.ARRAYS, r["launch_plan"]["where"])
                                               if w != "shared"] for r in ctx["k2"]},
        **ctx["k2_build"]}


def k3_summary(ctx) -> dict:
    """K3 at RetinaFace's stage-1 shape (residual and ReLU), with its
    launch counts on the batched and per-frame paths and its time at
    every case's shape beside the library chain it replaces."""
    from fire_tpu_torch.ops import bn_act as k3

    main = next(r for r in ctx["k3"] if r["case"] == "RetinaFace stage1 bn3")
    return {
        "name": k3.NAME, "route": "cuda", "source": "fire_tpu_torch/csrc/bn_act.cu",
        "replaces": "cuDNN's float32 BatchNorm between bf16 casts, the residual add and the "
                    "ReLU (flax.linen.BatchNorm in eval; no Pallas kernel)",
        "launches": ctx["k3_launches"],
        "launches_retina_path": ctx["k3_launches_retina_path"],
        "launches_frame_path": ctx["k3_launches_frame_path"],
        "launches_retina_frame": ctx["k3_launches_retina_frame"],
        "bf16_values_differing": sum(r["bf16_values_differing"] for r in ctx["k3"]),
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "device_ms": main["kernel_device_ms"],
        "device_ms_by_case": {r["case"]: r["kernel_device_ms"] for r in ctx["k3"]},
        "library_device_ms_by_case": {r["case"]: r["library_device_ms"] for r in ctx["k3"]},
        "bound_ms_by_case": {r["case"]: r["bound_ms"] for r in ctx["k3"]},
        **ctx["k3_build"]}


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
            t0 = time.perf_counter()
            with recognizer_errors_fail(name):
                globals()[f"phase_{name}"](ctx)
            print(f"[chip_smoke] {name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr,
                  flush=True)
            # what the phase's engines and step graphs held goes back to the
            # card, for the next phase's subprocesses
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for key in ("fr", "fr_retina"):  # a phase failed before the trace phase closed it
            if key in ctx:
                ctx[key].close()
        shutil.rmtree(ctx["tmp"], ignore_errors=True)
    print(json.dumps(kernel_summary(ctx)))
    print(ctx["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
