"""Command-line interface of the port (counterpart of ``fire_tpu.cli``):
the same flags, choices and defaults, plus ``--device``, and the same
wiring (``similarity_threshold=0.7``, ``unknown_trigger_count=1``,
detection interval forced to 1 in image mode, the committed
``weights_trained/`` defaults loaded into whichever model is still
random-init, RetinaFace sized to its committed 512² weights and the
mediapipe slot to 192² when no size is given, ``shrink_db_ids`` after
``--label`` runs, ``close`` at exit).

    python -m fire_tpu_torch --mode image --input scene.bmp --save out.bmp

A model with no committed weights (the 128-d encoder, the default) runs
the deterministic random init kept in the params cache, as in JAX.
Reference ONNX / TFLite files in ``--weights_dir`` are imported, or run
through the ONNX executor when their topology does not map.  ``--inputs``
runs several videos at once, one stream per device of the mesh (every
CUDA device):

    python -m fire_tpu_torch --mode video --inputs a.avi b.avi --save out.avi
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

from fire_tpu_torch.config import EngineConfig
from fire_tpu_torch.pipeline.recognizer import FaceRecognition
from fire_tpu_torch.utils.affinity import set_single_core_affinity

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fire_tpu_torch",
        description="Face Recognition System with Custom Filenames (PyTorch/CUDA port)"
    )
    p.add_argument("--mode", type=str, default="image", choices=["image", "video", "webcam"],
                   help="Which pipeline to run: one still image, a video file, or a live webcam stream")
    p.add_argument("--input", type=str, default=None, help="Input image/video location on disk")
    p.add_argument("--inputs", type=str, nargs="+", default=None,
                   help="Video mode: multiple videos processed as data-parallel "
                        "streams, one per device; all must share one resolution")
    p.add_argument("--save", type=str, default=None, help="Where to write the annotated result")
    p.add_argument("--label", type=str, default=None,
                   help="Identity name: relabels the matched face in image mode, renames recognized faces in webcam mode")
    p.add_argument("--log", action="store_true", help="Verbose INFO-level logging (default: critical only)")
    p.add_argument("--show", action="store_true", help="Open a window showing each processed frame (press q to stop streams; needs OpenCV)")
    p.add_argument("--password", type=str, default=None, help="At-rest encryption of database, index and outputs")
    p.add_argument("--detector", type=str, default="mediapipe",
                   choices=["mediapipe", "yunet", "retinaface"],
                   help="Detector type (mediapipe selects the BlazeFace-class fast path)")
    p.add_argument("--encoder", type=str, default=None, choices=["128", "512", "iresnet100"],
                   help="FaceNet embedding width, 128-d or 512-d, or ArcFace IResNet-100 "
                        "(512-d, 112x112 crops; no committed weights: pass --trained)")
    p.add_argument("--encoder_mode", type=str, default="cpu_optimized",
                   choices=["cpu_optimized", "gpu_optimized"],
                   help="Accepted for compatibility; the engine ignores it")
    p.add_argument("--align", action="store_true", help="3-point affine alignment of crops before encoding")
    p.add_argument("--align_video", action="store_true",
                   help="landmark-aligned crops in the per-frame video loop too "
                        "(recommended when distinct identities merge at the 0.7 threshold)")
    p.add_argument("--detection_interval", type=int, default=1,
                   help="Run the detector every Nth frame; the tracker coasts in between (1 = every frame)")
    p.add_argument("--core", type=int, default=0, help="Set to 1 to pin the process to a single CPU core (benchmarking aid)")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--annotate", dest="annotate", action="store_true",
                   help="Draw boxes + identity labels on output frames (default)")
    g.add_argument("--no-annotate", dest="annotate", action="store_false",
                   help="Emit frames without any drawn overlays")
    p.set_defaults(annotate=True)
    p.add_argument("--hnsw_index_path", type=str, default=None,
                   help="Override the default location of the gallery index file")
    p.add_argument("--hnsw_labels_path", type=str, default=None,
                   help="Override the default location of the gallery labels file")
    p.add_argument("--hnsw_db_ids_path", type=str, default=None,
                   help="Override the default location of the gallery DB-id mapping file")
    p.add_argument("--sqlite_db_path", type=str, default=None,
                   help="Override the default unencrypted SQLite database location")
    p.add_argument("--sqlite_db_encrypted_path", type=str, default=None,
                   help="Override the default encrypted SQLite database location (with --password)")
    p.add_argument("--interested_label", type=str, default=None,
                   help="Restrict emitted results to a single identity")
    p.add_argument("--batch_size", type=int, default=0,
                   help="Video mode: frames per device step (0 = classic per-frame pipeline)")
    p.add_argument("--encode_budget", type=int, default=0,
                   help="Batched video mode: cap crop+encode+match at the batch's top-N "
                        "detections by score (0 = encode every tracked slot)")
    p.add_argument("--profile", type=str, default=None,
                   help="Write a torch.profiler Chrome trace (trace.json) to this directory")
    p.add_argument("--weights_dir", type=str, default="weights",
                   help="Directory probed for reference weight files (facenet*.onnx, "
                        "face_detection_yunet_2023mar.onnx, retinaface.onnx, "
                        "face_detection_short_range.tflite)")
    p.add_argument("--trained", type=str, default=None,
                   help="Encoder variables from `python -m fire_tpu.train` (msgpack)")
    p.add_argument("--trained_detector", type=str, default=None,
                   help="Detector variables from `python -m fire_tpu.train.detect` (msgpack)")
    p.add_argument("--retinaface_size", type=int, default=None,
                   help="RetinaFace network input size (default: 512, the size the committed "
                        "default weights are trained at)")
    p.add_argument("--blazeface_size", type=int, default=None,
                   help="mediapipe-slot input size (default: 192, the size the committed "
                        "default weights are trained at; 128 selects the weaker 128 file)")
    p.add_argument("--no_default_weights", action="store_true",
                   help="Skip auto-loading the committed weights_trained/ defaults")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device everything runs on; 'cpu' must be asked for explicitly")
    return p


# committed trained defaults per detector slot.  The mediapipe slot's
# default operates at 192² (2016 anchors); the 128² file is the
# fallback for --blazeface_size 128.
_TRAINED_DEFAULTS = {
    "yunet": "yunet_synth.msgpack",
    "mediapipe": "blazeface192_synth.msgpack",
    "blazeface": "blazeface192_synth.msgpack",
    "retinaface": "retinaface_synth.msgpack",
}
_TRAINED_BLAZE_128 = "blazeface_synth.msgpack"


def _weights_trained_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "weights_trained")


def _load_trained_defaults(face_recog: FaceRecognition, args) -> None:
    """Load the committed ``weights_trained/`` files into whichever model
    is still ``"random-init"``; a model without a committed file keeps
    the random init (the engine has warned about a random detector)."""
    wdir = _weights_trained_dir()
    eng = face_recog.engine
    if eng.weight_source["detector"] == "random-init":
        fname = _TRAINED_DEFAULTS.get(args.detector)
        if args.detector in ("mediapipe", "blazeface") and args.blazeface_size == 128:
            fname = _TRAINED_BLAZE_128
        path = os.path.join(wdir, fname) if fname else None
        if args.detector == "retinaface" and args.retinaface_size != 512:
            # the committed weights are trained at 512: at any other size
            # they are no better than random
            log.warning("retinaface has no reference ONNX weights and the trained default needs "
                        "--retinaface_size 512 (got %s) — running RANDOM INIT; it will not find "
                        "real faces.", args.retinaface_size or 1024)
        elif path and os.path.exists(path):
            eng.load_trained_detector(path)
        else:
            log.warning("No weights found for detector %r (no committed default at %s) — "
                        "running RANDOM INIT.", args.detector, path)
    if eng.weight_source["encoder"] == "random-init":
        path = os.path.join(wdir, f"facenet{face_recog.cfg.encoder_model_type}_synth.msgpack")
        if os.path.exists(path):
            eng.load_trained_encoder(path)


def _usable(path: str, min_bytes: int) -> bool:
    """A reference file the JAX CLI's sizing rule counts: present and
    larger than a Git-LFS pointer could be."""
    return os.path.exists(path) and os.path.getsize(path) > min_bytes


def _run(args) -> None:
    defaults = not args.no_default_weights and args.trained_detector is None
    wd = args.weights_dir or "weights"
    # the committed RetinaFace weights are trained at 512², the mediapipe
    # slot's at 192²; an explicit size or a usable reference file wins
    if (args.detector == "retinaface" and args.retinaface_size is None and defaults
            and not _usable(os.path.join(wd, "retinaface.onnx"), 1_000_000)
            and os.path.exists(os.path.join(_weights_trained_dir(),
                                            _TRAINED_DEFAULTS["retinaface"]))):
        args.retinaface_size = 512
    if (args.detector in ("mediapipe", "blazeface") and args.blazeface_size is None and defaults
            and not any(_usable(os.path.join(wd, f), 100_000)
                        for f in ("face_detection_short_range.tflite", "blazeface.tflite",
                                  "blazeface.onnx", "face_detection_short_range.onnx"))
            and os.path.exists(os.path.join(_weights_trained_dir(),
                                            _TRAINED_DEFAULTS["mediapipe"]))):
        args.blazeface_size = 192
    size_kw = {}
    if args.retinaface_size:
        size_kw["retinaface_size"] = (args.retinaface_size, args.retinaface_size)
    if args.blazeface_size:
        size_kw["blazeface_size"] = (args.blazeface_size, args.blazeface_size)

    face_recog = FaceRecognition(
        detector_type=args.detector,
        align=args.align,
        align_video=args.align_video,
        encoder_model_type=args.encoder,
        encoder_mode=args.encoder_mode,
        similarity_threshold=0.7,
        enable_logging=args.log,
        show=args.show,
        unknown_trigger_count=1,
        detection_interval=1 if args.mode == "image" else args.detection_interval,
        encryption_password=args.password,
        hnsw_index_path=args.hnsw_index_path,
        hnsw_labels_path=args.hnsw_labels_path,
        hnsw_db_ids_path=args.hnsw_db_ids_path,
        sqlite_db_path=args.sqlite_db_path,
        sqlite_db_encrypted_path=args.sqlite_db_encrypted_path,
        interested_label=args.interested_label,
        weights_dir=args.weights_dir,
        trained_encoder=args.trained,
        trained_detector=args.trained_detector,
        engine_cfg=EngineConfig(**size_kw) if size_kw else None,
        encode_budget=args.encode_budget or None,
        device=args.device,
    )
    try:
        if not args.no_default_weights:
            _load_trained_defaults(face_recog, args)
        encoder_source = face_recog.engine.weight_source["encoder"]
        if args.encoder == "iresnet100" and encoder_source == "random-init":
            log.warning("ENCODER 'iresnet100' IS RUNNING RANDOM-INIT WEIGHTS — its embeddings "
                        "do not tell faces apart. No trained IResNet-100 is committed: pass "
                        "--trained FILE (its Flax msgpack weights).")

        if args.core:
            print(f"Use only 1 cpu core: {bool(args.core)}")
            set_single_core_affinity()

        if args.mode == "image":
            if args.input is None:
                log.error("Please provide the path to the input image using --input")
            else:
                face_recog.process_image(image_path=args.input, annotate=args.annotate,
                                         save_path=args.save, label=args.label)
        elif args.mode == "video":
            if args.inputs:
                face_recog.process_videos(video_paths=args.inputs, annotate=args.annotate,
                                          save_path=args.save,
                                          batch_size=args.batch_size or 8, name=args.label)
            elif args.input is None:
                log.error("Please provide the path to the input video using --input")
            else:
                face_recog.process_video(video_path=args.input, annotate=args.annotate,
                                         save_path=args.save, batch_size=args.batch_size)
        elif args.mode == "webcam":
            face_recog.process_webcam(annotate=args.annotate, save_path=args.save,
                                      name=args.label, batch_size=args.batch_size)

        if args.label:
            face_recog.shrink_db_ids()
    finally:
        face_recog.close()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.log else logging.CRITICAL,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if args.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(args.profile, exist_ok=True)
        prof = profile(activities=acts)
        prof.start()
    try:
        _run(args)
    except (NotImplementedError, ImportError) as e:
        # an ONNX op the executor lacks, or a file format / window that
        # needs OpenCV
        raise SystemExit(f"fire_tpu_torch: {e}") from e
    finally:
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))


if __name__ == "__main__":
    main()
