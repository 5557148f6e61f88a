"""``python -m fire_tpu_torch.bench {headline,gallery,tracker,crowd,profile}``
at tiny sizes with ``--device cpu``: each prints one JSON line whose
keys are its JAX script's (copied here from each script's ``print``; the
scripts are not imported).  ``headline`` adds the keys the port reports
beside ``bench.py``'s: the CUDA-event chain, its note, the pageable H2D
rate, and the two that say an OpenCV leg was not run.  A leg that raises
ends ``headline`` with a non-zero exit code and no JSON line."""

import json
import os
import subprocess
import sys

import pytest

from fire_tpu_torch.bench.__main__ import main
from fire_tpu_torch.utils import imageio
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench.py:455-488
BENCH_PY = {"metric", "value", "unit", "vs_baseline", "headline_median_fps", "headline_spread",
            "headline_note", "device_ms_per_batch", "fullcost_fps", "fullcost_median_fps",
            "fullcost_note", "frameskip_fps", "encode_budget_fps", "persistence",
            "e2e_process_video_fps", "e2e_note", "e2e_inram_fps", "host_plane_ms_per_frame",
            "projected_colocated_e2e_fps", "projected_note"}
HEADLINE_PORT_ONLY = {"device_ms_per_batch_cuda_events", "device_chain_note", "h2d_pageable_mbps"}
NO_CV2 = {"e2e_skipped", "inram_writer"}
# bench_gallery.py:66, bench_tracker.py:80, tools/bench_crowd.py:78-79 and 106-107,
# tools/profile_step.py:267-280
GALLERY = {"metric", "variants"}
TRACKER = {"metric", "variants"}
CROWD = {"faces_per_frame", "ms_per_frame", "detected_per_frame", "bucket_ladder", "batch"}
PROFILE = {"batch", "trained_workload", "full_step_ms", "fps", "stages_separate",
           "encoder_compacted_ms_by_bucket", "real_detections_in_batch", "chosen_bucket",
           "sum_stages_ms", "fusion_gain_ms", "xla_flops_estimate", "mfu_vs_197T_bf16"}


def _run(capsys, *argv):
    assert main([*argv, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1  # no nvidia-smi line on the CPU
    return json.loads(lines[0])


def test_headline(capsys):
    rec = _run(capsys, "headline", "--tiny")
    want = BENCH_PY | HEADLINE_PORT_ONLY | (set() if imageio.has_cv2() else NO_CV2)
    assert set(rec) == want
    assert rec["unit"] == "fps" and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 87.81, 3)
    assert set(rec["headline_spread"]) == set(rec["device_ms_per_batch"]) == {"8", "16"}
    assert set(rec["headline_spread"]["8"]) == {"best", "median", "p25", "p75", "min"}
    assert all(v is None for v in rec["device_ms_per_batch_cuda_events"].values())
    assert rec["h2d_pageable_mbps"] is None
    for key in ("fullcost_fps", "frameskip_fps", "encode_budget_fps", "e2e_inram_fps"):
        assert rec[key] > 0, key
    assert (rec["e2e_process_video_fps"] > 0) if imageio.has_cv2() else (
        rec["e2e_process_video_fps"] is None)
    plane = rec["host_plane_ms_per_frame"]
    # the port's own stage names, the JAX ones mapped onto them
    for key in ("read (prefetch stall)", "stack (host)", "submit (H2D + step)",
                "readback (wait + D2H)", "host stream_results", "host annotate",
                "host_work_total_ms_per_frame", "device_step_ms_per_frame_at_B128"):
        assert key in plane, key
    assert "host unpack+label+enroll" not in plane


def test_gallery(capsys):
    rec = _run(capsys, "gallery", "--tiny")
    assert set(rec) == GALLERY
    assert set(rec["variants"]) == {f"{v}_B{m}" for v in ("xla_bf16shadow", "xla_f32cast",
                                                         "pallas_bf16shadow") for m in (8, 64)}


def test_tracker(capsys):
    rec = _run(capsys, "tracker", "--batch", "16")
    assert set(rec) == TRACKER
    assert set(rec["variants"]) == {"lap_T64", "lap_T32", "greedy_T64", "greedy_T32"}


def test_crowd(capsys):
    rec = _run(capsys, "crowd", "--tiny")
    assert set(rec) == CROWD
    assert rec["faces_per_frame"] == [1, 4] and rec["batch"] == 8
    assert rec["bucket_ladder"] == [128, 512, 1024]
    assert len(rec["ms_per_frame"]) == len(rec["detected_per_frame"]) == 2


def test_profile(capsys, tmp_path):
    rec = _run(capsys, "profile", "--tiny", "--trace", str(tmp_path / "trace"))
    assert set(rec) == PROFILE
    assert rec["batch"] == 4 and rec["trained_workload"] is False
    assert set(rec["stages_separate"]) == {"detector_ms", "encoder_ms", "gallery_k1_top1_ms",
                                           "tracker_scan_ms"}
    assert list(rec["encoder_compacted_ms_by_bucket"]) == ["8", "16", "32"]
    assert rec["xla_flops_estimate"] > 0
    assert (tmp_path / "trace" / "profile_step.json").is_file()


def test_unknown_subcommand_is_refused(capsys):
    assert main(["bench"]) == 2
    assert "usage" in capsys.readouterr().err


def test_failing_leg_ends_headline_with_nonzero_exit():
    """``bench.py:93-125`` swallowed a leg's exception and printed zeros;
    here the full-cost leg raises, and the process exits non-zero having
    printed no JSON line."""
    code = (
        "import runpy, sys\n"
        "import fire_tpu_torch.bench.headline as h\n"
        "real = h.engine_leg\n"
        "def boom(*a, **kw):\n"
        "    if kw.get('encode_buckets') == ():\n"
        "        raise RuntimeError('full-cost leg failed')\n"
        "    return real(*a, **kw)\n"
        "h.engine_leg = boom\n"
        "sys.argv = ['bench', 'headline', '--tiny', '--device', 'cpu']\n"
        "runpy.run_module('fire_tpu_torch.bench', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode != 0
    assert "full-cost leg failed" in out.stderr
    assert out.stdout.strip() == ""
