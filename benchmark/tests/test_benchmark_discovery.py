"""A later cell, configuration, traffic mix or per-layer metric is new
files and entries alone: in a copy, a dummy of each is added and the
command and the harness find them."""

import json
import os
import shutil
import subprocess
import sys

from harness import spec

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def test_new_cell_config_mix_and_metric_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = json.load(open(os.path.join(spec.ROOT, bench["configs"][0]["file"])))
    cfg["name"] = "dummy-config"
    (root / "benchmark/configs/dummy-config.json").write_text(json.dumps(cfg))
    mix = spec.mix("live")
    mix["faces"] = [2, 2]
    (root / "benchmark/traffic/dummy-mix.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/dummy_ms.frame.py").write_text(
        "def read(r):\n    return 2 * r['setup_s'] if r['mode'] == 'per_frame' else None\n")
    bench["configs"].append({"name": "dummy-config", "source": "https://example.org/dummy",
                             "file": "benchmark/configs/dummy-config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy-config.dummy-mix", "config": "dummy-config",
                               "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_ms.frame", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "entry, per frame",
                               "moves": "frame_ms_p50",
                               "workloads": ["dummy-config.dummy-mix"]})
    bench["end_to_end"][1]["workloads"].append("dummy-config.dummy-mix")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    bdir = str(root / "benchmark")
    got = spec.load_benchmark(str(root))
    assert spec.config(got, "dummy-config", str(root))["name"] == "dummy-config"
    assert spec.mix("dummy-mix", bdir)["faces"] == [2, 2]
    out = spec.read_metrics(got, "dummy-config.dummy-mix", "per_layer",
                            {"mode": "per_frame", "setup_s": 3.0, "stages_ms": {},
                             "trace": None, "latency_ms": []}, bdir)
    assert out["dummy_ms.frame"] == {"value": 6.0, "unit": "ms"}
    # the command resolves the new cell before it looks for a card: on a
    # machine without one it stops there (exit 2), not at an unknown name
    run = [sys.executable, str(root / "benchmark/run.py"), "--workload",
           "dummy-config.dummy-mix", "--seed", "1", "--seconds", "1", "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(run, capture_output=True, text=True, cwd=root, timeout=300, env=env)
    assert p.returncode == 2 and "CUDA device" in p.stderr, p.stderr[-2000:]
    bad = subprocess.run(run[:3] + ["no-such-cell"] + run[4:], capture_output=True, text=True,
                         cwd=root, timeout=300, env=env)
    assert bad.returncode not in (0, 2)


def test_only_the_benchmark_files_do_not_run(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the command exits non-zero and prints no result."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "yunet640-facenet512-g100k.live", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
    assert p.returncode != 0 and '"correct"' not in p.stdout
