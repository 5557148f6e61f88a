"""A later cell, configuration, traffic mix, per-layer metric or network
is new files and entries alone: in a copy, a dummy of each is added, the
command and the harness find them, and no file the copy had changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np

from harness import spec

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

# a toy encoder, with a PReLU whose slope is a parameter leaf of its own name
TOY_ENCODER = '''"""A toy encoder: a convolution, BatchNorm, PReLU, mean pool, linear."""

import torch
from torch import nn

from reference.nets import BatchNorm, QConv2d, QLinear, draw

ROLE = "encoder"
CHANNELS, SCALE = "rgb", 255.0
UNIT_BN_SCALE = False


class PReLU(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.full((c,), 0.25))

    def forward(self, x):
        return torch.where(x > 0, x, x * self.negative_slope[:, None, None])


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = QConv2d(3, 8, 3, stride=2, padding=1, bias=False)
        self.bn = BatchNorm(8, 1e-5)
        self.act = PReLU(8)
        self.head = QLinear(8, 24)

    def forward(self, x):
        y = self.act(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        return self.head(y.mean(dim=(2, 3)))


def build():
    return Toy()


def init(net, generator):
    with torch.no_grad():
        net.act.negative_slope.fill_(0.25)
    draw(net, generator, (48, 48), SCALE, UNIT_BN_SCALE)
'''

# run inside the copy: the harness finds, counts, draws and loads the toy encoder
TOY_PROBE = """
import json, sys, tempfile
sys.path[:0] = ["benchmark", "."]
import numpy as np
from harness import spec, weights, work
from reference import nets, pipeline
cfg = spec.config(spec.load_benchmark("."), "toy-config", ".")
with tempfile.TemporaryDirectory() as d:
    ref = pipeline.Reference(weights.resolve(cfg, 2**31 + 1, d, "cpu"), ".", "cpu")
    frame = np.random.default_rng(0).integers(0, 256, (120, 160, 3), dtype=np.uint8)
    emb = ref.embed(frame, np.array([[10.0, 10.0, 40.0, 40.0], [50.0, 20.0, 30.0, 60.0]]))
print(json.dumps({"file": nets.network("toyenc").__file__,
                  "kind": type(nets.build("toyenc")).__name__,
                  "macs": work.network_macs(cfg), "emb": emb.tolist()}))
"""


def _hashes(root) -> dict:
    return {os.path.relpath(os.path.join(d, f), root):
            hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
            for d, _, files in os.walk(root) if "__pycache__" not in d for f in files}


def test_new_cell_config_mix_and_metric_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _hashes(root)
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
    # a new encoder: its network file and a configuration that names it,
    # with seeded weights for both networks (the copy has no trained file)
    (root / "benchmark/reference/networks/toyenc.py").write_text(TOY_ENCODER)
    toy = dict(cfg, name="toy-config", encoder="toyenc", embedding_dim=24, encode_px=[48, 48],
               input_px=[160, 160], detector_weights="seeded", encoder_weights="seeded")
    (root / "benchmark/configs/toy-config.json").write_text(json.dumps(toy))
    bench["configs"].append({"name": "toy-config", "source": "https://example.org/toy",
                             "file": "benchmark/configs/toy-config.json", "reduced": [],
                             "why": "a test"})
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

    p = subprocess.run([sys.executable, "-c", TOY_PROBE], capture_output=True, text=True,
                       cwd=root, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    toy = json.loads(p.stdout.strip().splitlines()[-1])
    assert os.path.samefile(toy["file"], root / "benchmark/reference/networks/toyenc.py")
    assert toy["kind"] == "Toy"
    # the toy's convolution 24 x 24 x 8 outputs x 3 x 3 x 3, its linear layer 24 x 8
    assert toy["macs"]["encoder"] == 24 * 24 * 8 * 27 + 24 * 8
    assert toy["macs"]["detector"] == 542_393_600 * (160 * 160) // (640 * 640)
    emb = np.asarray(toy["emb"])
    assert emb.shape == (2, 24) and np.allclose(np.linalg.norm(emb, axis=1), 1.0)
    after = _hashes(root)
    assert {k: after.get(k) for k in before} == before


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
