"""The control (the reference in float8 put in the program's place)
comes out not correct by the harness's own verdict: on the CPU at a
small size here, and on the card at the cell's own size (``cuda``)."""

import json
import os
import subprocess
import sys

import pytest

from cpu_cell import run_cpu
from harness import spec

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("workload", ["yunet640-facenet512-g100k.live",
                                      "yunet640-facenet512-g100k.crowd-b64"])
def test_control_fails_a_limit_on_the_cpu(workload):
    out = run_cpu(workload, seconds=3.0, control=True)
    assert out["correct"] is True
    assert out["info"]["control"]["correct"] is False, out["info"]["control"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in spec.load_benchmark()["workloads"]
                                      if w["chips"] == 1])
def test_control_fails_a_limit_on_the_card(card, workload):
    p = subprocess.run([sys.executable, os.path.join(spec.BENCH_DIR, "run.py"), "--workload",
                        workload, "--seed", "3141592653", "--seconds", "5", "--trace", "0",
                        "--control", "1"], capture_output=True, text=True, cwd=spec.ROOT,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    info = json.loads([line for line in p.stderr.splitlines() if line.startswith('{"info"')][-1])
    print(json.dumps({"workload": workload, "checks": out["checks"],
                      "control": info["info"]["control"]["numbers"]}))
    assert out["correct"] is True
    assert info["info"]["control"]["correct"] is False, info["info"]["control"]
