"""What the command and the reference load: never a module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``fire_tpu``
(compared whole), and the reference nothing of the program."""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


PRELUDE = f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
REPORT = "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n"


def test_reference_loads_nothing_of_the_program():
    tops = _loaded(PRELUDE + "import reference.pipeline, reference.nets, reference.msgpack\n"
                   + REPORT)
    assert "reference" in tops
    assert not tops & {"jax", "jaxlib", "flax", "fire_tpu", "fire_tpu_torch"}


def test_the_command_loads_no_jax():
    """run.py's modules and every program module its harness reaches."""
    code = (PRELUDE + "import runpy; runpy.run_path('benchmark/run.py', run_name='bench')\n"
            "from harness import cell, drive, check, trace, traffic, work, spec\n"
            "drive.Recorder().install()\n"
            "import fire_tpu_torch.pipeline.recognizer, fire_tpu_torch.parallel.sharded_gallery\n"
            + REPORT)
    tops = _loaded(code)
    assert {"harness", "reference", "fire_tpu_torch"} <= tops
    assert not tops & {"jax", "jaxlib", "flax", "fire_tpu"}


def test_prefix_is_compared_whole():
    """The port's name begins with the JAX package's: only the whole
    top-level name ``fire_tpu`` counts."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_run", os.path.join(BENCH, "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    sys.modules["fire_tpu_torch_probe.sub"] = sys
    try:
        assert ("fire_tpu" in run.loaded_forbidden()) == ("fire_tpu" in sys.modules)
        sys.modules["fire_tpu"] = sys
        assert "fire_tpu" in run.loaded_forbidden()
    finally:
        sys.modules.pop("fire_tpu_torch_probe.sub")
        sys.modules.pop("fire_tpu", None)
