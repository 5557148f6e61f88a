"""The port stands alone: no module of fire_tpu_torch/, and not
chip_smoke.py, imports JAX, Flax, optax, orbax, fire_tpu, msgpack,
ml_dtypes or cryptography; cv2 and triton are imported only inside
functions."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "fire_tpu", "msgpack", "ml_dtypes",
          "cryptography"}
LAZY_ONLY = {"cv2", "triton"}


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "fire_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(tree):
    """(top-level package, at module level?) for every import."""
    found = []

    def visit(node, in_function):
        for child in ast.iter_child_nodes(node):
            inside = in_function or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                       ast.Lambda))
            if isinstance(child, ast.Import):
                found.extend((a.name.split(".")[0], not in_function) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                found.append((child.module.split(".")[0], not in_function))
            visit(child, inside)

    visit(tree, False)
    return found


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_module_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for name, module_level in _imports(tree):
        assert name not in BANNED, f"{path} imports {name}"
        assert not (name in LAZY_ONLY and module_level), f"{path} imports {name} at module level"


def test_lint_sees_the_whole_package():
    rel = {os.path.relpath(p, REPO) for p in _sources()}
    assert "chip_smoke.py" in rel
    assert "fire_tpu_torch/ops/cosine_top1.py" in rel
    for new in ("__main__.py", "cli.py", "models/blazeface.py", "ops/affine.py",
                "pipeline/annotate.py", "utils/affinity.py", "utils/imageio.py",
                "models/retinaface.py", "gallery/crypto.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/sharded_gallery.py", "parallel/multistream.py",
                "parallel/shards.py",
                "models/onnx_import.py", "models/onnx_exec.py", "models/onnx_export.py",
                "models/tflite_import.py", "verify_onnx.py", "train/optim.py",
                "train/losses.py", "train/trainer.py", "train/data.py", "train/__main__.py",
                "train/detect.py", "train/detect_blaze.py", "train/detect_retina.py",
                "bench/__init__.py", "bench/__main__.py", "bench/common.py", "bench/headline.py",
                "bench/gallery.py", "bench/tracker.py", "bench/crowd.py", "bench/profile.py",
                "export_bf16.py", "track/scan.py", "dryrun.py", "runtime/step_graph.py",
                "runtime/graphs.py"):
        assert f"fire_tpu_torch/{new}" in rel
    assert len(rel) >= 57
    assert _imports(ast.parse("import jax\ndef f():\n    import cv2\n")) == [("jax", True), ("cv2", False)]
