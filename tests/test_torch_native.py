"""``fire_tpu_torch.runtime.native`` (the port's copy of
``native/src/fire_native.cc``, built with the host C++ compiler) against
``fire_tpu.runtime.native``.

The JAX package loads ``libfire_native.so`` when it has been built and
otherwise uses SciPy / NumPy.  Here it is compared both ways: with its
library, built by these tests from ``native/src/fire_native.cc`` and
named by ``FIRE_NATIVE_LIB``, the two packages run the same algorithm
and return equal indices on every input, ties included; without it (the
JAX package's state on a checkout where nothing was built) they return
equal indices wherever the optimum is unique, and on ties the JAX package
returns SciPy's assignment while the port returns the native solver's,
which costs the same.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment as scipy_lap

from fire_tpu.runtime import native as jnative
from fire_tpu.track import assignment as JAssign
from fire_tpu_torch.runtime import native
from fire_tpu_torch.track import assignment as TAssign

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's own library, built from its source."""
    out = str(tmp_path_factory.mktemp("jaxnative") / "libfire_native.so")
    subprocess.run([shutil.which("g++"), "-O2", "-std=c++17", "-shared", "-fPIC", "-o", out,
                    os.path.join(REPO, "native", "src", "fire_native.cc")], check=True)
    return out


@pytest.fixture
def jax_with_library(jax_native_lib, monkeypatch):
    monkeypatch.setenv("FIRE_NATIVE_LIB", jax_native_lib)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    assert jnative.load_native() is not None
    yield
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)


@pytest.fixture
def jax_without_library(monkeypatch):
    monkeypatch.delenv("FIRE_NATIVE_LIB", raising=False)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)  # as if probed and not found
    yield


def _costs(seed: int, ties: bool):
    rng = np.random.default_rng(seed)
    n, m = (int(v) for v in rng.integers(1, 10, 2))
    if ties:  # few distinct values: many optima
        return rng.integers(0, 3, (n, m)).astype(np.float64)
    return rng.random((n, m))


def test_the_port_builds_and_loads_its_library():
    lib = native.load_native()
    assert lib is not None and os.path.exists(native.library_path())
    assert native.library_path().startswith(os.path.join(REPO, "fire_tpu_torch", "_build"))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_lap_equal_to_jax_with_its_library(jax_with_library, ties):
    for seed in range(60):
        c = _costs(seed, ties)
        r, k = native.linear_sum_assignment(c)
        jr, jk = jnative.linear_sum_assignment(c)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(k, jk)
        sr, sk = scipy_lap(c)
        assert c[r, k].sum() == pytest.approx(c[sr, sk].sum(), abs=1e-9)  # optimal


def test_lap_against_jax_without_its_library(jax_without_library):
    differ = 0
    for seed in range(60):
        for ties in (False, True):
            c = _costs(seed, ties)
            r, k = native.linear_sum_assignment(c)
            jr, jk = jnative.linear_sum_assignment(c)  # SciPy's
            assert c[r, k].sum() == pytest.approx(c[jr, jk].sum(), abs=1e-9)
            same = np.array_equal(r, jr) and np.array_equal(k, jk)
            assert same or ties
            differ += not same
    assert differ > 0  # ties do split the two: the port returns the native solver's answer


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_hungarian_assign_equal_to_jax(jax_with_library, ties):
    rng = np.random.default_rng(7)
    for seed in range(40):
        cost = _costs(seed, ties).astype(np.float32)
        det_mask = rng.random(cost.shape[0]) < 0.8
        trk_mask = rng.random(cost.shape[1]) < 0.8
        got = TAssign.hungarian_assign(cost, det_mask, trk_mask, gate=1.2)
        np.testing.assert_array_equal(got, JAssign.hungarian_assign(cost, det_mask, trk_mask, 1.2))


def _boxes(seed: int, n: int):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    boxes[n // 2 :] = boxes[: n - n // 2]  # duplicates: IoU exactly 1
    scores = rng.random(n).astype(np.float32)
    scores[1::4] = scores[0]  # score ties
    return boxes, scores


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("suppress_equal", [False, True])
def test_host_nms_equal_to_jax_and_numpy(jax_with_library, plus_one, suppress_equal):
    for seed, n, thr in [(0, 1, 0.5), (1, 12, 0.3), (2, 40, 0.5), (3, 40, 1.0), (4, 7, 0.0)]:
        boxes, scores = _boxes(seed, n)
        got = native.host_nms(boxes, scores, thr, plus_one, suppress_equal)
        np.testing.assert_array_equal(
            got, jnative.host_nms(boxes, scores, thr, plus_one, suppress_equal))
        np.testing.assert_array_equal(
            got, native.host_nms_numpy(boxes, scores, thr, plus_one, suppress_equal))
        assert got.dtype == np.int64
    empty = np.zeros((0, 4), np.float32)
    assert native.host_nms(empty, np.zeros(0, np.float32), 0.5).shape == (0,)


def test_without_a_compiler_scipy_and_numpy_stand_in(monkeypatch, jax_without_library):
    """``load_native`` returns ``None`` (one warning) where the library
    cannot be built, and both functions answer as JAX's do then."""
    from fire_tpu_torch.runtime import build

    native.load_native.cache_clear()
    monkeypatch.setattr(build, "cxx", lambda: (_ for _ in ()).throw(RuntimeError("no c++")))
    monkeypatch.setattr(build, "library_path", lambda *a, **k: "/nonexistent/lib.so")
    try:
        assert native.load_native() is None
        c = _costs(3, True)
        r, k = native.linear_sum_assignment(c)
        jr, jk = jnative.linear_sum_assignment(c)
        np.testing.assert_array_equal(r, jr), np.testing.assert_array_equal(k, jk)
        boxes, scores = _boxes(5, 20)
        np.testing.assert_array_equal(native.host_nms(boxes, scores, 0.4),
                                      jnative.host_nms(boxes, scores, 0.4))
    finally:
        native.load_native.cache_clear()
