"""The port exports what the JAX package exports: every name of
``fire_tpu/{ops,models,track,gallery,pipeline,train}/__init__.py``
imports from the port's sub-package of the same name, and the helpers
that were missing match their JAX counterparts (``facenet_128`` /
``facenet_512``, ``ops.image.normalize_01``, ``track.ukf.kf_update``)."""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("ops", "models", "track", "gallery", "pipeline", "train")


def _jax_exports(sub):
    """The names ``fire_tpu/<sub>/__init__.py`` imports, read from its
    source (importing it would not list them)."""
    with open(os.path.join(REPO, "fire_tpu", sub, "__init__.py")) as f:
        tree = ast.parse(f.read())
    return sorted(a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
                  for a in node.names)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_imports_from_the_port(sub):
    names = _jax_exports(sub)
    assert names
    port = importlib.import_module(f"fire_tpu_torch.{sub}")
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"fire_tpu_torch.{sub} lacks {missing}"


def test_facenet_128_and_512_have_jax_variables():
    from fire_tpu.models import facenet as jax_facenet
    from fire_tpu_torch.models import facenet_128, facenet_512
    from fire_tpu_torch.weights import flatten, flax_shapes

    for ours, theirs in ((facenet_128(), jax_facenet.facenet_128()),
                         (facenet_512(), jax_facenet.facenet_512())):
        shapes = jax.eval_shape(theirs.init, jax.random.PRNGKey(0), jnp.zeros((1, 160, 160, 3)))
        want = {k: tuple(v.shape) for k, v in flatten(dict(shapes)).items()}
        got = {k: v.shape for k, v in flatten(flax_shapes(ours)).items()}
        assert got == want
        assert ours.embed_dim == theirs.embed_dim


def test_normalize_01_matches_jax():
    from fire_tpu.ops.image import normalize_01 as jax_normalize_01
    from fire_tpu_torch.ops import normalize_01, rgb_to_bgr

    x = np.random.default_rng(0).integers(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ours = normalize_01(torch.tensor(x), tdt)
        theirs = np.asarray(jax_normalize_01(jnp.asarray(x), jdt).astype(jnp.float32))
        assert ours.dtype == tdt
        np.testing.assert_array_equal(ours.float().numpy(), theirs)
    np.testing.assert_array_equal(rgb_to_bgr(torch.tensor(x)).numpy(), x[..., ::-1])


def test_kf_update_matches_jax_and_the_tracker_specialisation():
    from fire_tpu.track.ukf import kf_update as jax_kf_update
    from fire_tpu_torch.track import kf_update
    from fire_tpu_torch.track.ukf import kf_update_tracker, tracker_h_matrix

    rng = np.random.default_rng(1)
    t = 5
    x = rng.standard_normal((t, 10)).astype(np.float32)
    a = rng.standard_normal((t, 10, 10)).astype(np.float32)
    p = (a @ a.transpose(0, 2, 1) + 10 * np.eye(10)).astype(np.float32)
    z = rng.standard_normal((t, 4)).astype(np.float32)
    h = rng.standard_normal((4, 10)).astype(np.float32)
    r = (np.eye(4) * 0.5).astype(np.float32)
    xn, pn = kf_update(*map(torch.tensor, (x, p, z, h, r)))
    jx, jp = jax.vmap(jax_kf_update, in_axes=(0, 0, 0, None, None))(
        *map(jnp.asarray, (x, p, z, h, r)))
    np.testing.assert_allclose(xn.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pn.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-3)
    # one vector, unbatched, as JAX's takes it
    x1, p1 = kf_update(*map(torch.tensor, (x[0], p[0], z[0], h, r)))
    np.testing.assert_allclose(x1.numpy(), xn[0].numpy(), rtol=1e-5, atol=1e-5)
    # the selector H = [I₄ 0] gives the tracker's closed form
    hs = tracker_h_matrix()
    xs, ps = kf_update(torch.tensor(x), torch.tensor(p), torch.tensor(z), hs, 0.5 * torch.eye(4))
    xt, pt = kf_update_tracker(torch.tensor(x), torch.tensor(p), torch.tensor(z), 0.5)
    torch.testing.assert_close(xs, xt, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ps, pt, rtol=1e-4, atol=1e-3)
