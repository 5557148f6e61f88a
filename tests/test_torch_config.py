"""fire_tpu_torch.config equals fire_tpu.config field for field."""

import dataclasses

import pytest
import torch

import fire_tpu.config as jc
import fire_tpu_torch.config as tc

CLASSES = ["TrackerConfig", "GalleryConfig", "EngineConfig", "RecognizerConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_equal(name):
    j, t = getattr(jc, name)(), getattr(tc, name)()
    jf = [f.name for f in dataclasses.fields(j)]
    assert jf == [f.name for f in dataclasses.fields(t)]
    for f in jf:
        jv, tv = getattr(j, f), getattr(t, f)
        if dataclasses.is_dataclass(jv):
            assert dataclasses.asdict(jv) == dataclasses.asdict(tv), f
        else:
            assert jv == tv, f


def test_derived_properties_equal():
    for cap in (1000, 100_000):
        j, t = jc.GalleryConfig(capacity=cap), tc.GalleryConfig(capacity=cap)
        assert (j.padded_capacity, j.padded_recent) == (t.padded_capacity, t.padded_recent)
    r = dict(encoder_model_type="512")
    assert jc.RecognizerConfig(**r).embedding_dim == tc.RecognizerConfig(**r).embedding_dim == 512
    assert (jc.RecognizerConfig(**r).with_embedding_dim().gallery.embedding_dim
            == tc.RecognizerConfig(**r).with_embedding_dim().gallery.embedding_dim)
    assert jc.ALIGN_TEMPLATE_160 == tc.ALIGN_TEMPLATE_160
    e = tc.EngineConfig()
    assert e.cdtype == torch.bfloat16 and e.pdtype == torch.float32
    assert isinstance(e.compute_dtype, str)


def test_entry_points_refuse_missing_cuda():
    from fire_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
