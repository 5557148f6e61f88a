"""``PrefetchReader.read`` of the port against JAX's
(``fire_tpu/pipeline/stream.py:107-109``) over the same
``FrameSequenceCapture`` frames: the frames in order, then None at the
end of the stream."""

import numpy as np
import pytest

from fire_tpu.pipeline import stream as JS
from fire_tpu_torch.pipeline import stream as TS


@pytest.mark.parametrize("depth", [1, 8])
def test_read_gives_the_frames_then_none_as_jax(depth):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (6, 8, 3), dtype=np.uint8) for _ in range(5)]
    readers = [JS.PrefetchReader(JS.FrameSequenceCapture(frames), depth=depth),
               TS.PrefetchReader(TS.FrameSequenceCapture(frames), depth=depth)]
    try:
        for want in frames:
            got_j, got_t = (r.read() for r in readers)
            np.testing.assert_array_equal(got_t, got_j)
            np.testing.assert_array_equal(got_t, want)
        assert [r.read() for r in readers] == [None, None]
    finally:
        for r in readers:
            r.close()
