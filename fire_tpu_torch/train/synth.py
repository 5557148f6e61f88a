"""Parametric synthetic identities (numpy-only copy of
``fire_tpu.train.synth._identity_params``): each identity is a fixed
draw of geometry and appearance parameters, drawn from the generator in
the same order so a seed gives the JAX package's identities."""

from __future__ import annotations

import numpy as np


def _identity_params(rng: np.random.Generator) -> dict:
    return {
        "skin": rng.uniform(90, 220, 3),
        "hair": rng.uniform(10, 120, 3),
        "face_w": rng.uniform(0.30, 0.42),
        "face_h": rng.uniform(0.40, 0.52),
        "eye_dx": rng.uniform(0.10, 0.17),
        "eye_y": rng.uniform(-0.12, -0.04),
        "eye_r": rng.uniform(0.025, 0.05),
        "iris": rng.uniform(20, 160, 3),
        "brow_t": rng.uniform(0.01, 0.035),
        "brow_tilt": rng.uniform(-0.03, 0.03),
        "nose_w": rng.uniform(0.015, 0.045),
        "nose_l": rng.uniform(0.08, 0.16),
        "mouth_w": rng.uniform(0.08, 0.16),
        "mouth_y": rng.uniform(0.14, 0.24),
        "mouth_t": rng.uniform(0.012, 0.035),
        "lip": rng.uniform(60, 180, 3) * np.array([1.4, 0.7, 0.7]),
        "hair_top": rng.uniform(0.05, 0.22),
        "tex_seed": int(rng.integers(0, 2**31)),
        "tex_amp": rng.uniform(3, 14),
    }
