"""Linear Kalman filter — the tracker's exact specialisation of the
10-dim Merwe UKF (counterpart of ``fire_tpu.track.ukf``'s
``kf_predict``, ``kf_update_tracker``, ``_inv4_spd`` and the F / H
matrices).

The process and measurement models are linear, so the UKF equals the
linear KF; the JAX package runs this specialisation on its hot path in
float32 and so does the port.  Functions are batched over a leading
track axis.  float32 matmuls stay full precision on the card (TF32 is
off for matmuls by default).
"""

from __future__ import annotations

import torch


def tracker_f_matrix(dt: float = 1.0, device=None) -> torch.Tensor:
    """Constant-acceleration transition over
    [cx, cy, log_s, log_r, vx, vy, v_log_s, ax, ay, a_log_s]."""
    f = torch.eye(10, dtype=torch.float32, device=device)
    h = 0.5 * dt * dt
    for i in range(3):
        f[i, 4 + i] = dt
        f[i, 7 + i] = h
        f[4 + i, 7 + i] = dt
    return f


def tracker_h_matrix(device=None) -> torch.Tensor:
    """Measurement extracts [cx, cy, log_s, log_r]."""
    return torch.eye(4, 10, dtype=torch.float32, device=device)


def kf_predict(x, p, f, q):
    """x (T, 10), p (T, 10, 10) → predicted (x, p)."""
    xp = x @ f.T
    pp = f @ p @ f.T + q
    return xp, pp


def _inv2(m):
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    adj = torch.stack([
        torch.stack([m[..., 1, 1], -m[..., 0, 1]], dim=-1),
        torch.stack([-m[..., 1, 0], m[..., 0, 0]], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _inv4_spd(s: torch.Tensor) -> torch.Tensor:
    """Closed-form 4×4 SPD inverse by 2×2 blocks (Schur complement)."""
    a, b = s[..., :2, :2], s[..., :2, 2:]
    c, d = s[..., 2:, :2], s[..., 2:, 2:]
    ai = _inv2(a)
    sc = d - c @ (ai @ b)
    sci = _inv2(sc)
    aib = ai @ b
    top_left = ai + aib @ (sci @ (c @ ai))
    top_right = -(aib @ sci)
    bot_left = -(sci @ (c @ ai))
    return torch.cat([
        torch.cat([top_left, top_right], dim=-1),
        torch.cat([bot_left, sci], dim=-1),
    ], dim=-2)


def kf_update_tracker(x, p, z, r_diag: float):
    """KF update for the H = [I₄ 0] selector: S = P[:4,:4] + r·I,
    K = P[:, :4] S⁻¹.  x (T,10), p (T,10,10), z (T,4)."""
    eye4 = torch.eye(4, dtype=p.dtype, device=p.device)
    s = p[..., :4, :4] + r_diag * eye4
    si = _inv4_spd(s)
    k = p[..., :, :4] @ si
    xn = x + (k @ (z - x[..., :4])[..., None])[..., 0]
    pn = p - (k @ s) @ k.transpose(-1, -2)
    return xn, pn
