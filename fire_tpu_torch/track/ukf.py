"""Kalman filters of the tracker (counterpart of ``fire_tpu.track.ukf``):
the general sigma-point :class:`MerweUKF`, and the linear KF that is its
exact specialisation for the tracker's linear models (``kf_predict``,
``kf_update``, ``kf_update_tracker``, ``_inv4_spd`` and the F / H
matrices).

The process and measurement models are linear, so the UKF equals the
linear KF; the JAX package runs this specialisation on its hot path in
float32 and so does the port.  Functions are batched over a leading
track axis.  The tracker's own products (``kf_predict``,
``kf_update_tracker``, ``_inv4_spd``) go through :func:`ordered_matmul`:
a sum over the inner axis in ascending order, each product and each sum
rounded on its own, so that the float32 result is what the code says on
every device, where a BLAS library picks its own order (and the card's
order depends on the batch size); kernel K2 rounds the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MerweUKF:
    """Functional UKF with Merwe scaled sigma points: rows of the upper
    Cholesky factor of ``(n + λ) P`` as sigma directions, filterpy's
    Wm / Wc weights, and sigma points regenerated from the predicted
    state for the update.  ``fx`` / ``hx`` map one state vector; they are
    applied to each of the 2n+1 sigma points.  With ``alpha`` near 1e-3
    the centre weight is about 1e6: use float64 tensors there."""

    n: int
    fx: Callable[[torch.Tensor], torch.Tensor]
    hx: Callable[[torch.Tensor], torch.Tensor]
    alpha: float = 1e-3
    beta: float = 2.0
    kappa: float = 0.0

    @property
    def lambda_(self) -> float:
        return self.alpha ** 2 * (self.n + self.kappa) - self.n

    def weights(self, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        n, lam = self.n, self.lambda_
        wm = torch.full((2 * n + 1,), 0.5 / (n + lam), dtype=like.dtype, device=like.device)
        wc = wm.clone()
        wm[0] = lam / (n + lam)
        wc[0] = lam / (n + lam) + (1.0 - self.alpha ** 2 + self.beta)
        return wm, wc

    def sigma_points(self, x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """(2n+1, n) sigma points around ``x``."""
        u = torch.linalg.cholesky((self.lambda_ + self.n) * p, upper=True)
        return torch.cat([x[None, :], x[None, :] + u, x[None, :] - u], dim=0)

    def predict(self, x, p, q):
        """Returns ``(x', P', sigmas)`` with the sigma points rebuilt from
        the predicted ``(x', P')``, so the update sees the process noise."""
        wm, wc = self.weights(x)
        sig_f = torch.stack([self.fx(s) for s in self.sigma_points(x, p)])
        xp = wm @ sig_f
        d = sig_f - xp[None, :]
        pp = d.T @ (wc[:, None] * d) + q
        return xp, pp, self.sigma_points(xp, pp)

    def update(self, x, p, sigmas_f, z, r):
        wm, wc = self.weights(x)
        sig_h = torch.stack([self.hx(s) for s in sigmas_f])
        zp = wm @ sig_h
        dz = sig_h - zp[None, :]
        s = dz.T @ (wc[:, None] * dz) + r
        dx = sigmas_f - x[None, :]
        pxz = dx.T @ (wc[:, None] * dz)
        k = torch.linalg.solve(s.T, pxz.T).T  # K = Pxz S⁻¹
        xn = x + k @ (z - zp)
        pn = p - (k @ s) @ k.T
        return xn, pn


def ordered_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched, broadcast) as ``Σ_k a[..., :, k] b[..., k, :]``
    summed for k ascending, every product and sum a separate rounding."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k : k + 1] * b[..., k : k + 1, :]
    return out


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
    xp = ordered_matmul(x[..., None, :], f.T)[..., 0, :]
    pp = ordered_matmul(ordered_matmul(f, p), f.T) + q
    return xp, pp


def kf_update(x, p, z, h, r):
    """Linear KF update for a general measurement matrix ``h`` (4, 10):
    K = P Hᵀ S⁻¹ with S = H P Hᵀ + R, batched over a leading axis like
    :func:`kf_predict` (x (T, 10), p (T, 10, 10), z (T, 4))."""
    zp = x @ h.T
    s = h @ p @ h.T + r
    pxz = p @ h.T
    k = torch.linalg.solve(s.transpose(-1, -2), pxz.transpose(-1, -2)).transpose(-1, -2)
    xn = x + (k @ (z - zp)[..., None])[..., 0]
    pn = p - (k @ s) @ k.transpose(-1, -2)
    return xn, pn


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
    mm = ordered_matmul
    ai = _inv2(a)
    sc = d - mm(c, mm(ai, b))
    sci = _inv2(sc)
    aib = mm(ai, b)
    top_left = ai + mm(aib, mm(sci, mm(c, ai)))
    top_right = -mm(aib, sci)
    bot_left = -mm(sci, mm(c, ai))
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
    k = ordered_matmul(p[..., :, :4], si)
    xn = x + ordered_matmul(k, (z - x[..., :4])[..., None])[..., 0]
    pn = p - ordered_matmul(ordered_matmul(k, s), k.transpose(-1, -2))
    return xn, pn
