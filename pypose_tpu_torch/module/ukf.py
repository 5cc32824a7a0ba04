r"""Unscented Kalman filter.  Counterpart of ``pypose_tpu/module/ukf.py``."""

import torch

from .ekf import EKF, pinv
from ..function.linalg import bmv
from ..optim.solver import cholesky_or_nan


class UKF(EKF):
    r"""Batched unscented Kalman filter: ``2n+1`` sigma points, the
    columns of ``msqrt((n + k) P)`` (default: the Cholesky factor) about
    the estimate, through the full model (no Jacobians), with spread
    ``k`` (default ``3 - n``).

    Ref: pypose_tpu/module/ukf.py:9-71.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.module import NLS, UKF
        >>> class Sys(NLS):
        ...     def state_transition(self, state, input, t=None):
        ...         return state.cos() + input
        ...     def observation(self, state, input, t=None):
        ...         return state.sin() + input
        >>> ukf = UKF(Sys(), Q=torch.eye(2) * 0.01, R=torch.eye(2) * 0.01)
        >>> x1, P1 = ukf(torch.zeros(2), torch.tensor([0.1, -0.1]),
        ...              torch.zeros(2), torch.eye(2))
        >>> tuple(x1.shape), tuple(P1.shape)
        ((2,), (2, 2))
    """

    def __init__(self, model, Q=None, R=None, msqrt=None):
        super().__init__(model, Q, R)
        self.msqrt = cholesky_or_nan if msqrt is None else msqrt

    def forward(self, x, y, u, P, Q=None, R=None, t=None, k=None):
        k = 3 - x.shape[-1] if k is None else k
        Q = Q if Q is not None else self.Q
        R = R if R is not None else self.R
        self.model.set_refpoint(state=x, input=u, t=t)
        xs, w = self.sigma_weight_points(x, P, k)
        xs = self.model.state_transition(xs, u, t)
        xe = (w * xs).sum(dim=-2)
        ex = xe[..., None, :] - xs
        P = self.compute_cov(ex, ex, w, Q)
        xs, w = self.sigma_weight_points(xe, P, k)
        ys = self.model.observation(xs, u, t)
        ye = (w * ys).sum(dim=-2)
        ey = ye[..., None, :] - ys
        Py = self.compute_cov(ey, ey, w, R)
        Pxy = self.compute_cov(ex, ey, w)
        K = Pxy @ pinv(Py)
        x = xe + bmv(K, y - ye)
        P = P - K @ Py @ K.mT
        return x, P

    def sigma_weight_points(self, x, P, k):
        """The 2n+1 sigma points and their weights.  Ref:
        pypose_tpu/module/ukf.py:57-66."""
        assert x.shape[-1] == P.shape[-1] == P.shape[-2], 'Invalid shape'
        n, xe = x.shape[-1], x[..., None, :]
        xr = self.msqrt((n + k) * P).mT
        we = torch.full(xe.shape[:-1], k / (n + k), dtype=x.dtype,
                        device=x.device)
        wr = torch.full(xr.shape[:-1], 1 / (2 * (n + k)), dtype=x.dtype,
                        device=x.device)
        p = torch.cat([xe, xe + xr, xe - xr], dim=-2)
        w = torch.cat([we, wr, wr], dim=-1)
        return p, w[..., None]

    def compute_cov(self, a, b, w, Q=0):
        """Weighted covariance.  Ref: pypose_tpu/module/ukf.py:68-71."""
        a, b = a[..., None], b[..., None]
        return Q + (w[..., None] * a @ b.mT).sum(dim=-3)
