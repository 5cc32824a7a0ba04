r"""Extended Kalman filter.  Counterpart of ``pypose_tpu/module/ekf.py``."""

import torch

from ..nn import Module
from ..function.linalg import bmv


def pinv(a):
    """The pseudo-inverse as ``jnp.linalg.pinv`` computes it: singular
    values at most 10 max(m, n) eps of the largest are cut."""
    return torch.linalg.pinv(
        a, rtol=10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps)


class EKF(Module):
    r"""Batched extended Kalman filter: linearize the model at the current
    estimate (``NLS``'s ``jacrev`` Jacobians), then predict, gain and
    update in Joseph form:

    .. math:: P^- = A P A^\top + Q,\quad
              K = P^- C^\top (C P^- C^\top + R)^{+},\quad
              P^+ = (I - KC)\,P^-(I - KC)^\top + K R K^\top

    One ``forward`` is one step; :func:`~pypose_tpu_torch.module.
    filter_rollout` runs a trajectory.  The model is called on the batched
    estimate, as in the JAX package.

    Ref: pypose_tpu/module/ekf.py:9-86.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.module import NLS, EKF
        >>> class Sys(NLS):
        ...     def state_transition(self, state, input, t=None):
        ...         return state.cos() + input
        ...     def observation(self, state, input, t=None):
        ...         return state.sin() + input
        >>> ekf = EKF(Sys(), Q=torch.eye(2) * 0.01, R=torch.eye(2) * 0.01)
        >>> x, P = torch.zeros(2), torch.eye(2) * 100.0
        >>> x1, P1 = ekf(x, torch.tensor([0.1, -0.1]), torch.zeros(2), P)
        >>> bool(torch.trace(P1) < torch.trace(P))
        True
    """

    def __init__(self, model, Q=None, R=None):
        super().__init__()
        self.set_uncertainty(Q=Q, R=R)
        self.model = model

    def forward(self, x, y, u, P, Q=None, R=None, t=None):
        self.model.set_refpoint(state=x, input=u, t=t)
        I = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
        A = self.model.A
        C = self.model.C
        Q = Q if Q is not None else self.Q
        R = R if R is not None else self.R
        xm = self.model.state_transition(x, u, t=t)
        P = A @ P @ A.mT + Q
        K = P @ C.mT @ pinv(C @ P @ C.mT + R)
        e = y - self.model.observation(x, u, t=t)
        xp = xm + bmv(K, e)
        IKC = I - K @ C
        P = IKC @ P @ IKC.mT + K @ R @ K.mT
        return xp, P

    @property
    def Q(self):
        if getattr(self, '_Q', None) is None:
            raise NotImplementedError(
                'Call set_uncertainty() to define transition covariance Q.')
        return self._Q

    @property
    def R(self):
        if getattr(self, '_R', None) is None:
            raise NotImplementedError(
                'Call set_uncertainty() to define observation covariance R.')
        return self._R

    def set_uncertainty(self, Q=None, R=None):
        if Q is not None:
            self.register_buffer('_Q', Q)
        if R is not None:
            self.register_buffer('_R', R)
