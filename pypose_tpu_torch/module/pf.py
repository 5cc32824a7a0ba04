r"""Particle filter.  Counterpart of ``pypose_tpu/module/pf.py``."""

import torch

from .ekf import EKF
from ..function.linalg import bvv
from ..optim.solver import cholesky_or_nan


class PF(EKF):
    r"""Batched particle filter: ``particles`` states drawn from
    N(x, n P), propagated through the full model, weighted by their
    Gaussian observation likelihood and resampled by the inverse CDF (a
    ``searchsorted`` batched over leading dims), all fixed-shape tensor
    operations.  Its draws come from ``generator`` (a
    ``torch.Generator`` on the estimate's device; the global one if
    None) through :meth:`draw`.

    Ref: pypose_tpu/module/pf.py:11-93.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.module import NLS, PF
        >>> class Sys(NLS):
        ...     def state_transition(self, state, input, t=None):
        ...         return state.cos() + input
        ...     def observation(self, state, input, t=None):
        ...         return state.sin() + input
        >>> pf = PF(Sys(), Q=torch.eye(2) * 0.01, R=torch.eye(2) * 0.01,
        ...         particles=200)
        >>> x1, P1 = pf(torch.zeros(2), torch.tensor([0.1, -0.1]),
        ...             torch.zeros(2), torch.eye(2),
        ...             generator=torch.Generator().manual_seed(0))
        >>> tuple(x1.shape), tuple(P1.shape)
        ((2,), (2, 2))
    """

    def __init__(self, model, Q=None, R=None, particles=1000):
        super().__init__(model, Q, R)
        self.particles = particles

    def forward(self, x, y, u, P, Q=None, R=None, t=None, generator=None):
        Q = Q if Q is not None else self.Q
        R = R if R is not None else self.R
        self.model.set_refpoint(state=x, input=u, t=t)
        n = x.shape[-1]
        xp = self.generate_particles(x, n * P, generator)
        # particles on axis -2; the input gets a matching singleton axis
        up = u[..., None, :]
        xs = self.model.state_transition(xp, up, t)
        ye = self.model.observation(xs, up, t)
        q = self.relative_likelihood(y, ye, R)
        xr = self.resample_particles(q, xs, generator)
        x = xr.mean(dim=-2)
        ex = xr - x[..., None, :]
        P = self.compute_cov(ex, ex, Q)
        return x, P

    def draw(self, kind, shape, like, generator):
        """Standard normal (``kind`` 'normal') or uniform [0, 1) ('uniform')
        draws of ``shape`` with ``like``'s dtype and device."""
        make = torch.randn if kind == 'normal' else torch.rand
        return make(shape, generator=generator, dtype=like.dtype,
                    device=like.device)

    def generate_particles(self, x, P, generator=None):
        """Particles ~ N(x, P): x + L z with L = cholesky(P), z standard
        normal of shape (particles, *batch, n); for a batched x the
        particle axis is then swapped with the last batch axis, as the
        JAX package swaps them.  Ref: pypose_tpu/module/pf.py:53-60
        (``jax.random.multivariate_normal``'s Cholesky method)."""
        z = self.draw('normal', (self.particles,) + tuple(x.shape), x,
                      generator)
        out = x + torch.einsum('...ij,...j->...i', cholesky_or_nan(P), z)
        return out.transpose(0, -2) if x.ndim > 1 else out

    def relative_likelihood(self, y, ye, R):
        """Softmax of the Gaussian log-likelihoods.  Ref:
        pypose_tpu/module/pf.py:67-72."""
        d = y[..., None, :] - ye
        Rinv = torch.linalg.inv_ex(R)[0]
        logp = -0.5 * torch.einsum('...i,...ij,...j->...', d, Rinv, d)
        return torch.softmax(logp, dim=-1)

    def resample_particles(self, q, x, generator=None):
        """Inverse-CDF resampling, one uniform draw a particle, batched
        over leading dims.  Ref: pypose_tpu/module/pf.py:74-89."""
        r = self.draw('uniform', tuple(q.shape), x, generator)
        cumsumq = torch.cumsum(q, dim=-1)
        idx = torch.searchsorted(cumsumq.contiguous(), r.contiguous())
        idx = idx.clamp(0, self.particles - 1)
        return torch.take_along_dim(x, idx[..., None], dim=-2)

    def compute_cov(self, a, b, Q=0):
        """Covariance of the particles.  Ref: pypose_tpu/module/pf.py:
        91-93."""
        return Q + bvv(a, b).mean(dim=-3)
