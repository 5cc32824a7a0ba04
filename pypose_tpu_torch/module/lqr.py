r"""Discrete-time (iterative) LQR.

Counterpart of ``pypose_tpu/module/lqr.py:22-266``.  The JAX package's
two ``lax.scan`` programs, the reverse Riccati recursion and the forward
rollout, are eager loops over the horizon here; they read nothing back to
the host.  The linearization (``torch.func.jacrev`` of
``state_transition``, without touching the system's state) depends on
the nominal alone, so it runs for all steps at once, under
``torch.func.vmap``, before the recursion.
"""

import torch

from ..nn import Module
from ..function.linalg import bmv, bvmv
from ..optim.solver import cholesky_or_nan
from .dynamics import LTI

# robust mode's state saturation bound (pypose_tpu/module/lqr.py:216)
_XCAP = 1e6
# robust mode's cap on the cost-to-go (pypose_tpu/module/lqr.py:197-207)
_VCAP = 1e12


def _saturate(x, cap):
    return torch.clamp(torch.nan_to_num(x, nan=cap, posinf=cap, neginf=-cap),
                       -cap, cap)


def _sq(J):
    """A jacrev of a batched system has shape (*, n, *, n): squeeze dim -2
    where it is 1, as the JAX package does (only a batch of one).  Ref:
    pypose_tpu/module/lqr.py:255-260."""
    if J.ndim >= 4 and J.shape[-2] == 1:
        return J.squeeze(-2)
    return J


class LQR(Module):
    r"""Finite-horizon LQR: minimizes the quadratic stage cost
    :math:`\frac12 [x;u]^\top Q [x;u] + p^\top [x;u]` over horizon ``T``
    subject to the system's dynamics (LTI/LTV directly; other systems are
    linearized about the nominal trajectory at each step).
    ``u_lower``/``u_upper``/``du`` are accepted and unused, as in the JAX
    package.

    Ref: pypose_tpu/module/lqr.py:22-266.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.module import LTI, LQR
        >>> ns, nc, T = 2, 1, 4
        >>> sys = LTI(torch.eye(ns), torch.ones(ns, nc), torch.eye(ns),
        ...           torch.zeros(ns, nc))
        >>> Q = torch.eye(ns + nc)[None]
        >>> p = torch.zeros(ns + nc)[None]
        >>> x, u, cost = LQR(sys, Q, p, T)(torch.ones(ns)[None])
        >>> tuple(x.shape), tuple(u.shape)
        ((1, 5, 2), (1, 4, 1))
    """

    def __init__(self, system, Q, p, T):
        super().__init__()
        self.system = system
        self.Q, self.p, self.T = torch.as_tensor(Q), torch.as_tensor(p), T
        self.x_traj = None
        self.u_traj = None
        if self.Q.ndim == 3:
            self.Q = self.Q[..., None, :, :].repeat(1, self.T, 1, 1)
        if self.p.ndim == 2:
            self.p = self.p[..., None, :].repeat(1, self.T, 1)
        self.n_batch = tuple(self.p.shape[:-2])
        assert self.Q.shape[:-1] == self.p.shape, 'Shape not compatible.'
        assert self.Q.shape[-1] == self.Q.shape[-2], 'Shape not compatible.'
        assert self.Q.ndim == 4 or self.p.ndim == 3, 'Shape not compatible.'
        self.dtype = self.p.dtype

    def forward(self, x_init, dt=None, u_traj=None, u_lower=None,
                u_upper=None, du=None, x_traj=None, mu=0.0, robust=False):
        K, k = self.lqr_backward(x_init, dt, u_traj, u_lower, u_upper, du,
                                 mu=mu, robust=robust, x_traj=x_traj)
        return self.lqr_forward(x_init, K, k, u_lower, u_upper, du,
                                robust=robust)

    def _time(self, t, dt=None):
        return t if dt is None else t * dt

    def _linearize(self, x, u, t):
        """(A, B) at (x, u, t): an LTI/LTV system's matrices read at time t
        (its time restored after), else ``jacrev`` of
        ``state_transition``.  Ref: pypose_tpu/module/lqr.py:89-111."""
        sys = self.system
        if isinstance(sys, LTI):
            saved = sys._t
            sys.systime = t
            A, B = _sq(sys.A), _sq(sys.B)
            sys._t = saved
            return A, B
        A = _sq(torch.func.jacrev(
            lambda a: sys.state_transition(a, u, t))(x))
        B = _sq(torch.func.jacrev(
            lambda b: sys.state_transition(x, b, t))(u))
        return A, B

    def _linearize_traj(self, xs, us, dt):
        """(A, B) at every step of the nominal (``xs``, ``us`` of shape (*B,
        T, .)), stacked on a leading time axis: an LTI/LTV system's
        matrices step by step, else one ``torch.func.vmap`` over the steps
        of :meth:`_linearize` (the time a 0-dim tensor, as in the JAX
        package's scan), the same Jacobians in one batched pass."""
        if isinstance(self.system, LTI):
            AB = [self._linearize(xs[..., t, :], us[..., t, :],
                                  self._time(t, dt)) for t in range(self.T)]
            return (torch.stack([a for a, _ in AB]),
                    torch.stack([b for _, b in AB]))
        ts = torch.arange(self.T, device=xs.device)
        ts = ts if dt is None else ts * dt
        return torch.func.vmap(self._linearize, in_dims=(-2, -2, 0))(
            xs, us, ts)

    def _step(self, x, u, t):
        """The state transition at time t, without advancing the system's
        time."""
        sys = self.system
        if isinstance(sys, LTI):
            saved = sys._t
            sys.systime = t
            out = sys.state_transition(x, u, t)
            sys._t = saved
            return out
        return sys.state_transition(x, u, t)

    def lqr_backward(self, x_init, dt, u_traj=None, u_lower=None,
                     u_upper=None, du=None, mu=0.0, robust=False,
                     x_traj=None):
        """The reverse Riccati recursion from (V, v) = 0, linearized at
        every step of the nominal trajectory (all at once,
        :meth:`_linearize_traj`): ``x_traj`` if given, else
        the roll-out of ``u_traj`` (zeros if None) from ``x_init``.
        ``mu`` adds ``mu I`` to Quu before its Cholesky factor (a factor
        that fails gives NaN); ``robust`` saturates the nominal states and
        the cost-to-go.  Returns (K, k).  Ref:
        pypose_tpu/module/lqr.py:124-213."""
        ns, nsc = x_init.shape[-1], self.p.shape[-1]
        nc = nsc - ns
        dev = x_init.device
        if u_traj is None:
            self.u_traj = torch.zeros(self.n_batch + (self.T, nc),
                                      dtype=self.dtype, device=dev)
        else:
            self.u_traj = torch.as_tensor(u_traj)
        if x_traj is None:
            xt = x_init.expand(self.n_batch + (ns,))
            xs = []
            for t in range(self.T):
                xs.append(xt)
                xt = self._step(xt, self.u_traj[..., t, :],
                                self._time(t, dt))
                if robust:
                    xt = _saturate(xt, _XCAP)
            self.x_traj = torch.stack(xs, dim=-2)
        else:
            self.x_traj = torch.as_tensor(x_traj)

        xut = torch.cat([self.x_traj, self.u_traj], dim=-1)
        p = bmv(self.Q, xut) + self.p
        V = torch.zeros(self.n_batch + (ns, ns), dtype=self.dtype,
                        device=dev)
        v = torch.zeros(self.n_batch + (ns,), dtype=self.dtype, device=dev)
        eye = torch.eye(nc, dtype=self.dtype, device=dev)
        As, Bs = self._linearize_traj(self.x_traj, self.u_traj, dt)
        Ks, ks = [None] * self.T, [None] * self.T
        for t in range(self.T - 1, -1, -1):
            F = torch.cat([As[t], Bs[t]], dim=-1)
            Ft = F.mT
            Qt = self.Q[..., t, :, :] + Ft @ V @ F
            qt = p[..., t, :] + bmv(Ft, v)
            Qxx, Qxu = Qt[..., :ns, :ns], Qt[..., :ns, ns:]
            Qux, Quu = Qt[..., ns:, :ns], Qt[..., ns:, ns:]
            qx, qu = qt[..., :ns], qt[..., ns:]
            Quu = Quu + mu * eye
            # NaN where Quu is not positive definite: MPC's line search
            # tests finiteness
            L = cholesky_or_nan(Quu)
            Kt = -torch.cholesky_solve(Qux, L)
            kt = -torch.cholesky_solve(qu[..., None], L)[..., 0]
            KtT = Kt.mT
            V = Qxx + Qxu @ Kt + KtT @ Qux + KtT @ Quu @ Kt
            v = qx + bmv(Qxu, kt) + bmv(KtT, qu) + bmv(KtT @ Quu, kt)
            V = 0.5 * (V + V.mT)
            if robust:
                V, v = _saturate(V, _VCAP), _saturate(v, _VCAP)
            Ks[t], ks[t] = Kt, kt
        return torch.stack(Ks, dim=-3), torch.stack(ks, dim=-2)

    def lqr_forward(self, x_init, K, k, u_lower=None, u_upper=None, du=None,
                    eps=1.0, robust=False):
        """The rollout ``u = u_ref + eps k + K (x - x_ref)`` about the last
        backward pass's nominal, accumulating the quadratic cost;
        ``robust`` saturates diverging states.  Returns (x (T+1 states), u,
        cost).  Ref: pypose_tpu/module/lqr.py:215-252."""
        assert x_init.ndim == 2, 'Shape not compatible.'
        xt = x_init
        cost = torch.zeros(self.n_batch, dtype=self.dtype,
                           device=x_init.device)
        xs, us = [x_init], []
        for t in range(self.T):
            ut = bmv(K[..., t, :, :], xt - self.x_traj[..., t, :]) \
                + eps * k[..., t, :] + self.u_traj[..., t, :]
            xut = torch.cat([xt, ut], dim=-1)
            xt = self._step(xt, ut, t)
            if robust:
                xt = _saturate(xt, _XCAP)
            cost = cost + 0.5 * bvmv(xut, self.Q[..., t, :, :], xut) \
                + torch.sum(xut * self.p[..., t, :], dim=-1)
            xs.append(xt)
            us.append(ut)
        return torch.stack(xs, dim=-2), torch.stack(us, dim=-2), cost
