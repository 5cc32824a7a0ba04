r"""Model predictive control by iterative LQR.

Counterpart of ``pypose_tpu/module/mpc.py:22-328``.  The JAX package's
no-gradient iLQR loops are ``lax.while_loop``s; here they are host loops
under ``torch.no_grad`` whose state stays on the device and whose stop
test is one host read an iteration (:data:`HOST_READS` counts them).  The
line search's rollouts at the ``ls_steps`` feed-forward scales run as one
``torch.func.vmap``.  Gradients flow through the final LQR pass alone.
"""

import torch

from ..nn import Module
from ..function.linalg import bmv, bvmv
from ..utils.stepper import ReduceToBason
from .lqr import LQR, _VCAP, _XCAP, _saturate

# Host reads made by MPC's iteration loops in this process (one an
# iteration: the stop test).
HOST_READS = 0


def _finite_or_inf(c):
    return torch.where(torch.isfinite(c), c, torch.inf)


def _take(a, i):
    """``a[i]`` for a 0-dim index tensor ``i``, without reading it back to
    the host."""
    return a.index_select(0, i.reshape(1)).squeeze(0)


class MPC(Module):
    r"""Model predictive control by iLQR: re-linearize the system about the
    current trajectory and solve an LQR subproblem until the
    :class:`~pypose_tpu_torch.utils.ReduceToBason` stepper stops, then run
    one final differentiable LQR pass.  ``line_search=True`` is the robust
    iLQR (Levenberg-regularized Quu, a backtracking line search on the
    feed-forward term, the nominal carried from the accepted rollout, and
    a stabilizing initial policy), which lifts the horizon cap on
    unstable plants.

    Ref: pypose_tpu/module/mpc.py:22-328.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.module import LTI, MPC
        >>> ns, nc, T = 2, 1, 4
        >>> sys = LTI(torch.eye(ns), torch.ones(ns, nc), torch.eye(ns),
        ...           torch.zeros(ns, nc))
        >>> Q = torch.eye(ns + nc)[None]
        >>> p = torch.zeros(ns + nc)[None]
        >>> x, u, cost = MPC(sys, Q, p, T)(None, torch.ones(ns)[None])
        >>> tuple(u.shape)
        (1, 4, 1)
    """

    def __init__(self, system, Q, p, T, stepper=None, line_search=False,
                 reg_init=1e-6, reg_factor=10.0, reg_min=1e-8, reg_max=1e8,
                 ls_steps=8, ls_decay=0.5):
        super().__init__()
        self.stepper = ReduceToBason(steps=10) if stepper is None else stepper
        self.stepper.max_steps -= 1
        self.lqr = LQR(system, Q, p, T)
        self.line_search = bool(line_search)
        self.reg_init = float(reg_init)
        self.reg_factor = float(reg_factor)
        self.reg_min = float(reg_min)
        self.reg_max = float(reg_max)
        self.ls_steps = int(ls_steps)
        self.ls_decay = float(ls_decay)

    def forward(self, dt, x_init, u_init=None, u_lower=None, u_upper=None,
                du=None):
        ns = x_init.shape[-1]
        nc = self.lqr.p.shape[-1] - ns
        if u_init is None:
            u_init = torch.zeros(self.lqr.n_batch + (self.lqr.T, nc),
                                 dtype=x_init.dtype, device=x_init.device)
        else:
            u_init = torch.as_tensor(u_init)
        if self.stepper.verbose:
            return self._forward_host(dt, x_init, u_init)
        self.lqr.system.reset()
        with torch.no_grad():
            x0 = x_init.detach()
            if self.line_search:
                u_best, x_nom = self._iloop_ls(x0, dt, u_init)
            else:
                u_best = self._iloop(x0, dt, u_init)
        self.lqr.system.reset()
        if self.line_search:
            # linearize about the loop's carried nominal and roll with the
            # feedback term on: the trajectory the loop accepted
            out = self.lqr(x_init, dt, u_traj=u_best, x_traj=x_nom,
                           mu=self.reg_min, robust=True)
        else:
            out = self.lqr(x_init, dt, u_traj=u_best)
        self.lqr.system.reset()
        return out

    def _stop(self, stop):
        global HOST_READS
        HOST_READS += 1
        return bool(stop)

    def _iloop(self, x_init, dt, u_init):
        """Vanilla iLQR iterations: the best input trajectory under the
        stepper's rules.  One host read an iteration.  Ref:
        pypose_tpu/module/mpc.py:124-150."""
        st = self.stepper
        inf = torch.full(self.lqr.n_batch, torch.inf, dtype=x_init.dtype,
                         device=x_init.device)
        u, best_u, best_c, last = u_init, u_init, inf, inf
        steps = pat = 0
        while True:
            _, u_new, cost = self.lqr(x_init, dt, u_traj=u)
            better = torch.all(cost < best_c)
            best_u = torch.where(better, u_new, best_u)
            best_c = torch.where(better, cost, best_c)
            steps += 1
            plateau = torch.all((last - cost) / cost < st.decreasing)
            pat = torch.where(plateau, pat + 1, 0)
            stop = torch.all(cost < st.tol) | (pat >= st.patience)
            u, last = u_new, cost
            if steps >= st.max_steps or self._stop(stop):
                return best_u

    def _stabilizing_init(self, x_init, dt, u_init):
        """The closed-loop seed of the robust iLQR: the finite-horizon LQR
        policy of the affine linearization at (x_init, 0), rolled out on
        the true dynamics, against ``u_init`` open loop; returns (u, its
        pre-step nominal states, its cost) of the one with the lower total
        cost.  Ref: pypose_tpu/module/mpc.py:152-240."""
        lqr = self.lqr
        ns = x_init.shape[-1]
        nc = lqr.p.shape[-1] - ns
        dev, dtype = x_init.device, x_init.dtype
        u0 = torch.zeros(x_init.shape[:-1] + (nc,), dtype=dtype, device=dev)
        t0 = 0 if dt is None else 0.0
        A, B = lqr._linearize(x_init, u0, t0)
        f0 = lqr._step(x_init, u0, t0)
        c1 = f0 - bmv(A, x_init)
        F = torch.cat([A, B], dim=-1)
        Ft = F.mT
        Qc = lqr.Q[..., 0, :, :]
        pc = lqr.p[..., 0, :]
        eye = torch.eye(nc, dtype=dtype, device=dev)
        V = torch.zeros(x_init.shape[:-1] + (ns, ns), dtype=dtype,
                        device=dev)
        v = torch.zeros_like(x_init)
        Ks, ks = [None] * lqr.T, [None] * lqr.T
        for t in range(lqr.T - 1, -1, -1):
            Qt = Qc + Ft @ V @ F
            qt = pc + bmv(Ft, bmv(V, c1) + v)
            Quu = Qt[..., ns:, ns:] + 1e-6 * eye
            Qux = Qt[..., ns:, :ns]
            Qxu = Qt[..., :ns, ns:]
            Qxx = Qt[..., :ns, :ns]
            qx, qu = qt[..., :ns], qt[..., ns:]
            Kt = -torch.linalg.solve_ex(Quu, Qux)[0]
            kt = -torch.linalg.solve_ex(Quu, qu[..., None])[0][..., 0]
            KtT = Kt.mT
            V = Qxx + Qxu @ Kt + KtT @ Qux + KtT @ Quu @ Kt
            v = qx + bmv(Qxu, kt) + bmv(KtT, qu) + bmv(KtT @ Quu, kt)
            V = 0.5 * (V + V.mT)
            V, v = _saturate(V, _VCAP), _saturate(v, _VCAP)
            Ks[t], ks[t] = Kt, kt

        def roll(policy):
            xt = x_init
            cost = torch.zeros(lqr.n_batch, dtype=dtype, device=dev)
            us, xs = [], []
            for t in range(lqr.T):
                ut = bmv(Ks[t], xt) + ks[t] if policy \
                    else u_init[..., t, :]
                xut = torch.cat([xt, ut], dim=-1)
                xn = _saturate(lqr._step(xt, ut, lqr._time(t, dt)), _XCAP)
                cost = cost + 0.5 * bvmv(xut, lqr.Q[..., t, :, :], xut) \
                    + torch.sum(xut * lqr.p[..., t, :], dim=-1)
                us.append(ut)
                xs.append(xt)
                xt = xn
            return torch.stack(us, dim=-2), torch.stack(xs, dim=-2), cost

        u_stab, x_stab, c_stab = roll(True)
        u_open, x_open, c_open = roll(False)
        win = torch.sum(_finite_or_inf(c_stab)) < \
            torch.sum(_finite_or_inf(c_open))
        return (torch.where(win, u_stab, u_open),
                torch.where(win, x_stab, x_open),
                torch.where(win, c_stab, c_open))

    def _iloop_ls(self, x_init, dt, u_init):
        """Robust iLQR: each iteration a backward pass with ``Quu + mu I``
        about the carried accepted trajectory, the rollout at ``ls_steps``
        feed-forward scales ``ls_decay^i`` at once, and the best finite
        candidate accepted iff it lowers the total cost; mu shrinks on
        acceptance and grows on rejection.  Stops on the stepper's rules
        or when mu reaches ``reg_max`` on a rejection.  One host read an
        iteration.  Returns (u, x_nom).  Ref:
        pypose_tpu/module/mpc.py:242-315."""
        st = self.stepper
        lqr = self.lqr
        u, x_nom, last = self._stabilizing_init(x_init, dt, u_init)
        epss = torch.tensor([self.ls_decay ** i
                             for i in range(self.ls_steps)],
                            dtype=x_init.dtype, device=x_init.device)
        mu = torch.full((), self.reg_init, dtype=x_init.dtype,
                        device=x_init.device)
        pat = torch.zeros((), dtype=torch.int64, device=x_init.device)
        try_eps = torch.func.vmap(lambda e: lqr.lqr_forward(
            x_init, K, k, eps=e, robust=True))
        steps = 0
        while True:
            K, k = lqr.lqr_backward(x_init, dt, u_traj=u, mu=mu, robust=True,
                                    x_traj=x_nom)
            finite_b = torch.all(torch.isfinite(K)) & \
                torch.all(torch.isfinite(k))
            K, k = torch.nan_to_num(K), torch.nan_to_num(k)
            xs, us, costs = try_eps(epss)
            tot = _finite_or_inf(costs.reshape(self.ls_steps, -1).sum(-1))
            i = torch.argmin(tot)
            u_new = _take(us, i)
            x_new = _take(xs, i)[..., :-1, :]
            cost = _take(costs, i)
            best = _take(tot, i)
            accept = finite_b & torch.isfinite(best) & \
                (best < torch.sum(_finite_or_inf(last)))
            u = torch.where(accept, u_new, u)
            x_nom = torch.where(accept, x_new, x_nom)
            cost_eff = torch.where(accept, cost, last)
            mu = torch.where(accept,
                             torch.clamp(mu / self.reg_factor,
                                         min=self.reg_min),
                             torch.clamp(mu * self.reg_factor,
                                         max=self.reg_max))
            steps += 1
            plateau = accept & torch.all(
                (last - cost_eff) / torch.abs(cost_eff) < st.decreasing)
            pat = torch.where(plateau, pat + 1, 0)
            stop = torch.all(cost_eff < st.tol) | (pat >= st.patience) | \
                (~accept & (mu >= self.reg_max))
            last = cost_eff
            if steps >= st.max_steps or self._stop(stop):
                return u, x_nom

    def _forward_host(self, dt, x_init, u_init):
        """The printing loop of a verbose stepper (one host read an
        iteration), then the final pass from the best input trajectory.
        Ref: pypose_tpu/module/mpc.py:317-328."""
        best_u, best_c = u_init, None
        u = u_init
        self.stepper.reset()
        while self.stepper.continual():
            with torch.no_grad():
                _, u, cost = self.lqr(x_init.detach(), dt, u)
            self.stepper.step(cost)
            if best_c is None or bool((cost < best_c).all()):
                best_u, best_c = u, cost
        return self.lqr(x_init, dt, u_traj=best_u)
