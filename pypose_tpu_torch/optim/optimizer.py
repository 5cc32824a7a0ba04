r"""Second-order least-squares optimizers: Gauss-Newton and
Levenberg-Marquardt.

Counterpart of ``pypose_tpu/optim/optimizer.py``.  A step is residuals,
``torch.func.jacrev``, the corrector, the (weighted) normal equations, a
dense solve and a retraction: LieTensor parameters by ``p.add(d)`` (left
retraction for groups, addition for algebras), plain ones by addition.
Parameters are a ``name -> value`` dict (``Module.parameter_dict()``),
taken in sorted name order, as the JAX package's dict flattening gives
them.

The JAX package's data-dependent loops are ``lax.while_loop``s.  Here
they are loops of a fixed length whose finished state is carried through
unchanged by ``torch.where``, which is what a vmapped ``while_loop``
does: the LM reject loop runs ``reject + 1`` rounds, and ``optimize``
runs ``steps`` steps.  No loop reads the host, so the same core serves
``step()`` (one host read a step), ``optimize()`` (one an optimization)
and :func:`make_batch_optimizer`, a ``torch.func.vmap`` of the core over
independent problems (none).  Matrix products run in full float32: TF32
stays off (``optim.sparse.require_full_fp32``), as the JAX package pins
``precision=HIGHEST``.
"""

import math

import torch

from ..lietensor.lietensor import LieTensor
from ..nn import functional_call
from .corrector import FastTriggs, Trivial
from .functional import _leaves, _rebuild
from .solver import PINV, Cholesky
from .sparse import require_full_fp32
from .strategy import TrustRegion


def _as_tensor(x):
    return x.tensor() if isinstance(x, LieTensor) else x


def _where(cond, a, b):
    """``torch.where`` over a tensor, a LieTensor or a dict of them."""
    if isinstance(a, dict):
        return {k: _where(cond, a[k], b[k]) for k in a}
    if isinstance(a, LieTensor):
        return LieTensor(torch.where(cond, a.tensor(), b.tensor()),
                         ltype=a.ltype)
    return torch.where(cond, a, b)


class RobustModel:
    """Residuals of a model and their kernelized loss.  Ref:
    pypose_tpu/optim/optimizer.py:33."""

    def __init__(self, model, kernel=None):
        self.model = model
        if kernel is None:
            self.kernel = [Trivial()]
        else:
            kernel = kernel if isinstance(kernel, (tuple, list)) else [kernel]
            self.kernel = [k if k is not None else Trivial() for k in kernel]

    @staticmethod
    def _args(input):
        if isinstance(input, dict):
            return (), input
        if isinstance(input, (tuple, list)):
            return tuple(input), {}
        return (input,), {}

    def forward(self, params, input, target=None):
        args, kwargs = self._args(input)
        output = functional_call(self.model, params, args, kwargs)
        return self.residuals(output, target)

    def residuals(self, outputs, targets):
        if isinstance(outputs, (tuple, list)):
            targets = [None] * len(outputs) if targets is None else targets
            return tuple(self.residual(o, targets[i])
                         for i, o in enumerate(outputs))
        return (self.residual(outputs, targets),)

    def residual(self, output, target):
        output = _as_tensor(output)
        return output if target is None else output - _as_tensor(target)

    def loss(self, params, input, target=None):
        """Scalar kernelized loss: sum_i k_i(||r_i||^2).sum()."""
        R = self.forward(params, input, target)
        if len(self.kernel) > 1:
            terms = [torch.sum(k(torch.sum(r * r, -1)))
                     for k, r in zip(self.kernel, R)]
        else:
            terms = [torch.sum(self.kernel[0](torch.sum(r * r, -1)))
                     for r in R]
        return sum(terms)


def _update_parameters(params, step):
    """Split a flat step over the parameters (sorted names, storage
    sizes) and retract: ``p.add(d)`` for LieTensors, ``p + d`` otherwise.
    Ref: pypose_tpu/optim/optimizer.py:82."""
    flat = step.reshape(-1)
    out, off = {}, 0
    for k in sorted(params):
        p = params[k]
        n = math.prod(p.shape)
        d = flat[off:off + n].reshape(p.shape)
        out[k] = p.add(d) if isinstance(p, LieTensor) else p + d
        off += n
    return out


def _apply_weight(weight, R_list, J_list):
    """Block weights applied to residuals and Jacobians by batched d x d
    products (no block-diagonal matrix).  Ref:
    pypose_tpu/optim/optimizer.py:107."""
    if weight is None:
        return None, None
    weight = weight if isinstance(weight, (tuple, list)) else [weight]
    assert len(weight) == len(R_list)
    WR, WJ = [], []
    for w, r, Jr in zip(weight, R_list, J_list):
        d = r.shape[-1]
        P = Jr.shape[-1]
        if d == 1:
            w = w.reshape(w.shape + (1, 1))
        wb = w.expand(r.shape[:-1] + (d, d)).reshape(-1, d, d)
        WR.append(torch.einsum('nij,nj->ni', wb, r.reshape(-1, d))
                  .reshape(-1))
        WJ.append(torch.einsum('nij,njk->nik', wb, Jr.reshape(-1, d, P))
                  .reshape(-1, P))
    return torch.cat(WR), torch.cat(WJ, dim=0)


class _Optimizer:
    """Shared machinery: the parameter dict, the Jacobian, the
    correctors.  Ref: pypose_tpu/optim/optimizer.py:130."""

    def __init__(self, model, kernel=None, corrector=None):
        self.module = model
        self.model = RobustModel(model, kernel)
        if kernel is not None:
            kernel = kernel if isinstance(kernel, (tuple, list)) else [kernel]
            kernel = [k if k is not None else Trivial() for k in kernel]
            if corrector is None:
                corrector = [FastTriggs(k) for k in kernel]
        if corrector is None:
            corrector = [Trivial()]
        corrector = corrector if isinstance(corrector, (tuple, list)) \
            else [corrector]
        self.corrector = [c if c is not None else Trivial()
                          for c in corrector]
        self.loss = None
        self.last = None

    def _residuals_and_jac(self, params, input, target):
        """Residuals and, per residual, J [r.numel(), total storage
        size] by ``torch.func.jacrev`` over the sorted parameters."""
        names, leaves, ltypes = _leaves(params)

        def func(*ls):
            R = tuple(self.model.forward(_rebuild(names, ls, ltypes), input,
                                         target))
            return R, R

        J, R = torch.func.jacrev(func, argnums=tuple(range(len(leaves))),
                                 has_aux=True)(*leaves)
        J_flat = [torch.cat([j.reshape(r.numel(), l.numel())
                             for j, l in zip(Ji, leaves)], dim=1)
                  for Ji, r in zip(J, R)]
        return list(R), J_flat

    def _corrected(self, R, J):
        for i in range(len(R)):
            c = self.corrector[0] if len(self.corrector) == 1 \
                else self.corrector[i]
            R[i], J[i] = c(R=R[i], J=J[i])
        return R, J

    def _params(self):
        params = {k: v.detach() for k, v in
                  self.module.parameter_dict().items()}
        require_full_fp32(next(iter(params.values())).device)
        return params

    def _writeback(self, params):
        self.module.load_parameter_dict(params)

    def _system(self, params, input, target, weight):
        """Corrected residuals, the flat residual and Jacobian, and the
        weighted pair (None without a weight)."""
        R, J = self._residuals_and_jac(params, input, target)
        R, J = self._corrected(R, J)
        WR, WJ = _apply_weight(weight, R, J)
        R_flat = torch.cat([r.reshape(-1) for r in R])
        J_flat = torch.cat(J, dim=0)
        return R_flat, J_flat, WR, WJ


class GaussNewton(_Optimizer):
    r"""Gauss-Newton optimizer for nonlinear least squares,
    :math:`\min_\theta \sum_i \rho_i(\|r_i(\theta)\|^2)`: each step solves
    :math:`J\,\delta = -r` with ``solver`` (a pseudo-inverse by default,
    not the normal equations) and retracts.

    Args:
        model: a :class:`pypose_tpu_torch.Module` whose ``forward``
            returns the residual (or a tuple of them); its parameters are
            optimized.
        solver: linear solver (default :class:`PINV`).
        kernel: robust kernel(s) on the squared residual norms.
        corrector: corrector(s); :class:`FastTriggs` when a kernel is
            given.
        weight: optional block weights (information matrices).

    Ref: pypose_tpu/optim/optimizer.py:185.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> class PoseInv(pp.Module):
        ...     def __init__(self):
        ...         super().__init__()
        ...         self.pose = pp.Parameter(pp.identity_se3(2))
        ...     def forward(self, input):
        ...         return (self.pose.Exp() @ input).Log().tensor()
        >>> target = pp.randn_SE3(2, sigma=0.5,
        ...                       generator=torch.Generator().manual_seed(0))
        >>> opt = pp.optim.GN(PoseInv())
        >>> for _ in range(4):
        ...     loss = opt.step(target)
        >>> loss < 1e-7
        True
    """

    def __init__(self, model, solver=None, kernel=None, corrector=None,
                 weight=None, vectorize=True):
        super().__init__(model, kernel, corrector)
        self.solver = PINV() if solver is None else solver
        self.weight = weight

    def _core(self, params, input, target, weight):
        R_flat, J_flat, WR, WJ = self._system(params, input, target, weight)
        A, b = (J_flat, -R_flat) if weight is None else (WJ, -WR)
        D = self.solver(A=A, b=b.reshape(-1, 1))
        last = self.model.loss(params, input, target)
        new_params = _update_parameters(params, D)
        loss = self.model.loss(new_params, input, target)
        return new_params, loss, last

    def step(self, input=None, target=None, weight=None):
        weight = self.weight if weight is None else weight
        new_params, loss, last = self._core(self._params(), input, target,
                                            weight)
        self._writeback(new_params)
        loss, last = torch.stack([loss, last]).tolist()
        self.last = self.loss if self.loss is not None else last
        self.loss = loss
        return self.loss

    def _optimize_run(self, params, input, target, weight, steps, patience,
                      decreasing):
        """The StopOnPlateau loop around the GN core with no host read:
        ``steps`` rounds, the state frozen once the plateau rule stops
        it.  Returns (params, loss, history [steps] float32 with NaN past
        the stop, steps run).  Ref: pypose_tpu/optim/optimizer.py:259."""
        dev = _as_tensor(next(iter(params.values()))).device
        hist = torch.full((steps,), math.nan, dtype=torch.float32,
                          device=dev)
        last = torch.full((), math.inf, dtype=torch.float32, device=dev)
        i = torch.zeros((), dtype=torch.int32, device=dev)
        pat = torch.zeros_like(i)
        stop = torch.zeros((), dtype=torch.bool, device=dev)
        p = params
        for k in range(steps):
            p2, loss, _ = self._core(p, input, target, weight)
            loss = loss.to(torch.float32)
            run = ~stop
            hist = torch.where(run & (torch.arange(steps, device=dev) == k),
                               loss, hist)
            pat2 = torch.where(last - loss < decreasing, pat + 1,
                               torch.zeros_like(pat))
            p = _where(run, p2, p)
            last = torch.where(run, loss, last)
            i = i + run.to(i.dtype)
            pat = torch.where(run, pat2, pat)
            stop = stop | (run & (pat2 >= patience))
        return p, last, hist, i

    def optimize(self, input=None, target=None, weight=None, steps=10,
                 patience=5, decreasing=1e-3):
        """The StopOnPlateau loop around the GN core, one host read in
        all (``StopOnPlateau.optimize`` delegates here when not
        verbose).  Returns the final loss; per-step losses land in
        ``self.history``."""
        weight = self.weight if weight is None else weight
        p, loss, hist, nsteps = self._optimize_run(
            self._params(), input, target, weight, steps, patience,
            decreasing)
        self._writeback(p)
        vals = torch.cat([loss[None], hist, nsteps[None].to(hist.dtype)])
        vals = vals.tolist()
        n = int(vals[-1])
        self.history = vals[1:1 + n]
        self.loss = vals[0]
        self.last = self.history[-2] if len(self.history) > 1 else None
        return self.loss


GN = GaussNewton


class LevenbergMarquardt(_Optimizer):
    r"""Levenberg-Marquardt optimizer: the damped normal equations
    :math:`(J^\top W J + \lambda\,\mathrm{diag}(J^\top W J))\,\delta =
    -J^\top W r` (the diagonal clamped to [``min``, ``max``] first), with
    a damping strategy (:class:`Constant`, :class:`Adaptive`,
    :class:`TrustRegion`) and the reference's reject-retry rule: a step
    that raises the loss is rejected, up to ``reject`` times, with the
    strategy's new damping.  A non-finite step or candidate loss is never
    taken.  The sparse factor-graph path is
    :class:`pypose_tpu_torch.optim.sparse.SparseLM`.

    Ref: pypose_tpu/optim/optimizer.py:311.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> from pypose_tpu_torch.optim.strategy import Adaptive
        >>> class PoseInv(pp.Module):
        ...     def __init__(self):
        ...         super().__init__()
        ...         self.pose = pp.Parameter(pp.identity_se3(2))
        ...     def forward(self, input):
        ...         return (self.pose.Exp() @ input).Log().tensor()
        >>> target = pp.randn_SE3(2, sigma=0.5,
        ...                       generator=torch.Generator().manual_seed(1))
        >>> opt = pp.optim.LM(PoseInv(), strategy=Adaptive(damping=1e-6))
        >>> for _ in range(4):
        ...     loss = opt.step(target)
        >>> loss < 1e-7
        True
    """

    def __init__(self, model, solver=None, strategy=None, kernel=None,
                 corrector=None, weight=None, reject=16, min=1e-6, max=1e32,
                 vectorize=True, sparse=False):
        if sparse:
            raise ValueError(
                'LM(sparse=True): use pypose_tpu_torch.optim.sparse.SparseLM '
                'with Factor edge declarations')
        if not min > 0:
            raise ValueError(f'min value has to be positive: {min}')
        if not max > 0:
            raise ValueError(f'max value has to be positive: {max}')
        super().__init__(model, kernel, corrector)
        self.solver = Cholesky() if solver is None else solver
        self.strategy = TrustRegion() if strategy is None else strategy
        self.min, self.max = min, max
        self.reject = reject
        self.reject_count = 0
        self.weight = weight
        self.strategy_state = None

    def _core(self, params, strat_state, input, target, weight):
        """One LM step: the normal equations once, then ``reject + 1``
        damping rounds, each a solve, a candidate and its loss; a round
        after the step was settled leaves the state as it was.  Returns
        (params, loss, last, strategy state, rejections)."""
        R_flat, J_flat, WR, WJ = self._system(params, input, target, weight)
        JT = J_flat.transpose(0, 1)
        if weight is None:
            JT_W_R, A = JT @ R_flat, JT @ J_flat
        else:
            JT_W_R, A = JT @ WR, JT @ WJ
        diag = torch.diagonal(A)
        A = A - torch.diag_embed(diag) + torch.diag_embed(
            torch.clamp(diag, self.min, self.max))
        b = -JT_W_R.reshape(-1, 1)
        R_col = R_flat.reshape(-1, 1)
        last = self.model.loss(params, input, target)

        p0, loss, strat = params, last, strat_state
        count = torch.zeros((), dtype=torch.int32, device=last.device)
        done = torch.zeros((), dtype=torch.bool, device=last.device)
        for _ in range(self.reject + 1):
            A_d = A + torch.diag_embed(torch.diagonal(A) * strat['damping'])
            D = self.solver(A=A_d, b=b)
            bad = ~torch.all(torch.isfinite(D))
            D_safe = torch.where(bad, torch.zeros_like(D), D)
            cand = _update_parameters(p0, D_safe)
            loss_new = self.model.loss(cand, input, target)
            # a non-finite candidate loss is as bad as a non-finite delta
            bad = bad | ~torch.isfinite(loss_new)
            strat_new = self.strategy.update(strat, last, loss_new, J_flat,
                                             D_safe, R_col)
            rejectable = (last < loss_new) & (count < self.reject) & ~bad
            take = ~rejectable & ~bad
            run = ~done
            p0 = _where(run & take, cand, p0)
            loss = torch.where(run, torch.where(take, loss_new, last), loss)
            strat = _where(run, strat_new, strat)
            count = count + (run & rejectable).to(count.dtype)
            done = done | ~rejectable
        return p0, loss, last, strat, count

    def _init_strategy(self, params):
        if self.strategy_state is None:
            first = _as_tensor(next(iter(params.values())))
            self.strategy_state = self.strategy.init(first.dtype,
                                                     first.device)

    def step(self, input=None, target=None, weight=None):
        weight = self.weight if weight is None else weight
        params = self._params()
        self._init_strategy(params)
        new_params, loss, last, strat, count = self._core(
            params, self.strategy_state, input, target, weight)
        self._writeback(new_params)
        self.strategy_state = strat
        loss, last, count = torch.stack(
            [loss, last, count.to(loss.dtype)]).tolist()
        self.reject_count = int(count)
        self.last = last
        self.loss = loss
        return self.loss

    def optimize(self, input=None, target=None, weight=None, steps=10,
                 patience=5, decreasing=1e-3):
        """The StopOnPlateau loop (patience on the absolute decrease; quit
        after a rejection that also failed to make the progress) around
        the LM core, with one host read in all (``StopOnPlateau.optimize``
        delegates here when not verbose).  Returns the final loss;
        per-step losses land in ``self.history``.  Ref:
        pypose_tpu/optim/optimizer.py:LevenbergMarquardt.optimize."""
        weight = self.weight if weight is None else weight
        p = self._params()
        self._init_strategy(p)
        strat = self.strategy_state
        dev = _as_tensor(next(iter(p.values()))).device
        hist = torch.full((steps,), math.nan, dtype=torch.float32,
                          device=dev)
        loss = torch.full((), math.inf, dtype=torch.float32, device=dev)
        i = torch.zeros((), dtype=torch.int32, device=dev)
        pat = torch.zeros_like(i)
        stop = torch.zeros((), dtype=torch.bool, device=dev)
        for k in range(steps):
            p2, loss2, last, strat2, count = self._core(p, strat, input,
                                                        target, weight)
            run = ~stop
            hist = torch.where(run & (torch.arange(steps, device=dev) == k),
                               loss2.to(torch.float32), hist)
            small = last - loss2 < decreasing
            pat2 = torch.where(small, pat + 1, torch.zeros_like(pat))
            # quit on rejection only when the step also failed to make the
            # required progress (the reference quits on any rejection)
            stop2 = (pat2 >= patience) | ((count > 0) & small)
            p = _where(run, p2, p)
            strat = _where(run, strat2, strat)
            loss = torch.where(run, loss2.to(torch.float32), loss)
            i = i + run.to(i.dtype)
            pat = torch.where(run, pat2, pat)
            stop = stop | (run & stop2)
        self._writeback(p)
        self.strategy_state = strat
        vals = torch.cat([loss[None], hist, i[None].to(hist.dtype)]).tolist()
        n = int(vals[-1])
        self.history = vals[1:1 + n]
        self.loss = vals[0]
        self.last = self.history[-2] if len(self.history) > 1 else None
        return self.loss


LM = LevenbergMarquardt


def make_batch_optimizer(model, steps=10, strategy=None, kernel=None,
                         solver=None, has_target=False, has_weight=False):
    r"""A reusable solver for many independent instances of one least
    squares problem: ``torch.func.vmap`` of ``steps`` LM steps over a
    leading problem axis of ``input`` (and of ``target`` / ``weight``
    when enabled), every problem from the model's current parameters.  It
    reads the host nowhere.

    Returns ``solve(input, target=None, weight=None) -> (params, losses)``
    with a leading problem axis on every parameter and on the losses.

    Ref: pypose_tpu/optim/optimizer.py:506.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> from pypose_tpu_torch.optim import make_batch_optimizer
        >>> from pypose_tpu_torch.optim.strategy import Constant
        >>> class PoseInv(pp.Module):
        ...     def __init__(self):
        ...         super().__init__()
        ...         self.pose = pp.Parameter(pp.identity_se3(1))
        ...     def forward(self, input):
        ...         return (self.pose.Exp() @ input).Log().tensor()
        >>> solve = make_batch_optimizer(PoseInv(), steps=4,
        ...                              strategy=Constant(damping=1e-6))
        >>> targets = pp.randn_SE3(32, 1, sigma=0.3,
        ...                        generator=torch.Generator().manual_seed(0))
        >>> params, losses = solve(targets)   # 32 problems at once
        >>> bool(losses.max() < 1e-8)
        True
    """
    opt = LevenbergMarquardt(model, strategy=strategy, kernel=kernel,
                             solver=solver)
    params0 = opt._params()
    first = _as_tensor(next(iter(params0.values())))
    strat0 = opt.strategy.init(first.dtype, first.device)

    def solve_one(inp, tgt, wgt):
        params, strat = params0, strat0
        for _ in range(steps):
            params, loss, _, strat, _ = opt._core(params, strat, inp, tgt,
                                                  wgt)
        return params, loss

    in_dims = (0, 0 if has_target else None, 0 if has_weight else None)
    vsolve = torch.func.vmap(solve_one, in_dims=in_dims)

    def solve(input, target=None, weight=None):
        return vsolve(input, target, weight)

    return solve


def batch_optimize(model, input, target=None, weight=None, steps=10,
                   strategy=None, kernel=None, solver=None):
    r"""One call of :func:`make_batch_optimizer`.  Ref:
    pypose_tpu/optim/optimizer.py:565."""
    solve = make_batch_optimizer(model, steps=steps, strategy=strategy,
                                 kernel=kernel, solver=solver,
                                 has_target=target is not None,
                                 has_weight=weight is not None)
    return solve(input, target, weight)
