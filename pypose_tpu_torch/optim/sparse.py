r"""Sparse factor-graph Levenberg-Marquardt on torch tensors.

Counterpart of ``pypose_tpu/optim/sparse.py``.  Neither J nor J^T W J is
ever formed: per LM step the per-edge tangent-space Jacobian blocks come
from a closed form or, for a factor without one, from reverse-mode
autodiff of its residual under a left retraction (the Lie ops' autograd
Functions); robust kernels rescale them (FastTriggs).  The normal
equations are assembled per node
(diagonal blocks) and per edge or circular offset (coupling blocks,
``ops/spmv.py``), and a preconditioned CG solves them.  ``SparseLM``
decides its route at construction (:attr:`SparseLM.route`), by one
predicate that holds alike on every device:

- ``'stencil'``: all edges merge into one circulant stencil, the
  preconditioner is block-Jacobi, the parameters are float32 and the
  tangent dimension t is one the kernels are built for
  (``ops/stencil_cg.KERNEL_T``: 3, 4, 6, 7, the four groups' and a
  Euclidean group's of those sizes).  The whole solve runs in the CUDA
  kernels of ``ops/stencil_cg.py`` (their plain PyTorch versions on the
  CPU): the cluster kernel while the system fits the L2 budget, else the
  fused Chronopoulos-Gear kernel.
- ``'chain'``: the block-tridiagonal chain preconditioner, solved exactly
  by block cyclic reduction (``ops/block_tridiag.py``), inside the
  einsum CG.
- ``'einsum'``: every other graph.  The einsum CG
  (``optim/solver.py:cg``, ``jax.scipy.sparse.linalg.cg``'s recursion)
  with per-factor stencil or coupling-block (``CouplingSpMV``) matvecs,
  or the generic gather matvec where the graph is not one arity-2 group,
  and block-Jacobi through ``ops/smallinv.py:blockinv_scalar`` (t = 3,
  6) or ``blockinv``.

This mirrors the JAX package's own predicate
(``pypose_tpu/optim/sparse.py:671-687``): systems its kernel does not take
go to the einsum CG.  Its Pallas kernels take any static block size; the
CUDA kernels are built for the four groups' and other sizes take the
einsum CG.  How a factor's Jacobian is formed does not change its route.

The JAX package runs the LM reject loop, the plateau schedule and the
einsum CG inside ``lax.while_loop``; here they are Python loops that read
one host scalar per damping retry, one per LM step, and, on the einsum
and chain routes, one per CG iteration.
"""

import numpy as np
import torch

from ..lietensor import jacobian as _jac
from ..lietensor import operation as _op
from ..lietensor.lietensor import (LieTensor, SO3_type, SE3_type, RxSO3_type,
                                   Sim3_type)
from ..ops.block_tridiag import bcr_factor, bcr_solve
from ..ops.smallinv import blockinv, blockinv_scalar
from ..ops.spmv import CouplingSpMV, StencilSpMV
from ..ops.stencil_cg import KERNEL_T, stencil_cg
from .solver import cg
from .strategy import TrustRegion


def _tan_dim(v):
    return v.ltype.manifold[0] if isinstance(v, LieTensor) else v.shape[-1]


def _n_nodes(v):
    return int(np.prod(tuple(v.shape[:-1])))


def require_full_fp32(device):
    """Turn TF32 off for matmuls and cuDNN, and check that it is off, when
    ``device`` is a CUDA device: the JAX package pins
    ``precision=HIGHEST`` throughout, and TF32 keeps ~3 decimal digits."""
    if torch.device(device).type != 'cuda':
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError('TF32 could not be turned off')


class Factor:
    r"""A batch of E identical residual factors.

    Args:
        residual: ``residual(values, consts) -> [E, d]`` over the whole
            batch, where ``values`` maps each group name to the gathered
            nodes ``[E, arity, D]`` (LieTensor or tensor).  Row e must
            depend on edge e's values and constants alone: the autodiff
            Jacobian differentiates the whole batch at once, which is
            exact only then (the JAX package's per-edge residual makes
            this structural; here it is the residual's contract).
        indices: dict ``name -> int [E, arity]`` (or ``[E]``) rows of each
            variable group.
        consts: per-edge constants, leading dim E (measurements).
        weight: optional information matrices ``[E, d, d]`` or ``[d, d]``.
        kernel: optional robust kernel on ``chi2 = r^T W r``
            (``optim.kernel``; FastTriggs scaling of r and J).
        batched_jacobian: optional ``(values, consts) -> (r [E, d],
            {name: J [E, d, arity, tan]})``, a closed-form tangent
            Jacobian; without one ``SparseLM`` takes the Jacobian of
            ``residual`` by reverse-mode autodiff.
    """

    def __init__(self, residual, indices, consts=None, weight=None,
                 kernel=None, batched_jacobian=None):
        self.residual = residual
        self.kernel = kernel
        self.batched_jacobian = batched_jacobian
        self.indices = {}
        for k, v in indices.items():
            v = torch.as_tensor(v, dtype=torch.int64)
            self.indices[k] = v[:, None] if v.ndim == 1 else v
        self.consts = consts
        self.weight = weight
        self.num_edges = next(iter(self.indices.values())).shape[0]


class SparseLM:
    r"""Levenberg-Marquardt over a factor graph with a matvec-only
    preconditioned-CG solve.

    Args:
        params: dict ``name -> LieTensor [N, D] | tensor [N, D]`` stacked
            variable nodes, all on one device.
        factors: list of :class:`Factor`.
        strategy: damping strategy (default ``TrustRegion()``).
        reject: most rejected damping retries per LM step.
        min, max: clamp of the J^T W J diagonal before damping.
        cg_iter, cg_tol: inner CG budget (default ``min(10 * nparam,
            500)`` iterations).
        fixed: dict ``name -> bool mask [N]`` of gauge-fixed nodes.
        precond: 'auto', 'jacobi' or 'chain' ('auto' picks the chain
            preconditioner for chain-dominated graphs: a chain factor and
            fewer than 0.3 non-chain edges a node).

    Attributes:
        route: 'stencil', 'chain' or 'einsum', the solve's route (module
            docstring), fixed at construction; read-only.

    Example — a 30-pose odometry ring:

        >>> import torch
        >>> from pypose_tpu_torch.lietensor.utils import se3
        >>> from pypose_tpu_torch.optim.sparse import SparseLM, pgo_factor
        >>> from pypose_tpu_torch.optim.strategy import TrustRegion
        >>> g = torch.Generator().manual_seed(0)
        >>> N = 30
        >>> truth = se3(0.3 * torch.randn(N, 6, generator=g)).Exp()
        >>> i = torch.arange(N)
        >>> edges = torch.stack([i, (i + 1) % N], 1)
        >>> Z = truth[edges[:, 0]].Inv() @ truth[edges[:, 1]]
        >>> noisy = se3(0.1 * torch.randn(N, 6, generator=g)).Exp() @ truth
        >>> fixed = torch.zeros(N, dtype=torch.bool); fixed[0] = True
        >>> opt = SparseLM({'poses': noisy}, [pgo_factor(edges, Z)],
        ...                strategy=TrustRegion(radius=1e4),
        ...                fixed={'poses': fixed})
        >>> opt.optimize(steps=10, decreasing=1e-9, patience=2) < 1e-8
        True
    """

    # transpose-accumulations gather through per-node incidence tables
    # (scatter-free, fixed summation order) when the max node degree is
    # below this
    MAX_INCIDENCE_DEGREE = 64

    def __init__(self, params, factors, strategy=None, reject=16, min=1e-6,
                 max=1e32, cg_iter=None, cg_tol=1e-5, fixed=None,
                 precond='auto'):
        self.params = dict(params)
        self.factors = list(factors)
        self.strategy = TrustRegion() if strategy is None else strategy
        self.min, self.max = min, max
        self.reject = reject
        self.cg_iter = cg_iter
        self.cg_tol = cg_tol
        first = next(iter(self.params.values()))
        self.device = first.device
        self.dtype = first.tensor().dtype if isinstance(first, LieTensor) \
            else first.dtype
        require_full_fp32(self.device)
        self.fixed = {n: torch.as_tensor(m, dtype=torch.bool,
                                         device=self.device)
                      for n, m in (fixed or {}).items()}
        for f in self.factors:
            f.indices = {n: v.to(self.device) for n, v in f.indices.items()}
        self.strategy_state = None
        self.loss = None
        self.last = None
        self.reject_count = 0
        self.history = []
        self.cg_iterations = []
        self._check_route()
        self._build_incidence()
        self._build_stencil()
        if precond == 'auto':
            # the chain-exact preconditioner pays off on chain-dominated
            # graphs: few non-chain edges per node
            has_chain = any(
                s is not None and len(s) == 2 and s[1] == s[0] + 1
                for s in self._slice.values())
            n_nodes = sum(_n_nodes(v) for v in self.params.values())
            non_chain_edges = sum(
                f.num_edges for fi, f in enumerate(self.factors)
                if not any(self._slice.get((fi, n)) is not None
                           for n in f.indices))
            self.precond = 'chain' if has_chain and \
                non_chain_edges < 0.3 * (n_nodes if n_nodes > 1 else 1) \
                else 'jacobi'
        elif precond in ('jacobi', 'chain'):
            self.precond = precond
        else:
            raise ValueError(f'precond must be auto|jacobi|chain, got '
                             f'{precond!r}')
        if self.precond == 'chain':
            self._route = 'chain'
        elif (self._stencil_all is not None and self.dtype == torch.float32
              and self._stencil_all.tan in KERNEL_T):
            self._route = 'stencil'
        else:
            self._route = 'einsum'
        self._spmv = None
        if self._route != 'stencil' and self._spmv_name is not None:
            self._build_spmv()

    @property
    def route(self):
        """'stencil', 'chain' or 'einsum': the solve's route, fixed at
        construction (module docstring); read-only."""
        return self._route

    def _pgo_shape(self):
        """The one group's name when every factor is an arity-2 factor over
        one shared [N, d] group (the PGO shape), else None."""
        names = {n for f in self.factors for n in f.indices}
        if len(names) != 1:
            return None
        name = next(iter(names))
        if len(self.params[name].shape) != 2 or any(
                f.indices[name].shape[1] != 2 for f in self.factors):
            return None
        return name

    def _build_stencil(self):
        """The one merged stencil of all edges, for a graph of the PGO shape
        whose edge offsets cluster; None otherwise."""
        self._stencil_all = None
        self._spmv_name = self._pgo_shape()
        if self._spmv_name is None:
            return
        v = self.params[self._spmv_name]
        edges_all = torch.cat([f.indices[self._spmv_name]
                               for f in self.factors])
        try:
            self._stencil_all = StencilSpMV(edges_all, v.shape[0],
                                            _tan_dim(v), device=self.device)
        except ValueError:
            pass

    def _build_spmv(self):
        """Per-factor coupling structures of the einsum and chain routes:
        each factor's gather-free stencil where its offsets cluster, else
        its ``CouplingSpMV``."""
        name = self._spmv_name
        v = self.params[name]
        N, t = v.shape[0], _tan_dim(v)

        def build(f):
            try:
                return StencilSpMV(f.indices[name], N, t, device=self.device)
            except ValueError:
                return CouplingSpMV(f.indices[name], N, t,
                                    device=self.device, dtype=self.dtype)
        self._spmv = [build(f) for f in self.factors]

    def _build_incidence(self):
        """Static per-node incidence tables: for each (factor, group),
        inc[n, k] = flattened (edge * arity + slot) position of the k-th
        contribution to node n, plus a validity mask, so every J^T-side
        accumulation is a gather and a masked sum.  Chain-structured
        factors (``idx[:, a] == offset_a + arange(E)``) use static slices
        instead."""
        self._inc = {}
        self._slice = {}
        for fi, f in enumerate(self.factors):
            for n, idx in f.indices.items():
                idxn = idx.cpu().numpy()
                E_, _ = idxn.shape
                offs = idxn[0]
                if E_ > 1 and np.all(
                        idxn == offs[None, :] + np.arange(E_)[:, None]):
                    self._slice[(fi, n)] = tuple(int(o) for o in offs)
                    continue
                self._slice[(fi, n)] = None
                N = _n_nodes(self.params[n])
                flat = idxn.reshape(-1)
                deg = np.bincount(flat, minlength=N)
                D = int(deg.max()) if len(flat) else 0
                if D > self.MAX_INCIDENCE_DEGREE:
                    self._inc[(fi, n)] = None  # scatter-add instead
                    continue
                # the k-th contribution to each node, in edge order
                order = np.argsort(flat, kind='stable')
                first = np.concatenate([[0], np.cumsum(deg)[:-1]])
                k = np.arange(len(flat)) - first[flat[order]]
                inc = np.zeros((N, max(D, 1)), dtype=np.int64)
                mask = np.zeros((N, max(D, 1)), dtype=bool)
                inc[flat[order], k] = order
                mask[flat[order], k] = True
                self._inc[(fi, n)] = (
                    torch.as_tensor(inc, device=self.device),
                    torch.as_tensor(mask, device=self.device))

    def _accumulate(self, fi, n, contrib, idx):
        """Sum per-(edge, slot) contributions into per-node rows:
        contrib [E, arity, ...] -> [N, ...]."""
        tail = contrib.shape[2:]
        N = _n_nodes(self.params[n])
        offs = self._slice.get((fi, n))
        if offs is not None:
            E = contrib.shape[0]
            out = contrib.new_zeros((N,) + tail)
            for a, o in enumerate(offs):
                out[o:o + E] += contrib[:, a]
            return out
        flatc = contrib.reshape((-1,) + tail)
        inc = self._inc.get((fi, n))
        if inc is None:
            return contrib.new_zeros((N,) + tail).index_add_(
                0, idx.reshape(-1), flatc)
        inc_idx, mask = inc
        m = mask.reshape(mask.shape + (1,) * len(tail))
        return torch.where(m, flatc[inc_idx], 0.0).sum(1)

    def _gather_rows(self, fi, n, table, idx):
        """Rows of ``table`` [N, ...] per edge -> [E, arity, ...]."""
        offs = self._slice.get((fi, n))
        if offs is not None:
            E = idx.shape[0]
            return torch.stack([table[o:o + E] for o in offs], dim=1)
        return table[idx]

    def _gather(self, params, factor, fi):
        vals = {}
        for name, idx in factor.indices.items():
            p = params[name]
            data = p.tensor() if isinstance(p, LieTensor) else p
            data = self._gather_rows(fi, name, data, idx)
            vals[name] = LieTensor(data, ltype=p.ltype) \
                if isinstance(p, LieTensor) else data
        return vals

    # ------------------------------------------------------------------
    # per-factor residuals + tangent Jacobian blocks
    # ------------------------------------------------------------------
    def _edge_r_jac(self, params, factor, fi):
        """(r [E, d], {name: J [E, d, arity, tan]}): the closed form, or
        the tangent Jacobian of the residual at ``Retr(eps)``, eps = 0, by
        one ``torch.func.vjp`` and a ``vmap`` of its pullback over the d
        one-hot cotangents (``jacrev``'s own construction)."""
        vals = self._gather(params, factor, fi)
        if factor.batched_jacobian is not None:
            return factor.batched_jacobian(vals, factor.consts)

        def f(eps):
            return factor.residual(
                {n: v.add(eps[n]) if isinstance(v, LieTensor) else v + eps[n]
                 for n, v in vals.items()}, factor.consts)

        eps0 = {n: torch.zeros(idx.shape + (_tan_dim(params[n]),),
                               dtype=params[n].dtype, device=self.device)
                for n, idx in factor.indices.items()}
        r, pullback = torch.func.vjp(f, eps0)
        eye = torch.eye(r.shape[-1], dtype=r.dtype, device=r.device)
        J, = torch.func.vmap(pullback)(
            eye[:, None, :].expand((-1,) + tuple(r.shape)))
        return r.detach(), {n: j.movedim(0, 1) for n, j in J.items()}

    @staticmethod
    def _weights(factor, E):
        w = factor.weight
        if w is not None and w.ndim == 2:
            w = w.expand((E,) + tuple(w.shape))
        return w

    def _weighted(self, factor, r, J):
        """Apply the robust kernel (FastTriggs: r and J scaled by
        sqrt(rho'(chi2))) and the information weights -> (r, J, W r,
        W J)."""
        w = self._weights(factor, r.shape[0])
        if factor.kernel is not None:
            Wr = r if w is None else torch.einsum('eij,ej->ei', w, r)
            with torch.enable_grad():
                chi = torch.sum(r * Wr, -1, keepdim=True).detach() \
                    .requires_grad_()
                g1, = torch.autograd.grad(factor.kernel(chi).sum(), chi)
            s = torch.sqrt(torch.clamp(g1, min=0.0))
            r = s * r
            J = {n: s[..., None, None] * j for n, j in J.items()}
        if w is None:
            return r, J, r, J
        WR = torch.einsum('eij,ej->ei', w, r)
        WJ = {n: torch.einsum('eij,ejat->eiat', w, j) for n, j in J.items()}
        return r, J, WR, WJ

    def _chi2(self, params):
        total = 0.0
        for fi, f in enumerate(self.factors):
            r = f.residual(self._gather(params, f, fi), f.consts)
            w = self._weights(f, r.shape[0])
            if w is not None:
                chi = torch.sum(r * torch.einsum('eij,ej->ei', w, r), -1)
            else:
                chi = torch.sum(r * r, -1)
            if f.kernel is not None:
                chi = f.kernel(chi)
            total = total + torch.sum(chi)
        return total

    # ------------------------------------------------------------------
    # normal-equation pieces
    # ------------------------------------------------------------------
    def _mask(self, name, x):
        m = self.fixed.get(name)
        if m is None:
            return x
        return torch.where(m[:, None], 0.0, x)

    def _rhs(self, blocks):
        """b = -J^T W r."""
        out = {}
        for fi, (f, (r, J, WR, WJ)) in enumerate(zip(self.factors, blocks)):
            for n in f.indices:
                contrib = torch.einsum('edat,ed->eat', WJ[n], r)
                acc = -self._accumulate(fi, n, contrib, f.indices[n])
                out[n] = acc if n not in out else out[n] + acc
        return {n: self._mask(n, v) for n, v in out.items()}

    def _diag(self, blocks):
        """diag(J^T W J) per tangent coordinate (for LM damping)."""
        out = {}
        for fi, (f, (r, J, WR, WJ)) in enumerate(zip(self.factors, blocks)):
            for n in f.indices:
                acc = self._accumulate(fi, n, torch.sum(J[n] * WJ[n], 1),
                                       f.indices[n])
                out[n] = acc if n not in out else out[n] + acc
        return out

    def _block_diag_accum(self, blocks):
        """Per-node tan x tan diagonal blocks of J^T W J."""
        out = {}
        for fi, (f, (r, J, WR, WJ)) in enumerate(zip(self.factors, blocks)):
            for n in f.indices:
                B = torch.einsum('edat,edau->eatu', WJ[n], J[n])
                acc = self._accumulate(fi, n, B, f.indices[n])
                out[n] = acc if n not in out else out[n] + acc
        return out

    def _damped_blocks(self, accum, damped_scale):
        """Clamp and damp the diagonal of the accumulated blocks (the same
        treatment the solve's operator gets)."""
        out = {}
        for n, B in accum.items():
            diag = torch.diagonal(B, dim1=-2, dim2=-1)
            d = torch.clamp(diag, self.min, self.max) * damped_scale[n]
            eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
            out[n] = B + (d - diag)[..., None] * eye + 1e-8 * eye
        return out

    def _matvec(self, blocks, x):
        """y = J^T W J x over the tangent dict x (name -> [N, tan]), by
        gathers and incidence accumulation: the route of graphs that are
        not one arity-2 group."""
        out = {n: torch.zeros_like(v) for n, v in x.items()}
        for fi, (f, (r, J, WR, WJ)) in enumerate(zip(self.factors, blocks)):
            Jx = 0.0
            for n in f.indices:
                xg = self._gather_rows(fi, n, self._mask(n, x[n]),
                                       f.indices[n])
                E, A, T = xg.shape
                Jx = Jx + torch.einsum('eij,ej->ei', J[n].reshape(E, -1, A * T),
                                       xg.reshape(E, A * T))
            for n in f.indices:
                E, A = Jx.shape[0], f.indices[n].shape[1]
                contrib = torch.einsum(
                    'eij,ei->ej', WJ[n].reshape(E, Jx.shape[1], -1),
                    Jx).reshape(E, A, -1)
                out[n] = out[n] + self._accumulate(fi, n, contrib,
                                                   f.indices[n])
        return {n: self._mask(n, v) for n, v in out.items()}

    def _block_jacobi(self, accum, damped_scale):
        """Per-node damped blocks of J^T W J, inverted."""
        return {n: blockinv(B)
                for n, B in self._damped_blocks(accum, damped_scale).items()}

    def _chain_offdiag(self, blocks, n):
        """Super-diagonal blocks U[i] (node i -> i+1) of group ``n`` from
        its chain-structured factors; None if it has no chain."""
        N, t = _n_nodes(self.params[n]), _tan_dim(self.params[n])
        U = None
        for fi, (f, (r, J, WR, WJ)) in enumerate(zip(self.factors, blocks)):
            offs = self._slice.get((fi, n))
            if offs is None or len(offs) != 2 or offs[1] != offs[0] + 1:
                continue
            blk = torch.einsum('edt,edu->etu', WJ[n][:, :, 0, :],
                               J[n][:, :, 1, :])
            if U is None:
                U = blk.new_zeros((N, t, t))
            U[offs[0]:offs[0] + blk.shape[0]] += blk
        return U

    def _chain_preconditioner(self, blocks, accum, damped_scale):
        """The block-tridiagonal (chain-exact) preconditioner where a group
        has chain factors, block-Jacobi elsewhere: M(x) over tangent dicts.
        Fixed nodes get identity diagonal blocks and no couplings."""
        appliers = {}
        for n, D in self._damped_blocks(accum, damped_scale).items():
            U = self._chain_offdiag(blocks, n)
            if U is None:
                appliers[n] = (lambda inv: lambda x: torch.einsum(
                    'ntu,nu->nt', inv, x))(blockinv(D))
                continue
            m = self.fixed.get(n)
            if m is not None:
                eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
                D = torch.where(m[:, None, None], eye, D)
                kill = torch.cat([m[:-1] | m[1:], m.new_ones(1)])
                U = torch.where(kill[:, None, None], 0.0, U)
            L = torch.cat([torch.zeros_like(U[:1]),
                           U[:-1].transpose(-1, -2)])
            appliers[n] = (lambda fac: lambda x: bcr_solve(fac, x))(
                bcr_factor(D, L, U))
        return lambda x: {n: appliers[n](x[n]) for n in x}

    # ------------------------------------------------------------------
    def _check_route(self):
        """Raise for what is still to port: strategies other than
        TrustRegion."""
        if not isinstance(self.strategy, TrustRegion):
            raise NotImplementedError(
                'only TrustRegion is ported; Constant/Adaptive come with '
                'the dense-optimizer slice (ROADMAP Queue A, slice 7)')

    def _core(self, params, strat):
        """One LM step: formation, then damping retries until a step is
        taken or the reject budget is spent.  Returns (params, loss,
        last, strategy state, rejections, CG iterations per solve)."""
        blocks = [self._weighted(f, *self._edge_r_jac(params, f, fi))
                  for fi, f in enumerate(self.factors)]
        b = self._rhs(blocks)
        diag_raw = self._diag(blocks)
        diagA = {n: torch.clamp(v, self.min, self.max)
                 for n, v in diag_raw.items()}
        last = self._chi2(params)
        nparam = sum(_n_nodes(v) * _tan_dim(v) for v in params.values())
        maxiter = self.cg_iter if self.cg_iter is not None \
            else min(10 * nparam, 500)
        accum = self._block_diag_accum(blocks)
        solve = self._stencil_solver(b, diagA, diag_raw, accum, blocks,
                                     maxiter) if self.route == 'stencil' \
            else self._einsum_solver(b, diagA, diag_raw, accum, blocks,
                                     maxiter)

        def retract_all(p, delta):
            out = {}
            for n, v in p.items():
                d = self._mask(n, delta[n])
                out[n] = v.add(d) if isinstance(v, LieTensor) else v + d
            return out

        def pred_reduction(delta):
            """-(J D)^T W (2 R + J D), summed over factors."""
            total = 0.0
            for fi, (f, (r, J, WR, WJ)) in enumerate(
                    zip(self.factors, blocks)):
                Jd = 0.0
                for n in f.indices:
                    xg = self._gather_rows(fi, n, self._mask(n, delta[n]),
                                           f.indices[n])
                    Jd = Jd + torch.einsum('edat,eat->ed', J[n], xg)
                w = self._weights(f, r.shape[0])
                WJd = Jd if w is None else torch.einsum('eij,ej->ei', w, Jd)
                total = total + torch.sum(WJd * (2.0 * r + Jd))
            return -total

        count = 0
        its = []
        while True:
            x, it = solve(strat['damping'])
            its.append(it)
            bad = ~torch.all(torch.isfinite(
                torch.cat([v.reshape(-1) for v in x.values()])))
            D = {n: torch.where(bad, 0.0, v) for n, v in x.items()}
            cand = retract_all(params, D)
            loss_new = self._chi2(cand)
            # a non-finite candidate loss is as bad as a non-finite delta
            bad = bad | ~torch.isfinite(loss_new)
            pred = pred_reduction(D)
            q = (last - loss_new) / torch.where(pred == 0, 1e-31, pred)
            # a non-positive predicted reduction (unconverged-CG garbage
            # step) is a hard reject; the reference divides blindly
            q = torch.where(pred > 0, q, -1.0)
            strat = self._strategy_update(strat, q)
            rejectable = (last < loss_new) & ~bad
            if count >= self.reject or not bool(rejectable):
                take = ~bad
                p_out = {n: self._where_param(take, cand[n], params[n])
                         for n in params}
                return (p_out, torch.where(take, loss_new, last), last,
                        strat, count, its)
            count += 1

    def _stencil_solver(self, b, diagA, diag_raw, accum, blocks, maxiter):
        """solve(damping) -> ({name: x}, iterations) of the 'stencil'
        route: the merged channels, once a step, and ``stencil_cg``."""
        nm = self._spmv_name
        C_all = self._stencil_all.precompute_multi(
            [(blk[1][nm], blk[3][nm]) for blk in blocks])
        offsets = tuple(self._stencil_all.offsets)

        def solve(damping):
            dcorr = diagA[nm] - diag_raw[nm] + damping * diagA[nm]
            Minv = blockinv(self._damped_blocks(
                accum, {nm: 1.0 + damping})[nm])
            x, it = stencil_cg(b[nm], accum[nm], dcorr, Minv, C_all, offsets,
                               fixed_mask=self.fixed.get(nm),
                               maxiter=maxiter, tol=self.cg_tol)
            return {nm: x}, it
        return solve

    def _einsum_solver(self, b, diagA, diag_raw, accum, blocks, maxiter):
        """solve(damping) -> (x, iterations) of the 'einsum' and 'chain'
        routes: the einsum CG (``solver.cg``) on the clamped and damped
        operator, with per-factor stencil or coupling-block matvecs for
        graphs of the PGO shape and the generic gather matvec otherwise;
        preconditioned by the chain's BCR ('chain'), else by block-Jacobi
        (scalarized for one group of t = 3 or 6, ``blockinv`` and so
        ``torch.linalg.inv`` for other sizes, as in the JAX package)."""
        if self._spmv is not None:
            nm = self._spmv_name
            # coupling blocks once a step, for every CG iteration of every
            # damping retry
            states = [sp.precompute(blk[1][nm], blk[3][nm])
                      for sp, blk in zip(self._spmv, blocks)]
            D_spmv = accum[nm]

            def raw_matvec(x):
                xm = self._mask(nm, x[nm])
                y = torch.einsum('ntu,nu->nt', D_spmv, xm)
                for sp, st in zip(self._spmv, states):
                    y = y + sp.couple(st, xm)
                return {nm: self._mask(nm, y)}
        else:
            def raw_matvec(x):
                return self._matvec(blocks, x)

        names = list(diagA)
        scalar_pc = (self.route == 'einsum' and len(names) == 1
                     and accum[names[0]].shape[-1] in (3, 6))
        if scalar_pc:
            # the blocks' t*t components as [N] vectors, once a step
            n0 = names[0]
            t0 = accum[n0].shape[-1]
            acc_T = accum[n0].permute(1, 2, 0)
            pc_comps = [acc_T[i, j] for i in range(t0) for j in range(t0)]
            pc_diag_cl = [torch.clamp(pc_comps[i * t0 + i], self.min,
                                      self.max) for i in range(t0)]

        def solve(damping):
            def Avp(x):
                # the diagonal clamped to [min, max], then damped
                y = raw_matvec(x)
                return {n: y[n] + (diagA[n] - diag_raw[n]
                                   + damping * diagA[n]) * self._mask(n, x[n])
                        for n in y}

            scale = {n: 1.0 + damping for n in diagA}
            if self.route == 'chain':
                M = self._chain_preconditioner(blocks, accum, scale)
            elif scalar_pc:
                comps = list(pc_comps)
                for i in range(t0):
                    comps[i * t0 + i] = pc_diag_cl[i] * (1.0 + damping) + 1e-8
                Binv = torch.stack(blockinv_scalar(comps)).reshape(
                    t0, t0, -1).permute(2, 0, 1)

                def M(x):
                    return {n0: torch.einsum('ntu,nu->nt', Binv, x[n0])}
            else:
                Binv = self._block_jacobi(accum, scale)

                def M(x):
                    return {n: torch.einsum('ntu,nu->nt', Binv[n], x[n])
                            for n in x}
            return cg(Avp, b, tol=self.cg_tol, maxiter=maxiter, M=M)
        return solve

    @staticmethod
    def _where_param(cond, a, b):
        if isinstance(a, LieTensor):
            return LieTensor(torch.where(cond, a.tensor(), b.tensor()),
                             ltype=a.ltype)
        return torch.where(cond, a, b)

    def _strategy_update(self, strat, quality):
        """TrustRegion update from a precomputed gain ratio (SparseLM never
        forms J, so the dense strategies' (J, D, R) signature is
        bypassed)."""
        return self.strategy.step(strat, quality)

    def _init_strategy(self):
        if self.strategy_state is None:
            self.strategy_state = self.strategy.init(self.dtype, self.device)

    def step(self):
        """One LM step; returns the new chi2."""
        self._init_strategy()
        p, loss, last, strat, count, its = self._core(
            self.params, self.strategy_state)
        self.params = p
        self.strategy_state = strat
        self.reject_count = count
        self.last, self.loss = torch.stack([last, loss]).tolist()
        self.cg_iterations = [[int(i) for i in its]]
        return self.loss

    def optimize(self, steps=10, patience=5, decreasing=1e-3):
        """Run up to ``steps`` LM steps with the StopOnPlateau rule: stop
        after ``patience`` steps whose chi2 fell by less than
        ``decreasing``, or after a step with rejections that also fell by
        less than that.  Returns the final chi2; per-step values land in
        ``self.history`` and per-solve CG iterations in
        ``self.cg_iterations``."""
        self._init_strategy()
        p, strat = self.params, self.strategy_state
        loss = None
        hist, its_all = [], []
        pat = 0
        for _ in range(steps):
            p, loss, last, strat, count, its = self._core(p, strat)
            its_all.append(its)
            # one host read per LM step: chi2 and the progress test
            lossv, small = torch.stack(
                [loss, (last - loss < decreasing).to(loss.dtype)]).tolist()
            hist.append(lossv)
            pat = pat + 1 if small else 0
            # quit on rejection only when the step also failed to make the
            # required progress (the reference quits on any rejection)
            if pat >= patience or (count > 0 and small):
                break
        self.params = p
        self.strategy_state = strat
        self.loss = hist[-1] if hist else None
        self.history = hist
        self.cg_iterations = [[int(i) for i in its] for its in its_all]
        return self.loss


# Jl^-1 on the algebra and Adj on the group, for pgo_factor's closed form
_PGO_FORMS = {SO3_type: (_jac.so3_Jl_inv, _op.SO3_Adj),
              RxSO3_type: (_jac.rxso3_Jl_inv, _op.RxSO3_Adj),
              Sim3_type: (_jac.sim3_Jl_inv, _op.Sim3_Adj)}


def pgo_factor(edges, poses, infos=None, kernel=None, name='poses'):
    r"""Relative-pose factor for pose-graph optimisation over SO3 (rotation
    averaging), SE3, RxSO3 or Sim3 (scale-drift graphs).

    Residual per edge (i, j): ``Log(Z^{-1} (X_i^{-1} X_j))`` with optional
    tangent-dimension information-matrix weights.  The tangent Jacobian is
    closed-form: with ``M = Z^-1 X_i^-1`` and ``r = Log(M X_j)``,
    ``dr/d(delta_j) = Jl^-1(r) Adj(M)`` and ``dr/d(delta_i) = -dr/d(delta_j)``
    (left perturbation), written over the whole edge batch; SE3 takes the
    scalarized :func:`~pypose_tpu_torch.lietensor.scalarized.se3_pgo_blocks`.
    Sim3's ``Jl^-1`` is exact (scaling and squaring, then a batched 7x7
    solve).  Another type gets a residual-only factor, whose Jacobian
    ``SparseLM`` takes by autodiff.  ``kernel``: an optional robust kernel
    (``optim.kernel``).
    """
    from ..lietensor.scalarized import se3_pgo_blocks

    def residual(values, Z):
        X = values[name]
        return (Z.Inv() @ (X[:, 0].Inv() @ X[:, 1])).Log().tensor()

    batched_jacobian = None
    if poses.ltype is SE3_type:
        def batched_jacobian(values, Z):
            X = values[name].tensor()
            r, J = se3_pgo_blocks(X[:, 0], X[:, 1], Z.tensor())
            return r, {name: J}
    elif poses.ltype in _PGO_FORMS:
        Jl_inv, Adj = _PGO_FORMS[poses.ltype]

        def batched_jacobian(values, Z):
            X = values[name]
            M = Z.Inv() @ X[:, 0].Inv()
            r = (M @ X[:, 1]).Log().tensor()
            Jj = torch.matmul(Jl_inv(r), Adj(M.tensor()))
            return r, {name: torch.stack([-Jj, Jj], dim=2)}

    return Factor(residual, indices={name: edges}, consts=poses,
                  weight=infos, kernel=kernel,
                  batched_jacobian=batched_jacobian)


def split_chain_edges(edges, min_run=64):
    """Partition edge rows into maximal odometry runs (j == i+1 with
    consecutive i, at least ``min_run`` long) and the rest.  Runs take
    SparseLM's slice path.  Returns (list of row-index arrays for runs,
    rest row-index array)."""
    e = edges.cpu().numpy() if torch.is_tensor(edges) else np.asarray(edges)
    rows = np.arange(e.shape[0])
    cand = (e[:, 1] == e[:, 0] + 1)
    chain_rows = rows[cand]
    if len(chain_rows) == 0:
        return [], rows
    order = np.argsort(e[chain_rows, 0], kind='stable')
    chain_rows = chain_rows[order]
    ii = e[chain_rows, 0]
    breaks = np.nonzero(np.diff(ii) != 1)[0] + 1
    runs = np.split(chain_rows, breaks)
    keep, rest_extra = [], []
    for run in runs:
        (keep if len(run) >= min_run else rest_extra).append(run)
    rest = np.concatenate([rows[~cand]] + rest_extra) if rest_extra \
        else rows[~cand]
    return keep, rest
