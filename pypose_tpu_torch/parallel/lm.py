r"""Sparse Levenberg-Marquardt with the factor graph's edges sharded over a
mesh axis: :class:`ShardedLM` and the pose-graph wrapper
:class:`ShardedPGO`.

Counterpart of ``pypose_tpu/parallel/__init__.py:284-447``.  GSPMD's
implicit partitioning becomes explicit SPMD: every rank holds an equal
slice of the (padded) edges and the full node state; each J^T-side
accumulation (the rhs, the diagonal and its blocks, chi2, each CG
matvec's product, the predicted reduction) is a partial sum over the
rank's edges followed by one ``all_reduce(SUM)`` over the edge axis —
the JAX package's "per-shard partials + psum".  The LM control, the
damping and the CG vectors run replicated: ``all_reduce`` hands every
rank the same bits, so every rank takes the same accept or reject
decision with no further exchange.  Only ``all_reduce`` is used, so
ranks may share a card through gloo.
"""

import torch
from torch.utils._pytree import tree_map

from ..lietensor.lietensor import LieTensor
from ..optim.sparse import SparseLM, Factor, pgo_factor
from ..optim.strategy import Constant, TrustRegion
from .mesh import (all_reduce_sum, axis_size, check_device, local_rows,
                   make_mesh)


def _pad_factor(factor, params, multiple):
    """The factor with its edge count padded to a multiple of ``multiple``,
    neutrally: the padded edges duplicate edge 0's indices and constants
    with a ZERO information matrix and ``valid=False``, so they add nothing
    to any J^T W (.) sum or to chi2.  A factor without weights gets
    identity information matrices first (the same math).  As in the JAX
    package, the padded factor keeps the per-edge ``jacobian`` and not
    the ``batched_jacobian`` (for SE3 ``pgo_factor``: ``Jl^-1(r) @ Adj(M)``
    an edge instead of the scalarized form; in float64 the two differ by
    ~2e-5 at the weighted test problem's edges).  Ref:
    pypose_tpu/parallel/__init__.py:284-328."""
    E = factor.num_edges
    pad = (-E) % multiple
    if pad == 0:
        return factor
    # the residual dim d from edge 0 alone
    vals0 = {n: params[n][idx[0]] for n, idx in factor.indices.items()}
    r0 = factor.residual(vals0, tree_map(lambda x: x[0], factor.consts))
    d, dtype, dev = int(r0.shape[-1]), r0.dtype, r0.device

    def pad_lead(x):
        return torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])

    indices = {n: pad_lead(v) for n, v in factor.indices.items()}
    w = factor.weight
    if w is None:
        w = torch.eye(d, dtype=dtype, device=dev).expand(E, d, d)
    elif w.ndim == 2:
        w = w.expand(E, d, d)
    w = torch.cat([w, w.new_zeros((pad, d, d))])
    valid = torch.cat([
        torch.ones(E, dtype=torch.bool) if factor.valid is None
        else factor.valid.cpu(), torch.zeros(pad, dtype=torch.bool)])
    return Factor(factor.residual, indices,
                  consts=tree_map(pad_lead, factor.consts), weight=w,
                  kernel=factor.kernel, jacobian=factor.jacobian,
                  valid=valid)


class ShardedLM(SparseLM):
    r""":class:`~pypose_tpu_torch.optim.sparse.SparseLM` with its factor
    graph's edges sharded over the mesh axis ``axis``: the full
    single-device LM (TrustRegion, Adaptive or Constant damping, the
    reject loop, robust kernels, information matrices, block-Jacobi or
    chain preconditioning), run on every rank of the mesh.

    Each factor's edges pad to a multiple of the axis size with
    zero-information duplicates of edge 0 (:func:`_pad_factor`); each rank
    keeps its ``Shard(0)`` chunk of every per-edge array (indices,
    constants, weights, validity) and sums over it, and one
    ``all_reduce`` over ``axis`` completes each sum (module docstring).
    Structural choices (the route, the preconditioner, the chain slices)
    are made on the whole graph, so every rank takes the same ones.

    With ``node_axis`` (a 2-D mesh), each parameter group whose node
    count divides that axis is held sharded over it (its rows split over
    the ranks of ``node_axis``) and gathered once an LM step by an
    ``all_reduce`` of zero-filled slices (exact); other groups are held
    whole.  :meth:`full_params` gathers them on demand.

    ``scatter`` defaults to ``mesh.size() > 1`` and ``matvec`` to
    ``'generic'`` (the only one taken: the stencil and coupling-block
    structures span every edge).  The tensors must lie on the mesh's
    device type.  Ref: pypose_tpu/parallel/__init__.py:331-388.
    """

    def __init__(self, params, factors, mesh=None, axis='dp',
                 node_axis=None, **kw):
        self.mesh = make_mesh() if mesh is None else mesh
        check_device(self.mesh, *(v.tensor() if isinstance(v, LieTensor)
                                  else v for v in params.values()))
        m = axis_size(self.mesh, axis)
        factors = [_pad_factor(f, params, m) for f in factors]
        kw.setdefault('scatter', self.mesh.size() > 1)
        kw.setdefault('matvec', 'generic')
        if kw['matvec'] != 'generic':
            raise ValueError("ShardedLM takes matvec='generic' only, got "
                             f"{kw['matvec']!r}")
        super().__init__(params, factors, **kw)
        self._group = self.mesh.get_group(axis)
        E_start = self.mesh.get_local_rank(axis)

        def local(x):
            return local_rows(x, self.mesh, axis)

        for fi, f in enumerate(self.factors):
            start = E_start * (f.num_edges // m)
            f.indices = {n: local(v) for n, v in f.indices.items()}
            f.consts = tree_map(local, f.consts)
            if f.weight is not None and f.weight.ndim == 3:
                f.weight = local(f.weight)
            if f.valid is not None:
                f.valid = local(f.valid)
            f.num_edges //= m
            # chain slices shift to the rank's first edge; other factors
            # sum over tables of the rank's own edges
            for n, idx in f.indices.items():
                offs = self._slice[(fi, n)]
                if offs is not None:
                    self._slice[(fi, n)] = tuple(o + start for o in offs)
                else:
                    self._inc[(fi, n)] = self._incidence(
                        idx.cpu().numpy(), self._shape[n][0])
        self._rows = {}
        if node_axis is not None:
            self._node_group = self.mesh.get_group(node_axis)
            mn = axis_size(self.mesh, node_axis)
            nr = self.mesh.get_local_rank(node_axis)
            for n, v in self.params.items():
                N = self._shape[n][0]
                if len(v.shape) == 2 and N % mn == 0:
                    self._rows[n] = (nr * (N // mn), (nr + 1) * (N // mn))
            self.params = self._shard_nodes(self.params)

    def _reduce(self, sums):
        return all_reduce_sum(sums, self._group)

    def _shard_nodes(self, params):
        out = dict(params)
        for n, (r0, r1) in self._rows.items():
            out[n] = params[n][r0:r1]
        return out

    def full_params(self, params=None):
        """The parameters with every node-sharded group gathered: one
        ``all_reduce`` over ``node_axis`` of zero-filled slices."""
        params = self.params if params is None else params
        if not self._rows:
            return dict(params)
        parts = {}
        for n, (r0, r1) in self._rows.items():
            v = params[n]
            data = v.tensor() if isinstance(v, LieTensor) else v
            full = data.new_zeros((self._shape[n][0],) + data.shape[1:])
            full[r0:r1] = data
            parts[n] = full
        parts = all_reduce_sum(parts, self._node_group)
        out = dict(params)
        for n, full in parts.items():
            v = params[n]
            out[n] = LieTensor(full, ltype=v.ltype) \
                if isinstance(v, LieTensor) else full
        return out

    def _core(self, params, strat):
        if not self._rows:
            return super()._core(params, strat)
        p, *rest = super()._core(self.full_params(params), strat)
        return (self._shard_nodes(p), *rest)


class ShardedPGO:
    """Pose-graph optimisation with the relative-pose factor's edges
    sharded over a mesh axis, with the full LM semantics: a thin wrapper
    over :class:`ShardedLM` on one :func:`pgo_factor`.  ``node_axis`` (a
    2-D mesh) also shards the node state.  ``damping`` selects a
    ``Constant`` strategy; the default is ``TrustRegion(radius=1e4)``.
    Node 0 is fixed when ``fix_first``.  Ref:
    pypose_tpu/parallel/__init__.py:391-447."""

    def __init__(self, nodes, edges, poses, infos=None, kernel=None,
                 mesh=None, axis='dp', node_axis=None, strategy=None,
                 damping=None, cg_iter=50, cg_tol=1e-6, reject=16,
                 fix_first=True):
        n = nodes.lshape[0]
        if strategy is None:
            strategy = Constant(damping=damping) if damping is not None \
                else TrustRegion(radius=1e4)
        fixed = None
        if fix_first:
            fixed = {'poses': torch.zeros(n, dtype=torch.bool,
                                          device=nodes.device)}
            fixed['poses'][0] = True
        factor = pgo_factor(torch.as_tensor(edges), poses, infos, kernel)
        self.lm = ShardedLM({'poses': nodes}, [factor], mesh=mesh,
                            axis=axis, node_axis=node_axis,
                            strategy=strategy, fixed=fixed,
                            cg_iter=cg_iter, cg_tol=cg_tol, reject=reject)
        self.mesh = self.lm.mesh
        self.history = []

    def step(self):
        """One LM step (damping strategy and reject loop); returns the
        accepted chi2."""
        loss = self.lm.step()
        self.history.append(loss)
        return loss

    def run(self, steps):
        """``steps`` LM iterations in one ``optimize`` call (stops early
        only on a rejected step that makes no progress); returns the final
        chi2, with the history in ``self.history``."""
        loss = self.lm.optimize(steps=steps, patience=steps + 1,
                                decreasing=-float('inf'))
        self.history = list(self.lm.history)
        return loss

    @property
    def nodes(self):
        return self.result.tensor()

    @property
    def result(self):
        return self.lm.full_params()['poses']
