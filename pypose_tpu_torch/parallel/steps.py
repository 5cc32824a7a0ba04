r"""The raw fixed-damping sharded steps: :func:`make_pgo_step` and
:func:`make_ba_step`.

Counterpart of ``pypose_tpu/parallel/__init__.py:54-205``: plain
functions on tensors, with no reject loop, no damping strategy and no
kernels or information matrices, kept for sharding measurements (the
full LM semantics on a mesh are :class:`ShardedPGO` and
:class:`ShardedBA`).  Each rank passes its own slice of the edges or
observations (``shard_leading(x, mesh, axis).to_local()``; the slices
need not be equal) and the full node state; each sum over edges or
observations is a partial sum completed by one ``all_reduce`` over
``axis`` (none without a mesh), and the CG (``optim/solver.py:cg``) runs
replicated.
"""

import torch

from ..lietensor.jacobian import se3_Jl_inv
from ..lietensor.operation import SE3_Adj
from ..lietensor.scalarized import bal_reproj_blocks
from ..lietensor.utils import SE3
from ..ops.smallinv import inv3x3, inv6x6
from ..optim.ba import _gram_cols, _mv_cols, _vec_cols
from ..optim.solver import cg
from .mesh import all_reduce_sum


def _summer(mesh, axis):
    """Sums over the ranks of ``axis``: ``all_reduce_sum`` over its group,
    or the identity without a mesh."""
    if mesh is None:
        return lambda sums: sums
    group = mesh.get_group(axis)
    return lambda sums: all_reduce_sum(sums, group)


def _scatter(n, idx, rows):
    """[n, ...] sums of ``rows`` [E, ...] at ``idx`` [E] (scatter-add)."""
    return rows.new_zeros((n,) + rows.shape[1:]).index_add_(0, idx, rows)


def _zero_row0(x):
    return x.index_fill(0, torch.zeros(1, dtype=torch.int64,
                                       device=x.device), 0.0)


def make_pgo_step(n_nodes, damping=1e-4, cg_iter=50, cg_tol=1e-6,
                  mesh=None, axis='dp'):
    r"""A raw fixed-damping Gauss-Newton step of SE3 pose-graph
    optimisation, node 0 fixed:

        step(nodes_data [N, 7], edges [E, 2], Z_data [E, 7])
            -> (new_nodes_data, chi2)

    ``edges`` and ``Z_data`` are this rank's slice of the edges; chi2 is
    the whole graph's.  The Jacobian is the closed form ``J_j =
    Jl^-1(r) Adj(Z^-1 X_i^-1)``, ``J_i = -J_j``; a diagonally
    preconditioned CG of ``cg_iter`` iterations at most.  Ref:
    pypose_tpu/parallel/__init__.py:54-124."""
    psum = _summer(mesh, axis)

    def step(nodes_data, edges, Z_data):
        N = n_nodes
        X = SE3(nodes_data)
        Xi, Xj, Z = X[edges[:, 0]], X[edges[:, 1]], SE3(Z_data)
        M = Z.Inv() @ Xi.Inv()
        r = (M @ Xj).Log().tensor()
        Jj = torch.matmul(se3_Jl_inv(r), SE3_Adj(M.tensor()))
        J = torch.stack([-Jj, Jj], dim=2)                  # [E, 6, 2, 6]
        idx = edges.reshape(-1)
        contrib = torch.einsum('edat,ed->eat', J, r).reshape(-1, 6)
        b, diag, chi2 = psum((-_scatter(N, idx, contrib),
                              _scatter(N, idx, torch.sum(J * J, 1)
                                       .reshape(-1, 6)),
                              torch.sum(r * r)))
        b = _zero_row0(b)
        diag = torch.clamp(diag, 1e-6, 1e32)

        def Avp(x):
            x = _zero_row0(x['x'])
            Jx = torch.einsum('edat,eat->ed', J, x[edges])
            y = psum(_scatter(N, idx, torch.einsum('edat,ed->eat', J, Jx)
                              .reshape(-1, 6)))
            return {'x': _zero_row0(y + damping * diag * x)}

        Minv = 1.0 / ((1.0 + damping) * diag)
        delta, _ = cg(Avp, {'x': b}, tol=cg_tol, maxiter=cg_iter,
                      M=lambda v: {'x': Minv * v['x']})
        return X.add(_zero_row0(delta['x'])).tensor(), chi2

    return step


def make_ba_step(n_cams, n_points, damping=1e-4, cg_iter=30, cg_tol=1e-6,
                 mesh=None, axis='dp'):
    r"""A raw fixed-damping Schur-complement step of BAL bundle
    adjustment, camera 0 fixed:

        step(poses_data [C, 7], points [P, 3], cam_idx [O], pt_idx [O],
             pixels [O, 2], cameras [O, 3]) -> (new_poses_data,
                                                new_points, chi2)

    The observation arrays are this rank's slice; chi2 is the whole
    problem's.  Jacobians from the closed form
    (``lietensor/scalarized.py:bal_reproj_blocks``); the point blocks are
    eliminated, and the reduced camera system is solved by CG
    preconditioned with its inverted diagonal blocks.  Ref:
    pypose_tpu/parallel/__init__.py:127-205."""
    psum = _summer(mesh, axis)

    def step(poses_data, points, cam_idx, pt_idx, pixels, cameras):
        C, P = n_cams, n_points
        r, Jc, Jp = bal_reproj_blocks(poses_data[cam_idx], points[pt_idx],
                                      cameras, pixels)
        bc, bp, Hcc, Hpp, chi2 = psum((
            -_scatter(C, cam_idx, _vec_cols(Jc, r)),
            -_scatter(P, pt_idx, _vec_cols(Jp, r)),
            _scatter(C, cam_idx, _gram_cols(Jc, Jc)),
            _scatter(P, pt_idx, _gram_cols(Jp, Jp)), torch.sum(r * r)))
        bc = _zero_row0(bc)

        def damped(H):
            diag = torch.diagonal(H, dim1=-2, dim2=-1)
            d = torch.clamp(diag, 1e-6, 1e32) * (1.0 + damping)
            eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
            return H + (d - diag)[..., None] * eye

        Hcc_d, Hpp_inv = damped(Hcc), inv3x3(damped(Hpp))
        y = _mv_cols(Hpp_inv, bp)
        JpY = _mv_cols(Jp, y[pt_idx])
        bs = _zero_row0(bc - psum(_scatter(C, cam_idx, _vec_cols(Jc, JpY))))

        def Svp(x):
            x = _zero_row0(x['c'])
            hx = _mv_cols(Hcc_d, x)
            Jcx = _mv_cols(Jc, x[cam_idx])
            w = _mv_cols(Hpp_inv, psum(_scatter(P, pt_idx,
                                                _vec_cols(Jp, Jcx))))
            JpW = _mv_cols(Jp, w[pt_idx])
            hx = hx - psum(_scatter(C, cam_idx, _vec_cols(Jc, JpW)))
            return {'c': _zero_row0(hx)}

        Minv = inv6x6(Hcc_d)
        x, _ = cg(Svp, {'c': bs}, tol=cg_tol, maxiter=cg_iter,
                  M=lambda v: {'c': _mv_cols(Minv, v['c'])})
        dc = _zero_row0(x['c'])
        Jcdc = _mv_cols(Jc, dc[cam_idx])
        Hpcdc = psum(_scatter(P, pt_idx, _vec_cols(Jp, Jcdc)))
        dp = _mv_cols(Hpp_inv, bp - Hpcdc)
        return SE3(poses_data).add(dc).tensor(), points + dp, chi2

    return step
