r"""EPnP: the efficient perspective-n-point solver.

Counterpart of ``pypose_tpu/module/pnp.py:20-258``.  Batched over leading
dims, as tensor operations on the inputs' device (the JAX package jits the
whole solve): the 12 x 12 ``eigh`` of M^T M (in float64 on CUDA, where
cuSOLVER's float32 one is the less accurate), the beta systems by
:class:`~pypose_tpu_torch.optim.LSTSQ`, the candidates' poses by
``svdtf``, and an optional Gauss-Newton refinement of the betas with a
straight-through gradient.  Matrix products run in full float32 (TF32
off), as the JAX package pins ``precision='float32'`` here.
"""

import torch

from ..nn import Module, Parameter
from ..function.linalg import bmv
from ..function.geometry import cart2homo, reprojerr, svdtf
from ..lietensor.lietensor import LieTensor, SE3_type
from ..optim.optimizer import GaussNewton
from ..optim.solver import LSTSQ
from ..optim.sparse import require_full_fp32


def _idx(seq, like):
    return torch.tensor(seq, device=like.device)


class BetaObjective(Module):
    """Residual of the distances between control points.  Ref:
    pypose_tpu/module/pnp.py:20-39."""

    def __init__(self, beta):
        super().__init__()
        self.beta = Parameter(torch.as_tensor(beta))
        self.i = (0, 0, 0, 1, 1, 2)
        self.j = (1, 2, 3, 2, 3, 3)

    def forward(self, base_w, nullv):
        base_c = bmv(nullv.mT, self.beta)
        base_c = base_c.reshape(base_c.shape[:-1] + (4, 3))
        i, j = _idx(self.i, base_c), _idx(self.j, base_c)
        dist_c = torch.linalg.norm(base_c[..., i, :] - base_c[..., j, :],
                                   dim=-1)
        dist_w = torch.linalg.norm(base_w[..., i, :] - base_w[..., j, :],
                                   dim=-1)
        return dist_w - dist_c


class EPnP(Module):
    r"""Batched EPnP solver: expresses the n world points in a basis of
    four control points, solves the camera-frame control points from the
    2n x 12 projection system (the null space of M^T M and the beta
    candidates for N = 1..4), keeps the candidate of least mean
    reprojection error, and optionally refines its betas by Gauss-Newton.
    Returns the world-to-camera SE3.

    ``refine=True`` runs :class:`~pypose_tpu_torch.optim.GaussNewton`
    with a dense Jacobian over the whole batch (6B x 4B): for small
    batches.

    Ref: pypose_tpu/module/pnp.py:42-258.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> from pypose_tpu_torch.module import EPnP
        >>> g = torch.Generator().manual_seed(0)
        >>> pts_cam = torch.rand(12, 3, generator=g) * \
        ...     torch.tensor([4., 4., 8.]) + torch.tensor([-2., -2., 4.])
        >>> T = pp.randn_SE3(sigma=(0.4, 0.2), generator=g)
        >>> K = torch.tensor([[500., 0., 320.], [0., 500., 240.],
        ...                   [0., 0., 1.]])
        >>> pix = pp.point2pixel(pts_cam, K)
        >>> world = T.Inv().unsqueeze(-2).Act(pts_cam)
        >>> pose = EPnP(intrinsics=K, refine=False)(world, pix)
        >>> err = (pose.Inv() @ T).Log().tensor()
        >>> bool(err.abs().max() < 1e-2)
        True
    """

    def __init__(self, intrinsics=None, refine=True):
        super().__init__()
        self.refine = refine
        self.solver = LSTSQ()
        if intrinsics is not None:
            self.register_buffer('intrinsics', intrinsics)

    def forward(self, points, pixels, intrinsics=None):
        assert pixels.shape[-2] == points.shape[-2] >= 4, \
            'Number of points/pixels cannot be smaller than 4.'
        intrinsics = self.intrinsics if intrinsics is None else intrinsics
        require_full_fp32(points.device)
        c = self._candidates(points, pixels, intrinsics.to(points.device))
        pose, beta, scale = self._best_solution(c['errors'], c['poses'],
                                                c['betas'], c['scales'])
        if self.refine:
            beta = self._refine(beta * scale, c['nullv'], c['bases'])
            pose, scale = self._compute_solution(beta, c['nullv'],
                                                 c['alpha'], points)
        return pose

    def _candidates(self, points, pixels, intrinsics):
        """The four candidate solutions (N = 1..4) on a leading axis: their
        betas, poses, scales and reprojection errors [4, *B, n], with the
        control points, barycentric coordinates and null space they come
        from.  Ref: pypose_tpu/module/pnp.py:97-105."""
        bases = self._svd_basis(points)
        alpha = self._compute_alpha(points, bases)
        nullv = self._compute_nullv(pixels, alpha, intrinsics)
        l_mat, rho = self._compute_lrho(nullv, bases)
        betas = self._compute_betas(l_mat, rho)
        poses, scales = self._compute_solution(betas, nullv, alpha, points)
        errors = reprojerr(points, pixels, intrinsics, poses,
                           reduction='norm')
        return dict(bases=bases, alpha=alpha, nullv=nullv, betas=betas,
                    poses=poses, scales=scales, errors=errors)

    def _compute_solution(self, beta, nullv, alpha, points):
        """The pose and scale of each set of betas.  A degenerate one
        (betas all 0, a 0/0 scale) gives a NaN pose, as in the JAX package;
        its points enter the alignment as 0, since LAPACK's SVD raises on
        NaN input.  Ref: pypose_tpu/module/pnp.py:112-117."""
        bases = bmv(nullv.mT, beta)
        bases, transp, scale = self._compute_scale(bases, alpha, points)
        ok = torch.isfinite(transp).all(-1).all(-1)
        pose = svdtf(points, torch.where(ok[..., None, None], transp, 0.0))
        pose = torch.where(ok[..., None], pose.tensor(), torch.nan)
        return LieTensor(pose, ltype=SE3_type), scale

    @staticmethod
    def _best_index(errors):
        """Each problem's candidate of least mean reprojection error.  A
        candidate whose betas all come out 0 (its first least-squares
        component exactly 0, which rounding gives now and then: 59 of
        10,000 float32 problems on the H100) has a 0/0 scale and a NaN
        error; ``jnp.argmin`` would pick it and return a NaN pose, so here
        it counts as +inf and is never picked."""
        return torch.argmin(torch.nan_to_num(errors.mean(dim=-1),
                                             nan=torch.inf), dim=0)

    def _best_solution(self, errors, poses, betas, scales):
        """The candidate of least mean reprojection error.  Ref:
        pypose_tpu/module/pnp.py:119-133."""
        idx = self._best_index(errors)

        def sel(arr):
            full = idx.reshape((1,) + idx.shape + (1,) * (arr.ndim
                                                         - idx.ndim - 1))
            full = full.expand((1,) + arr.shape[1:])
            return torch.take_along_dim(arr, full, dim=0)[0]

        return (LieTensor(sel(poses.tensor()), ltype=SE3_type), sel(betas),
                sel(scales))

    def _refine(self, beta, nullv, bases):
        """Gauss-Newton on the betas (the optimizer's loop core, 10 steps,
        patience 3) with a straight-through gradient.  Ref:
        pypose_tpu/module/pnp.py:135-148."""
        model = BetaObjective(beta.detach())
        optim = GaussNewton(model, solver=LSTSQ())
        inp = (bases.detach(), nullv.detach())
        p, _, _, _ = optim._optimize_run(optim._params(), inp, None, None,
                                         steps=10, patience=3,
                                         decreasing=1e-3)
        return beta + (p['beta'] - beta).detach()

    def _svd_basis(self, points):
        """Control points: the centroid and the principal axes scaled by
        the square roots of the covariance's singular values.  Ref:
        pypose_tpu/module/pnp.py:150-159."""
        center = points.mean(dim=-2, keepdim=True)
        translated = points - center
        _, s, vh = torch.linalg.svd(translated.mT @ translated)
        controls = center + torch.sqrt(s)[..., None] * vh.mT
        return torch.cat([center, controls], dim=-2)

    def _compute_alpha(self, points, bases):
        """Barycentric coordinates: x @ bases = points in homogeneous
        coordinates.  Ref: pypose_tpu/module/pnp.py:161-167."""
        points, bases = cart2homo(points), cart2homo(bases)
        return points @ torch.linalg.inv_ex(bases)[0]

    def _compute_nullv(self, pixels, alpha, intrinsics, least=4):
        """The four eigenvectors of M^T M of least eigenvalue, the least
        last.  Ref: pypose_tpu/module/pnp.py:169-191."""
        MtM = self._mtm(pixels, alpha, intrinsics)
        if MtM.device.type == 'cuda' and MtM.dtype == torch.float32:
            # cuSOLVER's batched float32 eigh (Jacobi) loses the null space
            # where LAPACK's keeps it: at 10,000 problems its pose errors
            # reach p99 9.0e-4 and max 2.2e-2 against the CPU's 5.6e-4 and
            # 2.1e-3 (NVIDIA H100); in float64 they fall below both
            eigenvectors = torch.linalg.eigh(MtM.double())[1].float()
        else:
            eigenvectors = torch.linalg.eigh(MtM)[1]
        nullv = eigenvectors[..., :least].mT
        return torch.flip(nullv, dims=(-2,))

    @staticmethod
    def _mtm(pixels, alpha, intrinsics):
        """M^T M of the projection equations M (2 n x 12) in the control
        points' camera coordinates."""
        batch, point = pixels.shape[:-2], pixels.shape[-2]
        u, v = pixels[..., 0], pixels[..., 1]
        fu, u0 = intrinsics[..., 0, 0, None], intrinsics[..., 0, 2, None]
        fv, v0 = intrinsics[..., 1, 1, None], intrinsics[..., 1, 2, None]
        a0, a1 = alpha[..., 0], alpha[..., 1]
        a2, a3 = alpha[..., 2], alpha[..., 3]
        O = torch.zeros_like(a1)
        M = torch.stack([
            a0 * fu, O, a0 * (u0 - u), a1 * fu, O, a1 * (u0 - u),
            a2 * fu, O, a2 * (u0 - u), a3 * fu, O, a3 * (u0 - u),
            O, a0 * fv, a0 * (v0 - v), O, a1 * fv, a1 * (v0 - v),
            O, a2 * fv, a2 * (v0 - v), O, a3 * fv, a3 * (v0 - v)],
            dim=-1).reshape(batch + (point * 2, 12))
        return M.mT @ M

    def _compute_lrho(self, nullv, bases):
        """L matrix and rho vector of the beta systems.  Ref:
        pypose_tpu/module/pnp.py:193-206."""
        nullv = nullv.reshape(nullv.shape[:-1] + (4, 3))
        i = _idx((1, 2, 3, 2, 3, 3), nullv)
        j = _idx((0, 0, 0, 1, 1, 2), nullv)
        dv = nullv[..., i, :] - nullv[..., j, :]
        a = _idx((0, 0, 1, 0, 1, 2, 0, 1, 2, 3), nullv)
        b = _idx((0, 1, 1, 2, 2, 2, 3, 3, 3, 3), nullv)
        dp = torch.sum(dv[..., a, :, :] * dv[..., b, :, :], dim=-1)
        m = torch.tensor([1, 2, 1, 2, 2, 1, 2, 2, 2, 1], dtype=dp.dtype,
                         device=dp.device)
        bi = _idx((0, 0, 0, 1, 1, 2), bases)
        bj = _idx((1, 2, 3, 2, 3, 3), bases)
        rho = torch.sum((bases[..., bi, :] - bases[..., bj, :]) ** 2, dim=-1)
        return dp.mT * m, rho

    def _compute_betas(self, l_mat, rho):
        """The betas for N = 1..4, stacked on a leading axis.  Ref:
        pypose_tpu/module/pnp.py:208-241."""
        betas = torch.zeros((4,) + rho.shape[:-1] + (4,), dtype=rho.dtype,
                            device=rho.device)
        sq = lambda x: torch.sqrt(torch.abs(x))  # noqa: E731
        betas[0, ..., -1] = 1
        # N = 2
        S = self.solver(l_mat[..., _idx((5, 8, 9), l_mat)], rho)
        betas[1, ..., 2] = sq(S[..., 0])
        betas[1, ..., 3] = sq(S[..., 2]) * torch.sign(S[..., 1]) \
            * torch.sign(S[..., 0])
        # N = 3
        S = self.solver(l_mat[..., _idx((2, 4, 7, 5, 8, 9), l_mat)], rho)
        betas[2, ..., 1] = sq(S[..., 0])
        betas[2, ..., 2] = sq(S[..., 3]) * torch.sign(S[..., 1]) \
            * torch.sign(S[..., 0])
        betas[2, ..., 3] = sq(S[..., 5]) * torch.sign(S[..., 2]) \
            * torch.sign(S[..., 0])
        # N = 4
        S = self.solver(l_mat, rho)
        betas[3, ..., 0] = sq(S[..., 9]) * torch.sign(S[..., 6]) \
            * torch.sign(S[..., 0])
        betas[3, ..., 1] = sq(S[..., 5]) * torch.sign(S[..., 3]) \
            * torch.sign(S[..., 0])
        betas[3, ..., 2] = sq(S[..., 2]) * torch.sign(S[..., 1]) \
            * torch.sign(S[..., 0])
        betas[3, ..., 3] = sq(S[..., 0])
        return betas

    def _compute_scale(self, bases, alpha, points):
        """Scale and sign of the control points.  Ref:
        pypose_tpu/module/pnp.py:243-258."""
        bases = bases.reshape(bases.shape[:-1] + (4, 3))
        transp = alpha @ bases
        dw = torch.linalg.norm(points - points.mean(dim=-2, keepdim=True),
                               dim=-1)
        dc = torch.linalg.norm(transp - transp.mean(dim=-2, keepdim=True),
                               dim=-1)
        scale = torch.sum(dc * dw, dim=-1) / torch.sum(dc * dc, dim=-1)
        bases = bases * scale[..., None, None]
        scalep = alpha @ bases
        mask = torch.any(scalep[..., 2] < 0, dim=-1)
        sign = torch.ones_like(scale) - mask * 2
        scalep = sign[..., None, None] * scalep
        scale = (sign * scale)[..., None]
        return bases, scalep, scale
