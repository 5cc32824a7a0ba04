r"""Bundle adjustment: Schur-complement Levenberg-Marquardt over cameras
and points.

Counterpart of ``pypose_tpu/optim/ba.py``.  The two-block structure
(cameras x points) is solved without forming J:

* per-observation residuals and tangent Jacobians (2x6 camera, 2x3
  point): the scalarized closed form for the BAL residual
  (``lietensor/scalarized.py:bal_reproj_blocks``), else a ``vmap`` of
  ``jacrev`` at eps = 0 through the Lie ops' autograd Functions;
* the point blocks ``Hpp`` (3x3) are eliminated in closed form
  (``ops/smallinv.py``);
* the reduced camera system ``S = Hcc - Hcp Hpp^-1 Hpc`` is solved either
  exactly (dense Schur: S formed by one Gram product of bf16-rounded
  operands with a float32 result, a Cholesky factor of S with a boosted
  diagonal, and ``schur_refine`` refinement passes against the exact
  operator) or by block-Jacobi preconditioned CG over the Schur matvec
  (``optim/solver.py:cg``); ``schur='auto'`` takes the JAX package's
  predicate, its TPU-padded byte estimate included;
* points follow by back-substitution.

Observations are sorted by camera at construction (stable), as in the JAX
package.  Camera-side sums over observations are gathers with masked sums
in a fixed order: over a per-camera incidence table, or, for problems of
at least ``CAM_WINDOW_MIN_O`` observations, per tile of 1024 consecutive
observations through a one-hot product into a window of at most 256
cameras and a per-camera gather of the tiles' partials (no atomics, so
the card repeats its bits).

The JAX package runs the reject loop and the plateau schedule in
``lax.while_loop``; here they are Python loops that read one host scalar
per damping retry and one per LM step (:data:`HOST_READS`), and the
Schur CG one per iteration (``solver.CG_HOST_READS``).
"""

import numpy as np
import torch

from ..lietensor.scalarized import bal_reproj_blocks
from ..lietensor.utils import SE3
from ..ops.smallinv import chol3x3, inv3x3, inv6x6
from .solver import cg
from .sparse import require_full_fp32
from .strategy import TrustRegion

# Host reads made by BundleAdjustment's LM loops in this process: one per
# damping retry and one per step.
HOST_READS = 0


def _gram_cols(A, B):
    """``einsum('oda,odb->oab')``: [O, d, a], [O, d, b] -> [O, a, b]."""
    return (A[:, :, :, None] * B[:, :, None, :]).sum(1)


def _vec_cols(A, r):
    """``einsum('oda,od->oa')``."""
    return (A * r[:, :, None]).sum(1)


def _mv_cols(A, x):
    """``einsum('oda,oa->od')``."""
    return (A * x[:, None, :]).sum(-1)


def reproj_residual_bal(pose, point, camera, pixel):
    """BAL reprojection residual: ``pose`` SE3 (world to camera),
    ``point`` (..., 3), ``camera`` (f, k1, k2), ``pixel`` (..., 2).  BAL
    projects with ``p = -X_c[:2] / X_c[2]`` and distorts radially."""
    Xc = pose.Act(point)
    p = -Xc[..., :2] / Xc[..., 2:3]
    r2 = torch.sum(p * p, -1, keepdim=True)
    distortion = 1.0 + camera[..., 1:2] * r2 + camera[..., 2:3] * r2 * r2
    return camera[..., 0:1] * distortion * p - pixel


def reproj_residual_pinhole(pose, point, intrinsics, pixel):
    """Pinhole reprojection residual, intrinsics (f, cx, cy)."""
    Xc = pose.Act(point)
    p = Xc[..., :2] / Xc[..., 2:3]
    return intrinsics[..., 0:1] * p + intrinsics[..., 1:3] - pixel


def _index_numpy(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _incidence(idx, n):
    """Per-row incidence table of an index list: (inc [n, D] int64, mask
    [n, D] bool, D), row i holding the positions of i's entries in
    ascending order (zero padded)."""
    deg = np.bincount(idx, minlength=n)
    D = int(deg.max()) if len(idx) else 0
    order = np.argsort(idx, kind='stable')
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    rows = idx[order]
    cols = np.arange(len(idx)) - start[rows]
    inc = np.zeros((n, max(D, 1)), np.int64)
    mask = np.zeros((n, max(D, 1)), bool)
    inc[rows, cols] = order
    mask[rows, cols] = True
    return inc, mask, D


def schur_operand(Yl18, cam_slot, incm, C, dtype=torch.bfloat16):
    """T1 [P * 3, 6 * C] (rows (p, j), columns (a, c)) of the dense Schur
    Gram, in ``dtype``: each incidence slot's Yl18 [P, D, 18] row, rounded
    to ``dtype``, summed into its camera's column in float32 slot by slot
    (within a slot every (point, camera) is distinct, so the sum has one
    order on every device), then rounded to ``dtype`` (bf16 by default;
    float32 leaves every value unrounded)."""
    P, D = cam_slot.shape
    Y = Yl18.to(dtype).to(torch.float32)
    T1 = torch.zeros(P, 18, C, dtype=torch.float32, device=Y.device)
    for d in range(D):
        T1.scatter_add_(2, cam_slot[:, d].view(P, 1, 1).expand(P, 18, 1),
                        torch.where(incm[:, d, None], Y[:, d], 0.0)
                        .unsqueeze(-1))
    return T1.to(dtype).reshape(P * 3, 6 * C)


def schur_gram(T1):
    """M = T1^T T1 [6 * C, 6 * C] in float32, indices (a, c) by (b, c'),
    of a bf16 or float32 ``T1``: a float32 product of the upcast values,
    with TF32 off on the card (products of bf16 values are exact in
    float32, so only the summation order is the device's)."""
    T = T1.to(torch.float32)
    return T.T @ T


class BundleAdjustment:
    r"""Schur-complement Levenberg-Marquardt for bundle adjustment.

    Args:
        poses: SE3 [C] camera poses (world to camera).
        points: [P, 3] world points.
        cam_idx, pt_idx: int [O] observation indices.
        pixels: [O, 2] observations.
        cameras: [O, k] or [C, k] intrinsics passed to ``residual``.
        residual: ``residual(pose, point, camera, pixel) -> (2,)`` for one
            observation (default: the BAL convention).
        strategy: ``TrustRegion`` (default), ``Adaptive`` or ``Constant``.
        fix_first_pose: gauge-fix camera 0.
        kernel: robust kernel on each observation's chi2.
        schur: ``'auto'``, ``'dense'`` or ``'cg'``.
        schur_precision: precision of the dense Schur Gram, the JAX
            package's ``jax.lax.Precision`` by name (``'default'``,
            ``'high'`` or ``'highest'``, any case, or an object whose
            ``str`` ends in one): ``None``, default or high form it from
            bf16-rounded operands and boost the factor's diagonal for the
            refinement; highest forms it from the float32 values and
            factors it as it is.
        schur_refine: refinement passes of the dense solve.

    Everything lives on the device of ``points``.

    Attributes:
        obs_valid: ``None`` or a bool mask [O] in the camera-sorted order
            (``mask[self._obs_perm]`` of a mask in the input order): an
            invalid observation adds nothing to chi2 under any kernel; its
            residual and Jacobians must already vanish (the zero-focal
            padding of ``parallel.ShardedBA``).  Ref:
            pypose_tpu/optim/ba.py:166-169, 414-415, 431-432.

    Example:
        >>> from pypose_tpu_torch.datasets import synthetic_bal
        >>> from pypose_tpu_torch.optim.ba import BundleAdjustment
        >>> ds = synthetic_bal(4, 60, 3, seed=0, device='cpu')
        >>> ba = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
        ...                       ds['pt_idx'], ds['pixels'], ds['cameras'],
        ...                       fix_first_pose=True, cg_iter=20)
        >>> loss = ba.optimize(steps=5, patience=5, decreasing=1e-3)
        >>> loss <= ba.history[0]
        True
    """

    # dense-Schur budget of the [P, 18, C] Gram operand (bytes), and C cap
    DENSE_SCHUR_BYTES = 5e9
    DENSE_SCHUR_MAX_C = 1024
    MAX_POINT_DEGREE = 64
    MAX_CAM_DEGREE = 8192
    # windowed one-hot camera operations: least observation count, window
    # cap, tile
    CAM_WINDOW_MIN_O = 8192
    CAM_WINDOW_MAX_W = 256
    CAM_WINDOW_TILE = 1024

    def __init__(self, poses, points, cam_idx, pt_idx, pixels, cameras,
                 residual=None, strategy=None, reject=16, min=1e-6,
                 max=1e32, cg_iter=50, cg_tol=1e-5, fix_first_pose=False,
                 kernel=None, schur='auto', schur_precision=None,
                 schur_refine=3):
        if schur not in ('auto', 'dense', 'cg'):
            raise ValueError(f"schur must be 'auto', 'dense' or 'cg', got "
                             f'{schur!r}')
        precision = 'default' if schur_precision is None else \
            str(schur_precision).rsplit('.', 1)[-1].lower()
        if precision not in ('default', 'high', 'highest'):
            raise ValueError("schur_precision must be None, 'default', "
                             f"'high' or 'highest', got {schur_precision!r}")
        self.device = points.device
        self.dtype = points.dtype
        require_full_fp32(self.device)
        self.poses, self.points = poses, points
        self.C = poses.lshape[0]
        self.P = points.shape[0]
        ci = _index_numpy(cam_idx).astype(np.int64)
        pi = _index_numpy(pt_idx).astype(np.int64)
        if cameras.shape[0] == self.C:
            cameras = cameras[torch.as_tensor(ci, device=cameras.device)]
        # sort the observations by camera (stable): every consumer reduces
        # over observations, and the camera-side sums then run over
        # contiguous tiles
        perm = np.argsort(ci, kind='stable')
        self._obs_perm = perm
        if not np.array_equal(perm, np.arange(len(perm))):
            ci, pi = ci[perm], pi[perm]
            tp = torch.as_tensor(perm, device=pixels.device)
            pixels, cameras = pixels[tp], cameras[tp.to(cameras.device)]
        self._ci, self._pi = ci, pi
        self.cam_idx = torch.as_tensor(ci, device=self.device)
        self.pt_idx = torch.as_tensor(pi, device=self.device)
        self.pixels = pixels.to(self.device)
        self.cameras = cameras.to(self.device)
        self.residual = reproj_residual_bal if residual is None else residual
        self.strategy = TrustRegion() if strategy is None else strategy
        self.kernel = kernel
        self.min, self.max = min, max
        self.reject = reject
        self.cg_iter, self.cg_tol = cg_iter, cg_tol
        self.fix_first_pose = fix_first_pose
        self.schur = schur
        # bf16-product Grams (default and high alike: products of bf16
        # values are exact in float32) or a float32 one (highest)
        self.schur_precision = precision
        self.schur_refine = schur_refine
        self.obs_valid = None
        self.strategy_state = None
        self.loss = self.last = None
        self.reject_count = 0
        self.history = []
        self.cg_iterations = []
        self._build_point_incidence()
        self._build_cam_windows()
        self._pick_schur_mode()

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    def _pick_schur_mode(self):
        """Dense reduced camera system where C and the Gram operand fit the
        JAX package's budget (its TPU estimate: ohp [P, D, C] and T1 [P, 18,
        C] in float32 with C padded to a multiple of 128), else Schur-CG."""
        if self.schur == 'cg':
            self._use_dense_schur = False
            return
        ok = self._pt_inc is not None and self.C <= self.DENSE_SCHUR_MAX_C
        if ok:
            D = self._pt_inc[0].shape[1]
            cpad = -(-self.C // 128) * 128
            ok = self.P * (D + 18) * cpad * 4 < self.DENSE_SCHUR_BYTES
        if self.schur == 'dense' and not ok:
            raise ValueError('dense Schur requested but problem exceeds '
                             'the dense-S budget (C=%d, P=%d)' %
                             (self.C, self.P))
        self._use_dense_schur = ok

    def _build_point_incidence(self):
        """Incidence tables of points (degree up to ``MAX_POINT_DEGREE``)
        and cameras (up to ``MAX_CAM_DEGREE``); past its cap a side sums
        by a segment sum over its observations sorted by row."""
        inc, mask, D = _incidence(self._pi, self.P)
        self._pt_inc = None if D > self.MAX_POINT_DEGREE else \
            (self._tensor(inc), self._tensor(mask))
        inc, mask, D = _incidence(self._ci, self.C)
        self._cam_inc = None if D > self.MAX_CAM_DEGREE else \
            (self._tensor(inc), self._tensor(mask))
        self._pt_seg = self._segments(self._pi, self.P, self._pt_inc)
        self._cam_seg = self._segments(self._ci, self.C, self._cam_inc)

    def _segments(self, idx, n, table):
        """Without an incidence ``table``, (order, lengths): the
        observations sorted by ``idx`` (stable) and each row's count, for
        the segment sum."""
        if table is not None:
            return None
        return (self._tensor(np.argsort(idx, kind='stable')),
                self._tensor(np.bincount(idx, minlength=n)))

    def _build_cam_windows(self):
        """Tile and window metadata of the camera-sorted observations:
        tile t of ``CAM_WINDOW_TILE`` observations touches cameras c0[t]
        .. c0[t] + W - 1.  ``oh`` [n_tiles, To, W] is each tile's one-hot
        (0/1, exact in every dtype); ``seg`` [C, S] lists, for each
        camera, the flat (tile, slot) partials that hold it, in tile
        order, with its mask."""
        self._cam_win = None
        ci = self._ci
        O, To = len(ci), self.CAM_WINDOW_TILE
        if O < self.CAM_WINDOW_MIN_O:
            return
        n_tiles = -(-O // To)
        ci_pad = np.concatenate([ci, np.full(n_tiles * To - O, ci[-1])])
        tiles = ci_pad.reshape(n_tiles, To)
        c0 = tiles[:, 0]
        W = int((tiles[:, -1] - c0).max()) + 1
        if W > self.CAM_WINDOW_MAX_W:
            return
        li = tiles - c0[:, None]
        widx = c0[:, None] + np.arange(W)[None, :]
        wvalid = widx < self.C
        widx = np.where(wvalid, widx, self.C)          # C: a dropped slot
        seg, segm, _ = _incidence(widx.reshape(-1), self.C + 1)
        oh = li[:, :, None] == np.arange(W)[None, None, :]
        self._cam_win = dict(
            li=self._tensor(li), widx=self._tensor(widx),
            wvalid=self._tensor(wvalid),
            oh=self._tensor(oh).to(self.dtype),
            seg=(self._tensor(seg[:self.C]), self._tensor(segm[:self.C])))

    def _obs_data(self):
        """The per-observation arrays and tables, as one dict (a test may
        pass a copy without ``cam_win`` to take the gather forms)."""
        return dict(cam_idx=self.cam_idx, pt_idx=self.pt_idx,
                    pixels=self.pixels, cameras=self.cameras,
                    obs_valid=self.obs_valid, pt_inc=self._pt_inc,
                    cam_inc=self._cam_inc, cam_win=self._cam_win,
                    pt_seg=self._pt_seg, cam_seg=self._cam_seg)

    # ------------------------------------------------------------------
    # camera and point sums
    # ------------------------------------------------------------------
    def _bcast_cams(self, obs, x):
        """Per-camera rows to per-observation rows, ``x[cam_idx]``: through
        the tiles' one-hots when windowed (exact: one 1 a row)."""
        win = obs.get('cam_win')
        if win is None:
            return x[obs['cam_idx']]
        n_tiles, To = win['li'].shape
        xw = x[torch.where(win['wvalid'], win['widx'], 0)]      # [t, W, k]
        xw = torch.where(win['wvalid'][..., None], xw, 0.0)
        out = torch.bmm(win['oh'].to(x.dtype), xw)
        return out.reshape(n_tiles * To, -1)[:obs['cam_idx'].shape[0]]

    @staticmethod
    def _masked_sum(contrib, inc_mask):
        inc, mask = inc_mask
        return torch.where(mask[..., None], contrib[inc], 0.0).sum(1)

    @staticmethod
    def _segment_sum(contrib, seg):
        order, lengths = seg
        return torch.segment_reduce(contrib[order], 'sum', lengths=lengths,
                                    axis=0)

    def _acc_cams(self, obs, contrib):
        """[O, ...] -> [C, ...] sum over each camera's observations."""
        tail = contrib.shape[1:]
        flat = contrib.reshape(contrib.shape[0], -1)
        win = obs.get('cam_win')
        if win is not None:
            # per tile, the window's partials by one product with the
            # one-hot; then each camera's partials gathered in tile order
            n_tiles, To = win['li'].shape
            k = flat.shape[1]
            pad = flat.new_zeros(n_tiles * To - flat.shape[0], k)
            ct = torch.cat([flat, pad]).reshape(n_tiles, To, k)
            part = torch.bmm(win['oh'].to(flat.dtype).transpose(1, 2), ct)
            out = self._masked_sum(part.reshape(-1, k), win['seg'])
        elif obs['cam_inc'] is not None:
            out = self._masked_sum(flat, obs['cam_inc'])
        else:
            out = self._segment_sum(flat, obs['cam_seg'])
        return out.reshape((self.C,) + tail)

    def _acc_points(self, obs, contrib):
        """[O, ...] -> [P, ...] sum over each point's observations."""
        tail = contrib.shape[1:]
        flat = contrib.reshape(contrib.shape[0], -1)
        if obs['pt_inc'] is not None:
            out = self._masked_sum(flat, obs['pt_inc'])
        else:
            out = self._segment_sum(flat, obs['pt_seg'])
        return out.reshape((self.P,) + tail)

    # ------------------------------------------------------------------
    # formation
    # ------------------------------------------------------------------
    def _r_jac(self, obs, poses_data, points):
        """Residuals and per-observation tangent Jacobians: (r [O, 2],
        Jc [O, 2, 6], Jp [O, 2, 3])."""
        Tc = self._bcast_cams(obs, poses_data)
        Xp = points[obs['pt_idx']]
        if self.residual is reproj_residual_bal:
            return bal_reproj_blocks(Tc, Xp, obs['cameras'], obs['pixels'])
        residual = self.residual

        def one(tc, xp, cam, pix):
            def f(eps_c, eps_p):
                return residual(SE3(tc).add(eps_c), xp + eps_p, cam, pix)
            z6 = torch.zeros(6, dtype=tc.dtype, device=tc.device)
            z3 = torch.zeros(3, dtype=tc.dtype, device=tc.device)
            Jc, Jp = torch.func.jacrev(f, argnums=(0, 1))(z6, z3)
            return f(z6, z3), Jc, Jp

        return torch.func.vmap(one)(Tc, Xp, obs['cameras'], obs['pixels'])

    def _robust_scale(self, r):
        if self.kernel is None:
            return torch.ones_like(r[:, :1])
        with torch.enable_grad():
            chi = torch.sum(r * r, -1, keepdim=True).detach().requires_grad_()
            g1, = torch.autograd.grad(self.kernel(chi).sum(), chi)
        return torch.sqrt(torch.clamp(g1, min=0.0))

    def _reduce(self, sums):
        """Sums over the observations, from the partial sums over the
        observations this optimizer holds: the identity here;
        ``parallel.ShardedBA`` all-reduces them over its ranks."""
        return sums

    def _sum_chi2(self, r, obs):
        chi = torch.sum(r * r, -1)
        if self.kernel is not None:
            chi = self.kernel(chi)
        if obs.get('obs_valid') is not None:
            chi = torch.where(obs['obs_valid'], chi, 0.0)
        return self._reduce(torch.sum(chi))

    def _chi2(self, poses_data, points, obs=None):
        """chi2 of the residual of one observation, vmapped."""
        obs = self._obs_data() if obs is None else obs
        residual = self.residual
        return self._sum_chi2(torch.func.vmap(
            lambda t, x, c, p: residual(SE3(t), x, c, p))(
            self._bcast_cams(obs, poses_data), points[obs['pt_idx']],
            obs['cameras'], obs['pixels']), obs)

    def _mask_cam(self, x):
        if self.fix_first_pose:
            return x.index_fill(0, torch.zeros(1, dtype=torch.int64,
                                               device=x.device), 0.0)
        return x

    @staticmethod
    def _damped(H, damping, lo, hi):
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        d = torch.clamp(diag, lo, hi) * (1.0 + damping)
        eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        return H + (d - diag)[..., None] * eye

    # ------------------------------------------------------------------
    # one LM step
    # ------------------------------------------------------------------
    def _core(self, poses_data, points, strat, obs):
        """One LM step: formation, then damping retries until a step is
        taken or the reject budget is spent.  Returns (poses, points,
        loss, last, strategy state, rejections, CG iterations per
        solve)."""
        global HOST_READS
        r, Jc, Jp = self._r_jac(obs, poses_data, points)
        # the current chi2 from the residuals in hand
        last = self._sum_chi2(r, obs)
        s = self._robust_scale(r)
        r = s * r
        Jc = s[..., None] * Jc
        Jp = s[..., None] * Jp
        pi = obs['pt_idx']

        bc = self._mask_cam(-self._acc_cams(obs, _vec_cols(Jc, r)))
        bp = -self._acc_points(obs, _vec_cols(Jp, r))
        Hcc = self._acc_cams(obs, _gram_cols(Jc, Jc))
        Hpp = self._acc_points(obs, _gram_cols(Jp, Jp))
        dense = self._dense_pieces(obs, Jc, Jp) if self._use_dense_schur \
            else None

        def solve(damping):
            Hcc_d = self._damped(Hcc, damping, self.min, self.max)
            Hpp_inv = inv3x3(self._damped(Hpp, damping, self.min, self.max))

            # Schur rhs: bs = bc - Hcp Hpp^-1 bp
            JpY = _mv_cols(Jp, _mv_cols(Hpp_inv, bp)[pi])
            bs = bc - self._mask_cam(self._acc_cams(obs, _vec_cols(Jc, JpY)))

            def Svp(x):
                x = self._mask_cam(x)
                hx = _mv_cols(Hcc_d, x)
                Jcx = _mv_cols(Jc, self._bcast_cams(obs, x))
                w = _mv_cols(Hpp_inv, self._acc_points(obs, _vec_cols(Jp,
                                                                      Jcx)))
                JpW = _mv_cols(Jp, w[pi])
                return self._mask_cam(hx - self._acc_cams(obs, _vec_cols(
                    Jc, JpW)))

            if dense is not None:
                dc, it = self._dense_solve(dense, Hcc_d, Hpp_inv, bs, Svp), 0
            else:
                Minv = inv6x6(Hcc_d)

                def M(x):
                    return {'c': self._mask_cam(
                        _mv_cols(Minv, self._mask_cam(x['c'])))}
                x, it = cg(lambda x: {'c': Svp(x['c'])}, {'c': bs},
                           tol=self.cg_tol, maxiter=self.cg_iter, M=M)
                dc = x['c']
            dc = self._mask_cam(dc)
            # back-substitute the points: dp = Hpp^-1 (bp - Hpc dc)
            Jcdc = _mv_cols(Jc, self._bcast_cams(obs, dc))
            Hpcdc = self._acc_points(obs, _vec_cols(Jp, Jcdc))
            return dc, _mv_cols(Hpp_inv, bp - Hpcdc), it

        def pred_reduction(dc, dp):
            Jd = _mv_cols(Jc, self._bcast_cams(obs, dc)) + _mv_cols(Jp, dp[pi])
            return -self._reduce(torch.sum(Jd * (2.0 * r + Jd)))

        count, its = 0, []
        while True:
            dc, dp, it = solve(strat['damping'])
            its.append(it)
            bad = ~(torch.isfinite(dc).all() & torch.isfinite(dp).all())
            dc = torch.where(bad, 0.0, dc)
            dp = torch.where(bad, 0.0, dp)
            T_new = SE3(poses_data).add(dc).tensor()
            X_new = points + dp
            loss_new = self._chi2(T_new, X_new, obs)
            # a non-finite candidate loss is as bad as a non-finite delta
            bad = bad | ~torch.isfinite(loss_new)
            pred = pred_reduction(dc, dp)
            q = (last - loss_new) / torch.where(pred == 0, 1e-31, pred)
            # a non-positive predicted reduction (the local model says the
            # step does not descend) is a hard reject
            q = torch.where(pred > 0, q, -1.0)
            strat = self.strategy.step(strat, q)
            HOST_READS += 1
            if count < self.reject and bool((last < loss_new) & ~bad):
                count += 1
                continue
            take = ~bad
            return (torch.where(take, T_new, poses_data),
                    torch.where(take, X_new, points),
                    torch.where(take, loss_new, last), last, strat, count,
                    its)

    def _dense_pieces(self, obs, Jc, Jp):
        """The damping-free pieces of the dense reduced camera system: the
        camera-point coupling blocks gathered per point, Gp18 [P, D, 18]
        (index a * 3 + k), and each incidence slot's camera [P, D]."""
        inc, incm = obs['pt_inc']
        G18 = _gram_cols(Jc, Jp).reshape(-1, 18)
        Gp18 = G18[inc] * incm[..., None]
        return Gp18, obs['cam_idx'][inc], incm

    def _dense_solve(self, pieces, Hcc_d, Hpp_inv, bs, Svp):
        """The reduced camera system, formed and factored: S = Hcc_d -
        (L^T Hpc)^T (L^T Hpc) with Hpp^-1 = L L^T, the Gram over (P, 3)
        by :func:`schur_operand` (bf16) and :func:`schur_gram` (float32).
        The factor of S with its diagonal boosted is a preconditioner for
        ``schur_refine`` passes against the exact operator ``Svp``; a
        factor that fails (S not positive definite) gives a NaN step."""
        C = self.C
        highest = self.schur_precision == 'highest'
        M = self._schur_M(Hpp_inv, *pieces)
        Mfull = M.reshape(6, C, 6, C).permute(1, 0, 3, 2).reshape(6 * C,
                                                                  6 * C)
        ar = torch.arange(C, device=Hcc_d.device)
        Sd = torch.zeros(C, 6, C, 6, dtype=Hcc_d.dtype, device=Hcc_d.device)
        Sd[ar, :, ar, :] = Hcc_d
        S = Sd.reshape(6 * C, 6 * C) - Mfull
        if self.fix_first_pose:
            # gauge: camera 0's unknowns become identity rows
            S[:6, :] = 0.0
            S[:, :6] = 0.0
            S[torch.arange(6), torch.arange(6)] = 1.0
        if self.schur_refine > 0 and not highest:
            # the bf16-formed S can lose positive-definiteness at small
            # damping; as a preconditioner for the refinement its diagonal
            # is boosted
            dS = torch.diagonal(S)
            S = S + torch.diag(1e-2 * dS + 4e-3 * torch.mean(dS))
        Lc, info = torch.linalg.cholesky_ex(S)
        failed = info != 0

        def cho_solve(rhs):
            x = torch.cholesky_solve(rhs.reshape(-1, 1), Lc).reshape(C, 6)
            return torch.where(failed, torch.nan, x)

        dc = cho_solve(bs)
        for _ in range(self.schur_refine):
            dc = dc + cho_solve(bs - Svp(dc))
        return dc

    def _schur_M(self, Hpp_inv, Gp18, cam_slot, incm):
        """M = T1^T T1 [6 C, 6 C], the Gram of the points' eliminated
        couplings: a sum over points (``parallel.ShardedBA`` forms it over
        its share of the points and all-reduces it)."""
        L = chol3x3(Hpp_inv)
        # Yl[p, d, j * 6 + a] = sum_k L[p, k, j] Gp[p, d, a * 3 + k]
        Yl18 = torch.stack(
            [sum(L[:, k, j][:, None] * Gp18[:, :, a * 3 + k]
                 for k in range(3))
             for j in range(3) for a in range(6)], dim=-1)
        return schur_gram(schur_operand(
            Yl18, cam_slot, incm, self.C,
            torch.float32 if self.schur_precision == 'highest'
            else torch.bfloat16))

    # ------------------------------------------------------------------
    def _init_strategy(self):
        if self.strategy_state is None:
            self.strategy_state = self.strategy.init(self.dtype, self.device)

    def step(self):
        """One LM step; returns the new chi2."""
        global HOST_READS
        self._init_strategy()
        T, X, loss, last, strat, count, its = self._core(
            self.poses.tensor(), self.points, self.strategy_state,
            self._obs_data())
        self.poses, self.points, self.strategy_state = SE3(T), X, strat
        HOST_READS += 1
        self.loss, self.last = torch.stack([loss, last]).tolist()
        self.reject_count = count
        self.cg_iterations = [its]
        return self.loss

    def optimize(self, steps=10, patience=5, decreasing=1e-3):
        """Run up to ``steps`` LM steps with the StopOnPlateau rule: stop
        after ``patience`` steps whose chi2 fell by less than
        ``decreasing``, or after a step with rejections that also fell by
        less than that (the reference quits on any rejection).  Returns
        the final chi2; per-step values (float32, as the JAX package
        keeps them) land in ``self.history``, rejections in
        ``self.rejections`` and CG iterations per solve in
        ``self.cg_iterations``."""
        global HOST_READS
        self._init_strategy()
        T, X, strat = self.poses.tensor(), self.points, self.strategy_state
        obs = self._obs_data()
        hist, rejections, its_all = [], [], []
        pat = 0
        for _ in range(steps):
            T, X, loss, last, strat, count, its = self._core(T, X, strat, obs)
            HOST_READS += 1
            lossv, small = torch.stack(
                [loss.to(torch.float32),
                 (last - loss < decreasing).to(torch.float32)]).tolist()
            hist.append(lossv)
            rejections.append(count)
            its_all.append(its)
            pat = pat + 1 if small else 0
            if pat >= patience or (count > 0 and small):
                break
        self.poses, self.points, self.strategy_state = SE3(T), X, strat
        self.history = hist
        self.rejections = rejections
        self.cg_iterations = its_all
        self.loss = hist[-1] if hist else None
        return self.loss
