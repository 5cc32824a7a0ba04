r"""IMU preintegration (Forster et al.) on associative scans.

Counterpart of ``pypose_tpu/module/imu_preintegrator.py``.  The SO3
increment product is the O(log F) quaternion scan of
``basics/ops.py:_cum_quat``; the 9x9 covariance is the O(F) closed form
(``_cov_closed``): one reverse quaternion scan, reverse cumsums and
scalarized 3x3 products.  It runs eagerly (the JAX package jits the
pipeline; here every operation is its own launch on the card).
"""

import torch

from ..basics.ops import associative_scan, cumprod
from ..lietensor.lietensor import LieTensor
from ..lietensor.utils import identity_SO3, so3
from ..nn import Module


def _cumsum(x, dim=1):
    """Inclusive sum over ``dim``, accumulated in float64 for float32
    input (as torch's CPU cumsum does; its CUDA one would accumulate in
    float32), so the card and the CPU agree, and scanned along the last
    dimension (a scan over an outer dimension runs one thread a column on
    the card)."""
    y = torch.cumsum(x.movedim(dim, -1), dim=-1,
                     dtype=torch.float64 if x.dtype == torch.float32
                     else None)
    return y.to(x.dtype).movedim(-1, dim)


def _check(obj):
    """[D] -> [1, 1, D], [F, D] -> [1, F, D] (tensors and LieTensors)."""
    if obj is not None:
        if len(obj.shape) == 2:
            obj = obj[None, ...]
        elif len(obj.shape) == 1:
            obj = obj[None, None, ...]
    return obj


class IMUPreintegrator(Module):
    r"""Propagates IMU measurements (gyro and accelerometer) between
    discrete frames, with optional 9x9 covariance propagation.

    Integration state (``pos``, ``rot``, ``vel``, ``cov`` and the
    covariance rotation ``Rij``) persists across calls unless
    ``reset=True``.  The buffers are made in ``dtype`` on ``device`` and
    follow the inputs' device at each call.

    Ref: pypose_tpu/module/imu_preintegrator.py:17 (``__init__`` :45,
    ``forward`` :76, ``integrate`` :147, ``predict`` :182,
    ``propagate_cov`` :196 with its closed form ``_cov_closed``
    :372-500).

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.module import IMUPreintegrator
        >>> integ = IMUPreintegrator(reset=True)
        >>> F = 10
        >>> dt = torch.full((1, F, 1), 0.01)
        >>> gyro = torch.zeros(1, F, 3)                  # stationary IMU
        >>> acc = torch.tensor([0., 0., 9.81007]).expand(1, F, 3)
        >>> out = integ(dt, gyro, acc)
        >>> bool(out['pos'][0, -1].abs().max() < 1e-5)   # no motion
        True
        >>> out['cov'].shape
        torch.Size([1, 9, 9])
    """

    def __init__(self, pos=None, rot=None, vel=None, gravity=9.81007,
                 gyro_cov=(3.2e-3) ** 2, acc_cov=(8e-2) ** 2,
                 prop_cov=True, reset=False, dtype=torch.float32,
                 device=None):
        super().__init__()
        if not reset and not prop_cov:
            raise RuntimeError(
                '"prop_cov" and "reset" cannot be False simultaneously.')
        self.prop_cov, self.reset = prop_cov, reset
        kw = dict(dtype=dtype, device=device)
        pos = torch.zeros(3, **kw) if pos is None else pos
        rot = identity_SO3(**kw) if rot is None else rot
        vel = torch.zeros(3, **kw) if vel is None else vel
        if isinstance(acc_cov, float):
            acc_cov = torch.tensor([[acc_cov] * 3], **kw)
        if isinstance(gyro_cov, float):
            gyro_cov = torch.tensor([[gyro_cov] * 3], **kw)
        self.register_buffer('gravity', torch.tensor([0., 0., gravity], **kw))
        # a given state keeps its dtype and goes to ``device``
        self.register_buffer('pos', _check(torch.as_tensor(pos,
                                                           device=device)))
        self.register_buffer('rot', _check(rot if device is None
                                           else rot.to(device)))
        self.register_buffer('vel', _check(torch.as_tensor(vel,
                                                           device=device)))
        self.register_buffer('cov', torch.zeros(1, 9, 9, **kw))
        self.register_buffer('gyro_cov', gyro_cov)
        self.register_buffer('acc_cov', acc_cov)
        self.Rij = None

    def forward(self, dt, gyro, acc, rot=None, gyro_cov=None, acc_cov=None,
                init_state=None):
        """Ref: pypose_tpu/module/imu_preintegrator.py:76-120."""
        assert 0 < acc.dim() == torch.as_tensor(dt).dim() == gyro.dim() <= 3
        acc, gyro, dt = _check(acc), _check(gyro), _check(torch.as_tensor(dt))
        rot = _check(rot) if rot is not None else None
        if self.gravity.device != dt.device:
            self.to(dt.device)
            if self.Rij is not None:
                self.Rij = self.Rij.to(dt.device)
        B = dt.shape[0]

        if init_state is None:
            init_state = {'pos': self.pos, 'rot': self.rot, 'vel': self.vel}
        if self.prop_cov:
            if gyro_cov is None:
                gyro_cov = self.gyro_cov.repeat(B, 1, 1)
            if acc_cov is None:
                acc_cov = self.acc_cov.repeat(B, 1, 1)
            if init_state.get('cov') is None:
                init_cov = self.cov.expand(B, 9, 9)
            else:
                init_cov = init_state['cov']
        else:
            init_cov = None
        Rij_prev = init_state.get('Rij', self.Rij)

        base = {k: init_state[k] for k in ('pos', 'rot', 'vel')}
        predict, cov, Rij = self._core(dt, gyro, acc, rot, gyro_cov, acc_cov,
                                       base, init_cov, Rij_prev)

        if not self.reset:
            self.pos = predict['pos'][..., -1:, :]
            self.rot = predict['rot'][..., -1:, :]
            self.vel = predict['vel'][..., -1:, :]
            self.cov = cov['cov']
            if Rij is not None:
                self.Rij = Rij[..., -1:, :]
        return {**predict, **cov}

    def _core(self, dt, gyro, acc, rot, gyro_cov, acc_cov, init_state,
              init_cov, Rij_prev):
        """The pipeline: integrate, predict, then the covariance on
        detached inputs (``jax.lax.stop_gradient`` at :134-141)."""
        inte_state = self.integrate(dt, gyro, acc, rot=rot,
                                    init_rot=init_state['rot'])
        predict = self.predict(init_state, inte_state)
        if not self.prop_cov:
            return predict, {'cov': None}, None
        Rij = inte_state['Dr'] if Rij_prev is None \
            else Rij_prev * inte_state['Dr']
        cov_input = {'Rij': Rij.detach(), 'Rk': inte_state['w'].detach(),
                     'a': inte_state['a'].detach(), 'dt': dt.detach()}
        cov = self.propagate_cov(cov_input, init_cov, gyro_cov, acc_cov)
        return predict, cov, Rij

    def integrate(self, dt, gyro, acc, rot=None, init_rot=None):
        """Delta terms via the cumulative SO3 product and cumsums.

        Ref: pypose_tpu/module/imu_preintegrator.py:147-180.
        """
        B, F = dt.shape[:2]
        kw = dict(dtype=dt.dtype, device=dt.device)
        dr = so3(gyro * dt).Exp()
        w = LieTensor(torch.cat([identity_SO3(B, 1, **kw).tensor(),
                                 dr.tensor()], dim=1), ltype=dr.ltype)
        incre_r = cumprod(w, dim=1, left=False)
        if isinstance(rot, LieTensor):
            a = acc - rot.Inv() @ self.gravity
        else:
            if init_rot is None:
                init_rot = identity_SO3(B, 1, **kw)
            inte_rot = init_rot * incre_r
            a = acc - inte_rot[:, 1:, :].Inv() @ self.gravity
        ra = incre_r[:, :F, :] @ a
        zero = torch.zeros(B, 1, 3, **kw)
        incre_v = _cumsum(torch.cat([zero, ra * dt], dim=1))
        incre_p = _cumsum(torch.cat(
            [zero, incre_v[:, :F, :] * dt + ra * 0.5 * dt ** 2], dim=1))
        incre_t = torch.cat([torch.zeros(B, 1, 1, **kw), _cumsum(dt)], dim=1)
        return {'a': a, 'Dp': incre_p[:, 1:, :], 'Dv': incre_v[:, 1:, :],
                'Dr': incre_r[:, 1:, :], 'Dt': incre_t[:, 1:, :],
                'w': w[:, 1:, :]}

    def predict(self, init_state, integrate):
        """Compose the deltas with the initial state.

        Ref: pypose_tpu/module/imu_preintegrator.py:182-189.
        """
        return {
            'rot': init_state['rot'] * integrate['Dr'],
            'vel': init_state['vel'] + init_state['rot'] * integrate['Dv'],
            'pos': init_state['pos'] + init_state['rot'] * integrate['Dp']
                   + init_state['vel'] * integrate['Dt'],
        }

    def propagate_cov(self, cov_input, init_cov, gyro_cov, acc_cov):
        """The 9x9 recursion ``P <- A P A^T + B`` over the span, in its
        closed form (:meth:`_cov_closed`).

        Ref: pypose_tpu/module/imu_preintegrator.py:196-244.
        """
        from ..lietensor.jacobian import cosc, sinc3
        from ..lietensor.scalarized import _mm3, _mscale, _quat2R, _skew, \
            _so3_log

        dtf = cov_input['dt'][..., 0]                          # [B, F]
        qij = tuple(cov_input['Rij'].tensor()[..., k] for k in range(4))
        qk = tuple(cov_input['Rk'].tensor()[..., k] for k in range(4))
        av = tuple(cov_input['a'][..., k] for k in range(3))
        zero = torch.zeros_like(dtf)
        one = torch.ones_like(dtf)

        Rij = _quat2R(qij)
        RH = _mscale(-1.0, _mm3(Rij, _skew(av)))               # -Rij Ha

        # Jr(Rk) = Jl(-Log(Rk)) = I - cosc K + sinc3 K^2, K = skew(phi)
        phi = _so3_log(qk)
        theta = torch.sqrt(torch.clamp(
            phi[0] ** 2 + phi[1] ** 2 + phi[2] ** 2, min=1e-36))
        K = _skew(phi)
        K2 = _mm3(K, K)
        c1, c2 = cosc(theta), sinc3(theta)
        Jr = tuple(tuple(
            (one if i == j else zero) - c1 * K[i][j] + c2 * K2[i][j]
            for j in range(3)) for i in range(3))

        gc = tuple(gyro_cov[..., k] for k in range(3))   # [B,1] or [B,F]
        ac = tuple(acc_cov[..., k] for k in range(3))
        JCJ = tuple(tuple(sum(Jr[i][k] * gc[k] * Jr[j][k] for k in range(3))
                          for j in range(3)) for i in range(3))
        W = tuple(tuple(sum(Rij[i][k] * ac[k] * Rij[j][k] for k in range(3))
                        for j in range(3)) for i in range(3))
        return self._cov_closed(cov_input, qk, RH, JCJ, W, dtf, init_cov)

    @staticmethod
    def _cov_closed(cov_input, qk, RH, JCJ, W, dtf, init_cov):
        r"""O(F) closed form of the covariance span.

        With the ascending products :math:`S_j = A_j A_{j+1} \cdots A_F`,

        .. math::
            S_j = \begin{bmatrix} Q_j & 0 & 0 \\ X_j & I & 0 \\
                  Y_j & T_j I & I \end{bmatrix},

        :math:`Q_j = Rk_j^T Q_{j+1}` (a reverse quaternion scan,
        renormalised), :math:`T_j = \sum_{k\ge j} dt_k`,
        :math:`X_j = \sum_{k\ge j} dt_k\,RH_k\,Q_{k+1}`,
        :math:`Y_j = \sum_{k\ge j} (dt_k X_{k+1} + \tfrac12 dt_k^2
        RH_k Q_{k+1})` (reverse cumsums), and
        :math:`P = S_1 P_0 S_1^T + \sum_j S_{j+1} B_j S_{j+1}^T` expands
        into six 3x3 block sums over frames.

        Ref: pypose_tpu/module/imu_preintegrator.py:372-500.
        """
        from ..lietensor.scalarized import _mm3, _qconj, _qmul, _quat2R

        B = dtf.shape[0]
        kw = dict(dtype=dtf.dtype, device=dtf.device)
        # Q_j: suffix quaternion products of conj(qk), renormalised
        qs = associative_scan(_qmul, _qconj(qk), dim=1, reverse=True)
        qn = torch.rsqrt(torch.clamp(
            qs[0] ** 2 + qs[1] ** 2 + qs[2] ** 2 + qs[3] ** 2, min=1e-30))
        qs = tuple(c * qn for c in qs)

        def shift_left(c, fill):
            return torch.cat([c[..., 1:], torch.full((B, 1), fill, **kw)],
                             dim=-1)

        def revcum(c):
            return torch.flip(_cumsum(torch.flip(c, (1,))), (1,))

        def mmT(Am, Bm):
            return tuple(tuple(sum(Am[i][k] * Bm[j][k] for k in range(3))
                               for j in range(3)) for i in range(3))

        # S_{j+1} blocks, per frame j (the exclusive shifts reindex the
        # inclusive scans instead of subtracting)
        qsx = tuple(shift_left(c, 1.0 if k == 3 else 0.0)
                    for k, c in enumerate(qs))
        Q3 = _quat2R(qsx)                                     # Q_{j+1}
        D = tuple(tuple(dtf * m for m in row)
                  for row in _mm3(RH, Q3))                    # dt RH Q
        Xin = tuple(tuple(revcum(m) for m in row) for row in D)
        Xex = tuple(tuple(shift_left(m, 0.0) for m in row) for row in Xin)
        E = tuple(tuple(dtf * Xex[i][j] + 0.5 * dtf * D[i][j]
                        for j in range(3)) for i in range(3))
        Yin = tuple(tuple(revcum(m) for m in row) for row in E)
        Yex = tuple(tuple(shift_left(m, 0.0) for m in row) for row in Yin)
        Tin = revcum(dtf)
        Tex = shift_left(Tin, 0.0)

        b2 = 0.5 * dtf ** 2
        b3 = 0.25 * dtf ** 3
        N1 = mmT(_mm3(Q3, JCJ), Q3)    # Q JCJ Q^T
        N2 = _mm3(Q3, JCJ)             # Q JCJ
        QJX = mmT(N2, Xex)
        QJY = mmT(N2, Yex)
        XJ = _mm3(Xex, JCJ)
        XJX = mmT(XJ, Xex)
        XJY = mmT(XJ, Yex)
        YJY = mmT(_mm3(Yex, JCJ), Yex)

        def fsum(c):
            return torch.sum(c, dim=1)

        blk00 = [[fsum(dtf * N1[i][j]) for j in range(3)] for i in range(3)]
        blk01 = [[fsum(dtf * QJX[i][j]) for j in range(3)] for i in range(3)]
        blk02 = [[fsum(dtf * QJY[i][j]) for j in range(3)] for i in range(3)]
        blk11 = [[fsum(dtf * (XJX[i][j] + W[i][j])) for j in range(3)]
                 for i in range(3)]
        blk12 = [[fsum(dtf * XJY[i][j] + (dtf * Tex + b2) * W[i][j])
                  for j in range(3)] for i in range(3)]
        blk22 = [[fsum(dtf * YJY[i][j]
                       + (b3 + 2.0 * Tex * b2 + Tex ** 2 * dtf) * W[i][j])
                  for j in range(3)] for i in range(3)]
        grid = [[blk00, blk01, blk02],
                [None, blk11, blk12],
                [None, None, blk22]]

        def entry(r, c):
            br, bc, i, j = r // 3, c // 3, r % 3, c % 3
            if br <= bc:
                return grid[br][bc][i][j]
            return grid[bc][br][j][i]                  # symmetric blocks

        covB = torch.stack([entry(r, c) for r in range(9) for c in range(9)],
                           dim=-1).reshape(B, 9, 9)

        # + S_1 P_0 S_1^T
        Q13 = _quat2R(tuple(c[:, 0] for c in qs))
        X1 = tuple(tuple(Xin[i][j][:, 0] for j in range(3)) for i in range(3))
        Y1 = tuple(tuple(Yin[i][j][:, 0] for j in range(3)) for i in range(3))
        T1 = Tin[:, 0]
        zb = torch.zeros(B, **kw)
        ob = torch.ones(B, **kw)

        def s1entry(r, c):
            br, bc, i, j = r // 3, c // 3, r % 3, c % 3
            if bc == 0:
                return (Q13, X1, Y1)[br][i][j]
            if br == 1:
                return (ob if i == j else zb) if bc == 1 else zb
            if br == 2:
                if bc == 1:
                    return T1 if i == j else zb
                return ob if i == j else zb
            return zb
        S1 = torch.stack([s1entry(r, c) for r in range(9) for c in range(9)],
                         dim=-1).reshape(B, 9, 9)
        covB = covB + torch.einsum('bij,bjk,blk->bil', S1,
                                   init_cov.to(dtf.dtype), S1)
        return {'cov': covB, 'Rij': cov_input['Rij'][..., -1:, :]}
