r"""Scalarized SE3 pose-graph and BAL reprojection residual and Jacobian
blocks.

Counterpart of ``pypose_tpu/lietensor/scalarized.py:40-292``.  Every
intermediate is an ``[E]`` vector (3x3 matrices are nested tuples of
them) and only the final ``r [E, 6]`` and ``J [E, 6, 2, 6]`` are stacked.
On the card this keeps the chain elementwise at width E, with no small
[E, 3, 3] temporaries.

Math (identical to ``optim.sparse.pgo_factor``'s residual):
    M  = Z^{-1} X_i^{-1}
    r  = Log(M X_j)                                  in [tau, phi] order
    Jj = se3_Jl_inv(r) @ SE3_Adj(M)
       = [[A R, A S + B R], [0, A R]]
with A = so3_Jl_inv(phi), B = -A Q A (Q = calcQ(r)), R = R(M),
S = skew(t_M) R, and dr/d(delta_i) = -Jj (left perturbation).
"""

import math

import torch

from .jacobian import coef_Jl_inv, coefQ2, coefQ3, sinc3

__all__ = ['se3_pgo_blocks', 'bal_reproj_blocks']


def _qconj(q):
    x, y, z, w = q
    return (-x, -y, -z, w)


def _qmul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return (aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz)


def _qrot(q, v):
    """Rotate v by unit quaternion q: v + w t + qv x t, t = 2 qv x v."""
    x, y, z, w = q
    vx, vy, vz = v
    tx = 2.0 * (y * vz - z * vy)
    ty = 2.0 * (z * vx - x * vz)
    tz = 2.0 * (x * vy - y * vx)
    return (vx + w * tx + (y * tz - z * ty),
            vy + w * ty + (z * tx - x * tz),
            vz + w * tz + (x * ty - y * tx))


def _quat2R(q):
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return ((1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)),
            (2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)),
            (2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)))


def _skew(v):
    x, y, z = v
    o = 0.0
    return ((o, -z, y), (z, o, -x), (-y, x, o))


def _mm3(A, B):
    return tuple(tuple(sum(A[i][k] * B[k][j] for k in range(3))
                       for j in range(3)) for i in range(3))


def _mv3(A, v):
    return tuple(sum(A[i][k] * v[k] for k in range(3)) for i in range(3))


def _madd(*Ms):
    return tuple(tuple(sum(M[i][j] for M in Ms) for j in range(3))
                 for i in range(3))


def _mscale(s, M):
    return tuple(tuple(s * M[i][j] for j in range(3)) for i in range(3))


def _eye3():
    return ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


def _norm3(v):
    return torch.sqrt(torch.clamp(v[0] * v[0] + v[1] * v[1] + v[2] * v[2],
                                  min=1e-36))


def _so3_log(q):
    """Component SO3_Log, same branches as ``operation.SO3_Log``."""
    x, y, z, w = q
    v2 = x * x + y * y + z * z
    vn = torch.sqrt(torch.clamp(v2, min=1e-36))
    eps = torch.finfo(w.dtype).eps
    v_big = vn > eps
    w_big = torch.abs(w) > eps
    w_safe = torch.where(w_big, w, 1.0)
    vn_safe = torch.where(v_big, vn, 1.0)
    factor_main = 2.0 * torch.atan2(vn, w) / vn_safe
    factor_main = torch.where(w < 0, factor_main - 2.0 * math.pi / vn_safe,
                              factor_main)
    factor_small_v = 2.0 / w_safe - 2.0 * v2 / (3.0 * w_safe ** 3)
    f = torch.where(v_big, factor_main, factor_small_v)
    return (f * x, f * y, f * z)


def _so3_Jl_inv(phi):
    """A = I - K/2 + coef_Jl_inv(theta) K^2 in component form."""
    K = _skew(phi)
    C = coef_Jl_inv(_norm3(phi))
    return _madd(_eye3(), _mscale(-0.5, K), _mscale(C, _mm3(K, K)))


def _calcQ(tau, phi):
    """Q block of the se3 left Jacobian in component form."""
    Tau, Phi = _skew(tau), _skew(phi)
    theta = _norm3(phi)
    c1, c2, c3 = sinc3(theta), coefQ2(theta), coefQ3(theta)
    PT, TP = _mm3(Phi, Tau), _mm3(Tau, Phi)
    PTP = _mm3(PT, Phi)
    return _madd(
        _mscale(0.5, Tau),
        _mscale(c1, _madd(PT, TP, PTP)),
        _mscale(c2, _madd(_mm3(Phi, PT), _mm3(TP, Phi),
                          _mscale(-3.0, PTP))),
        _mscale(c3, _madd(_mm3(PTP, Phi), _mm3(Phi, PTP))))


def se3_pgo_blocks(Xi, Xj, Z):
    """Residual and closed-form tangent Jacobian of a batch of SE3
    relative-pose factors.

    Args:
        Xi, Xj: [E, 7] SE3 storage (t, q) of the edge endpoints.
        Z: [E, 7] SE3 measurements.

    Returns:
        (r, J): r [E, 6] residual ``Log(Z^-1 Xi^-1 Xj)`` in [tau, phi]
        order; J [E, 6, 2, 6] with ``J[:, :, 0] = -Jj`` (w.r.t. the left
        perturbation of Xi) and ``J[:, :, 1] = Jj``.
    """
    ti, qi = tuple(Xi.unbind(-1)[:3]), tuple(Xi.unbind(-1)[3:])
    tj, qj = tuple(Xj.unbind(-1)[:3]), tuple(Xj.unbind(-1)[3:])
    tz, qz = tuple(Z.unbind(-1)[:3]), tuple(Z.unbind(-1)[3:])

    # M = Z^-1 Xi^-1
    qzi = _qconj(qz)
    tzi = tuple(-c for c in _qrot(qzi, tz))
    qii = _qconj(qi)
    tii = tuple(-c for c in _qrot(qii, ti))
    tm = tuple(a + b for a, b in zip(tzi, _qrot(qzi, tii)))
    qm = _qmul(qzi, qii)

    # P = M Xj;  r = Log(P)
    tp = tuple(a + b for a, b in zip(tm, _qrot(qm, tj)))
    qp = _qmul(qm, qj)
    phi = _so3_log(qp)
    A_p = _so3_Jl_inv(phi)          # Jl^-1 at the residual's phi
    tau = _mv3(A_p, tp)

    # se3_Jl_inv(r) = [[A, -A Q A], [0, A]]
    Q = _calcQ(tau, phi)
    B = _mscale(-1.0, _mm3(_mm3(A_p, Q), A_p))

    # Adj(M) = [[R, skew(tm) R], [0, R]]
    R = _quat2R(qm)
    S = _mm3(_skew(tm), R)

    TL = _mm3(A_p, R)               # top-left  = bottom-right
    TR = _madd(_mm3(A_p, S), _mm3(B, R))

    r = torch.stack(tau + phi, dim=-1)
    zero = torch.zeros_like(TL[0][0])
    rows = [torch.stack(TL[i] + TR[i], dim=-1) for i in range(3)]
    rows += [torch.stack((zero, zero, zero) + TL[i], dim=-1)
             for i in range(3)]
    Jj = torch.stack(rows, dim=-2)                   # [E, 6, 6]
    J = torch.stack([-Jj, Jj], dim=-2)               # [E, 6, 2, 6]
    return r, J


def bal_reproj_blocks(Tc, Xp, cams, pix):
    """Residual and closed-form tangent Jacobians of a batch of BAL
    reprojection observations, every intermediate an [O] vector.

    Math (``optim.ba.reproj_residual_bal``): with the camera point
    ``Xc = R(q) X + t``, BAL projects ``p = -Xc_xy / Xc_z`` and distorts
    radially, ``res = f (1 + k1 r2 + k2 r2^2) p - pix``.  Left
    perturbation (``pose.add(eps) = Exp(eps) pose``): ``dXc/d[tau, phi] =
    [I, -skew(Xc)]`` and ``dXc/dX = R(q)``.

    Args:
        Tc: [O, 7] SE3 storage of the observing cameras.
        Xp: [O, 3] world points.
        cams: [O, 3] BAL intrinsics (f, k1, k2).
        pix: [O, 2] observed pixels.

    Returns:
        (r [O, 2], Jc [O, 2, 6], Jp [O, 2, 3]).
    """
    t = tuple(Tc[..., i] for i in range(3))
    q = tuple(Tc[..., i] for i in range(3, 7))
    X = tuple(Xp[..., i] for i in range(3))
    f, k1, k2 = cams[..., 0], cams[..., 1], cams[..., 2]

    R = _quat2R(q)
    xc, yc, zc = (a + b for a, b in zip(_mv3(R, X), t))   # Xc = R X + t
    iz = 1.0 / zc
    px = -xc * iz
    py = -yc * iz
    r2 = px * px + py * py
    dist = 1.0 + k1 * r2 + k2 * r2 * r2
    rx = f * dist * px - pix[..., 0]
    ry = f * dist * py - pix[..., 1]

    # dres/dp = f [dist I + 2 (k1 + 2 k2 r2) p p^T]   (2x2)
    g = 2.0 * (k1 + 2.0 * k2 * r2)
    a00 = f * (dist + g * px * px)
    a01 = f * (g * px * py)
    a11 = f * (dist + g * py * py)

    # Jpix = dres/dp @ dp/dXc, dp/dXc = [[-iz, 0, -px iz], [0, -iz, -py iz]]
    Jpix = ((-a00 * iz, -a01 * iz, -(a00 * px + a01 * py) * iz),
            (-a01 * iz, -a11 * iz, -(a01 * px + a11 * py) * iz))

    # Jc = Jpix @ [I | -skew(Xc)]
    mskew = _mscale(-1.0, _skew((xc, yc, zc)))
    rot = [tuple(sum(Jpix[i][k] * mskew[k][j] for k in range(3))
                 for j in range(3)) for i in range(2)]
    Jc = torch.stack([torch.stack(Jpix[i] + rot[i], dim=-1)
                      for i in range(2)], dim=-2)           # [O, 2, 6]
    # Jp = Jpix @ R
    Jp = torch.stack([torch.stack(
        tuple(sum(Jpix[i][k] * R[k][j] for k in range(3)) for j in range(3)),
        dim=-1) for i in range(2)], dim=-2)                 # [O, 2, 3]
    return torch.stack([rx, ry], dim=-1), Jc, Jp
