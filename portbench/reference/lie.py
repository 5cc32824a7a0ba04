"""Plain SE3 and Sim3 arithmetic for the reference solver and the problem
generators.

A pose is a tensor ``[..., 8]``: translation t (3), unit quaternion q
(x, y, z, w; 4) and scale s (1; 1 for SE3).  The tangent of SE3 is
``[tau (3), phi (3)]``, of Sim3 ``[tau (3), phi (3), sigma (1)]``, with
``Exp(tau, phi, sigma) = (W(phi, sigma) tau, exp(phi), e^sigma)`` and
``W = int_0^1 e^{s sigma} exp(s phi^) ds`` (SE3: sigma = 0, W the left
Jacobian of SO3).  W is taken by Gauss-Legendre quadrature, which is
exact to rounding for these smooth integrands; nothing here is a closed
form copied from the program.

Every product of a matrix with a vector or a matrix goes through
``arith.mm``, so :class:`Arith` decides the precision of all of them:
float64 for the reference, or float32 with each operand rounded to TF32
for the control (what a float32 matmul with TF32 on computes).
"""

import numpy as np
import torch

TANGENT = {'SE3': 6, 'Sim3': 7}


def round_tf32(x):
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest even;
    a tangent passes through unchanged."""
    i = x.detach().view(torch.int32)
    r = ((i + 0xFFF + ((i >> 13) & 1)) & -8192).view(torch.float32)
    return x + (r - x.detach())


class Arith:
    """The precision of the reference: ``'float64'`` (the judge) or
    ``'tf32'`` (float32 storage, every matmul operand rounded to TF32: the
    control)."""

    def __init__(self, precision='float64'):
        if precision not in ('float64', 'tf32'):
            raise ValueError(f'precision {precision!r}')
        self.precision = precision
        self.dtype = torch.float64 if precision == 'float64' \
            else torch.float32

    def mm(self, a, b):
        if self.precision == 'tf32':
            return torch.matmul(round_tf32(a), round_tf32(b))
        return torch.matmul(a, b)

    def mv(self, M, v):
        return self.mm(M, v[..., None])[..., 0]


F64 = Arith('float64')

_GL_S, _GL_W = (torch.as_tensor(a) for a in np.polynomial.legendre.leggauss(16))
# Gauss-Legendre nodes and weights on [0, 1]
_GL_S = 0.5 * (_GL_S + 1.0)
_GL_W = 0.5 * _GL_W


def skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def quat_matrix(q):
    """The rotation matrix of a unit quaternion (x, y, z, w)."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def quat_left(q):
    """L(q) with q (x) p = L(q) p, Hamilton product, (x, y, z, w) order."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([torch.stack([w, -z, y, x], -1),
                        torch.stack([z, w, -x, y], -1),
                        torch.stack([-y, x, w, z], -1),
                        torch.stack([-x, -y, -z, w], -1)], -2)


def _split(X):
    return X[..., :3], X[..., 3:7], X[..., 7:8]


def compose(X, Y, ar=F64):
    tX, qX, sX = _split(X)
    tY, qY, sY = _split(Y)
    t = tX + sX * ar.mv(quat_matrix(qX), tY)
    q = ar.mv(quat_left(qX), qY)
    return torch.cat([t, q, sX * sY], -1)


def inverse(X, ar=F64):
    t, q, s = _split(X)
    qc = torch.cat([-q[..., :3], q[..., 3:]], -1)
    return torch.cat([-(ar.mv(quat_matrix(qc), t)) / s, qc, 1.0 / s], -1)


def _series(x2, small, coefs):
    """sum_k coefs[k] x2^k where ``small``, else 0 (a guarded Taylor
    series in the squared angle)."""
    x2 = torch.where(small, x2, torch.zeros_like(x2))
    out = torch.zeros_like(x2)
    for c in reversed(coefs):
        out = out * x2 + c
    return out


def exp_quat(phi):
    """exp of a rotation vector as a unit quaternion."""
    th2 = (phi * phi).sum(-1, keepdim=True)
    small = th2 < 1e-6
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    imag = torch.where(small, _series(th2, small, [0.5, -1 / 48, 1 / 3840]),
                       torch.sin(0.5 * th) / th)
    real = torch.where(small, _series(th2, small, [1.0, -1 / 8, 1 / 384]),
                       torch.cos(0.5 * th))
    return torch.cat([imag * phi, real], -1)


def log_quat(q):
    """The rotation vector of a unit quaternion, angle in [0, pi]."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    v, w = q[..., :3], q[..., 3:4]
    n2 = (v * v).sum(-1, keepdim=True)
    small = n2 < 1e-12
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    w_safe = torch.where(small, w, torch.ones_like(w))
    a2 = n2 / (w_safe * w_safe)
    f_small = 2.0 / w_safe * _series(a2, small, [1.0, -1 / 3, 1 / 5])
    return torch.where(small, f_small, 2.0 * torch.atan2(n, w) / n) * v


def _rodrigues_coefs(x2):
    """(sin th / th, (1 - cos th) / th^2) at th^2 = x2."""
    small = x2 < 1e-4
    th = torch.sqrt(torch.where(small, torch.ones_like(x2), x2))
    th2 = th * th
    a = torch.where(small, _series(x2, small, [1.0, -1 / 6, 1 / 120,
                                               -1 / 5040]),
                    torch.sin(th) / th)
    b = torch.where(small, _series(x2, small, [0.5, -1 / 24, 1 / 720,
                                               -1 / 40320]),
                    (1 - torch.cos(th)) / th2)
    return a, b


def w_matrix(phi, sigma):
    """W(phi, sigma) = int_0^1 e^{s sigma} exp(s phi^) ds = c0 I + c1 K +
    c2 K^2, K = phi^, each coefficient by 16-point Gauss-Legendre."""
    s = _GL_S.to(phi)
    w = _GL_W.to(phi)
    th2 = (phi * phi).sum(-1, keepdim=True)                  # [..., 1]
    a, b = _rodrigues_coefs(th2 * s * s)                     # [..., 16]
    e = w * torch.exp(sigma * s)
    c0 = e.sum(-1)
    c1 = (e * s * a).sum(-1)
    c2 = (e * s * s * b).sum(-1)
    K = skew(phi)
    K2 = phi[..., :, None] * phi[..., None, :] \
        - th2[..., None] * torch.eye(3, dtype=phi.dtype, device=phi.device)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return c0[..., None, None] * eye + c1[..., None, None] * K \
        + c2[..., None, None] * K2


def exp(x, group, ar=F64):
    """Exp of a tangent [..., 6] (SE3) or [..., 7] (Sim3) as a pose."""
    tau, phi = x[..., :3], x[..., 3:6]
    sigma = x[..., 6:7] if group == 'Sim3' else torch.zeros_like(x[..., :1])
    t = ar.mv(w_matrix(phi, sigma), tau)
    return torch.cat([t, exp_quat(phi), torch.exp(sigma)], -1)


def log(X, group):
    """Log of a pose as a tangent [..., 6] (SE3) or [..., 7] (Sim3)."""
    t, q, s = _split(X)
    phi = log_quat(q)
    sigma = torch.log(s) if group == 'Sim3' else torch.zeros_like(s)
    # solve_ex: a singular W (a diverged step) gives non-finite values,
    # which the solver rejects, instead of raising
    tau = torch.linalg.solve_ex(w_matrix(phi, sigma), t[..., None])[0][..., 0]
    parts = [tau, phi, sigma] if group == 'Sim3' else [tau, phi]
    return torch.cat(parts, -1)


def residual(Xi, Xj, Z, group, ar=F64):
    """Log(Z^-1 (Xi^-1 Xj)) of each edge: the pose-graph residual."""
    return log(compose(inverse(Z, ar), compose(inverse(Xi, ar), Xj, ar), ar),
               group)


def retract(d, X, group, ar=F64):
    """Exp(d) X: the left retraction."""
    return compose(exp(d, group, ar), X, ar)
