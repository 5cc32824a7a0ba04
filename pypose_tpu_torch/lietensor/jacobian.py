r"""Closed-form SO3/SE3 Jacobian helpers on torch tensors (forward only).

Counterpart of ``pypose_tpu/lietensor/jacobian.py:23-150, 236-260,
305-365``: the Taylor-guarded coefficient functions, skew matrices, the
SO3 left Jacobian and its inverse, calcQ and the SE3 left Jacobian and its
inverse.  Every coefficient switches to its truncated series below a
dtype-aware cutoff (``_cut``) chosen so that the series is accurate to the
dtype's machine precision, and the closed forms stay cancellation-free
above it.  All functions broadcast over leading batch dims.
"""

import torch

__all__ = [
    'sinc1', 'cosc', 'sinc3', 'coef_Jl_inv', 'coefQ2', 'coefQ3', 'vec2skew',
    'so3_Jl', 'so3_Jl_inv', 'so3_Jl_apply', 'so3_Jl_inv_apply', 'calcQ',
    'se3_Jl', 'se3_Jl_inv',
]

# Taylor-series switch point for float32 (pypose_tpu/lietensor/jacobian.py:39)
_CUT = 0.5


def _cut(x):
    return 0.25 if torch.finfo(x.dtype).bits >= 64 else _CUT


def _guard(pred, x, alt=1.0):
    """Replace ``x`` by ``alt`` where ``pred`` holds, so the branch that
    ``torch.where`` discards never divides by zero."""
    return torch.where(pred, alt, x)


def vec2skew(v):
    """(*, 3) -> (*, 3, 3) skew-symmetric matrices."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([
        torch.stack([o, -z, y], dim=-1),
        torch.stack([z, o, -x], dim=-1),
        torch.stack([-y, x, o], dim=-1),
    ], dim=-2)


def _theta(x):
    """Rotation angle with a NaN-safe sqrt; returns (theta, theta2)."""
    theta2 = torch.sum(x * x, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-36))
    return theta, theta2


# ---------------------------------------------------------------------------
# scalar coefficient functions of theta (elementwise)
# ---------------------------------------------------------------------------

def sinc1(theta):
    """sin(t)/t with Taylor branch."""
    small = torch.abs(theta) < _cut(theta)
    t = _guard(small, theta)
    t2 = theta * theta
    taylor = 1.0 - t2 / 6.0 * (1.0 - t2 / 20.0 * (
        1.0 - t2 / 42.0 * (1.0 - t2 / 72.0)))
    return torch.where(small, taylor, torch.sin(t) / t)


def cosc(theta):
    """(1 - cos t)/t^2 = 2 sin^2(t/2)/t^2 with Taylor branch."""
    small = torch.abs(theta) < _cut(theta)
    t = _guard(small, theta)
    t2 = theta * theta
    taylor = 0.5 - t2 / 24.0 * (1.0 - t2 / 30.0 * (
        1.0 - t2 / 56.0 * (1.0 - t2 / 90.0)))
    s = torch.sin(t / 2.0)
    return torch.where(small, taylor, 2.0 * s * s / (t * t))


def sinc3(theta):
    """(t - sin t)/t^3 with Taylor branch."""
    small = torch.abs(theta) < _cut(theta)
    t = _guard(small, theta)
    t2 = theta * theta
    taylor = (1.0 / 6.0) * (1.0 - t2 / 20.0 * (1.0 - t2 / 42.0 * (
        1.0 - t2 / 72.0 * (1.0 - t2 / 110.0))))
    return torch.where(small, taylor, (t - torch.sin(t)) / (t * t * t))


def coef_Jl_inv(theta):
    """(1 - (t/2) cot(t/2)) / t^2, the K@K coefficient of so3 Jl^{-1}."""
    small = torch.abs(theta) < _cut(theta)
    t = _guard(small, theta)
    t2 = theta * theta
    taylor = (1.0 / 12.0) * (1.0 + t2 / 60.0 * (
        1.0 + t2 / 42.0 * (1.0 + t2 / 40.0)))
    half = t / 2.0
    exact = (1.0 - half * torch.cos(half) / torch.sin(half)) / (t * t)
    return torch.where(small, taylor, exact)


def coefQ2(theta):
    """(t^2 + 2 cos t - 2) / (2 t^4)."""
    small = torch.abs(theta) < 2.0 * _cut(theta)
    t = _guard(small, theta)
    t2 = theta * theta
    taylor = (1.0 / 24.0) * (1.0 - t2 / 30.0 * (1.0 - t2 / 56.0 * (
        1.0 - t2 / 90.0 * (1.0 - t2 / 264.0))))
    exact = (t * t + 2.0 * torch.cos(t) - 2.0) / (2.0 * t ** 4)
    return torch.where(small, taylor, exact)


def coefQ3(theta):
    """(2t - 3 sin t + t cos t) / (2 t^5)."""
    small = torch.abs(theta) < 2.0 * _cut(theta)
    t = _guard(small, theta)
    t2 = theta * theta
    taylor = (1.0 / 120.0) * (1.0 - t2 / 21.0 * (1.0 - t2 / 48.0 * (
        1.0 - 2.0 * t2 / 165.0)))
    exact = (2.0 * t - 3.0 * torch.sin(t) + t * torch.cos(t)) / (2.0 * t ** 5)
    return torch.where(small, taylor, exact)


# ---------------------------------------------------------------------------
# 3x3 matrices as nested tuples of [*batch] tensors
# ---------------------------------------------------------------------------

def _tskew(v):
    x, y, z = v
    o = torch.zeros_like(x)
    return ((o, -z, y), (z, o, -x), (-y, x, o))


def _tmm(A, B):
    return tuple(tuple(sum(A[i][k] * B[k][j] for k in range(3))
                       for j in range(3)) for i in range(3))


def _tadd(*Ms):
    return tuple(tuple(sum(M[i][j] for M in Ms) for j in range(3))
                 for i in range(3))


def _tscale(s, M):
    return tuple(tuple(s * M[i][j] for j in range(3)) for i in range(3))


def _tstack(rows):
    """Stack a list of row-tuples of [*batch] entries into one tensor."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _theta_scalar(phi):
    return torch.sqrt(torch.clamp(
        phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2], min=1e-36))


def _so3_Jl_t(phi):
    """(1 - B th^2) I + A K + B phi phi^T (using K^2 = phi phi^T - th^2 I)."""
    th = _theta_scalar(phi)
    A, B = cosc(th), sinc3(th)
    x, y, z = phi
    d = 1.0 - B * th * th
    return ((d + B * x * x, -A * z + B * x * y, A * y + B * x * z),
            (A * z + B * x * y, d + B * y * y, -A * x + B * y * z),
            (-A * y + B * x * z, A * x + B * y * z, d + B * z * z))


def _so3_Jl_inv_t(phi):
    """(1 - C th^2) I - K/2 + C phi phi^T."""
    th = _theta_scalar(phi)
    C = coef_Jl_inv(th)
    x, y, z = phi
    d = 1.0 - C * th * th
    return ((d + C * x * x, 0.5 * z + C * x * y, -0.5 * y + C * x * z),
            (-0.5 * z + C * x * y, d + C * y * y, 0.5 * x + C * y * z),
            (0.5 * y + C * x * z, -0.5 * x + C * y * z, d + C * z * z))


def _calcQ_t(tau, phi):
    th = _theta_scalar(phi)
    Tau, Phi = _tskew(tau), _tskew(phi)
    c1, c2, c3 = sinc3(th), coefQ2(th), coefQ3(th)
    PT, TP = _tmm(Phi, Tau), _tmm(Tau, Phi)
    PTP = _tmm(PT, Phi)
    return _tadd(
        _tscale(0.5, Tau),
        _tscale(c1, _tadd(PT, TP, PTP)),
        _tscale(c2, _tadd(_tmm(Phi, PT), _tmm(TP, Phi),
                          _tscale(-3.0, PTP))),
        _tscale(c3, _tadd(_tmm(PTP, Phi), _tmm(Phi, PTP))))


def _unpack3(x):
    return (x[..., 0], x[..., 1], x[..., 2])


# ---------------------------------------------------------------------------
# so3 / SO3
# ---------------------------------------------------------------------------

def so3_Jl(x):
    """Left Jacobian of SO(3): I + A K + B K^2."""
    return _tstack(_so3_Jl_t(_unpack3(x)))


def so3_Jl_inv(x):
    """Inverse left Jacobian of SO(3)."""
    return _tstack(_so3_Jl_inv_t(_unpack3(x)))


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def so3_Jl_apply(x, v):
    """``so3_Jl(x) @ v`` without building the matrix."""
    theta, _ = _theta(x)
    A, B = cosc(theta), sinc3(theta)
    xv = _cross(x, v)
    return v + A * xv + B * _cross(x, xv)


def so3_Jl_inv_apply(x, v):
    """``so3_Jl_inv(x) @ v`` without building the matrix."""
    theta, _ = _theta(x)
    C = coef_Jl_inv(theta)
    xv = _cross(x, v)
    return v - 0.5 * xv + C * _cross(x, xv)


# ---------------------------------------------------------------------------
# se3 (tangent order: [tau(3), phi(3)])
# ---------------------------------------------------------------------------

def calcQ(x):
    """Q block of the SE(3) left Jacobian."""
    return _tstack(_calcQ_t(_unpack3(x[..., :3]), _unpack3(x[..., 3:6])))


def _se3_rows(TL, TR):
    """Assemble [[TL, TR], [0, TL]] rows from 3x3 tuples."""
    zero = torch.zeros_like(TL[0][0])
    rows = [TL[i] + TR[i] for i in range(3)]
    rows += [(zero, zero, zero) + TL[i] for i in range(3)]
    return rows


def se3_Jl(x):
    """6x6 left Jacobian of SE(3): [[Jl, Q], [0, Jl]]."""
    tau, phi = _unpack3(x[..., :3]), _unpack3(x[..., 3:6])
    return _tstack(_se3_rows(_so3_Jl_t(phi), _calcQ_t(tau, phi)))


def se3_Jl_inv(x):
    """Inverse 6x6 left Jacobian of SE(3): [[A, -A Q A], [0, A]]."""
    tau, phi = _unpack3(x[..., :3]), _unpack3(x[..., 3:6])
    A = _so3_Jl_inv_t(phi)
    Q = _calcQ_t(tau, phi)
    B = _tscale(-1.0, _tmm(_tmm(A, Q), A))
    return _tstack(_se3_rows(A, B))
