r"""Closed-form Lie-group Jacobian helpers on torch tensors.

Counterpart of ``pypose_tpu/lietensor/jacobian.py``: the Taylor-guarded
coefficient functions, skew matrices, the SO3 left Jacobian and its
inverse, calcQ and the SE3 left Jacobian and its inverse, the algebra
adjoints of all four groups, the W matrix of Sim(3)'s exp and log
(``rxso3_Ws``) in its three cancellation-free regimes, and the exact
Sim(3) left Jacobian by scaling and squaring.  Every coefficient switches
to its truncated series below a dtype-aware cutoff (``_cut``) chosen so
that the series is accurate to the dtype's machine precision, and the
closed forms stay cancellation-free above it.  All functions broadcast
over leading batch dims.
"""

import math

import torch

__all__ = [
    'sinc1', 'cosc', 'sinc3', 'coef_Jl_inv', 'coefQ2', 'coefQ3', 'vec2skew',
    'so3_Jl', 'so3_Jl_inv', 'so3_Jl_apply', 'so3_Jl_inv_apply', 'so3_Jr',
    'so3_adj', 'so3_adj_apply', 'calcQ', 'calcQ_apply', 'se3_Jl',
    'se3_Jl_inv', 'se3_Jl_apply', 'se3_Jl_inv_apply', 'se3_adj',
    'se3_adj_apply', 'rxso3_Ws', 'rxso3_Ws_apply', 'rxso3_Jl',
    'rxso3_Jl_inv', 'rxso3_adj', 'rxso3_adj_apply', 'sim3_adj',
    'sim3_adj_apply', 'sim3_Jl', 'sim3_Jl_inv',
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


def so3_Jr(x):
    """Right Jacobian of so(3): Jr(x) = Jl(-x)."""
    return so3_Jl(-x)


def so3_adj(x):
    return vec2skew(x)


def so3_adj_apply(x, v):
    """``so3_adj(x) @ v = x x v`` (no matrix)."""
    return _cross(x, v)


def _zeros1(like):
    return like.new_zeros(like.shape[:-1] + (1,))


def se3_adj_apply(x, v):
    """``se3_adj(x) @ v``: [[Phi, Tau], [0, Phi]] as cross products."""
    tau, phi = x[..., :3], x[..., 3:6]
    top = _cross(phi, v[..., :3]) + _cross(tau, v[..., 3:6])
    return torch.cat([top, _cross(phi, v[..., 3:6])], dim=-1)


def rxso3_adj_apply(x, v):
    """``rxso3_adj(x) @ v``: only the skew(phi) block is nonzero."""
    top = _cross(x[..., :3], v[..., :3])
    return torch.cat([top, _zeros1(top)], dim=-1)


def sim3_adj_apply(x, v):
    """``sim3_adj(x) @ v`` in component form (see :func:`sim3_adj`)."""
    tau, phi, sigma = x[..., :3], x[..., 3:6], x[..., 6:7]
    top = (_cross(phi, v[..., :3]) + sigma * v[..., :3]
           + _cross(tau, v[..., 3:6]) - tau * v[..., 6:7])
    mid = _cross(phi, v[..., 3:6])
    return torch.cat([top, mid, _zeros1(top)], dim=-1)


# ---------------------------------------------------------------------------
# se3 (tangent order: [tau(3), phi(3)])
# ---------------------------------------------------------------------------

def calcQ(x):
    """Q block of the SE(3) left Jacobian."""
    return _tstack(_calcQ_t(_unpack3(x[..., :3]), _unpack3(x[..., 3:6])))


def calcQ_apply(tau, phi, v):
    """``calcQ([tau, phi]) @ v`` as a chain of cross products (no matrix)."""
    theta, _ = _theta(phi)
    c1, c2, c3 = sinc3(theta), coefQ2(theta), coefQ3(theta)
    tv = _cross(tau, v)
    pv = _cross(phi, v)
    ptv = _cross(phi, tv)          # Phi Tau v
    tpv = _cross(tau, pv)          # Tau Phi v
    ppv = _cross(phi, pv)          # Phi Phi v
    ptpv = _cross(phi, tpv)        # Phi Tau Phi v
    pptv = _cross(phi, ptv)        # Phi Phi Tau v
    tppv = _cross(tau, ppv)        # Tau Phi Phi v
    return (0.5 * tv + c1 * (ptv + tpv + ptpv)
            + c2 * (pptv + tppv - 3.0 * ptpv)
            + c3 * (_cross(phi, tppv) + _cross(phi, ptpv)))


def se3_Jl_apply(x, v):
    """``se3_Jl(x) @ v`` without building the matrix:
    [[Jl, Q], [0, Jl]] @ [v1, v2] = [Jl v1 + Q v2, Jl v2]."""
    tau, phi = x[..., :3], x[..., 3:6]
    v1, v2 = v[..., :3], v[..., 3:6]
    top = so3_Jl_apply(phi, v1) + calcQ_apply(tau, phi, v2)
    return torch.cat(torch.broadcast_tensors(top, so3_Jl_apply(phi, v2)),
                     dim=-1)


def se3_Jl_inv_apply(x, v):
    """``se3_Jl_inv(x) @ v`` without building the matrix:
    [[A, -A Q A], [0, A]] @ [v1, v2] = [A (v1 - Q (A v2)), A v2]."""
    tau, phi = x[..., :3], x[..., 3:6]
    Av2 = so3_Jl_inv_apply(phi, v[..., 3:6])
    top = so3_Jl_inv_apply(phi, v[..., :3] - calcQ_apply(tau, phi, Av2))
    return torch.cat(torch.broadcast_tensors(top, Av2), dim=-1)


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


def se3_adj(x):
    """6x6 adjoint of se(3): [[Phi, Tau], [0, Phi]]."""
    Phi = vec2skew(x[..., 3:6])
    Tau = vec2skew(x[..., :3])
    top = torch.cat([Phi, Tau], dim=-1)
    bot = torch.cat([torch.zeros_like(Phi), Phi], dim=-1)
    return torch.cat([top, bot], dim=-2)


# ---------------------------------------------------------------------------
# rxso3 (tangent order: [phi(3), sigma(1)])
# ---------------------------------------------------------------------------

def _rxso3_Ws_coefs(x):
    r"""Coefficients (A, B, C) of W = A K + B K^2 + C I, K = skew(phi), the
    matrix of Sim(3)'s exp and log, defined by
    :math:`W = \int_0^1 e^{s\sigma} \exp(s\hat\phi)\,ds`:

    .. math::
        C = \int_0^1 e^{s\sigma} ds,\quad
        A = \int_0^1 s\,e^{s\sigma}\,\mathrm{sinc}(s\theta) ds,\quad
        B = \int_0^1 s^2 e^{s\sigma}\,\frac{1-\cos(s\theta)}{(s\theta)^2} ds.

    Evaluated in three cancellation-free regimes:

    1. theta >= cut: closed forms (stable for every sigma);
    2. theta < cut, \|sigma\| >= cut: a theta-Taylor series whose
       coefficients T_m = int s^{m-1} e^{s sigma} ds come from a stable
       upward recursion;
    3. both small: a double power series.
    """
    phi, sigma = x[..., :3], x[..., 3]
    theta = _theta(phi)[0][..., 0]
    theta2 = theta * theta
    cut = _cut(x)

    t_small = theta < cut
    s_small = torch.abs(sigma) < cut
    both_small = t_small & s_small

    # C = expm1(sigma)/sigma (the series only to dodge 0/0)
    sig = _guard(s_small, sigma)
    C_taylor = 1.0 + sigma / 2.0 * (1.0 + sigma / 3.0 * (
        1.0 + sigma / 4.0 * (1.0 + sigma / 5.0 * (1.0 + sigma / 6.0))))
    C = torch.where(s_small, C_taylor, torch.expm1(sig) / sig)

    # regime 1: theta >= cut (exact; safe for any sigma)
    th = _guard(t_small, theta)
    scale = torch.exp(sigma)
    a = scale * torch.sin(th)
    b = scale * torch.cos(th)
    c = th * th + sigma * sigma
    A1 = (a * sigma + (1.0 - b) * th) / (th * c)
    B1 = (C - ((b - 1.0) * sigma + a * th) / c) / (th * th)

    # regime 2: theta < cut, |sigma| >= cut;
    # T_m = (e^sigma - (m-1) T_{m-1}) / sigma
    T = [None, C]
    for m in range(2, 10):
        T.append((scale - (m - 1.0) * T[m - 1]) / sig)
    theta4 = theta2 * theta2
    A2 = (T[2] - theta2 / 6.0 * T[4] + theta4 / 120.0 * T[6]
          - theta4 * theta2 / 5040.0 * T[8])
    B2 = (0.5 * T[3] - theta2 / 24.0 * T[5] + theta4 / 720.0 * T[7]
          - theta4 * theta2 / 40320.0 * T[9])

    # regime 3: both small; S_m = sum_k sigma^k / (k! (k+m)), k <= 8
    def S(m):
        acc = torch.zeros_like(sigma)
        term = torch.ones_like(sigma)     # sigma^k / k!
        for k in range(0, 9):
            acc = acc + term / (k + m)
            term = term * sigma / (k + 1)
        return acc

    A3 = (S(2) - theta2 / 6.0 * S(4) + theta4 / 120.0 * S(6)
          - theta4 * theta2 / 5040.0 * S(8))
    B3 = (0.5 * S(3) - theta2 / 24.0 * S(5) + theta4 / 720.0 * S(7)
          - theta4 * theta2 / 40320.0 * S(9))

    A = torch.where(t_small, torch.where(both_small, A3, A2), A1)
    B = torch.where(t_small, torch.where(both_small, B3, B2), B1)
    return A, B, C


def rxso3_Ws(x):
    """W matrix of Sim(3)'s exp and log (see :func:`_rxso3_Ws_coefs`),
    built by components: A K + B (phi phi^T - th^2 I) + C I."""
    A, B, C = _rxso3_Ws_coefs(x)
    phi = _unpack3(x[..., :3])
    th = _theta_scalar(phi)
    px, py, pz = phi
    d = C - B * th * th
    return _tstack((
        (d + B * px * px, -A * pz + B * px * py, A * py + B * px * pz),
        (A * pz + B * px * py, d + B * py * py, -A * px + B * py * pz),
        (-A * py + B * px * pz, A * px + B * py * pz, d + B * pz * pz)))


def rxso3_Ws_apply(x, tau):
    """``rxso3_Ws(x) @ tau`` without building the matrix."""
    A, B, C = _rxso3_Ws_coefs(x)
    phi = x[..., :3]
    pt = _cross(phi, tau)
    return (C[..., None] * tau + A[..., None] * pt
            + B[..., None] * _cross(phi, pt))


def _embed(block, n):
    """The n x n identity with ``block`` [*, k, k] in its top-left corner
    (built by concatenation, so ``torch.func.vmap`` can batch ``block``)."""
    k = block.shape[-1]
    batch = block.shape[:-2]
    eye = torch.eye(n - k, dtype=block.dtype, device=block.device)
    top = torch.cat([block, block.new_zeros(batch + (k, n - k))], dim=-1)
    bot = torch.cat([block.new_zeros(batch + (n - k, k)),
                     eye.expand(batch + (n - k, n - k))], dim=-1)
    return torch.cat([top, bot], dim=-2)


def rxso3_Jl(x):
    """4x4 left Jacobian of RxSO(3): blockdiag(so3_Jl(phi), 1)."""
    return _embed(so3_Jl(x[..., :3]), 4)


def rxso3_Jl_inv(x):
    return _embed(so3_Jl_inv(x[..., :3]), 4)


def rxso3_adj(x):
    """4x4 adjoint of rxso3: skew(phi) in the rotation block, zero else."""
    K = vec2skew(x[..., :3])
    top = torch.cat([K, K.new_zeros(K.shape[:-1] + (1,))], dim=-1)
    return torch.cat([top, K.new_zeros(K.shape[:-2] + (1, 4))], dim=-2)


# ---------------------------------------------------------------------------
# sim3 (tangent order: [tau(3), phi(3), sigma(1)])
# ---------------------------------------------------------------------------

def sim3_adj(x):
    """7x7 adjoint of sim3: [[skew(phi) + sigma I, skew(tau), -tau],
    [0, skew(phi), 0], [0, 0, 0]]."""
    tau, phi, sigma = x[..., :3], x[..., 3:6], x[..., 6:7]
    I3 = torch.eye(3, dtype=x.dtype, device=x.device)
    P, T = vec2skew(phi), vec2skew(tau)
    Z3 = torch.zeros_like(P)
    top = torch.cat([P + sigma[..., None] * I3, T, -tau[..., None]], dim=-1)
    mid = torch.cat([Z3, P, Z3[..., :1]], dim=-1)
    bot = x.new_zeros(x.shape[:-1] + (1, 7))
    return torch.cat([top, mid, bot], dim=-2)


def _expint(A, n_sq=8, order=10):
    """T(A) = sum_{k>=0} A^k/(k+1)! = integral_0^1 exp(sA) ds, to machine
    precision at any norm, by scaling and squaring on the doubling
    identities T(2B) = T(B)(I + exp(B))/2 and exp(2B) = exp(B)^2 with
    exp(B) = I + B T(B).

    With n_sq = 8 and a 10-term base series the truncation error is
    ~(||A||/256)^11/12!, below float64 eps for ||A|| up to ~1e2.  A fixed
    chain of batched small matrix products (``torch.matmul``: on a CUDA
    device TF32 must be off, ``optim.sparse.require_full_fp32``)."""
    d = A.shape[-1]
    I = torch.eye(d, dtype=A.dtype, device=A.device).expand(A.shape)  # noqa: E741
    B = A * (0.5 ** n_sq)
    T = I / math.factorial(order + 1)
    for k in range(order - 1, -1, -1):
        T = I / math.factorial(k + 1) + torch.matmul(B, T)
    E = I + torch.matmul(B, T)
    for _ in range(n_sq):
        T = 0.5 * torch.matmul(T, I + E)
        E = torch.matmul(E, E)
    return T


def sim3_Jl(x):
    """Exact 7x7 left Jacobian of Sim(3): the adjoint integral
    T(ad(x)) = integral_0^1 exp(s ad) ds by :func:`_expint`."""
    return _expint(sim3_adj(x))


def sim3_Jl_inv(x):
    """Exact inverse left Jacobian of Sim(3): a batched solve against
    :func:`sim3_Jl`."""
    J = sim3_Jl(x)
    I7 = torch.eye(7, dtype=x.dtype, device=x.device).expand(J.shape)
    return torch.linalg.solve(J, I7)
