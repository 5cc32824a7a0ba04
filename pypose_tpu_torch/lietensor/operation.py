r"""Group maps of SO3, SE3, RxSO3 and Sim3 on torch tensors (forward only).

Counterpart of ``pypose_tpu/lietensor/operation.py:84-805``.  The JAX
package wraps each op in a ``jax.custom_jvp``; the pose-graph paths need
none of them (their Jacobians are closed-form, ``optim/sparse.py:
pgo_factor``), so these are the plain forward functions.  Storage layouts
match the reference:

====== ======= ==========================================
group  storage layout
====== ======= ==========================================
SO3    4       ``[qx, qy, qz, qw]``
so3    3       ``[px, py, pz]`` (axis-angle)
SE3    7       ``[tx, ty, tz, qx, qy, qz, qw]``
se3    6       ``[tau(3), phi(3)]``
RxSO3  5       ``[qx, qy, qz, qw, s]``
rxso3  4       ``[phi(3), sigma]``
Sim3   8       ``[tx, ty, tz, qx, qy, qz, qw, s]``
sim3   7       ``[tau(3), phi(3), sigma]``
====== ======= ==========================================
"""

import math

import torch

from .jacobian import (vec2skew, sinc1, so3_Jl_apply, so3_Jl_inv_apply,
                       se3_Jl_inv_apply, rxso3_Ws, rxso3_Ws_apply,
                       sim3_Jl_inv, _embed, _theta, _cross)


def _bcat(parts):
    """Concatenate on the last dim after broadcasting the batch dims."""
    batch = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    return torch.cat([p.expand(batch + p.shape[-1:]) for p in parts], dim=-1)


# ---------------------------------------------------------------------------
# quaternion primitives (xyzw layout)
# ---------------------------------------------------------------------------

def _qmul(X, Y):
    Xv, Xw = X[..., :3], X[..., 3:4]
    Yv, Yw = Y[..., :3], Y[..., 3:4]
    Zv = Xw * Yv + Xv * Yw + _cross(Xv, Yv)
    Zw = Xw * Yw - torch.sum(Xv * Yv, dim=-1, keepdim=True)
    return torch.cat([Zv, Zw], dim=-1)


def _qconj(X):
    return torch.cat([-X[..., :3], X[..., 3:4]], dim=-1)


def _qrot(X, p):
    """Rotate point(s) p by unit quaternion X: two cross products."""
    Xv, Xw = X[..., :3], X[..., 3:4]
    uv = 2.0 * _cross(Xv, p)
    return p + Xw * uv + _cross(Xv, uv)


def _SE3_Adj_apply(X, v):
    """``SE3_Adj(X) @ v`` = [R v1 + t x (R v2), R v2]."""
    t, q = X[..., :3], X[..., 3:7]
    Rv2 = _qrot(q, v[..., 3:6])
    return _bcat([_qrot(q, v[..., :3]) + _cross(t, Rv2), Rv2])


def _RxSO3_Adj_apply(X, v):
    """``RxSO3_Adj(X) @ v``: Adj = blockdiag(R, 1)."""
    return _bcat([_qrot(X[..., :4], v[..., :3]), v[..., 3:4]])


def _Sim3_Adj_apply(X, v):
    """``Sim3_Adj(X) @ v`` = [s R v1 + t x (R v2) - t v3, R v2, v3]."""
    t, q, s = X[..., :3], X[..., 3:7], X[..., 7:8]
    Rv2 = _qrot(q, v[..., 3:6])
    top = s * _qrot(q, v[..., :3]) + _cross(t, Rv2) - t * v[..., 6:7]
    return _bcat([top, Rv2, v[..., 6:7]])


# ---------------------------------------------------------------------------
# matrices and adjoints
# ---------------------------------------------------------------------------

def SO3_Adj(X):
    """Rotation matrix from a unit quaternion (= adjoint of SO3)."""
    I3 = torch.eye(3, dtype=X.dtype, device=X.device).expand(
        X.shape[:-1] + (3, 3))
    Xv, Xw = X[..., :3], X[..., 3:4]
    Xw33 = Xw[..., None] * I3
    return (2.0 * Xw[..., None] * (Xw33 + vec2skew(Xv)) - I3
            + 2.0 * Xv[..., None] * Xv[..., None, :])


def SO3_Matrix(X):
    return SO3_Adj(X)


def SE3_Adj(X):
    t, q = X[..., :3], X[..., 3:7]
    R = SO3_Adj(q)
    tR = torch.matmul(vec2skew(t), R)
    Z = torch.zeros_like(R)
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([Z, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def SE3_Matrix(X):
    T = torch.eye(4, dtype=X.dtype, device=X.device).repeat(
        X.shape[:-1] + (1, 1))
    T[..., :3, :3] = SO3_Matrix(X[..., 3:7])
    T[..., :3, 3] = X[..., :3]
    return T


def SO3_Matrix4x4(X):
    return _embed(SO3_Matrix(X), 4)


def SE3_Matrix4x4(X):
    return SE3_Matrix(X)


def RxSO3_Adj(X):
    return _embed(SO3_Adj(X[..., :4]), 4)


def RxSO3_Matrix(X):
    """s R."""
    return X[..., 4:5, None] * SO3_Adj(X[..., :4])


def RxSO3_Rotation(X):
    return SO3_Adj(X[..., :4])


def RxSO3_Matrix4x4(X):
    return _embed(RxSO3_Matrix(X), 4)


def Sim3_Adj(X):
    """7x7 adjoint: [[sR, [t]x R, -t], [0, R, 0], [0, 0, 1]]."""
    Adj = torch.eye(7, dtype=X.dtype, device=X.device).repeat(
        X.shape[:-1] + (1, 1))
    R = RxSO3_Rotation(X[..., 3:])
    Adj[..., :3, :3] = RxSO3_Matrix(X[..., 3:])
    Adj[..., :3, 3:6] = torch.matmul(vec2skew(X[..., :3]), R)
    Adj[..., :3, 6] = -X[..., :3]
    Adj[..., 3:6, 3:6] = R
    return Adj


def Sim3_Matrix(X):
    T = torch.eye(4, dtype=X.dtype, device=X.device).repeat(
        X.shape[:-1] + (1, 1))
    T[..., :3, :3] = RxSO3_Matrix(X[..., 3:])
    T[..., :3, 3] = X[..., :3]
    return T


def Sim3_Matrix4x4(X):
    return Sim3_Matrix(X)


# ---------------------------------------------------------------------------
# Exp / Log
# ---------------------------------------------------------------------------

def so3_Exp(x):
    """so3 -> SO3 quaternion: [x sin(t/2)/t, cos(t/2)], Taylor-switched
    near t = 0."""
    theta, _ = _theta(x)
    half = 0.5 * theta
    imag = 0.5 * sinc1(half)          # sin(t/2)/t
    real = torch.cos(half)
    return torch.cat([x * imag, real], dim=-1)


def SO3_Log(X):
    """SO3 quaternion -> so3, with the reference's branches: the main
    ``2 atan(|v|/w)/|v|`` factor (negative angles for w < 0, keeping the
    reference's double-cover choice) and ``2/w - 2|v|^2/(3 w^3)`` when
    |v| is below machine epsilon."""
    v, w = X[..., :3], X[..., 3:4]
    v2 = torch.sum(v * v, dim=-1, keepdim=True)
    vn = torch.sqrt(torch.clamp(v2, min=1e-36))
    eps = torch.finfo(X.dtype).eps
    v_big = vn > eps
    w_big = torch.abs(w) > eps
    w_safe = torch.where(w_big, w, 1.0)
    vn_safe = torch.where(v_big, vn, 1.0)
    factor_main = 2.0 * torch.atan2(vn, w) / vn_safe
    factor_main = torch.where(w < 0, factor_main - 2.0 * math.pi / vn_safe,
                              factor_main)
    factor_small_v = 2.0 / w_safe - 2.0 * v2 / (3.0 * w_safe ** 3)
    factor = torch.where(v_big, factor_main, factor_small_v)
    return factor * v


def se3_Exp(x):
    """se3 -> SE3: t = Jl(phi) tau, q = Exp(phi)."""
    tau, phi = x[..., :3], x[..., 3:6]
    return torch.cat([so3_Jl_apply(phi, tau), so3_Exp(phi)], dim=-1)


def SE3_Log(X):
    """SE3 -> se3: phi = Log(q), tau = Jl_inv(phi) t."""
    phi = SO3_Log(X[..., 3:7])
    tau = so3_Jl_inv_apply(phi, X[..., :3])
    return torch.cat([tau, phi], dim=-1)


def rxso3_Exp(x):
    """rxso3 -> RxSO3: q = Exp(phi), s = exp(sigma)."""
    return torch.cat([so3_Exp(x[..., :3]), torch.exp(x[..., 3:4])], dim=-1)


def RxSO3_Log(X):
    """RxSO3 -> rxso3: phi = Log(q), sigma = log(s)."""
    return torch.cat([SO3_Log(X[..., :4]), torch.log(X[..., 4:5])], dim=-1)


def sim3_Exp(x):
    """sim3 -> Sim3: t = Ws(phi, sigma) tau."""
    t = rxso3_Ws_apply(x[..., 3:7], x[..., :3])
    return torch.cat([t, rxso3_Exp(x[..., 3:7])], dim=-1)


def Sim3_Log(X):
    """Sim3 -> sim3: tau = Ws(phi, sigma)^-1 t, a batched 3x3 solve."""
    phi_sigma = RxSO3_Log(X[..., 3:8])
    tau = torch.linalg.solve(rxso3_Ws(phi_sigma), X[..., :3, None])[..., 0]
    return torch.cat([tau, phi_sigma], dim=-1)


# ---------------------------------------------------------------------------
# Act / Mul / Inv
# ---------------------------------------------------------------------------

def SO3_Act(X, p):
    return _qrot(X, p)


def SE3_Act(X, p):
    """R p + t."""
    return X[..., :3] + _qrot(X[..., 3:7], p)


def SO3_Mul(X, Y):
    return _qmul(X, Y)


def SE3_Mul(X, Y):
    t = X[..., :3] + _qrot(X[..., 3:7], Y[..., :3])
    q = _qmul(X[..., 3:7], Y[..., 3:7])
    return _bcat([t, q])


def SO3_Inv(X):
    return _qconj(X)


def SE3_Inv(X):
    q_inv = _qconj(X[..., 3:7])
    t_inv = -_qrot(q_inv, X[..., :3])
    return torch.cat([t_inv, q_inv], dim=-1)


def RxSO3_Act(X, p):
    """s R p."""
    return X[..., 4:5] * _qrot(X[..., :4], p)


def Sim3_Act(X, p):
    """s R p + t."""
    return X[..., :3] + RxSO3_Act(X[..., 3:8], p)


def _act4(t, p):
    """Homogeneous result [t, w] with w = p's fourth coordinate."""
    return _bcat([t, p[..., 3:4]])


def SO3_Act4(X, p):
    return _act4(_qrot(X, p[..., :3]), p)


def SE3_Act4(X, p):
    """[R p3 + t pw, pw]."""
    return _act4(_qrot(X[..., 3:7], p[..., :3]) + X[..., :3] * p[..., 3:4], p)


def RxSO3_Act4(X, p):
    return _act4(RxSO3_Act(X, p[..., :3]), p)


def Sim3_Act4(X, p):
    """[s R p3 + t pw, pw]."""
    return _act4(RxSO3_Act(X[..., 3:8], p[..., :3])
                 + X[..., :3] * p[..., 3:4], p)


def RxSO3_Mul(X, Y):
    return _bcat([_qmul(X[..., :4], Y[..., :4]), X[..., 4:5] * Y[..., 4:5]])


def Sim3_Mul(X, Y):
    t = X[..., :3] + RxSO3_Act(X[..., 3:8], Y[..., :3])
    return _bcat([t, RxSO3_Mul(X[..., 3:8], Y[..., 3:8])])


def RxSO3_Inv(X):
    return torch.cat([_qconj(X[..., :4]), 1.0 / X[..., 4:5]], dim=-1)


def Sim3_Inv(X):
    qs_inv = torch.cat([_qconj(X[..., 3:7]), 1.0 / X[..., 7:8]], dim=-1)
    return torch.cat([-RxSO3_Act(qs_inv, X[..., :3]), qs_inv], dim=-1)


# ---------------------------------------------------------------------------
# AdjXa / AdjTXa / Jinvp
# ---------------------------------------------------------------------------

def SO3_AdjXa(X, a):
    """Adj(X) a for SO3: the rotation of a."""
    return _qrot(X, a)


def SE3_AdjXa(X, a):
    return _SE3_Adj_apply(X, a)


def RxSO3_AdjXa(X, a):
    return _RxSO3_Adj_apply(X, a)


def Sim3_AdjXa(X, a):
    return _Sim3_Adj_apply(X, a)


def SO3_AdjTXa(X, a):
    """Adj(X^-1) a."""
    return SO3_AdjXa(SO3_Inv(X), a)


def SE3_AdjTXa(X, a):
    return SE3_AdjXa(SE3_Inv(X), a)


def RxSO3_AdjTXa(X, a):
    return RxSO3_AdjXa(RxSO3_Inv(X), a)


def Sim3_AdjTXa(X, a):
    return Sim3_AdjXa(Sim3_Inv(X), a)


def SO3_Jinvp(X, p):
    """Jl^-1(Log(X)) p."""
    return so3_Jl_inv_apply(SO3_Log(X), p)


def SE3_Jinvp(X, p):
    return se3_Jl_inv_apply(SE3_Log(X), p)


def RxSO3_Jinvp(X, p):
    phis = RxSO3_Log(X)
    return _bcat([so3_Jl_inv_apply(phis[..., :3], p[..., :3]), p[..., 3:4]])


def Sim3_Jinvp(X, p):
    return torch.einsum('...ij,...j->...i', sim3_Jl_inv(Sim3_Log(X)), p)
