r"""SO3/SE3 group maps on torch tensors (forward only).

Counterpart of ``pypose_tpu/lietensor/operation.py:84-115, 143-200,
265-360, 438-470, 591-700``.  The JAX package wraps each op in a
``jax.custom_jvp``; the sphere2500 path needs none of them (its Jacobians
are closed-form, ``scalarized.se3_pgo_blocks``), so these are the plain
forward functions.  Storage layouts match the reference:

====== ======= ==========================================
group  storage layout
====== ======= ==========================================
SO3    4       ``[qx, qy, qz, qw]``
so3    3       ``[px, py, pz]`` (axis-angle)
SE3    7       ``[tx, ty, tz, qx, qy, qz, qw]``
se3    6       ``[tau(3), phi(3)]``
====== ======= ==========================================
"""

import math

import torch

from .jacobian import (vec2skew, sinc1, so3_Jl_apply, so3_Jl_inv_apply,
                       _theta, _cross)


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


def SO3_AdjXa(X, a):
    """Adj(X) a for SO3: the rotation of a."""
    return _qrot(X, a)


def SE3_AdjXa(X, a):
    return _SE3_Adj_apply(X, a)


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
