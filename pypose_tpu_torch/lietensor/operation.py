r"""Group maps of SO3, SE3, RxSO3 and Sim3 on torch tensors, with analytic
forward- and reverse-mode rules.

Counterpart of ``pypose_tpu/lietensor/operation.py``.  The JAX package
wraps each of its 32 ops in a ``jax.custom_jvp`` and lets JAX transpose
the JVP for reverse mode.  Here each op is a ``torch.autograd.Function``
(:data:`FUNCTIONS`) whose ``jvp`` is the JAX rule, line for line, and
whose ``backward`` is that rule's transpose; ``generate_vmap_rule`` makes
them compose with ``torch.func.vmap``, ``jacrev``, ``jacfwd`` and
``grad``.  Each Function's ``forward`` is the plain forward function
(``_<op>_fwd``), so values are the same bits with or without autograd.

The rules follow the *left-trivialized tangent convention* of the
reference:

* a group-valued tensor ``X`` (storage shape ``(*, D)``) carries a tangent
  ``dX`` of the same storage shape whose first ``m`` entries (``m`` = the
  manifold dimension) are the left perturbation :math:`\delta` with
  :math:`\dot X = \frac{d}{dt}\mathrm{Exp}(t\delta)X|_{t=0}`, and whose
  remaining entries are zero; its gradient has the same form (zero tail);
* Euclidean tensors (points, algebra vectors) carry ordinary tangents.

The rules are written in differentiable torch operations, so a second
derivative exists; near the identity they use the Taylor branches of
``jacobian.py`` (``so3_Jl_apply(0, dx) = dx``), where autograd of the
forward's ``sqrt`` would give NaN.  Storage layouts match the reference:

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
                       se3_Jl_apply, se3_Jl_inv_apply, calcQ_apply, rxso3_Ws,
                       rxso3_Ws_apply, sim3_Jl, sim3_Jl_inv, so3_adj_apply,
                       se3_adj_apply, rxso3_adj_apply, sim3_adj_apply, _embed,
                       _theta, _cross)


def _bcat(parts):
    """Concatenate on the last dim after broadcasting the batch dims."""
    batch = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    return torch.cat([p.expand(batch + p.shape[-1:]) for p in parts], dim=-1)


def _pad(tan, out):
    """A manifold tangent broadcast to ``out``'s batch and zero-padded to
    its storage size (the convention's zero tail)."""
    tan = tan.expand(out.shape[:-1] + tan.shape[-1:])
    pad = out.shape[-1] - tan.shape[-1]
    if pad == 0:
        return tan
    return torch.cat([tan, tan.new_zeros(tan.shape[:-1] + (pad,))], dim=-1)


def _bcast(t, out):
    return t.expand(out.shape)


def _grad(g, like):
    """A cotangent for input ``like``: zero-padded to its storage size and
    summed over the batch dims that were broadcast."""
    pad = like.shape[-1] - g.shape[-1]
    if pad:
        g = torch.cat([g, g.new_zeros(g.shape[:-1] + (pad,))], dim=-1)
    return g if g.shape == like.shape else g.sum_to_size(like.shape)


def _mv(M, v):
    return torch.einsum('...ij,...j->...i', M, v)


def _vm(v, M):
    return torch.einsum('...i,...ij->...j', v, M)


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


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


def _qrotT(X, g):
    """The transpose of ``p -> _qrot(X, p)``: rotation by the conjugate
    (exact for any X, unit or not)."""
    return _qrot(_qconj(X), g)


# ---------------------------------------------------------------------------
# group adjoints applied to a tangent, and their transposes
# ---------------------------------------------------------------------------

def _SE3_Adj_apply(X, v):
    """``SE3_Adj(X) @ v`` = [R v1 + t x (R v2), R v2]."""
    t, q = X[..., :3], X[..., 3:7]
    Rv2 = _qrot(q, v[..., 3:6])
    return _bcat([_qrot(q, v[..., :3]) + _cross(t, Rv2), Rv2])


def _SE3_AdjT_apply(X, g):
    """``SE3_Adj(X)^T @ g`` = [R^T g1, R^T (g1 x t + g2)]."""
    t, q = X[..., :3], X[..., 3:7]
    g1 = g[..., :3]
    return _bcat([_qrotT(q, g1), _qrotT(q, _cross(g1, t) + g[..., 3:6])])


def _RxSO3_Adj_apply(X, v):
    """``RxSO3_Adj(X) @ v``: Adj = blockdiag(R, 1)."""
    return _bcat([_qrot(X[..., :4], v[..., :3]), v[..., 3:4]])


def _RxSO3_AdjT_apply(X, g):
    return _bcat([_qrotT(X[..., :4], g[..., :3]), g[..., 3:4]])


def _Sim3_Adj_apply(X, v):
    """``Sim3_Adj(X) @ v`` = [s R v1 + t x (R v2) - t v3, R v2, v3]."""
    t, q, s = X[..., :3], X[..., 3:7], X[..., 7:8]
    Rv2 = _qrot(q, v[..., 3:6])
    top = s * _qrot(q, v[..., :3]) + _cross(t, Rv2) - t * v[..., 6:7]
    return _bcat([top, Rv2, v[..., 6:7]])


def _Sim3_AdjT_apply(X, g):
    """``Sim3_Adj(X)^T @ g`` = [s R^T g1, R^T (g1 x t + g2), g3 - t.g1]."""
    t, q, s = X[..., :3], X[..., 3:7], X[..., 7:8]
    g1 = g[..., :3]
    return _bcat([s * _qrotT(q, g1), _qrotT(q, _cross(g1, t) + g[..., 3:6]),
                  g[..., 6:7] - _dot(t, g1)])


# transposes ad(x)^T g of the algebra adjoints (``jacobian.*_adj_apply``)
def _so3_adjT_apply(x, g):
    return _cross(g, x)


def _se3_adjT_apply(x, g):
    """[[-Phi, 0], [-Tau, -Phi]] @ g."""
    tau, phi = x[..., :3], x[..., 3:6]
    g1, g2 = g[..., :3], g[..., 3:6]
    return _bcat([_cross(g1, phi), _cross(g1, tau) + _cross(g2, phi)])


def _rxso3_adjT_apply(x, g):
    top = _cross(g[..., :3], x[..., :3])
    return _bcat([top, torch.zeros_like(top[..., :1])])


def _sim3_adjT_apply(x, g):
    """sim3_adj(x)^T @ g = [-phi x g1 + sigma g1, -tau x g1 - phi x g2,
    -tau.g1]."""
    tau, phi, sigma = x[..., :3], x[..., 3:6], x[..., 6:7]
    g1, g2 = g[..., :3], g[..., 3:6]
    return _bcat([_cross(g1, phi) + sigma * g1,
                  _cross(g1, tau) + _cross(g2, phi), -_dot(tau, g1)])


# ---------------------------------------------------------------------------
# left Jacobians of the algebras applied to a tangent, and their transposes
# (Jl(x)^T = Jl(-x) for so3; Q(tau, phi)^T = Q(-tau, -phi))
# ---------------------------------------------------------------------------

def _so3_JlT_apply(x, g):
    return so3_Jl_apply(-x, g)


def _so3_Jl_invT_apply(x, g):
    return so3_Jl_inv_apply(-x, g)


def _se3_JlT_apply(x, g):
    """[[Jl, Q], [0, Jl]]^T @ g = [Jl^T g1, Q^T g1 + Jl^T g2]."""
    tau, phi = x[..., :3], x[..., 3:6]
    g1, g2 = g[..., :3], g[..., 3:6]
    return _bcat([so3_Jl_apply(-phi, g1),
                  calcQ_apply(-tau, -phi, g1) + so3_Jl_apply(-phi, g2)])


def _se3_Jl_invT_apply(x, g):
    """[[A, -A Q A], [0, A]]^T @ g = [A^T g1, A^T (g2 - Q^T A^T g1)]."""
    tau, phi = x[..., :3], x[..., 3:6]
    Ag1 = so3_Jl_inv_apply(-phi, g[..., :3])
    bot = so3_Jl_inv_apply(-phi, g[..., 3:6] - calcQ_apply(-tau, -phi, Ag1))
    return _bcat([Ag1, bot])


def _rxso3_Jl_apply(x, v):
    return _bcat([so3_Jl_apply(x[..., :3], v[..., :3]), v[..., 3:4]])


def _rxso3_JlT_apply(x, g):
    return _bcat([so3_Jl_apply(-x[..., :3], g[..., :3]), g[..., 3:4]])


def _rxso3_Jl_inv_apply(x, v):
    return _bcat([so3_Jl_inv_apply(x[..., :3], v[..., :3]), v[..., 3:4]])


def _rxso3_Jl_invT_apply(x, g):
    return _bcat([so3_Jl_inv_apply(-x[..., :3], g[..., :3]), g[..., 3:4]])


def _sim3_Jl_apply(x, v):
    return _mv(sim3_Jl(x), v)


def _sim3_JlT_apply(x, g):
    return _vm(g, sim3_Jl(x))


def _sim3_Jl_inv_apply(x, v):
    return _mv(sim3_Jl_inv(x), v)


def _sim3_Jl_invT_apply(x, g):
    return _vm(g, sim3_Jl_inv(x))


# ---------------------------------------------------------------------------
# matrices, adjoints and action Jacobians (plain functions)
# ---------------------------------------------------------------------------

def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(
        like.shape[:-1] + (n, n))


def _homogeneous(M, t):
    """[[M, t], [0, 1]] from M [*, 3, 3] and t [*, 3]."""
    top = torch.cat([M, t[..., None].expand(M.shape[:-1] + (1,))], dim=-1)
    bot = torch.cat([top.new_zeros(top.shape[:-2] + (1, 3)),
                     top.new_ones(top.shape[:-2] + (1, 1))], dim=-1)
    return torch.cat([top, bot], dim=-2)


def SO3_Adj(X):
    """Rotation matrix from a unit quaternion (= adjoint of SO3)."""
    I3 = _eye(3, X)
    Xv, Xw = X[..., :3], X[..., 3:4]
    Xw33 = Xw[..., None] * I3
    return (2.0 * Xw[..., None] * (Xw33 + vec2skew(Xv)) - I3
            + 2.0 * Xv[..., None] * Xv[..., None, :])


def SO3_Matrix(X):
    return SO3_Adj(X)


def SO3_Matrix4x4(X):
    return _embed(SO3_Matrix(X), 4)


def SO3_Act_Jacobian(p):
    """d(X p)/d(delta) at X = I: skew(-p), [*, 3, 3]."""
    return vec2skew(-p)


def SO3_Act4_Jacobian(p):
    """[[skew(-p3)], [0]], [*, 4, 3]."""
    J = SO3_Act_Jacobian(p[..., :3])
    return torch.cat([J, J.new_zeros(J.shape[:-2] + (1, 3))], dim=-2)


def SE3_Adj(X):
    t, q = X[..., :3], X[..., 3:7]
    R = SO3_Adj(q)
    tR = torch.matmul(vec2skew(t), R)
    Z = torch.zeros_like(R)
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([Z, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def SE3_Matrix(X):
    return _homogeneous(SO3_Matrix(X[..., 3:7]), X[..., :3])


def SE3_Matrix4x4(X):
    return SE3_Matrix(X)


def SE3_Act_Jacobian(p):
    """[I, skew(-p)], [*, 3, 6]."""
    return torch.cat([_eye(3, p), vec2skew(-p)], dim=-1)


def SE3_Act4_Jacobian(p):
    """[[pw I, skew(-p3)], [0, 0]], [*, 4, 6]."""
    top = torch.cat([_eye(3, p) * p[..., 3:4, None],
                     vec2skew(-p[..., :3])], dim=-1)
    return torch.cat([top, top.new_zeros(top.shape[:-2] + (1, 6))], dim=-2)


def RxSO3_Adj(X):
    return _embed(SO3_Adj(X[..., :4]), 4)


def RxSO3_Matrix(X):
    """s R."""
    return X[..., 4:5, None] * SO3_Adj(X[..., :4])


def RxSO3_Rotation(X):
    return SO3_Adj(X[..., :4])


def RxSO3_Matrix4x4(X):
    return _embed(RxSO3_Matrix(X), 4)


def RxSO3_Act_Jacobian(p):
    """[skew(-p), p], [*, 3, 4]."""
    return torch.cat([vec2skew(-p), p[..., None]], dim=-1)


def RxSO3_Act4_Jacobian(p):
    """[[skew(-p3), p3], [0, 0]], [*, 4, 4]."""
    top = RxSO3_Act_Jacobian(p[..., :3])
    return torch.cat([top, top.new_zeros(top.shape[:-2] + (1, 4))], dim=-2)


def Sim3_Adj(X):
    """7x7 adjoint: [[sR, [t]x R, -t], [0, R, 0], [0, 0, 1]]."""
    t = X[..., :3]
    R = RxSO3_Rotation(X[..., 3:])
    Z3 = torch.zeros_like(R)
    top = torch.cat([RxSO3_Matrix(X[..., 3:]), torch.matmul(vec2skew(t), R),
                     -t[..., None]], dim=-1)
    mid = torch.cat([Z3, R, Z3[..., :1]], dim=-1)
    bot = torch.cat([X.new_zeros(X.shape[:-1] + (1, 6)),
                     X.new_ones(X.shape[:-1] + (1, 1))], dim=-1)
    return torch.cat([top, mid, bot], dim=-2)


def Sim3_Matrix(X):
    return _homogeneous(RxSO3_Matrix(X[..., 3:]), X[..., :3])


def Sim3_Matrix4x4(X):
    return Sim3_Matrix(X)


def Sim3_Act_Jacobian(p):
    """[I, skew(-p), p], [*, 3, 7]."""
    return torch.cat([SE3_Act_Jacobian(p), p[..., None]], dim=-1)


def Sim3_Act4_Jacobian(p):
    """[[pw I, skew(-p3), p3], [0, 0, 0]], [*, 4, 7]."""
    p3 = torch.cat([p[..., :3], torch.zeros_like(p[..., :1])], dim=-1)
    return torch.cat([SE3_Act4_Jacobian(p), p3[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# plain forwards: Exp / Log
# ---------------------------------------------------------------------------

def _so3_Exp_fwd(x):
    """so3 -> SO3 quaternion: [x sin(t/2)/t, cos(t/2)], Taylor-switched
    near t = 0."""
    theta, _ = _theta(x)
    half = 0.5 * theta
    imag = 0.5 * sinc1(half)          # sin(t/2)/t
    real = torch.cos(half)
    return torch.cat([x * imag, real], dim=-1)


def _SO3_Log_fwd(X):
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


def _se3_Exp_fwd(x):
    """se3 -> SE3: t = Jl(phi) tau, q = Exp(phi)."""
    tau, phi = x[..., :3], x[..., 3:6]
    return torch.cat([so3_Jl_apply(phi, tau), _so3_Exp_fwd(phi)], dim=-1)


def _SE3_Log_fwd(X):
    """SE3 -> se3: phi = Log(q), tau = Jl_inv(phi) t."""
    phi = _SO3_Log_fwd(X[..., 3:7])
    tau = so3_Jl_inv_apply(phi, X[..., :3])
    return torch.cat([tau, phi], dim=-1)


def _rxso3_Exp_fwd(x):
    """rxso3 -> RxSO3: q = Exp(phi), s = exp(sigma)."""
    return torch.cat([_so3_Exp_fwd(x[..., :3]), torch.exp(x[..., 3:4])],
                     dim=-1)


def _RxSO3_Log_fwd(X):
    """RxSO3 -> rxso3: phi = Log(q), sigma = log(s)."""
    return torch.cat([_SO3_Log_fwd(X[..., :4]), torch.log(X[..., 4:5])],
                     dim=-1)


def _sim3_Exp_fwd(x):
    """sim3 -> Sim3: t = Ws(phi, sigma) tau."""
    t = rxso3_Ws_apply(x[..., 3:7], x[..., :3])
    return torch.cat([t, _rxso3_Exp_fwd(x[..., 3:7])], dim=-1)


def _Sim3_Log_fwd(X):
    """Sim3 -> sim3: tau = Ws(phi, sigma)^-1 t, a batched 3x3 solve."""
    phi_sigma = _RxSO3_Log_fwd(X[..., 3:8])
    tau = torch.linalg.solve(rxso3_Ws(phi_sigma), X[..., :3, None])[..., 0]
    return torch.cat([tau, phi_sigma], dim=-1)


# ---------------------------------------------------------------------------
# plain forwards: Act / Mul / Inv / AdjXa / AdjTXa
# ---------------------------------------------------------------------------

def _SO3_Act_fwd(X, p):
    return _qrot(X, p)


def _SE3_Act_fwd(X, p):
    """R p + t."""
    return X[..., :3] + _qrot(X[..., 3:7], p)


def _RxSO3_Act_fwd(X, p):
    """s R p."""
    return X[..., 4:5] * _qrot(X[..., :4], p)


def _Sim3_Act_fwd(X, p):
    """s R p + t."""
    return X[..., :3] + _RxSO3_Act_fwd(X[..., 3:8], p)


def _act4(t, p):
    """Homogeneous result [t, w] with w = p's fourth coordinate."""
    return _bcat([t, p[..., 3:4]])


def _SO3_Act4_fwd(X, p):
    return _act4(_qrot(X, p[..., :3]), p)


def _SE3_Act4_fwd(X, p):
    """[R p3 + t pw, pw]."""
    return _act4(_qrot(X[..., 3:7], p[..., :3]) + X[..., :3] * p[..., 3:4], p)


def _RxSO3_Act4_fwd(X, p):
    return _act4(_RxSO3_Act_fwd(X, p[..., :3]), p)


def _Sim3_Act4_fwd(X, p):
    """[s R p3 + t pw, pw]."""
    return _act4(_RxSO3_Act_fwd(X[..., 3:8], p[..., :3])
                 + X[..., :3] * p[..., 3:4], p)


def _SO3_Mul_fwd(X, Y):
    return _qmul(X, Y)


def _SE3_Mul_fwd(X, Y):
    t = X[..., :3] + _qrot(X[..., 3:7], Y[..., :3])
    q = _qmul(X[..., 3:7], Y[..., 3:7])
    return _bcat([t, q])


def _RxSO3_Mul_fwd(X, Y):
    return _bcat([_qmul(X[..., :4], Y[..., :4]), X[..., 4:5] * Y[..., 4:5]])


def _Sim3_Mul_fwd(X, Y):
    t = X[..., :3] + _RxSO3_Act_fwd(X[..., 3:8], Y[..., :3])
    return _bcat([t, _RxSO3_Mul_fwd(X[..., 3:8], Y[..., 3:8])])


def _SO3_Inv_fwd(X):
    return _qconj(X)


def _SE3_Inv_fwd(X):
    q_inv = _qconj(X[..., 3:7])
    t_inv = -_qrot(q_inv, X[..., :3])
    return torch.cat([t_inv, q_inv], dim=-1)


def _RxSO3_Inv_fwd(X):
    return torch.cat([_qconj(X[..., :4]), 1.0 / X[..., 4:5]], dim=-1)


def _Sim3_Inv_fwd(X):
    qs_inv = torch.cat([_qconj(X[..., 3:7]), 1.0 / X[..., 7:8]], dim=-1)
    return torch.cat([-_RxSO3_Act_fwd(qs_inv, X[..., :3]), qs_inv], dim=-1)


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------

class _LieFunction(torch.autograd.Function):
    """Base of the 32 ops: saves the inputs and the output for both the
    backward and the jvp; functorch derives the vmap rule."""

    generate_vmap_rule = True

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)
        ctx.save_for_forward(*inputs, output)


FUNCTIONS = {}


def _function(name, forward, jvp, backward):
    """Register the Function ``name``: ``forward(*inputs)`` the plain
    forward, ``jvp(*inputs, out, *tangents)`` the JAX rule and
    ``backward(*inputs, out, grad)`` its transpose; return its ``apply``."""
    cls = type(name, (_LieFunction,), dict(
        __doc__=f'{name} with its analytic jvp and backward.',
        forward=staticmethod(forward),
        jvp=staticmethod(lambda ctx, *tangents: jvp(*ctx.saved_tensors,
                                                    *tangents)),
        backward=staticmethod(lambda ctx, g: backward(*ctx.saved_tensors,
                                                      g))))
    FUNCTIONS[name] = cls
    return cls.apply


def _exp(name, forward, Jl, JlT, m):
    """x -> Exp(x): tangent Jl(x) dx, cotangent Jl(x)^T g[:m]."""
    return _function(
        name, forward,
        lambda x, out, dx: _pad(Jl(x, dx), out),
        lambda x, out, g: JlT(x, g[..., :m]))


def _log(name, forward, Jl_inv, Jl_invT, m):
    """X -> Log(X): tangent Jl^-1(out) dX[:m], cotangent
    [Jl^-1(out)^T g, 0]."""
    return _function(
        name, forward,
        lambda X, out, dX: _bcast(Jl_inv(out, dX[..., :m]), out),
        lambda X, out, g: _grad(Jl_invT(out, g), X))


so3_Exp = _exp('so3_Exp', _so3_Exp_fwd, so3_Jl_apply, _so3_JlT_apply, 3)
se3_Exp = _exp('se3_Exp', _se3_Exp_fwd, se3_Jl_apply, _se3_JlT_apply, 6)
rxso3_Exp = _exp('rxso3_Exp', _rxso3_Exp_fwd, _rxso3_Jl_apply,
                 _rxso3_JlT_apply, 4)
sim3_Exp = _exp('sim3_Exp', _sim3_Exp_fwd, _sim3_Jl_apply, _sim3_JlT_apply,
                7)
SO3_Log = _log('SO3_Log', _SO3_Log_fwd, so3_Jl_inv_apply,
               _so3_Jl_invT_apply, 3)
SE3_Log = _log('SE3_Log', _SE3_Log_fwd, se3_Jl_inv_apply,
               _se3_Jl_invT_apply, 6)
RxSO3_Log = _log('RxSO3_Log', _RxSO3_Log_fwd, _rxso3_Jl_inv_apply,
                 _rxso3_Jl_invT_apply, 4)
Sim3_Log = _log('Sim3_Log', _Sim3_Log_fwd, _sim3_Jl_inv_apply,
                _sim3_Jl_invT_apply, 7)


# Act: d out = (left perturbation of X acting on out) + s R dp.
# Act4: the same on [out3, w] with w = p's fourth coordinate, plus t dpw.

def _SO3_Act_jvp(X, p, out, dX, dp):
    return _bcast(_cross(dX[..., :3], out) + _qrot(X, dp), out)


def _SO3_Act_vjp(X, p, out, g):
    return _grad(_cross(out, g), X), _grad(_qrotT(X, g), p)


def _SE3_Act_jvp(X, p, out, dX, dp):
    return _bcast(dX[..., :3] + _cross(dX[..., 3:6], out)
                  + _qrot(X[..., 3:7], dp), out)


def _SE3_Act_vjp(X, p, out, g):
    return (_grad(_bcat([g, _cross(out, g)]), X),
            _grad(_qrotT(X[..., 3:7], g), p))


def _RxSO3_Act_jvp(X, p, out, dX, dp):
    return _bcast(_cross(dX[..., :3], out) + out * dX[..., 3:4]
                  + X[..., 4:5] * _qrot(X[..., :4], dp), out)


def _RxSO3_Act_vjp(X, p, out, g):
    return (_grad(_bcat([_cross(out, g), _dot(out, g)]), X),
            _grad(X[..., 4:5] * _qrotT(X[..., :4], g), p))


def _Sim3_Act_jvp(X, p, out, dX, dp):
    return _bcast(dX[..., :3] + _cross(dX[..., 3:6], out)
                  + out * dX[..., 6:7]
                  + X[..., 7:8] * _qrot(X[..., 3:7], dp), out)


def _Sim3_Act_vjp(X, p, out, g):
    return (_grad(_bcat([g, _cross(out, g), _dot(out, g)]), X),
            _grad(X[..., 7:8] * _qrotT(X[..., 3:7], g), p))


def _SO3_Act4_jvp(X, p, out, dX, dp):
    top = _cross(dX[..., :3], out[..., :3]) + _qrot(X, dp[..., :3])
    return _bcast(_bcat([top, dp[..., 3:4]]), out)


def _SO3_Act4_vjp(X, p, out, g):
    g3 = g[..., :3]
    return (_grad(_cross(out[..., :3], g3), X),
            _grad(_bcat([_qrotT(X, g3), g[..., 3:4]]), p))


def _SE3_Act4_jvp(X, p, out, dX, dp):
    top = (out[..., 3:4] * dX[..., :3]
           + _cross(dX[..., 3:6], out[..., :3])
           + _qrot(X[..., 3:7], dp[..., :3]) + X[..., :3] * dp[..., 3:4])
    return _bcast(_bcat([top, dp[..., 3:4]]), out)


def _SE3_Act4_vjp(X, p, out, g):
    g3 = g[..., :3]
    return (_grad(_bcat([out[..., 3:4] * g3, _cross(out[..., :3], g3)]), X),
            _grad(_bcat([_qrotT(X[..., 3:7], g3),
                         _dot(X[..., :3], g3) + g[..., 3:4]]), p))


def _RxSO3_Act4_jvp(X, p, out, dX, dp):
    top = (_cross(dX[..., :3], out[..., :3])
           + out[..., :3] * dX[..., 3:4]
           + X[..., 4:5] * _qrot(X[..., :4], dp[..., :3]))
    return _bcast(_bcat([top, dp[..., 3:4]]), out)


def _RxSO3_Act4_vjp(X, p, out, g):
    g3, o3 = g[..., :3], out[..., :3]
    return (_grad(_bcat([_cross(o3, g3), _dot(o3, g3)]), X),
            _grad(_bcat([X[..., 4:5] * _qrotT(X[..., :4], g3),
                         g[..., 3:4]]), p))


def _Sim3_Act4_jvp(X, p, out, dX, dp):
    top = (out[..., 3:4] * dX[..., :3]
           + _cross(dX[..., 3:6], out[..., :3])
           + out[..., :3] * dX[..., 6:7]
           + X[..., 7:8] * _qrot(X[..., 3:7], dp[..., :3])
           + X[..., :3] * dp[..., 3:4])
    return _bcast(_bcat([top, dp[..., 3:4]]), out)


def _Sim3_Act4_vjp(X, p, out, g):
    g3, o3 = g[..., :3], out[..., :3]
    return (_grad(_bcat([out[..., 3:4] * g3, _cross(o3, g3), _dot(o3, g3)]),
                  X),
            _grad(_bcat([X[..., 7:8] * _qrotT(X[..., 3:7], g3),
                         _dot(X[..., :3], g3) + g[..., 3:4]]), p))


SO3_Act = _function('SO3_Act', _SO3_Act_fwd, _SO3_Act_jvp, _SO3_Act_vjp)
SE3_Act = _function('SE3_Act', _SE3_Act_fwd, _SE3_Act_jvp, _SE3_Act_vjp)
RxSO3_Act = _function('RxSO3_Act', _RxSO3_Act_fwd, _RxSO3_Act_jvp,
                      _RxSO3_Act_vjp)
Sim3_Act = _function('Sim3_Act', _Sim3_Act_fwd, _Sim3_Act_jvp,
                     _Sim3_Act_vjp)
SO3_Act4 = _function('SO3_Act4', _SO3_Act4_fwd, _SO3_Act4_jvp,
                     _SO3_Act4_vjp)
SE3_Act4 = _function('SE3_Act4', _SE3_Act4_fwd, _SE3_Act4_jvp,
                     _SE3_Act4_vjp)
RxSO3_Act4 = _function('RxSO3_Act4', _RxSO3_Act4_fwd, _RxSO3_Act4_jvp,
                       _RxSO3_Act4_vjp)
Sim3_Act4 = _function('Sim3_Act4', _Sim3_Act4_fwd, _Sim3_Act4_jvp,
                      _Sim3_Act4_vjp)


def _mul(name, forward, Adj, AdjT, m):
    """X Y: tangent dX + Adj(X) dY, cotangents (g, Adj(X)^T g)."""
    return _function(
        name, forward,
        lambda X, Y, out, dX, dY: _pad(dX[..., :m] + Adj(X, dY[..., :m]),
                                       out),
        lambda X, Y, out, g: (_grad(g[..., :m], X),
                              _grad(AdjT(X, g[..., :m]), Y)))


def _inv(name, forward, Adj, AdjT, m):
    """X^-1: tangent -Adj(out) dX, cotangent -Adj(out)^T g."""
    return _function(
        name, forward,
        lambda X, out, dX: _pad(-Adj(out, dX[..., :m]), out),
        lambda X, out, g: _grad(-AdjT(out, g[..., :m]), X))


def _adjxa(name, Adj, AdjT, adj, adjT, m):
    """Adj(X) a: out(t) = Adj(Exp(t d) X) a = Adj(Exp(t d)) out, so the
    tangent is ad(d) out + Adj(X) da = -ad(out) d + Adj(X) da."""
    return _function(
        name, Adj,
        lambda X, a, out, dX, da: _bcast(-adj(out, dX[..., :m])
                                         + Adj(X, da), out),
        lambda X, a, out, g: (_grad(-adjT(out, g), X),
                              _grad(AdjT(X, g), a)))


def _adjtxa(name, Inv, Adj, AdjT, adj, adjT, m):
    """Adj(X^-1) a: out(t) = Adj(X^-1 Exp(-t d)) a, so the tangent is
    Adj(X^-1) (ad(a) d + da)."""
    def backward(X, a, out, g):
        h = AdjT(Inv(X), g)
        return _grad(adjT(a, h), X), _grad(h, a)
    return _function(
        name, lambda X, a: Adj(Inv(X), a),
        lambda X, a, out, dX, da: _bcast(
            Adj(Inv(X), adj(a, dX[..., :m]) + da), out),
        backward)


SO3_Mul = _mul('SO3_Mul', _SO3_Mul_fwd, _qrot, _qrotT, 3)
SE3_Mul = _mul('SE3_Mul', _SE3_Mul_fwd, _SE3_Adj_apply, _SE3_AdjT_apply, 6)
RxSO3_Mul = _mul('RxSO3_Mul', _RxSO3_Mul_fwd, _RxSO3_Adj_apply,
                 _RxSO3_AdjT_apply, 4)
Sim3_Mul = _mul('Sim3_Mul', _Sim3_Mul_fwd, _Sim3_Adj_apply,
                _Sim3_AdjT_apply, 7)
SO3_Inv = _inv('SO3_Inv', _SO3_Inv_fwd, _qrot, _qrotT, 3)
SE3_Inv = _inv('SE3_Inv', _SE3_Inv_fwd, _SE3_Adj_apply, _SE3_AdjT_apply, 6)
RxSO3_Inv = _inv('RxSO3_Inv', _RxSO3_Inv_fwd, _RxSO3_Adj_apply,
                 _RxSO3_AdjT_apply, 4)
Sim3_Inv = _inv('Sim3_Inv', _Sim3_Inv_fwd, _Sim3_Adj_apply,
                _Sim3_AdjT_apply, 7)
SO3_AdjXa = _adjxa('SO3_AdjXa', _qrot, _qrotT, so3_adj_apply,
                   _so3_adjT_apply, 3)
SE3_AdjXa = _adjxa('SE3_AdjXa', _SE3_Adj_apply, _SE3_AdjT_apply,
                   se3_adj_apply, _se3_adjT_apply, 6)
RxSO3_AdjXa = _adjxa('RxSO3_AdjXa', _RxSO3_Adj_apply, _RxSO3_AdjT_apply,
                     rxso3_adj_apply, _rxso3_adjT_apply, 4)
Sim3_AdjXa = _adjxa('Sim3_AdjXa', _Sim3_Adj_apply, _Sim3_AdjT_apply,
                    sim3_adj_apply, _sim3_adjT_apply, 7)
SO3_AdjTXa = _adjtxa('SO3_AdjTXa', _SO3_Inv_fwd, _qrot, _qrotT,
                     so3_adj_apply, _so3_adjT_apply, 3)
SE3_AdjTXa = _adjtxa('SE3_AdjTXa', _SE3_Inv_fwd, _SE3_Adj_apply,
                     _SE3_AdjT_apply, se3_adj_apply, _se3_adjT_apply, 6)
RxSO3_AdjTXa = _adjtxa('RxSO3_AdjTXa', _RxSO3_Inv_fwd, _RxSO3_Adj_apply,
                       _RxSO3_AdjT_apply, rxso3_adj_apply,
                       _rxso3_adjT_apply, 4)
Sim3_AdjTXa = _adjtxa('Sim3_AdjTXa', _Sim3_Inv_fwd, _Sim3_Adj_apply,
                      _Sim3_AdjT_apply, sim3_adj_apply, _sim3_adjT_apply,
                      7)


# ---------------------------------------------------------------------------
# Jinvp: plain compositions of the ops, as in the JAX package
# ---------------------------------------------------------------------------

def SO3_Jinvp(X, p):
    """Jl^-1(Log(X)) p."""
    return so3_Jl_inv_apply(SO3_Log(X), p)


def SE3_Jinvp(X, p):
    return se3_Jl_inv_apply(SE3_Log(X), p)


def RxSO3_Jinvp(X, p):
    phis = RxSO3_Log(X)
    return _bcat([so3_Jl_inv_apply(phis[..., :3], p[..., :3]), p[..., 3:4]])


def Sim3_Jinvp(X, p):
    return _mv(sim3_Jl_inv(Sim3_Log(X)), p)
