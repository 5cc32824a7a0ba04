r"""Differentiable nonlinear least squares by the implicit function
theorem.

Counterpart of ``pypose_tpu/optim/implicit.py``.  Forward: ``steps`` LM
iterations, not differentiated.  Backward: the IFT with the Gauss-Newton
Hessian,

    d theta* / d x = -(J^T J)^{-1} J^T dr/dx     at theta = theta*(x),

where J = dr/d(delta) in the left-tangent coordinates of theta.  The JAX
``custom_vjp`` is a ``torch.autograd.Function`` with
``generate_vmap_rule``, so the solve composes with ``torch.func.vmap``.
Cotangents of Lie-group outputs arrive in the left-tangent convention
(storage shape, zero tail), as everywhere in the port.
"""

import math

import torch
import torch.utils._pytree as pytree

from ..lietensor.lietensor import LieTensor


def _is_lie(x):
    return isinstance(x, LieTensor)


def _tan_dim(v):
    return v.ltype.manifold[0] if _is_lie(v) else v.shape[-1]


def _struct_leaves(tree):
    """Leaves with LieTensors kept whole."""
    return pytree.tree_leaves(tree, is_leaf=_is_lie)


def _tan_total(theta):
    return sum(math.prod(v.shape[:-1]) * _tan_dim(v)
               if len(v.shape) > 0 else 1 for v in _struct_leaves(theta))


def _retract_tree(theta, delta_flat):
    """Retract a flat tangent vector onto the (possibly Lie) pytree."""
    leaves, spec = pytree.tree_flatten(theta, is_leaf=_is_lie)
    out, off = [], 0
    for v in leaves:
        if _is_lie(v):
            t = _tan_dim(v)
            n = math.prod(v.shape[:-1])
            d = delta_flat[off:off + n * t].reshape(tuple(v.lshape) + (t,))
            out.append(v.add(d))
            off += n * t
        else:
            n = v.numel()
            out.append(v + delta_flat[off:off + n].reshape(v.shape))
            off += n
    return pytree.tree_unflatten(out, spec)


def _cotangent_flat(theta, grads):
    """The tangent-space cotangent of the storage gradients ``grads``
    (one per storage leaf of ``theta``, matching :func:`_retract_tree`)."""
    parts, k = [], 0
    for v in _struct_leaves(theta):
        g = grads[k]
        k += 1
        parts.append((g[..., :_tan_dim(v)] if _is_lie(v) else g).reshape(-1))
    return torch.cat(parts)


def least_squares(residual_fn, theta0, x, steps=10, damping=1e-6,
                  bwd_damping=1e-8):
    r"""Solve ``argmin_theta ||residual_fn(theta, x)||^2``, differentiably
    in ``x`` (implicit function theorem; the solve is not unrolled).

    Args:
        residual_fn: ``residual_fn(theta, x) -> tensor`` (any shape).
        theta0: initial guess pytree (may hold LieTensors).
        x: data pytree (may hold LieTensors).
        steps: LM iterations of the forward solve.
        damping: forward LM damping.
        bwd_damping: Tikhonov term of the backward normal equations.
    Returns:
        theta*: the solution, of ``theta0``'s structure.

    Ref: pypose_tpu/optim/implicit.py:80.
    """
    t_leaves, t_spec = pytree.tree_flatten(theta0)
    x_leaves, x_spec = pytree.tree_flatten(x)
    nt = len(t_leaves)

    def split(leaves):
        return (pytree.tree_unflatten(list(leaves[:nt]), t_spec),
                pytree.tree_unflatten(list(leaves[nt:]), x_spec))

    def rt(theta, delta_flat, xx):
        return residual_fn(_retract_tree(theta, delta_flat), xx).reshape(-1)

    def jac(theta, xx):
        z = torch.zeros(_tan_total(theta), dtype=t_leaves[0].dtype,
                        device=t_leaves[0].device)
        return torch.func.jacrev(lambda d: rt(theta, d, xx))(z), z

    class _Solve(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(*leaves):
            theta, xx = split(leaves)
            for _ in range(steps):
                J, z = jac(theta, xx)
                r = rt(theta, z, xx)
                A = J.transpose(0, 1) @ J
                A = A + damping * torch.diag_embed(
                    torch.clamp(torch.diagonal(A), 1e-10, 1e32))
                b = -(J.transpose(0, 1) @ r)
                theta = _retract_tree(theta, torch.linalg.solve(A, b))
            return tuple(pytree.tree_flatten(theta)[0])

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*output, *inputs[nt:])

        @staticmethod
        def backward(ctx, *grads):
            saved = ctx.saved_tensors
            theta, xx = split(saved)
            J, _ = jac(theta, xx)
            gtan = _cotangent_flat(theta, grads)
            T = J.shape[1]
            A = J.transpose(0, 1) @ J + bwd_damping * torch.eye(
                T, dtype=J.dtype, device=J.device)
            w = J @ torch.linalg.solve(A, gtan)
            # vjp of r with respect to x at (theta*, x), applied to -w
            _, pullback = torch.func.vjp(
                lambda *xl: residual_fn(
                    theta, pytree.tree_unflatten(list(xl), x_spec)
                ).reshape(-1), *saved[nt:])
            gx = pullback(-w)
            # at an exact optimum the solution does not depend on the start
            return tuple(torch.zeros_like(v) for v in saved[:nt]) + tuple(gx)

    out = _Solve.apply(*t_leaves, *x_leaves)
    return pytree.tree_unflatten(list(out), t_spec)
