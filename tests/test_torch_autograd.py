"""The 32 autograd Functions of ``pypose_tpu_torch.lietensor.operation``
against the JAX package's ``jax.custom_jvp`` ops on the same numpy inputs
(CPU, float32 and float64): the value, the VJP (``torch.autograd.grad``
against ``jax.vjp``) and the JVP (``torch.func.jvp`` against ``jax.jvp``),
at generic points (the binary ops with a broadcast batch dim) and at the
identity or zero; ``jacrev`` against ``jacfwd``; ``vmap`` of the unbatched
call against the batched call; finite gradients at the identity; a
second derivative free of NaN.

Tolerances.  Each result is held within ``TOL[dtype] * (1 + max|want|)``:
1e-9 in float64 and 1e-5 in float32, and ten times that for the Sim3 and
sim3 ops, whose rules go through ``sim3_Jl`` / ``sim3_Jl_inv`` (28 7x7
products, 8 squarings and a batched solve: the two packages are 1.6e-5
apart in float32, ``tests/test_torch_groups.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.lietensor import operation as jop
import pypose_tpu_torch as ppt
from pypose_tpu_torch.lietensor import operation as top
from pypose_tpu_torch.testing import cap_threads

cap_threads()

TOL = {'float32': 1e-5, 'float64': 1e-9}
DTYPES = ['float32', 'float64']
# group -> (algebra, tangent dim, storage dim)
GROUPS = {'SO3': ('so3', 3, 4), 'SE3': ('se3', 6, 7),
          'RxSO3': ('rxso3', 4, 5), 'Sim3': ('sim3', 7, 8)}
ALGEBRA = {alg: g for g, (alg, _, _) in GROUPS.items()}
OPS = list(top.FUNCTIONS)


def test_one_function_each():
    """One Function for each of the JAX package's 32 custom_jvp ops, each
    with its own rules and functorch's vmap rule."""
    assert len(OPS) == 32
    for name, cls in top.FUNCTIONS.items():
        assert isinstance(getattr(jop, name), jax.custom_jvp), name
        assert issubclass(cls, torch.autograd.Function)
        assert cls.generate_vmap_rule
        for rule in ('forward', 'setup_context', 'backward', 'jvp'):
            assert getattr(cls, rule) is not getattr(
                torch.autograd.Function, rule), (name, rule)
        assert getattr(top, name) == cls.apply


def op_group(name):
    """The group an op belongs to, and its kind (Exp, Log, Act, ...)."""
    prefix, kind = name.split('_', 1)
    return ALGEBRA.get(prefix, prefix), kind


def algebra_points(group, n, rng, zero):
    """[n, tan] algebra elements: rotation angles up to ~2.5 and
    log-scales up to ~1, or zeros."""
    tan = GROUPS[group][1]
    if zero:
        return np.zeros((n, tan))
    x = rng.normal(size=(n, tan))
    if group in ('RxSO3', 'Sim3'):
        x[:, -1] *= 0.4
    rot = slice(0, 3) if group in ('SO3', 'RxSO3') else slice(3, 6)
    angle = np.linalg.norm(x[:, rot], axis=-1, keepdims=True)
    x[:, rot] *= np.minimum(1.0, 2.5 / angle)
    return x


def group_points(group, x, dtype):
    """Exp(x) computed by the JAX package in ``dtype``, as numpy."""
    with jax.enable_x64(dtype == 'float64'):
        alg = GROUPS[group][0]
        return np.asarray(getattr(jpp, alg)(
            jnp.asarray(x.astype(dtype))).Exp().tensor())


def inputs(name, dtype, identity):
    """The op's inputs as numpy arrays of ``dtype``, and which of them are
    group-valued.  At generic points a binary op's group input has batch
    [4, 1] against the other's [4, 2]; at the identity both are [8]."""
    group, kind = op_group(name)
    rng = np.random.default_rng(OPS.index(name))
    lead, other = ((8,), (8,)) if identity else ((4, 1), (4, 2))

    def grp(shape):
        x = algebra_points(group, int(np.prod(shape)), rng, identity)
        return group_points(group, x, dtype).reshape(shape + (-1,))
    if kind == 'Exp':
        x = algebra_points(group, 8, rng, identity)
        return [x.astype(dtype)], [False]
    if kind in ('Log', 'Inv'):
        return [grp((8,))], [True]
    X = grp(lead)
    if kind in ('Act', 'Act4'):
        p = 2.0 * rng.normal(size=other + (3,))
        if kind == 'Act4':
            p = np.concatenate([p, rng.normal(size=other + (1,))], -1)
        return [X, p.astype(dtype)], [True, False]
    if kind == 'Mul':
        return [X, grp(other)], [True, True]
    a = rng.normal(size=other + (GROUPS[group][1],))   # AdjXa, AdjTXa
    return [X, a.astype(dtype)], [True, False]


def tangent_like(arrays, on_group, rng):
    """Random tangents (zero tail for group inputs, the convention)."""
    out = []
    for a, g in zip(arrays, on_group):
        t = rng.normal(size=a.shape).astype(a.dtype)
        if g:
            t[..., -1] = 0.0    # every group's tail is its last entry
        out.append(t)
    return out


def tol(name, dtype):
    group, _ = op_group(name)
    return TOL[dtype] * (10.0 if group == 'Sim3' else 1.0)


def close(got, want, name, dtype, what):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol(name, dtype) * (1 + np.abs(want).max()),
        err_msg=f'{name} {dtype} {what}')


@pytest.mark.parametrize('point', ['generic', 'identity'])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', OPS)
def test_value_vjp_jvp_match_jax(name, dtype, point):
    arrays, on_group = inputs(name, dtype, point == 'identity')
    rng = np.random.default_rng(100 + OPS.index(name))
    t_op, j_op = getattr(top, name), getattr(jop, name)
    with jax.enable_x64(dtype == 'float64'):
        j_in = [jnp.asarray(a) for a in arrays]
        j_out, j_vjp = jax.vjp(j_op, *j_in)
        ct = rng.normal(size=j_out.shape).astype(dtype)
        j_grads = j_vjp(jnp.asarray(ct))
        tans = tangent_like(arrays, on_group, rng)
        _, j_tan = jax.jvp(j_op, tuple(j_in),
                           tuple(jnp.asarray(t) for t in tans))

    t_in = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    t_out = t_op(*t_in)
    close(t_out, j_out, name, dtype, 'value')
    t_grads = torch.autograd.grad(t_out, t_in, torch.from_numpy(ct))
    for i, (g, w) in enumerate(zip(t_grads, j_grads)):
        close(g, w, name, dtype, f'vjp of input {i}')
        assert torch.isfinite(g).all()
        if on_group[i]:
            tail = GROUPS[op_group(name)[0]][1]
            assert not g[..., tail:].any(), 'convention: zero tail'
    _, t_tan = torch.func.jvp(
        t_op, tuple(torch.from_numpy(a.copy()) for a in arrays),
        tuple(torch.from_numpy(t) for t in tans))
    close(t_tan, j_tan, name, dtype, 'jvp')


def one_sample(name):
    """float64 inputs of one unbatched sample."""
    arrays, _ = inputs(name, 'float64', False)
    return [torch.from_numpy(a.reshape(-1, a.shape[-1])[0].copy())
            for a in arrays]


@pytest.mark.parametrize('name', OPS)
def test_jacrev_matches_jacfwd(name):
    """Reverse mode (the backward rules) and forward mode (the jvp rules)
    give the same Jacobian, in float64 within 1e-12 (1e-10 for Sim3)."""
    x = one_sample(name)
    argnums = tuple(range(len(x)))
    op = getattr(top, name)
    rev = torch.func.jacrev(op, argnums=argnums)(*x)
    fwd = torch.func.jacfwd(op, argnums=argnums)(*x)
    bound = 1e-10 if op_group(name)[0] == 'Sim3' else 1e-12
    for r, f in zip(rev, fwd):
        assert r.shape == f.shape
        torch.testing.assert_close(r, f, rtol=0, atol=bound)


@pytest.mark.parametrize('name', OPS)
def test_vmap_matches_batched(name):
    """``vmap`` of the unbatched call (and of its pullback) equals the
    batched call, float64, within 1e-13."""
    arrays, _ = inputs(name, 'float64', True)
    x = [torch.from_numpy(a) for a in arrays]
    op = getattr(top, name)
    out = op(*x)
    torch.testing.assert_close(torch.func.vmap(op)(*x), out, rtol=0,
                               atol=1e-13)
    ct = torch.from_numpy(np.random.default_rng(3).normal(size=out.shape))
    x_req = [a.clone().requires_grad_() for a in x]
    grads = torch.autograd.grad(op(*x_req), x_req, ct)

    def pullback(*args):
        return torch.func.vjp(op, *args[:-1])[1](args[-1])
    for v, g in zip(torch.func.vmap(pullback)(*x, ct), grads):
        torch.testing.assert_close(v, g, rtol=0, atol=1e-13)


@pytest.mark.parametrize('name', OPS)
def test_grad_at_identity_finite(name):
    """float32 gradients of a scalar of the output at the identity (zero
    algebra, identity group) are finite: the rules' Taylor branches, not
    autograd of the forward's sqrt."""
    arrays, _ = inputs(name, 'float32', True)
    x = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = getattr(top, name)(*x)
    for g in torch.autograd.grad((out * out).sum() + out.sum(), x):
        assert torch.isfinite(g).all()


@pytest.mark.parametrize('group', list(GROUPS))
def test_second_order_does_not_nan(group):
    """tests/lietensor/test_grad.py:test_second_order_does_not_nan over
    each group: the gradient of |grad|^2 through Exp then Log is finite,
    at random tangents and at exactly zero."""
    alg = GROUPS[group][0]

    def loss(v):
        return torch.sum(getattr(ppt, alg)(v).Exp().Log().tensor() ** 2)

    def second(v):
        v = v.clone().requires_grad_()
        g, = torch.autograd.grad(loss(v), v, create_graph=True)
        h, = torch.autograd.grad(torch.sum(g ** 2), v)
        return h
    x = algebra_points(group, 3, np.random.default_rng(15), False)
    for v in (torch.from_numpy(0.2 * x), torch.zeros(3, GROUPS[group][1],
                                                     dtype=torch.float64)):
        assert torch.isfinite(second(v)).all()
