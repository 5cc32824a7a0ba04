"""The port's SO3/SE3 Lie core against the JAX package on identical numpy
inputs: the Taylor-guarded coefficients across their cutoffs, the
Jacobian matrices, and Exp/Log/Mul/Inv/Act/Adj/Matrix including small
angles, w < 0 and the quaternion double cover.

Tolerances: float32 rtol 1e-5 / atol 1e-6, float64 rtol/atol 1e-12, looser
only where a comment says why.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as pp
from pypose_tpu.lietensor import jacobian as jjac, operation as jop
import pypose_tpu_torch as ppt
from pypose_tpu_torch.lietensor import jacobian as tjac, operation as top
from pypose_tpu_torch.testing import assert_close
from pypose_tpu_torch.testing import cap_threads

cap_threads()

DTYPES = [np.float32, np.float64]
TOL = {np.float32: dict(rtol=1e-5, atol=1e-6),
       np.float64: dict(rtol=1e-12, atol=1e-12)}


def run_both(fn_j, fn_t, *arrays, dtype):
    """Same numpy inputs through the JAX and the torch function."""
    arrays = [np.asarray(a, dtype) for a in arrays]
    with jax.enable_x64(dtype == np.float64):
        out_j = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays]))
    out_t = fn_t(*[torch.from_numpy(a.copy()) for a in arrays]).numpy()
    assert out_t.dtype == out_j.dtype == dtype
    return out_j, out_t


def unit_quat(rng, n, dtype):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(dtype)


def tangents(rng, n, dim, dtype):
    """Tangent vectors whose rotation part spans every Taylor cutoff:
    angles 0, 1e-8 ... 3 rad, around 0.25, 0.5 and 1.0 on both sides."""
    angles = np.array([0.0, 1e-8, 1e-4, 0.1, 0.24, 0.26, 0.49, 0.51, 0.99,
                       1.01, 2.0, 3.0])
    angles = np.resize(angles, n)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    phi = axis * angles[:, None]
    if dim == 3:
        return phi.astype(dtype)
    return np.concatenate([rng.normal(size=(n, 3)), phi], -1).astype(dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', ['sinc1', 'cosc', 'sinc3', 'coef_Jl_inv',
                                  'coefQ2', 'coefQ3'])
def test_coefficients_across_cutoffs(name, dtype):
    theta = np.concatenate([np.linspace(0.0, 3.0, 301),
                            np.array([0.25, 0.5, 1.0]) - 1e-6,
                            np.array([0.25, 0.5, 1.0]) + 1e-6])
    j, t = run_both(getattr(jjac, name), getattr(tjac, name), theta,
                    dtype=dtype)
    np.testing.assert_allclose(t, j, **TOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name,dim', [('vec2skew', 3), ('so3_Jl', 3),
                                      ('so3_Jl_inv', 3), ('calcQ', 6),
                                      ('se3_Jl', 6), ('se3_Jl_inv', 6)])
def test_jacobian_matrices(name, dim, dtype):
    x = tangents(np.random.default_rng(0), 48, dim, dtype)
    j, t = run_both(getattr(jjac, name), getattr(tjac, name), x, dtype=dtype)
    np.testing.assert_allclose(t, j, **TOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name,dim', [('so3_Exp', 3), ('se3_Exp', 6)])
def test_exp(name, dim, dtype):
    x = tangents(np.random.default_rng(1), 48, dim, dtype)
    j, t = run_both(getattr(jop, name), getattr(top, name), x, dtype=dtype)
    np.testing.assert_allclose(t, j, **TOL[dtype])


def log_inputs(rng, dtype, se3):
    """Generic unit quaternions, w < 0, |v| below machine epsilon (the
    small-v branch), identity, and w = 0 (a half turn)."""
    eps = np.finfo(dtype).eps
    q = np.concatenate([
        unit_quat(rng, 20, np.float64),
        -np.abs(unit_quat(rng, 10, np.float64)),
        np.array([[eps / 10, 0, 0, 1], [0, -eps / 4, eps / 8, -1],
                  [0, 0, 0, 1], [0.6, 0, 0.8, 0]])]).astype(dtype)
    if se3:
        t = rng.normal(size=(q.shape[0], 3)).astype(dtype)
        return np.concatenate([t, q], -1)
    return q


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name,se3', [('SO3_Log', False), ('SE3_Log', True)])
def test_log_branches(name, se3, dtype):
    X = log_inputs(np.random.default_rng(2), dtype, se3)
    j, t = run_both(getattr(jop, name), getattr(top, name), X, dtype=dtype)
    np.testing.assert_allclose(t, j, **TOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
def test_log_double_cover(dtype):
    """q and -q are one rotation: the port's Log agrees on both (and with
    JAX on -q)."""
    q = unit_quat(np.random.default_rng(3), 32, dtype)
    j, t = run_both(jop.SO3_Log, top.SO3_Log, -q, dtype=dtype)
    np.testing.assert_allclose(t, j, **TOL[dtype])
    t_pos = top.SO3_Log(torch.from_numpy(q)).numpy()
    # the two logs differ by a full turn, so compare them as rotations;
    # float32: Exp(Log) round trips of angles up to 2 pi lose a few ulps
    # of 2 pi (~5e-7 each)
    assert_close(ppt.so3(torch.from_numpy(t)).Exp(),
                 ppt.so3(torch.from_numpy(t_pos)).Exp(),
                 atol=5e-6 if dtype == np.float32 else 1e-12)


def se3_storage(rng, n, dtype):
    t = rng.normal(size=(n, 3))
    return np.concatenate([t, unit_quat(rng, n, np.float64)], -1) \
        .astype(dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name,group', [
    ('SO3_Mul', 'SO3'), ('SE3_Mul', 'SE3'), ('SO3_AdjXa', 'SO3'),
    ('SE3_AdjXa', 'SE3'), ('SO3_Act', 'SO3'), ('SE3_Act', 'SE3')])
def test_binary_ops(name, group, dtype):
    rng = np.random.default_rng(4)
    X = unit_quat(rng, 30, dtype) if group == 'SO3' \
        else se3_storage(rng, 30, dtype)
    if name.endswith('Mul'):
        Y = unit_quat(rng, 30, dtype) if group == 'SO3' \
            else se3_storage(rng, 30, dtype)
    elif name.endswith('AdjXa'):
        Y = rng.normal(size=(30, 3 if group == 'SO3' else 6)).astype(dtype)
    else:
        Y = rng.normal(size=(30, 3)).astype(dtype)
    j, t = run_both(getattr(jop, name), getattr(top, name), X, Y,
                    dtype=dtype)
    np.testing.assert_allclose(t, j, **TOL[dtype])
    # broadcasting over a shared operand, as the JAX functions allow
    j, t = run_both(getattr(jop, name), getattr(top, name), X[:1], Y,
                    dtype=dtype)
    np.testing.assert_allclose(t, j, **TOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name,group', [
    ('SO3_Inv', 'SO3'), ('SE3_Inv', 'SE3'), ('SO3_Adj', 'SO3'),
    ('SE3_Adj', 'SE3'), ('SO3_Matrix', 'SO3'), ('SE3_Matrix', 'SE3')])
def test_unary_ops(name, group, dtype):
    rng = np.random.default_rng(5)
    X = unit_quat(rng, 30, dtype) if group == 'SO3' \
        else se3_storage(rng, 30, dtype)
    j, t = run_both(getattr(jop, name), getattr(top, name), X, dtype=dtype)
    np.testing.assert_allclose(t, j, **TOL[dtype])


def test_lietensor_api_matches_jax():
    """The LieTensor surface the slice uses: constructors, lshape,
    indexing, Exp/Log/Inv/@/Act and add as the left retraction."""
    rng = np.random.default_rng(6)
    x = tangents(rng, 12, 6, np.float32)
    d = (0.1 * rng.normal(size=(12, 6))).astype(np.float32)
    p = rng.normal(size=(12, 3)).astype(np.float32)
    Xj = pp.se3(jnp.asarray(x)).Exp()
    Xt = ppt.se3(torch.from_numpy(x)).Exp()
    assert Xt.ltype is ppt.lietensor.SE3_type
    assert tuple(Xt.lshape) == (12,) and tuple(Xt.shape) == (12, 7)
    cases = [
        (Xj.Log(), Xt.Log()),
        (Xj[2:5].Inv(), Xt[2:5].Inv()),
        (Xj @ Xj.Inv()[::-1], Xt @ ppt.SE3(Xt.Inv().tensor().flip(0))),
        (Xj.add(jnp.asarray(d)), Xt.add(torch.from_numpy(d))),
        (Xj.Act(jnp.asarray(p)), Xt.Act(torch.from_numpy(p))),
        (Xj @ jnp.asarray(p), Xt @ torch.from_numpy(p)),
        (Xj.Adj(jnp.asarray(d)), Xt.Adj(torch.from_numpy(d))),
        (Xj.matrix(), Xt.matrix()),
    ]
    for cj, ct in cases:
        cj = cj.tensor() if hasattr(cj, 'tensor') else cj
        ct = ct.tensor() if hasattr(ct, 'tensor') else ct
        np.testing.assert_allclose(np.asarray(ct), np.asarray(cj),
                                   **TOL[np.float32])
    assert tuple(ppt.identity_SE3(2, 3).lshape) == (2, 3)
    np.testing.assert_array_equal(ppt.identity_SO3(2).numpy(),
                                  np.asarray(pp.identity_SO3(2).tensor()))
    np.testing.assert_array_equal(ppt.identity_se3(4).numpy(), 0.0)
    assert Xt.to(torch.float64).dtype == torch.float64


def test_unported_groups_raise():
    """RxSO3 and Sim3, which raised until the remaining-groups slice, are
    real types now (tests/test_torch_groups.py holds them against the JAX
    package); what no type has still raises."""
    from pypose_tpu_torch.lietensor import Sim3_type, rxso3_type
    np.testing.assert_array_equal(
        Sim3_type.identity(2).numpy(),
        np.asarray(pp.identity_Sim3(2).tensor()))
    X = rxso3_type.Exp(torch.zeros(4))
    assert X.ltype.name == 'RxSO3'
    np.testing.assert_array_equal(X.numpy(), [0., 0., 0., 1., 1.])
    with pytest.raises(AttributeError):
        ppt.SE3(torch.zeros(7)).Exp()
    with pytest.raises(AttributeError):
        ppt.sim3(torch.zeros(7)).Log()


def test_lietensor_views_match_jax():
    """The batch-dim views ICP uses, and Act / @ of an unsqueezed SE3
    against a cloud, as in the JAX package (lietensor.py:642-668)."""
    rng = np.random.default_rng(7)
    x = tangents(rng, 6, 6, np.float32)
    p = rng.normal(size=(2, 5, 3)).astype(np.float32)
    Xj = pp.se3(jnp.asarray(x)).Exp()
    Xt = ppt.se3(torch.from_numpy(x)).Exp()
    cases = [
        (Xj.unsqueeze(-2), Xt.unsqueeze(-2), (6, 1, 7)),
        (Xj.unsqueeze(0).squeeze(0), Xt.unsqueeze(0).squeeze(0), (6, 7)),
        (Xj[:1].squeeze(), Xt[:1].squeeze(), (7,)),
        (Xj[:1].expand(4, 7), Xt[:1].expand(4, 7), (4, 7)),
        (Xj[:1].broadcast_to((3, 7)), Xt[:1].broadcast_to((3, 7)), (3, 7)),
        (Xj.reshape(2, 3, 7), Xt.reshape(2, 3, 7), (2, 3, 7)),
        (Xj.view(3, 2, 7), Xt.view(3, 2, 7), (3, 2, 7)),
        (Xj.lview(2, 3), Xt.lview(2, 3), (2, 3, 7)),
        (Xj[:2].unsqueeze(-2).Act(jnp.asarray(p)),
         Xt[:2].unsqueeze(-2).Act(torch.from_numpy(p)), (2, 5, 3)),
        (Xj[0].unsqueeze(-2) @ jnp.asarray(p[0]),
         Xt[0].unsqueeze(-2) @ torch.from_numpy(p[0]), (5, 3)),
    ]
    for cj, ct, shape in cases:
        if hasattr(ct, 'ltype'):
            assert ct.ltype is ppt.lietensor.SE3_type
        cj = cj.tensor() if hasattr(cj, 'tensor') else cj
        ct = ct.tensor() if hasattr(ct, 'tensor') else ct
        assert tuple(ct.shape) == shape
        np.testing.assert_allclose(np.asarray(ct), np.asarray(cj),
                                   **TOL[np.float32])
