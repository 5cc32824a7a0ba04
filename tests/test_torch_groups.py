"""RxSO3, Sim3 and their algebras in the port against the JAX package on
the same numpy inputs (CPU, float32 and float64), and the operations the
port's SO3/SE3 gained with them (Act on 4-points, AdjT, Jinvp).

Tolerances.  Each result is held within ``TOL[dtype] * (1 + max|want|)``:
1e-6 in float32 and 1e-12 in float64, a few ulps of the largest entry
(both packages evaluate the same closed forms; products and sums round in
another order).  Two float32 exceptions, measured on the CPU and stated at
their cases: ``sim3_Jl`` / ``sim3_Jl_inv`` / ``Jinvp`` over Sim3 (a chain
of 28 7x7 products whose 8 squarings amplify each rounding, and a batched
solve: the two packages are 1.6e-5 apart at tangent norm 3, and each is
~3e-5 from the float64 value) and ``svdstf`` (an SVD of a 3x3 Gram
matrix: 1e-5).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.lietensor import jacobian as jjac
import pypose_tpu_torch as ppt
from pypose_tpu_torch.lietensor import basics as tbasics
from pypose_tpu_torch.lietensor import jacobian as tjac

TOL = {'float32': 1e-6, 'float64': 1e-12}
DTYPES = ['float32', 'float64']
GROUPS = {'RxSO3': ('rxso3', 4, 5), 'Sim3': ('sim3', 7, 8),
          'SO3': ('so3', 3, 4), 'SE3': ('se3', 6, 7)}


def close(got, want, dtype, factor=1.0):
    got = got.tensor() if isinstance(got, ppt.LieTensor) else got
    want = want.tensor() if isinstance(want, jpp.LieTensor) else want
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == \
        np.dtype(dtype)
    np.testing.assert_allclose(
        got, want, rtol=0,
        atol=factor * TOL[dtype] * (1 + np.abs(want).max()))


def tangents(group, dtype, n=64, seed=0, scale=1.0):
    """[n, tan] algebra elements: rotation angles up to ~2.5, log-scales
    up to ~1, with rows at zero and near the Taylor cut-offs."""
    tan = GROUPS[group][1]
    x = scale * np.random.default_rng(seed).normal(size=(n, tan))
    if group in ('RxSO3', 'Sim3'):
        x[:, -1] *= 0.4
    rot = slice(0, 3) if group in ('SO3', 'RxSO3') else slice(3, 6)
    angle = np.linalg.norm(x[:, rot], axis=-1, keepdims=True)
    x[:, rot] *= np.minimum(1.0, 2.5 / np.maximum(angle, 1e-30))
    x[0] = 0.0
    x[1] *= 1e-4
    x[2] *= 0.3
    return x.astype(dtype)


def both(group, x):
    """The group elements Exp(x) in both packages, from the JAX package's
    storage (so both start from the same bits)."""
    alg = GROUPS[group][0]
    X = getattr(jpp, alg)(jnp.asarray(x)).Exp()
    return X, getattr(ppt, group)(torch.from_numpy(np.array(X.tensor())))


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('group', ['RxSO3', 'Sim3'])
def test_exp_and_round_trip(group, dtype):
    x = tangents(group, dtype)
    alg = GROUPS[group][0]
    with jax.enable_x64(dtype == 'float64'):
        want = getattr(jpp, alg)(jnp.asarray(x)).Exp()
        got = getattr(ppt, alg)(torch.from_numpy(x)).Exp()
        assert got.ltype.name == group
        close(got, want, dtype)
        # Log(Exp(x)) = x where the angle stays below pi
        back = got.Log().tensor().numpy()
        np.testing.assert_allclose(back, x, rtol=0,
                                   atol=20 * TOL[dtype] * (1 + np.abs(x).max()))


OPS = ['Log', 'Inv', 'Mul', 'Act', 'Act4', 'Adj', 'AdjT', 'Jinvp', 'matrix',
       'parts']
NEW_FOR = {'SO3': ['Act4', 'AdjT', 'Jinvp'], 'SE3': ['Act4', 'AdjT', 'Jinvp']}
CASES = [(g, o) for g in ('RxSO3', 'Sim3') for o in OPS] + \
    [(g, o) for g, ops in NEW_FOR.items() for o in ops]
# float32 Jinvp over Sim3: the 7x7 product chain and solve (module docstring)
FACTOR = {('Sim3', 'Jinvp', 'float32'): 20.0}


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('group,op', CASES)
def test_group_op_matches_jax(group, op, dtype):
    rng = np.random.default_rng(1)
    tan = GROUPS[group][1]
    f = FACTOR.get((group, op, dtype), 1.0)
    with jax.enable_x64(dtype == 'float64'):
        jX, tX = both(group, tangents(group, dtype))
        jY, tY = both(group, tangents(group, dtype, seed=5))
        n = jX.shape[0]
        a = rng.normal(size=(n, tan)).astype(dtype)
        p3 = rng.normal(size=(n, 3)).astype(dtype)
        p4 = rng.normal(size=(n, 4)).astype(dtype)
        if op == 'Log':
            close(tX.Log(), jX.Log(), dtype)
        elif op == 'Inv':
            close(tX.Inv(), jX.Inv(), dtype)
        elif op == 'Mul':
            close(tX @ tY, jX @ jY, dtype)
            close(ppt.Mul(tX[:1], tY), jX[:1] @ jY, dtype)   # broadcast
        elif op == 'Act':
            close(tX.Act(torch.from_numpy(p3)), jX.Act(jnp.asarray(p3)),
                  dtype)
            close(tX.unsqueeze(1) @ torch.from_numpy(p3)[None, :5],
                  jX.unsqueeze(1).Act(jnp.asarray(p3)[None, :5]), dtype)
        elif op == 'Act4':
            close(tX.Act(torch.from_numpy(p4)), jX.Act(jnp.asarray(p4)),
                  dtype)
        elif op == 'Adj':
            got = tX.Adj(torch.from_numpy(a))
            assert got.ltype.name == GROUPS[group][0]
            close(got, jX.Adj(jnp.asarray(a)), dtype)
        elif op == 'AdjT':
            close(ppt.AdjT(tX, torch.from_numpy(a)),
                  jX.AdjT(jnp.asarray(a)), dtype)
        elif op == 'Jinvp':
            close(ppt.Jinvp(tX, torch.from_numpy(a)),
                  jX.Jinvp(jnp.asarray(a)), dtype, f)
        elif op == 'matrix':
            close(tX.matrix(), jX.matrix(), dtype)
            close(tX.Log().matrix(), jX.Log().matrix(), dtype)
        else:
            close(tX.rotation(), jX.rotation(), dtype)
            close(tX.translation(), jX.translation(), dtype)
            close(tX.scale(), jX.scale(), dtype)
            close(ppt.scale(tX.Log()), jX.Log().scale(), dtype)
            close(tX.euler(), jX.euler(), dtype)


@pytest.mark.parametrize('group', list(GROUPS))
def test_matrix_forms_match_jax(group):
    """Adj, Matrix, Matrix4x4 (and Rotation) of each group's operation
    module, float64."""
    from pypose_tpu.lietensor import operation as jop
    from pypose_tpu_torch.lietensor import operation as top
    names = ['Adj', 'Matrix', 'Matrix4x4'] + \
        (['Rotation'] if group == 'RxSO3' else [])
    with jax.enable_x64(True):
        jX, tX = both(group, tangents(group, 'float64', n=16))
        for name in names:
            fn = f'{group}_{name}'
            close(getattr(top, fn)(tX.tensor()),
                  getattr(jop, fn)(jX.tensor()), 'float64')
        # Adj(X) a as a matrix product
        a = torch.from_numpy(tangents(group, 'float64', n=16, seed=2))
        want = torch.einsum('nij,nj->ni',
                            getattr(top, group + '_Adj')(tX.tensor()), a)
        np.testing.assert_allclose(tX.Adj(a).tensor().numpy(), want.numpy(),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('theta,sigma', [(1e-3, 1e-3), (1e-3, 0.9),
                                         (1.3, 1e-3), (1.3, -0.9),
                                         (0.0, 0.0), (3.0, 2.0)])
def test_rxso3_Ws_regimes(theta, sigma, dtype):
    """theta and sigma each below and above ``_cut`` (0.5 in float32, 0.25
    in float64): the double series, the T_m recursion and the closed
    forms, plus the origin and a large element."""
    rng = np.random.default_rng(2)
    axis = rng.normal(size=(32, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    x = np.concatenate([theta * axis, np.full((32, 1), sigma)], -1)
    x = x.astype(dtype)
    tau = rng.normal(size=(32, 3)).astype(dtype)
    with jax.enable_x64(dtype == 'float64'):
        close(tjac.rxso3_Ws(torch.from_numpy(x)), jjac.rxso3_Ws(jnp.asarray(x)),
              dtype)
        close(tjac.rxso3_Ws_apply(torch.from_numpy(x), torch.from_numpy(tau)),
              jjac.rxso3_Ws_apply(jnp.asarray(x), jnp.asarray(tau)), dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('norm', [1e-4, 0.5, 3.0])
def test_sim3_Jl_and_inverse(norm, dtype):
    """float32: Jl within 1e-5 (1 + max|Jl|) and Jl_inv within 2e-5 (1 +
    max|Jl_inv|) of the JAX package's.  Measured at tangent norms 0.5 and
    3: Jl 1.4e-5 and 1.6e-5 apart, Jl_inv 1.1e-5 and 8.7e-6, while each
    package's float32 Jl is 1.6e-5 to 3.4e-5 from the float64 value (XLA's
    dot sums as an FMA chain, torch's CPU matmul rounds each product, and
    the 8 squarings of the scaling-and-squaring chain amplify either);
    float64 within 2e-12 and 1e-11."""
    x = np.random.default_rng(3).normal(size=(48, 7))
    x = (norm * x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(dtype)
    with jax.enable_x64(dtype == 'float64'):
        close(tjac.sim3_Jl(torch.from_numpy(x)), jjac.sim3_Jl(jnp.asarray(x)),
              dtype, 10.0 if dtype == 'float32' else 2.0)
        Ji = tjac.sim3_Jl_inv(torch.from_numpy(x))
        close(Ji, jjac.sim3_Jl_inv(jnp.asarray(x)), dtype,
              20.0 if dtype == 'float32' else 10.0)
    eye = torch.eye(7, dtype=Ji.dtype).expand(Ji.shape)
    assert float((Ji @ tjac.sim3_Jl(torch.from_numpy(x)) - eye).abs().max()) \
        <= (1e-4 if dtype == 'float32' else 1e-12)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', ['so3_Jr', 'so3_adj', 'se3_adj', 'rxso3_Jl',
                                  'rxso3_Jl_inv', 'rxso3_adj', 'sim3_adj'])
def test_jacobian_helper_matches_jax(name, dtype):
    tan = {'so3': 3, 'se3': 6, 'rxso3': 4, 'sim3': 7}[name.split('_')[0]]
    x = np.random.default_rng(4).normal(size=(16, tan)).astype(dtype)
    with jax.enable_x64(dtype == 'float64'):
        close(getattr(tjac, name)(torch.from_numpy(x)),
              getattr(jjac, name)(jnp.asarray(x)), dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', ['so3', 'se3', 'rxso3', 'sim3'])
def test_adj_apply_is_adj_times_v(name, dtype):
    tan = {'so3': 3, 'se3': 6, 'rxso3': 4, 'sim3': 7}[name]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(16, tan)).astype(dtype))
    v = torch.from_numpy(rng.normal(size=(16, tan)).astype(dtype))
    want = torch.einsum('nij,nj->ni', getattr(tjac, name + '_adj')(x), v)
    got = getattr(tjac, name + '_adj_apply')(x, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=10 * TOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('group', ['RxSO3', 'Sim3'])
def test_matrix_conversions(group, dtype):
    """mat2Sim3 / mat2RxSO3 / from_matrix on the JAX package's matrices,
    3x3, 3x4 and 4x4."""
    with jax.enable_x64(dtype == 'float64'):
        jX, tX = both(group, tangents(group, dtype, scale=0.7))
        M = np.array(jX.matrix())
        to = {'RxSO3': (ppt.mat2RxSO3, jpp.mat2RxSO3),
              'Sim3': (ppt.mat2Sim3, jpp.mat2Sim3)}[group]
        views = [M] if group == 'RxSO3' else [M, M[:, :3, :], M[:, :3, :3]]
        for m in views:
            close(to[0](torch.from_numpy(m)), to[1](jnp.asarray(m)), dtype,
                  4.0)
        ltypes = getattr(ppt.lietensor, group + '_type'), \
            getattr(jpp, group + '_type')
        close(ppt.from_matrix(torch.from_numpy(M), ltypes[0]),
              jpp.from_matrix(jnp.asarray(M), ltypes[1]), dtype, 4.0)
    with pytest.raises(ValueError, match='full rank'):
        to[0](torch.zeros(3, 3, dtype=getattr(torch, dtype)))
    with pytest.raises(ValueError, match='ltype'):
        ppt.from_matrix(torch.eye(3), ppt.lietensor.so3_type)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('with_scale', [True, False])
def test_svdstf_matches_jax(with_scale, dtype):
    """float32 within 1e-5 (1 + max|T|): the 3x3 SVD's rounding."""
    rng = np.random.default_rng(6)
    src = rng.normal(size=(2, 40, 3)).astype(dtype)
    with jax.enable_x64(dtype == 'float64'):
        jT = jpp.randn_Sim3(2, sigma=(0.5, 0.4, 0.2),
                            key=jax.random.PRNGKey(0), dtype=dtype)
        tgt = np.array(jT.unsqueeze(1).Act(jnp.asarray(src)))
        want = jpp.svdstf(jnp.asarray(src), jnp.asarray(tgt),
                          with_scale=with_scale)
        got = ppt.svdstf(torch.from_numpy(src), torch.from_numpy(tgt),
                         with_scale=with_scale)
        assert got.ltype.name == 'Sim3'
        close(got, want, dtype, 10.0)
        if with_scale:
            close(got, jT, dtype, 30.0)
    with pytest.raises(ValueError, match='number of points'):
        ppt.svdstf(torch.zeros(4, 3), torch.zeros(5, 3))


@pytest.mark.parametrize('group', ['RxSO3', 'Sim3'])
def test_stack_cat_split(group):
    jX, tX = both(group, tangents(group, 'float32', n=6))
    jY, tY = both(group, tangents(group, 'float32', n=6, seed=9))
    jb = jpp.lietensor.basics
    close(tbasics.stack([tX, tY], dim=1), jb.stack([jX, jY], dim=1), 'float32')
    close(tbasics.cat([tX, tY]), jb.cat([jX, jY]), 'float32')
    for sections in (4, [1, 2, 3]):
        got = tbasics.split(tX, sections)
        want = jb.split(jX, sections)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.ltype is tX.ltype
            close(g, w, 'float32')
    with pytest.raises(TypeError, match='ltype mismatch'):
        tbasics.cat([tX, tX.Log()])


@pytest.mark.parametrize('alg', ['rxso3', 'sim3'])
def test_algebra_arithmetic_and_factories(alg):
    group = {'rxso3': 'RxSO3', 'sim3': 'Sim3'}[alg]
    tan, dim = GROUPS[group][1:]
    x = getattr(ppt, alg)(torch.from_numpy(tangents(group, 'float32', n=5)))
    jx = getattr(jpp, alg)(jnp.asarray(x.tensor().numpy()))
    close(tbasics.add(x, x.tensor(), alpha=0.5), jx.add(jx.tensor(), 0.5),
          'float32')
    close(tbasics.mul(x, 2.0), jx.mul(2.0), 'float32')
    close(2.0 * x, 2.0 * jx, 'float32')
    close(-x, -jx, 'float32')
    close(ppt.Inv(x), jx.Inv(), 'float32')
    X = x.Exp()
    jX = jx.Exp()
    d = torch.from_numpy(tangents(group, 'float32', n=5, seed=3))
    # retraction: a storage-shaped step adds through its first m channels
    step = torch.cat([d, torch.ones(5, dim - tan)], -1)
    close(X + step, jX + jnp.asarray(step.numpy()), 'float32')
    close(ppt.Retr(X, getattr(ppt, alg)(d)),
          jX.Retr(getattr(jpp, alg)(jnp.asarray(d.numpy()))), 'float32')
    ident = getattr(ppt, 'identity_' + group)(2, 3)
    close(ident, getattr(jpp, 'identity_' + group)(2, 3), 'float32')
    close(ppt.identity_like(X), jX.identity_like(), 'float32')
    assert ppt.identity_like(x).ltype is x.ltype
    assert float(ppt.identity_like(x).tensor().abs().max()) == 0.0
    with pytest.raises(NotImplementedError):
        x.Jr()


@pytest.mark.parametrize('alg,sigma', [('rxso3', 0.3), ('rxso3', (0.3, 0.1)),
                                       ('sim3', 0.3),
                                       ('sim3', (0.5, 0.3, 0.1)),
                                       ('sim3', (1., 2., 3., 0.3, 0.1))])
def test_randn_draw_order_and_sigmas(alg, sigma):
    """The draws in the JAX package's order (rotation axis and angle, then
    log-scale, then translation), from the generator alone; the group's
    randn is Exp of the algebra's."""
    n = 4000
    fn = getattr(ppt, 'randn_' + alg)
    x = fn(n, sigma=sigma, generator=torch.Generator().manual_seed(0),
           dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    axis = torch.randn((n, 3), generator=g, dtype=torch.float64)
    s = (sigma,) * 5 if not isinstance(sigma, tuple) else sigma
    if alg == 'rxso3':
        s_rot, s_scale, s_t = s[0], s[1], None
    else:
        s = s if len(s) == 5 else (s[0],) * 3 + s[1:]
        s_rot, s_scale, s_t = s[3], s[4], torch.tensor(s[:3]).double()
    rot = axis / axis.norm(dim=-1, keepdim=True) * s_rot * torch.randn(
        (n, 1), generator=g, dtype=torch.float64)
    scale = s_scale * torch.randn((n, 1), generator=g, dtype=torch.float64)
    parts = [rot, scale]
    if s_t is not None:
        parts.insert(0, s_t * torch.randn((n, 3), generator=g,
                                          dtype=torch.float64))
    torch.testing.assert_close(x.tensor(), torch.cat(parts, -1))
    X = getattr(ppt, 'randn_' + {'rxso3': 'RxSO3', 'sim3': 'Sim3'}[alg])(
        n, sigma=sigma, generator=torch.Generator().manual_seed(0),
        dtype=torch.float64)
    torch.testing.assert_close(X.tensor(), x.Exp().tensor())
    like = ppt.randn_like(X[:7], sigma=sigma,
                          generator=torch.Generator().manual_seed(1))
    assert like.ltype is X.ltype and like.shape == X[:7].shape
    with pytest.raises(ValueError):
        fn(2, sigma=(0.1,) * 4, generator=torch.Generator().manual_seed(0))


def test_quat2unit_and_accessors():
    X = ppt.Sim3(torch.tensor([[1., 2., 3., 0., 0., 0., 2., 1.5]]))
    close(ppt.quat2unit(X), jpp.quat2unit(jpp.Sim3(
        jnp.asarray(X.tensor().numpy()))), 'float32')
    R = ppt.RxSO3(torch.tensor([[0., 3., 0., 4., 2.]]))
    close(ppt.quat2unit(R), jpp.quat2unit(jpp.RxSO3(
        jnp.asarray(R.tensor().numpy()))), 'float32')
    with pytest.warns(UserWarning, match='not Lie group'):
        assert ppt.quat2unit(X.Log()).ltype.name == 'sim3'
    assert ppt.lietensor.tensor(X) is X.tensor()
    assert tuple(ppt.matrix(X).shape) == (1, 4, 4)
    assert tuple(ppt.rotation(R).shape) == (1, 4)
    assert tuple(ppt.translation(R).shape) == (1, 3)
    assert tuple(ppt.euler(R).shape) == (1, 3)
    assert tuple(ppt.vec2skew(torch.ones(2, 3)).shape) == (2, 3, 3)
    with pytest.raises(ValueError, match='3 or 4'):
        X.Act(torch.zeros(1, 5))
    with pytest.raises(TypeError, match='LieTensor'):
        ppt.Exp(torch.zeros(3))
