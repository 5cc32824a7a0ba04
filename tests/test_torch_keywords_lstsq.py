"""The keywords the port refused (ROADMAP.md C8) and LSTSQ's answer on
rank-deficient and wide systems (C9), against the JAX package:

- ``lstsq_svd``, LSTSQ's route on CUDA (the SVD minimum-norm solve of
  ``jnp.linalg.lstsq``), and ``LSTSQ`` on the CPU (``torch.linalg.lstsq``
  with gelsy), on 5 x (6, 10) systems (EPnP's N = 4 beta system) and on
  5 x (6, 6) systems of rank 4 (its N = 3 system can lose rank), float32
  and float64: within 1e-5 (float32) and 1e-11 (float64) of (1 +
  magnitude) of ``jnp.linalg.lstsq`` (measured on the CPU: 9.5e-7 and
  4.8e-7 for LSTSQ in float32);
- ``SparseLM(solver=...)`` is accepted and ignored, as in the JAX package;
- ``BundleAdjustment(schur_precision=...)``: 'highest' forms the dense
  Schur Gram from the float32 values without the preconditioner's
  diagonal boost; one dense LM step against the JAX package's with
  ``jax.lax.Precision.HIGHEST``: chi2 before it within 2e-5; after it
  within 1e-7 (float64) and the poses and points within 1e-7 of the
  largest update (measured 3.9e-9 and 1.1e-8: both packages form the
  Gram in float32); in float32 within 1e-2 and 0.1, as the unboosted
  float32 factor makes the step ill-conditioned in both packages
  (measured below).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.optim import ba as jba
from pypose_tpu.optim.solver import LSTSQ as JLSTSQ
from pypose_tpu_torch.datasets import synthetic_bal
from pypose_tpu_torch.optim.ba import BundleAdjustment
from pypose_tpu_torch.optim.solver import LSTSQ, lstsq_svd
from pypose_tpu_torch.optim.sparse import SparseLM
from pypose_tpu_torch.testing import ring3_problem
from pypose_tpu_torch.testing import cap_threads

cap_threads()

TOL = {'float32': 1e-5, 'float64': 1e-11}


def systems(kind, dtype):
    rng = np.random.default_rng(0)
    if kind == 'wide':
        A = rng.normal(size=(5, 6, 10))
    else:
        A = rng.normal(size=(5, 6, 4)) @ rng.normal(size=(5, 4, 6))
    b = rng.normal(size=(5, 6))
    return A.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('kind', ['wide', 'rank4'])
def test_lstsq_matches_jax(kind, dtype):
    A, b = systems(kind, dtype)
    with jax.enable_x64(dtype == 'float64'):
        want = np.asarray(JLSTSQ()(jnp.asarray(A), jnp.asarray(b)))
        want_each = np.stack([np.asarray(jnp.linalg.lstsq(
            jnp.asarray(a), jnp.asarray(v))[0]) for a, v in zip(A, b)])
    np.testing.assert_allclose(want, want_each, rtol=0, atol=TOL[dtype])
    tA, tb = torch.from_numpy(A), torch.from_numpy(b)
    tol = TOL[dtype] * (1 + np.abs(want).max())
    for got in (lstsq_svd(tA, tb[..., None])[..., 0], LSTSQ()(tA, tb),
                LSTSQ()(tA, tb[..., None])[..., 0]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # the minimum-norm answer: orthogonal to A's null space
    x = lstsq_svd(tA, tb[..., None])[..., 0]
    _, S, Vh = torch.linalg.svd(tA)
    null = Vh[..., 4:, :] if kind == 'rank4' else Vh[..., 6:, :]
    assert float((null @ x[..., None]).abs().max()) <= tol


def test_lstsq_svd_rcond():
    """A given rcond cuts singular values below rcond * sigma_max; a
    negative one means eps, as in jnp.linalg.lstsq."""
    A = torch.diag(torch.tensor([1.0, 1e-3, 1e-9], dtype=torch.float64))
    b = torch.ones(3, 1, dtype=torch.float64)
    assert lstsq_svd(A, b, rcond=1e-6)[:, 0].tolist() == [1.0, 1e3, 0.0]
    with jax.enable_x64(True):
        for rcond in (None, -1.0, 1e-6):
            want = np.asarray(jnp.linalg.lstsq(jnp.asarray(A.numpy()),
                                               jnp.asarray(b.numpy()),
                                               rcond=rcond)[0])
            np.testing.assert_allclose(lstsq_svd(A, b, rcond).numpy(), want,
                                       rtol=1e-12)


def test_sparse_lm_takes_solver_and_ignores_it():
    """SparseLM(solver=...) (pypose_tpu/optim/sparse.py:153-160): stored,
    never read; the route and the steps are those without it."""
    params, factors, fixed = ring3_problem(dtype=torch.float64,
                                           device='cpu')
    a = SparseLM(params, factors, fixed=fixed, cg_iter=100, cg_tol=1e-10)
    b = SparseLM(params, factors, solver=LSTSQ(), fixed=fixed, cg_iter=100,
                 cg_tol=1e-10)
    assert b.route == a.route and isinstance(b.solver, LSTSQ)
    assert [b.step() for _ in range(2)] == [a.step() for _ in range(2)]


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_schur_precision_highest_matches_jax(dtype):
    """One dense LM step (8 cameras, 300 points) with the Gram at
    HIGHEST, against the JAX package's."""
    tdt = torch.float32 if dtype == 'float32' else torch.float64
    ds = synthetic_bal(8, 300, 4, seed=1, pose_noise=(0.1, 0.04),
                       point_noise=0.1, dtype=tdt, device='cpu')
    kw = dict(fix_first_pose=True, schur='dense', cg_iter=30)
    np_ = {k: (v.tensor() if hasattr(v, 'tensor') else v).numpy()
           for k, v in ds.items()}
    with jax.enable_x64(dtype == 'float64'):
        import pypose_tpu as jpp
        j = jba.BundleAdjustment(
            jpp.SE3(jnp.asarray(np_['poses'])), jnp.asarray(np_['points']),
            jnp.asarray(np_['cam_idx'].astype(np.int32)),
            jnp.asarray(np_['pt_idx'].astype(np.int32)),
            jnp.asarray(np_['pixels']), jnp.asarray(np_['cameras']),
            schur_precision=jax.lax.Precision.HIGHEST, **kw)
        jT, jX, jloss, jlast, jstrat, jcount = jax.jit(j._core)(
            jnp.asarray(np_['poses']), jnp.asarray(np_['points']),
            j.strategy.init(jnp.asarray(np_['points']).dtype), j._obs_data())
    t = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                         ds['pt_idx'], ds['pixels'], ds['cameras'],
                         schur_precision=jax.lax.Precision.HIGHEST, **kw)
    assert t.schur_precision == 'highest' and t._use_dense_schur
    tT, tX, tloss, tlast, tstrat, tcount, _ = t._core(
        ds['poses'].tensor(), ds['points'], t.strategy.init(t.dtype),
        t._obs_data())
    # float32 at HIGHEST factors S unboosted: its step is ill-conditioned
    # in both packages (measured: the JAX package's chi2 after it 523.74
    # and 524.76 in two runs of one program, the port's 522.96, float64's
    # 524.81; the port's update 4.5% off float64's)
    # float64: both packages form the Gram in float32, whose summation
    # order (it moves with torch's CPU thread count) sets the gap: chi2
    # 3.9e-9 at one thread, the update 1.1e-8
    chi_tol, x_tol = (1e-2, 0.1) if dtype == 'float32' else (1e-7, 1e-7)
    np.testing.assert_allclose(float(tlast), float(jlast), rtol=2e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=chi_tol)
    assert tcount == int(jcount) and float(tloss) < float(tlast)
    for got, want, start in ((tT, jT, np_['poses']), (tX, jX,
                                                     np_['points'])):
        step = np.abs(np.asarray(want) - start).max()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=x_tol * step)


def test_schur_precision_names():
    ds = synthetic_bal(4, 60, 3, seed=0, device='cpu')
    args = (ds['poses'], ds['points'], ds['cam_idx'], ds['pt_idx'],
            ds['pixels'], ds['cameras'])
    for given, want in ((None, 'default'), ('HIGH', 'high'),
                        ('highest', 'highest'),
                        (jax.lax.Precision.DEFAULT, 'default')):
        assert BundleAdjustment(*args, schur_precision=given
                                ).schur_precision == want
    with pytest.raises(ValueError):
        BundleAdjustment(*args, schur_precision='tf32')
