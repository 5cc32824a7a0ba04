"""IMUPreintegrator of the port against the JAX package on the same numpy
inputs: the closed-form checks of tests/module/test_imu.py (static,
constant acceleration, constant rotation, known rotation), the
closed-form covariance of tests/module/test_imu_covform.py on random
input and per-frame covariances on a batch, in float32 and float64
(test_torch_imu_state.py: the continuation, carried state and
gradients, with the helpers here).

Tolerances.  float64: 1e-11 (the same formulas; the scans combine in the
same order).  float32: states within 1e-6 absolute and the covariance
within 1e-5 relative at F <= 50: the JAX package jits the pipeline, and
XLA contracts the quaternion products into FMAs, which the port's eager
ops round apart (measured 3.6e-7 in rot, 3.0e-8 in vel, 4.7e-10 in a
covariance of 3.2e-3 at F = 50); gradients within 1e-4 relative in
float32, 1e-9 in float64.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.module import IMUPreintegrator as JIMU
import pypose_tpu_torch as pp
from pypose_tpu_torch.module import IMUPreintegrator
from pypose_tpu_torch.testing import cap_threads

cap_threads()

G = 9.81007
DTYPES = ['float32', 'float64']
ATOL = {'float32': 1e-6, 'float64': 1e-11}
COV_RTOL = {'float32': 1e-5, 'float64': 1e-11}
STATE = ('pos', 'rot', 'vel', 'cov', 'gyro_cov', 'acc_cov', 'gravity')


def arr(x):
    x = x.tensor() if hasattr(x, 'tensor') else x
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def random_input(F, seed, dtype, B=1):
    rng = np.random.default_rng(seed)
    dt = np.full((B, F, 1), 0.01, dtype)
    gyro = rng.normal(0, 0.3, (B, F, 3)).astype(dtype)
    acc = (rng.normal(0, 1.0, (B, F, 3)) + [0., 0., G]).astype(dtype)
    return dt, gyro, acc


def run_both(dtype, inputs, jkw=None, tkw=None, calls=1, **mod):
    """Each package's integrator on the same numpy inputs (a list of
    (dt, gyro, acc[, kwargs]) per call); returns the outputs of the last
    call and the two modules."""
    with jax.enable_x64(dtype == 'float64'):
        jm = JIMU(**mod)
        for x in inputs:
            jout = jm(*(jnp.asarray(a) for a in x[:3]),
                      **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                             else v) for k, v in (jkw or {}).items()})
        jout = {k: arr(v) for k, v in jout.items() if v is not None}
        jstate = {k: arr(getattr(jm, k)) for k in STATE}
        if jm.Rij is not None:
            jstate['Rij'] = arr(jm.Rij)
    tm = IMUPreintegrator(dtype=getattr(torch, dtype), **mod)
    for x in inputs:
        tout = tm(*(torch.from_numpy(a) for a in x[:3]),
                  **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                         else v) for k, v in (tkw or {}).items()})
    tout = {k: arr(v) for k, v in tout.items() if v is not None}
    return jout, tout, jstate, tm


def assert_outputs(jout, tout, dtype):
    assert set(jout) == set(tout)
    for k in jout:
        if k == 'cov':
            np.testing.assert_allclose(
                tout[k], jout[k], rtol=COV_RTOL[dtype],
                atol=COV_RTOL[dtype] * np.abs(jout[k]).max())
        else:
            np.testing.assert_allclose(tout[k], jout[k], atol=ATOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
def test_static_gravity_compensation(dtype):
    F = 20
    x = (np.full((1, F, 1), 0.01, dtype), np.zeros((1, F, 3), dtype),
         np.broadcast_to(np.array([0., 0., G], dtype), (1, F, 3)).copy())
    jout, tout, _, _ = run_both(dtype, [x], reset=True, prop_cov=True)
    assert_outputs(jout, tout, dtype)
    np.testing.assert_allclose(tout['pos'][0, -1], 0.0, atol=1e-4)
    np.testing.assert_allclose(tout['vel'][0, -1], 0.0, atol=1e-4)
    assert tout['cov'].shape == (1, 9, 9)
    assert (np.linalg.eigvalsh(tout['cov'][0].astype(np.float64))
            > -1e-12).all()


def test_constant_acceleration_and_rotation():
    F, dtv, a, wz = 50, 0.01, 2.0, 0.5
    dt = torch.full((1, F, 1), dtv)
    out = IMUPreintegrator(reset=True, prop_cov=False)(
        dt, torch.zeros(1, F, 3), torch.tensor([a, 0., G]).expand(1, F, 3))
    t = F * dtv
    np.testing.assert_allclose(float(out['pos'][0, -1, 0]), 0.5 * a * t ** 2,
                               rtol=1e-2)
    np.testing.assert_allclose(float(out['vel'][0, -1, 0]), a * t, rtol=1e-3)
    out = IMUPreintegrator(reset=True, prop_cov=False, gravity=0.0)(
        torch.full((1, 100, 1), dtv), torch.tensor([0., 0., wz]).expand(
            1, 100, 3), torch.zeros(1, 100, 3))
    np.testing.assert_allclose(out['rot'][0, -1].Log().tensor().numpy(),
                               [0., 0., wz * 100 * dtv], atol=1e-5)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('seed', [0, 3])
def test_closed_form_cov_matches_jax(dtype, seed):
    """test_imu_covform.py's input (F = 50, random gyro and acc)."""
    jout, tout, _, _ = run_both(dtype, [random_input(50, seed, dtype)],
                                reset=True, prop_cov=True)
    assert_outputs(jout, tout, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_known_rotation_matches_jax(dtype):
    F = 10
    dt, gyro, acc = random_input(F, 6, dtype)
    q = np.random.default_rng(7).normal(size=(1, F, 4))
    rot = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(dtype)
    with jax.enable_x64(dtype == 'float64'):
        jr = JIMU(reset=True, prop_cov=True)(
            jnp.asarray(dt), jnp.asarray(gyro), jnp.asarray(acc),
            rot=jpp.SO3(jnp.asarray(rot)))
        jr = {k: arr(v) for k, v in jr.items()}
    tr = IMUPreintegrator(reset=True, prop_cov=True,
                          dtype=getattr(torch, dtype))(
        torch.from_numpy(dt), torch.from_numpy(gyro), torch.from_numpy(acc),
        rot=pp.SO3(torch.from_numpy(rot)))
    assert_outputs(jr, {k: arr(v) for k, v in tr.items()}, dtype)
    free = IMUPreintegrator(reset=True, prop_cov=True,
                            dtype=getattr(torch, dtype))(
        torch.from_numpy(dt), torch.from_numpy(gyro), torch.from_numpy(acc))
    assert (free['pos'] - tr['pos']).abs().max() > 1e-3  # rot= mattered
    # identity rotations and gravity-only input: no motion
    out = IMUPreintegrator(reset=True, prop_cov=False)(
        torch.full((1, F, 1), 0.01), torch.zeros(1, F, 3),
        torch.tensor([0., 0., G]).expand(1, F, 3),
        rot=pp.identity_SO3(1, F))
    np.testing.assert_allclose(out['pos'][0, -1].numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize('dtype', DTYPES)
def test_batch_with_per_frame_covariances(dtype):
    """B = 3 with gyro_cov/acc_cov given per frame [B, F, 3]."""
    B, F = 3, 16
    x = random_input(F, 8, dtype, B=B)
    rng = np.random.default_rng(9)
    gc = (1e-5 * (1 + rng.random((B, F, 3)))).astype(dtype)
    ac = (1e-3 * (1 + rng.random((B, F, 3)))).astype(dtype)
    kw = {'gyro_cov': gc, 'acc_cov': ac}
    jout, tout, _, _ = run_both(dtype, [x], jkw=kw, tkw=kw, reset=True,
                                prop_cov=True)
    assert tout['cov'].shape == (B, 9, 9)
    assert_outputs(jout, tout, dtype)
