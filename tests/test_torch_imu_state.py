"""IMUPreintegrator's state and gradients against the JAX package, the
second half of the IMU parity tests (test_torch_imu.py holds the first
and the helpers): the ``reset=False`` continuation over three calls
(every buffered state, ``Rij`` included), state carried over from the
JAX module by ``testing.module_state_from_numpy``, gradients against
``jax.grad``, and the module's buffers.  Tolerances as in
test_torch_imu.py: float64 1e-11; float32 states 1e-6 and covariance
1e-5 relative; gradients 1e-4 relative in float32, 1e-9 in float64.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu_torch as pp
from pypose_tpu.module import IMUPreintegrator as JIMU
from pypose_tpu_torch.module import IMUPreintegrator
from pypose_tpu_torch.testing import module_state_from_numpy

from test_torch_imu import (ATOL, DTYPES, STATE, arr, assert_outputs,
                            random_input, run_both)


@pytest.mark.parametrize('dtype', DTYPES)
def test_stateful_continuation_matches_jax(dtype):
    """reset=False, three calls: the outputs and every buffered state
    (pos, rot, vel, cov and Rij) after the last."""
    inputs = [random_input(10, s, dtype) for s in (1, 2, 3)]
    jout, tout, jstate, tm = run_both(dtype, inputs, reset=False,
                                      prop_cov=True)
    assert_outputs(jout, tout, dtype)
    for k, v in jstate.items():
        got = arr(tm.Rij if k == 'Rij' else getattr(tm, k))
        np.testing.assert_allclose(got, v, atol=ATOL[dtype] * (
            1 + np.abs(v).max()), err_msg=k)
    assert isinstance(tm.rot, pp.LieTensor) and tm.rot.ltype is \
        pp.identity_SO3().ltype
    assert tm.Rij.shape == (1, 1, 4)


def test_stateful_continuation_rotation():
    integ = IMUPreintegrator(reset=False, prop_cov=True, gravity=0.0)
    F = 10
    dt = torch.full((1, F, 1), 0.01)
    gyro = torch.tensor([0., 0., 1.0]).expand(1, F, 3)
    integ(dt, gyro, torch.zeros(1, F, 3))
    out2 = integ(dt, gyro, torch.zeros(1, F, 3))
    np.testing.assert_allclose(out2['rot'][0, -1].Log().tensor().numpy(),
                               [0., 0., 0.2], atol=1e-5)


@pytest.mark.parametrize('dtype', DTYPES)
def test_state_from_jax_module(dtype):
    """The JAX module's state after one call, carried into a fresh port
    module by module_state_from_numpy: the next call agrees."""
    x1, x2 = random_input(12, 4, dtype), random_input(12, 5, dtype)
    with jax.enable_x64(dtype == 'float64'):
        jm = JIMU(reset=False, prop_cov=True)
        jm(*(jnp.asarray(a) for a in x1))
        state = {k: arr(getattr(jm, k)) for k in STATE}
        state['Rij'] = arr(jm.Rij)
        jout = {k: arr(v) for k, v in
                jm(*(jnp.asarray(a) for a in x2)).items()}
    tm = module_state_from_numpy(
        IMUPreintegrator(reset=False, prop_cov=True,
                         dtype=getattr(torch, dtype)),
        state, ltypes={'Rij': 'SO3'})
    assert tm.Rij.ltype is tm.rot.ltype
    tout = {k: arr(v) for k, v in
            tm(*(torch.from_numpy(a) for a in x2)).items()}
    assert_outputs(jout, tout, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_gradient_matches_jax(dtype):
    """d/d(gyro) of sum(pos^2) + sum(Log(rot)^2) at F = 5, against
    jax.grad (the Lie ops' left-tangent rules on both sides)."""
    F = 5
    dt = np.full((1, F, 1), 0.01, dtype)
    acc = np.full((1, F, 3), 0.1, dtype)
    gyro = (0.2 + 0.1 * np.random.default_rng(10).normal(size=(1, F, 3))
            ).astype(dtype)
    with jax.enable_x64(dtype == 'float64'):
        jm = JIMU(reset=True, prop_cov=False, gravity=0.0)

        def jloss(g):
            out = jm(jnp.asarray(dt), g, jnp.asarray(acc))
            return jnp.sum(out['pos'] ** 2) + \
                jnp.sum(out['rot'].Log().tensor() ** 2)
        want = np.asarray(jax.grad(jloss)(jnp.asarray(gyro)))
    tm = IMUPreintegrator(reset=True, prop_cov=False, gravity=0.0,
                          dtype=getattr(torch, dtype))

    def tloss(g):
        out = tm(torch.from_numpy(dt), g, torch.from_numpy(acc))
        return torch.sum(out['pos'] ** 2) + \
            torch.sum(out['rot'].Log().tensor() ** 2)
    got = torch.func.grad(tloss)(torch.from_numpy(gyro)).numpy()
    assert np.abs(got).sum() > 0
    tol = 1e-4 if dtype == 'float32' else 1e-9
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(
        want).max())


def test_buffers_follow_inputs_and_refuse_no_state():
    with pytest.raises(RuntimeError):
        IMUPreintegrator(reset=False, prop_cov=False)
    m = IMUPreintegrator()
    assert set(dict(m.named_buffers())) == {
        'gravity', 'pos', 'rot', 'vel', 'cov', 'gyro_cov', 'acc_cov'}
    assert m.rot.ltype is pp.identity_SO3().ltype
    assert m.state_dict()['rot'].shape == (1, 1, 4)
