"""The gradients the two learning examples train with, against the JAX
package's in float64 on the same inputs:

- ``examples/mpc_linear_learning.py``: d(imitation loss)/d(A, B) through
  MPC's final LQR pass (``pypose_tpu_torch.examples.mpc_linear_learning.
  imitation`` against the JAX script's ``loss_fn``, built here the same
  way), at the learner's initial (A, B) and at a perturbed pair;
- ``examples/imu_corrector.py``: d(loss)/d(gyro bias, acc bias) through
  IMUPreintegrator (``...examples.imu_corrector.bias_loss`` against the
  JAX script's ``loss_fn``), at zero biases and at nonzero ones.

Tolerance: 1e-9 of (1 + max|gradient|); the losses within 1e-12
relative.  Measured on the CPU: 6.7e-16 (MPC).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.module import IMUPreintegrator as JIMU
from pypose_tpu.module import LTI as JLTI, MPC as JMPC
from pypose_tpu.utils import ReduceToBason as JReduceToBason
from pypose_tpu_torch.examples import imu_corrector, mpc_linear_learning
from pypose_tpu_torch.testing import cap_threads

cap_threads()

TOL = 1e-9


def held(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= TOL * (1 + np.abs(want).max())


def jax_imitation():
    """The JAX script's run_mpc and loss_fn (examples/mpc_linear_learning.
    py:42-70) in float64."""
    ex = mpc_linear_learning
    dt = jnp.float64
    n_sc = ex.N_STATE + ex.N_CTRL
    C = jnp.eye(ex.N_STATE, dtype=dt)
    D = jnp.zeros((ex.N_STATE, ex.N_CTRL), dt)
    c1 = jnp.zeros(ex.N_STATE, dt)
    Q = jnp.tile(jnp.eye(n_sc, dtype=dt), (ex.N_BATCH, ex.T, 1, 1))
    p = jnp.tile(jnp.asarray(ex.P_COST, dt), (ex.N_BATCH, ex.T, 1))

    def run(A, B, x_init):
        mpc = JMPC(JLTI(A, B, C, D, c1, c1), Q, p, ex.T,
                   stepper=JReduceToBason(steps=1))
        return mpc(1, x_init)

    def loss(params, x_init, x_true, u_true):
        x_pred, u_pred, _ = run(params['A'], params['B'], x_init)
        return jnp.mean((u_true - u_pred) ** 2) + \
            jnp.mean((x_true - x_pred) ** 2)
    return run, loss


@pytest.mark.parametrize('shift', [0.0, 0.05])
def test_mpc_imitation_gradient_matches_jax(shift):
    ex = mpc_linear_learning
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(ex.N_BATCH, ex.N_STATE))
    A0 = np.asarray(ex.A_INIT) + shift * rng.normal(size=(3, 3))
    B0 = np.asarray(ex.B_INIT) + shift * rng.normal(size=(3, 3))
    with jax.enable_x64(True):
        jrun, jloss = jax_imitation()
        x = jnp.asarray(x0)
        xt, ut, _ = jrun(jnp.asarray(ex.A_TRUE, jnp.float64),
                         jnp.asarray(ex.B_TRUE, jnp.float64), x)
        jl, jg = jax.value_and_grad(jloss)(
            {'A': jnp.asarray(A0), 'B': jnp.asarray(B0)}, x, xt, ut)
    run, loss = ex.imitation('cpu', torch.float64)
    x = torch.tensor(x0)
    with torch.no_grad():
        txt, tut, _ = run(torch.tensor(ex.A_TRUE, dtype=torch.float64),
                          torch.tensor(ex.B_TRUE, dtype=torch.float64), x)
    held(txt, xt)
    held(tut, ut)
    A = torch.tensor(A0, requires_grad=True)
    B = torch.tensor(B0, requires_grad=True)
    l = loss(A, B, x, txt, tut)
    l.backward()
    assert abs(float(l.detach()) / float(jl) - 1) < 1e-12
    held(A.grad, jg['A'])
    held(B.grad, jg['B'])


def jax_bias_loss(F):
    """The JAX script's loss_fn (examples/imu_corrector.py:36-60) in
    float64."""
    dt64 = jnp.float64
    gb = jnp.asarray(imu_corrector.TRUE_GYRO_BIAS, dt64)
    ab = jnp.asarray(imu_corrector.TRUE_ACC_BIAS, dt64)
    dt = jnp.full((1, F, 1), 0.01, dt64)
    gyro_clean = jnp.broadcast_to(jnp.array([0., 0., 0.7], dt64), (1, F, 3))
    acc_clean = jnp.broadcast_to(jnp.array([0.5, 0., 9.81007], dt64),
                                 (1, F, 3))
    integ = JIMU(reset=True, prop_cov=False)
    gt = integ(dt, gyro_clean, acc_clean)
    gt_pos = gt['pos'][0, -1]
    gt_rot = gt['rot'][0, -1].tensor()

    def loss_fn(params):
        out = integ(dt, gyro_clean + gb - params['gyro_bias'],
                    acc_clean + ab - params['acc_bias'])
        rot_err = (out['rot'][0, -1].Inv() @ jpp.SO3(gt_rot)).Log().tensor()
        pos_err = out['pos'][0, -1] - gt_pos
        return jnp.sum(rot_err ** 2) + jnp.sum(pos_err ** 2)
    return loss_fn


@pytest.mark.parametrize('at', ['zero', 'near'])
def test_imu_corrector_gradient_matches_jax(at):
    F = 50
    bias = np.zeros(6) if at == 'zero' else \
        np.array([0.015, -0.02, 0.01, 0.05, 0.0, 0.1])
    with jax.enable_x64(True):
        jl, jg = jax.value_and_grad(jax_bias_loss(F))(
            {'gyro_bias': jnp.asarray(bias[:3]),
             'acc_bias': jnp.asarray(bias[3:])})
    loss, _, _ = imu_corrector.bias_loss(F, 'cpu', torch.float64)
    g = torch.tensor(bias[:3], requires_grad=True)
    a = torch.tensor(bias[3:], requires_grad=True)
    l = loss(g, a)
    l.backward()
    assert abs(float(l.detach()) / float(jl) - 1) < 1e-12
    held(g.grad, jg['gyro_bias'])
    held(a.grad, jg['acc_bias'])
