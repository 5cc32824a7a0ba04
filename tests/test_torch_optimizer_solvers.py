"""LM's solvers, robust kernels, correctors and block weights of the port
against the JAX package, a third of the tests/optim/test_optimizer.py
mirror (test_torch_optimizer.py holds the shared helpers).  Tolerances
as in test_torch_optimizer.py; the correctors' (R, J) within 1e-6.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.optim import corrector as jcorr, kernel as jkern, \
    solver as jsolv
import pypose_tpu_torch as pp
from pypose_tpu_torch.optim import corrector as tcorr, kernel as tkern, \
    solver as tsolv

from test_torch_optimizer import assert_run, draw, run


@pytest.mark.parametrize('name', ['PINV', 'LSTSQ', 'Cholesky', 'CG', 'PCG'])
def test_lm_solvers_converge(name):
    pose, inp = draw((2, 2), 2)
    assert_run(run(
        lambda m: jpp.optim.LM(m, solver=getattr(jsolv, name)()),
        lambda m: pp.optim.LM(m, solver=getattr(tsolv, name)()),
        pose, inp, 8), 'float32', 1e-7)


@pytest.mark.parametrize('name', ['Huber', 'Cauchy'])
def test_lm_kernel_corrector(name):
    pose, inp = draw((2, 2), 3)
    assert_run(run(
        lambda m: jpp.optim.LM(m, kernel=getattr(jkern, name)(delta=2.0)),
        lambda m: pp.optim.LM(m, kernel=getattr(tkern, name)(delta=2.0)),
        pose, inp, 10), 'float32', 1e-6)


def test_lm_triggs_corrector():
    pose, inp = draw((2, 2), 4)
    assert_run(run(
        lambda m: jpp.optim.LM(m, kernel=jkern.Huber(delta=2.0),
                               corrector=jcorr.Triggs(jkern.Huber(2.0))),
        lambda m: pp.optim.LM(m, kernel=tkern.Huber(delta=2.0),
                              corrector=tcorr.Triggs(tkern.Huber(2.0))),
        pose, inp, 10), 'float32', 1e-6)


@pytest.mark.parametrize('name', ['FastTriggs', 'Triggs'])
def test_correctors_match_jax(name):
    """(R, J) of each corrector on residuals past and within the Huber
    knee."""
    rng = np.random.default_rng(0)
    R = (rng.normal(size=(6, 3)) * [[0.1], [0.5], [1.0], [2.0], [3.0],
                                    [0.0]]).astype(np.float32)
    J = rng.normal(size=(18, 5)).astype(np.float32)
    jR, jJ = getattr(jcorr, name)(jkern.Huber(delta=1.5))(
        jnp.asarray(R), jnp.asarray(J))
    tR, tJ = getattr(tcorr, name)(tkern.Huber(delta=1.5))(
        torch.from_numpy(R), torch.from_numpy(J))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), rtol=1e-6,
                               atol=1e-6)
    assert tcorr.Trivial()(R=1, J=2) == (1, 2) and tcorr.Trivial()(3) == 3


def test_lm_weighted():
    pose, inp = draw((2, 2), 5)
    w = np.broadcast_to(2.0 * np.eye(6, dtype=np.float32), (2, 2, 6, 6))
    assert_run(run(
        lambda m: jpp.optim.LM(m, weight=jnp.asarray(w)),
        lambda m: pp.optim.LM(m, weight=torch.from_numpy(w.copy())),
        pose, inp, 8), 'float32', 1e-7)
