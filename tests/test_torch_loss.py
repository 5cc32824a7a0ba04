"""``module/loss.py`` (``geodesic_loss``, ``GeodesicLoss``) against the
JAX package on the same numpy-drawn group elements: SO3, SE3, RxSO3 and
Sim3 inputs (their rotation parts), every reduction, float32 and float64,
within 1e-5 (float32) and 1e-12 (float64) of (1 + magnitude)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.module import GeodesicLoss as JGeodesicLoss
import pypose_tpu_torch as ppt
from pypose_tpu_torch.module import GeodesicLoss
from pypose_tpu_torch.testing import cap_threads

cap_threads()

TAN = {'SO3': 'so3', 'SE3': 'se3', 'RxSO3': 'rxso3', 'Sim3': 'sim3'}
DIM = {'so3': 3, 'se3': 6, 'rxso3': 4, 'sim3': 7}


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('group', list(TAN))
def test_geodesic_loss_matches_jax(group, dtype):
    rng = np.random.default_rng(4)
    alg = TAN[group]
    a, b = (0.8 * rng.normal(size=(5, DIM[alg]))).astype(dtype), \
        (0.8 * rng.normal(size=(5, DIM[alg]))).astype(dtype)
    x = getattr(ppt, alg)(torch.from_numpy(a)).Exp()
    y = getattr(ppt, alg)(torch.from_numpy(b)).Exp()
    tol = 1e-5 if dtype == 'float32' else 1e-12
    with jax.enable_x64(dtype == 'float64'):
        jx = getattr(jpp, alg)(jnp.asarray(a)).Exp()
        jy = getattr(jpp, alg)(jnp.asarray(b)).Exp()
        for reduction in ('none', 'mean', 'sum'):
            want = np.asarray(JGeodesicLoss(reduction)(jx, jy))
            got = GeodesicLoss(reduction)(x, y).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=tol * (1 + np.abs(want).max()))
            np.testing.assert_allclose(
                ppt.geodesic_loss(x, y, reduction).numpy(), got, rtol=0,
                atol=0)
    with pytest.raises(ValueError):
        ppt.geodesic_loss(x, y, 'max')
    with pytest.raises(TypeError):
        ppt.geodesic_loss(x.tensor(), y)
