"""The plain versions of the port's SE3 kernels (``ops/se3.py``, on the
CPU: ``operation.SE3_Mul``/``SE3_Act``) against the JAX package's Pallas
kernels ``pallas_se3.se3_mul_fused``/``se3_act_fused``, run in interpret
mode as tests/ops/test_smallinv_pallas.py runs them, on identical numpy
inputs; and the wrappers' checks.

Tolerance: atol 1e-6 (1 + max|input|), a few float32 ulps: the same
formulas, with the product terms summed in another order.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import pypose_tpu_torch as ppt
from pypose_tpu.ops import pallas_se3
from pypose_tpu_torch.ops import se3 as tse3
from pypose_tpu_torch.testing import cap_threads

cap_threads()


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs['interpret'] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, 'pallas_call', interp_call)
    monkeypatch.setattr(pallas_se3.pl, 'pallas_call', interp_call)


def poses_and_points(N, seed):
    gen = torch.Generator().manual_seed(seed)
    X = ppt.randn_SE3(N, sigma=2.0, generator=gen).tensor().numpy()
    Y = ppt.randn_SE3(N, sigma=2.0, generator=gen).tensor().numpy()
    p = (5 * torch.randn((N, 3), generator=gen)).numpy()
    return X, Y, p


@pytest.mark.parametrize('N', [1, 1024, 1500])
def test_se3_plain_matches_pallas(interpret, N):
    """N = 1500 is not a multiple of the 1024-element Pallas tile."""
    X, Y, p = poses_and_points(N, N)
    for fused_t, fused_j, other in (
            (tse3.se3_mul_fused, pallas_se3.se3_mul_fused, Y),
            (tse3.se3_act_fused, pallas_se3.se3_act_fused, p)):
        out_t = fused_t(torch.from_numpy(X), torch.from_numpy(other))
        out_j = np.asarray(fused_j(jnp.asarray(X), jnp.asarray(other)))
        assert out_t.shape == out_j.shape == (N, other.shape[1])
        tol = 1e-6 * (1 + max(np.abs(X).max(), np.abs(other).max()))
        np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0, atol=tol)


def test_se3_wrappers_check_shapes():
    X, Y, p = poses_and_points(8, 0)
    X, Y, p = torch.from_numpy(X), torch.from_numpy(Y), torch.from_numpy(p)
    before = (tse3.SE3_MUL_LAUNCHES, tse3.SE3_ACT_LAUNCHES)
    for bad in ((X, p), (X[:4], Y), (X[:, :6], Y)):
        with pytest.raises(ValueError):
            tse3.se3_mul_fused(*bad)
    for bad in ((X, Y), (X, p[:4]), (X[None], p)):
        with pytest.raises(ValueError):
            tse3.se3_act_fused(*bad)
    # the plain versions ran on the CPU: nothing was launched
    tse3.se3_mul_fused(X, Y)
    tse3.se3_act_fused(X, p)
    assert (tse3.SE3_MUL_LAUNCHES, tse3.SE3_ACT_LAUNCHES) == before
