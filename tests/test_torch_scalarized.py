"""The port's scalarized SE3 pose-graph blocks against the JAX package at
E=500 on identical numpy inputs, and against the port's own LieTensor
residual.

Tolerances: float64 rtol/atol 1e-12; float32 rtol 1e-5 with atol 1e-5,
looser than the elementwise 1e-6 because r and J are chains of ~30
dependent products of O(1..10) values whose roundings differ between
XLA's fused order and torch's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.lietensor.scalarized import se3_pgo_blocks as jax_blocks
import pypose_tpu_torch as ppt
from pypose_tpu_torch.lietensor.scalarized import se3_pgo_blocks
from pypose_tpu_torch.testing import cap_threads

cap_threads()

TOL = {np.float32: dict(rtol=1e-5, atol=1e-5),
       np.float64: dict(rtol=1e-12, atol=1e-12)}


def random_se3(rng, n, scale=1.0):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([scale * rng.normal(size=(n, 3)), q], -1)


def edge_inputs(dtype, E=500):
    """Random endpoints and measurements (large residuals, angles up to
    pi), with exact measurements for half of the edges (zero residual,
    the Taylor branches)."""
    rng = np.random.default_rng(0)
    Xi, Xj = random_se3(rng, E, 3.0), random_se3(rng, E, 3.0)
    Z = random_se3(rng, E)
    exact = (ppt.SE3(torch.from_numpy(Xi)).Inv()
             @ ppt.SE3(torch.from_numpy(Xj))).tensor().numpy()
    Z[: E // 2] = exact[: E // 2]
    return [a.astype(dtype) for a in (Xi, Xj, Z)]


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_se3_pgo_blocks_match_jax(dtype):
    Xi, Xj, Z = edge_inputs(dtype)
    with jax.enable_x64(dtype == np.float64):
        r_j, J_j = (np.asarray(a) for a in jax_blocks(
            jnp.asarray(Xi), jnp.asarray(Xj), jnp.asarray(Z)))
    r_t, J_t = se3_pgo_blocks(torch.from_numpy(Xi), torch.from_numpy(Xj),
                              torch.from_numpy(Z))
    assert r_t.shape == (500, 6) and J_t.shape == (500, 6, 2, 6)
    assert r_t.dtype == torch.from_numpy(Xi).dtype
    np.testing.assert_allclose(r_t.numpy(), r_j, **TOL[dtype])
    np.testing.assert_allclose(J_t.numpy(), J_j, **TOL[dtype])
    np.testing.assert_array_equal(J_t[:, :, 0].numpy(), -J_t[:, :, 1].numpy())


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_scalarized_residual_matches_group_ops(dtype):
    """r equals Log(Z^-1 Xi^-1 Xj) through the LieTensor ops, the form
    SparseLM's chi2 uses."""
    Xi, Xj, Z = (torch.from_numpy(a) for a in edge_inputs(dtype))
    r, _ = se3_pgo_blocks(Xi, Xj, Z)
    ref = (ppt.SE3(Z).Inv() @ (ppt.SE3(Xi).Inv() @ ppt.SE3(Xj))).Log()
    np.testing.assert_allclose(r.numpy(), ref.tensor().numpy(),
                               **TOL[dtype])
