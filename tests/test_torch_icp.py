"""The port's ICP against the JAX package's on identical numpy clouds: a
small cloud (dense knn), a batch with an initial transform, a 9,000-point
cloud (81M pairs: the auto-tiled Gram path on both sides), and the
straight-through Kabsch gradient.

Tolerances: transforms within 1e-5 in ``Log(T_port^-1 T_jax)``, and
within 1e-4 of the ground truth (float32 Kabsch on converged matches);
gradients within rtol 1e-3, atol 1e-5 (a 3x3 SVD's derivative from two
LAPACK implementations).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as pp
from pypose_tpu.module import ICP as JICP
from pypose_tpu.utils import ReduceToBason as JReduceToBason
import pypose_tpu_torch as ppt
from pypose_tpu_torch.function import geometry as tgeo
from pypose_tpu_torch.testing import assert_close


def instance(N, batch=(), scale=1.0, sigma=(0.2, 0.1), seed=0):
    """Numpy source cloud, ground-truth SE3 storage and target cloud."""
    rng = np.random.default_rng(seed)
    src = (scale * rng.normal(size=batch + (N, 3))).astype(np.float32)
    T = ppt.randn_SE3(*batch, sigma=sigma,
                      generator=torch.Generator().manual_seed(seed))
    tgt = T.unsqueeze(-2).Act(torch.from_numpy(src)).numpy()
    return src, T.tensor().numpy(), tgt


def as_port(T_j):
    return ppt.SE3(torch.from_numpy(np.array(T_j.tensor())))


def test_icp_small_cloud_matches_jax():
    src, T, tgt = instance(200)
    T_t = ppt.ICP()(torch.from_numpy(src), torch.from_numpy(tgt))
    T_j = JICP()(jnp.asarray(src), jnp.asarray(tgt))
    assert T_t.shape == (7,)
    assert_close(T_t, as_port(T_j), atol=1e-5)
    assert_close(T_t, ppt.SE3(torch.from_numpy(T)), atol=1e-4)


def test_icp_batched_with_init_matches_jax():
    """Two clouds, each with its own transform, and an initial guess that
    is half of it (through the constructor and through forward)."""
    src, T, tgt = instance(150, batch=(2,), sigma=(0.4, 0.3), seed=1)
    init = ppt.SE3(torch.from_numpy(T)).Log()
    init = ppt.se3(0.5 * init.tensor()).Exp()
    init_np = init.tensor().numpy()
    T_j = JICP(init=pp.SE3(jnp.asarray(init_np)))(jnp.asarray(src),
                                                  jnp.asarray(tgt))
    for T_t in (ppt.ICP(init=init)(torch.from_numpy(src),
                                   torch.from_numpy(tgt)),
                ppt.ICP()(torch.from_numpy(src), torch.from_numpy(tgt),
                          init=init)):
        assert T_t.shape == (2, 7)
        assert_close(T_t, as_port(T_j), atol=1e-5)
        assert_close(T_t, ppt.SE3(torch.from_numpy(T)), atol=1e-4)
    with pytest.raises(TypeError):
        ppt.ICP(init=ppt.identity_SO3())
    with pytest.raises(TypeError):
        ppt.ICP()(torch.from_numpy(src), torch.from_numpy(tgt),
                  init=init.tensor())


def test_icp_9000_points_auto_tiled_matches_jax(monkeypatch):
    """81M pairs, past the 64 Mi dense limit: both packages take their
    chunked Gram path (chunk 7456) without being told to; ``bench.py``'s
    ICP settings (points scaled by 5, 8 sweeps)."""
    calls = []
    orig = tgeo._knn_tiled
    monkeypatch.setattr(tgeo, '_knn_tiled',
                        lambda *a: calls.append(a[-1]) or orig(*a))
    src, T, tgt = instance(9000, scale=5.0, sigma=(0.3, 0.05), seed=3)

    def stepper(cls):
        return cls(steps=8, patience=8, tol=1e-9)
    T_t = ppt.ICP(stepper=stepper(ppt.ReduceToBason))(
        torch.from_numpy(src), torch.from_numpy(tgt))
    T_j = JICP(stepper=stepper(JReduceToBason))(jnp.asarray(src),
                                                jnp.asarray(tgt))
    assert calls and set(calls) == {7456}
    assert_close(T_t, as_port(T_j), atol=1e-5)
    assert_close(T_t, ppt.SE3(torch.from_numpy(T)), atol=1e-4)


def test_icp_gradient_matches_jax():
    """d sum(T^2) / d source through the straight-through Kabsch
    surrogate (icp.py:108-116)."""
    src, _, tgt = instance(60, seed=2)
    g_j = np.asarray(jax.grad(
        lambda s: jnp.sum(JICP()(s, jnp.asarray(tgt)).tensor() ** 2))(
            jnp.asarray(src)))
    s = torch.from_numpy(src).requires_grad_(True)
    out = ppt.ICP()(s, torch.from_numpy(tgt))
    (out.tensor() ** 2).sum().backward()
    assert s.grad.shape == (60, 3) and np.abs(g_j).max() > 1e-3
    np.testing.assert_allclose(s.grad.numpy(), g_j, rtol=1e-3, atol=1e-5)
