"""The port's rigid alignment, matrix conversions, type check and loop
controller against the JAX package on identical numpy inputs:
``svdtf`` (including a reflected cloud), ``mat2SO3``/``mat2SE3`` over the
four extraction branches and 3x3, 3x4 and 4x4 inputs with their checks,
``is_SE3``, and ``ReduceToBason``'s step sequences.

Tolerances: quaternions and transforms within atol 1e-6 (float32) and
1e-12 (float64) of JAX's, the same formulas in the same order; Kabsch
transforms within 1e-5 in ``Log(T_port^-1 T_jax)`` (a 3x3 SVD from
different LAPACK implementations).  The stepper's decisions are compared
exactly.
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as pp
from pypose_tpu.function.checking import is_SE3 as j_is_SE3
from pypose_tpu.utils import ReduceToBason as JReduceToBason
import pypose_tpu_torch as ppt
from pypose_tpu_torch.testing import assert_close
from pypose_tpu_torch.testing import cap_threads

cap_threads()


def rotations(rng, n, angles):
    """Rodrigues rotations (float64) about random axes by ``angles``."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    K = K - K.transpose(0, 2, 1)
    a = np.asarray(angles)[:, None, None]
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def branch(R):
    """Which of mat2SO3's four cases each rotation takes (atol 1e-5)."""
    rt = np.swapaxes(R, -1, -2)
    d2 = rt[..., 2, 2] < 1e-5
    d0_d1 = rt[..., 0, 0] > rt[..., 1, 1]
    d0_nd1 = rt[..., 0, 0] < -rt[..., 1, 1]
    return np.select([d2 & d0_d1, d2 & ~d0_d1, ~d2 & d0_nd1], [0, 1, 2], 3)


def all_branch_rotations(n=64):
    rng = np.random.default_rng(0)
    angles = np.concatenate([rng.uniform(0, 0.5, n // 2),
                             rng.uniform(2.8, np.pi, n - n // 2)])
    flips = [np.diag([1., -1, -1]), np.diag([-1., 1, -1]),
             np.diag([-1., -1, 1]), np.eye(3)]
    R = np.concatenate([rotations(rng, n, angles), np.stack(flips)])
    assert set(branch(R)) == {0, 1, 2, 3}
    return R


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('rows,cols', [(3, 3), (3, 4), (4, 4)])
def test_mat2SO3_mat2SE3_match_jax(rows, cols, dtype):
    R = all_branch_rotations()
    n = R.shape[0]
    M = np.zeros((n, rows, cols))
    M[:, :3, :3] = R
    if cols == 4:
        M[:, :3, 3] = np.random.default_rng(1).normal(size=(n, 3))
    if rows == 4:
        M[:, 3, 3] = 1.0
    M = M.astype(dtype)
    atol = 1e-6 if dtype == np.float32 else 1e-12
    with jax.enable_x64(dtype == np.float64):
        q_j = np.asarray(pp.mat2SO3(jnp.asarray(M)).tensor())
        T_j = np.asarray(pp.mat2SE3(jnp.asarray(M)).tensor())
    q_t = ppt.mat2SO3(torch.from_numpy(M)).tensor().numpy()
    T_t = ppt.mat2SE3(torch.from_numpy(M)).tensor().numpy()
    assert q_t.dtype == dtype and T_t.shape == (n, 7)
    np.testing.assert_allclose(q_t, q_j, rtol=0, atol=atol)
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=atol)


def test_mat2SO3_checks_match_jax():
    """Both raise on non-orthogonal matrices and on a reflection, both pass
    them with check=False, and both warn on a bad 4x4 last row."""
    bad = [np.diag([1., 1., 1.2]), np.diag([1., 1., -1.])]
    for M in bad:
        M = M.astype(np.float32)
        for f, arr in ((pp.mat2SO3, jnp.asarray), (ppt.mat2SO3,
                                                    torch.from_numpy)):
            with pytest.raises(ValueError):
                f(arr(M))
            f(arr(M), check=False)
    for shape in ((2, 3), (4, 3)):
        with pytest.raises(ValueError):
            pp.mat2SE3(jnp.zeros(shape))
        with pytest.raises(ValueError):
            ppt.mat2SE3(torch.zeros(shape))
    with pytest.raises(ValueError):
        ppt.mat2SO3(torch.zeros(3))
    M = np.eye(4, dtype=np.float32)
    M[3, 0] = 0.5
    for f, arr in ((pp.mat2SE3, jnp.asarray), (ppt.mat2SE3,
                                                torch.from_numpy)):
        with pytest.warns(UserWarning, match='last rows'):
            f(arr(M))
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        ppt.mat2SE3(torch.from_numpy(M), check=False)


def svdtf_both(src, tgt):
    T_j = pp.svdtf(jnp.asarray(src), jnp.asarray(tgt))
    T_t = ppt.svdtf(torch.from_numpy(src), torch.from_numpy(tgt))
    return T_t, ppt.SE3(torch.from_numpy(np.array(T_j.tensor())))


@pytest.mark.parametrize('batch', [(), (3,)])
def test_svdtf_matches_jax_and_recovers_pose(batch):
    rng = np.random.default_rng(4)
    src = rng.normal(size=batch + (30, 3)).astype(np.float32)
    T = ppt.randn_SE3(*batch, sigma=1.0,
                      generator=torch.Generator().manual_seed(5))
    tgt = T.unsqueeze(-2).Act(torch.from_numpy(src)).numpy()
    T_t, T_j = svdtf_both(src, tgt)
    assert T_t.shape == batch + (7,)
    assert_close(T_t, T_j, atol=1e-5)
    assert_close(T_t, T, atol=1e-5)


def test_svdtf_reflected_cloud_matches_jax():
    """A mirrored cloud: the best orthogonal map has det -1, and both
    packages negate it (geometry.py:224-225)."""
    rng = np.random.default_rng(6)
    src = (rng.normal(size=(40, 3)) * [3., 2., 1.]).astype(np.float32)
    tgt = (src * np.float32([1., 1., -1.])).astype(np.float32)
    T_t, T_j = svdtf_both(src, tgt)
    assert_close(T_t, T_j, atol=1e-5)
    R = T_t.matrix()[:3, :3]
    assert abs(float(torch.linalg.det(R)) - 1) < 1e-5
    np.testing.assert_allclose(R.numpy(), np.diag([-1., -1., 1.]), atol=1e-5)


def test_is_SE3():
    X = ppt.identity_SE3(2)
    assert ppt.is_SE3(X) and j_is_SE3(pp.identity_SE3(2))
    assert not ppt.is_SE3(ppt.identity_SO3(2))
    assert not j_is_SE3(pp.identity_SO3(2))
    assert not ppt.is_SE3(X.tensor()) and not ppt.is_SE3(None)


@pytest.mark.parametrize('losses,kwargs', [
    # loss tolerance
    ([1.0, 0.5, 1e-6], dict(steps=10)),
    # maximum steps
    ([4.0, 3.0, 2.0, 1.0, 0.5, 0.25], dict(steps=4)),
    # patience: relative decreases below 1e-3, reset by a large one
    ([1.0, 0.9999, 0.99989, 0.5, 0.49999, 0.499989, 0.499988, 0.499987],
     dict(steps=20, patience=3)),
    # an increase counts towards patience
    ([1.0, 2.0, 3.0], dict(steps=20, patience=2)),
    # batched losses: every entry must meet tol / plateau
    ([[1.0, 1e-7], [0.5, 1e-7], [1e-6, 1e-7]], dict(steps=20)),
    ([[1.0, 2.0], [1.0, 1.0], [1.0, 0.99999], [1.0, 0.99998]],
     dict(steps=20, patience=2, decreasing=1e-4)),
])
def test_reduce_to_bason_matches_jax(losses, kwargs):
    """The same loss sequence through both steppers: the same decision,
    step count and patience count after every step, until each sequence's
    stop (float32 losses; the port also takes them as torch tensors)."""
    for as_tensor in (False, True):
        sj, st = JReduceToBason(**kwargs), ppt.ReduceToBason(**kwargs)
        for loss in losses:
            if not sj.continual():
                break
            loss = np.asarray(loss, np.float32)
            sj.step(loss)
            st.step(torch.from_numpy(loss) if as_tensor else loss)
            assert (st.continual(), st.steps, st.patience_count) == \
                (sj.continual(), sj.steps, sj.patience_count)
        assert not st.continual()
        st.reset()
        assert st.continual() and st.steps == 0 and st.patience_count == 0
