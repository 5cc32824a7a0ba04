"""BAL IO, the synthetic BAL generator and the projections of
``function/geometry.py`` against the JAX package.

``synthetic_bal``: the topology, the ground-truth points, the pixel noise
and the point noise are drawn from ``np.random.default_rng(seed)`` in the
JAX generator's order, so the indices and the points equal the JAX
package's bit for bit.  The ground-truth quaternions (``mat2SO3`` in
float32) and the pixels (their float32 projection) are computed, and
XLA's CPU float32 arithmetic differs from torch's in the last bits: its
square root is not correctly rounded, and at the optimisation level 0
that tests/conftest.py sets its products and sums round differently.
Measured: quaternions within 2 ulp, camera-frame points within 1.9e-6 (2
ulp of ~10), pixels within 1.5e-4 px at 16/300 and 2.3e-4 px at 257
cameras (1-2 ulp of pixels of ~1000 px); with XLA's default level
(``PPT_TEST_XLA_OPT=1``) the 16/300 instance is bit-equal throughout.  The
noisy poses come from a ``torch.Generator``.

Tolerances elsewhere: float32 rtol 1e-6 (atol 1e-6; 6e-5 for pixels, 1-2
ulp of the ~300-600 px terms that cancel in them), float64 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import pypose_tpu as jpp
from pypose_tpu.datasets import load_bal as jax_load_bal
from pypose_tpu.datasets import save_bal as jax_save_bal
from pypose_tpu.datasets import synthetic_bal as jax_synthetic_bal
import pypose_tpu_torch as ppt
from pypose_tpu_torch.datasets import (find_data, load_bal, save_bal,
                                       synthetic_bal)
from pypose_tpu_torch.function import (cart2homo, homo2cart, pixel2point,
                                       point2pixel, reprojerr)

TOL = {np.float32: dict(rtol=1e-6, atol=6e-5),
       np.float64: dict(rtol=1e-12, atol=1e-12)}


def _np(x):
    x = x.tensor() if hasattr(x, 'tensor') else x
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_load_bal_matches_jax(dtype):
    path = find_data('realformat_excerpt_bal.txt')
    got = load_bal(path, dtype=dtype, device='cpu')
    ref = jax_load_bal(path)
    for key in ('cam_idx', 'pt_idx'):
        np.testing.assert_array_equal(_np(got[key]), _np(ref[key]))
    for key in ('points', 'pixels', 'cameras', 'poses'):
        np.testing.assert_allclose(_np(got[key]), _np(ref[key]), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
        assert got[key].dtype == dtype


def test_save_bal_matches_jax(tmp_path):
    """Both packages' files parse to the same problem (the Rodrigues
    vectors within 1e-6: JAX's Log runs in float32)."""
    ds = synthetic_bal(6, 50, 3, seed=2, device='cpu')
    a, b = str(tmp_path / 'port.txt'), str(tmp_path / 'jax.txt')
    save_bal(a, ds['poses'], ds['points'], ds['cam_idx'], ds['pt_idx'],
             ds['pixels'], ds['cameras'])
    jax_save_bal(b, jpp.SE3(jnp.asarray(_np(ds['poses']))),
                 _np(ds['points']), _np(ds['cam_idx']), _np(ds['pt_idx']),
                 _np(ds['pixels']), _np(ds['cameras']))
    from pypose_tpu_torch.native import parse_bal_plain
    for x, y in zip(parse_bal_plain(a), parse_bal_plain(b)):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)


def test_synthetic_bal_equals_jax_16_300():
    """The anchor problem's arguments: the drawn arrays bit for bit, the
    computed ones within the last bits of XLA's float32 arithmetic;
    camera 0 keeps its ground truth in both."""
    kw = dict(n_cams=16, n_points=300, obs_per_point=4, seed=0,
              pose_noise=(0.3, 0.1), point_noise=0.5, pixel_noise=0.5)
    got = synthetic_bal(**kw, device='cpu')
    ref = jax_synthetic_bal(**kw)
    for key in ('points', 'cam_idx', 'pt_idx', 'cameras', 'gt_points'):
        np.testing.assert_array_equal(_np(got[key]), _np(ref[key]),
                                      err_msg=key)
    np.testing.assert_array_max_ulp(_np(got['gt_poses']),
                                    _np(ref['gt_poses']), maxulp=2)
    np.testing.assert_allclose(_np(got['pixels']), _np(ref['pixels']),
                               rtol=0, atol=2.5e-4)
    np.testing.assert_array_equal(_np(got['poses'])[0],
                                  _np(got['gt_poses'])[0])
    assert not np.array_equal(_np(got['poses']), _np(ref['poses']))


def test_synthetic_bal_fractional_obs_per_point():
    """trafalgar's 225,911 / 65,132 observations a point at a tenth of its
    points and all its cameras: indices, points, cameras exact; the
    ground-truth quaternions within 2 ulp; the camera-frame points through
    JAX's own poses within 4e-6, and the pixels within
    2.5e-4 px of JAX's as made."""
    kw = dict(n_cams=257, n_points=6513, obs_per_point=225911 / 65132,
              seed=0, pose_noise=(0.3, 0.1), point_noise=0.5)
    got = synthetic_bal(**kw, device='cpu')
    ref = jax_synthetic_bal(**kw)
    assert got['pixels'].shape[0] == int(6513 * 3) + round(
        (225911 / 65132 - 3) * 6513)
    for key in ('points', 'cam_idx', 'pt_idx', 'cameras', 'gt_points'):
        np.testing.assert_array_equal(_np(got[key]), _np(ref[key]),
                                      err_msg=key)
    np.testing.assert_array_max_ulp(_np(got['gt_poses']),
                                    _np(ref['gt_poses']), maxulp=2)
    np.testing.assert_allclose(_np(got['pixels']), _np(ref['pixels']),
                               rtol=0, atol=2.5e-4)
    gt = ppt.SE3(torch.as_tensor(_np(ref['gt_poses']).copy()))
    Xc = gt[got['cam_idx']].Act(got['gt_points'][got['pt_idx']])
    ref_Xc = ref['gt_poses'][jnp.asarray(_np(ref['cam_idx']))].Act(
        ref['gt_points'][jnp.asarray(_np(ref['pt_idx']))])
    np.testing.assert_allclose(Xc.numpy(), np.asarray(ref_Xc), rtol=0,
                               atol=4e-6)


def test_synthetic_bal_device_default():
    """The default device is the card: without one it raises, as a CUDA
    tensor does."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises((RuntimeError, AssertionError)):
        synthetic_bal(4, 20, 2)
    with pytest.raises((RuntimeError, AssertionError)):
        load_bal(find_data('realformat_excerpt_bal.txt'))


def _camera_data(rng, dtype):
    K = np.array([[320., 0., 160.], [0., 300., 120.], [0., 0., 1.]], dtype)
    pts = (rng.normal(size=(2, 50, 3)) + [0., 0., 6.]).astype(dtype)
    pix = (rng.normal(size=(2, 50, 2)) * 40 + 140).astype(dtype)
    T = rng.normal(size=(2, 6)) * 0.2
    return K, pts, pix, T


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_projections_match_jax(dtype):
    rng = np.random.default_rng(7)
    K, pts, pix, T = _camera_data(rng, dtype)
    depth = pts[..., 2]
    with jax.enable_x64(dtype == np.float64):
        jT = jpp.se3(jnp.asarray(T.astype(dtype))).Exp()
        tT = ppt.se3(torch.as_tensor(T.astype(dtype))).Exp()
        np.testing.assert_allclose(_np(tT), np.asarray(jT.tensor()),
                                   **TOL[dtype])
        tT = ppt.SE3(torch.as_tensor(np.asarray(jT.tensor())))
        jK, jp, jx = jnp.asarray(K), jnp.asarray(pts), jnp.asarray(pix)
        tK, tp, tx = (torch.as_tensor(a) for a in (K, pts, pix))
        homo = np.concatenate([pts[..., :2], np.zeros_like(pts[..., :1]),
                               -pts[..., 2:]], -1)
        pairs = [
            (cart2homo(tp), jpp.cart2homo(jp)),
            (homo2cart(torch.as_tensor(homo)),
             jpp.homo2cart(jnp.asarray(homo))),
            (point2pixel(tp, tK), jpp.point2pixel(jp, jK)),
            (point2pixel(tp, tK, tT), jpp.point2pixel(jp, jK, jT)),
            (pixel2point(tx, torch.as_tensor(depth), tK),
             jpp.pixel2point(jx, jnp.asarray(depth), jK))]
        for red in ('none', 'norm', 'sum'):
            pairs.append((reprojerr(tp, tx, tK, tT, reduction=red),
                          jpp.reprojerr(jp, jx, jK, jT, reduction=red)))
        for i, (got, want) in enumerate(pairs):
            assert got.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=str(i), **TOL[dtype])
