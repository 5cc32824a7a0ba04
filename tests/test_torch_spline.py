"""``function/spline.py`` of the port against the JAX package on the same
numpy inputs, in float32 and float64: ``chspline`` and ``bspline`` (with
and without ``extrapolate``) at intervals 0.05, 0.1, 0.2, 0.25 and 0.3
(the sample counts of ``arange(0, 1, interval)`` included), with batch
dimensions, and on a float32 timeline near 6e4 (an ulp of 0.004); and
tests/function/test_geometry.py's two spline tests.

Tolerances: outputs within 1e-12 (float64) and 2e-6 (float32) of each
column's largest magnitude (the same operations; the power and the 4 x 4
basis product may round their last bit differently); B-spline poses
compared as storages (the same formulas give the same quaternion sign).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
import pypose_tpu_torch as ppt
from pypose_tpu_torch.testing import cap_threads

cap_threads()

DTYPES = [np.float32, np.float64]
INTERVALS = [0.05, 0.1, 0.2, 0.25, 0.3]


def rtol(dtype):
    return 1e-12 if dtype == np.float64 else 2e-6


def close(got, want, dtype):
    got = (got.tensor() if hasattr(got, 'tensor') else got).numpy()
    want = np.asarray(want.tensor() if hasattr(want, 'tensor') else want)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want).reshape(-1, want.shape[-1]).max(0), 1)
    assert (np.abs(got - want) <= rtol(dtype) * scale).all(), \
        np.abs(got - want).max()


def control_poses(rng, shape):
    """SE3 control poses (float64 numpy) of a random walk along the last
    batch axis."""
    t = np.cumsum(rng.normal(size=shape + (3,)) * 0.5, axis=-2)
    v = np.cumsum(rng.normal(size=shape + (3,)) * 0.2, axis=-2)
    th = np.linalg.norm(v, axis=-1, keepdims=True)
    q = np.concatenate([np.sin(th / 2) * v / th, np.cos(th / 2)], -1)
    return np.concatenate([t, q], -1)


@pytest.mark.parametrize('interval', INTERVALS)
@pytest.mark.parametrize('dtype', DTYPES)
def test_chspline_matches_jax(dtype, interval):
    rng = np.random.default_rng(0)
    for shape in [(7, 3), (2, 5, 4)]:
        pts = rng.normal(size=shape).astype(dtype)
        with jax.enable_x64(dtype == np.float64):
            want = jpp.chspline(jnp.asarray(pts), interval=interval)
        got = ppt.chspline(torch.tensor(pts), interval=interval)
        assert got.dtype == torch.from_numpy(pts).dtype
        close(got, want, dtype)


def jax_bspline(P, interval, extrapolate):
    """The JAX package's bspline on storages ``P``, jitted (one compile
    in place of one per eager operation)."""
    fn = jax.jit(lambda x: jpp.bspline(jpp.SE3(x), interval=interval,
                                       extrapolate=extrapolate).tensor())
    with jax.enable_x64(P.dtype == np.float64):
        return fn(jnp.asarray(P))


@pytest.mark.parametrize('interval', INTERVALS)
@pytest.mark.parametrize('dtype', DTYPES)
def test_bspline_matches_jax(dtype, interval):
    P = control_poses(np.random.default_rng(1), (6,)).astype(dtype)
    want = jax_bspline(P, interval, False)
    got = ppt.bspline(ppt.SE3(torch.tensor(P)), interval=interval)
    assert got.ltype is ppt.SE3_type
    close(got, want, dtype)


@pytest.mark.parametrize('extrapolate', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
def test_bspline_batched_matches_jax(dtype, extrapolate):
    P = control_poses(np.random.default_rng(2), (2, 3, 5)).astype(dtype)
    want = jax_bspline(P, 0.25, extrapolate)
    got = ppt.bspline(ppt.SE3(torch.tensor(P)), interval=0.25,
                      extrapolate=extrapolate)
    assert tuple(got.lshape) == (2, 3, (6 if extrapolate else 2) * 4 + 1)
    close(got, want, dtype)


def test_float32_timeline_near_6e4():
    """60,001 waypoints in float32: the timeline's ulp is ~0.004 at its
    end; the same samples and segment indices as the JAX package."""
    rng = np.random.default_rng(2)
    pts = np.cumsum(rng.normal(size=(60_001, 2)), 0).astype(np.float32)
    want = np.asarray(jpp.chspline(jnp.asarray(pts), interval=0.3))
    got = ppt.chspline(torch.tensor(pts), interval=0.3)
    assert got.shape == want.shape == (240_001, 2)
    close(got[-2000:], want[-2000:], np.float32)


def test_splines_raise_on_bad_input():
    with pytest.raises(AssertionError):
        ppt.chspline(torch.zeros(4, 3), interval=1.0)
    with pytest.raises(AssertionError):
        ppt.bspline(ppt.identity_SE3(3))
    with pytest.raises(AssertionError):
        ppt.bspline(ppt.identity_SO3(5))


# --- tests/function/test_geometry.py's spline tests, on numpy draws -------

def test_chspline_interpolates_knots():
    pts = torch.tensor(np.random.default_rng(10).normal(size=(6, 3)),
                       dtype=torch.float32)
    out = ppt.chspline(pts, interval=0.25)
    np.testing.assert_allclose(out[::4].numpy(), pts.numpy(), atol=1e-5)


def test_bspline_shapes_and_smoothness():
    poses = ppt.SE3(torch.tensor(control_poses(np.random.default_rng(11),
                                               (7,)), dtype=torch.float32))
    out = ppt.bspline(poses, interval=0.2)
    assert out.ltype is ppt.SE3_type
    assert out.lshape[0] == (7 - 3) * 5 + 1
    ext = ppt.bspline(poses, interval=0.2, extrapolate=True)
    assert ext.lshape[0] == (11 - 3) * 5 + 1
    d = (out[:-1].Inv() @ out[1:]).Log().tensor()
    assert float(d.abs().max()) < 1.0
