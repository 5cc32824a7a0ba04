"""The port's synthetic sphere pose graph and random Lie factories against
the JAX package: the same topology and ground truth (the noise comes from
a torch.Generator, so it is checked by its distribution), the same
instance from the same seed, and the factories' refusal of a missing
generator.
"""

import numpy as np
import pytest

import torch

from pypose_tpu.datasets import synthetic_sphere as jax_synthetic_sphere
import pypose_tpu_torch as ppt
from pypose_tpu_torch.datasets import synthetic_sphere
from pypose_tpu_torch.testing import assert_close, instance_checksum


@pytest.mark.parametrize('n', [100, 2500])
def test_topology_and_ground_truth_match_jax(n):
    """Edges exactly; ground truth within 1e-6 (float32, rounded from
    float64 here and computed in float32 by XLA there); the 'natural'
    information matrices exactly."""
    ds = synthetic_sphere(n, info='natural', device='cpu')
    ref = jax_synthetic_sphere(n, info='natural')
    np.testing.assert_array_equal(ds['edges'].numpy(),
                                  np.asarray(ref['edges']))
    np.testing.assert_allclose(ds['gt'].numpy(), np.asarray(ref['gt'].tensor()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ds['infos'].numpy(), np.asarray(ref['infos']))
    assert ds['nodes'].lshape == (n,) and ds['poses'].lshape == (
        ds['edges'].shape[0],)
    # pose 0 is pinned to the ground truth
    np.testing.assert_array_equal(ds['nodes'].numpy()[0], ds['gt'].numpy()[0])


def test_same_seed_same_instance():
    a, b = (synthetic_sphere(300, seed=7, device='cpu') for _ in range(2))
    for key in ('nodes', 'poses', 'gt'):
        assert torch.equal(a[key].tensor(), b[key].tensor()), key
    assert torch.equal(a['edges'], b['edges'])
    c = synthetic_sphere(300, seed=8, device='cpu')
    assert not torch.equal(a['nodes'].tensor(), c['nodes'].tensor())
    assert instance_checksum(a) == instance_checksum(b) != \
        instance_checksum(c)


def test_dtype_and_device():
    """float64 keeps the float64 instance; float32 is its rounding."""
    d64 = synthetic_sphere(200, dtype=torch.float64, device='cpu')
    d32 = synthetic_sphere(200, device='cpu')
    assert d64['nodes'].dtype == torch.float64
    assert d32['poses'].dtype == torch.float32
    assert torch.equal(d64['poses'].tensor().float(), d32['poses'].tensor())


def _std(x):
    return x.double().pow(2).mean(0).sqrt()


def test_noise_has_the_stated_sigma():
    """The measurement noise (Z against the ground-truth relative pose)
    and the initial-pose noise, as se3 tangents: translation rms per
    channel and rotation-vector rms (times sqrt(3), the axis being
    uniform) within 6% of meas_sigma (0.05, 0.02) and init_sigma
    (1.0, 0.3).  At 4499 and 2500 samples the relative standard error of
    an rms is ~1.1% and ~1.4%, so 6% is over 4 of them."""
    ds = synthetic_sphere(2500, device='cpu')
    gt, e = ds['gt'], ds['edges']
    meas = ((gt[e[:, 0]].Inv() @ gt[e[:, 1]]).Inv() @ ds['poses']).Log()
    init = (ds['nodes'] @ gt.Inv()).Log().tensor()[1:]
    for xi, (st, sr) in ((meas.tensor(), (0.05, 0.02)), (init, (1.0, 0.3))):
        np.testing.assert_allclose(_std(xi[:, :3]).numpy(), [st] * 3,
                                   rtol=0.06)
        np.testing.assert_allclose(
            float(_std(xi[:, 3:]).pow(2).sum().sqrt()), sr, rtol=0.06)


def test_randn_factories():
    """Per-channel sigma of randn_se3 at 200k draws (relative standard
    error 0.16%, bound 1%); group draws are Exp of algebra draws from the
    same stream; a CPU generator gives the same values whatever the
    target dtype's device."""
    g = torch.Generator().manual_seed(0)
    x = ppt.randn_se3(200_000, sigma=(0.5, 0.1), generator=g).tensor()
    np.testing.assert_allclose(_std(x[:, :3]).numpy(), [0.5] * 3, rtol=0.01)
    np.testing.assert_allclose(float(_std(x[:, 3:]).pow(2).sum().sqrt()),
                               0.1, rtol=0.01)
    sig4 = ppt.randn_se3(200_000, sigma=(0.1, 0.2, 0.3, 0.0),
                         generator=g).tensor()
    np.testing.assert_allclose(_std(sig4[:, :3]).numpy(), [0.1, 0.2, 0.3],
                               rtol=0.01)
    assert not sig4[:, 3:].any()
    for alg, grp, dim in ((ppt.randn_so3, ppt.randn_SO3, 3),
                          (ppt.randn_se3, ppt.randn_SE3, 6)):
        a = alg(4, 5, sigma=0.2, generator=torch.Generator().manual_seed(1),
                dtype=torch.float64)
        X = grp(4, 5, sigma=0.2, generator=torch.Generator().manual_seed(1),
                dtype=torch.float64)
        assert a.shape == (4, 5, dim) and a.dtype == torch.float64
        assert_close(X, a.Exp(), atol=1e-12)


def test_randn_needs_a_generator():
    for fn in (ppt.randn_so3, ppt.randn_SO3, ppt.randn_se3, ppt.randn_SE3):
        with pytest.raises(TypeError, match='torch.Generator'):
            fn(3)
        with pytest.raises(TypeError, match='torch.Generator'):
            fn(3, generator=0)
    with pytest.raises(TypeError, match='single number'):
        ppt.randn_so3(3, sigma=(0.1, 0.2), generator=torch.Generator())
    with pytest.raises(ValueError, match='size 1, 2 or 4'):
        ppt.randn_se3(3, sigma=(0.1, 0.2, 0.3), generator=torch.Generator())


def test_euler2SO3_matches_jax():
    from pypose_tpu.lietensor.convert import euler2SO3 as jax_euler2SO3
    rng = np.random.default_rng(0)
    e = rng.uniform(-np.pi, np.pi, (50, 3))
    q = ppt.euler2SO3(torch.from_numpy(e)).numpy()
    np.testing.assert_allclose(q, np.asarray(jax_euler2SO3(e).tensor()),
                               rtol=1e-6, atol=1e-6)


def test_docstring_examples():
    import doctest
    from pypose_tpu_torch import datasets
    from pypose_tpu_torch.lietensor import convert
    for module in (datasets, convert):
        result = doctest.testmod(module)
        assert result.attempted > 0 and result.failed == 0, module
