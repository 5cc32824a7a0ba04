"""The port's g2o IO against the JAX package: the vendored sphere2500
problem equals what the JAX generator makes, the real-format excerpt
parses as the JAX loader parses it, and save/load round-trips.  Also
checks that the port imports without jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pypose_tpu.datasets import load_g2o as jax_load_g2o
from pypose_tpu.datasets import synthetic_sphere
from pypose_tpu_torch.datasets import find_data, load_g2o, save_g2o

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_vendored_sphere2500_equals_generator():
    """data/synthetic_sphere2500_seed42.g2o is synthetic_sphere(2500) with
    seed 42.  Written with 12 significant digits, which round-trip a
    float32 exactly; the 1e-6 tolerance covers one-ulp differences in the
    generator's own float32 arithmetic between XLA builds and flags."""
    path = find_data('synthetic_sphere2500_seed42.g2o')
    assert path is not None
    ds = load_g2o(path)
    ref = synthetic_sphere(2500)
    assert ds['nodes'].lshape == (2500,) and ds['edges'].shape == (4499, 2)
    np.testing.assert_array_equal(ds['edges'].numpy(),
                                  np.asarray(ref['edges']))
    for key in ('nodes', 'poses'):
        np.testing.assert_allclose(ds[key].numpy(),
                                   np.asarray(ref[key].tensor()),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(ds['infos'].numpy(),
                                  np.broadcast_to(np.eye(6), (4499, 6, 6)))


def test_realformat_excerpt_matches_jax_loader():
    """Unsorted and non-contiguous vertex ids, comments, odd spacing."""
    path = find_data('realformat_excerpt.g2o')
    got = load_g2o(path, dtype=torch.float64)
    ref = jax_load_g2o(path, dtype=jnp.float32)
    np.testing.assert_array_equal(got['edges'].numpy(),
                                  np.asarray(ref['edges']))
    for key in ('nodes', 'poses'):
        np.testing.assert_allclose(got[key].numpy(),
                                   np.asarray(ref[key].tensor()),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(got['infos'].numpy(), np.asarray(ref['infos']),
                               rtol=1e-6)
    assert got['nodes'].dtype == torch.float64


def test_save_load_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(6, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    nodes = torch.from_numpy(np.concatenate([rng.normal(size=(6, 3)), q], 1))
    edges = torch.tensor([[0, 1], [1, 2], [4, 5], [5, 0]])
    A = rng.normal(size=(4, 6, 6))
    infos = torch.from_numpy(A @ np.swapaxes(A, 1, 2))
    p = tmp_path / 'g.g2o'
    save_g2o(p, nodes, edges, nodes[:4], infos)
    back = load_g2o(p, dtype=torch.float64)
    np.testing.assert_array_equal(back['edges'].numpy(), edges.numpy())
    np.testing.assert_allclose(back['nodes'].numpy(), nodes.numpy(),
                               rtol=1e-11)
    np.testing.assert_allclose(back['infos'].numpy(), infos.numpy(),
                               rtol=1e-11)


@pytest.mark.parametrize('module', ['pypose_tpu_torch',
                                    'pypose_tpu_torch.optim.sparse'])
def test_port_imports_without_jax(module):
    code = (f'import sys, {module}\n'
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'pypose_tpu.')) "
            "or m == 'pypose_tpu')\n"
            'assert not bad, bad\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
