"""The port's native tokenizers (``pypose_tpu_torch/native``, g++-built
from the port's own ``loader.cpp``) against its plain Python parses and
against the JAX package's native parse, on the vendored g2o and BAL
files and on a ``save_bal`` round trip.  Every array is compared exactly:
strtod and Python's float() both round correctly.  A broken source, an
unreadable file and a malformed one raise.
"""

import numpy as np
import pytest
import torch

import pypose_tpu.native as jax_native
from pypose_tpu_torch import native
from pypose_tpu_torch.datasets import (find_data, load_bal, load_g2o,
                                       save_bal, synthetic_bal)
from pypose_tpu_torch.testing import cap_threads

cap_threads()

G2O = ['realformat_excerpt.g2o', 'synthetic_sphere2500_seed42.g2o']


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('name', G2O)
def test_g2o_native_matches_plain_and_jax(name):
    path = find_data(name)
    got = native.parse_g2o(path)
    _equal(got, native.parse_g2o_plain(path))
    _equal(got, jax_native.parse_g2o(path))
    assert got[0].dtype == np.int64 and got[1].dtype == np.float64


def test_bal_native_matches_plain_and_jax():
    path = find_data('realformat_excerpt_bal.txt')
    got = native.parse_bal(path)
    _equal(got, native.parse_bal_plain(path))
    _equal(got, jax_native.parse_bal(path))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_save_bal_round_trip(tmp_path, dtype):
    """save_bal then the native parse: the integer arrays exactly, the
    values as written (12 significant digits) and read back by the plain
    parse; load_bal gives back the poses' rotations (float64 values
    equal to 1e-10, float32 to 1e-6)."""
    ds = synthetic_bal(5, 40, 3, seed=1, dtype=dtype, device='cpu')
    path = str(tmp_path / 'p.txt')
    save_bal(path, ds['poses'], ds['points'], ds['cam_idx'], ds['pt_idx'],
             ds['pixels'], ds['cameras'])
    got = native.parse_bal(path)
    _equal(got, native.parse_bal_plain(path))
    np.testing.assert_array_equal(got[0], ds['cam_idx'].numpy())
    np.testing.assert_array_equal(got[1], ds['pt_idx'].numpy())
    back = load_bal(path, dtype=dtype, device='cpu')
    tol = 1e-10 if dtype == torch.float64 else 1e-6
    for key in ('points', 'pixels', 'cameras'):
        np.testing.assert_allclose(back[key].numpy(), ds[key].numpy(),
                                   rtol=tol, atol=tol, err_msg=key)
    T, T0 = back['poses'].tensor().numpy(), ds['poses'].tensor().numpy()
    np.testing.assert_allclose(T[:, :3], T0[:, :3], rtol=tol, atol=tol)
    q, q0 = T[:, 3:], T0[:, 3:]          # q and -q: the same rotation
    sign = np.sign(np.sum(q * q0, -1, keepdims=True))
    np.testing.assert_allclose(q * sign, q0, rtol=tol, atol=tol)


def test_load_g2o_native_equals_plain_rows(tmp_path):
    """load_g2o sorts the vertices by id and renumbers the edges: the same
    as the plain parse processed the same way."""
    path = find_data('realformat_excerpt.g2o')
    ds = load_g2o(path, dtype=torch.float64, device='cpu')
    vids, verts, edges, meas, _ = native.parse_g2o_plain(path)
    order = np.argsort(vids)
    np.testing.assert_array_equal(ds['nodes'].tensor().numpy(), verts[order])
    rows = {v: r for r, v in enumerate(vids[order])}
    np.testing.assert_array_equal(
        ds['edges'].numpy(), np.vectorize(rows.get)(edges))
    np.testing.assert_array_equal(ds['poses'].tensor().numpy(), meas)


def test_malformed_and_missing_files_raise(tmp_path):
    bad = tmp_path / 'bad.txt'
    bad.write_text('2 3 4\n0 0 1.0 2.0\n0 1 x 0.5\n')
    with pytest.raises(ValueError, match='malformed'):
        native.parse_bal(str(bad))
    short = tmp_path / 'short.txt'
    short.write_text('1 1 1\n0 0 1.0 2.0\n' + '0.1\n' * 9)   # no point
    with pytest.raises(ValueError, match='malformed'):
        native.parse_bal(str(short))
    g2o = tmp_path / 'bad.g2o'
    g2o.write_text('VERTEX_SE3:QUAT 0 0 0 0 0 0\nEDGE_SE3:QUAT 0 1\n')
    with pytest.raises(ValueError, match='malformed'):
        native.parse_g2o(str(g2o))
    with pytest.raises(ValueError, match='cannot read'):
        native.parse_bal(str(tmp_path / 'missing.txt'))
    with pytest.raises(ValueError, match='cannot read'):
        load_g2o(str(tmp_path / 'missing.g2o'), device='cpu')


def test_broken_source_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output;
    nothing falls back to the plain parse."""
    src = tmp_path / 'loader.cpp'
    src.write_text('this is not C++\n')
    monkeypatch.setattr(native, 'SRC', src)
    monkeypatch.setattr(native, 'LIB', tmp_path / 'libppt_loader.so')
    monkeypatch.setattr(native, 'BUILD', tmp_path)
    monkeypatch.setattr(native, '_lib', None)
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        native.parse_g2o(find_data('realformat_excerpt.g2o'))
