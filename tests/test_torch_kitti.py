"""The KITTI raw oxts IO of the port against the JAX package: a drive
written by the port's ``save_kitti_oxts`` (byte-equal to the JAX
package's), loaded by both packages' ``load_kitti_imu``, windowed by
``kitti_imu_windows`` and preintegrated by both ``IMUPreintegrator``s.
No KITTI drive is vendored, so every drive here is synthesized.

Tolerances: dt, gyro, acc and gt_pos are rounded from the same float64
values, so equal; gt_rot and gt_vel go through float32 euler2SO3 and
Act, within 1e-6; the preintegrated states within 1e-5 (float32).
"""

import filecmp
import os

import numpy as np
import pytest

import torch

from pypose_tpu import datasets as jds
from pypose_tpu.module import IMUPreintegrator as JIMU
from pypose_tpu_torch import datasets as tds
from pypose_tpu_torch.module import IMUPreintegrator
from pypose_tpu_torch.testing import cap_threads

cap_threads()

G = 9.81007


def drive(F=40, dt=0.1, seed=0):
    """A drive with forward acceleration and a slow yaw: stamps and
    [F + 1, 30] packets."""
    idx = {k: i for i, k in enumerate(tds._OXTS_FIELDS)}
    rng = np.random.default_rng(seed)
    t = np.arange(F + 1) * dt
    pk = np.zeros((F + 1, 30))
    lat0, er, a = 49.0, 6378137.0, 0.5
    scale = np.cos(lat0 * np.pi / 180.0)
    x = 0.5 * a * t ** 2
    pk[:, idx['lat']] = lat0 + 1e-6 * rng.normal(size=F + 1)
    pk[:, idx['lon']] = x * 180.0 / (np.pi * er * scale)
    pk[:, idx['alt']] = 7.0 + 0.01 * t
    pk[:, idx['yaw']] = 0.05 * t
    pk[:, idx['roll']] = 0.01 * np.sin(t)
    pk[:, idx['vf']] = a * t
    pk[:, idx['vl']] = 0.01 * rng.normal(size=F + 1)
    pk[:, idx['ax']] = a
    pk[:, idx['az']] = G
    pk[:, idx['wz']] = 0.05
    # sub-second stamps that round to nanoseconds, one within 0.5 ns of
    # the next second
    stamps = 1.3e9 + t
    stamps[3] = 1.3e9 + 1.0 - 2e-10
    return stamps, pk


def test_save_matches_jax_package(tmp_path):
    stamps, pk = drive()
    tds.save_kitti_oxts(str(tmp_path / 't'), stamps, pk)
    jds.save_kitti_oxts(str(tmp_path / 'j'), stamps, pk)
    cmp = filecmp.dircmp(str(tmp_path / 't' / 'oxts'),
                         str(tmp_path / 'j' / 'oxts'))
    assert filecmp.cmp(str(tmp_path / 't/oxts/timestamps.txt'),
                       str(tmp_path / 'j/oxts/timestamps.txt'),
                       shallow=False)
    names = sorted(os.listdir(str(tmp_path / 't/oxts/data')))
    assert len(names) == len(pk) and not cmp.diff_files
    match, mismatch, errors = filecmp.cmpfiles(
        str(tmp_path / 't/oxts/data'), str(tmp_path / 'j/oxts/data'), names,
        shallow=False)
    assert not mismatch and not errors


def test_load_window_preintegrate_matches_jax(tmp_path):
    stamps, pk = drive()
    tds.save_kitti_oxts(str(tmp_path), stamps, pk)
    jd = jds.load_kitti_imu(str(tmp_path))
    td = tds.load_kitti_imu(str(tmp_path), device='cpu')
    for k in ('dt', 'gyro', 'acc', 'gt_pos', 'gt_vel', 'gt_rot'):
        a = td[k].tensor() if k == 'gt_rot' else td[k]
        b = jd[k].tensor() if k == 'gt_rot' else jd[k]
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        tol = 1e-6 if k in ('gt_rot', 'gt_vel') else 0
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   rtol=tol, err_msg=k)
    F = td['dt'].shape[0]
    assert F == len(stamps) - 1
    np.testing.assert_allclose(td['dt'][4:].numpy(), 0.1, atol=1e-6)

    tw = tds.kitti_imu_windows(td, duration=10, step=5)
    jw = jds.kitti_imu_windows(jd, duration=10, step=5)
    assert len(tw) == len(jw) > 0
    for a, b in zip(tw, jw):
        assert a.keys() == b.keys()
        for k in a:
            x = a[k].tensor() if hasattr(a[k], 'tensor') else a[k]
            y = b[k].tensor() if hasattr(b[k], 'tensor') else b[k]
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)

    jo = JIMU(reset=True, prop_cov=True, gravity=G)(
        jd['dt'][None], jd['gyro'][None], jd['acc'][None])
    to = IMUPreintegrator(reset=True, prop_cov=True, gravity=G)(
        td['dt'][None], td['gyro'][None], td['acc'][None])
    for k in ('pos', 'vel', 'rot', 'cov'):
        x = to[k].tensor() if hasattr(to[k], 'tensor') else to[k]
        y = jo[k].tensor() if hasattr(jo[k], 'tensor') else jo[k]
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_load_defaults_to_the_card(tmp_path):
    stamps, pk = drive(F=4)
    tds.save_kitti_oxts(str(tmp_path), stamps, pk)
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is usable')
    with pytest.raises((RuntimeError, AssertionError)):
        tds.load_kitti_imu(str(tmp_path))
    d = tds.load_kitti_imu(str(tmp_path), dtype=torch.float64, device='cpu')
    assert d['acc'].dtype == torch.float64 and d['gt_rot'].dtype == \
        torch.float64
