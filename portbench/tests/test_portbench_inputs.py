"""The benchmark's frozen input generators against the instances the
anchor files were computed on, and against the port's own generators."""

import json

import pytest
import torch

import problems
from conftest import REPO


def _anchor(name):
    return json.loads((REPO / 'data' / name).read_text())


def _same(got, want):
    assert got['n_edges'] == want['n_edges']
    for k in ('nodes_abs_sum', 'poses_abs_sum'):
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k]), (k, got, want)


def test_sphere100k_seed42_is_the_anchor_instance():
    g = problems.sphere(100_000, 42)
    _same(problems.checksum(g, 'SE3'),
          _anchor('jax_anchor_pgo100k_seed42.json')['instance_checksum'])


def test_sim3_lift_seed7_is_the_anchor_instance():
    g = problems.parse_g2o(REPO / 'portbench/data/sphere2500_seed42.g2o.gz')
    _same(problems.checksum(problems.lift_sim3(g, 7), 'Sim3'),
          _anchor('jax_anchor_sim3_sphere2500.json')['instance_checksum'])


def test_g2o_copy_is_the_repository_file():
    a = problems.parse_g2o(REPO / 'portbench/data/sphere2500_seed42.g2o.gz')
    b = problems.parse_g2o(REPO / 'data/synthetic_sphere2500_seed42.g2o')
    for k in ('nodes', 'edges', 'meas'):
        assert torch.equal(a[k], b[k])
    assert a['nodes'].shape == (2500, 8) and a['edges'].shape == (4499, 2)


def test_g2o_parser_matches_the_port_loader():
    from pypose_tpu_torch.datasets import load_g2o
    a = problems.parse_g2o(REPO / 'data/synthetic_sphere2500_seed42.g2o')
    b = load_g2o(str(REPO / 'data/synthetic_sphere2500_seed42.g2o'),
                 device='cpu')
    assert torch.equal(a['nodes'][:, :7].float(), b['nodes'].tensor())
    assert torch.equal(a['meas'][:, :7].float(), b['poses'].tensor())
    assert torch.equal(a['edges'], b['edges'])


@pytest.mark.parametrize('n, seed', [(500, 3), (2000, 2 ** 31 + 11)])
def test_sphere_copy_matches_the_port_generator(n, seed):
    from pypose_tpu_torch.datasets import synthetic_sphere
    a = problems.sphere(n, seed)
    b = synthetic_sphere(n, seed=seed, device='cpu')
    assert torch.equal(a['edges'], b['edges'])
    assert torch.equal(a['nodes'][:, :7].float(), b['nodes'].tensor())
    # float64 products in another order may round to a neighbouring
    # float32 in the last bit
    assert torch.allclose(a['meas'][:, :7].float(), b['poses'].tensor(),
                          rtol=0, atol=4e-6)


def test_sim3_lift_matches_the_port():
    from pypose_tpu_torch.lietensor.lietensor import LieTensor, SE3_type
    from pypose_tpu_torch.testing import pgo_group_instance
    g = problems.sphere(300, 5)
    ds = {'nodes': LieTensor(g['nodes'][:, :7].float(), ltype=SE3_type),
          'poses': LieTensor(g['meas'][:, :7].float(), ltype=SE3_type),
          'edges': g['edges']}
    want = pgo_group_instance(ds, 'Sim3', torch.Generator().manual_seed(9))
    got = problems.lift_sim3(g, 9)
    assert torch.equal(got['nodes'].float(), want['nodes'].tensor())
    assert torch.equal(got['meas'].float(), want['poses'].tensor())
