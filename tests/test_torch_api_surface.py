"""The port's public surface against the JAX package's: every public
top-level name of ``pypose_tpu`` and every name ``pypose_tpu.module``
exports is in the port, still owed by a named ROADMAP.md Queue A item, or
on its Do-not-port list (ROADMAP.md C7)."""

import pytest

import pypose_tpu as jpp
import pypose_tpu.module as jmodule
import pypose_tpu_torch as ppt
import pypose_tpu_torch.module as tmodule
from pypose_tpu_torch.testing import cap_threads

cap_threads()

# ROADMAP.md Queue A: the item that still owes each name
OWED = {'metric': 5, 'chspline': 5, 'bspline': 5,
        'sparse': 6, 'bsr_bsc_matmul': 6, 'bsr_matvec': 6,
        'dense_to_bsr': 6, 'dense_to_bsc': 6,
        'parallel': 7}
# ROADMAP.md "Do not port"
DO_NOT_PORT = {'autograd', 'retain_ltype', 'interop', 'seed'}


def public(mod):
    return sorted(n for n in dir(mod) if not n.startswith('_'))


@pytest.mark.parametrize('name', public(jpp))
def test_top_level_name(name):
    if name in OWED or name in DO_NOT_PORT:
        assert not hasattr(ppt, name), \
            f'{name} is ported: take it off the owed or do-not-port list'
        return
    assert hasattr(ppt, name), f'pypose_tpu_torch lacks {name}'


def test_module_exports():
    assert sorted(tmodule.__all__) == sorted(jmodule.__all__)
    for name in jmodule.__all__:
        assert callable(getattr(tmodule, name))


def test_c7_names_work():
    """ROADMAP.md C7's input: ``pp.stack([pp.randn_SE3(2)] * 2)``."""
    import torch
    X = ppt.randn_SE3(2, generator=torch.Generator().manual_seed(0))
    for f in (ppt.stack, ppt.cat, ppt.concat):
        out = f([X, X])
        assert out.ltype is ppt.SE3_type
    assert ppt.stack([X] * 2).shape == (2, 2, 7)
    assert [s.shape for s in ppt.split(ppt.cat([X, X]), 2)] == \
        [(2, 7), (2, 7)]
    assert ppt.SE3_type in ppt.liegroup and ppt.se3_type in ppt.liealgebra
    assert ppt.tensor(X).shape == (2, 7)
    assert ppt.hasnan([X, {'a': torch.tensor([0.0, float('nan')])}])
    assert not ppt.hasnan((X, 1.0))
