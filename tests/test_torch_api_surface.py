"""The port's public surface against the JAX package's: every public
top-level name of ``pypose_tpu`` and every name ``pypose_tpu.module``
exports is in the port, still owed by a named ROADMAP.md Queue A item, or
on its Do-not-port list (ROADMAP.md C7)."""

import pytest

import pypose_tpu as jpp
import pypose_tpu.function as jfunction
import pypose_tpu.metric as jmetric
import pypose_tpu.module as jmodule
import pypose_tpu.sparse as jsparse
import pypose_tpu.testing as jtesting
import pypose_tpu.utils as jutils
import pypose_tpu_torch as ppt
import pypose_tpu_torch.metric as tmetric
import pypose_tpu_torch.module as tmodule
import pypose_tpu_torch.sparse as tsparse
import pypose_tpu_torch.utils as tutils
from pypose_tpu_torch.testing import cap_threads

cap_threads()

# ROADMAP.md Queue A: the item that still owes each name
OWED = {'parallel': 7}
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


@pytest.mark.parametrize('jmod,tmod', [(jmetric, tmetric),
                                       (jsparse, tsparse),
                                       (jutils, tutils)],
                         ids=['metric', 'sparse', 'utils'])
def test_subpackage_exports(jmod, tmod):
    """``metric``, ``sparse`` and ``utils`` export the JAX package's
    ``__all__``, and each name resolves."""
    assert sorted(tmod.__all__) == sorted(jmod.__all__)
    for name in jmod.__all__:
        assert getattr(tmod, name) is not None


def test_function_and_testing_names():
    """Every name of ``pypose_tpu.function.__all__`` and
    ``pypose_tpu.testing.__all__`` is in the port's counterpart."""
    import pypose_tpu_torch.function as tfunction
    import pypose_tpu_torch.testing as ttesting
    for jmod, tmod in ((jfunction, tfunction), (jtesting, ttesting)):
        for name in jmod.__all__:
            assert callable(getattr(tmod, name)), name


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
