"""``utils/checkpoint.py``, ``utils/timer.py``, ``utils/collect_env.py`` and
``testing/comparison.py`` of the port, with the JAX package beside them:

- checkpoints in both directions in one file format: a tree the JAX
  package saved (LieTensors of four types, arrays, scalars, strings,
  nested lists, a tuple, an LM run's parameters and strategy state)
  loads in the port with the same values and ltypes, and the port's
  saves load in the JAX package; an LM run saved after one step resumes
  (JAX -> port and port -> port) as tests/utils/test_utils.py does;
- ``Timer(device='cpu')`` times without a card; ``collect_env`` reports
  torch and the card's tools; ``assert_close`` from
  ``testing.comparison`` (also re-exported by ``testing``) against the
  JAX package's on the same inputs.

Values are compared exactly (the file stores the arrays' bits).
"""

import os
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.testing import assert_close as j_assert_close
from pypose_tpu.utils import checkpoint as jcheckpoint
import pypose_tpu_torch as ppt
import pypose_tpu_torch.testing
from pypose_tpu_torch.testing import cap_threads
from pypose_tpu_torch.testing.comparison import assert_close
from pypose_tpu_torch.utils import (Timer, checkpoint, collect_env,
                                    get_pretty_env_info)

cap_threads()


def storage(x):
    x = x.tensor() if hasattr(x, 'tensor') else x
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def jax_tree():
    k = jax.random.PRNGKey
    return {'poses': jpp.randn_SE3(3, key=k(0)), 'step': 7,
            'arr': jnp.arange(4.0),
            'nested': [jpp.randn_so3(2, key=k(1)), 'tag',
                       [jpp.randn_Sim3(2, key=k(2)), {'s': 0.5}]],
            'tup': (1.5, jnp.ones(2), jpp.randn_RxSO3(1, key=k(3))),
            'none': None}


def port_tree():
    g = torch.Generator().manual_seed(0)
    return {'poses': ppt.randn_SE3(3, generator=g), 'step': 7,
            'arr': torch.arange(4.0),
            'nested': [ppt.randn_so3(2, generator=g), 'tag',
                       [ppt.randn_Sim3(2, generator=g), {'s': 0.5}]],
            'tup': (1.5, torch.ones(2), ppt.randn_RxSO3(1, generator=g)),
            'none': None, 'f64': torch.ones(2, dtype=torch.float64)}


def same_tree(a, b, names):
    """Same structure, values and ltype names (``names`` maps each
    package's ltype to its name)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            same_tree(a[k], b[k], names)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            same_tree(x, y, names)
    elif hasattr(a, 'ltype'):
        assert names(a) == names(b)
        np.testing.assert_array_equal(storage(a), storage(b))
    elif hasattr(a, 'shape'):
        np.testing.assert_array_equal(storage(a), storage(b))
    else:
        assert a == b


def ltype_name(x):
    return x.ltype.name


def test_jax_checkpoint_loads_in_port(tmp_path):
    path = os.path.join(str(tmp_path), 'jax_state')
    tree = jax_tree()
    jcheckpoint.save(path, tree)
    back = checkpoint.load(path, device='cpu')
    same_tree(tree, back, ltype_name)
    assert back['poses'].ltype is ppt.SE3_type
    assert back['nested'][2][0].ltype is ppt.Sim3_type
    assert back['tup'][2].ltype is ppt.RxSO3_type
    assert back['poses'].device.type == 'cpu'


def test_port_checkpoint_loads_in_jax(tmp_path):
    path = os.path.join(str(tmp_path), 'port_state.npz')
    tree = port_tree()
    checkpoint.save(path, tree)
    with jax.enable_x64(True):
        back = jcheckpoint.load(path)
        same_tree(tree, back, ltype_name)
    assert back['poses'].ltype is jpp.SE3_type
    same_tree(tree, checkpoint.load(path, device='cpu'), ltype_name)


def test_checkpoint_files_are_the_same_bytes(tmp_path):
    """The same tree (numpy leaves) saved by both packages: the same
    manifest and arrays."""
    a = np.arange(6.0).reshape(2, 3).astype(np.float32)
    q = np.array([[0., 0, 0, 0, 0, 0, 1]], np.float32)
    for pkg, ck, lie in (('jax', jcheckpoint, jpp.SE3(jnp.asarray(q))),
                         ('port', checkpoint, ppt.SE3(torch.tensor(q)))):
        ck.save(os.path.join(str(tmp_path), pkg),
                {'a': a, 'T': lie, 'n': 3, 'l': (1, [2.0, 'x'])})
    with np.load(os.path.join(str(tmp_path), 'jax.npz')) as j, \
            np.load(os.path.join(str(tmp_path), 'port.npz')) as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            np.testing.assert_array_equal(j[k], p[k])


class _PoseInv:
    """tests/utils/test_utils.py's PoseInv in both packages."""

    @staticmethod
    def port(pose):
        class PoseInv(ppt.Module):
            def __init__(self):
                super().__init__()
                self.pose = ppt.Parameter(pose)

            def forward(self, input):
                return (self.pose.Exp() @ input).Log().tensor()
        return PoseInv()

    @staticmethod
    def jax(key):
        class PoseInv(jpp.Module):
            def __init__(self):
                super().__init__()
                self.pose = jpp.Parameter(jpp.randn_se3(2, sigma=0.5,
                                                        key=key))

            def forward(self, input):
                return (self.pose.Exp() @ input).Log().tensor()
        return PoseInv()


def _resume(state, inputs, steps=5):
    m = _PoseInv.port(ppt.identity_se3(2))
    m.load_parameter_dict(state['params'])
    opt = ppt.optim.LM(m)
    opt.strategy_state = state['strategy']
    losses = [opt.step(inputs) for _ in range(steps)]
    return m, losses


def test_lm_run_resumes_from_a_jax_checkpoint(tmp_path):
    """One LM step in the JAX package, saved; the port loads it and takes
    five more: the same losses as the JAX package's five more, and below
    1e-8 at the end."""
    path = os.path.join(str(tmp_path), 'opt')
    inputs = jpp.randn_SE3(2, key=jax.random.PRNGKey(4))
    m = _PoseInv.jax(jax.random.PRNGKey(5))
    opt = jpp.optim.LM(m)
    opt.step(inputs)
    jcheckpoint.save(path, {'params': m.parameters(),
                            'strategy': opt.strategy_state})
    want = [float(opt.step(inputs)) for _ in range(5)]
    state = checkpoint.load(path, device='cpu')
    assert state['params']['pose'].ltype is ppt.se3_type
    _, got = _resume(state, ppt.SE3(torch.tensor(np.asarray(
        inputs.tensor()))))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-10)
    assert got[-1] < 1e-8


def test_lm_run_resumes_from_a_port_checkpoint(tmp_path):
    path = os.path.join(str(tmp_path), 'opt')
    g = torch.Generator().manual_seed(4)
    inputs = ppt.randn_SE3(2, generator=g)
    m = _PoseInv.port(ppt.randn_se3(2, sigma=0.5, generator=g))
    opt = ppt.optim.LM(m)
    opt.step(inputs)
    checkpoint.save(path, {'params': m.parameter_dict(),
                           'strategy': opt.strategy_state})
    state = checkpoint.load(path, device='cpu')
    assert state['params']['pose'].ltype is ppt.se3_type
    assert sorted(state['strategy']) == sorted(opt.strategy_state)
    m2, losses = _resume(state, inputs)
    assert losses[-1] < 1e-8
    # the JAX package resumes the port's run too
    jstate = jcheckpoint.load(path)
    jm = _PoseInv.jax(jax.random.PRNGKey(6))
    jm.load_parameters({'pose': jpp.nn.Parameter(jstate['params']['pose'])})
    jopt = jpp.optim.LM(jm)
    jopt.strategy_state = jstate['strategy']
    jinputs = jpp.SE3(jnp.asarray(inputs.tensor().numpy()))
    for _ in range(5):
        jloss = jopt.step(jinputs)
    assert float(jloss) < 1e-8


def test_timer_on_the_cpu():
    t = Timer(device='cpu')
    t.tic()
    time.sleep(0.01)
    d = t.toc()
    assert 0.005 < d < 5
    t.start()
    assert 0 <= t.end(reset=False) <= t.end() < 5
    assert t.device.type == 'cpu'


def test_timer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('covered by tests/test_torch_cuda.py on a card')
    with pytest.raises((RuntimeError, AssertionError)):
        Timer()


def test_collect_env(capsys):
    info = get_pretty_env_info()
    for line in ('pypose_tpu_torch version', 'PyTorch version',
                 'CUDA available', 'nvcc', 'nvidia-smi (name, power limit)'):
        assert line in info
    collect_env()
    assert 'PyTorch version' in capsys.readouterr().out


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_assert_close_matches_jax(dtype):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 3)).astype(dtype)
    assert pypose_tpu_torch.testing.assert_close is assert_close
    cases = [(a, a + 1e-9, {}), (a, a + 1e-3, {}), (a, a * (1 + 1e-6), {}),
             (a, a + 1e-3, dict(atol=1e-2))]
    for x, y, kw in cases:
        outcomes = []
        for fn, wrap in ((j_assert_close, jnp.asarray),
                         (assert_close, torch.tensor)):
            try:
                with jax.enable_x64(dtype == np.float64):
                    fn(wrap(x), wrap(y.astype(dtype)), **kw)
                outcomes.append(True)
            except AssertionError:
                outcomes.append(False)
        assert outcomes[0] == outcomes[1], (x.dtype, kw, outcomes)
    # group LieTensors by (a^-1 b).Log(): q and -q are the same rotation
    q = np.array([[0.1, 0.2, 0.3, 0, 0, 0, 0]], dtype)
    q[0, 3:] = [0.2, 0.1, 0.3, 0.9]
    q[0, 3:] /= np.linalg.norm(q[0, 3:])
    neg = q.copy()
    neg[0, 3:] *= -1
    assert_close(ppt.SE3(torch.tensor(q)), ppt.SE3(torch.tensor(neg)))
    with pytest.raises(AssertionError):
        q2 = q.copy()
        q2[0, 0] += 1e-3
        assert_close(ppt.SE3(torch.tensor(q)), ppt.SE3(torch.tensor(q2)))
