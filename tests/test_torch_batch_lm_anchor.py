"""The JAX anchor of the batch-lm cell: ``bench.py:bench_batch_lm`` (4,096
independent SE3 pose-inversion problems, ``PoseInvB``, four LM steps with
``Constant(damping=1e-6)``) on ``testing.batch_lm_instance(4096, 7)``'s
targets, solved by the JAX package's ``make_batch_optimizer`` (a
``jax.vmap``): ``data/jax_anchor_batch_lm.json`` holds the per-problem
losses and a checksum of the parameters.

Write the file (the JAX package, then the port's CPU run, whose spread is
recorded beside it; ~30 s):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_batch_lm_anchor.py

Tolerances.  Every loss is at float32's rounding floor after four steps
(~1e-13), where its bits are noise: each problem is held within 1e-10
absolute of the JAX package's (and below 1e-8, the JAX test's bound).
The parameter checksum (float64 sum of |params|) within 1e-6 relative,
and the targets' checksum within 1e-6 (the instance).  Before any solve,
the Jacobian of PoseInvB at the targets is held to the JAX package's
within 1e-6.
"""

import json
import sys
import time

import numpy as np

from pypose_tpu_torch.datasets import find_data
from pypose_tpu_torch.optim import make_batch_optimizer
from pypose_tpu_torch.optim.strategy import Constant
from pypose_tpu_torch.testing import batch_lm_instance
from pypose_tpu_torch.testing import cap_threads

cap_threads()

ANCHOR = 'jax_anchor_batch_lm.json'
B, SEED, STEPS = 4096, 7, 4


def checksum(x):
    x = x.tensor() if hasattr(x, 'tensor') else x
    return float(x.detach().double().abs().sum())


def port_run(device='cpu'):
    targets, model = batch_lm_instance(B, SEED, device=device)
    solve = make_batch_optimizer(model, steps=STEPS,
                                 strategy=Constant(damping=1e-6))
    params, losses = solve(targets)
    return targets, params, losses


def held(anchor, targets, params, losses):
    """Failures against the anchor."""
    bad = []
    if abs(checksum(targets) / anchor['targets_checksum'] - 1) > 1e-6:
        bad.append('targets checksum')
    err = float(np.abs(losses.detach().cpu().double().numpy()
                       - np.asarray(anchor['losses'])).max())
    if not err <= 1e-10 or not float(losses.max()) < 1e-8:
        bad.append(f'losses: {err:.3e} from the anchor, max '
                   f'{float(losses.max()):.3e}')
    rel = checksum(params['pose']) / anchor['params_checksum'] - 1
    if not abs(rel) <= 1e-6:
        bad.append(f'params checksum {rel:.3e}')
    return bad


def test_jacobian_matches_jax():
    """J of PoseInvB at the first 3 targets, against the JAX package's
    (storage-shaped columns; an se3 parameter, so all six are live)."""
    import jax.numpy as jnp
    import pypose_tpu as jpp
    from pypose_tpu_torch.optim import LM
    targets, model = batch_lm_instance(3, SEED, device='cpu')

    class JB(jpp.Module):
        def __init__(self):
            super().__init__()
            self.pose = jpp.Parameter(jpp.identity_se3(1))

        def forward(self, input):
            return (self.pose.Exp() @ input).Log().tensor()
    jopt = jpp.optim.LM(JB())
    tx = targets.tensor().numpy()
    for b in range(3):
        _, jJ = jopt._residuals_and_jac(
            jopt._params(), jpp.SE3(jnp.asarray(tx[b])), None)
        topt = LM(model)
        _, tJ = topt._residuals_and_jac(topt._params(), targets[b], None)
        np.testing.assert_allclose(tJ[0].numpy(), np.asarray(jJ[0]),
                                   atol=1e-6)


def test_port_cpu_matches_anchor():
    with open(find_data(ANCHOR)) as f:
        anchor = json.load(f)
    targets, params, losses = port_run()
    assert losses.shape == (B,) and params['pose'].shape == (B, 1, 6)
    assert not held(anchor, targets, params, losses)


def _jax_run(targets):
    import jax.numpy as jnp
    import pypose_tpu as jpp
    from pypose_tpu.optim import make_batch_optimizer as jmake
    from pypose_tpu.optim.strategy import Constant as JConstant

    class PoseInvB(jpp.Module):
        def __init__(self):
            super().__init__()
            self.pose = jpp.Parameter(jpp.identity_se3(1))

        def forward(self, input):
            return (self.pose.Exp() @ input).Log().tensor()
    solve = jmake(PoseInvB(), steps=STEPS,
                  strategy=JConstant(damping=1e-6))
    params, losses = solve(jpp.SE3(jnp.asarray(targets.tensor().numpy())))
    return (np.asarray(params['pose'].tensor(), np.float64),
            np.asarray(losses, np.float64))


if __name__ == '__main__':
    from _anchor import write_anchor
    targets, _ = batch_lm_instance(B, SEED, device='cpu')
    t0 = time.perf_counter()
    jparams, jlosses = _jax_run(targets)
    jax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, tparams, tlosses = port_run()
    port_s = time.perf_counter() - t0
    tl = tlosses.double().numpy()
    spread = {'losses_max_abs': float(np.abs(tl - jlosses).max()),
              'params_max_abs': float(np.abs(
                  tparams['pose'].tensor().double().numpy() - jparams).max())}
    print(f'JAX: max loss {jlosses.max():.3e}; port CPU max loss '
          f'{tl.max():.3e}; spread {spread}', flush=True)
    write_anchor('batch_lm', 'tests/test_torch_batch_lm_anchor.py', {
        'problem': f'bench.py:bench_batch_lm: B={B} PoseInvB problems, '
                   f'{STEPS} LM steps, Constant(damping=1e-6), targets '
                   f'testing.batch_lm_instance({B}, {SEED})',
        'targets_checksum': checksum(targets),
        'params_checksum': float(np.abs(jparams).sum()),
        'max_loss': float(jlosses.max()),
        'port_cpu_spread': spread,
        'tolerance': 'each loss within 1e-10 absolute (and below 1e-8); '
                     'params checksum within 1e-6 relative',
        'seconds': {'jax': round(jax_s, 1), 'port_cpu': round(port_s, 1)},
        'losses': [float('%.4g' % v) for v in jlosses]})
    sys.exit(0)
