"""The JAX anchor of the port's chain-dominated pose graph (pgo-chain).

``bench.py:bench_pgo_chain``'s workload on the port's instance: the port's
``synthetic_sphere(5000, loops_per_pose=0.04, seed=5)`` (the JAX
generator's topology, 4,999 odometry edges and 200 loops at offset 222,
its noise from a ``torch.Generator``), one odometry run and the loops as
two factors (``split_chain_edges``), TrustRegion(1e4), cg_iter 200,
cg_tol 1e-6, pose 0 fixed, ``optimize(steps=6, decreasing=1e-6,
patience=2)``.  ``precond='auto'`` picks the chain preconditioner (block
cyclic reduction over 13 levels, padded to 8,192) on both sides.  The
target is what the JAX package's ``SparseLM`` computes on exactly this
instance: ``data/jax_anchor_pgo_chain5k_seed5.json``.  Write it (JAX, then
the port on the CPU, ~30 s):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_pgo_chain_anchor.py

Tolerances.  Every CG solve after the first runs to its 200-iteration
cap, and in float32 the chain preconditioner's long-wavelength error is
large (the chain part's condition grows ~N^2), so the trajectory follows
the last bits of each implementation.  When the translations of 10 poses
move by one ulp, the JAX package's own final chi2 lands between -4.3e-3
and +8.1e-3 of the anchor (five nudges; ``python
tests/test_torch_pgo_chain_anchor.py --spread 5`` prints them beside the
port's), so no float32 implementation can be held within 1e-3.  The BCR
factor's level products sum each entry as a forward FMA chain, as XLA's
CPU dot does (``ops/block_tridiag.py:_mm``); with torch's matmul, which
rounds each product apart, the factor erred ~15% more a product and the
port's CPU final sat 2.6e-2 above the anchor.  On the CPU the port's
first step is now within 3.9e-6 of the anchor's and its final chi2
within 8.9e-4 (0.1905221 against 0.1906914); either package in float64
ends at 0.18727.  The first step is held within 3e-4, the final chi2
within 1e-2, the JAX package's own spread.
"""

import json

import numpy as np

from pypose_tpu_torch.datasets import find_data, synthetic_sphere
from pypose_tpu_torch.testing import instance_checksum, pgo_optimizer
from pypose_tpu_torch.testing import cap_threads

cap_threads()

ANCHOR = 'jax_anchor_pgo_chain5k_seed5.json'
N, LOOPS, SEED = 5000, 0.04, 5
# bench.py:654-685 (bench_pgo_chain)
SCHEDULE = dict(radius=1e4, cg_iter=200, cg_tol=1e-6, steps=6,
                decreasing=1e-6, patience=2)
FIRST_RTOL, FINAL_RTOL = 3e-4, 1e-2


def instance(device='cpu'):
    return synthetic_sphere(N, loops_per_pose=LOOPS, seed=SEED,
                            device=device)


def _anchor():
    with open(find_data(ANCHOR)) as f:
        return json.load(f)


def test_instance_matches_anchor():
    got = instance_checksum(instance())
    want = _anchor()['instance_checksum']
    assert got['n_edges'] == want['n_edges'] == 5199
    for key in ('nodes_abs_sum', 'poses_abs_sum'):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


def test_optimize_matches_anchor(monkeypatch):
    """The port's full schedule on the CPU: route 'chain' (the JAX
    package's preconditioner), no stencil solve, chi2 against the
    anchor within the tolerances above."""
    from pypose_tpu_torch.optim import sparse
    monkeypatch.setattr(sparse, 'stencil_cg', None)
    anchor = _anchor()
    opt = pgo_optimizer(instance(), **SCHEDULE)
    assert opt.route == 'chain' == anchor['jax_precond']
    final = opt.optimize(steps=SCHEDULE['steps'],
                         decreasing=SCHEDULE['decreasing'],
                         patience=SCHEDULE['patience'])
    np.testing.assert_allclose(opt.history[0], anchor['history'][0],
                               rtol=FIRST_RTOL)
    np.testing.assert_allclose(final, anchor['final_chi2'], rtol=FINAL_RTOL)
    assert all(0 < i <= SCHEDULE['cg_iter']
               for step in opt.cg_iterations for i in step)


def _jax_anchor(ds):
    """The JAX package's SparseLM on the port's instance, crossed over as
    numpy: (chi2 history, final, its preconditioner, initial chi2)."""
    import jax.numpy as jnp
    from pypose_tpu.lietensor.utils import SE3
    from pypose_tpu.optim.sparse import (SparseLM, pgo_factor,
                                         split_chain_edges)
    from pypose_tpu.optim.strategy import TrustRegion

    edges = jnp.asarray(ds['edges'].numpy().astype(np.int32))
    Z = SE3(jnp.asarray(ds['poses'].tensor().numpy()))
    nodes = SE3(jnp.asarray(ds['nodes'].tensor().numpy()))
    runs, rest = split_chain_edges(edges)
    factors = [pgo_factor(edges[jnp.asarray(r)], Z[jnp.asarray(r)])
               for r in list(runs) + ([rest] if len(rest) else [])]
    opt = SparseLM({'poses': nodes}, factors,
                   strategy=TrustRegion(radius=SCHEDULE['radius']),
                   fixed={'poses': jnp.zeros(N, bool).at[0].set(True)},
                   cg_iter=SCHEDULE['cg_iter'], cg_tol=SCHEDULE['cg_tol'])
    initial = float(opt._chi2(opt.params, opt._factor_data()))
    final = opt.optimize(steps=SCHEDULE['steps'],
                         decreasing=SCHEDULE['decreasing'],
                         patience=SCHEDULE['patience'])
    return [float(h) for h in opt.history], float(final), opt.precond, \
        initial


def _nudged(ds, seed):
    """``ds`` with the translations of 10 poses (not pose 0, drawn from
    ``np.random.default_rng(seed)``) moved up by one float32 ulp."""
    import torch
    from pypose_tpu_torch.lietensor.utils import SE3
    x = ds['nodes'].tensor().numpy().copy()
    idx = np.random.default_rng(seed).choice(np.arange(1, N), 10,
                                             replace=False)
    x[idx, :3] = np.nextafter(x[idx, :3], np.float32(np.inf))
    return dict(ds, nodes=SE3(torch.from_numpy(x)))


def spread(n):
    """The float32 trajectory's sensitivity: both packages' final chi2 on
    ``n`` one-ulp nudges of the instance (``_nudged``, seeds 1..n), and the
    port's with its BCR factor computed in float64 and stored in float32,
    printed relative to the anchor; then each package's float32 BCR solve
    error on the last chain system that run factored."""
    import jax.numpy as jnp
    import torch
    from pypose_tpu.ops import block_tridiag as jbt
    from pypose_tpu_torch.ops import block_tridiag as bt
    from pypose_tpu_torch.optim import sparse
    want = _anchor()['final_chi2']
    factor = sparse.bcr_factor
    seen = []

    def factor64(D, L, U):
        seen[:] = [D, L, U]
        fac = factor(D.double(), L.double(), U.double())
        return dict(fac, root_inv=fac['root_inv'].to(D.dtype),
                    levels=[{k: v.to(D.dtype) for k, v in lv.items()}
                            for lv in fac['levels']])
    sparse.bcr_factor = factor64
    try:
        opt = pgo_optimizer(instance(), **SCHEDULE)
        final = opt.optimize(steps=SCHEDULE['steps'],
                             decreasing=SCHEDULE['decreasing'],
                             patience=SCHEDULE['patience'])
    finally:
        sparse.bcr_factor = factor
    print(f'port (CPU), BCR factor in float64: final chi2 {final:.7g}, '
          f'{final / want - 1:+.3e} of the anchor', flush=True)
    D, L, U = seen
    b = torch.randn((D.shape[0], D.shape[-1]),
                    generator=torch.Generator().manual_seed(0))
    exact = bt.bcr_solve(bt.bcr_factor(D.double(), L.double(), U.double()),
                         b.double())
    port = bt.bcr_solve(bt.bcr_factor(D, L, U), b).double()
    jd, jl, ju, jb = (jnp.asarray(v.numpy()) for v in (D, L, U, b))
    ref = torch.from_numpy(np.array(jbt.bcr_solve(jbt.bcr_factor(jd, jl, ju),
                                                  jb))).double()
    print(f'float32 BCR solve on the last chain system, |x - x64| / |x64|: '
          f'port {float((port - exact).norm() / exact.norm()):.3e}, JAX '
          f'{float((ref - exact).norm() / exact.norm()):.3e}', flush=True)
    for seed in range(1, n + 1):
        ds = _nudged(instance(), seed)
        jax_final = _jax_anchor(ds)[1]
        port_final = pgo_optimizer(ds, **SCHEDULE).optimize(
            steps=SCHEDULE['steps'], decreasing=SCHEDULE['decreasing'],
            patience=SCHEDULE['patience'])
        print(f'nudge {seed}: final chi2 relative to the anchor: JAX '
              f'{jax_final / want - 1:+.3e}, port (CPU) '
              f'{port_final / want - 1:+.3e}', flush=True)


def main():
    import sys
    import jax
    jax.config.update('jax_platforms', 'cpu')
    if sys.argv[1:2] == ['--spread']:
        return spread(int(sys.argv[2]))
    from _anchor import write_jax_anchor
    write_jax_anchor(
        ANCHOR, f'pypose_tpu_torch.datasets.synthetic_sphere({N}, '
        f'loops_per_pose={LOOPS}, seed={SEED}), float32, built on the CPU',
        instance(), SCHEDULE, _jax_anchor,
        lambda ds: pgo_optimizer(ds, **SCHEDULE),
        reference='pypose_tpu.optim.sparse.SparseLM on the JAX CPU backend, '
                  'factors as bench.py:bench_pgo_chain builds them: the '
                  'einsum CG with the chain (BCR) preconditioner',
        command='PYTHONPATH=. JAX_PLATFORMS=cpu python '
                'tests/test_torch_pgo_chain_anchor.py')


if __name__ == '__main__':
    main()
