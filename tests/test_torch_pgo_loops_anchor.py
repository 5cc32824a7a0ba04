"""The JAX anchor of the port's random-loop pose graph (pgo-loops-10k).

``bench.py:bench_pgo_groups``'s topology over SE3
(``pypose_tpu_torch.testing.pgo_loops_instance``): 10,000 nodes on a ring
with N // 10 random loops, exact measurements, initial poses 0.1-sigma off
the truth; one ``pgo_factor`` over all 11,000 edges, TrustRegion(1e4),
cg_iter 100, cg_tol 1e-8, node 0 fixed, ``optimize(steps=6,
decreasing=1e-10, patience=2)``.  The graph fits no merged stencil, so
both packages take the einsum CG with ``CouplingSpMV`` (9,999 chain rows
by slice, 1,001 loop rows one-hot) and the scalarized block-Jacobi.  The
target is what the JAX package's ``SparseLM`` computes on exactly this
instance: ``data/jax_anchor_pgo_loops10k.json``.  Write it (JAX, then the
port on the CPU, ~15 s):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_pgo_loops_anchor.py

Tolerances.  The run starts at chi2 1289 and, with exact measurements,
heads for zero; every solve runs to its 100-iteration cap.  On the CPU the
port's history (every entry above 1e-3) is within 6.5e-5 of the anchor's:
entries above 1e-3 are held within 1e-3.  Both sides end at 2.3e-6 of the
initial chi2 (JAX 0.0029279): each must end below 1e-5 of it.  The issue's
first aim, below 1e-6 of the first entry, is out of reach of the JAX
package itself on this schedule (its final is 1.5e-3 of its first entry).
"""

import json

import numpy as np

from pypose_tpu_torch.datasets import find_data
from pypose_tpu_torch.testing import (instance_checksum, pgo_loops_instance,
                                      pgo_optimizer)

ANCHOR = 'jax_anchor_pgo_loops10k.json'
N = 10_000
# bench.py:730-773 (bench_pgo_groups)
SCHEDULE = dict(radius=1e4, cg_iter=100, cg_tol=1e-8, steps=6,
                decreasing=1e-10, patience=2, split_chains=False)
HIST_RTOL, HIST_FLOOR, END_SHARE = 1e-3, 1e-3, 1e-5


def _anchor():
    with open(find_data(ANCHOR)) as f:
        return json.load(f)


def check_history(hist, anchor):
    """The anchor tolerances above, for a chi2 history ``hist``."""
    want = np.asarray(anchor['history'])
    assert len(hist) == len(want)
    big = want > HIST_FLOOR
    np.testing.assert_allclose(np.asarray(hist)[big], want[big],
                               rtol=HIST_RTOL)
    assert hist[-1] < END_SHARE * anchor['initial_chi2']
    assert want[-1] < END_SHARE * anchor['initial_chi2']


def test_instance_matches_anchor():
    got = instance_checksum(pgo_loops_instance(N, device='cpu'))
    want = _anchor()['instance_checksum']
    assert got['n_edges'] == want['n_edges'] == 11_000
    for key in ('nodes_abs_sum', 'poses_abs_sum'):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


def test_optimize_matches_anchor(monkeypatch):
    """The port's full schedule on the CPU: route 'einsum' through one
    CouplingSpMV, no stencil solve, chi2 history against the anchor."""
    from pypose_tpu_torch.ops.spmv import CouplingSpMV
    from pypose_tpu_torch.optim import sparse
    monkeypatch.setattr(sparse, 'stencil_cg', None)
    anchor = _anchor()
    opt = pgo_optimizer(pgo_loops_instance(N, device='cpu'), **SCHEDULE)
    assert opt.route == 'einsum' and anchor['jax_precond'] == 'jacobi'
    (sp,) = opt._spmv
    assert isinstance(sp, CouplingSpMV) and sp._chain_contig
    assert (len(sp.chain_rows), len(sp.loop_rows)) == (9999, 1001)
    opt.optimize(steps=SCHEDULE['steps'], decreasing=SCHEDULE['decreasing'],
                 patience=SCHEDULE['patience'])
    check_history(opt.history, anchor)


def _jax_anchor(ds):
    """The JAX package's SparseLM on the port's instance, crossed over as
    numpy, as bench.py:bench_pgo_groups builds it: (chi2 history, final,
    its preconditioner, initial chi2)."""
    import jax.numpy as jnp
    from pypose_tpu.lietensor.utils import SE3
    from pypose_tpu.optim.sparse import SparseLM, pgo_factor
    from pypose_tpu.optim.strategy import TrustRegion
    edges = jnp.asarray(ds['edges'].numpy().astype(np.int32))
    Z = SE3(jnp.asarray(ds['poses'].tensor().numpy()))
    opt = SparseLM({'x': SE3(jnp.asarray(ds['nodes'].tensor().numpy()))},
                   [pgo_factor(edges, Z, name='x')],
                   strategy=TrustRegion(radius=SCHEDULE['radius']),
                   fixed={'x': jnp.zeros(N, bool).at[0].set(True)},
                   cg_iter=SCHEDULE['cg_iter'], cg_tol=SCHEDULE['cg_tol'])
    initial = float(opt._chi2(opt.params, opt._factor_data()))
    final = opt.optimize(steps=SCHEDULE['steps'],
                         decreasing=SCHEDULE['decreasing'],
                         patience=SCHEDULE['patience'])
    return [float(h) for h in opt.history], float(final), opt.precond, \
        initial


def main():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from _anchor import write_jax_anchor
    write_jax_anchor(
        ANCHOR, f'pypose_tpu_torch.testing.pgo_loops_instance({N}), '
        'float32, built on the CPU', pgo_loops_instance(N, device='cpu'),
        SCHEDULE, _jax_anchor, lambda ds: pgo_optimizer(ds, **SCHEDULE),
        reference='pypose_tpu.optim.sparse.SparseLM on the JAX CPU backend, '
                  'one pgo_factor as bench.py:bench_pgo_groups builds it: '
                  'the einsum CG with CouplingSpMV and the scalarized '
                  'block-Jacobi (blockinv_scalar)',
        command='PYTHONPATH=. JAX_PLATFORMS=cpu python '
                'tests/test_torch_pgo_loops_anchor.py')


if __name__ == '__main__':
    main()
