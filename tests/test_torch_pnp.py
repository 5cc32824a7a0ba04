"""``module/pnp.py:EPnP`` of the port against the JAX package on the same
numpy-drawn problems (``testing.epnp_instance``: ``bench.py:
bench_modules``' shapes and intrinsics), in float32 and float64, and the
EPnP cells' JAX anchor.

The 12 x 12 ``eigh`` of M^T M and the 3 x 3 SVDs differ in their
eigenvector signs and near-degenerate null spaces between LAPACK and XLA,
so the null space and the betas are never compared: the poses are, and
their errors against the true pose.  Each problem's chosen candidate
(N = 1..4, least mean reprojection error) is compared too: where two
candidates' errors are within rounding, the packages may pick different
ones, and the count of such problems is reported and bounded.

Tolerances: float64 poses within 1e-10 (measured 1.5e-12 at B = 64).
float32 poses of a problem within 2 (e_port + e_jax) + 1e-6, e being each
package's error |Log(T^-1 T_true)|_inf on that problem (by the triangle
inequality the gap is at most about e_port + e_jax; measured up to 1.4
times it over 10,000 problems); the median and the 99th percentile of
the errors within 25% of the JAX package's at B = 10,000 (measured 6%
and 2.5%; at smaller B, and refined, the quantiles are float32 noise),
the largest within twice its; candidate flips at most 1% of the problems,
or one (measured 18 of 10,000, and 1 of 64 at seed 1).

The anchor (``data/jax_anchor_epnp.json``): the JAX package's [epnp] cell
(B = 10,000, n = 12, ``refine=False``; its error quantiles, every
problem's candidate, the poses and errors of the first 256) and
[epnp-refine] (B = 16, ``refine=True``).  Write it (~30 s) with
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_pnp.py``.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.function.geometry import reprojerr as jreprojerr
from pypose_tpu.module import EPnP as JEPnP
from pypose_tpu.module.pnp import BetaObjective as JBetaObjective
from pypose_tpu_torch.datasets import find_data
from pypose_tpu_torch.function.geometry import reprojerr as pp_reprojerr
from pypose_tpu_torch.module import EPnP
from pypose_tpu_torch.module.pnp import BetaObjective
from pypose_tpu_torch.testing import (EPNP_CELLS as CELLS, epnp_failures,
                                      epnp_instance, epnp_solve, epnp_stats)
from pypose_tpu_torch.testing import cap_threads

cap_threads()

ANCHOR = 'jax_anchor_epnp.json'
ANCHOR_POSES = 256


def _np(x):
    x = x.tensor() if hasattr(x, 'tensor') else x
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def jax_solve(d, refine):
    """The JAX package's EPnP on a port instance: (poses [B, 7], each
    problem's candidate, errors against the true pose), float64 numpy."""
    J = {k: jnp.asarray(_np(v)) for k, v in d.items()}
    e = JEPnP(intrinsics=J['intrinsics'], refine=refine)

    def candidate(P, X, K):
        with jax.default_matmul_precision('float32'):
            bases = e._svd_basis(P)
            alpha = e._compute_alpha(P, bases)
            nullv = e._compute_nullv(X, alpha, K)
            betas = e._compute_betas(*e._compute_lrho(nullv, bases))
            poses, _ = e._compute_solution(betas, nullv, alpha, P)
            err = jreprojerr(P, X, K, poses, reduction='norm')
            return jnp.argmin(err.mean(-1), 0)
    pose = e(J['points'], J['pixels'])
    idx = jax.jit(candidate)(J['points'], J['pixels'], J['intrinsics'])
    err = jnp.abs((pose.Inv() @ jpp.SE3(J['pose'])).Log().tensor()).max(-1)
    return (np.asarray(pose.tensor(), np.float64), np.asarray(idx),
            np.asarray(err, np.float64))


def reference(poses, cands, errs):
    """A result as ``epnp_failures`` takes its reference."""
    return {'stats': epnp_stats(errs), 'candidates': cands.reshape(-1),
            'poses': poses.reshape(-1, 7), 'errors': errs.reshape(-1)}


# the parity cases: (problems, refine, instance seed); B = 1 drops the batch
PARITY = {'one': (1, False, 1), 'B64': (64, False, 1), 'refine': (8, True, 2)}


def parity_instance(case, dtype):
    B, refine, seed = PARITY[case]
    d = epnp_instance(B, seed=seed, device='cpu', dtype=getattr(torch, dtype))
    if B == 1:
        d = {k: v[0] if k != 'intrinsics' else v for k, v in d.items()}
    return d, refine


def parity_reference(case, dtype):
    """The JAX package's result on a parity case, as the anchor file
    stores it (the writer runs the JAX package at XLA's default
    optimization level; under tests/conftest.py's level 0 its SVD-based
    solves give NaN poses on some of these problems)."""
    with open(find_data(ANCHOR)) as f:
        want = json.load(f)['parity'][f'{case}-{dtype}']
    return {k: np.asarray(v) if k != 'candidates' else v
            for k, v in want.items()}


def check_parity(case, dtype):
    want = parity_reference(case, dtype)
    tp, tidx, terr = epnp_solve(*parity_instance(case, dtype))
    tp, tidx, terr = tp.reshape(-1, 7), tidx.reshape(-1), terr.reshape(-1)
    if dtype == 'float64':
        np.testing.assert_allclose(tp, want['poses'], rtol=0, atol=1e-10)
        assert [int(c) for c in tidx] == [int(c) for c in
                                          want['candidates']]
        return terr
    bad, _ = epnp_failures(case, dict(want, stats=epnp_stats(
        want['errors'])), tp, tidx, terr)
    assert not bad
    return terr


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('B', [1, 64], ids=['one', 'B64'])
def test_epnp_matches_jax(B, dtype):
    """``refine=False``: a single problem (no batch dims) and 64 problems."""
    check_parity('one' if B == 1 else 'B64', dtype)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_epnp_refine_matches_jax(dtype):
    """``refine=True`` at B = 8 (Gauss-Newton over the betas, a dense
    48 x 32 Jacobian): the refined poses, at least as good as the
    unrefined ones."""
    terr = check_parity('refine', dtype)
    d, _ = parity_instance('refine', dtype)
    assert np.median(terr) <= np.median(epnp_solve(d, False)[2])


def test_a_degenerate_candidate_is_never_picked():
    """A candidate whose betas are all 0 (its least-squares first component
    rounded to exactly 0, as it is on the card for some problems) has a
    0/0 scale and a NaN reprojection error: the finite candidate of least
    error is picked, never the NaN one (``jnp.argmin`` would pick it)."""
    d = epnp_instance(16, seed=1, device='cpu')
    e = EPnP(intrinsics=d['intrinsics'], refine=False)
    c = e._candidates(d['points'], d['pixels'], d['intrinsics'])
    betas = c['betas'].clone()
    betas[0] = 0.0
    poses, scales = e._compute_solution(betas, c['nullv'], c['alpha'],
                                        d['points'])
    assert bool(scales[0].isnan().all())
    errors = pp_reprojerr(d['points'], d['pixels'], d['intrinsics'], poses,
                          reduction='norm')
    idx = e._best_index(errors)
    assert bool((idx != 0).all())
    pose, _, _ = e._best_solution(errors, poses, betas, scales)
    assert bool(torch.isfinite(pose.tensor()).all())
    want = torch.argmin(errors[1:].mean(-1), 0) + 1
    assert torch.equal(idx, want)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_beta_objective_matches_jax(dtype):
    rng = np.random.default_rng(3)
    beta, base_w, nullv = (rng.normal(size=s).astype(dtype)
                           for s in ((5, 4), (5, 4, 3), (5, 4, 12)))
    t = BetaObjective(torch.from_numpy(beta))(torch.from_numpy(base_w),
                                              torch.from_numpy(nullv))
    with jax.enable_x64(dtype == 'float64'):
        j = JBetaObjective(jnp.asarray(beta))(jnp.asarray(base_w),
                                              jnp.asarray(nullv))
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=1e-5 if dtype == 'float32'
                                   else 1e-12)


@pytest.mark.parametrize('name', list(CELLS))
def test_cells_hold_the_jax_anchor(name):
    """[epnp] (10,000 problems) and [epnp-refine] (16) at full size on the
    CPU against data/jax_anchor_epnp.json."""
    with open(find_data(ANCHOR)) as f:
        anchor = json.load(f)[name]
    B, refine = CELLS[name]
    d = epnp_instance(B, device='cpu')
    assert float(d['pixels'].double().abs().sum()) == pytest.approx(
        anchor['instance_checksum'], rel=1e-12)
    bad, numbers = epnp_failures(name, anchor, *epnp_solve(d, refine))
    assert not bad, (bad, numbers)


if __name__ == '__main__':
    import time
    from _anchor import write_anchor
    out = {}
    for name, (B, refine) in CELLS.items():
        d = epnp_instance(B, device='cpu')
        t0 = time.perf_counter()
        jp, jidx, jerr = jax_solve(d, refine)
        jax_s = time.perf_counter() - t0
        n = min(B, ANCHOR_POSES)
        out[name] = {
            'B': B, 'refine': refine,
            'instance_checksum': float(d['pixels'].double().abs().sum()),
            'stats': epnp_stats(jerr),
            'candidates': ''.join(str(int(i)) for i in jidx),
            'poses': jp[:n].tolist(), 'errors': jerr[:n].tolist()}
        t0 = time.perf_counter()
        bad, numbers = epnp_failures(name, out[name],
                                     *epnp_solve(d, refine))
        out[name]['port_cpu'] = dict(numbers, failures=bad)
        out[name]['seconds'] = {'jax': round(jax_s, 1),
                                'port_cpu': round(time.perf_counter() - t0,
                                                  1)}
        print(name, out[name]['stats'], out[name]['port_cpu'], flush=True)
    parity = {}
    for case in PARITY:
        for dtype in ('float32', 'float64'):
            d, refine = parity_instance(case, dtype)
            with jax.enable_x64(dtype == 'float64'):
                jp, jidx, jerr = jax_solve(d, refine)
            parity[f'{case}-{dtype}'] = {
                'poses': jp.reshape(-1, 7).tolist(),
                'candidates': [int(i) for i in jidx.reshape(-1)],
                'errors': jerr.reshape(-1).tolist()}
    write_anchor('epnp', 'tests/test_torch_pnp.py', {
        'parity': parity,
        'problem': 'bench.py:bench_modules [epnp]: testing.epnp_instance(B, '
                   'n=12, seed=0), float32, intrinsics fx = fy = 500, (cx, '
                   'cy) = (320, 240); errors |Log(T^-1 T_true)|_inf',
        'tolerance': 'error median and p99 within 25%, max within 2x; '
                     'poses of the first 256 within 2 (e + e_ref) + 1e-6; '
                     'candidate flips at most 1% (or one)',
        **out})
