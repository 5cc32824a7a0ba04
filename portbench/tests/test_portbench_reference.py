"""The plain reference against the port's CPU path on small spheres, and
the judge's numbers on results it has to find wrong."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import judge
import problems
from reference import lie, lm

SCHEDULE = [{'cg_iter': 100, 'cg_tol': 1e-9, 'steps': 5,
             'decreasing': 1e-6, 'patience': 2}]


def _graph(group, n=150, seed=3):
    g = problems.sphere(n, seed)
    return problems.lift_sim3(g, seed + 1) if group == 'Sim3' else g


def _port(g, group):
    from pypose_tpu_torch.lietensor.lietensor import (LieTensor, SE3_type,
                                                      Sim3_type)
    lt = SE3_type if group == 'SE3' else Sim3_type
    nodes, meas = problems.storage(g, group)
    return LieTensor(nodes, ltype=lt), LieTensor(meas, ltype=lt)


@pytest.mark.parametrize('group', ['SE3', 'Sim3'])
def test_residual_and_jacobian_match_the_port(group):
    """float64: the residual to rounding; the Jacobian to central
    differences and to the port's per-edge closed form Jl^-1(r) Adj(M),
    which sits up to 2.4e-7 of max |J| off the exact derivative in
    float64 (its coefficients are evaluated to float32's reach; its Sim3
    Log and Exp, through the same, up to 5e-8 off)."""
    from pypose_tpu_torch.optim.sparse import pgo_factor
    g = _graph(group)
    X, Z = _port(g, group)
    f = pgo_factor(g['edges'], Z)
    vals = {'poses': X[g['edges']]}
    r_p = f.residuals(vals, Z)
    _, J_p = torch.func.vmap(f.jacobian)(vals, Z)
    J_p = torch.cat([J_p['poses'][:, :, 0], J_p['poses'][:, :, 1]], -1)
    G = lm.Graph(g['nodes'], g['edges'], g['meas'], group)
    r, J = G.jacobians(G.nodes)
    assert torch.allclose(r, r_p, rtol=0,
                          atol=1e-10 if group == 'SE3' else 1e-7)
    assert torch.allclose(J, J_p, rtol=0, atol=1e-6 * J.abs().max())
    t = lie.TANGENT[group]
    i, j = g['edges'][:, 0], g['edges'][:, 1]

    def f(d):
        return lie.residual(lie.retract(d[:, :t], G.nodes[i], group),
                            lie.retract(d[:, t:], G.nodes[j], group),
                            G.meas, group)
    h, cols = 1e-6, []
    for k in range(2 * t):
        e = torch.zeros(i.shape[0], 2 * t, dtype=torch.float64)
        e[:, k] = h
        cols.append((f(e) - f(-e)) / (2 * h))
    assert torch.allclose(J, torch.stack(cols, -1), rtol=0,
                          atol=1e-8 * J.abs().max())


@pytest.mark.parametrize('group', ['SE3', 'Sim3'])
def test_solve_matches_the_port_cpu_path(group):
    """The reference in float64 and the port's SparseLM in float32 on the
    CPU (its kernels' plain versions): the same LM trajectory to float32's
    reach, the same final chi2."""
    import harness
    g = _graph(group)
    traffic = {'group': group, 'radius': 1e4, 'phases': SCHEDULE}
    hist, _, X = harness.ProgramSolver(g, traffic, 'cpu')()
    G = lm.Graph(g['nodes'], g['edges'], g['meas'], group)
    _, h_ref, _ = lm.solve(G, 1e4, SCHEDULE)
    h, h_ref = judge.flat(hist), judge.flat(h_ref)
    assert len(h) == len(h_ref)
    assert max(abs(a - b) / b for a, b in zip(h, h_ref)) < 1e-3
    assert abs(lm.chi2(G, judge.poses8(X)) / h_ref[-1] - 1) < 1e-4


def _numbers(g, group, hist, X):
    G, h_ref, _ = judge.reference(
        g, {'group': group, 'radius': 1e4, 'phases': SCHEDULE}, 'cpu')
    rec = SimpleNamespace(hist=hist, its=[[[1]]], wall_s=1.0)
    counters = {'LAUNCHES': 0}
    got, _, _ = judge.numbers(G, h_ref, {}, {'group': group}, [rec],
                              [(0, X)], counters, counters, 'cpu')
    return got


CELL_LIMITS = sorted(Path(judge.__file__).parent.glob('limits/*.json'))


def test_judge_separates_sound_from_bf16_and_one_step_short():
    """The reference's own solution passes every number by orders of
    magnitude; the same poses rounded to bf16 fail, and the solve stopped
    one LM step short misses one step, which every cell's limits
    refuse."""
    group = 'SE3'
    g = _graph(group)
    G = lm.Graph(g['nodes'], g['edges'], g['meas'], group)
    X, hist, _ = lm.solve(G, 1e4, SCHEDULE)
    sound = _numbers(g, group, hist, X)
    assert sound['chi2_gap'] < 1e-9 and sound['pose_chi2_gap'] < 1e-9
    assert sound['history_gap'] < 1e-9 and sound['steps_misses'] == 0
    bf16 = _numbers(g, group, hist, X.to(torch.bfloat16).to(torch.float64))
    assert bf16['pose_chi2_gap'] > 1e-2
    short = SCHEDULE[0] | {'steps': SCHEDULE[0]['steps'] - 1}
    X4, hist4, _ = lm.solve(G, 1e4, [short])
    assert len(hist4[0]) == len(hist[0]) - 1
    shorted = _numbers(g, group, hist4, X4)
    assert shorted['steps_misses'] == 1
    assert shorted['chi2_gap'] > 1e-4 and shorted['pose_chi2_gap'] > 1e-4
    for path in CELL_LIMITS:
        limits = json.loads(path.read_text())['limits']
        assert shorted['steps_misses'] > limits['steps_misses'], path.name


@pytest.mark.parametrize('hist,ref,misses', [
    ([[1, 2, 3], [4]], [[1, 2, 3], [4]], 0),
    ([[1, 2], [4]], [[1, 2, 3], [4]], 1),
    ([[1, 2, 3], [4, 5]], [[1, 2, 3], [4]], 1),
    ([[1, 2, 3]], [[1, 2, 3], [4, 5]], 2)])
def test_step_misses_counts_every_missing_or_extra_step(hist, ref, misses):
    assert judge.step_misses(hist, ref) == misses


@pytest.mark.parametrize('group', ['SE3', 'Sim3'])
def test_exp_log_round_trip(group):
    """log(exp(x)) = x and exp(log(X)) = X in float64, rotations up to
    2.5 rad, log-scales up to ~1."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2000, lie.TANGENT[group], generator=gen,
                    dtype=torch.float64)
    x[:, 3:6] *= torch.clamp(2.5 / x[:, 3:6].norm(dim=-1, keepdim=True),
                             max=1.0)
    x[:10] *= 1e-9                      # the small-angle branches
    assert torch.allclose(lie.log(lie.exp(x, group), group), x, rtol=0,
                          atol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -3.14159265], dtype=torch.float32)
    r = lie.round_tf32(x)
    assert r.tolist()[:3] == [1.0, 1.0, 1.0 + 2 ** -9]
    assert abs(r[3].item() + 3.14159265) <= 2 ** -10 * 2
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
