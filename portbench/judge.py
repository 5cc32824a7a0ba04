"""Whether a run's solves are correct: the plain reference solves the same
graph from the same start in float64 (``reference/lm.py``) after the
window has closed, and each number below is held to the cell's limit
(``limits/<workload>.json``), each relative to the reference's final
chi2 ``c*``:

- ``chi2_gap``: the widest |c_s - c*| / c* over every solve s of the
  window, c_s the final chi2 the program reported (formation, the PCG
  steps and the LM control together);
- ``pose_chi2_gap``: the widest |chi2(X_s) - c*| / c* over the judged
  solves, chi2(X_s) the reference's float64 chi2 of the poses X_s the
  solve returned (its answer, recomputed from the inputs);
- ``history_gap``: the widest |h_s[k] - h*[k]| / h*[k] over the judged
  solves and the steps both histories have (the LM trajectory);
- ``steps_misses``: over every solve of the window and every phase of
  its schedule, the LM steps the program ran less the reference's, in
  absolute value: a solve that stops short, or runs on, by one step
  reads 1; limit 0;
- ``route_misses``: launches of the kernel the configuration names, less
  one a CG solve, plus launches of every other stencil CG kernel (on the
  CPU, where the plain versions run: every launch); limit 0.

A solve whose reported chi2 breaks ``chi2_gap``'s limit, or whose steps
differ from the reference's, counts as failed.
"""

import time

import torch

from reference import lie, lm

TANGENT = lie.TANGENT


def poses8(X):
    """[N, 8] float64 poses from the port's storage ([N, 7] for SE3)."""
    X = X.to(torch.float64)
    if X.shape[-1] == 7:
        X = torch.cat([X, torch.ones_like(X[:, :1])], -1)
    return X


def flat(hist):
    return [h for phase in hist for h in phase]


def reference(graph, traffic, device):
    """(the reference's graph, its chi2 history of each phase, its CG
    iterations of each step of each phase)."""
    G = lm.Graph(graph['nodes'].to(device), graph['edges'],
                 graph['meas'].to(device), traffic['group'])
    _, h_ref, its_ref = lm.solve(G, traffic['radius'], traffic['phases'])
    return G, h_ref, its_ref


def step_misses(hist, h_ref):
    """|steps the program ran - the reference's|, summed over the
    phases."""
    return sum(abs(len(a) - len(b)) for a, b in zip(hist, h_ref)) + \
        sum(len(p) for p in hist[len(h_ref):] + h_ref[len(hist):])


def numbers(G, h_ref, config, traffic, solves, kept, before, after,
            device):
    """Every number the module docstring names, and each solve's
    reported-chi2 gap and step misses."""
    flat_ref = flat(h_ref)
    c_ref = flat_ref[-1]

    def rel(c):
        return abs(c - c_ref) / c_ref

    finals = [rel(flat(s.hist)[-1]) for s in solves]
    misses = [step_misses(s.hist, h_ref) for s in solves]
    out = {'chi2_gap': max(finals)}
    out['pose_chi2_gap'] = max(rel(lm.chi2(G, poses8(X))) for _, X in kept)
    out['history_gap'] = max(
        max(abs(a - b) / b for a, b in zip(flat(solves[k].hist), flat_ref))
        for k, _ in kept)
    out['steps_misses'] = sum(misses)
    cg_solves = sum(len(s) for r in solves for p in r.its for s in p)
    expect = config['pcg_counter'][traffic['group']] \
        if torch.device(device).type == 'cuda' else None
    out['route_misses'] = sum(
        abs(after[c] - before[c] - (cg_solves if c == expect else 0))
        for c in after)
    return out, finals, misses


def judge(graph, traffic, config, solves, kept, before, after, limits,
          device, log):
    """(checks {name: {'value', 'limit'}}, failed solves, the reference's
    CG iterations of each step of each phase)."""
    t0 = time.perf_counter()
    G, h_ref, its_ref = reference(graph, traffic, device)
    got, finals, misses = numbers(G, h_ref, config, traffic, solves, kept,
                                  before, after, device)
    lim = limits['limits']
    checks = {name: {'value': got[name], 'limit': lim[name]} for name in lim}
    failed = sum(f > lim['chi2_gap'] or m > lim['steps_misses']
                 for f, m in zip(finals, misses))
    log(f'judge: reference chi2 history {h_ref} in '
        f'{time.perf_counter() - t0:.3f} s; judged solves '
        f'{[k for k, _ in kept]} of {len(solves)}; first solve\'s history '
        f'{solves[0].hist}')
    return checks, failed, its_ref
