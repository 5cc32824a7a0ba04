"""One run of one cell: the problem from the seed, the program's solver
built through its normal path, a warm-up solve, the closed-loop window,
the traced stretches, the judge, and the result line.

Every piece is found by name: the cell in ``BENCHMARK.json``, its
configuration in the file the entry names, its traffic mix in
``traffic/<traffic>.json``, its limits in ``limits/<workload>.json``, and
each metric in ``metrics/<metric>.py``, whose ``read(run)`` returns the
value or None.  ``run_cell`` takes the device: the command line gives it
'cuda' only; the tests drive it on the CPU ('cpu', the program's plain
kernel versions), which no measurement ever reads.
"""

import importlib.util
import json
import random
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path
from types import SimpleNamespace

import torch

import judge
import problems
import tracing

HERE = Path(__file__).resolve().parent

# the port's launch counters of its stencil CG kernels
# (pypose_tpu_torch/ops/stencil_cg.py)
COUNTERS = ('LAUNCHES', 'FUSED_LAUNCHES', 'TILED_MV_LAUNCHES',
            'TILED_PC_LAUNCHES')
# solves profiled in each traced stretch; a stretch is traced again when
# the profiler hands back a trace without device operations or without
# one span a solve, at most this many times
STRETCH_SOLVES = 1
TRACE_TRIES = 3


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(root, workload, bench=HERE):
    """(configuration, traffic mix, limits, the end-to-end and per-layer
    metric entries of this cell)."""
    spec = load_json(root / 'BENCHMARK.json')
    cells = {w['name']: w for w in spec['workloads']}
    if workload not in cells:
        raise SystemExit(f'unknown workload {workload!r}; BENCHMARK.json '
                         f'has {sorted(cells)}')
    cell = cells[workload]
    conf = {c['name']: c for c in spec['configs']}[cell['config']]
    config = load_json(root / conf['file'])
    traffic = load_json(bench / 'traffic' / f"{cell['traffic']}.json")
    if traffic['entry'] != 'SparseLM.optimize':
        raise ValueError(f"traffic entry {traffic['entry']!r}")
    limits = load_json(bench / 'limits' / f'{workload}.json')

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get('workloads', [workload])]
    return (config, traffic, limits, mine(spec['end_to_end']),
            mine(spec['per_layer']))


def reader(name, bench=HERE):
    """``read`` of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f'portbench_metric_{name}', bench / 'metrics' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def n_offsets(graph):
    """Distinct circular offsets (j - i) mod N of the graph's edges: the
    coupling channels of the one merged stencil the program solves."""
    e, N = graph['edges'], graph['nodes'].shape[0]
    return int(torch.unique((e[:, 1] - e[:, 0]) % N).numel())


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


class ProgramSolver:
    """The user's whole solve through the port: one ``pgo_factor`` per
    odometry run of ``split_chain_edges`` and one for the rest, node 0
    fixed, ``SparseLM`` with ``TrustRegion(radius)``; each solve resets
    the poses and the damping state and runs every phase of the traffic's
    schedule with ``SparseLM.optimize``."""

    def __init__(self, graph, traffic, device):
        from pypose_tpu_torch.lietensor.lietensor import (LieTensor, SE3_type,
                                                          Sim3_type)
        from pypose_tpu_torch.optim import sparse
        from pypose_tpu_torch.optim.strategy import TrustRegion
        ltype = {'SE3': SE3_type, 'Sim3': Sim3_type}[traffic['group']]
        nodes, meas = problems.storage(graph, traffic['group'])
        self.device = device
        self.nodes = LieTensor(nodes.to(device=device, dtype=torch.float32),
                               ltype=ltype)
        Z = LieTensor(meas.to(device=device, dtype=torch.float32),
                      ltype=ltype)
        edges = graph['edges'].to(device)
        runs, rest = sparse.split_chain_edges(edges)
        factors = []
        for rows in list(runs) + ([rest] if len(rest) else []):
            rows = torch.as_tensor(rows, device=device)
            factors.append(sparse.pgo_factor(edges[rows], Z[rows]))
        fixed = torch.zeros(nodes.shape[0], dtype=torch.bool, device=device)
        fixed[0] = True
        first = traffic['phases'][0]
        self.opt = sparse.SparseLM(
            {'poses': self.nodes}, factors,
            strategy=TrustRegion(radius=traffic['radius']),
            fixed={'poses': fixed}, cg_iter=first['cg_iter'],
            cg_tol=first['cg_tol'])
        self.phases = traffic['phases']

    def __call__(self):
        """(chi2 history of each phase, CG iterations of each step of each
        phase, the returned poses [N, 7 or 8])."""
        opt = self.opt
        opt.params = {'poses': self.nodes}
        opt.strategy_state = None
        hist, its = [], []
        for ph in self.phases:
            opt.cg_iter, opt.cg_tol = ph['cg_iter'], ph['cg_tol']
            opt.optimize(steps=ph['steps'], patience=ph['patience'],
                         decreasing=ph['decreasing'])
            hist.append(list(opt.history))
            its.append(opt.cg_iterations)
        _sync(self.device)
        return hist, its, opt.params['poses'].tensor()

    @staticmethod
    def counters():
        from pypose_tpu_torch.ops import stencil_cg
        return {c: getattr(stencil_cg, c) for c in COUNTERS}

    @contextmanager
    def pcg_span(self):
        """A ``record_function`` span around each of the program's calls
        into ops/stencil_cg.py, for the traced stretch only."""
        from pypose_tpu_torch.optim import sparse
        inner = sparse.stencil_cg

        def spanned(*args, **kwargs):
            with torch.profiler.record_function(tracing.PCG_SPAN):
                return inner(*args, **kwargs)
        sparse.stencil_cg = spanned
        try:
            yield
        finally:
            sparse.stencil_cg = inner


class ControlSolver:
    """The reference put in the program's place, computed in TF32: the
    control that the judge has to find wrong."""

    def __init__(self, graph, traffic, device):
        from reference import lie, lm
        self.lm = lm
        self.graph = lm.Graph(graph['nodes'].to(device), graph['edges'],
                              graph['meas'].to(device), traffic['group'],
                              lie.Arith('tf32'))
        self.traffic = traffic
        self.device = device

    def __call__(self):
        X, hist, its = self.lm.solve(self.graph, self.traffic['radius'],
                                     self.traffic['phases'])
        _sync(self.device)
        return hist, its, X

    @staticmethod
    def counters():
        return {c: 0 for c in COUNTERS}

    @contextmanager
    def pcg_span(self):
        yield


SOLVERS = {'program': ProgramSolver, 'control': ControlSolver}


def _window(solve, seconds, seed, sample):
    """The closed loop: one client, solve after solve until ``seconds``
    have passed; every solve's history and wall time, and the returned
    poses of ``sample`` solves drawn from the seed (reservoir)."""
    rng = random.Random(seed)
    solves, kept = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        w0 = time.perf_counter()
        hist, its, X = solve()
        w1 = time.perf_counter()
        n = len(solves)
        solves.append(SimpleNamespace(hist=hist, its=its, wall_s=w1 - w0))
        if n < sample:
            kept.append((n, X.clone()))
        else:
            k = rng.randrange(n + 1)
            if k < sample:
                kept[k] = (n, X.clone())
        if w1 >= deadline:
            return solves, kept, w1 - t0


def _stretch(solver, activities, span, tries):
    """One profiled stretch of STRETCH_SOLVES solves, traced again while
    the profiler hands back no device operation (or, with ``span``, fewer
    spans than solves); its readings, or None."""
    from torch.profiler import profile
    for _ in range(tries):
        solves = []
        with solver.pcg_span() if span else nullcontext():
            with profile(activities=activities) as prof:
                w0 = time.perf_counter()
                for _ in range(STRETCH_SOLVES):
                    solves.append(solver()[:2])
                wall = time.perf_counter() - w0
        red = tracing.reduce(prof, wall)
        n_solves = sum(len(s) for h, its in solves for p in its for s in p)
        if red is not None and (not span or red['spans'] >= n_solves):
            red['solves'] = [SimpleNamespace(hist=h, its=i)
                             for h, i in solves]
            return red
    return None


def _power_limit():
    """The card's power limit in W, read by nvidia-smi, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _host_loop_ms():
    """Milliseconds of a fixed pure-Python loop: how fast the host ran
    around the window (logged, no metric)."""
    t = time.perf_counter()
    acc = 0
    for i in range(300_000):
        acc += i & 7
    return 1e3 * (time.perf_counter() - t)


def log_err(*args):
    print(*args, file=sys.stderr, flush=True)


def run_cell(root, workload, seed, seconds, trace, device, t0,
             solver='program', log=log_err, bench=HERE):
    """One run; returns the result dict (the last line it prints).
    ``t0``: ``time.perf_counter()`` at process start; ``bench``: the
    benchmark's folder, whose traffic, limits and metrics it reads."""
    marks = [('imports', time.perf_counter())]
    root = Path(root)
    config, traffic, limits, e2e, per_layer = cell_spec(root, workload,
                                                        bench)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    graph = problems.build(config, traffic, seed, root)
    marks.append(('problem', time.perf_counter()))
    solve = SOLVERS[solver](graph, traffic, device)
    _sync(device)
    marks.append(('solver', time.perf_counter()))
    solve()                                   # warm-up: every shape once
    _sync(device)
    marks.append(('warm-up solve', time.perf_counter()))
    setup_s = time.perf_counter() - t0
    log(f'[{workload}] setup {setup_s:.3f} s: ' + ', '.join(
        f'{name} {b - a:.3f} s' for (name, b), (_, a)
        in zip(marks, [(None, t0)] + marks)))
    before = solve.counters()
    host_ms = _host_loop_ms()
    solves, kept, window_s = _window(solve, seconds, seed,
                                     traffic['judged_solves'])
    after = solve.counters()
    log(f'[{workload}] host speed: a fixed Python loop took {host_ms:.2f} '
        f'ms before the window and {_host_loop_ms():.2f} ms after it')
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == 'cuda' else 0
    walls = sorted(s.wall_s for s in solves)
    cg = [i for s in solves for p in s.its for step in p for i in step]
    log(f'[{workload}] {len(solves)} solves in {window_s:.3f} s; solve '
        f'wall time median {walls[len(walls) // 2] * 1e3:.3f} ms, p90 over '
        f'{len(walls)} samples; {len(cg) / len(solves):.2f} CG solves and '
        f'{sum(cg) / len(solves):.1f} CG iterations a solve')
    run = SimpleNamespace(
        solves=solves, window_s=window_s, setup_s=setup_s,
        N=graph['nodes'].shape[0], t=judge.TANGENT[traffic['group']],
        n_off=n_offsets(graph), stretch=None, busy=None, peaks=None,
        ref_its=None)
    device_info = {'platform': 'gpu' if device == 'cuda' else device,
                   'kind': torch.cuda.get_device_name(0)
                   if device == 'cuda' else 'cpu',
                   'count': 1, 'memory_peak_bytes': int(peak)}
    if trace:
        from torch.profiler import ProfilerActivity
        # on the CPU no trace holds a device operation: one try each
        cuda = [ProfilerActivity.CUDA] if device == 'cuda' else []
        tries = TRACE_TRIES if cuda else 1
        run.busy = _stretch(solve, cuda or [ProfilerActivity.CPU], False,
                            tries)
        run.stretch = _stretch(solve, [ProfilerActivity.CPU] + cuda, True,
                               tries)
        run.peaks = load_json(bench / 'roofline' / 'peaks.json').get(
            device_info['kind'])
        if device == 'cuda':
            device_info['power_limit_w'] = _power_limit()
        for name, st in (('busy', run.busy), ('stretch', run.stretch)):
            if st is not None:
                log(f'[{workload}] traced {name}: ' + ', '.join(
                    f'{k} {v}' for k, v in st.items() if k != 'solves'))
        if run.busy is not None:
            device_info['busy_s'] = run.busy['busy_s']
            device_info['window_s'] = run.busy['wall_s']
    del solve
    if device == 'cuda':
        torch.cuda.empty_cache()
    checks, failed, run.ref_its = judge.judge(
        graph, traffic, config, solves, kept, before, after, limits, device,
        log)
    metrics = {}
    for m in (per_layer if trace else e2e):
        value = reader(m['name'], bench)(run)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    result = {'correct': all(c['value'] <= c['limit']
                             for c in checks.values()) and failed == 0,
              'attempted': len(solves), 'failed': failed,
              'metrics': metrics, 'device': device_info}
    if trace and run.stretch is not None:
        result['breakdown'] = {
            'device_ops': [list(x) for x in run.stretch['device_top']],
            'idle_gaps': [list(x) for x in run.stretch['idle_top']]}
    result['checks'] = checks
    return result
