"""The program's own spans and host-read counter (``optim/sparse.py``) under
the harness, on the tiny cell on the CPU: a run still reads ``correct``
(``route_misses`` counts the stencil launches only) while
``sparse.HOST_READS`` moves, and the benchmark's ``portbench.pcg`` span,
put around the module global ``stencil_cg`` at call time, still wraps
every CG solve, each inside the program's ``sparselm.pcg`` range."""

import time

import harness
import problems
from conftest import TINY_TRAFFIC


def test_run_is_correct_while_the_host_read_counter_moves(tiny_root):
    from pypose_tpu_torch.optim import sparse
    reads = sparse.HOST_READS
    r = harness.run_cell(tiny_root, 'tiny.se3', 5, 0.5, 1, 'cpu',
                         time.perf_counter(), bench=tiny_root / 'portbench',
                         log=lambda *a: None)
    assert r['correct'], r['checks']
    assert r['checks']['route_misses']['value'] == 0
    assert sparse.HOST_READS > reads


def test_benchmark_pcg_span_wraps_every_solve_inside_the_programs(
        tiny_root):
    from torch.profiler import ProfilerActivity, profile
    config, traffic, _, _, _ = harness.cell_spec(
        tiny_root, 'tiny.se3', tiny_root / 'portbench')
    graph = problems.build(config, traffic, 5, tiny_root)
    solver = harness.ProgramSolver(graph, TINY_TRAFFIC, 'cpu')
    with solver.pcg_span(), profile(activities=[ProfilerActivity.CPU]) as p:
        _, its, _ = solver()
    ranges = {}
    for e in p.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    solves = sum(len(s) for phase in its for s in phase)
    bench, prog = ranges['portbench.pcg'], ranges['sparselm.pcg']
    assert len(bench) == len(prog) == solves
    for s, e in bench:
        assert any(s0 <= s and e <= e0 for s0, e0 in prog)
