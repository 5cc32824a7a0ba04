"""The harness finds a configuration, a traffic mix and a metric by name:
dropped into a temporary copy as new files, with no existing file edited,
they run on the CPU's dry path.  On a machine without a card the command
exits non-zero and prints no result."""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

from conftest import BENCH, make_root

NEW_METRIC = '''"""Solves in the window (a test metric)."""


def read(run):
    return float(len(run.solves))
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / 'portbench').rglob('*') if p.is_file()}


def test_new_files_are_found_and_run(tmp_path):
    extra = [{'name': 'test.solves', 'unit': 'solves', 'better': 'higher',
              'source': 'program_counter', 'layer': 'LM control',
              'moves': 'solves_per_s', 'workloads': ['tiny.se3']}]
    base = tmp_path / 'base'
    make_root(base)
    before = _digests(base)
    root = make_root(tmp_path / 'new', extra)   # the same files, and more
    (root / 'portbench/metrics/test.solves.py').write_text(NEW_METRIC)
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {
        Path('portbench/metrics/test.solves.py')}
    code = (f'import sys, json, time; sys.path[:0] = ['
            f'{str(root / "portbench")!r}, {str(BENCH.parent)!r}]\n'
            'import harness\nfrom pathlib import Path\n'
            f'root = Path({str(root)!r})\n'
            'out = [harness.run_cell(root, "tiny.se3", 4, 0.2, t, "cpu", '
            'time.perf_counter(), log=lambda *a: None) for t in (0, 1)]\n'
            'print(json.dumps(out))')
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, check=True)
    e2e, traced = json.loads(res.stdout.strip().splitlines()[-1])
    assert e2e['correct'] and traced['correct']
    assert set(e2e['metrics']) == {'solves_per_s', 'setup_s'}
    assert traced['metrics']['test.solves']['value'] >= 1
    assert {'lm.steps_per_solve', 'host.solve_ms_p90'} <= set(
        traced['metrics'])


def test_without_a_card_the_command_fails_with_no_result(tmp_path):
    """Run from a directory holding only BENCHMARK.json and the
    benchmark's folder; CPU-only torch here, so it stops at the card."""
    root = make_root(tmp_path)
    res = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', 'tiny.se3',
         '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=root,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ''
