"""Nothing a run loads is JAX or the JAX package (top-level module names
compared whole: the port's name begins with the JAX package's), and the
reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

from conftest import BENCH, REPO

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'pypose_tpu'}


def _modules_after(code):
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, cwd=REPO, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


PRELUDE = (f'import sys, json; sys.path[:0] = [{str(BENCH)!r}, '
           f'{str(REPO)!r}]\n')
TOPS = 'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))'


def test_a_run_loads_no_jax(tmp_path):
    """Every module of a run (the harness, the program, a CPU dry run of
    the tiny cell, traced) and none is JAX's."""
    code = PRELUDE + f'''
import time
sys.path.insert(0, {str(BENCH / 'tests')!r})
from pathlib import Path
import conftest, harness, run
root = conftest.make_root(Path({str(tmp_path)!r}))
harness.run_cell(root, 'tiny.se3', 3, 0.2, 1, 'cpu', time.perf_counter(),
                 bench=root / 'portbench', log=lambda *a: None)
assert run.forbidden_modules() == []
''' + TOPS
    tops = _modules_after(code)
    assert 'pypose_tpu_torch' in tops and not tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = PRELUDE + '''
import torch, problems
from reference import lie, lm
g = problems.sphere(40, 1)
G = lm.Graph(g['nodes'], g['edges'], g['meas'], 'SE3')
lm.solve(G, 1e4, [dict(cg_iter=20, cg_tol=1e-6, steps=2, decreasing=1e-6,
                       patience=2)])
''' + TOPS
    tops = _modules_after(code)
    assert not tops & (FORBIDDEN | {'pypose_tpu_torch'})


def test_reference_and_inputs_import_only_torch_numpy_and_the_stdlib():
    allowed = {'torch', 'numpy', 'gzip', 'reference'}
    for path in [*(BENCH / 'reference').glob('*.py'), BENCH / 'problems.py']:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module]
            else:
                continue
            for n in names:
                assert n.split('.')[0] in allowed, (path.name, n)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, 'pypose_tpu_torch_x', sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
    assert run.forbidden_modules() == ['jax']
