"""The judge against the control and against planted faults, on the tiny
cell through the whole run on the CPU's dry path (the harness's look for
a card skipped), and the control at the cells' own sizes on the card.

Faults a pose-graph cell can have (``faults.py``): a step that returns
its state unchanged (every step, or the last one); a solve one LM step
short; half of the batch (of the edges) left out; an answer altered where
it is produced.  There is no exchange between chips to leave out:
every cell runs on one.
"""

import json
import time

import pytest

import faults
import harness
from conftest import TINY_TRAFFIC


def _run(root, solver='program'):
    return harness.run_cell(root, 'tiny.se3', 5, 0.5, 0, 'cpu',
                            time.perf_counter(), solver=solver,
                            bench=root / 'portbench', log=lambda *a: None)


def _wrong(result):
    return not result['correct']


def test_sound_run_is_correct(tiny_root):
    r = _run(tiny_root)
    assert r['correct'], r['checks']
    assert r['attempted'] >= 1 and r['failed'] == 0
    assert list(r)[-1] == 'checks'


def test_control_is_not_correct(tiny_root):
    """The reference in TF32 in the program's place."""
    r = _run(tiny_root, 'control')
    assert _wrong(r), r['checks']


@pytest.mark.parametrize('fault', sorted(faults.FAULTS))
def test_planted_fault_is_not_correct(tiny_root, fault):
    with faults.FAULTS[fault](len(TINY_TRAFFIC['phases'])):
        r = _run(tiny_root)
    assert _wrong(r), r['checks']


def test_fault_plants_restore_the_program():
    from pypose_tpu_torch.optim import sparse
    before = (sparse.SparseLM.optimize, sparse.SparseLM._core,
              sparse.pgo_factor)
    for plant in faults.FAULTS.values():
        with plant(2):
            pass
    assert before == (sparse.SparseLM.optimize, sparse.SparseLM._core,
                      sparse.pgo_factor)


CARD_FAULTS = {'sphere2500.se3': ['skip_final_step'],
               'sphere100k.se3': ['skip_final_step', 'unchanged_final_step'],
               'sphere2500.sim3': ['skip_final_step',
                                   'unchanged_final_step']}


@pytest.mark.cuda
@pytest.mark.parametrize('workload,kind', [
    (w, k) for w, ks in CARD_FAULTS.items() for k in ['control'] + ks])
def test_control_and_faults_on_the_card_at_the_cells_size(cuda_device,
                                                          workload, kind):
    """The control and the planted faults at the cell's own size and
    limits, on three seeds, through the run's own path
    (``readings.py``): every one reads ``correct`` false."""
    import readings
    from conftest import REPO
    out = REPO / 'chiprun_out' / f'test_readings_{workload}_{kind}.jsonl'
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    args = ['--workload', workload, '--control-seeds', '101', '202', '303',
            '--seconds', '0.1', '--out', str(out.relative_to(REPO))]
    if kind != 'control':
        args += ['--faults', kind]
    assert readings.main(args) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    mine = [x for x in lines if x['kind'] == kind]
    assert len(mine) == 3 and not any(x['correct'] for x in mine), mine
