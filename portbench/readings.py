"""The readings that the correctness limits are set from, on the card, by
the path that decides ``correct``: ``harness.run_cell`` with a short
window, once a seed for the program, the control (the reference in TF32
in the program's place) and each planted fault (``faults.py``), all in
one process.

    python3 portbench/readings.py --workload <name> --seeds 1 2 3 \
        [--control-seeds 4 5 6] [--faults skip_final_step ...] \
        [--seconds 2] [--out readings.jsonl]

The faults run on the ``--control-seeds``.  Prints one JSON line a run
(each number the judge compared, and ``correct``), and appends it to
``--out`` under the checkout.
"""

import argparse
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='*', default=[])
    ap.add_argument('--control-seeds', type=int, nargs='*', default=[])
    ap.add_argument('--faults', nargs='*', default=[])
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import faults
    import harness
    _, traffic, _, _, _ = harness.cell_spec(ROOT, args.workload)
    phases = len(traffic['phases'])
    runs = [(s, 'program') for s in args.seeds] + \
        [(s, k) for s in args.control_seeds
         for k in ['control'] + args.faults]
    for seed, kind in runs:
        plant = faults.FAULTS[kind](phases) if kind in faults.FAULTS \
            else nullcontext()
        with plant:
            r = harness.run_cell(
                ROOT, args.workload, seed, args.seconds, 0, 'cuda',
                time.perf_counter(),
                solver='control' if kind == 'control' else 'program')
        line = {'workload': args.workload, 'seed': seed, 'kind': kind,
                'correct': r['correct'], 'attempted': r['attempted'],
                'failed': r['failed'],
                'numbers': {k: c['value'] for k, c in r['checks'].items()}}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(ROOT / args.out, 'a') as f:
                f.write(json.dumps(line) + '\n')
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
