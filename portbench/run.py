"""Run one cell of the benchmark of pypose_tpu_torch once, on the card:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints progress and, as its last lines, each
number the correctness check compared beside its limit on standard error,
and the result as one JSON object on the last line of standard output.
Exits non-zero with no result where no CUDA device is present, where the
program under test is not in this checkout, or where JAX or the JAX
package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache the program or torch could write, at fixed paths inside the
# checkout
CACHE = ROOT / '.portbench_cache'
for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                 ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('CUDA_CACHE_PATH', 'nv')):
    os.environ[var] = str(CACHE / sub)

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pypose_tpu')


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print('no CUDA device: this benchmark measures the card only',
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import pypose_tpu_torch
    except ImportError as e:
        print(f'the program under test is not in {ROOT}: {e}',
              file=sys.stderr)
        return 2
    if ROOT not in Path(pypose_tpu_torch.__file__).resolve().parents:
        print(f'pypose_tpu_torch loads from {pypose_tpu_torch.__file__}, '
              f'not from this checkout {ROOT}', file=sys.stderr)
        return 2
    import harness
    result = harness.run_cell(ROOT, args.workload, args.seed % 2 ** 63,
                              args.seconds, args.trace, 'cuda', T0)
    bad = forbidden_modules()
    if bad:
        print(f'loaded modules of {bad}: nothing the benchmark runs may '
              'load JAX or the JAX package', file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
