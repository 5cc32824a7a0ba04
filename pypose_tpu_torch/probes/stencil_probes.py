r"""The stencil PCG kernels' templates against an earlier build of their
sources, on the card.

Given ``--old DIR``, a directory holding an earlier ``stencil_cg.cu``,
``stencil_cg_tiled.cu``, ``stencil_cg_fused.cu`` and
``stencil_common.cuh`` of this C interface (e.g. ``git archive 488fdf5
pypose_tpu_torch/csrc | tar -x -C OUT``, then ``--old
OUT/pypose_tpu_torch/csrc``), builds them beside this tree's (one nvcc
each, all at once, the flags of ``ops/_build.py``) and prints both builds'
registers and spills of each template (``-Xptxas -v``).  Then it holds
this build's templates (t = 3, 4, 6, 7) bit for bit to the earlier
build's, x and the iteration count, or y: the whole solve at N = 40 and
at sphere2500's shape (150 iterations), the fused solver with float32 and
bf16 operands at N = 53 and at the 100k shape (250 iterations), and the
tiled matvec and block-Jacobi kernels alone at the 100k shape (one
launch).  Each full-shape pair is timed old, new, new, old (device time
a call, torch.profiler, the kernel alone; each side's two readings
averaged).  Needs an NVIDIA GPU:

    python3 -m pypose_tpu_torch.probes.stencil_probes --old DIR
"""

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from pypose_tpu_torch.ops import _build
from pypose_tpu_torch.ops import stencil_cg as scg

ROOT = Path(__file__).resolve().parents[2]
SOURCES = ('stencil_cg', 'stencil_cg_tiled', 'stencil_cg_fused')


def old_libs(directory):
    """The earlier sources in ``directory`` built into ``_build/old_csrc``
    and bound with the C functions both builds share; returns ({name:
    library}, {name: ptxas log})."""
    out = _build.BUILD / 'old_csrc'
    out.mkdir(parents=True, exist_ok=True)
    for src in Path(directory).glob('stencil_*'):
        shutil.copy(src, out / src.name)
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, '-o',
         str(out / f'lib{name}.so'), str(out / f'{name}.cu')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in SOURCES}
    libs, logs = {}, {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on the earlier {name}.cu:\n'
                               f'{logs[name]}')
        lib = ctypes.CDLL(str(out / f'lib{name}.so'))
        for fname, argtypes in scg._SIGNATURES[name].items():
            if fname.endswith('_any_t'):
                continue
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ppt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ppt_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, logs


def registers(log):
    """{template: (registers, spill stores)} of a ptxas report, each
    template named by its mangled template arguments."""
    out, entry, spill = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = re.sub(r'^.*?(stencil_pcg_cluster|fused_pcg|tiled_\w+?)'
                           r'(I.*?E)E.*$', r'\1<\2>', m.group(1))
            continue
        m = re.search(r'(\d+) bytes spill stores', line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r'Used (\d+) registers', line)
        if m and entry:
            out[entry] = (int(m.group(1)), spill)
    return out


class using:
    """Within the block, the wrappers of ops/stencil_cg.py launch the
    kernels of ``libs`` (None: this tree's)."""

    def __init__(self, libs):
        self.libs = libs

    def __enter__(self):
        self.saved = scg._kernel_lib
        if self.libs is not None:
            scg._kernel_lib = self.libs.__getitem__

    def __exit__(self, *exc):
        scg._kernel_lib = self.saved


def cases(t):
    """(tag, call, kernel name for the profiler, calls a reading or None
    for a small case) at block size t."""
    from chip_smoke import stencil_system
    out = []
    for tag, shape, maxiter in (('small', (40, 9, 15, False), 300),
                                ('sphere2500 shape', (2500, 157, 2000, True),
                                 150)):
        offsets, ops = stencil_system(*shape, t)
        out.append((f'whole solve, {tag}', lambda o=offsets, a=ops, m=maxiter:
                    scg.stencil_cg_transposed(*a, o, t, m, 0.0 if m == 150
                                              else 1e-7),
                    'stencil_pcg', None if tag == 'small' else 20))
    for tag, shape, maxiter in (('small', (53, 9, 15, False), 300),
                                ('100k shape', (100_000, 993, 80_000, True),
                                 250)):
        offsets, (b_T, *ops) = stencil_system(*shape, t)
        for dtype in (None, torch.bfloat16):
            stored = scg.round_operands(*ops, dtype)
            out.append((f'fused {"bf16" if dtype else "f32"}, {tag}',
                        lambda o=offsets, b=b_T, s=stored, d=dtype, m=maxiter:
                        scg.stencil_cg_fused(b, *s, o, t, m,
                                             0.0 if m == 250 else 1e-7,
                                             operand_dtype=d),
                        'fused_pcg', None if tag == 'small' else 10))
    gen = torch.Generator(device=b_T.device).manual_seed(7)
    v = torch.randn(b_T.shape, generator=gen, device=b_T.device)
    out += [('tiled mv, 100k shape',
             lambda: (scg._tiled_mv_launch(ops[0], ops[2], v, offsets, t),
                      None), 'tiled_mv', 50),
            ('tiled pc, 100k shape',
             lambda: (scg._tiled_pc_launch(ops[1], v, t), None),
             'tiled_pc', 50)]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--old', type=Path, required=True,
                    help='a directory of earlier stencil_cg*.cu sources')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('stencil_probes needs an NVIDIA GPU')
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms
    _build.build_all(SOURCES)
    old, old_logs = old_libs(args.old)
    for name in SOURCES:
        new = registers((_build.BUILD / f'lib{name}.log').read_text())
        for tmpl, (regs, spill) in registers(old_logs[name]).items():
            now = new.get(tmpl)
            print(f'[ptxas] {name} {tmpl}: earlier {regs} registers, '
                  f'{spill} B spilled; this build '
                  f'{"missing" if now is None else f"{now[0]} registers, {now[1]} B spilled"}',
                  flush=True)
    differ = []
    for t in sorted(scg.TEMPLATE_T):
        for tag, call, kname, calls in cases(t):
            with using(old):
                a = call()
            b = call()
            same = bool(torch.equal(a[0], b[0])) and (
                a[1] is None or int(a[1]) == int(b[1]))
            line = f'[templates] t={t} {tag}: bit-equal to the earlier ' \
                f'build {same}'
            if calls is not None:
                ms = {'old': [], 'new': []}
                for side in ('old', 'new', 'new', 'old'):
                    with using(old if side == 'old' else None):
                        ms[side].append(device_ms(call, calls=calls,
                                                  match=kname))
                o, n = statistics.mean(ms['old']), statistics.mean(ms['new'])
                line += f'; device ms a call earlier {o:.5f}, this build ' \
                    f'{n:.5f} (readings {ms}): {n / o:.3f}'
            print(line, flush=True)
            if not same:
                differ.append((t, tag))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '-i', '0'],
                         capture_output=True, text=True).stdout.strip()
    print(f'[templates] {smi}; differ: {differ or "none"}', flush=True)
    if differ:
        raise SystemExit(1)


if __name__ == '__main__':
    main()
