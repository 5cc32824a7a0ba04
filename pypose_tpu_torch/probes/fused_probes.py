r"""Probes of what bounds the fused Chronopoulos-Gear kernel on an NVIDIA GPU.

The per-phase cost of ``csrc/stencil_cg_fused.cu``'s loop: an instrumented
copy of the source (written to ``pypose_tpu_torch/_build/``, never used by
the package) in which thread 0 of every CTA adds ``clock64()`` deltas per
phase, solved at N=53 (6 CTAs of one warp: the latency floor), at the
100k-pose shape (N=100,000, offsets (1, 993), 132 CTAs, state and Minv in
shared memory) with float32 and with bf16 operands, and at N=200,000
(state in global memory), 250 iterations, five solves each.  Thread 0's
view: a phase that ends in an exchange includes the wait for the slowest
CTA.  Reported per iteration: the mean over CTAs and the largest CTA's.

Run from the repository root on a machine with the GPU and nvcc:

    python3 -m pypose_tpu_torch.probes.fused_probes
"""

import ctypes
import subprocess
import sys

import torch

from pypose_tpu_torch.ops import _build
from pypose_tpu_torch.ops import stencil_cg as scg
from pypose_tpu_torch.testing import random_stencil_system

MAX_CTAS = 1024

# (name, anchor line) in loop order; each mark, placed after its anchor,
# adds the cycles since the previous one to its slot
MARKS = [
    ('pass 1', '    ppt::block_sum2(part[0], part[1], red);'
               '  // after every u write\n'),
    ('A u', '      for (int i = 0; i < T; ++i) w[i * vs + nl] = y[i];\n    }\n'),
    ('exchange 1', '    gather<2>(mail_1, G, e, dots, tot);\n'),
    ('pass 2', '    ppt::block_sum2(wu, unused, red);\n'),
    ('p, s update', '        s[j] = w[j] + beta * s[j];\n      }\n    }\n'),
    ('exchange 2', '    gather<1>(mail_2, G, e, delta, tot);\n'),
]
LOOP = '  for (bool init = true;; init = false) {\n'


def instrumented_source():
    """csrc/stencil_cg_fused.cu with a clock64() mark at each of MARKS."""
    s = (_build.CSRC / 'stencil_cg_fused.cu').read_text()
    s = s.replace('#include "stencil_common.cuh"',
                  f'#include "{_build.CSRC}/stencil_common.cuh"\n'
                  f'__device__ long long g_phase[{MAX_CTAS}][{len(MARKS)}];')
    if s.count(LOOP) != 1:
        raise RuntimeError('loop head not found')
    s = s.replace(LOOP, '  long long t_mark = clock64();\n' + LOOP)
    start = s.index(LOOP)
    for k, (_, line) in enumerate(MARKS):
        at = s.find(line, start)
        if at < 0:
            raise RuntimeError(f'mark {k}: source line not found: {line!r}')
        at += len(line)
        s = s[:at] + _mark(k) + s[at:]
        start = at + len(_mark(k))
    s = s.replace(
        'const char* ppt_cuda_error_string',
        'int ppt_phase_read(long long* out) { return (int)cudaMemcpyFromSymbol'
        '(out, g_phase, sizeof(g_phase)); }\n'
        'int ppt_phase_reset() { static long long z[sizeof(g_phase) / 8]; '
        'return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z)); }\n'
        'const char* ppt_cuda_error_string')
    return s


def _mark(k):
    return ('    if (threadIdx.x == 0) { const long long t = clock64(); '
            f'g_phase[blockIdx.x][{k}] += t - t_mark; t_mark = t; }}\n')


def phase_times(lib, N, operand_dtype, solves=5, maxiter=250):
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(N)
    loop, n_loops = (9, 15) if N < 100 else (993, N * 4 // 5)
    offsets, (b, *ops) = random_stencil_system(N, loop, n_loops, N >= 100,
                                               gen, dev)
    ops = scg.round_operands(*ops, operand_dtype)
    scg._kernel_lib = lambda name: lib   # the instrumented library

    def solve():
        return scg.stencil_cg_fused(b, *ops, offsets, 6, maxiter, 0.0,
                                    operand_dtype=operand_dtype)
    solve()
    torch.cuda.synchronize()
    lib.ppt_phase_reset()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(solves):
        _, it = solve()
    end.record()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (MAX_CTAS * len(MARKS)))()
    lib.ppt_phase_read(ctypes.cast(buf, ctypes.c_void_p))
    plan = scg.fused_plan(N, 6, dev)
    G, n = plan['ctas'], solves * int(it)
    per = [[buf[c * len(MARKS) + k] / n for k in range(len(MARKS))]
           for c in range(G)]
    total = [sum(p) for p in per]
    kind = 'bf16' if operand_dtype is not None else 'float32'
    print(f'[phases] N={N} {kind}, plan {plan}, {int(it)} iterations: '
          f'{start.elapsed_time(end) / n * 1e3:.2f} us per iteration (CUDA '
          f'events over {solves} solves); thread 0 cycles per iteration: '
          f'mean over CTAs {sum(total) / G:.0f}, largest {max(total):.0f}',
          flush=True)
    for k, (name, _) in enumerate(MARKS):
        col = [p[k] for p in per]
        print(f'[phases]   {name:12s} mean {sum(col) / G:9.1f}  largest '
              f'{max(col):9.1f}', flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit('fused_probes: needs an NVIDIA GPU')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit,clocks.max.sm',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.BUILD.mkdir(exist_ok=True)
    src = _build.BUILD / 'stencil_cg_fused_phases.cu'
    src.write_text(instrumented_source())
    lib_path = _build.BUILD / 'libstencil_cg_fused_phases.so'
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-o',
                    str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    for fname, argtypes in scg._SIGNATURES['stencil_cg_fused'].items():
        getattr(lib, fname).argtypes = argtypes
        getattr(lib, fname).restype = ctypes.c_int
    lib.ppt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ppt_cuda_error_string.restype = ctypes.c_char_p
    lib.ppt_phase_read.argtypes = [ctypes.c_void_p]
    for N, dtype in ((53, None), (100_000, None), (100_000, torch.bfloat16),
                     (200_000, None)):
        phase_times(lib, N, dtype)
    return 0


if __name__ == '__main__':
    sys.exit(main())
