r"""Probes of what bounds the whole-solve cluster kernel on an NVIDIA GPU.

1. ``cluster_exchange.cu``: ns per cluster-wide exchange of one float
   between 16 CTAs, by cluster barrier (release/acquire, as the kernel
   uses; relaxed, as a floor) and by ``st.async`` on mbarriers.
2. The per-phase cost of ``csrc/stencil_cg.cu``'s loop: an instrumented
   copy of the source (written to ``pypose_tpu_torch/_build/``, never
   used by the package) in which thread 0 of CTA 0 adds ``clock64()``
   deltas per phase, solved at the sphere2500 shape (operands in shared
   memory) and at N=20,000 (operands in L2), 150 iterations, ten solves.
   Thread 0's view: a phase that ends in a barrier includes the wait for
   the slowest thread of the cluster.

Run from the repository root on a machine with the GPU and nvcc:

    python3 -m pypose_tpu_torch.probes.cluster_probes
"""

import ctypes
import subprocess
import sys

import torch

from pypose_tpu_torch.ops import _build
from pypose_tpu_torch.ops import stencil_cg as scg
from pypose_tpu_torch.testing import random_stencil_system

HERE = _build.PACKAGE / 'probes'

# (name, anchor line, whether the mark goes after or before it) in loop
# order; each mark adds the cycles since the previous one to its slot
MARKS = [
    ('loop top', '  while (it < maxiter && rr > tol2) {\n', 'after'),
    ('A wait for pushes', '      phase_g ^= 1;\n    }\n', 'after'),
    ('A matvec', '      pap[0] += p[i * NL + nl] * y;\n    });\n', 'after'),
    ('A reduce',
     '    cluster_sum<1>(pap, sm, kSlotA, kMbarA, phase_a, rank);\n', 'after'),
    ('B x, r + sync',
     '      nxt[1] += rv * rv;\n    });\n    __syncthreads();\n', 'after'),
    ('B z = Minv r', '      nxt[0] += r[i * NL + nl] * zi;\n    });\n',
     'after'),
    ('B reduce',
     '    cluster_sum<2>(nxt, sm, kSlotB, kMbarB, phase_b, rank);\n', 'after'),
    ('C p + sync', '    });\n    __syncthreads();\n    if (more) {\n',
     'before-last'),
    ('C push p, q', '    gamma = nxt[0];\n    rr = nxt[1];\n', 'before'),
]


def instrumented_source():
    """csrc/stencil_cg.cu with a clock64() mark at each of MARKS."""
    s = (_build.CSRC / 'stencil_cg.cu').read_text()
    s = s.replace('#include "stencil_common.cuh"',
                  f'#include "{_build.CSRC}/stencil_common.cuh"\n'
                  f'__device__ long long g_phase[{len(MARKS)}];')
    s = s.replace('  while (it < maxiter && rr > tol2) {\n',
                  '  long long t_mark = clock64();\n'
                  '  while (it < maxiter && rr > tol2) {\n', 1)
    start = s.index('  while (it < maxiter && rr > tol2) {\n')
    for k, (_, line, where) in enumerate(MARKS):
        at = s.find(line, start)
        if at < 0:
            raise RuntimeError(f'mark {k}: source line not found: {line!r}')
        if where == 'after':
            at += len(line)
        elif where == 'before-last':      # before the anchor's last line
            at += len(line) - len(line.splitlines(True)[-1])
        s = s[:at] + _mark(k) + s[at:]
        start = at + len(_mark(k))
    s = s.replace(
        'const char* ppt_cuda_error_string',
        'int ppt_phase_read(long long* out) { return (int)cudaMemcpyFromSymbol'
        '(out, g_phase, sizeof(g_phase)); }\n'
        'int ppt_phase_reset() { long long z[sizeof(g_phase) / 8] = {0}; '
        'return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z)); }\n'
        'const char* ppt_cuda_error_string')
    return s


def _mark(k):
    return ('    if (threadIdx.x == 0 && rank == 0) { const long long t = '
            f'clock64(); g_phase[{k}] += t - t_mark; t_mark = t; }}\n')


def phase_times(lib, N, solves=10, maxiter=150):
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(N)
    offsets, ops = random_stencil_system(N, 157, N * 4 // 5, True, gen, dev)
    x = torch.empty_like(ops[0])
    scratch = torch.empty((2, 6, N), device=dev)
    it = torch.empty(1, dtype=torch.int32, device=dev)

    def solve():
        rc = lib.ppt_stencil_pcg(
            6, *(o.data_ptr() for o in ops), scg._c_offsets(offsets, N),
            len(offsets), N, maxiter, 0.0, x.data_ptr(), scratch.data_ptr(),
            it.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(lib.ppt_cuda_error_string(rc).decode())
    solve()
    torch.cuda.synchronize()
    lib.ppt_phase_reset()
    for _ in range(solves):
        solve()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * len(MARKS))()
    lib.ppt_phase_read(ctypes.cast(buf, ctypes.c_void_p))
    n = solves * int(it[0])
    where = 'shared memory' if scg.stencil_cg_smem_fits(N, 6, 2) else 'L2'
    print(f'[phases] N={N} (operands in {where}), {int(it[0])} iterations: '
          f'{sum(buf) / n:.1f} cycles of thread 0 of CTA 0 per iteration',
          flush=True)
    for k, (name, *_) in enumerate(MARKS):
        print(f'[phases]   {name:16s} {buf[k] / n:9.1f}', flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit('cluster_probes: needs an NVIDIA GPU')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit,clocks.max.sm',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    nvcc = _build.nvcc_path()
    _build.BUILD.mkdir(exist_ok=True)
    exe = _build.BUILD / 'cluster_exchange'
    subprocess.run([nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                    '-std=c++17', '-O3', '-o', str(exe),
                    str(HERE / 'cluster_exchange.cu')], check=True)
    subprocess.run([str(exe)], check=True)
    src = _build.BUILD / 'stencil_cg_phases.cu'
    src.write_text(instrumented_source())
    lib_path = _build.BUILD / 'libstencil_cg_phases.so'
    subprocess.run([nvcc, *_build.NVCC_FLAGS, '-o', str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    I, P, D = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
    lib.ppt_stencil_pcg.argtypes = [I] + [P] * 5 + [I] * 3 + [D] + [P] * 4
    lib.ppt_phase_read.argtypes = [P]
    lib.ppt_cuda_error_string.argtypes = [I]
    lib.ppt_cuda_error_string.restype = ctypes.c_char_p
    for N in (2500, 20_000):
        phase_times(lib, N)
    return 0


if __name__ == '__main__':
    sys.exit(main())
