r"""The stencil PCG kernels against an earlier build of their sources, on
the card.

Given ``--old DIR``, a directory holding an earlier ``stencil_cg.cu``,
``stencil_cg_tiled.cu``, ``stencil_cg_fused.cu`` and the headers they
include (e.g. ``git archive eefa59b pypose_tpu_torch/csrc | tar -x -C
OUT``, then ``--old OUT/pypose_tpu_torch/csrc``), builds them beside this
tree's (one nvcc each, all at once, the flags of ``ops/_build.py``) and
prints both builds' registers and spills of each kernel (``-Xptxas -v``).
Then it holds this build bit for bit to the earlier build's, x and the
iteration count, or y:

- at the templates' t (3, 4, 6, 7): the whole solve at N = 40 and at
  sphere2500's shape (150 iterations), the fused solver with float32 and
  bf16 operands at N = 53 and at the 100k shape (250 iterations), each
  full-shape pair timed old, new, new, old (device time a call,
  torch.profiler, the kernel alone; each side's two readings averaged);
- the tiled matvec and block-Jacobi kernels alone, one launch, at N = 53
  and at the 100k shape (offsets (1, 993)), at the templates' t and at
  runtime t = 1, 2, 5, 9, 16, and this build's ring matvec forced at the
  same t against the earlier build's matvec: at 100k each timed old, new,
  new, old, warm (the operands in L2 across launches) and with the L2
  flushed before each launch (a 128 MB buffer zeroed; only the kernel
  counted), beside the bound (``chip_smoke.bound``: each operand and
  vector byte once, at 3.35 TB/s), the plain version's time and, for the
  apply, one ``torch.einsum``'s (CUDA events, median of 7).

``--tiled-only`` takes the tiled kernels alone; ``--bulk-rate`` first
times ``probes/bulk_rate.cu``, the rate at which bulk copies fill shared
memory (what caps the ring).  Needs an NVIDIA GPU:

    python3 -m pypose_tpu_torch.probes.stencil_probes --old DIR [--tiled-only] [--bulk-rate]
"""

import argparse
import ctypes
import functools
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
    for src in (*Path(directory).glob('stencil_*'),
                *Path(directory).glob('*.cuh')):
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
            if not hasattr(lib, fname):   # newer than the earlier build
                continue
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ppt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ppt_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, logs


def registers(log):
    """{kernel: (registers, spill stores)} of a ptxas report, each
    template named by its mangled template arguments (``ILi0E``: the
    runtime-t instantiation)."""
    out, entry, spill = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r'(stencil_pcg_cluster|fused_pcg|'
                          r'tiled_(?:mv|pc)_(?:kernel|any_t|ring))(I\w*?E)?E',
                          m.group(1))
            entry = m.group(1) if k is None else \
                k.group(1) + (f'<{k.group(2)}>' if k.group(2) else '')
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
    return out


# the runtime-t block sizes held beside the templates'
RUNTIME_T = (1, 2, 5, 9, 16)


def tiled_systems(t):
    """{shape: (offsets, A_T, Minv_T, C_T, v)} at N = 53 and the 100k
    shape (chip_smoke.stencil_system's operands, v drawn from seed 7)."""
    from chip_smoke import stencil_system
    out = {}
    for tag, shape in (('N=53', (53, 9, 15, False)),
                       ('100k shape', (100_000, 993, 80_000, True))):
        offsets, (b_T, A_T, Minv_T, C_T) = stencil_system(*shape, t)
        gen = torch.Generator(device=b_T.device).manual_seed(7)
        v = torch.randn(b_T.shape, generator=gen, device=b_T.device)
        out[tag] = (offsets, A_T, Minv_T, C_T, v)
    return out


def tiled_probe(t, old, flush):
    """The tiled matvec and apply at block size t against the earlier
    build: bit-equal at both shapes; at the 100k shape device time warm
    and flushed (old, new, new, old), bound, plain and library times.
    Returns [(t, kernel, shape)] of the cases that differ."""
    from chip_smoke import bound, cuda_ms, device_ms
    differ = []
    for tag, (offsets, A_T, Minv_T, C_T, v) in tiled_systems(t).items():
        N, n_off = v.shape[1], len(offsets)
        M3 = Minv_T.view(t, t, -1)
        mv_bytes = 4 * N * (t * t * (1 + n_off) + 2 * t)
        mv_flop = 2 * N * t * t * (1 + 2 * n_off)

        def mv(ring=False):
            return scg._tiled_mv_launch(A_T, C_T, v, offsets, t, ring=ring)
        mv_plain = functools.partial(scg._stencil_matvec_torch, A_T, C_T,
                                     offsets, t, v)
        pc = functools.partial(scg._tiled_pc_launch, Minv_T, v, t)
        # name: (this build's launch, the earlier build's, plain, library,
        # bytes, operations)
        kernels = {
            'mv': (mv, mv, mv_plain, None, mv_bytes, mv_flop),
            'mv ring': (functools.partial(mv, True), mv, mv_plain, None,
                        mv_bytes, mv_flop),
            'pc': (pc, pc, lambda: scg._block_mul(Minv_T, v, t),
                   lambda: torch.einsum('iun,un->in', M3, v),
                   4 * N * (t * t + 2 * t), 2 * N * t * t)}
        for kname, (kern, kern_old, plain, library, n_bytes, n_flop) in \
                kernels.items():
            with using(old):
                a = kern_old()
            b = kern()
            same = bool(torch.equal(a, b))
            line = (f'[tiled] {kname} t={t} '
                    f'({"template" if t in scg.TEMPLATE_T else "runtime t"})'
                    f' {tag}: bit-equal to the earlier build {same}')
            if not same:
                differ.append((t, kname, tag))
            if tag == '100k shape':
                ms = {(side, cold): [] for side in ('old', 'new')
                      for cold in (False, True)}
                for side in ('old', 'new', 'new', 'old'):
                    for cold in (False, True):
                        f = kern_old if side == 'old' else kern
                        with using(old if side == 'old' else None):
                            ms[side, cold].append(device_ms(
                                (lambda f=f: (flush.zero_(), f())) if cold
                                else f, calls=50,
                                match=f'tiled_{kname[:2]}'))
                mean = {k: 1e3 * statistics.mean(v) for k, v in ms.items()}
                readings = {side + (' flushed' if cold else ''):
                            [round(1e3 * x, 2) for x in v]
                            for (side, cold), v in ms.items()}
                b_ms, b_by = bound(n_bytes, n_flop)
                p_ms, _ = cuda_ms(plain)
                lib = 'none' if library is None else \
                    f'{1e3 * cuda_ms(library)[0]:.2f} us (torch.einsum)'
                line += (
                    f'; device us a launch, warm: earlier '
                    f'{mean["old", False]:.2f}, this build '
                    f'{mean["new", False]:.2f}; L2 flushed: earlier '
                    f'{mean["old", True]:.2f}, this build '
                    f'{mean["new", True]:.2f} (readings us {readings}); '
                    f'bound {1e3 * b_ms:.2f} us ({b_by}): share flushed '
                    f'earlier {1e3 * b_ms / mean["old", True]:.3f}, this '
                    f'build {1e3 * b_ms / mean["new", True]:.3f}; plain '
                    f'{1e3 * p_ms:.2f} us; library {lib}')
            print(line, flush=True)
    return differ


def bulk_rates():
    """probes/bulk_rate.cu: the rate 1-D bulk copies fill shared memory,
    two blocks an SM, from a 1 GiB buffer (device memory) and a 16 MiB one
    (L2), by copy size (32 KB stages, 3 of them), and by stage size (512-B
    copies, 8 stages (3 of 32 KB), one and four producer warps (three at
    32 KB): the ring's cost a stage
    beside the copies'); prints GB/s and, for the second, cycles a stage
    a block at the SM clock nvidia-smi reads."""
    from chip_smoke import cuda_ms
    src = Path(__file__).with_name('bulk_rate.cu')
    _build.BUILD.mkdir(exist_ok=True)
    lib_path = _build.BUILD / 'libbulk_rate.so'
    run = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-o',
                          str(lib_path), str(src)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f'nvcc failed on bulk_rate.cu:\n{run.stdout}'
                           f'{run.stderr}')
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ppt_bulk_rate.argtypes = [P, ctypes.c_size_t] + [I] * 6 + [P]
    lib.ppt_bulk_rate.restype = I
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = 2 * sms
    buf = torch.zeros(1 << 28, dtype=torch.float32, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def rate(nbytes, size, stage_bytes, stages, warps, rounds):
        def call():
            rc = lib.ppt_bulk_rate(buf.data_ptr(), nbytes, size, stage_bytes,
                                   stages, rounds, warps, grid, stream)
            if rc:
                raise RuntimeError(f'bulk_rate failed: {rc}')
        call()
        ms, _ = cuda_ms(call, repeat=5)
        return ms
    mhz = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm', '--format=csv,noheader,'
         'nounits', '-i', '0'], capture_output=True, text=True).stdout)
    for where, nbytes in (('device memory', 1 << 30), ('L2', 1 << 24)):
        for warps in (1, 3):
            rates = {size: round(grid * 200 * 32768 / rate(
                nbytes, size, 32768, 3, warps, 200) / 1e6, 1)
                for size in (256, 512, 1024, 2048, 4096, 16384)}
            print(f'[bulk-rate] {where}, {warps} producer warp(s), two '
                  f'blocks an SM, 3 stages of 32768 B: GB/s by copy bytes '
                  f'{rates}', flush=True)
        for warps in (1, 4):
            rows = {}
            for stage_bytes in (1024, 4096, 16384, 32768):
                rounds = 400
                stages = min(8, 98304 // stage_bytes)
                # a producer warp at most a stage (the ring's parities)
                ms = rate(nbytes, 512, stage_bytes, stages,
                          min(warps, stages), rounds)
                rows[stage_bytes] = (
                    round(grid * rounds * stage_bytes / ms / 1e6, 1),
                    round(ms * 1e-3 * mhz * 1e6 / rounds))
            print(f'[bulk-rate] {where}, {warps} producer warp(s), 512-B '
                  f'copies, 8 stages (3 of 32 KB): (GB/s, cycles a stage a '
                  f'block at '
                  f'{mhz:.0f} MHz) by stage bytes {rows}', flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--old', type=Path,
                    help='a directory of earlier stencil_cg*.cu sources')
    ap.add_argument('--tiled-only', action='store_true',
                    help='the tiled kernels alone')
    ap.add_argument('--bulk-rate', action='store_true',
                    help='first, the rate bulk copies fill shared memory '
                         'by copy size (probes/bulk_rate.cu)')
    args = ap.parse_args()
    if args.old is None and not args.bulk_rate:
        ap.error('give --old DIR, --bulk-rate or both')
    if not torch.cuda.is_available():
        raise SystemExit('stencil_probes needs an NVIDIA GPU')
    sys.path.insert(0, str(ROOT))
    if args.bulk_rate:
        bulk_rates()
    if args.old is None:
        return
    from chip_smoke import device_ms
    _build.build_all(SOURCES)
    old, old_logs = old_libs(args.old)
    for name in SOURCES:
        new = registers((_build.BUILD / f'lib{name}.log').read_text())
        earlier = registers(old_logs[name])
        for kernel in sorted(set(new) | set(earlier)):
            a, b = earlier.get(kernel), new.get(kernel)
            print(f'[ptxas] {name} {kernel}: earlier '
                  f'{"none" if a is None else f"{a[0]} registers, {a[1]} B spilled"}'
                  f'; this build '
                  f'{"none" if b is None else f"{b[0]} registers, {b[1]} B spilled"}',
                  flush=True)
    differ = []
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device='cuda')
    for t in sorted(scg.TEMPLATE_T) + list(RUNTIME_T):
        differ += tiled_probe(t, old, flush)
    for t in () if args.tiled_only else sorted(scg.TEMPLATE_T):
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
    print(f'[stencil-probes] {smi}; differ: {differ or "none"}', flush=True)
    if differ:
        raise SystemExit(1)


if __name__ == '__main__':
    main()
