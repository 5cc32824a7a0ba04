r"""The wide knn scans (D > 8) on the card: what the compiler made of them,
and their times against an earlier build of ``csrc/knn.cu``.

Prints ``-Xptxas -v``'s registers, shared memory and spills of the
tensor-core scans (``wide_tc_scan``) and the pre-passes (``tf32_split``,
``f64_panels``), and the count of HGMMA (float32) or DMMA (float64)
instructions in each one's SASS (``cuobjdump -sass``, where the toolkit
has it).  Then, at FPFH-like 50,000 x 50,000
(D = 33) and SIFT-like 20,000 x 100,000 (D = 128) clouds
(``chip_smoke.descriptors``), ``nn1`` and ``nnk`` at k = 8, and ``nnk`` at
k = 2 on the SIFT clouds (Lowe's ratio test): each case held to the plain
version by the near-tie rule, and timed with CUDA events (median of 7,
the 50 MB L2 flushed before each launch).  Given ``--old PATH``, a
``knn.cu`` of this C interface (``ppt_knn_scratch`` taking k; e.g. ``git
show 89bb3cd:pypose_tpu_torch/csrc/knn.cu``) is built beside it and
instead the cases of ``OLD_CASES`` are timed old, new, new, old in one
process: the [knn-bigk] merge-scan cases of the register-tiled family,
held bit for bit to the old build, and the float64 [knn-wide] cases,
each build held to the plain version by the near-tie rule at F64_TOL
(with ``--crossover`` both run, every library built at once).
``--variants`` also times the text edits of
``csrc/knn.cu`` in ``VARIANTS`` (no tensor-core products, no copies into
shared memory, two stages, one consumer warpgroup): where the scans'
time goes.  ``--wgmma`` first measures how many cycles of an SM one
``wgmma.m64nNk8.tf32`` takes at N = 64, 128 and 256
(``probes/wgmma_rate.cu``); ``--dmma`` checks the fragment layouts the
DMMA scan assumes (an exact integer product through each float64
``mma.sync`` shape), measures each shape's rate alone, and the
fragments' shared-memory loads in the panels' order against coordinate
order (bytes a cycle an SM: bank conflicts; ``probes/dmma_rate.cu``).  ``--bigk`` instead times nnk at k > 16 on
``chip_smoke.py``'s [knn-bigk] cases on the warp merge scan against
``BIGK_VARIANTS`` (all, or those named after ``--bigk``), the choices of
that path: its merge rounds, ring stages and blocks an SM.
``--crossover`` times each family's two paths past k = 16, the merge
scan and the select-then-sort path, each forced by a build of
``csrc/knn.cu`` with other crossover constants (``CROSSOVER_VARIANTS``),
on ``CROSSOVER_SHAPES`` (all, or those of the clouds named) at each k,
and checks that they give the same bits: where ``kSelectK``,
``kSelectK64``, ``kSelectKSmallR``, ``kSelectKSmallR64``,
``kWideSelectK``, ``kWideSelectK64`` and ``kWideSelectK64Long`` come
from.  ``--sort-all`` times k = N both ways, the fused sort kernel and the
general select path (``SORT_ALL_VARIANTS``).  ``--cases [TAG ...]`` runs ``chip_smoke.py``'s [knn-bigk] phase on
the cases named.  ``--breakdown`` traces one call of each [knn-bigk] case on
the select path and sums its device time by kernel (sample and counting
passes, picks, emission, sort), and counts the counting passes the
digit walk takes each of its first 128 rows (``ops.knn._select_rows`` on
their FMA-chain scores in the clouds' type, with the card's boundary
buffer; no guess).  Needs an NVIDIA GPU:

    python3 -m pypose_tpu_torch.probes.knn_probes [--old PATH] [--variants]
        [--wgmma] [--dmma] [--bigk [VARIANT ...]] [--crossover [CLOUDS ...]]
        [--sort-all] [--breakdown]
        [--cases [TAG ...]]
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from pypose_tpu_torch.ops import _build
from pypose_tpu_torch.ops import knn as K
from pypose_tpu_torch.testing import nnk_tolerance_failures

ROOT = Path(__file__).resolve().parents[2]
CASES = (('fpfh', 33, 50_000, 50_000, 1), ('fpfh', 33, 50_000, 50_000, 8),
         ('sift', 128, 20_000, 100_000, 1), ('sift', 128, 20_000, 100_000, 8),
         ('sift', 128, 20_000, 100_000, 2))


def old_lib(path):
    """The earlier knn.cu (this C interface) built with the same flags
    (once: the card tests' library of the same source is reused) and bound
    as :func:`variant_libs` binds a variant."""
    import hashlib
    digest = hashlib.sha1(Path(path).read_bytes()).hexdigest()[:12]
    out = _build.BUILD / f'libknn_old_{digest}.so'   # as the card tests name it
    if not out.exists():
        _build.BUILD.mkdir(exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-o',
                        str(out), str(path)], check=True, capture_output=True,
                       text=True)
    return _bind(out)


# --old's cases: (tag, clouds of chip_smoke.bigk_clouds, k, bit-equal):
# the register-tiled merge scan's [knn-bigk] cases (the same bits in both
# builds), and [knn-wide]'s float64 FPFH-like clouds at nn1 and k = 8 (the
# earlier SIMT scans against DMMA: each held to the plain version).
OLD_CASES = (('normals', 'icp', 30, True), ('outliers', 'icp', 50, True),
             ('fpfh-nbhd', 'icp', 100, True), ('d6-f64', 'd6-f64', 30, True),
             ('fpfh-f64 nn1', 'fpfh-f64', 1, False),
             ('fpfh-f64 k=8', 'fpfh-f64', 8, False))


def against_old(dev, old):
    """OLD_CASES, each timed old, new, new, old (L2 flushed, median of 7)
    and held to the old build bit for bit or, with it, to the plain
    version by the near-tie rule (float64 at F64_TOL)."""
    from chip_smoke import F64_TOL, bigk_clouds, flushed_ms
    clouds = bigk_clouds(dev)
    for tag, cl, k, same in OLD_CASES:
        ref, nbr = clouds[cl]
        tol = F64_TOL if ref.dtype == torch.float64 else {}
        d_o, i_o = variant_call(old, ref, nbr, k)
        d_n, i_n = variant_call(_bind(_build.BUILD / 'libknn.so'), ref, nbr,
                                k)
        if same:
            check = torch.equal(d_o, d_n) and torch.equal(i_o, i_n)
            line = f'bit-equal {check}'
        else:
            i_p = (K._nn1_torch(ref, nbr)[1][:, None] if k == 1
                   else K._nnk_torch(ref, nbr, k)[1])
            rules = [nnk_tolerance_failures(ref, nbr, d, i, i_p, **tol)
                     for d, i in ((d_o, i_o), (d_n, i_n))]
            check = all(r['index_failures'] == r['repeat_failures']
                        == r['d2_failures'] == 0 for r in rules)
            line = f'old rule {rules[0]}, new rule {rules[1]}'
        del d_o, i_o, d_n, i_n
        fo = lambda: variant_call(old, ref, nbr, k)  # noqa: E731
        fn = ((lambda: K.nn1(ref, nbr)) if k == 1 else
              (lambda: K.nnk(ref, nbr, k)))
        t = [flushed_ms(f)[0] for f in (fo, fn, fn, fo)]
        print(f'[old] {tag} {ref.dtype} [{ref.shape[0]}, {ref.shape[1]}] x '
              f'[{nbr.shape[0]}, {nbr.shape[1]}], k={k}: old {t[0]:.4f} '
              f'{t[3]:.4f}, new {t[1]:.4f} {t[2]:.4f} ms (median of 7, L2 '
              f'flushed); new/old {(t[1] + t[2]) / (t[0] + t[3]):.3f}; '
              f'{line}', flush=True)
        if not check:
            raise SystemExit(f'--old {tag}: {line}')


# Variants of csrc/knn.cu for --variants, each a text edit of the source:
# what the float32 wide scans take without their tensor-core products,
# without their copies into shared memory (the stages then hold stale
# data: times only), or with two stages.
VARIANTS = {
    'no-mma': [('uint64_t db, int accumulate) {',
                'uint64_t db, int accumulate) {\n  if (accumulate >= 0) '
                'return;')],
    'no-copy': [('            bulk_load(st, tile + off, hi_bytes + lo_bytes, '
                 '&full[s]);\n', ''),
                ('          mbar_expect_tx(&full[s], hi_bytes + lo_bytes +\n'
                 '                                       (resident ? 0 : '
                 'kGroups * a_bytes));',
                 '          mbar_arrive(&full[s]);')],
    'stages-2': [('constexpr int kMaxChunkStages = 4;',
                  'constexpr int kMaxChunkStages = 2;')],
    'groups-1': [('constexpr int kGroups = 2;', 'constexpr int kGroups = 1;')],
}
# Variants for --bigk, the warp merge scan's choices: its merge rounds at
# four list entries a lane (kRound's), its ring at two stages, its blocks
# at two an SM (the register cap of 128).
BIGK_VARIANTS = {
    'warp-round-4': [('constexpr int kWarpRound = 1;',
                      'constexpr int kWarpRound = 4;')],
    'ring-2': [('constexpr int kRingStages = 4;',
                'constexpr int kRingStages = 2;')],
    'blocks-2': [('__launch_bounds__(32 * (kMaxWarps + 1), 3)',
                  '__launch_bounds__(32 * (kMaxWarps + 1), 2)')],
}
# Variants for --crossover: each family's two paths past k = 16 forced
# (every crossover constant), the merge scans (the select paths only at
# k = N) and the select-then-sort paths (at every k > 16).
_CROSSOVERS = ('kSelectK', 'kSelectK64', 'kSelectKSmallR',
               'kSelectKSmallR64', 'kWideSelectK', 'kWideSelectK64',
               'kWideSelectK64Long')
CROSSOVER_VARIANTS = {
    name: [(f'constexpr int {c} = ', f'constexpr int {c} = {k}; //')
           for c in _CROSSOVERS]
    for name, k in (('merge', '1 << 30'), ('select', '17'))}
# --crossover's shapes: (tag, clouds, ks); the clouds of chip_smoke.py's
# [knn-bigk] range case (10,000 ICP source points against the 100k
# target), its 100k target against itself (in float32 and float64),
# [knn-d6]'s float64 clouds, [knn-wide]'s FPFH-like (D = 33) and
# SIFT-like (D = 128) float32 clouds, its FPFH-like float64 clouds, and
# the SIFT-like clouds' first 10,000 x 20,000 in float64.
CROSSOVER_SHAPES = (
    ('fpfh 50k x 50k', 'fpfh', (64, 100, 128, 256, 512, 1024)),
    ('sift 20k x 100k', 'sift', (64, 100, 128, 256, 512, 1024)),
    ('fpfh-f64 10k x 10k', 'fpfh-f64',
     (17, 24, 32, 48, 64, 128, 256, 512, 1024)),
    ('sift-f64 10k x 20k', 'sift-f64',
     (32, 64, 96, 128, 192, 256, 512, 1024)),
    ('10k x 100k', 'range',
     (64, 100, 128, 256, 320, 384, 448, 512, 1024, 2048)),
    ('100k x 100k', 'icp',
     (64, 100, 128, 256, 320, 384, 448, 512, 1024, 2048)),
    ('100k x 100k f64', 'icp-f64',
     (64, 100, 128, 256, 320, 384, 448, 512, 1024, 2048)),
    ('d6-f64 10k x 10k', 'd6-f64',
     (30, 64, 100, 128, 256, 320, 384, 448, 512, 1024, 2048)))
# --sort-all: k = N within one block's sort, the fused kernel
# (sel_sort_all: scores and sorts) against the general path (sel_init, sel_emit, sel_sort)
# with the early returns that send k = N to the fused kernel taken out;
# on (tag, clouds, rows): the first `rows` points of the clouds against
# themselves.
SORT_ALL_VARIANTS = {
    'fused': [],
    'general': [('  if (fused && k == N && p.P <= kSortMax) return p;\n', ''),
                ('  if (k == N && p.P <= kSortMax) {\n', '  if (false) {\n')],
}
SORT_ALL_SHAPES = (('full 4096^2', 'full', 4096), ('2048^2', 'full', 2048),
                   ('8192^2', 'icp', 8192), ('d6-f64 4096^2', 'd6-f64', 4096))


def variant_libs(variants, sources=None):
    """csrc/knn.cu with each variant's edits ({name: [(old, new)]}), and
    each other source of ``sources`` ({name: path}) as it is, built (one
    nvcc each, all at once) and bound as ops/knn.py binds the real one."""
    src = (_build.CSRC / 'knn.cu').read_text()
    procs = {}
    texts = {name: Path(path).read_text()
             for name, path in (sources or {}).items()}
    for name, edits in {**variants, **{n: [] for n in texts}}.items():
        text = texts.get(name, src)
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f'variant {name}: {old!r} not in knn.cu')
            text = text.replace(old, new)
        path = _build.BUILD / f'knn_{name}.cu'
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, '-o',
             str(path.with_suffix('.so')), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'variant {name}: {log}')
        (_build.BUILD / f'knn_{name}.log').write_text(log)  # ptxas' report
        libs[name] = _bind(_build.BUILD / f'knn_{name}.so')
    return libs


def _bind(path):
    """A built knn.cu's entry points that :func:`variant_call` calls."""
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn, args in (('ppt_nn1_splits', [I] * 4),
                     ('ppt_knn_scratch',
                      [I] * 5 + [ctypes.POINTER(ctypes.c_longlong)]),
                     ('ppt_nn1', [P, P] + [I] * 5 + [P] * 6),
                     ('ppt_nnk_splits', [I] * 5),
                     ('ppt_nnk_select_scratch',
                      [I] * 5 + [ctypes.POINTER(ctypes.c_longlong)]),
                     ('ppt_nnk', [P, P] + [I] * 6 + [P] * 6)):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = I
    return lib


def variant_call(lib, ref, nbr, k):
    """One call of ``lib``'s nn1 (k = 1) or nnk, its scratch as
    ops/knn.py:_launch_nnk allocates it."""
    (R, D), N = ref.shape, nbr.shape[0]
    dev, f64 = ref.device, int(ref.dtype == torch.float64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    d2 = torch.empty((R, k), dtype=ref.dtype, device=dev)
    idx = torch.empty((R, k), dtype=torch.int64, device=dev)
    n = ctypes.c_longlong()
    sel = ctypes.c_longlong(-1)
    if k > 1:
        lib.ppt_nnk_select_scratch(R, N, D, k, f64, ctypes.byref(sel))
    if sel.value >= 0:   # the select path: its scratch, no lists
        sp, n.value = 1, sel.value
        ps = pi = torch.empty((1,), dtype=torch.int32, device=dev)
    else:
        lib.ppt_knn_scratch(R, N, D, k, f64, ctypes.byref(n))
        n.value *= 4
        sp = (lib.ppt_nn1_splits(R, N, D, f64) if k == 1
              else lib.ppt_nnk_splits(R, N, D, k, f64))
        ps = torch.empty((sp, k, R), dtype=ref.dtype, device=dev)
        pi = torch.empty((sp, k, R), dtype=torch.int32, device=dev)
    scratch = torch.empty((max(1, n.value),), dtype=torch.uint8, device=dev)
    args = (scratch.data_ptr(), ps.data_ptr(), pi.data_ptr(), d2.data_ptr(),
            idx.data_ptr(), stream)
    rc = (lib.ppt_nn1(ref.data_ptr(), nbr.data_ptr(), R, N, D, f64, sp,
                      *args)
          if k == 1 else
          lib.ppt_nnk(ref.data_ptr(), nbr.data_ptr(), R, N, D, k, f64, sp,
                      *args))
    if rc:
        raise RuntimeError(f'variant launch failed: {rc}')
    return d2, idx


def bigk(dev, libs):
    """The [knn-bigk] cases on the warp merge scan (chip_smoke.BIGK_CASES
    of the register-tiled family whose path is the scan) timed against
    each variant of ``libs`` in turns (this build, the variant, the
    variant, this build; L2 flushed, median of 7), each held to the plain
    version by the near-tie rule (float64 at F64_TOL)."""
    from chip_smoke import BIGK_CASES, F64_TOL, bigk_clouds, flushed_ms
    clouds = bigk_clouds(dev)
    for tag, cl, k, family, _ in BIGK_CASES:
        ref, nbr = clouds[cl]
        (R, D), N = ref.shape, nbr.shape[0]
        if not family.startswith('register-tiled') or \
                K.nnk_plan(R, N, D, k, ref.dtype)['route'] != 'scan':
            continue
        tol = F64_TOL if ref.dtype == torch.float64 else {}
        i_p = K._nnk_torch(ref, nbr, k)[1]
        got = nnk_tolerance_failures(ref, nbr, *K.nnk(ref, nbr, k), i_p,
                                     **tol)
        line = f'[probe] {tag} ({family}), k={k}: {got}'
        for name, lib in libs.items():
            vgot = nnk_tolerance_failures(
                ref, nbr, *variant_call(lib, ref, nbr, k), i_p, **tol)
            this = lambda: K.nnk(ref, nbr, k)  # noqa: E731
            var = lambda: variant_call(lib, ref, nbr, k)  # noqa: E731
            t = [flushed_ms(f)[0] for f in (this, var, var, this)]
            line += (f'; {name}: this {t[0]:.4f}, {name} {t[1]:.4f}, '
                     f'{t[2]:.4f}, this {t[3]:.4f} ms (rule failures '
                     f'{vgot["index_failures"] + vgot["repeat_failures"]})')
        print(line + ' (median of 7, L2 flushed)', flush=True)
        if got['index_failures'] or got['repeat_failures'] \
                or got['d2_failures']:
            raise SystemExit(f'{tag} k={k}: outside the near-tie rule')


def crossover(dev, libs, shapes=()):
    """nnk's two paths past k = 16 (CROSSOVER_VARIANTS, forced by
    kSelectK) on CROSSOVER_SHAPES (all, or those whose clouds are named in
    ``shapes``) at each k, timed in turns (merge, select, select, merge;
    L2 flushed, median of 7); the two must give the same bits (they rank
    the same scores in the same order)."""
    from chip_smoke import bigk_clouds
    clouds = bigk_clouds(dev)
    for tag, cl, ks in CROSSOVER_SHAPES:
        if shapes and cl not in shapes:
            continue
        ref, nbr = clouds[cl]
        for k in ks:
            turns(libs, 'merge', 'select', f'[crossover] {tag} {ref.dtype}, '
                  f'k={k}', ref, nbr, k)


def sort_all(dev, libs):
    """k = N within a block's sort, both ways (SORT_ALL_VARIANTS) on
    SORT_ALL_SHAPES, timed in turns as --crossover times them."""
    from chip_smoke import bigk_clouds
    clouds = bigk_clouds(dev)
    for tag, cl, rows in SORT_ALL_SHAPES:
        pts = clouds[cl][1][:rows].contiguous()
        turns(libs, 'fused', 'general', f'[sort-all] {tag} {pts.dtype}, '
              f'k=N={rows}', pts, pts, rows)


def turns(libs, a, b, tag, ref, nbr, k):
    """``libs[a]`` and ``libs[b]`` at k, timed a, b, b, a (L2 flushed,
    median of 7 each) and printed; exits unless they give the same bits."""
    from chip_smoke import flushed_ms
    outs = {n: variant_call(libs[n], ref, nbr, k) for n in (a, b)}
    same = all(torch.equal(x, y) for x, y in zip(outs[a], outs[b]))
    del outs
    fa = lambda: variant_call(libs[a], ref, nbr, k)  # noqa: E731
    fb = lambda: variant_call(libs[b], ref, nbr, k)  # noqa: E731
    t = [flushed_ms(f)[0] for f in (fa, fb, fb, fa)]
    print(f'{tag}: {a} {t[0]:.4f} {t[3]:.4f}, {b} {t[1]:.4f} {t[2]:.4f} ms '
          f'(median of 7, L2 flushed); {b}/{a} '
          f'{(t[1] + t[2]) / (t[0] + t[3]):.3f}; bit-equal {same}',
          flush=True)
    if not same:
        raise SystemExit(f'{tag}: the two paths differ')


def breakdown(dev, tags=()):
    """Where the select path's time goes: each [knn-bigk] case that takes
    it (chip_smoke.BIGK_CASES, ops.knn.nnk_plan; those in ``tags`` where
    given: ``--breakdown --cases TAG ...``), one call under
    torch.profiler after a warm one, its device time summed by kernel."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import BIGK_CASES, bigk_clouds
    clouds = bigk_clouds(dev)
    for tag, cl, k, _, _ in BIGK_CASES:
        ref, nbr = clouds[cl]
        (R, D), N = ref.shape, nbr.shape[0]
        if K.nnk_plan(R, N, D, k, ref.dtype)['route'] != 'select' or \
                tags and tag not in tags:
            continue
        K.nnk(ref, nbr, k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            K.nnk(ref, nbr, k)
            torch.cuda.synchronize()
        tot, scans = {}, []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if 'wide_tc_scan' in e.name() or 'sel_count' in e.name():
                    scans.append(e.duration_ns() / 1e6)
                m = re.search(r'::(\w+)(<[^>(]*>)?', e.name())
                name = m.group(1) + (m.group(2) or '') if m \
                    else e.name()[:40]
                n, ns = tot.get(name, (0, 0))
                tot[name] = (n + 1, ns + e.duration_ns())
        print(f'[breakdown] {tag} [{R}, {D}] x [{N}, {D}] {ref.dtype}, k={k}: '
              + ', '.join(f'{name} x{n} {ns / 1e6:.4f} ms'
                          for name, (n, ns) in tot.items())
              + f'; all {sum(ns for _, ns in tot.values()) / 1e6:.4f} ms; '
              'the scans and counting passes in order '
              + ', '.join(f'{ms:.4f}' for ms in scans) + ' ms; counting '
              f'passes a row (digit walk, first 128 rows): '
              f'{walk_passes(ref, nbr, k)}', flush=True)


def walk_passes(ref, nbr, k, rows=128):
    """{passes: rows} of the digit walk (ops.knn._select_rows, no guess)
    on the FMA-chain scores, in the clouds' type, of the first ``rows``
    rows, with the card's boundary buffer (csrc/knn.cu:sel_plan's cap)."""
    N = nbr.shape[0]
    if k == N:
        return {0: min(rows, ref.shape[0])}
    P = 64
    while P < k - 1 + 256:
        P *= 2
    cap = min(512, P - (k - 1))
    s = K._select_scores(ref[:rows], nbr).cpu()
    out = {}
    for r in range(s.shape[0]):
        n = K._select_rows(s[r:r + 1], k, cap)[2]
        out[n] = out.get(n, 0) + 1
    return dict(sorted(out.items()))


def wgmma_rates(dev, steps=15, rounds=2000):
    """probes/wgmma_rate.cu on every SM: {(N, warpgroups): (cycles a
    wgmma.m64nNk8.tf32 takes an SM, MAC a cycle an SM)}, from the slowest
    warpgroup's clock64 span over `rounds` groups of `steps` wgmmas."""
    src = Path(__file__).with_name('wgmma_rate.cu')
    out = _build.BUILD / 'libwgmma_rate.so'
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-o', str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ppt_wgmma_rate.argtypes = [I] * 4 + [P, P, I]
    lib.ppt_wgmma_rate.restype = I
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cycles = torch.zeros(2 * sms, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, device=dev)
    rates = {}
    for n in (64, 128, 256):
        for groups in (1, 2):
            cycles.zero_()
            rc = lib.ppt_wgmma_rate(n, groups, steps, rounds,
                                    cycles.data_ptr(), sink.data_ptr(), sms)
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f'wgmma_rate launch failed: {rc}')
            span = float(cycles.view(sms, 2).max(1).values.double().median())
            per = span / (groups * steps * rounds)
            rates[(n, groups)] = (per, 64 * n * 8 / per)
    return rates


def dmma_rates(dev, rounds=20_000, warps=8):
    """probes/dmma_rate.cu on every SM: {shape: (its layout check exact,
    cycles an SM a k-step of a warp's tile, TFLOP/s by CUDA events)}, and
    {fragment loads: (None, cycles a round, bytes a cycle an SM)}."""
    src = Path(__file__).with_name('dmma_rate.cu')
    out = _build.BUILD / 'libdmma_rate.so'
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-o', str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ppt_dmma_rate.argtypes = [I] * 3 + [P, P, I]
    lib.ppt_dmma_layout.argtypes = [I, P, P, P]
    lib.ppt_lds_rate.argtypes = [I] * 3 + [P, P, I]
    lib.ppt_dmma_rate.restype = lib.ppt_dmma_layout.restype = I
    lib.ppt_lds_rate.restype = I
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cycles = torch.zeros(32 * sms, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.float64, device=dev)
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-8, 8, (16, 16), generator=gen).double().to(dev)
    b = torch.randint(-8, 8, (8, 16), generator=gen).double().to(dev)
    rates = {}
    for shape, name in ((0, 'm8n8k4'), (4, 'm16n8k4'), (8, 'm16n8k8'),
                        (16, 'm16n8k16')):
        d = torch.zeros((16, 8), dtype=torch.float64, device=dev)
        rc = lib.ppt_dmma_layout(shape, a.data_ptr(), b.data_ptr(),
                                 d.data_ptr())
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f'dmma_layout launch failed: {rc}')
        exact = torch.equal(d, a @ b.T)
        run = lambda: lib.ppt_dmma_rate(  # noqa: E731
            shape, warps, rounds, cycles.data_ptr(), sink.data_ptr(), sms)
        run()
        torch.cuda.synchronize()
        cycles.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = run()
        end.record()
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f'dmma_rate launch failed: {rc}')
        span = float(cycles.view(sms, 32)[:, :warps].max(1).values.double()
                     .median())
        # a k-step of 8 of a 16 x 64 tile: 16 * 64 * 8 * 2 flop a warp
        flop = 16 * 64 * 8 * 2 * rounds * warps * sms
        rates[name] = (exact, span / rounds / warps,
                       flop / (start.elapsed_time(end) * 1e-3) / 1e12)
    # the fragments' loads alone: bytes an SM a cycle, 128 at most
    for permuted, name in ((1, 'fragment loads, panel order (LDS.128)'),
                           (0, 'fragment loads, coordinate order (LDS.64)')):
        cycles.zero_()
        rc = lib.ppt_lds_rate(permuted, warps, rounds, cycles.data_ptr(),
                              sink.data_ptr(), sms)
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f'lds_rate launch failed: {rc}')
        span = float(cycles.view(sms, 32)[:, :warps].max(1).values.double()
                     .median())
        # a round: 10 fragment pairs of 16 bytes a thread, 32 threads a warp
        rates[name] = (None, span / rounds, 10 * 16 * 32 * warps * rounds
                       / span)
    return rates


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--old', type=Path, help='an earlier csrc/knn.cu')
    ap.add_argument('--variants', action='store_true',
                    help='time the VARIANTS of csrc/knn.cu beside it')
    ap.add_argument('--wgmma', action='store_true',
                    help='the TF32 wgmma rate at n64, n128, n256 first')
    ap.add_argument('--breakdown', action='store_true',
                    help='the select path\'s device time by kernel on the '
                         '[knn-bigk] cases that take it')
    ap.add_argument('--crossover', nargs='*', metavar='CLOUDS',
                    help='nnk past k = 16: the merge scan against the '
                         'select path (CROSSOVER_VARIANTS) at each k, on '
                         'CROSSOVER_SHAPES (all, or those of the clouds '
                         'named)')
    ap.add_argument('--dmma', action='store_true',
                    help='the float64 mma.sync layouts and rates first')
    ap.add_argument('--sort-all', action='store_true',
                    help='k = N: the fused sort kernel against the general '
                         'select path (SORT_ALL_VARIANTS)')
    ap.add_argument('--cases', nargs='*', metavar='TAG',
                    help='chip_smoke.py\'s [knn-bigk] phase on the cases '
                         'of BIGK_CASES named (all if none)')
    ap.add_argument('--bigk', nargs='*', metavar='VARIANT',
                    help='only the [knn-bigk] cases on the warp merge scan '
                         'against BIGK_VARIANTS (all, or those named)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('knn_probes: needs an NVIDIA GPU')
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (compiled_kernels, d2_err_over_tol, descriptors,
                            flushed_ms, knn_bound)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '-i', '0'],
                         capture_output=True, text=True).stdout.strip()
    print(f'[probe] {smi}; torch {torch.__version__}', flush=True)
    K._kernel_lib()
    for match, op in (('wide_tc_scanIf', 'HGMMA'), ('tf32_split', 'HGMMA'),
                      ('wide_tc_scanId', 'DMMA'), ('f64_panels', 'DMMA'),
                      ('nnk_warp_scan', 'ATOMS')):
        for name, (used, spill, n) in compiled_kernels(
                _build.BUILD / 'libknn.so', (match,), op).items():
            print(f'[probe] {name}: {used}; {spill}; {op} in SASS: {n}',
                  flush=True)
    if args.dmma:
        for shape, (exact, per, rate) in dmma_rates(dev).items():
            if exact is None:
                print(f'[probe] {shape}: {per:.2f} cycles a round of a '
                      f'warp\'s 10 loads (8 warps an SM), {rate:.1f} bytes '
                      'a cycle an SM (128 without bank conflicts)',
                      flush=True)
                continue
            print(f'[probe] {shape}: layout exact {exact}; {per:.2f} cycles '
                  f'an SM a k-step of 8 of a warp\'s 16 x 64 tile '
                  f'(8 warps an SM), {rate:.2f} TFLOP/s (CUDA events, all '
                  'SMs)', flush=True)
    if args.wgmma:
        for (n, groups), (per, mac) in wgmma_rates(dev).items():
            print(f'[probe] wgmma.m64n{n}k8.tf32, {groups} warpgroup(s) an '
                  f'SM: {per:.1f} cycles a wgmma an SM, {mac:.0f} MAC a cycle '
                  f'an SM ({mac / 1024:.2f} of the 1024 of 495 TFLOP/s at '
                  f'~1.83 GHz)', flush=True)
    if args.old:
        if args.crossover is None:
            against_old(dev, old_lib(args.old))
            return
        # both: every build at once
        libs = variant_libs(CROSSOVER_VARIANTS, {'old': args.old})
        against_old(dev, libs.pop('old'))
        crossover(dev, libs, args.crossover)
        return
    variants = variant_libs(VARIANTS) if args.variants else {}
    if args.crossover is not None or args.sort_all:
        libs = variant_libs({  # one build of each, all at once
            **(SORT_ALL_VARIANTS if args.sort_all else {}),
            **(CROSSOVER_VARIANTS if args.crossover is not None else {})})
        if args.sort_all:
            sort_all(dev, libs)
        if args.crossover is not None:
            crossover(dev, libs, args.crossover)
        if not args.breakdown:
            return
    if args.breakdown:
        breakdown(dev, args.cases or ())
        return
    if args.cases is not None:
        from chip_smoke import knn_bigk_phase
        knn_bigk_phase(dev, args.cases or None)
        return
    if args.bigk is not None:
        bigk(dev, variant_libs({n: e for n, e in BIGK_VARIANTS.items()
                                if not args.bigk or n in args.bigk}))
        return
    gen = torch.Generator().manual_seed(0)
    clouds = {}
    for tag, D, R, N, k in CASES:
        if tag not in clouds:
            clouds[tag] = tuple(descriptors(tag, n, gen).float().to(dev)
                                for n in (R, N))
        ref, nbr = clouds[tag]
        d_k, i_k = K.nnk(ref, nbr, k)
        i_p = K._nnk_torch(ref, nbr, k)[1]
        got = nnk_tolerance_failures(ref, nbr, d_k, i_k, i_p)
        got['max_err_over_tol'] = d2_err_over_tol(ref, nbr, d_k, i_k)
        new_ms = lambda: K.nnk(ref, nbr, k)  # noqa: E731
        times = f'new {flushed_ms(new_ms)[0]:.4f} ms'
        for v, vlib in variants.items():
            t = flushed_ms(lambda: variant_call(vlib, ref, nbr, k))[0]
            times += f'; {v} {t:.4f} ms'
        b = knn_bound(R, N, D, k, False)
        print(f'[probe] {tag} [{R}, {D}] x [{N}, {D}], k={k}: {got}; {times}'
              f' (median of 7, L2 flushed); bound {b[0]:.4f} ms ({b[1]})',
              flush=True)
        if got['index_failures'] or got['repeat_failures'] \
                or got['d2_failures']:
            raise SystemExit(f'{tag} k={k}: outside the near-tie rule')


if __name__ == '__main__':
    main()
