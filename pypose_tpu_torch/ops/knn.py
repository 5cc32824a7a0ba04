r"""Brute-force nearest neighbours: :func:`nn1` (k = 1) and :func:`nnk`.

Counterpart of ``pypose_tpu/ops/pallas_knn.py``.  Each Pallas kernel there
(``_knn1_kernel``, ``_knnk_kernel``) becomes a kernel of ``csrc/knn.cu``,
launched for CUDA tensors by the wrappers here; beside them are their
plain PyTorch versions, which run for CPU tensors and are what tests and
``chip_smoke.py`` compare the kernels with.  On CUDA a wrapper launches
its kernel or raises: it never falls back to the plain version.

The plain versions compute squared distances in the Gram form
``(|a|^2 + |b|^2) - 2 a.b`` with every product and sum rounded once, in
the order of the Pallas kernel (``cross`` summed over the coordinates
from the first; float32 past 128 coordinates in float64, rounded once),
and pick the first index among equal distances, as the
Pallas kernels' first-occurrence argmin and merge do.  Both kernels rank
by ``|b|^2 - 2 a.b`` in FMA form and add ``|a|^2`` after the scan, so on a
near-tie they may pick another neighbour than their plain versions: the
card holds them to :func:`pypose_tpu_torch.testing.nnk_tolerance_failures`
(for ``nn1``, ``nn1_tolerance_failures``).  The distance is clamped at 0
after the neighbours are chosen (``pallas_knn.py:153, 191``).  Indices
are int64 (torch's index type), where the JAX package returns int32.

Both kernels take float32 and float64 clouds of any number of
coordinates: register-tiled scans for 1 to 8 coordinates, and wide scans
past 8 (descriptor clouds: FPFH's 33, SIFT's 128).  :func:`nnk` takes any
``1 <= k <= N``, as the Pallas kernel does: up to k = 16 each row's list
lives in registers (2, 4, 8 or 16 entries); past 16 a row's candidates
gather in a buffer in shared memory, which its warp merges 64 at a time
into the row's sorted list: in the register-tiled scan a warp keeps four
rows (two in float64) and their lists in shared memory, its lanes
scoring different neighbours against them, the neighbours staged once a
call and streamed to the warps by bulk copies; the wide scans keep the
lists in global memory (the header of ``csrc/knn.cu`` says why).  From a crossover k on (:func:`select_k`, measured for each
family, and a function of R for the register-tiled one; ``csrc/knn.cu``
holds it) and at k = N, the
register-tiled family and the wide families instead select, then
sort: counting passes fix each row's k-th (key, index) pair 8 bits at a
time, one pass writes the pairs before it, and a block a row sorts them
(:func:`_select_rows` emulates the cut on the CPU, over
:func:`_select_scores` or, for the float32 wide family,
:func:`_tf32_scores`; nothing on the card's path runs it); both ways
return the same bits.  In float32 the wide
scans run on the tensor cores in three-pass TF32 (``csrc/knn.cu``): each
coordinate is split once a call into ``hi = tf32(x)`` and
``lo = tf32(x - hi)``, both rounded to nearest (:func:`_tf32_split`), and
the cross term is ``a_lo.b_hi + a_hi.b_lo`` (the small products, first)
plus ``a_hi.b_hi``, summed fresh in blocks of 32 coordinates, which holds
the float32 chain's accuracy where one TF32 pass does not (:func:`_tf32_scores` emulates both on the CPU;
nothing on the card's path runs it).  In float64 the wide scans form
their 64 x 64 tiles of scores on the FP64 tensor cores (DMMA) at every
k: the merge scans below the crossover and the select path from it on
and at k = N.
``function/geometry.py:_knn_tiled`` routes k = 1 (not ``largest``) on
CUDA to :func:`nn1` and every other ``k <= N`` to :func:`nnk`.
"""

import ctypes
import functools

import torch

from ._build import bind, raise_on

# Launches of each kernel in this process.
NN1_LAUNCHES = 0
NNK_LAUNCHES = 0
# What csrc/knn.cu is instantiated for: float32 and float64 points of any
# number of coordinates.  Anything else raises on CUDA.
_DTYPES = (torch.float32, torch.float64)

# Pairs in one [chunk, N] block of the plain versions (the JAX package's
# 64 Mi budget of function/geometry.py:_knn_tiled).
_PLAIN_PAIRS = 64 * 1024 * 1024

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel_lib():
    return bind('knn', {
        'ppt_nn1_splits': [_INT] * 4,
        'ppt_knn_scratch': [_INT] * 5 + [ctypes.POINTER(ctypes.c_longlong)],
        'ppt_nn1': [_PTR, _PTR] + [_INT] * 5 + [_PTR] * 6,
        'ppt_nnk_splits': [_INT] * 5,
        'ppt_nnk_select_k': [_INT] * 3,
        'ppt_nnk_family': [_INT] * 5,
        'ppt_nnk_select_scratch': [_INT] * 5
                                  + [ctypes.POINTER(ctypes.c_longlong)],
        'ppt_nnk': [_PTR, _PTR] + [_INT] * 6 + [_PTR] * 6,
        'ppt_nnk_wide_merge_splits': [_INT] * 5,
        'ppt_nnk_wide_merge': [_PTR, _PTR] + [_INT] * 6 + [_PTR] * 6})


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _sqnorm(x):
    """|x|^2 over the last dim, summed from the first coordinate; float32
    past 128 coordinates in float64, rounded once, as the kernels sum it
    (``csrc/knn.cu:kLongNorm``)."""
    if x.dtype == torch.float32 and x.shape[-1] > 128:
        return _sqnorm(x.double()).float()
    s = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c] * x[..., c]
    return s


def _gram_d2(a, b, an, bn):
    """[r, N] squared distances in the kernels' order of operations."""
    cross = a[:, None, 0] * b[None, :, 0]
    for c in range(1, a.shape[1]):
        cross += a[:, None, c] * b[None, :, c]
    d2 = an[:, None] + bn[None, :]
    d2 -= cross.mul_(2.0)
    return d2


def _plain_blocks(ref, nbr):
    """Yield the [chunk, N] distance blocks of the plain versions; float32
    past 128 coordinates formed in float64 and rounded once, as the
    kernels form the norms there (their three TF32 passes hold the cross
    term to ~1e-7, where a float32 sum of 300 products drifts by up to
    the near-tie tolerance)."""
    wide = ref.dtype == torch.float32 and ref.shape[1] > 128
    if wide:
        ref, nbr = ref.double(), nbr.double()
    an, bn = _sqnorm(ref), _sqnorm(nbr)
    chunk = max(128, _PLAIN_PAIRS // nbr.shape[0])
    for s in range(0, ref.shape[0], chunk):
        d2 = _gram_d2(ref[s:s + chunk], nbr, an[s:s + chunk], bn)
        yield d2.float() if wide else d2


def _nn1_torch(ref, nbr):
    """Plain version of :func:`nn1`: argmin (first occurrence) of each
    ``[chunk, N]`` block, then the clamp."""
    vals, idxs = [], []
    for d2 in _plain_blocks(ref, nbr):
        idx = torch.argmin(d2, dim=1)
        vals.append(d2.gather(1, idx[:, None])[:, 0])
        idxs.append(idx)
    return torch.cat(vals).clamp_min(0.0), torch.cat(idxs)


def _nnk_torch(ref, nbr, k):
    """Plain version of :func:`nnk`: a stable sort of each block's rows,
    so equal distances keep the lower index first, then the clamp."""
    vals, idxs = [], []
    for d2 in _plain_blocks(ref, nbr):
        v, i = torch.sort(d2, dim=1, stable=True)
        # copies: a slice would keep the whole sorted block alive
        vals.append(v[:, :k].contiguous())
        idxs.append(i[:, :k].contiguous())
    return torch.cat(vals).clamp_min(0.0), torch.cat(idxs)


def _tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits), to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32`` rounds: on
    the integer view, half an ulp of TF32 added, the 13 low bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_split(x):
    """``(hi, lo)`` of float32 ``x``: ``hi = tf32(x)``, ``lo = tf32(x -
    hi)`` (``x - hi`` is exact), the split the wide scans' pre-pass makes;
    ``|x - hi - lo| <= 2^-22 |x|``."""
    hi = _tf32_round(x)
    return hi, _tf32_round(x - hi)


# coordinates a stage of the tensor-core scans holds, and a fresh sum
# (csrc/knn.cu:kTcChunk, kBlockDim)
_TC_CHUNK, _TC_BLOCK = 64, 32


def _tc_blocks(D):
    """The blocks ``[k0, k1)`` of coordinates whose products the wide
    scans sum fresh: 32 at a time within each chunk of 64 (padded to a
    multiple of 8), 40 where 8 are left, clipped to D
    (``csrc/knn.cu:block_end``)."""
    Dp = -(-D // 8) * 8
    out = []
    for c0 in range(0, Dp, _TC_CHUNK):
        kc, k0 = min(_TC_CHUNK, Dp - c0), 0
        while k0 < kc:
            k1 = kc if kc - k0 <= _TC_BLOCK + 8 else k0 + _TC_BLOCK
            if c0 + k0 < D:
                out.append((c0 + k0, min(D, c0 + k1)))
            k0 = k1
    return out


def _tf32_scores(ref, nbr, passes=3):
    """[R, N] scores ``s = |b|^2 - 2 a.b`` of float32 clouds with the cross
    term in TF32, summed in float32 coordinate by coordinate: three passes
    as the wide scans form it (per block of :func:`_tc_blocks`, a fresh
    sum of the small products ``a_lo b_hi`` and ``a_hi b_lo`` first and
    the big ones ``a_hi b_hi`` last, added to the total; ``s = |b|^2 - 2
    total``), or one (``a_hi b_hi`` alone, in one sum).  Each product of
    two TF32 values is exact in float32; the tensor cores sum a k-step of
    8 in an order of their own, and truncate, so this is the kernels'
    arithmetic up to that order and rounding."""
    (a_hi, a_lo), (b_hi, b_lo) = _tf32_split(ref), _tf32_split(nbr)
    shape = (ref.shape[0], nbr.shape[0])
    total = torch.zeros(shape, dtype=torch.float32)
    if passes == 1:
        for c in range(ref.shape[1]):
            total += a_hi[:, None, c] * b_hi[None, :, c]
        return _sqnorm(nbr)[None, :] - 2.0 * total
    for k0, k1 in _tc_blocks(ref.shape[1]):
        part = a_lo[:, None, k0] * b_hi[None, :, k0]
        for c in range(k0 + 1, k1):
            part += a_lo[:, None, c] * b_hi[None, :, c]
        for c in range(k0, k1):
            part += a_hi[:, None, c] * b_lo[None, :, c]
        for c in range(k0, k1):
            part += a_hi[:, None, c] * b_hi[None, :, c]
        total += part
    return _sqnorm(nbr)[None, :] - 2.0 * total


def _nnk_tf32(ref, nbr, k, passes=3):
    """The wide scans' selection on :func:`_tf32_scores`: the k least s of
    each row by (s, index), then ``d2 = s + |a|^2`` clamped at 0:
    ``(d2 [R, k], idx [R, k] int64)``."""
    s = _tf32_scores(ref, nbr, passes)
    v, i = torch.sort(s, dim=1, stable=True)
    d2 = (v[:, :k] + _sqnorm(ref)[:, None]).clamp_min(0.0)
    return d2, i[:, :k].contiguous()


def _select_scores(ref, nbr):
    """[R, N] scores ``s = |b|^2 - 2 a.b`` in the register-tiled scans'
    order (``|b|^2`` summed from the first coordinate, then ``a_c (-2 b_c)``
    added from the first), each product and sum rounded once: the card
    fuses them (FMA), which this CPU version does not."""
    s = _sqnorm(nbr)[None, :].expand(ref.shape[0], -1)
    for c in range(ref.shape[1]):
        s = s + ref[:, None, c] * (-2.0 * nbr[None, :, c])
    return s


def _select_keys(s):
    """The select path's key of each score (csrc/knn.cu:Sel<T>::key): its
    bits as an order-preserving unsigned integer, every bit flipped where
    s < 0 and the sign bit where s >= 0, after ``s + 0`` (which makes -0
    +0: the (s, index) order holds them equal; +inf sorts last).  int64:
    the 32-bit key of float32, or the 64-bit key's bits of float64."""
    s = s + 0.0
    if s.dtype == torch.float32:
        u = s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    u = s.view(torch.int64)
    return torch.where(u < 0, ~u, u ^ torch.iinfo(torch.int64).min)


def _index_bits(N):
    """Index bits the index digits read: N - 1's, rounded up to 8s
    (csrc/knn.cu:index_bits)."""
    b = 8
    while b < 32 and (N - 1) >> b:
        b += 8
    return b


def _select_rows(s, k, cap=0):
    """The select path's selection on scores ``s`` [R, N], as csrc/knn.cu
    runs it (nothing on the card's path runs this): each row's (key, index)
    pairs are cut digit by digit, 8 bits at a time, the key's (4 digits in
    float32, 8 in float64) then the index's (:func:`_index_bits`): a pass
    counts the digit over the pairs that share the row's prefix and fixes
    the bin where the row's k-th pair falls, until that bin's pairs
    complete the k or number at most ``cap`` (the boundary buffer, whose
    size on the card ``csrc/knn.cu:sel_plan`` sets; 0, the default, cuts
    at the k-th pair exactly).  The pairs before the prefix, and the bin's, are then sorted by
    (key, index) and the first k kept; k = N sorts every pair.  Returns
    (s [R, k], idx [R, k] int64, passes): ``passes`` the counting passes
    that ran."""
    R, N = s.shape
    if not 1 <= k <= N:
        raise ValueError(f'k={k} > number of neighbors {N}')
    key = _select_keys(s)
    kd = 4 if s.dtype == torch.float32 else 8
    ibits = _index_bits(N)
    j = torch.arange(N).expand(R, N)
    digits = ([(key >> (8 * (kd - 1 - d))) & 255 for d in range(kd)]
              + [(j >> (ibits - 8 * (d + 1))) & 255
                 for d in range(ibits // 8)])
    rows = torch.arange(R)
    below = torch.zeros(R, dtype=torch.int64)
    in_bin = torch.ones((R, N), dtype=torch.bool)   # shares the prefix
    before = torch.zeros((R, N), dtype=torch.bool)  # comes before it
    done = torch.full((R,), k == N or N <= cap)
    passes = 0
    for dig in digits:
        if bool(done.all()):
            break
        passes += 1
        live = ~done
        hist = torch.zeros((R, 256), dtype=torch.int64)
        hist.scatter_add_(1, dig, (in_bin & live[:, None]).long())
        cum = hist.cumsum(1)
        need = k - below
        pick = torch.argmax((cum >= need[:, None]).long(), dim=1)
        count = hist[rows, pick]
        below = torch.where(live, below + cum[rows, pick] - count, below)
        before |= live[:, None] & in_bin & (dig < pick[:, None])
        in_bin &= ~live[:, None] | (dig == pick[:, None])
        done |= (below + count == k) | (count <= cap)
    take = before | in_bin   # the emitted pairs: before, and the bin's
    order_key = key if kd == 4 else key ^ torch.iinfo(torch.int64).min
    order_key = torch.where(take, order_key, torch.iinfo(torch.int64).max)
    # (key, index) order: indices ascend, then a stable sort by key
    _, i = torch.sort(order_key, dim=1, stable=True)
    i = i[:, :k].contiguous()
    return s.gather(1, i), i, passes


def _nnk_select(ref, nbr, k, cap=0):
    """CPU emulation of nnk's select-then-sort path: :func:`_select_rows`
    on :func:`_select_scores` (the register-tiled family's scores, and the
    float64 wide family's: its passes on the card form the same s on the
    FP64 tensor cores, in another rounding order) or, for float32 clouds
    of more than 8 coordinates, :func:`_tf32_scores` (the wide family's
    three-pass TF32 scores), then ``d2 = s + |a|^2`` clamped at 0:
    ``(d2 [R, k], idx [R, k] int64)``."""
    wide = ref.shape[1] > 8 and ref.dtype == torch.float32
    s = _tf32_scores(ref, nbr) if wide else _select_scores(ref, nbr)
    v, i, _ = _select_rows(s, k, cap)
    return (v + _sqnorm(ref)[:, None]).clamp_min(0.0), i


# ---------------------------------------------------------------------------
# the kernels' wrapper
# ---------------------------------------------------------------------------

def _check(ref, nbr):
    if ref.ndim != 2 or nbr.ndim != 2 or ref.shape[1] != nbr.shape[1]:
        raise ValueError(f'ref {tuple(ref.shape)} and nbr '
                         f'{tuple(nbr.shape)} must be [R, D] and [N, D]')
    if nbr.shape[0] == 0:
        raise ValueError('nbr holds no points')
    if ref.device != nbr.device:
        raise ValueError(f'ref is on {ref.device}, nbr on {nbr.device}')


def _check_cuda(ref, nbr):
    if ref.device.type != 'cuda':
        raise ValueError(f'unsupported device {ref.device}')
    for name, a in (('ref', ref), ('nbr', nbr)):
        if a.dtype not in _DTYPES or a.dtype != ref.dtype:
            raise TypeError(f'ref is {ref.dtype} and nbr {nbr.dtype}; the '
                            'knn kernels take two float32 or two float64 '
                            'clouds')
        if not a.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if ref.shape[1] < 1:
        raise ValueError('the knn kernels take points of at least one '
                         'coordinate')


def _stream(a):
    return torch.cuda.current_stream(a.device).cuda_stream


def _scratch(lib, ref, R, N, D, k, f64):
    """The float32 scratch of the wide merge scans on the tensor cores at
    k (1 for nn1), or of the warp merge scan past k = 16 (its neighbours
    staged once a call); None where the kernels need none."""
    floats = ctypes.c_longlong()
    raise_on(lib, lib.ppt_knn_scratch(R, N, D, k, f64, ctypes.byref(floats)),
             'knn scratch')
    if not floats.value:
        return None
    return torch.empty((floats.value,), dtype=torch.float32,
                       device=ref.device)


def _ptr(a):
    return None if a is None else a.data_ptr()


def _launch_nn1(ref, nbr):
    """One launch of csrc/knn.cu's nn1 (its scan and merge passes; in
    float32 past 8 coordinates the split pre-pass first): (d2 [R], idx [R]
    int64)."""
    global NN1_LAUNCHES
    _check_cuda(ref, nbr)
    (R, D), N = ref.shape, nbr.shape[0]
    f64 = int(ref.dtype == torch.float64)
    d2 = torch.empty((R,), dtype=ref.dtype, device=ref.device)
    idx = torch.empty((R,), dtype=torch.int64, device=ref.device)
    if R == 0:
        return d2, idx
    lib = _kernel_lib()
    with torch.cuda.device(ref.device):
        splits = lib.ppt_nn1_splits(R, N, D, f64)
        if splits < 1:
            raise RuntimeError(f'nn1: no split of {N} neighbours for {R} '
                               'rows (device query failed)')
        part_s = torch.empty((splits, R), dtype=ref.dtype,
                             device=ref.device)
        part_i = torch.empty((splits, R), dtype=torch.int32,
                             device=ref.device)
        scratch = _scratch(lib, ref, R, N, D, 1, f64)
        raise_on(lib, lib.ppt_nn1(
            ref.data_ptr(), nbr.data_ptr(), R, N, D, f64, splits,
            _ptr(scratch), part_s.data_ptr(), part_i.data_ptr(),
            d2.data_ptr(), idx.data_ptr(), _stream(ref)), 'nn1')
    NN1_LAUNCHES += 1
    return d2, idx


# the kernels' families (csrc/knn.cu:ppt_nnk_family)
_FAMILIES = ('register-tiled', 'register-tiled', 'tensor-core',
             'tensor-core', 'tensor-core-f64', 'tensor-core-f64')


def select_k(dtype, R, D=3):
    """The least k from which :func:`nnk` takes a select-then-sort path
    below k = N for R rows of D coordinates in ``dtype`` (float32 or
    float64): the crossovers that ``probes/knn_probes.py --crossover``
    measures, held in ``csrc/knn.cu`` alone (kSelectK, kSelectK64,
    kSelectKSmallR and kSelectKSmallR64 for the register-tiled family, by
    R; kWideSelectK for
    the float32 wide family, the same at both measured widths;
    kWideSelectK64 and kWideSelectK64Long for the float64 one, by D).
    Builds the library."""
    k = _kernel_lib().ppt_nnk_select_k(R, D, int(dtype == torch.float64))
    if k < 0:
        raise ValueError(f'select_k: invalid R={R}, D={D}')
    return k


def nnk_plan(R, N, D, k, dtype):
    """How :func:`nnk` runs on the current CUDA device for R rows, N
    neighbours of D coordinates and k (float32 or float64): ``route``
    ``'select'`` (a select-then-sort path: at k >= :func:`select_k` or
    k = N) or ``'scan'`` (the threshold scans and their merge);
    ``family`` ``'register-tiled'`` (D <= 8), ``'tensor-core'`` (float32
    past 8 coordinates) or ``'tensor-core-f64'`` (float64 past 8: DMMA);
    ``select_k``; the ``splits`` of the neighbour range; and the bytes the
    wrapper allocates beside the outputs: ``scratch_bytes`` (the select
    path's, with the split clouds in the tensor-core families, the
    tensor-core scans' split clouds, or the register-tiled warp merge
    scan's staged neighbours past k = 16) and ``part_bytes`` (the scans'
    partial lists, ``splits * k * R`` pairs; none where the warp merge
    scan takes one split, which writes its lists' first k itself)."""
    lib = _kernel_lib()
    f64 = int(dtype == torch.float64)
    fam = lib.ppt_nnk_family(R, N, D, k, f64)
    if fam < 0:
        raise ValueError(f'nnk_plan: invalid R={R}, N={N}, D={D}, k={k}')
    info = dict(family=_FAMILIES[fam], select_k=select_k(dtype, R, D))
    sel = ctypes.c_longlong()
    raise_on(lib, lib.ppt_nnk_select_scratch(R, N, D, k, f64,
                                             ctypes.byref(sel)),
             'nnk scratch')
    if sel.value >= 0:
        return dict(route='select', splits=1, scratch_bytes=sel.value,
                    part_bytes=0, **info)
    splits = lib.ppt_nnk_splits(R, N, D, k, f64)
    if splits < 1:
        raise RuntimeError(f'nnk: no split of {N} neighbours for {R} rows '
                           '(device query failed)')
    floats = ctypes.c_longlong()
    raise_on(lib, lib.ppt_knn_scratch(R, N, D, k, f64, ctypes.byref(floats)),
             'knn scratch')
    one = info['family'] == 'register-tiled' and k > 16 and splits == 1
    return dict(route='scan', splits=splits, scratch_bytes=4 * floats.value,
                part_bytes=0 if one else
                splits * k * R * ((8 if f64 else 4) + 4), **info)


def _launch_nnk(ref, nbr, k):
    """One launch of csrc/knn.cu's nnk (the select path's passes and
    sort, or the threshold scan and its merge; :func:`nnk_plan`): (d2 [R,
    k], idx [R, k] int64)."""
    global NNK_LAUNCHES
    _check_cuda(ref, nbr)
    (R, D), N = ref.shape, nbr.shape[0]
    f64 = int(ref.dtype == torch.float64)
    d2 = torch.empty((R, k), dtype=ref.dtype, device=ref.device)
    idx = torch.empty((R, k), dtype=torch.int64, device=ref.device)
    if R == 0:
        return d2, idx
    lib = _kernel_lib()
    with torch.cuda.device(ref.device):
        plan = nnk_plan(R, N, D, k, ref.dtype)
        part_s = part_i = scratch = None
        if plan['part_bytes']:
            part_s = torch.empty((plan['splits'], k, R), dtype=ref.dtype,
                                 device=ref.device)
            part_i = torch.empty((plan['splits'], k, R), dtype=torch.int32,
                                 device=ref.device)
        if plan['scratch_bytes']:
            scratch = torch.empty((plan['scratch_bytes'],),
                                  dtype=torch.uint8, device=ref.device)
        raise_on(lib, lib.ppt_nnk(
            ref.data_ptr(), nbr.data_ptr(), R, N, D, k, f64, plan['splits'],
            _ptr(scratch), _ptr(part_s), _ptr(part_i), d2.data_ptr(),
            idx.data_ptr(), _stream(ref)), 'nnk')
    NNK_LAUNCHES += 1
    return d2, idx


def _nnk_wide_merge(ref, nbr, k):
    """The wide families' merge scan at any ``1 <= k <= N``, whatever
    :func:`select_k` says (the tensor-core scans, float32 in three-pass
    TF32, float64 on DMMA; lists merged past k = 16): what ``chip_smoke.py``, the card tests and
    ``probes/knn_probes.py --crossover`` hold the wide select paths to,
    bit for bit (both rank the same s).  CUDA clouds of more than 8
    coordinates; counted in ``NNK_LAUNCHES``.  Nothing on :func:`nnk`'s
    path calls it."""
    global NNK_LAUNCHES
    _check(ref, nbr)
    _check_cuda(ref, nbr)
    (R, D), N = ref.shape, nbr.shape[0]
    if D <= 8 or not 1 <= k <= N or R == 0:
        raise ValueError(f'the wide merge scan takes clouds of more than 8 '
                         f'coordinates and 1 <= k <= N: D={D}, k={k}, N={N}, '
                         f'R={R}')
    f64 = int(ref.dtype == torch.float64)
    lib = _kernel_lib()
    with torch.cuda.device(ref.device):
        splits = lib.ppt_nnk_wide_merge_splits(R, N, D, k, f64)
        if splits < 1:
            raise RuntimeError(f'nnk: no split of {N} neighbours for {R} rows '
                               '(device query failed)')
        part_s = torch.empty((splits, k, R), dtype=ref.dtype,
                             device=ref.device)
        part_i = torch.empty((splits, k, R), dtype=torch.int32,
                             device=ref.device)
        scratch = _scratch(lib, ref, R, N, D, k, f64)
        d2 = torch.empty((R, k), dtype=ref.dtype, device=ref.device)
        idx = torch.empty((R, k), dtype=torch.int64, device=ref.device)
        raise_on(lib, lib.ppt_nnk_wide_merge(
            ref.data_ptr(), nbr.data_ptr(), R, N, D, k, f64, splits,
            _ptr(scratch), part_s.data_ptr(), part_i.data_ptr(),
            d2.data_ptr(), idx.data_ptr(), _stream(ref)), 'nnk')
    NNK_LAUNCHES += 1
    return d2, idx


def nn1(ref, nbr):
    """Squared distance to, and index of, the nearest ``nbr`` row of each
    ``ref`` row: ``(d2 [R], idx [R] int64)``.

    CUDA tensors launch the kernel of ``csrc/knn.cu`` on the current
    stream (two float32 or two float64 clouds, contiguous, of any number
    of coordinates: the register-tiled scan up to 8, the wide scan past
    it, on the tensor cores (float64 on DMMA); anything else raises); CPU
    tensors run :func:`_nn1_torch`.  On a near-tie the two may return
    different neighbours (module docstring).
    """
    _check(ref, nbr)
    if ref.device.type == 'cpu':
        return _nn1_torch(ref, nbr)
    return _launch_nn1(ref, nbr)


def nnk(ref, nbr, k):
    """The ``k`` nearest ``nbr`` rows of each ``ref`` row, ascending by
    (distance, index): ``(d2 [R, k], idx [R, k] int64)``.  ``k = 1`` is
    :func:`nn1`; ``k`` above the number of neighbours raises.

    CUDA tensors launch the kernel of ``csrc/knn.cu`` (as :func:`nn1`, at
    any ``k``: past 16 the lists leave the registers, and from
    ``k = select_k(dtype, R, D)`` on, and at ``k = N``, it selects, then
    sorts; :func:`nnk_plan`);
    CPU tensors run :func:`_nnk_torch`.  On a near-tie the two may return different
    neighbours (module docstring).
    """
    if k == 1:
        d2, idx = nn1(ref, nbr)
        return d2[:, None], idx[:, None]
    _check(ref, nbr)
    if k > nbr.shape[0]:
        raise ValueError(f'k={k} > number of neighbors {nbr.shape[0]}')
    if ref.device.type == 'cpu':
        return _nnk_torch(ref, nbr, k)
    return _launch_nnk(ref, nbr, k)
