r"""Block-Jacobi PCG for stencil-form normal equations: three solvers.

Counterpart of ``pypose_tpu/ops/pallas_cg.py``.  Each Pallas kernel there
becomes a hand-written CUDA kernel, launched for CUDA tensors by its
wrapper here; beside each wrapper is its plain PyTorch version, the same
algorithm step for step, which runs for CPU tensors and is what tests and
``chip_smoke.py`` compare the kernel with.  On CUDA a wrapper launches its
kernel or raises: it never falls back to the plain version.

- :func:`stencil_cg_transposed` (``pallas_cg.py:36-128``): the whole
  solve in one launch of ``csrc/stencil_cg.cu``, a cluster of 16 CTAs
  exchanging their state through distributed shared memory; plain version
  :func:`_cg_body_torch`.  For systems within its budgets
  (:func:`stencil_cg_fits`, :func:`stencil_cg_smem_fits`).
- :func:`stencil_cg_fused` (``pallas_cg.py:253-444``): Chronopoulos-Gear
  PCG, the whole solve in one persistent cooperative launch of
  ``csrc/stencil_cg_fused.cu`` over all SMs, operands in float32 or bf16;
  plain version :func:`_fused_cg_torch`.  Past the budget
  :func:`stencil_cg` routes here, with float32 operands.
- :func:`stencil_cg_tiled` (``pallas_cg.py:131-250``): per iteration one
  matvec and one block-Jacobi launch of ``csrc/stencil_cg_tiled.cu``, the
  CG state in torch ops; plain version :func:`_tiled_cg_torch`.  Nothing
  routes to it.

The Pallas kernels take the block size t as a static argument; the CUDA
kernels are templates on it, built for :data:`KERNEL_T` (3, 4, 6, 7: the
tangent dimensions of SO3, RxSO3, SE3 and Sim3).  Any other t raises on
CUDA tensors; the plain versions take any t.

Matvec (see ``ops/spmv.py``):

    A x = Ablk x + sum_k [ C_k . roll(x, -d_k) + roll(C_k^T . x, +d_k) ]

Layouts (lane-major, node index last):
    vectors   [t, N]
    blocks    [t*t, N]        (row-major block entry (i, u) at row i*t+u)
    channels  [n_off*t*t, N]

:func:`stencil_cg` folds gauge fixing (identity blocks and zeroed
channels at fixed nodes) and the LM diagonal correction into the
operands, so the solver sees an unconstrained SPD system.
"""

import ctypes
import functools

import torch

from ._build import bind, raise_on as _raise_on

# Launches of each CUDA kernel in this process: the whole-solve kernel and
# the fused solver (one per solve each), the tiled matvec and block-Jacobi
# apply (one each per CG iteration).
LAUNCHES = 0
FUSED_LAUNCHES = 0
TILED_MV_LAUNCHES = 0
TILED_PC_LAUNCHES = 0

# The tiled solver queues this many iterations between host reads of its
# stop flag; a stopped solve makes the extra ones no-ops.
CHECK_EVERY = 8

# The block sizes the kernels are instantiated for (the tangent dimensions
# of SO3, RxSO3, SE3 and Sim3); StencilSpMV refuses more than 16 offsets.
KERNEL_T = frozenset({3, 4, 6, 7})
MAX_OFFSETS = 16

# Budgets of the whole-solve kernel (csrc/stencil_cg.cu), one cluster of
# CLUSTER CTAs on an H100.  Its operands stay resident in the 50 MB L2
# within L2_BUDGET_BYTES (half of it leaves room for the rest of the LM
# step's tensors); past it they would stream from HBM on 16 SMs, so larger
# systems take the fused solver, whose grid spans all SMs.  Each CTA's
# shared memory holds at most SMEM_PER_BLOCK bytes (227 KB, the opt-in
# limit), of which _HEADER_FLOATS floats are reduction slots.
L2_BUDGET_BYTES = 25 * 10 ** 6
CLUSTER = 16
SMEM_PER_BLOCK = 232_448
_HEADER_FLOATS = 128


def _cta_nodes(N):
    """Nodes each CTA of the cluster owns (the last ones may own fewer)."""
    return -(-N // CLUSTER)


def stencil_cg_smem_fits(N, t, n_off):
    """True when the whole-solve kernel keeps its operands in shared
    memory: per CTA, 4 * (128 + NL * (5t + 2 n_off t + 2tt + n_off tt))
    bytes <= 232,448, NL = ceil(N / 16); a node's vectors p, r, x, z, Ap
    (5t floats), the p at n + d_k and q_k at n - d_k that other CTAs push
    to it (2 n_off t), A and Minv (2tt) and its channels (n_off tt).
    sphere2500 (t = 6, 2 offsets): NL = 157, 198 floats a node, 124,856
    bytes."""
    per_node = 5 * t + 2 * n_off * t + 2 * t * t + n_off * t * t
    return 4 * (_HEADER_FLOATS + _cta_nodes(N) * per_node) <= SMEM_PER_BLOCK


def stencil_cg_fits(N, t, n_off):
    """True when :func:`stencil_cg` takes the whole-solve kernel; where
    False, the fused solver (an error nowhere).  Two sums must hold:

    - L2: 4 N (t + 2tt + n_off tt + t + 2t) bytes <= 25e6, the operands
      b, A, Minv, C, the output x and the scratch z, Ap (t = 6, 2 offsets:
      168 floats a node, so N <= 37,202);
    - shared memory, with the operands in L2: 4 * (128 + NL (2t + n_off t))
      bytes <= 232,448 per CTA, NL = ceil(N / 16), for p, r and q_k (2
      offsets: 24 floats a node, NL <= 2,416).

    Within it, :func:`stencil_cg_smem_fits` says whether the operands go to
    shared memory as well."""
    l2 = 4 * N * (t + 2 * t * t + n_off * t * t + t + 2 * t)
    state = 4 * (_HEADER_FLOATS + _cta_nodes(N) * (2 * t + n_off * t))
    return l2 <= L2_BUDGET_BYTES and state <= SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _block_mul(M_T, v, t, transpose=False):
    """[t*t, N] block-diagonal times [t, N]: y_i = sum_u M[i, u] v_u."""
    M = M_T.reshape(t, t, -1)
    if transpose:
        M = M.transpose(0, 1)
    return (M * v.unsqueeze(0)).sum(1)


def _stencil_matvec_torch(A_T, C_T, offsets, t, p):
    y = _block_mul(A_T, p, t)
    tt = t * t
    for k, d in enumerate(offsets):
        Ck = C_T[k * tt:(k + 1) * tt]
        y = y + _block_mul(Ck, torch.roll(p, -d, dims=1), t)      # x_{n+d}
        back = _block_mul(Ck, p, t, transpose=True)              # C^T x at n
        y = y + torch.roll(back, d, dims=1)                      # to n+d
    return y


def _cg_body_torch(A_T, Minv_T, C_T, b, offsets, t, maxiter, tol):
    """The CG algorithm of ``pallas_cg.py:_cg_body``, step for step.
    Reads |r|^2 on the host once per iteration for the stop test."""
    x = torch.zeros_like(b)
    r = b
    z = _block_mul(Minv_T, r, t)
    gamma = torch.sum(r * z)
    bnorm2 = torch.sum(b * b)
    tol2 = (tol * tol) * bnorm2
    p = z
    it = 0
    while it < maxiter and bool(torch.sum(r * r) > tol2):
        Ap = _stencil_matvec_torch(A_T, C_T, offsets, t, p)
        denom = torch.sum(p * Ap)
        alpha = gamma / torch.where(denom == 0, 1e-31, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = _block_mul(Minv_T, r, t)
        gamma_new = torch.sum(r * z)
        beta = gamma_new / torch.where(gamma == 0, 1e-31, gamma)
        p = z + beta * p
        gamma = gamma_new
        it += 1
    return x, torch.tensor(it, dtype=torch.int32, device=b.device)


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _tiled_cg(matvec, precond, b, maxiter, tol):
    """The CG iteration of ``pallas_cg.py:225-249`` around a matvec and a
    preconditioner apply, with the ``while_loop``'s stop test on the
    device: an ``active`` flag (|r|^2 > tol^2 |b|^2) zeroes alpha and
    freezes the state once the solve is done and counts the iterations, so
    the host reads it only every :data:`CHECK_EVERY` iterations.  Returns
    the same x and count as the ``while_loop``."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    gamma = _dot(r, z)
    rr = _dot(b, b)
    tol2 = (tol * tol) * rr
    p = z
    it = torch.zeros((), dtype=torch.int32, device=b.device)
    done = 0
    while done < maxiter and bool(rr > tol2):
        for _ in range(min(CHECK_EVERY, maxiter - done)):
            active = rr > tol2
            Ap = matvec(p)
            denom = _dot(p, Ap)
            alpha = torch.where(
                active, gamma / torch.where(denom == 0, 1e-31, denom), 0.0)
            x = torch.addcmul(x, alpha, p)
            r = torch.addcmul(r, alpha, Ap, value=-1)
            z = precond(r)
            gamma_new = _dot(r, z)
            beta = gamma_new / torch.where(gamma == 0, 1e-31, gamma)
            p = torch.where(active, torch.addcmul(z, beta, p), p)
            gamma = torch.where(active, gamma_new, gamma)
            rr = torch.where(active, _dot(r, r), rr)
            it = it + active
            done += 1
    return x, it


def _tiled_cg_torch(A_T, Minv_T, C_T, b, offsets, t, maxiter, tol):
    """Plain version of :func:`stencil_cg_tiled`: :func:`_tiled_cg` with
    the plain matvec and block-Jacobi apply."""
    return _tiled_cg(
        lambda p: _stencil_matvec_torch(A_T, C_T, offsets, t, p),
        lambda r: _block_mul(Minv_T, r, t), b, maxiter, tol)


def _fused_cg_torch(A_T, Minv_T, C_T, b, offsets, t, maxiter, tol):
    """Plain version of :func:`stencil_cg_fused`: the Chronopoulos-Gear
    recursion of ``pallas_cg.py:408-444`` step for step, the init pass
    (alpha = beta = 0 on zero u, p, s, w) included.  Reads |r|^2 on the
    host once per iteration for the stop test."""

    def axpy(alpha, beta, u, p, s, w, x, r):         # pass 1
        p2 = u + beta * p
        s2 = w + beta * s
        x2 = x + alpha * p2
        r2 = r - alpha * s2
        u2 = _block_mul(Minv_T, r2, t)
        return p2, s2, x2, r2, u2, torch.sum(r2 * u2), torch.sum(r2 * r2)

    def matvec(u):                                   # pass 2
        w = _stencil_matvec_torch(A_T, C_T, offsets, t, u)
        return w, torch.sum(w * u)

    zv = torch.zeros_like(b)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    _, _, x, r, u, gamma, rr = axpy(zero, zero, zv, zv, zv, zv, zv, b)
    w, delta = matvec(u)
    tol2 = (tol * tol) * rr
    p = s = zv
    gamma_pr = alpha_pr = torch.ones((), dtype=b.dtype, device=b.device)
    it = 0
    while it < maxiter and bool(rr > tol2):
        if it == 0:
            beta = zero
            alpha = gamma / torch.where(delta == 0, 1e-31, delta)
        else:
            beta = gamma / torch.where(gamma_pr == 0, 1e-31, gamma_pr)
            den = delta - beta * gamma / torch.where(alpha_pr == 0, 1e-31,
                                                     alpha_pr)
            alpha = gamma / torch.where(den == 0, 1e-31, den)
        p, s, x, r, u, gamma_new, rr = axpy(alpha, beta, u, p, s, w, x, r)
        w, delta = matvec(u)
        gamma_pr, alpha_pr, gamma = gamma, alpha, gamma_new
        it += 1
    return x, torch.tensor(it, dtype=torch.int32, device=b.device)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_INT, _PTR, _DBL = ctypes.c_int, ctypes.c_void_p, ctypes.c_double

# argument types of each library's C functions (all return an int)
_SIGNATURES = {
    'stencil_cg': {
        'ppt_stencil_pcg': [_INT] + [_PTR] * 5 + [_INT] * 3 + [_DBL]
        + [_PTR] * 4},
    'stencil_cg_tiled': {
        'ppt_tiled_mv': [_INT, _PTR, _PTR, _PTR, _INT, _INT, _PTR, _PTR,
                         _PTR],
        'ppt_tiled_pc': [_INT, _PTR, _INT, _PTR, _PTR, _PTR]},
    'stencil_cg_fused': {
        'ppt_fused_plan': [_INT, _INT, _PTR],
        'ppt_fused_pcg': [_INT, _INT] + [_PTR] * 5 + [_INT] * 3 + [_DBL]
        + [_PTR] * 6},
}


@functools.cache
def _kernel_lib(name):
    return bind(name, _SIGNATURES[name])


def _check_operands(b_T, A_T, Minv_T, C_T, offsets, t):
    N = b_T.shape[1]
    tt = t * t
    expect = {'b_T': (b_T, (t, N)), 'A_T': (A_T, (tt, N)),
              'Minv_T': (Minv_T, (tt, N)),
              'C_T': (C_T, (len(offsets) * tt, N))}
    for name, (a, shape) in expect.items():
        if a.device != b_T.device:
            raise ValueError(f'{name} is on {a.device}, b_T on {b_T.device}')
        if tuple(a.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(a.shape)}, '
                             f'expected {shape}')


def _check_cuda(b_T, A_T, Minv_T, C_T, offsets, t, operand_dtype=None):
    """What the CUDA kernels take: float32 (the operands A, Minv, C in
    ``operand_dtype`` where the fused solver stores them so), contiguous,
    t in :data:`KERNEL_T`, at most 16 offsets, on a CUDA device."""
    if b_T.device.type != 'cuda':
        raise ValueError(f'unsupported device {b_T.device}')
    for name, a in (('b_T', b_T), ('A_T', A_T), ('Minv_T', Minv_T),
                    ('C_T', C_T)):
        want = torch.float32 if name == 'b_T' or operand_dtype is None \
            else operand_dtype
        if a.dtype != want:
            raise TypeError(f'{name} is {a.dtype}; the CUDA kernels take '
                            f'{want} here')
        if not a.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if t not in KERNEL_T:
        raise ValueError(f'the CUDA kernels are instantiated for t in '
                         f'{sorted(KERNEL_T)}, got t={t}')
    if len(offsets) > MAX_OFFSETS:
        raise ValueError(f'{len(offsets)} offsets > {MAX_OFFSETS}')


def _c_offsets(offsets, N):
    """Offsets as a host int array in [0, N), passed by value into the
    kernels' parameter structs."""
    return (ctypes.c_int * max(len(offsets), 1))(*(d % N for d in offsets))


def _stream(a):
    return torch.cuda.current_stream(a.device).cuda_stream


def stencil_cg_transposed(b_T, A_T, Minv_T, C_T, offsets, t, maxiter, tol):
    """Solve ``A x = b`` in the lane-major layout.

    Returns ``(x_T [t, N], iterations)`` with the iteration count as a
    0-d int32 tensor on the operands' device.  CUDA tensors go through the
    kernel (float32, contiguous, t in :data:`KERNEL_T`, at most 16
    offsets; anything else raises), launched on the current stream without
    synchronising; CPU
    tensors run :func:`_cg_body_torch`.
    """
    global LAUNCHES
    offsets = tuple(int(d) for d in offsets)
    _check_operands(b_T, A_T, Minv_T, C_T, offsets, t)
    if b_T.device.type == 'cpu':
        return _cg_body_torch(A_T, Minv_T, C_T, b_T, offsets, t, maxiter,
                              tol)
    _check_cuda(b_T, A_T, Minv_T, C_T, offsets, t)
    N = b_T.shape[1]
    x = torch.empty_like(b_T)
    scratch = torch.empty((2, t, N), dtype=torch.float32, device=b_T.device)
    it = torch.empty((1,), dtype=torch.int32, device=b_T.device)
    lib = _kernel_lib('stencil_cg')
    with torch.cuda.device(b_T.device):
        rc = lib.ppt_stencil_pcg(
            t, b_T.data_ptr(), A_T.data_ptr(), Minv_T.data_ptr(),
            C_T.data_ptr(), _c_offsets(offsets, N), len(offsets), N,
            int(maxiter), float(tol), x.data_ptr(), scratch.data_ptr(),
            it.data_ptr(), _stream(b_T))
    _raise_on(lib, rc, 'stencil_pcg')
    LAUNCHES += 1
    return x, it[0]


def stencil_cg_tiled(b_T, A_T, Minv_T, C_T, offsets, t, maxiter, tol):
    """Solve ``A x = b`` in the lane-major layout with the operands
    streamed from device memory on every iteration (``pallas_cg.py:
    stencil_cg_tiled``): zero initial guess, stop when |r|^2 <= tol^2
    |b|^2 or at ``maxiter``, 1e-31 division guards.

    Returns ``(x_T [t, N], iterations)``, the count a 0-d int32 tensor on
    the operands' device.  CUDA tensors launch the matvec and
    block-Jacobi kernels of ``csrc/stencil_cg_tiled.cu`` once each per
    iteration (float32, contiguous, t in :data:`KERNEL_T`, at most 16
    offsets; anything else raises), with the CG state in torch ops; CPU
    tensors run
    :func:`_tiled_cg_torch`.
    """
    offsets = tuple(int(d) for d in offsets)
    _check_operands(b_T, A_T, Minv_T, C_T, offsets, t)
    if b_T.device.type == 'cpu':
        return _tiled_cg_torch(A_T, Minv_T, C_T, b_T, offsets, t, maxiter,
                               tol)
    _check_cuda(b_T, A_T, Minv_T, C_T, offsets, t)
    with torch.cuda.device(b_T.device):
        return _tiled_cg(
            lambda p: _tiled_mv_launch(A_T, C_T, p, offsets, t),
            lambda r: _tiled_pc_launch(Minv_T, r, t),
            b_T, maxiter, tol)


def _tiled_mv_launch(A_T, C_T, p, offsets, t):
    """``q = A p``: one launch of the tiled matvec kernel on the current
    stream.  Unchecked (it runs once per CG iteration): takes operands
    :func:`stencil_cg_tiled` has checked (CUDA, float32, contiguous,
    t in :data:`KERNEL_T`)."""
    global TILED_MV_LAUNCHES
    lib = _kernel_lib('stencil_cg_tiled')
    N = p.shape[1]
    q = torch.empty_like(p)
    _raise_on(lib, lib.ppt_tiled_mv(
        t, A_T.data_ptr(), C_T.data_ptr(), _c_offsets(offsets, N),
        len(offsets), N, p.data_ptr(), q.data_ptr(), _stream(p)),
        'tiled_mv')
    TILED_MV_LAUNCHES += 1
    return q


def _tiled_pc_launch(Minv_T, r, t):
    """``z = Minv r``: one launch of the block-Jacobi kernel (operands as
    :func:`_tiled_mv_launch`)."""
    global TILED_PC_LAUNCHES
    lib = _kernel_lib('stencil_cg_tiled')
    z = torch.empty_like(r)
    _raise_on(lib, lib.ppt_tiled_pc(
        t, Minv_T.data_ptr(), r.shape[1], r.data_ptr(), z.data_ptr(),
        _stream(r)), 'tiled_pc')
    TILED_PC_LAUNCHES += 1
    return z


def round_operands(A_T, Minv_T, C_T, operand_dtype):
    """A, Minv and C stored in ``operand_dtype`` (``None``: as they are;
    ``torch.bfloat16``: rounded to nearest even, as ``astype`` rounds in
    ``pallas_cg.py:363-366``)."""
    if operand_dtype is None:
        return A_T, Minv_T, C_T
    if operand_dtype != torch.bfloat16:
        raise ValueError(f'operand_dtype {operand_dtype}: the fused solver '
                         'stores operands as float32 (None) or bfloat16')
    return tuple(a.to(torch.bfloat16) for a in (A_T, Minv_T, C_T))


def fused_plan(N, t, device=None):
    """How the fused kernel lays out a solve of N nodes of block size ``t``
    on a CUDA ``device``: ``{'ctas', 'nodes_per_cta', 'threads', 'smem'}``,
    ``smem`` True where each CTA keeps its state and Minv in shared memory
    (6t + tt floats a node: 72 at t = 6, 91 at t = 7, 27 at t = 3), else
    in global memory."""
    lib = _kernel_lib('stencil_cg_fused')
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        _raise_on(lib, lib.ppt_fused_plan(int(N), int(t), out), 'fused_plan')
    return {'ctas': out[0], 'nodes_per_cta': out[1], 'threads': out[2],
            'smem': bool(out[3])}


def stencil_cg_fused(b_T, A_T, Minv_T, C_T, offsets, t, maxiter, tol,
                     operand_dtype=None):
    """Solve ``A x = b`` in the lane-major layout by Chronopoulos-Gear PCG
    (``pallas_cg.py:stencil_cg_fused``): zero initial guess, stop when
    |r|^2 <= tol^2 |b|^2 or at ``maxiter``, 1e-31 division guards; the
    same answer as :func:`stencil_cg_tiled` up to rounding, with both dot
    products of an iteration taken together.  ``operand_dtype=
    torch.bfloat16`` stores A, Minv and C in bf16 (:func:`round_operands`);
    the arithmetic stays in b's dtype.

    Returns ``(x_T [t, N], iterations)``, the count a 0-d int32 tensor on
    the operands' device.  CUDA tensors go through one launch of
    ``csrc/stencil_cg_fused.cu`` on the current stream, without
    synchronising (b float32; A, Minv, C float32, or bf16 where
    ``operand_dtype`` says so; contiguous, t in :data:`KERNEL_T`, at most
    16 offsets; anything else raises); CPU tensors run :func:`_fused_cg_torch` on the
    stored operands widened back to b's dtype.
    """
    global FUSED_LAUNCHES
    offsets = tuple(int(d) for d in offsets)
    _check_operands(b_T, A_T, Minv_T, C_T, offsets, t)
    A_T, Minv_T, C_T = round_operands(A_T, Minv_T, C_T, operand_dtype)
    if b_T.device.type == 'cpu':
        A_T, Minv_T, C_T = (a.to(b_T.dtype) for a in (A_T, Minv_T, C_T))
        return _fused_cg_torch(A_T, Minv_T, C_T, b_T, offsets, t, maxiter,
                               tol)
    _check_cuda(b_T, A_T, Minv_T, C_T, offsets, t, operand_dtype)
    N = b_T.shape[1]
    dev = b_T.device
    plan = fused_plan(N, t, dev)
    lib = _kernel_lib('stencil_cg_fused')
    x = torch.empty_like(b_T)
    u = torch.empty_like(b_T)
    scratch = torch.empty((0 if plan['smem'] else 4, t, N),
                          dtype=torch.float32, device=dev)
    mail = torch.zeros((2, plan['ctas'], 2), dtype=torch.int64, device=dev)
    it = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ppt_fused_pcg(
            t, int(operand_dtype is not None), b_T.data_ptr(),
            A_T.data_ptr(), Minv_T.data_ptr(), C_T.data_ptr(),
            _c_offsets(offsets, N), len(offsets), N, int(maxiter),
            float(tol), x.data_ptr(), u.data_ptr(), scratch.data_ptr(),
            mail.data_ptr(), it.data_ptr(), _stream(b_T))
    _raise_on(lib, rc, 'fused_pcg')
    FUSED_LAUNCHES += 1
    return x, it


def fold_operands(b, Ablk, dcorr, Minv, C, offsets, fixed_mask=None):
    """Fold gauge fixing and the diagonal correction into the operands and
    transpose them to the lane-major layout; returns (b_T, A_T, Minv_T,
    C_T).  Arguments as :func:`stencil_cg`."""
    N, t = b.shape
    n_off = C.shape[0]
    eye = torch.eye(t, dtype=b.dtype, device=b.device)
    if fixed_mask is not None:
        m = (~fixed_mask).to(b.dtype)
        b = b * m[:, None]
        dcorr = dcorr * m[:, None]
        keep = m[:, None, None] > 0
        Ablk = torch.where(keep, Ablk, eye)
        Minv = torch.where(keep, Minv, eye)
        C = torch.stack([C[k] * (m * torch.roll(m, -d))[:, None, None]
                         for k, d in enumerate(offsets)])
    Ablk = Ablk + dcorr[..., None] * eye
    return (b.T.contiguous(),
            Ablk.permute(1, 2, 0).reshape(t * t, N).contiguous(),
            Minv.permute(1, 2, 0).reshape(t * t, N).contiguous(),
            C.permute(0, 2, 3, 1).reshape(n_off * t * t, N).contiguous())


def stencil_cg(b, Ablk, dcorr, Minv, C, offsets, fixed_mask=None,
               maxiter=100, tol=1e-5):
    r"""Preconditioned CG on stencil-form normal equations.

    Args:
        b: [N, t] right-hand side.
        Ablk: [N, t, t] undamped diagonal blocks of J^T W J.
        dcorr: [N, t] per-coordinate diagonal correction (the LM
            clamp/damp term ``diagA - diag_raw + damping * diagA``).
        Minv: [N, t, t] block-Jacobi preconditioner (inverted damped
            blocks).
        C: [n_off, N, t, t] coupling channels (StencilSpMV.precompute).
        offsets: tuple of circular offsets.
        fixed_mask: optional bool [N]; fixed nodes are pinned to zero.
    Returns (x [N, t], iterations).

    Systems within the L2 budget (:func:`stencil_cg_fits`) take the
    whole-solve kernel, larger ones the fused solver with float32
    operands, on every device.
    """
    N, t = b.shape
    solve = stencil_cg_transposed if stencil_cg_fits(N, t, C.shape[0]) \
        else stencil_cg_fused
    operands = fold_operands(b, Ablk, dcorr, Minv, C, offsets, fixed_mask)
    x_T, it = solve(*operands, offsets, t, maxiter, tol)
    return x_T.T, it
