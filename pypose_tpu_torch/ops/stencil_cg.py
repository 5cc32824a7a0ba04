r"""Whole-solve block-Jacobi PCG for stencil-form normal equations.

Counterpart of ``pypose_tpu/ops/pallas_cg.py:36-128, 447-514``.  The
Pallas kernel there (``_kernel``) becomes the hand-written CUDA kernel
``csrc/stencil_cg.cu``, launched by :func:`stencil_cg_transposed` for
CUDA tensors.  Its plain PyTorch version, :func:`_cg_body_torch`, is the
same algorithm step for step; it runs for CPU tensors and is what tests
and ``chip_smoke.py`` compare the kernel with.  On CUDA the wrapper
launches the kernel or raises: it never falls back to the plain version.

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

from ._build import load

# Launches of the CUDA kernel in this process (one per solve on the card).
LAUNCHES = 0

# The instantiated block size; StencilSpMV refuses more than 16 offsets.
KERNEL_T = 6
MAX_OFFSETS = 16

# L2 budget for the kernel's operands and state.  The single-block kernel
# is bounded by L2 bandwidth only while everything stays resident in the
# H100's 50 MB L2; half of it leaves room for the rest of the LM step's
# tensors.  Past it the one SM would stream from HBM: that size needs the
# multi-SM or tiled kernels of the large-graph slice.
L2_BUDGET_BYTES = 25 * 10 ** 6


def stencil_cg_fits(N, t, n_off):
    """True when the kernel's operands (b, A, Minv, C), its output x and
    its scratch (r, z, p, Ap) fit the L2 budget."""
    n_floats = N * (t + 2 * t * t + n_off * t * t + t + 4 * t)
    return 4 * n_floats <= L2_BUDGET_BYTES


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


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

@functools.cache
def _kernel_lib():
    lib = load('stencil_cg')
    fn = lib.ppt_stencil_pcg
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_double]
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    lib.ppt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ppt_cuda_error_string.restype = ctypes.c_char_p
    return lib


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


def stencil_cg_transposed(b_T, A_T, Minv_T, C_T, offsets, t, maxiter, tol):
    """Solve ``A x = b`` in the lane-major layout.

    Returns ``(x_T [t, N], iterations)`` with the iteration count as a
    0-d int32 tensor on the operands' device.  CUDA tensors go through the
    kernel (float32, contiguous, t = 6, at most 16 offsets; anything else
    raises), launched on the current stream without synchronising; CPU
    tensors run :func:`_cg_body_torch`.
    """
    global LAUNCHES
    offsets = tuple(int(d) for d in offsets)
    _check_operands(b_T, A_T, Minv_T, C_T, offsets, t)
    if b_T.device.type == 'cpu':
        return _cg_body_torch(A_T, Minv_T, C_T, b_T, offsets, t, maxiter,
                              tol)
    if b_T.device.type != 'cuda':
        raise ValueError(f'unsupported device {b_T.device}')
    for name, a in (('b_T', b_T), ('A_T', A_T), ('Minv_T', Minv_T),
                    ('C_T', C_T)):
        if a.dtype != torch.float32:
            raise TypeError(f'{name} is {a.dtype}; the CUDA kernel takes '
                            'float32 only')
        if not a.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if t != KERNEL_T:
        raise ValueError(f'the CUDA kernel is instantiated for t={KERNEL_T}'
                         f', got t={t}')
    if len(offsets) > MAX_OFFSETS:
        raise ValueError(f'{len(offsets)} offsets > {MAX_OFFSETS}')
    N = b_T.shape[1]
    offs = (ctypes.c_int * max(len(offsets), 1))(*(d % N for d in offsets))
    x = torch.empty_like(b_T)
    scratch = torch.empty((4, t, N), dtype=torch.float32, device=b_T.device)
    it = torch.empty((1,), dtype=torch.int32, device=b_T.device)
    lib = _kernel_lib()
    with torch.cuda.device(b_T.device):
        stream = torch.cuda.current_stream(b_T.device).cuda_stream
        rc = lib.ppt_stencil_pcg(
            t, b_T.data_ptr(), A_T.data_ptr(), Minv_T.data_ptr(),
            C_T.data_ptr(), offs, len(offsets), N, int(maxiter), float(tol),
            x.data_ptr(), scratch.data_ptr(), it.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError('stencil_pcg launch failed: '
                           + lib.ppt_cuda_error_string(rc).decode())
    LAUNCHES += 1
    return x, it[0]


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
    """
    operands = fold_operands(b, Ablk, dcorr, Minv, C, offsets, fixed_mask)
    x_T, it = stencil_cg_transposed(*operands, offsets, b.shape[1], maxiter,
                                    tol)
    return x_T.T, it
