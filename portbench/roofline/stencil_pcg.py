"""The work of one block-Jacobi PCG solve on a circulant block stencil,
counted from its shapes and the iterations it ran, whatever kernel runs
it: N nodes of block size t, n_off coupling offsets, float32.

Per node and iteration: the matvec (the diagonal block and, for each
offset, C_k x_{n+d} and C_k^T x_n: (1 + 2 n_off) t^2 multiply-adds), the
preconditioner apply (t^2), three dot products (p.Ap, r.z, r.r: 3t) and
three vector updates (x, r, p: 3t); two operations a multiply-add.  Bytes:
each input (b, the diagonal blocks A, the preconditioner Minv, the n_off
coupling channels) read once and x written once, 4 bytes a float.
"""


def work(N, t, n_off, iterations):
    """(floating-point operations, bytes) of one solve."""
    flops = 2 * iterations * N * ((2 + 2 * n_off) * t * t + 6 * t)
    nbytes = 4 * N * (2 * t + (2 + n_off) * t * t)
    return flops, nbytes


def least_seconds(N, t, n_off, iterations, peaks):
    """The least time the card could take for the solve: the larger of
    its operations at the float32 peak and its bytes at the memory
    peak."""
    flops, nbytes = work(N, t, n_off, iterations)
    return max(flops / peaks['fp32_flop_per_s'],
               nbytes / peaks['hbm_bytes_per_s'])
