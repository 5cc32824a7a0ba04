r"""Block-sparse matrices: BSR x BSC products and the BSR matvec.

Counterpart of ``pypose_tpu/sparse/ops.py:18-127``.  The index metadata
(``crow_indices``, ``col_indices``, ...) are numpy arrays on the host;
the block values are a ``[nnzb, bh, bw]`` tensor on the card, on the
input tensor's device, or on ``device``.  ``bsr_bsc_matmul`` lists the
block pairs on the host (the JAX package's pair order, built with
vectorized numpy in place of its Python loop), then on the values'
device gathers, multiplies and sums.  Every sum over pairs or over a
row's blocks is a fixed-order gather and sum (:func:`_segment_plan`:
tiles of ``SEGMENT_TILE`` entries, then tiles of the tiles' partials),
never an ``index_add_``: two runs on one device give the same bits.
"""

from collections import namedtuple

import numpy as np
import torch

# values: [nnzb, bh, bw]; the indices are numpy metadata
BSR = namedtuple('BSR', ['crow_indices', 'col_indices', 'values', 'shape'])
BSC = namedtuple('BSC', ['ccol_indices', 'row_indices', 'values', 'shape'])

SEGMENT_TILE = 16


def _blocks(dense, blocksize, device):
    """(the ``[nbr, nbc, bh, bw]`` blocks as a tensor, the nonzero block
    mask as numpy)."""
    if torch.is_tensor(dense):
        host = dense.detach().cpu().numpy()
        t = dense if device is None else dense.to(device)
    else:
        host = np.asarray(dense)
        t = torch.as_tensor(host, device='cuda' if device is None
                            else device)
    H, W = host.shape
    bh, bw = blocksize
    assert H % bh == 0 and W % bw == 0
    nbr, nbc = H // bh, W // bw
    nz = ~(host.reshape(nbr, bh, nbc, bw) == 0).all(axis=(1, 3))
    return t.reshape(nbr, bh, nbc, bw).permute(0, 2, 1, 3), nz


def dense_to_bsr(dense, blocksize, device=None):
    """A dense ``[H, W]`` matrix (tensor or numpy) as BSR, all-zero blocks
    dropped.  The values go on ``device``: by default the tensor's own,
    the card for a numpy array."""
    blocks, nz = _blocks(dense, blocksize, device)
    rows, cols = np.nonzero(nz)
    crow = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=nz.shape[0]))]).astype(np.int64)
    values = blocks[torch.as_tensor(rows, device=blocks.device),
                    torch.as_tensor(cols, device=blocks.device)]
    return BSR(crow, cols.astype(np.int64), values, tuple(dense.shape))


def dense_to_bsc(dense, blocksize, device=None):
    """A dense ``[H, W]`` matrix as BSC (blocks ordered by column, then
    row), all-zero blocks dropped; values placed as :func:`dense_to_bsr`
    places them."""
    blocks, nz = _blocks(dense, blocksize, device)
    rows, cols = np.nonzero(nz)
    order = np.lexsort((rows, cols))
    rows, cols = rows[order], cols[order]
    ccol = np.concatenate([[0], np.cumsum(np.bincount(
        cols, minlength=nz.shape[1]))]).astype(np.int64)
    values = blocks[torch.as_tensor(rows, device=blocks.device),
                    torch.as_tensor(cols, device=blocks.device)]
    return BSC(ccol, rows.astype(np.int64), values, tuple(dense.shape))


def bsr_to_dense(bsr):
    nnzb, bh, bw = bsr.values.shape
    H, W = bsr.shape
    nbr, nbc = H // bh, W // bw
    dev = bsr.values.device
    rows = np.repeat(np.arange(nbr), np.diff(bsr.crow_indices))
    out = bsr.values.new_zeros((nbr, nbc, bh, bw))
    out[torch.as_tensor(rows, device=dev),
        torch.as_tensor(bsr.col_indices, device=dev)] = bsr.values
    return out.permute(0, 2, 1, 3).reshape(H, W)


def _segment_plan(seg):
    """A fixed-order sum of items by segment id ``seg`` (numpy, one per
    item): (tables, items, segments).  Each table ``[chunks,
    SEGMENT_TILE]`` sums up to ``SEGMENT_TILE`` entries of one segment,
    in list order, from the previous level (the items, then the
    partials), its padding pointing at an appended zero row; after the last table each segment has one
    partial, ``items`` its row, ``segments`` its id (ascending)."""
    seg = np.asarray(seg, dtype=np.int64)
    items = np.argsort(seg, kind='stable')
    s = seg[items]
    tables = []
    while True:
        ids, start, counts = np.unique(s, return_index=True,
                                       return_counts=True)
        if not len(counts) or counts.max() <= 1:
            return tables, items, ids
        chunks = -(-counts // SEGMENT_TILE)
        pos = np.arange(len(s)) - np.repeat(start, counts)
        chunk = np.repeat(np.cumsum(chunks) - chunks, counts) \
            + pos // SEGMENT_TILE
        n_prev = len(s) if not tables else tables[-1].shape[0]
        table = np.full((int(chunks.sum()), SEGMENT_TILE), n_prev,
                        dtype=np.int64)
        table[chunk, pos % SEGMENT_TILE] = items
        tables.append(table)
        s = np.repeat(ids, chunks)
        items = np.arange(len(s))


def _segment_sum(x, plan):
    """Run a :func:`_segment_plan` over the rows of ``x``: (one sum per
    segment, in the order of the plan's segment ids)."""
    tables, items, _ = plan
    dev = x.device
    for table in tables:
        x = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        x = x[torch.as_tensor(table, device=dev)].sum(dim=1)
    return x[torch.as_tensor(items, device=dev)]


def bsr_bsc_pairs(bsr, bsc):
    """The block pairs of ``bsr @ bsc`` in the JAX package's order (each
    A block (i, k), in storage order, with the B blocks (k, j) in theirs):
    (A block indices, B block indices, output block ``i * nbc + j``), as
    numpy int64."""
    bh, bk = bsr.values.shape[1:]
    bw = bsc.values.shape[2]
    nbr, nbc, nbk = bsr.shape[0] // bh, bsc.shape[1] // bw, \
        bsc.shape[0] // bk
    a_rows = np.repeat(np.arange(nbr), np.diff(bsr.crow_indices))
    b_cols = np.repeat(np.arange(nbc), np.diff(bsc.ccol_indices))
    row_b = np.asarray(bsc.row_indices, dtype=np.int64)
    col_a = np.asarray(bsr.col_indices, dtype=np.int64)
    order_b = np.argsort(row_b, kind='stable')
    cnt_b = np.bincount(row_b, minlength=nbk)
    start_b = np.cumsum(cnt_b) - cnt_b
    n = cnt_b[col_a]
    ai = np.repeat(np.arange(len(col_a)), n)
    local = np.arange(len(ai)) - np.repeat(np.cumsum(n) - n, n)
    bi = order_b[np.repeat(start_b[col_a], n) + local]
    return ai, bi, a_rows[ai] * nbc + b_cols[bi]


def _block_mm(A, B):
    """``A @ B`` over ``[n, bh, bk] x [n, bk, bw]`` as a fixed sum over k
    of broadcast products (no TF32, no library reduction order)."""
    out = A[:, :, 0, None] * B[:, None, 0, :]
    for k in range(1, A.shape[2]):
        out = out + A[:, :, k, None] * B[:, None, k, :]
    return out


def bsr_bsc_matmul(bsr, bsc):
    """Block CSR x block CSC -> the dense product, on the values' device.

    The pair list and the summation plan are built on the host from the
    patterns; on the device it is one gather of each side, the blocks'
    products and the fixed-order sums of :func:`_segment_sum`.

    Example:
        >>> import numpy as np
        >>> from pypose_tpu_torch.sparse import (dense_to_bsr, dense_to_bsc,
        ...                                      bsr_bsc_matmul)
        >>> A = np.kron(np.eye(2), np.ones((2, 2)))
        >>> out = bsr_bsc_matmul(dense_to_bsr(A, (2, 2), device='cpu'),
        ...                      dense_to_bsc(A, (2, 2), device='cpu'))
        >>> bool((out.numpy() == A @ A).all())
        True
    """
    assert bsr.shape[1] == bsc.shape[0], 'matrix-matrix shape invalid'
    bh, bw = bsr.values.shape[1], bsc.values.shape[2]
    H, W = bsr.shape[0], bsc.shape[1]
    nbr, nbc = H // bh, W // bw
    dev = bsr.values.device
    ai, bi, oi = bsr_bsc_pairs(bsr, bsc)
    out = bsr.values.new_zeros((nbr * nbc, bh, bw))
    if len(ai):
        plan = _segment_plan(oi)
        prods = _block_mm(bsr.values[torch.as_tensor(ai, device=dev)],
                          bsc.values[torch.as_tensor(bi, device=dev)])
        out[torch.as_tensor(plan[2], device=dev)] = _segment_sum(prods, plan)
    return out.reshape(nbr, nbc, bh, bw).permute(0, 2, 1, 3).reshape(H, W)


def bsr_matvec(bsr, x):
    """Block-sparse matrix times a dense vector ``[W]`` -> ``[H]``, each
    row's blocks summed in a fixed order."""
    nnzb, bh, bw = bsr.values.shape
    H, W = bsr.shape
    nbr = H // bh
    dev = bsr.values.device
    rows = np.repeat(np.arange(nbr), np.diff(bsr.crow_indices))
    gathered = x.reshape(W // bw, bw)[
        torch.as_tensor(bsr.col_indices, device=dev)]
    prods = (bsr.values * gathered[:, None, :]).sum(dim=-1)
    out = prods.new_zeros((nbr, bh))
    if nnzb:
        plan = _segment_plan(rows)
        out[torch.as_tensor(plan[2], device=dev)] = _segment_sum(prods, plan)
    return out.reshape(H)


def _sparse_csr_mm(a, b):
    """Layout dispatcher: BSR x BSC only."""
    if isinstance(a, BSR) and isinstance(b, BSC):
        return bsr_bsc_matmul(a, b)
    raise NotImplementedError(
        'Only BSR x BSC is supported; convert with dense_to_bsr/bsc.')
